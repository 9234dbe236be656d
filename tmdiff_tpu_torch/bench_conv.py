"""Times the conv kernels (K1 through the "banded" lowering, K3 through
"auto") alone at every conv shape of one request, on a CUDA card.

    python3 -m tmdiff_tpu_torch.bench_conv [--dtype bf16|fp32] [--impl banded|auto|both]
        [--bands 8|4|both] [--reps 10]

Run from the root of a checkout: it times that checkout's kernels, so two
trees run one after the other in one call compare two versions on one card.
Builds `csrc/conv3d.cu` and prints its ptxas report for the tensor-core
instances of the dtype, then records the conv calls (shape and options) of
one encode + one denoise of the full-width WavBEST (channels 32, 64, 128,
256) at batch 2, 256x256, weighted as one `dpm++` request (encode once, 31
denoise calls). At each shape it holds the kernel against its plain version
(bf16: within one bf16 step plus 1e-4 of scale; fp32: 1e-4 of scale) and
prints the variant taken, the kernel's ms by CUDA events over back-to-back
launches, the library conv's ms (cuDNN in benchmark mode on a
pre-modulated input, TF32 off) and the bound (989 TFLOP/s bf16, 165 TFLOP/s
3xTF32, or 3.35 TB/s, the larger). Last, per kernel and band count, the
request's sums and the kernel-over-library ratio. Inputs unit-normal from a
seed.
"""
from __future__ import annotations

import argparse
import re
import subprocess

import numpy as np
import torch
import torch.nn.functional as F

from tmdiff_tpu_torch.models.wavbest import WavBEST
from tmdiff_tpu_torch.ops import modconv
from tmdiff_tpu_torch.ops.cuda import build
from tmdiff_tpu_torch.ops.cuda import conv2d as K3
from tmdiff_tpu_torch.ops.cuda import conv3d as K

BATCH, SIZE, NFE, SEED = 2, 256, 31, 0
PEAKS = {"bf16": 989e12, "fp32": 495e12 / 3}
PEAK_BYTES = 3.35e12
RTOL = 1e-4
DTYPES = {"bf16": torch.bfloat16, "fp32": torch.float32}


def event_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def library_ms(fn, reps: int) -> float:
    before = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = True
    try:
        fn()
        return event_ms(fn, reps)
    finally:
        torch.backends.cudnn.benchmark = before


def half_step(t):
    a = t.float().abs()
    e = torch.floor(torch.log2(torch.where(a > 0, a, torch.ones_like(a))))
    return torch.where(a > 0, torch.exp2(e - 8), torch.zeros_like(a))


def check(got, ref, dtype) -> float:
    """Largest |got - ref|; raises beyond the bar named in the docstring."""
    diff = (got.float() - ref.float()).abs()
    scale = ref.float().abs().max().item()
    bar = RTOL * scale + (half_step(got) + half_step(ref) if dtype == "bf16" else 0.0)
    over = int((diff > bar).sum())
    if over:
        raise SystemExit(f"bench_conv: {over} elements beyond the bar")
    return diff.max().item()


def valid_taps(n: int) -> int:
    return 1 if n == 1 else 3 * n - 2


def request_shapes(model, attr, bands, gen):
    """{(shape + (Cout,), flags): launches per dpm++ request} of the calls
    to `modconv.<attr>`."""
    seen, original, phase = {}, getattr(modconv, attr), ["encode"]

    def recorder(x, kernel, *rest):
        key = (tuple(x.shape) + (kernel.shape[-1],), tuple(a is not None for a in rest))
        seen[key] = seen.get(key, 0) + (NFE if phase[0] == "denoise" else 1)
        return original(x, kernel, *rest)

    pan = torch.rand(BATCH, 1, SIZE, SIZE, device="cuda", generator=gen)
    ms = torch.rand(BATCH, bands, SIZE, SIZE, device="cuda", generator=gen)
    setattr(modconv, attr, recorder)
    try:
        with torch.no_grad():
            cache = model.encode_condition(pan, ms, torch.randn(768, device="cuda", generator=gen))
            phase[0] = "denoise"
            model.denoise(torch.randn(BATCH, bands, SIZE, SIZE, device="cuda", generator=gen),
                          torch.full((BATCH,), 500.0, device="cuda"), cache)
    finally:
        setattr(modconv, attr, original)
    return seen


def bench(model, impl, bands, dtype, reps, gen):
    mod, attr = (K, "banded_conv3d") if impl == "banded" else (K3, "conv3x3_nhwc")
    model.use_conv_impl(impl)
    shapes = request_shapes(model, attr, bands, gen)
    model.use_conv_impl("banded")
    sums = {"ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0}
    for (shape, flags), n in sorted(shapes.items()):
        *lead, cin, cout = shape
        taps = (3, 3, 3) if mod is K else (3, 3)
        n_taps = int(np.prod(taps))
        dt = DTYPES[dtype]
        x = torch.randn(*lead, cin, device="cuda", generator=gen).to(dt)
        k = (torch.randn(*taps, cin, cout, device="cuda", generator=gen)
             / (n_taps * cin) ** 0.5).to(dt)
        s = (1.0 + 0.5 * torch.randn(lead[0], cin, device="cuda", generator=gen)).to(dt)
        bias = torch.randn(cout, device="cuda", generator=gen).to(dt)
        acc = torch.randn(*lead, cout, device="cuda", generator=gen).to(dt)
        opts = [t if f else None for t, f in zip((s, bias, acc), flags)]
        fresh = lambda: [t.clone() if t is acc else t for t in opts]
        entry = getattr(mod, attr)
        plain = K.conv3d_plain if mod is K else K3.conv3x3_nhwc_plain
        with torch.no_grad():
            before = dict(mod.variant_launches)
            got = entry(x, k, *fresh())
            (variant,) = [v for v, c in mod.variant_launches.items() if c != before[v]]
            err = check(got, plain(x, k, *fresh()), dtype)
            ms_k = event_ms(lambda: entry(x, k, *opts), reps)
            xs = x * s.view(lead[0], *[1] * (len(lead) - 1), cin) if flags[0] else x
            perm = (0, 4, 1, 2, 3) if mod is K else (0, 3, 1, 2)
            wl = k.permute(len(taps) + 1, len(taps), *range(len(taps))).contiguous()
            conv = F.conv3d if mod is K else F.conv2d
            bi = bias if flags[1] else None
            ms_l = library_ms(lambda: conv(xs.permute(*perm), wl, bi, padding=1), reps)
        flops = 2.0 * lead[0] * cin * cout * int(np.prod([valid_taps(v) for v in lead[1:]]))
        nbytes = x.element_size() * (int(np.prod(lead)) * (cin + cout * (2 if flags[-1] and
                                                                          mod is K else 1))
                                     + n_taps * cin * cout)
        bnd = max(flops / PEAKS[dtype], nbytes / PEAK_BYTES) * 1e3
        print(f"{attr} {dtype} bands={bands} {tuple(lead)} {cin}->{cout} options={flags} "
              f"launches/request={n} variant={variant} ms={ms_k:.4f} library_ms={ms_l:.4f} "
              f"kernel/library={ms_k / ms_l:.3f} bound_ms={bnd:.4f} share_of_bound="
              f"{bnd / ms_k:.3f} max_abs_err={err:.3g}", flush=True)
        sums["ms"] += n * ms_k
        sums["library_ms"] += n * ms_l
        sums["bound_ms"] += n * bnd
    print(f"SUM {attr} {dtype} {impl} bands={bands}: {len(shapes)} shapes; one dpm++ request "
          f"batch {BATCH} {SIZE}x{SIZE}: kernel {sums['ms']:.1f} ms, library "
          f"{sums['library_ms']:.1f} ms, kernel/library {sums['ms'] / sums['library_ms']:.3f}, "
          f"bound {sums['bound_ms']:.1f} ms, share of bound {sums['bound_ms'] / sums['ms']:.3f}",
          flush=True)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--dtype", choices=tuple(DTYPES), default="bf16")
    parser.add_argument("--impl", choices=("banded", "auto", "both"), default="both")
    parser.add_argument("--bands", choices=("8", "4", "both"), default="8")
    parser.add_argument("--reps", type=int, default=10)
    args = parser.parse_args()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"{smi}; torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    build.load("conv3d")
    kernel = "bf16" if args.dtype == "bf16" else "tf32x3"
    name = None
    for line in build.build_info["conv3d"]["log"].splitlines():
        if "Compiling entry function" in line:
            m = re.search(r"conv_3x3_(\w+?)_kernelI(\w+?)EEEv", line)
            name = f"{m.group(1)}<{m.group(2).replace('Li', '').replace('E', ',')}>" if m else None
        elif name and name.startswith(kernel + "<") and ("registers" in line or "spill" in line):
            print(f"ptxas {name}: {line.strip()}")
    model = WavBEST(device="cuda", seed=SEED, dtype=DTYPES[args.dtype])
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    impls = ("banded", "auto") if args.impl == "both" else (args.impl,)
    bands = (8, 4) if args.bands == "both" else (int(args.bands),)
    for impl in impls:
        for b in bands:
            bench(model, impl, b, args.dtype, args.reps, gen)


if __name__ == "__main__":
    main()
