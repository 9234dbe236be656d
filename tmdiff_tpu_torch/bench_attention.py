"""Times the flash-attention kernel (K4) alone, on a CUDA card.

    python3 -m tmdiff_tpu_torch.bench_attention [--reps 20] [--bf16]

Run from the root of a checkout: it times that checkout's kernel, so two
trees run one after the other in one call compare two versions on one card
(a tree that predates `--bf16` needs a copy of this file). Builds
`csrc/flash_attention.cu` and prints its ptxas spill report, then at each
shape (chip_smoke.py's three attention shapes and one at D = 128) prints
the plan, the max abs error against its plain version, ms per call by CUDA
events over back-to-back calls (host enqueue included), the host's enqueue
ms per call, the device ms of each kernel from torch.profiler, and
`F.scaled_dot_product_attention`'s ms by CUDA events in the same dtype.
fp32 (TF32 off; against `attention_reference`) or, with `--bf16`, bf16
q, k, v (against `flash_attention_plain`, and SDPA in bf16); inputs
unit-normal from a seed.
"""
from __future__ import annotations

import argparse
import re
import subprocess
import time

import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

from tmdiff_tpu_torch.ops.cuda import build
from tmdiff_tpu_torch.ops.cuda import flash_attention as K4

SHAPES = (((2, 8, 4096, 64), 4096), ((2, 8, 4096, 64), 1), ((2, 1, 1024, 256), 1024),
          ((1, 3, 1024, 128), 1024))


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


def _profiled(fn, reps: int):
    """torch.profiler's CUDA events of `reps` calls of fn after a warm-up
    call, as (short kernel name, event)."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            m = re.search(r"(\w+)(<[^()]*>)?\(", e.key.replace("(anonymous namespace)::", ""))
            yield (m.group(1) + (m.group(2) or "") if m else e.key), e


def kernel_ms(fn, reps: int) -> dict[str, float]:
    """Device ms per call of each kernel fn launches."""
    return {name: e.self_device_time_total / 1e3 / reps
            for name, e in _profiled(fn, reps) if e.self_device_time_total > 0}


def kernel_launches(fn) -> dict[str, int]:
    """Launches of each kernel in one call of fn."""
    return {name: e.count for name, e in _profiled(fn, 1)}


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--reps", type=int, default=20)
    parser.add_argument("--bf16", action="store_true", help="bf16 q, k, v")
    args = parser.parse_args()
    dtype = torch.bfloat16 if args.bf16 else torch.float32
    plain = K4.flash_attention_plain if args.bf16 else K4.attention_reference
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    K4.library()
    spills = [line.strip() for line in build.build_info["flash_attention"]["log"].splitlines()
              if "spill" in line and not line.strip().startswith("0 bytes stack")]
    print(f"build {build.build_info['flash_attention']['seconds']:.1f} s; spills: "
          f"{'; '.join(spills) or 'none'}", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    for (b, h, sq, d), skv in SHAPES:
        q, k, v = (torch.randn(b, h, s, d, device="cuda", generator=gen).to(dtype)
                   for s in (sq, skv, skv))
        with torch.no_grad():
            err = (K4.flash_attention(q, k, v).float() - plain(q, k, v).float()).abs().max().item()
            fn = lambda: K4.flash_attention(q, k, v)  # noqa: E731
            ms = event_ms(fn, args.reps)
            t0 = time.perf_counter()
            for _ in range(args.reps):
                fn()
            host_ms = (time.perf_counter() - t0) * 1e3 / args.reps
            torch.cuda.synchronize()
            per_kernel = kernel_ms(fn, args.reps)
            sdpa_ms = event_ms(lambda: F.scaled_dot_product_attention(q, k, v), args.reps)
        kernels = ", ".join(f"{name} {t:.4f}" for name, t in per_kernel.items())
        print(f"{(b, h, sq, d)} Skv {skv}: {K4.device_plan(q, skv)} err {err:.3g} "
              f"ms {ms:.4f} host_ms {host_ms:.4f} device_ms {sum(per_kernel.values()):.4f} "
              f"({kernels}) sdpa_ms {sdpa_ms:.4f}", flush=True)


if __name__ == "__main__":
    main()
