#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (an H100 is the
target): builds the CUDA kernel from `tmdiff_tpu_torch/csrc/`, holds it
against its plain PyTorch version at every 3x3x3 conv shape of the
full-width WavBEST (channels 32, 64, 128, 256) at 256x256, 8 and 4 bands,
batch 2, then serves dpm++ pansharpening requests on a seeded model.

    python3 chip_smoke.py

Phases (any failure ends the run with a non-zero exit code):
  1. build   compile the kernel library with nvcc (sm_90a); print seconds
             and ptxas' register and spill report.
  2. kernel  record every distinct 3x3x3 conv the model launches (one
             encode + one denoise at 8 and at 4 bands); at each shape hold
             the K1 entry (the path's own options, then style + bias +
             accumulate) and the K2 entry (no options) against the plain
             version; time kernel, plain version and F.conv3d (a yardstick
             only, TF32 off) and compute the bound.
  3. model   one fused forward at 8 bands with the kernel and with the plain
             convs on the card; compare; check the launch count.
  4. serve   the main path: a Pansharpener answers a WV3 8-band, a QB 4-band
             and a mixed QB/GF2 4-band request (batch 2 each, 30-step dpm++);
             launch counts reset just before and read just after. Then one
             request again through the plain convs, compared with the kernel's.
The last two lines of standard output are the card's name and power limit
and {"ok": true, "device": {...}}; the line before them is the
{"kernels": [...]} summary.

Tolerances (fp32 everywhere, TF32 off): a conv agrees with its plain version
to 1e-4 of the output's largest magnitude (fp32 sums of up to 27 * 256 terms
in another order); the forward pass to 5e-4 absolute, the repository's
forward parity bar; a sampled image to 2e-3, its sampling bar.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

CHANNELS = (32, 64, 128, 256)
SIZE, BATCH, SEED = 256, 2, 0
PEAK_FP32_FLOPS = 67e12  # H100 SXM, fp32 outside the tensor cores
PEAK_BYTES = 3.35e12     # H100 SXM HBM3
CONV_RTOL = 1e-4
FORWARD_ATOL = 5e-4
SAMPLE_ATOL = 2e-3
# 3x3x3 convs per call of the full-width model at 256x256 (one launch per
# concat part and per group of the grouped skip conv):
#   encode  = head 1 + 3 down stages x 4                                 = 13
#   denoise = head 1 + 3 down stages x 4 + middle 2
#             + 3 up stages x (3 parts + 1 + Conv_0 1 + 3 groups + Conv_1 1)
#             + final (3 parts + 1 + 3 ResBlocks x 2)                    = 52
ENCODE_CONVS, DENOISE_CONVS = 13, 52
NFE = 31


def fail(msg: str):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def cuda_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def valid_taps(n: int) -> int:
    """Sum over n positions of the 3-tap window entries that fall inside."""
    return 1 if n == 1 else 3 * n - 2


def conv_bound(b, d, h, w, cin, cout, style, bias, accumulate):
    flops = 2.0 * b * cin * cout * valid_taps(d) * valid_taps(h) * valid_taps(w)
    nbytes = 4.0 * (b * d * h * w * (cin + cout * (2 if accumulate else 1))
                    + 27 * cin * cout + (b * cin if style else 0) + (cout if bias else 0))
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def make_batch(rng, bands):
    ms = rng.uniform(0.05, 0.95, (BATCH, bands, SIZE, SIZE)).astype(np.float32)
    pan = (ms.mean(1, keepdims=True)
           + 0.05 * rng.standard_normal((BATCH, 1, SIZE, SIZE))).astype(np.float32)
    return {"PAN": pan, "MS": ms}


def record_convs(model, modconv, pan, ms, prompt, x_t, t):
    """Runs encode + denoise once; returns {(phase, shape, flags): count}."""
    seen = {}
    original = modconv.banded_conv3d
    phase = ["encode"]

    def recorder(x, kernel, style=None, bias=None, out=None):
        key = (phase[0], tuple(x.shape) + (kernel.shape[-1],),
               (style is not None, bias is not None, out is not None))
        seen[key] = seen.get(key, 0) + 1
        return original(x, kernel, style, bias, out)

    modconv.banded_conv3d = recorder
    try:
        with torch.no_grad():
            cache = model.encode_condition(pan, ms, prompt)
            phase[0] = "denoise"
            model.denoise(x_t, t, cache)
    finally:
        modconv.banded_conv3d = original
    return seen


def kernel_phase(model, K, modconv, gen):
    dev = "cuda"
    # ((b, d, h, w, cin, cout), (style, bias, accumulate)) -> {bands: launches per request}
    shapes = {}
    for bands in (8, 4):
        pan = torch.rand(BATCH, 1, SIZE, SIZE, device=dev, generator=gen)
        ms = torch.rand(BATCH, bands, SIZE, SIZE, device=dev, generator=gen)
        x_t = torch.randn(BATCH, bands, SIZE, SIZE, device=dev, generator=gen)
        prompt = torch.randn(768, device=dev, generator=gen)
        t = torch.full((BATCH,), 500.0, device=dev)
        seen = record_convs(model, modconv, pan, ms, prompt, x_t, t)
        for (phase, shape, flags), n in seen.items():
            per = shapes.setdefault((shape, flags), {})
            per[bands] = per.get(bands, 0) + n * (NFE if phase == "denoise" else 1)
    print(f"[kernel] {len(shapes)} distinct 3x3x3 conv shapes and options", flush=True)
    totals = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0,
              "ops_s": 0.0, "bytes_s": 0.0}
    max_err = max_rel = 0.0
    for (shape, (has_style, has_bias, acc)), per in sorted(shapes.items()):
        b, d, h, w, cin, cout = shape
        x = torch.randn(b, d, h, w, cin, device=dev, generator=gen)
        k = torch.randn(3, 3, 3, cin, cout, device=dev, generator=gen) / (27 * cin) ** 0.5
        s = 1.0 + 0.5 * torch.randn(b, cin, device=dev, generator=gen)
        bias = torch.randn(cout, device=dev, generator=gen)
        out0 = torch.randn(b, d, h, w, cout, device=dev, generator=gen)
        path = (s if has_style else None, bias if has_bias else None)
        errs = []
        with torch.no_grad():
            for fn, st, bi, out in ((K.banded_conv3d, *path, out0 if acc else None),
                                    (K.banded_conv3d, s, bias, out0),
                                    (K.banded_conv3d_v2, None, None, None)):
                got = fn(x, k, st, bi, None if out is None else out.clone())
                ref = K.conv3d_plain(x, k, st, bi, None if out is None else out.clone())
                torch.cuda.synchronize()
                err = (got - ref).abs().max().item()
                scale = ref.abs().max().item()
                if not err <= CONV_RTOL * scale:
                    fail(f"conv {shape} {fn.__name__}: max abs err {err} > {CONV_RTOL} x {scale}")
                errs.append(err)
                max_err, max_rel = max(max_err, err), max(max_rel, err / scale)
            st, bi = path
            out = out0.clone() if acc else None
            ms_k = cuda_ms(lambda: K.banded_conv3d(x, k, st, bi, out), 10)
            ms_p = cuda_ms(lambda: K.conv3d_plain(x, k, st, bi, out), 3)
            xs = (x * s[:, None, None, None, :] if has_style else x).permute(0, 4, 1, 2, 3)
            wl = k.permute(4, 3, 0, 1, 2).contiguous()
            ms_l = cuda_ms(lambda: F.conv3d(xs, wl, bi, padding=1), 10)
        bound, bound_by = conv_bound(b, d, h, w, cin, cout, has_style, has_bias, acc)
        n8 = per.get(8, 0)
        print(f"[kernel] B{b} D{d} {h}x{w} {cin}->{cout} style={int(has_style)} "
              f"bias={int(has_bias)} acc={int(acc)} launches/request 8-band={n8} "
              f"4-band={per.get(4, 0)} ms={ms_k:.4f} plain_ms={ms_p:.4f} "
              f"library_ms={ms_l:.4f} bound_ms={bound:.4f} ({bound_by}) "
              f"err(K1 path, K1 all, K2 none)={errs[0]:.3g},{errs[1]:.3g},{errs[2]:.3g}",
              flush=True)
        for key, v in (("ms", ms_k), ("plain_ms", ms_p), ("library_ms", ms_l), ("bound_ms", bound)):
            totals[key] += n8 * v
        totals["ops_s" if bound_by == "operations" else "bytes_s"] += n8 * bound
    totals["bound_by"] = "operations" if totals["ops_s"] >= totals["bytes_s"] else "bytes"
    print(f"[kernel] one 8-band batch-{BATCH} request, summed over its convs: "
          f"kernel {totals['ms']:.1f} ms, plain {totals['plain_ms']:.1f} ms, "
          f"F.conv3d {totals['library_ms']:.1f} ms, bound {totals['bound_ms']:.1f} ms; "
          f"max abs err {max_err:.3g}, max err / output scale {max_rel:.3g}", flush=True)
    return totals, max_err


def model_phase(model, K, gen):
    dev = "cuda"
    pan = torch.rand(BATCH, 1, SIZE, SIZE, device=dev, generator=gen)
    ms = torch.rand(BATCH, 8, SIZE, SIZE, device=dev, generator=gen)
    x_t = torch.randn(BATCH, 8, SIZE, SIZE, device=dev, generator=gen)
    prompt = torch.randn(BATCH, 768, device=dev, generator=gen)
    t = torch.tensor([10.0, 700.0], device=dev)
    with torch.no_grad():
        K.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        y = model(x_t, t, pan, ms, prompt)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        n = K.launches
        ref = model.use_plain_conv(True)(x_t, t, pan, ms, prompt)
        model.use_plain_conv(False)
    err = (y - ref).abs().max().item()
    print(f"[model] fused forward 8-band batch {BATCH} {SIZE}x{SIZE}: {sec:.3f} s, "
          f"{n} kernel launches (expected {ENCODE_CONVS + DENOISE_CONVS}), "
          f"max abs err vs plain convs {err:.3g} (atol {FORWARD_ATOL}), "
          f"output max |y| {ref.abs().max().item():.3g}", flush=True)
    if tuple(y.shape) != (BATCH, 8, SIZE, SIZE) or not torch.isfinite(y).all():
        fail("forward output has the wrong shape or is not finite")
    if n != ENCODE_CONVS + DENOISE_CONVS:
        fail(f"forward launched the kernel {n} times")
    if not err <= FORWARD_ATOL:
        fail(f"forward differs from the plain convs by {err}")


def serve_phase(model, K, seed):
    from tmdiff_tpu_torch.pipeline import Pansharpener

    sharp = Pansharpener(model, device="cuda")
    rng = np.random.default_rng(seed)
    requests = [("WV3", make_batch(rng, 8)), ("QB", make_batch(rng, 4)),
                (["QB", "GF2"], make_batch(rng, 4))]
    calls = [0]
    denoise = model.denoise

    def counted(*args, **kw):
        calls[0] += 1
        return denoise(*args, **kw)

    model.denoise = counted
    results = []
    try:
        sharp.sample(requests[1][1], sensor="QB", seed=seed)  # warm-up, outside the count
        torch.cuda.synchronize()
        K.reset_launches()
        for i, (sensor, batch) in enumerate(requests):
            calls[0], before = 0, K.launches
            t0 = time.perf_counter()
            img = sharp.sample(batch, sensor=sensor, method="dpm++", seed=seed + i)
            sec = time.perf_counter() - t0
            results.append((sensor, batch, img, sec, calls[0], K.launches - before))
        launches = K.launches
    finally:
        del model.denoise
    expected = ENCODE_CONVS + NFE * DENOISE_CONVS
    for sensor, batch, img, sec, nfe, n in results:
        bands = batch["MS"].shape[1]
        ok = (img.shape == batch["MS"].shape and np.isfinite(img).all()
              and img.min() >= 0.0 and img.max() <= 1.0)
        print(f"[serve] sensor={sensor} bands={bands} batch={BATCH} {SIZE}x{SIZE}: "
              f"{sec:.3f} s, NFE {nfe}, {nfe / sec:.2f} denoise calls/s, "
              f"{n} kernel launches (expected {expected}), finite and in [0, 1]: {ok}",
              flush=True)
        if not ok or nfe != NFE or n != expected:
            fail(f"request {sensor}: ok={ok} nfe={nfe} launches={n}")
    sensor, batch, img = results[1][:3]
    model.use_plain_conv(True)
    try:
        t0 = time.perf_counter()
        ref = sharp.sample(batch, sensor=sensor, method="dpm++", seed=seed + 1)
        sec = time.perf_counter() - t0
    finally:
        model.use_plain_conv(False)
    err = float(np.abs(img - ref).max())
    print(f"[serve] {sensor} 4-band request through the plain convs: {sec:.3f} s; "
          f"max abs err vs kernel path {err:.3g} (atol {SAMPLE_ATOL})", flush=True)
    if not err <= SAMPLE_ATOL:
        fail(f"sampled image differs from the plain path by {err}")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from tmdiff_tpu_torch.models.wavbest import WavBEST
    from tmdiff_tpu_torch.ops import modconv
    from tmdiff_tpu_torch.ops.cuda import build
    from tmdiff_tpu_torch.ops.cuda import conv3d as K

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on {smi}; "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
          f"cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}", flush=True)

    t0 = time.perf_counter()
    K.library()
    info = build.build_info["conv3d"]
    print(f"[build] conv3d.cu: {time.perf_counter() - t0:.2f} s (nvcc {info['seconds']:.2f} s)")
    for line in info["log"].splitlines():
        if "registers" in line or "spill" in line:
            print("[build]", line.strip())

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    model = WavBEST(CHANNELS, device="cuda", seed=SEED)
    totals, max_err = kernel_phase(model, K, modconv, gen)
    model_phase(model, K, gen)
    launches = serve_phase(model, K, SEED)
    if launches == 0:
        fail("the main path launched no conv3d kernel")

    kernel = {
        "name": "conv3d_333", "route": "cuda", "source": "tmdiff_tpu_torch/csrc/conv3d.cu",
        "replaces": "tmdiff_tpu/ops/pallas/banded_conv3d.py:101",
        "replaces_also": "tmdiff_tpu/ops/pallas/banded_conv3d.py:182",
        "launches": launches, "max_abs_err": max_err,
        "ms": totals["ms"], "plain_ms": totals["plain_ms"], "bound_ms": totals["bound_ms"],
        "bound_by": totals["bound_by"], "library_ms": totals["library_ms"],
        "times_are": f"summed over the 3x3x3 convs of one dpm++ request, 8 bands, "
                     f"batch {BATCH}, {SIZE}x{SIZE}, full width",
    }
    print(json.dumps({"kernels": [kernel]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
