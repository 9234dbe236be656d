#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (an H100 is the
target): builds the CUDA kernels from `tmdiff_tpu_torch/csrc/`, holds each
against its plain PyTorch version at the shapes its path gives it, then
serves dpm++ pansharpening requests on a seeded full-width WavBEST (channels
32, 64, 128, 256; 256x256, batch 2) under both conv lowerings, and runs the
attention library at SD-style widths.

    python3 chip_smoke.py

Phases (any failure ends the run with a non-zero exit code):
  1. build     compile every source under csrc/ with nvcc (sm_90a), all at
               once; print seconds and ptxas' register and spill report.
  2. kernel    K1/K2: record every distinct 3x3x3 conv the "banded" model
               launches (one encode + one denoise at 8 and at 4 bands); at
               each shape hold the K1 entry (the path's own options, then
               style + bias + accumulate) and the K2 entry (no options)
               against the plain version; time kernel, plain version and
               F.conv3d (a yardstick only, TF32 off) and compute the bound.
  3. conv2d    K3: the same for every band-folded 3x3 conv the "auto" model
               launches, against F.conv2d on the same banded operands; the
               bound counts the 2-D conv's own multiply-adds, printed beside
               the useful 3x3x3 ones.
  4. model     one fused forward at 8 bands with the kernel and with the plain
               convs on the card; compare; check the launch count.
  5. serve     the main path: a Pansharpener answers a WV3 8-band, a QB 4-band
               and a mixed QB/GF2 4-band request (batch 2 each, 30-step dpm++)
               through the "banded" model; launch counts reset just before
               and read just after. Then one request again through the plain
               convs, compared with the kernel's.
  6. auto      the WV3 and QB requests again through the "auto" model (K1 and
               K3), counts reset just before and read just after; each image
               against the "banded" one.
  7. attention K4: flash attention against attention_reference and
               F.scaled_dot_product_attention (a yardstick only) at
               self-attention over 64x64 tokens (8 heads x 64), cross-attention
               to a one-token 768-wide prompt context, and a 32x32x256
               SpatialSelfAttention; then a SpatialTransformer forward
               (8 x 64 heads, 64x64x256 image, that context) through K4 and
               through the plain attention, counts reset just before.
The last two lines of standard output are the card's name and power limit
and {"ok": true, "device": {...}}; the line before them is the
{"kernels": [...]} summary.

Tolerances (fp32 everywhere, TF32 off): a conv agrees with its plain version
to 1e-4 of the output's largest magnitude (fp32 sums of up to 27 * 256 or
9 * 512 terms in another order); attention to 2e-5 absolute at unit-normal
inputs (the JAX package's flash-attention bar); a forward pass to 5e-4
absolute, the repository's forward parity bar; a sampled image to 2e-3, its
sampling bar.
"""
from __future__ import annotations

import json
import os
import re
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
ATTENTION_ATOL = 2e-5
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
# The attention library's SD-style widths at WavBEST's resolutions:
# (label, q shape (B, H, Sq, D), Skv)
ATTENTION_SHAPES = (
    ("self-attention, 64x64 tokens, 8 heads x 64", (BATCH, 8, 4096, 64), 4096),
    ("cross-attention to a 1-token prompt context", (BATCH, 8, 4096, 64), 1),
    ("SpatialSelfAttention, 32x32 x 256 channels", (BATCH, 1, 1024, 256), 1024),
)
PROMPT_DIM = 768
DEV = "cuda"


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


def bound(flops: float, nbytes: float):
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def conv_bound(b, d, h, w, cin, cout, style, bias, accumulate):
    flops = 2.0 * b * cin * cout * valid_taps(d) * valid_taps(h) * valid_taps(w)
    nbytes = 4.0 * (b * d * h * w * (cin + cout * (2 if accumulate else 1))
                    + 27 * cin * cout + (b * cin if style else 0) + (cout if bias else 0))
    return bound(flops, nbytes)


def make_batch(rng, bands):
    ms = rng.uniform(0.05, 0.95, (BATCH, bands, SIZE, SIZE)).astype(np.float32)
    pan = (ms.mean(1, keepdims=True)
           + 0.05 * rng.standard_normal((BATCH, 1, SIZE, SIZE))).astype(np.float32)
    return {"PAN": pan, "MS": ms}


def record_calls(model, modconv, attr, pan, ms, prompt, x_t, t):
    """Runs encode + denoise once; returns {(phase, shape, flags): count} of
    the calls to `modconv.<attr>` (a kernel wrapper), shape = x's shape +
    (Cout,), flags = which optional arguments were given."""
    seen = {}
    original = getattr(modconv, attr)
    phase = ["encode"]

    def recorder(x, kernel, *rest):
        key = (phase[0], tuple(x.shape) + (kernel.shape[-1],), tuple(a is not None for a in rest))
        seen[key] = seen.get(key, 0) + 1
        return original(x, kernel, *rest)

    setattr(modconv, attr, recorder)
    try:
        with torch.no_grad():
            cache = model.encode_condition(pan, ms, prompt)
            phase[0] = "denoise"
            model.denoise(x_t, t, cache)
    finally:
        setattr(modconv, attr, original)
    return seen


def path_shapes(model, modconv, attr, gen):
    """{(bands, shape, flags): launches per dpm++ request} of one wrapper."""
    shapes = {}
    for bands in (8, 4):
        pan = torch.rand(BATCH, 1, SIZE, SIZE, device=DEV, generator=gen)
        ms = torch.rand(BATCH, bands, SIZE, SIZE, device=DEV, generator=gen)
        x_t = torch.randn(BATCH, bands, SIZE, SIZE, device=DEV, generator=gen)
        prompt = torch.randn(PROMPT_DIM, device=DEV, generator=gen)
        t = torch.full((BATCH,), 500.0, device=DEV)
        for (phase, shape, flags), n in record_calls(model, modconv, attr, pan, ms, prompt,
                                                     x_t, t).items():
            key = (bands, shape, flags)
            shapes[key] = shapes.get(key, 0) + n * (NFE if phase == "denoise" else 1)
    return shapes


def kernel_phase(model, K, modconv, gen):
    # ((b, d, h, w, cin, cout), (style, bias, accumulate)) -> {bands: launches per request}
    shapes = {}
    for (bands, shape, flags), n in path_shapes(model, modconv, "banded_conv3d", gen).items():
        shapes.setdefault((shape, flags), {})[bands] = n
    print(f"[kernel] {len(shapes)} distinct 3x3x3 conv shapes and options", flush=True)
    totals = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0,
              "ops_s": 0.0, "bytes_s": 0.0}
    max_err = max_rel = 0.0
    for (shape, (has_style, has_bias, acc)), per in sorted(shapes.items()):
        b, d, h, w, cin, cout = shape
        x = torch.randn(b, d, h, w, cin, device=DEV, generator=gen)
        k = torch.randn(3, 3, 3, cin, cout, device=DEV, generator=gen) / (27 * cin) ** 0.5
        s = 1.0 + 0.5 * torch.randn(b, cin, device=DEV, generator=gen)
        bias = torch.randn(cout, device=DEV, generator=gen)
        out0 = torch.randn(b, d, h, w, cout, device=DEV, generator=gen)
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
        bnd, bound_by = conv_bound(b, d, h, w, cin, cout, has_style, has_bias, acc)
        n8 = per.get(8, 0)
        print(f"[kernel] B{b} D{d} {h}x{w} {cin}->{cout} style={int(has_style)} "
              f"bias={int(has_bias)} acc={int(acc)} launches/request 8-band={n8} "
              f"4-band={per.get(4, 0)} ms={ms_k:.4f} plain_ms={ms_p:.4f} "
              f"library_ms={ms_l:.4f} bound_ms={bnd:.4f} ({bound_by}) "
              f"err(K1 path, K1 all, K2 none)={errs[0]:.3g},{errs[1]:.3g},{errs[2]:.3g}",
              flush=True)
        for key, v in (("ms", ms_k), ("plain_ms", ms_p), ("library_ms", ms_l), ("bound_ms", bnd)):
            totals[key] += n8 * v
        totals["ops_s" if bound_by == "operations" else "bytes_s"] += n8 * bnd
    totals["bound_by"] = "operations" if totals["ops_s"] >= totals["bytes_s"] else "bytes"
    print(f"[kernel] one 8-band batch-{BATCH} request, summed over its convs: "
          f"kernel {totals['ms']:.1f} ms, plain {totals['plain_ms']:.1f} ms, "
          f"F.conv3d {totals['library_ms']:.1f} ms, bound {totals['bound_ms']:.1f} ms; "
          f"max abs err {max_err:.3g}, max err / output scale {max_rel:.3g}", flush=True)
    return totals, max_err


def conv2d_phase(model, K3, modconv, gen):
    """K3 at every band-folded 3x3 conv of the "auto" model. The operands
    are the ones the lowering builds: x folded to (B, H, W, D*Cin) and the
    block-banded (3, 3, D*Cin, D*Cout) weight of a random 3x3x3 kernel."""
    model.use_conv_impl("auto")
    try:
        shapes = path_shapes(model, modconv, "conv3x3_nhwc", gen)
    finally:
        model.use_conv_impl("banded")
    print(f"[conv2d] {len(shapes)} distinct band-folded 3x3 conv shapes and options "
          f"(8 and 4 bands)", flush=True)
    totals = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0,
              "ops_s": 0.0, "bytes_s": 0.0, "flops": 0.0, "useful_flops": 0.0}
    max_err = max_rel = 0.0
    for (bands, shape, (has_style, has_bias)), n in sorted(shapes.items()):
        b, h, w, c2, cout2 = shape
        d, cin, cout = bands, c2 // bands, cout2 // bands
        x = torch.randn(b, h, w, c2, device=DEV, generator=gen)
        k = torch.randn(3, 3, 3, cin, cout, device=DEV, generator=gen) / (27 * cin) ** 0.5
        w2 = modconv.banded_weight(k, d)
        s = (1.0 + 0.5 * torch.randn(b, cin, device=DEV, generator=gen)).repeat(1, d)
        bias = torch.randn(cout, device=DEV, generator=gen).repeat(d)
        st, bi = (s if has_style else None), (bias if has_bias else None)
        errs = []
        with torch.no_grad():
            for args in ((st, bi), (s, bias)):
                got = K3.conv3x3_nhwc(x, w2, *args)
                ref = K3.conv3x3_nhwc_plain(x, w2, *args)
                torch.cuda.synchronize()
                err = (got - ref).abs().max().item()
                scale = ref.abs().max().item()
                if not err <= CONV_RTOL * scale:
                    fail(f"conv2d {shape}: max abs err {err} > {CONV_RTOL} x {scale}")
                errs.append(err)
                max_err, max_rel = max(max_err, err), max(max_rel, err / scale)
            ms_k = cuda_ms(lambda: K3.conv3x3_nhwc(x, w2, st, bi), 10)
            ms_p = cuda_ms(lambda: K3.conv3x3_nhwc_plain(x, w2, st, bi), 3)
            xs = (x * s[:, None, None, :] if has_style else x).permute(0, 3, 1, 2)
            wl = w2.permute(3, 2, 0, 1).contiguous()
            ms_l = cuda_ms(lambda: F.conv2d(xs, wl, bi, padding=1), 10)
        flops = 2.0 * b * c2 * cout2 * valid_taps(h) * valid_taps(w)
        useful = 2.0 * b * cin * cout * valid_taps(d) * valid_taps(h) * valid_taps(w)
        nbytes = 4.0 * (b * h * w * (c2 + cout2) + 9 * c2 * cout2
                        + (b * c2 if has_style else 0) + (cout2 if has_bias else 0))
        bnd, bound_by = bound(flops, nbytes)
        print(f"[conv2d] bands={d} B{b} {h}x{w} {c2}->{cout2} ({cin}->{cout} per band) "
              f"style={int(has_style)} bias={int(has_bias)} launches/request={n} "
              f"ms={ms_k:.4f} plain_ms={ms_p:.4f} library_ms={ms_l:.4f} "
              f"bound_ms={bnd:.4f} ({bound_by}) GFLOP 2-D={flops / 1e9:.2f} "
              f"useful 3x3x3={useful / 1e9:.2f} ({flops / useful:.2f}x) "
              f"err(path, style+bias)={errs[0]:.3g},{errs[1]:.3g}", flush=True)
        if d == 8:
            for key, v in (("ms", ms_k), ("plain_ms", ms_p), ("library_ms", ms_l),
                           ("bound_ms", bnd), ("flops", flops), ("useful_flops", useful)):
                totals[key] += n * v
            totals["ops_s" if bound_by == "operations" else "bytes_s"] += n * bnd
    totals["bound_by"] = "operations" if totals["ops_s"] >= totals["bytes_s"] else "bytes"
    print(f"[conv2d] one 8-band batch-{BATCH} auto request, summed over its K3 convs: "
          f"kernel {totals['ms']:.1f} ms, plain {totals['plain_ms']:.1f} ms, "
          f"F.conv2d {totals['library_ms']:.1f} ms, bound {totals['bound_ms']:.1f} ms; "
          f"2-D GFLOP {totals['flops'] / 1e9:.1f} for {totals['useful_flops'] / 1e9:.1f} useful; "
          f"max abs err {max_err:.3g}, max err / output scale {max_rel:.3g}", flush=True)
    return totals, max_err


def model_phase(model, K, gen):
    pan = torch.rand(BATCH, 1, SIZE, SIZE, device=DEV, generator=gen)
    ms = torch.rand(BATCH, 8, SIZE, SIZE, device=DEV, generator=gen)
    x_t = torch.randn(BATCH, 8, SIZE, SIZE, device=DEV, generator=gen)
    prompt = torch.randn(BATCH, PROMPT_DIM, device=DEV, generator=gen)
    t = torch.tensor([10.0, 700.0], device=DEV)
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


class DenoiseCounter:
    """Counts the model's denoise calls while installed."""

    def __init__(self, model):
        self.model, self.calls = model, 0

    def __enter__(self):
        denoise = self.model.denoise

        def counted(*args, **kw):
            self.calls += 1
            return denoise(*args, **kw)

        self.model.denoise = counted
        return self

    def __exit__(self, *exc):
        del self.model.denoise


def check_image(img, batch) -> bool:
    return (img.shape == batch["MS"].shape and bool(np.isfinite(img).all())
            and img.min() >= 0.0 and img.max() <= 1.0)


def serve_phase(model, K, seed):
    from tmdiff_tpu_torch.pipeline import Pansharpener

    sharp = Pansharpener(model, device=DEV)
    rng = np.random.default_rng(seed)
    requests = [("WV3", make_batch(rng, 8)), ("QB", make_batch(rng, 4)),
                (["QB", "GF2"], make_batch(rng, 4))]
    results = []
    with DenoiseCounter(model) as nfe:
        sharp.sample(requests[1][1], sensor="QB", seed=seed)  # warm-up, outside the count
        torch.cuda.synchronize()
        K.reset_launches()
        for i, (sensor, batch) in enumerate(requests):
            nfe.calls, before = 0, K.launches
            t0 = time.perf_counter()
            img = sharp.sample(batch, sensor=sensor, method="dpm++", seed=seed + i)
            sec = time.perf_counter() - t0
            results.append((sensor, batch, img, sec, nfe.calls, K.launches - before))
        launches = K.launches
    expected = ENCODE_CONVS + NFE * DENOISE_CONVS
    for sensor, batch, img, sec, calls, n in results:
        bands = batch["MS"].shape[1]
        ok = check_image(img, batch)
        print(f"[serve] sensor={sensor} bands={bands} batch={BATCH} {SIZE}x{SIZE}: "
              f"{sec:.3f} s, NFE {calls}, {calls / sec:.2f} denoise calls/s, "
              f"{n} kernel launches (expected {expected}), finite and in [0, 1]: {ok}",
              flush=True)
        if not ok or calls != NFE or n != expected:
            fail(f"request {sensor}: ok={ok} nfe={calls} launches={n}")
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
    return launches, results


def auto_serve_phase(model, K, K3, K4, banded_results, seed):
    """The WV3 and QB requests of the serve phase again, through the "auto"
    lowering; each image against the "banded" one."""
    from tmdiff_tpu_torch.pipeline import Pansharpener

    sharp = Pansharpener(model.use_conv_impl("auto"), device=DEV)
    try:
        with DenoiseCounter(model) as nfe:
            sharp.sample(banded_results[1][1], sensor="QB", seed=seed, steps=2)  # warm-up
            torch.cuda.synchronize()
            for mod in (K, K3, K4):
                mod.reset_launches()
            for i, (sensor, batch, ref) in enumerate(r[:3] for r in banded_results[:2]):
                nfe.calls, k1, k3 = 0, K.launches, K3.launches
                t0 = time.perf_counter()
                img = sharp.sample(batch, sensor=sensor, method="dpm++", seed=seed + i)
                sec = time.perf_counter() - t0
                k1, k3 = K.launches - k1, K3.launches - k3
                err = float(np.abs(img - ref).max())
                ok = check_image(img, batch)
                print(f"[auto] sensor={sensor} bands={batch['MS'].shape[1]} batch={BATCH} "
                      f"{SIZE}x{SIZE}: {sec:.3f} s, NFE {nfe.calls}, "
                      f"{nfe.calls / sec:.2f} denoise calls/s, K1 launches {k1}, "
                      f"K3 launches {k3}, max abs err vs the banded request {err:.3g} "
                      f"(atol {SAMPLE_ATOL}), finite and in [0, 1]: {ok}", flush=True)
                if not ok or nfe.calls != NFE or k1 + k3 != ENCODE_CONVS + NFE * DENOISE_CONVS:
                    fail(f"auto request {sensor}: ok={ok} nfe={nfe.calls} launches={k1}+{k3}")
                if not err <= SAMPLE_ATOL:
                    fail(f"auto request {sensor} differs from the banded one by {err}")
            counts = {"K1": K.launches, "K3": K3.launches, "K4": K4.launches}
    finally:
        model.use_conv_impl("banded")
    if counts["K3"] == 0:
        fail("the auto requests launched no conv3x3_nhwc kernel")
    if counts["K4"] != 0:
        fail("the auto requests launched a kernel off their path")
    return counts


def attention_bound(b, h, sq, skv, d):
    flops = 4.0 * b * h * sq * skv * d  # q.kT and p.v
    nbytes = 4.0 * b * h * d * (2 * sq + 2 * skv)
    return bound(flops, nbytes)


def attention_phase(K4, gen):
    from tmdiff_tpu_torch.ops.attention import SpatialTransformer

    per_shape, max_err = [], 0.0
    for label, (b, h, sq, d), skv in ATTENTION_SHAPES:
        q = torch.randn(b, h, sq, d, device=DEV, generator=gen)
        k = torch.randn(b, h, skv, d, device=DEV, generator=gen)
        v = torch.randn(b, h, skv, d, device=DEV, generator=gen)
        with torch.no_grad():
            got = K4.flash_attention(q, k, v)
            ref = K4.attention_reference(q, k, v)
            torch.cuda.synchronize()
            err = (got - ref).abs().max().item()
            if not err <= ATTENTION_ATOL:
                fail(f"attention {label}: max abs err {err} > {ATTENTION_ATOL}")
            max_err = max(max_err, err)
            ms_k = cuda_ms(lambda: K4.flash_attention(q, k, v), 10)
            ms_p = cuda_ms(lambda: K4.attention_reference(q, k, v), 3)
            ms_l = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v), 10)
        bnd, bound_by = attention_bound(b, h, sq, skv, d)
        per_shape.append({"ms": ms_k, "plain_ms": ms_p, "library_ms": ms_l, "bound_ms": bnd,
                          "bound_by": bound_by})
        print(f"[attention] {label}: q {(b, h, sq, d)} Skv {skv} ms={ms_k:.4f} "
              f"plain_ms={ms_p:.4f} library_ms={ms_l:.4f} bound_ms={bnd:.4f} ({bound_by}) "
              f"max abs err {err:.3g} (atol {ATTENTION_ATOL})", flush=True)

    # The module's entry point: a SpatialTransformer over a 64x64x256 image
    # attending to the 768-wide prompt embedding as a one-token context. Its
    # proj_out starts at zero (the identity), so it is drawn at random here.
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(SEED)
        st = SpatialTransformer(256, heads=8, dim_head=64, context_dim=PROMPT_DIM)
        torch.nn.init.normal_(st.proj_out.weight, std=0.05)
    st = st.to(DEV).eval()
    x = torch.randn(BATCH, 64, 64, 256, device=DEV, generator=gen)
    ctx = torch.randn(BATCH, 1, PROMPT_DIM, device=DEV, generator=gen)
    with torch.no_grad():
        st(x, ctx)  # warm-up
        torch.cuda.synchronize()
        K4.reset_launches()
        t0 = time.perf_counter()
        y = st(x, ctx)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        launches = K4.launches
        for m in st.modules():
            if hasattr(m, "use_flash"):
                m.use_flash = False
        t0 = time.perf_counter()
        ref = st(x, ctx)
        torch.cuda.synchronize()
        sec_plain = time.perf_counter() - t0
    err = (y - ref).abs().max().item()
    print(f"[attention] SpatialTransformer(8 x 64 heads) on {tuple(x.shape)} with a "
          f"{tuple(ctx.shape)} context: {sec * 1e3:.2f} ms through K4 ({launches} launches), "
          f"{sec_plain * 1e3:.2f} ms through the plain attention; max abs err {err:.3g} "
          f"(atol {FORWARD_ATOL}), output max |y| {ref.abs().max().item():.3g}", flush=True)
    if tuple(y.shape) != tuple(x.shape) or not torch.isfinite(y).all():
        fail("SpatialTransformer output has the wrong shape or is not finite")
    if launches != 2:
        fail(f"SpatialTransformer launched the attention kernel {launches} times")
    if not err <= FORWARD_ATOL:
        fail(f"SpatialTransformer differs from the plain attention by {err}")
    # its two attentions are the first two shapes
    totals = {key: sum(p[key] for p in per_shape[:2])
              for key in ("ms", "plain_ms", "library_ms", "bound_ms")}
    totals["bound_by"] = per_shape[0]["bound_by"]
    return totals, max_err, launches


def kernel_name(line: str) -> str:
    """`conv_3x3_kernel<1,64,1,8,32>` from ptxas' line on a mangled
    template instance; the line itself where it is not one."""
    m = re.search(r"(\w+_kernel)I(\w+?)EEEv", line)
    if not m:
        return line.strip()
    head, args = m.groups()
    for size in range(len("_kernel"), len(head)):  # the name's length prefix
        if head[:-size].endswith(str(size)):
            head = head[-size:]
            break
    return f"{head}<{args.replace('Li', '').replace('E', ',')}>"


def build_phase(build):
    t0 = time.perf_counter()
    build.build_all()
    print(f"[build] {len(build.sources())} sources, one nvcc each, in parallel: "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    for name in build.sources():
        info = build.build_info[name]
        print(f"[build] {name}.cu: nvcc {info['seconds']:.2f} s")
        for line in info["log"].splitlines():
            if "Compiling entry function" in line:
                print(f"[build]   {kernel_name(line)}")
            elif "registers" in line or "spill" in line:
                print("[build]    ", line.strip())


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from tmdiff_tpu_torch.models.wavbest import WavBEST
    from tmdiff_tpu_torch.ops import modconv
    from tmdiff_tpu_torch.ops.cuda import build
    from tmdiff_tpu_torch.ops.cuda import conv2d as K3
    from tmdiff_tpu_torch.ops.cuda import conv3d as K
    from tmdiff_tpu_torch.ops.cuda import flash_attention as K4

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on {smi}; "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
          f"cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}", flush=True)
    t_start = time.perf_counter()
    build_phase(build)

    gen = torch.Generator(device=DEV).manual_seed(SEED)
    model = WavBEST(CHANNELS, device=DEV, seed=SEED)
    k1_totals, k1_err = kernel_phase(model, K, modconv, gen)
    k3_totals, k3_err = conv2d_phase(model, K3, modconv, gen)
    model_phase(model, K, gen)
    k1_launches, banded_results = serve_phase(model, K, SEED)
    if k1_launches == 0:
        fail("the main path launched no conv3d kernel")
    auto_counts = auto_serve_phase(model, K, K3, K4, banded_results, SEED)
    k4_totals, k4_err, k4_launches = attention_phase(K4, gen)
    print(f"[done] all phases in {time.perf_counter() - t_start:.1f} s", flush=True)

    per_request = (f"summed over the launches of one dpm++ request, 8 bands, batch {BATCH}, "
                   f"{SIZE}x{SIZE}, full width")
    kernels = [
        {"name": "conv3d_333", "route": "cuda", "source": "tmdiff_tpu_torch/csrc/conv3d.cu",
         "replaces": "tmdiff_tpu/ops/pallas/banded_conv3d.py:101",
         "replaces_also": "tmdiff_tpu/ops/pallas/banded_conv3d.py:182",
         "launches": k1_launches, "launches_auto": auto_counts["K1"], "max_abs_err": k1_err,
         "ms": k1_totals["ms"], "plain_ms": k1_totals["plain_ms"],
         "bound_ms": k1_totals["bound_ms"], "bound_by": k1_totals["bound_by"],
         "library_ms": k1_totals["library_ms"],
         "times_are": per_request + ' through the "banded" model'},
        {"name": "conv3x3_nhwc", "route": "cuda", "source": "tmdiff_tpu_torch/csrc/conv3d.cu",
         "replaces": "tmdiff_tpu/ops/pallas/conv2d.py:43",
         "launches": auto_counts["K3"], "max_abs_err": k3_err,
         "ms": k3_totals["ms"], "plain_ms": k3_totals["plain_ms"],
         "bound_ms": k3_totals["bound_ms"], "bound_by": k3_totals["bound_by"],
         "library_ms": k3_totals["library_ms"],
         "times_are": per_request + ' through the "auto" model'},
        {"name": "flash_attention", "route": "cuda",
         "source": "tmdiff_tpu_torch/csrc/flash_attention.cu",
         "replaces": "tmdiff_tpu/ops/pallas/flash_attention.py:80",
         "launches": k4_launches, "max_abs_err": k4_err,
         "ms": k4_totals["ms"], "plain_ms": k4_totals["plain_ms"],
         "bound_ms": k4_totals["bound_ms"], "bound_by": k4_totals["bound_by"],
         "library_ms": k4_totals["library_ms"],
         "times_are": f"summed over the two attentions of one SpatialTransformer forward, "
                      f"batch {BATCH}, 64x64x256, 8 heads x 64"},
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
