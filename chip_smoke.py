#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (an H100 is the
target): builds the CUDA kernels from `tmdiff_tpu_torch/csrc/`, holds each
against its plain PyTorch version at the shapes its path gives it, then
serves pansharpening requests on a seeded full-width WavBEST (channels
32, 64, 128, 256; 256x256, batch 2) under both conv lowerings with every
sampler, in fp32 and in bf16, serves both serving presets through the HTTP
server (`python -m tmdiff_tpu_torch.serve`), runs the attention library at
SD-style widths in fp32 and bf16, runs the library modules that reach no
TPU kernel on the card against the CPU, trains in fp32 and bf16, drives the
CLI's train, val and distill phases, runs the legacy UNet and its
ControlNet adapter in fp32 and bf16, and samples, trains and serves over a
("data", "space") mesh of four ranks.

    python3 chip_smoke.py
    python3 chip_smoke.py --mesh-only    # build and the mesh phase alone; with
                                         # four cards visible it adds NCCL

Phases (any failure ends the run with a non-zero exit code):
  1. build     compile every source under csrc/ with nvcc (sm_90a), all at
               once; print seconds and ptxas' register and spill report.
  2. kernel    K1/K2: record every distinct 3x3x3 conv the "banded" model
               launches (one encode + one denoise at 8 and at 4 bands); at
               each shape hold the K1 entry (the path's own options, then
               style + bias + accumulate) and the K2 entry (no options)
               against the plain version; name the kernel variant the shape
               takes; time kernel, plain version and F.conv3d (a yardstick
               only: TF32 off, cuDNN in benchmark mode after a warm-up) and
               compute the bound at the rate of the tensor-core variant's
               arithmetic (3xTF32: 495 / 3 TFLOP/s) for every shape, with
               the fp32 FMA bound (67 TFLOP/s) printed beside it.
     accumulation  K1 at K = 27 x 256 (8-band 64x64, 256 -> 256 and -> 64)
               with its channel steps forced over 1..16 splits beside the
               plan's count: the error against the accumulation chain's
               length, the planned one within 8e-5 of the output's scale and
               a chain at every channel step within 1e-5.
  3. conv2d    K3: the same for every band-folded 3x3 conv the "auto" model
               launches, against F.conv2d on the same banded operands; the
               bound counts the 2-D conv's own multiply-adds, printed beside
               the useful 3x3x3 ones.
  4. model     one fused forward at 8 bands with the kernel and with the plain
               convs on the card; compare; check the launch count.
  5. serve     the main path: a Pansharpener answers a WV3 8-band, a QB 4-band
               and a mixed QB/GF2 4-band request (batch 2 each, 30-step dpm++)
               through the "banded" model; launch counts reset just before
               and read just after, by kernel variant: every launch must
               take a tensor-core variant (the path's Cin are multiples of
               32). Then one request again through the plain convs,
               compared with the kernel's.
  6. auto      the WV3 and QB requests again through the "auto" model (K1 and
               K3), counts reset just before and read just after, by
               variant as in serve; each image against the "banded" one.
     bf16      the bf16 instances (K1/K2 with three depth taps, K3 with one)
               at every conv shape and option set of the bf16 model, 8 and
               4 bands ("banded" for K1, "auto" for K3): each entry against
               its plain bf16 version within one bf16 step, the variant a
               bf16 one, timings against the bf16 bound (989 TFLOP/s or
               3.35 TB/s) and the bf16 library conv; then the serve phase's
               WV3 request on the bf16 model through "banded" and "auto",
               counts reset just before and read just after: 1625 bf16
               launches and no fp32 one, the image within 1e-2 of the
               "banded" request through the plain bf16 convs and within
               5e-2 of the fp32 kernel request.
     http      a port checkpoint of the seeded model (EMA = weights) served
               by `python -m tmdiff_tpu_torch.serve` with each preset
               (serve_quality: 8 bands, ddim_cached 20; serve_lowlatency: 4
               bands, ddim 1; both bf16 and EMA, warmed up before binding)
               as subprocesses started together (nothing timed until both
               are healthy): per preset 16 concurrent 256x256 requests
               (WV2/WV3, QB/GF2), every reply 200; latency p50/p99, img/s,
               /v1/stats; the server's own launch counts (printed when
               SIGINT stops it): bf16 conv launches only; each image
               against a direct request in this process at its seed and
               bucket, to 2e-3.
     samplers  every other sampler of the Pansharpener, each request with
               the counts reset just before and read just after and its
               denoise, denoise_deep and denoise_reuse calls counted:
               dpm++_noise 20 steps (21 calls), dpm++_cfg 20 steps at
               guidance 3 and (3, 1.5) (20 calls at batch 4; both were 50
               steps before the bf16 and http phases came), regression
               (1), ddim 50 and 20,
               ddim_cached 20 at refresh_every 2 and cache levels 1 and 3
               and on a static 7-refresh schedule, all WV3 8-band batch 2
               256x256 "banded"; ancestral (T = 1000, 10 frames) on a QB
               4-band 128x128 image, batch 1; dpm++_cfg and ddim_cached
               through "auto" (K3); sample_tiled on a 512x512 QB scene
               (256 tiles, overlap 32, 8 crops a call, ddim 10). Each
               image (and the frames) against the same request through the
               plain convs; K1 and K3 launches by variant against the
               count the calls give; seconds and calls/s. Then each
               wrapper against its plain version at every (shape, options)
               the requests gave it.
  7. attention K4: flash attention against attention_reference and
               F.scaled_dot_product_attention (a yardstick only) at
               self-attention over 64x64 tokens (8 heads x 64), cross-attention
               to a one-token 768-wide prompt context, and a 32x32x256
               SpatialSelfAttention; each shape names its variant (it must
               be the tensor-core one), split count and key tile, gives the
               same bits on a second launch, and is timed (CUDA events, and
               each kernel's device time under torch.profiler) beside its
               bound at 3xTF32 (the fp32 FMA bound beside it); one D % 4 != 0
               shape holds the FMA variant against the plain version; then
               a SpatialTransformer forward (8 x 64 heads, 64x64x256 image,
               that context) through K4 and through the plain attention,
               counts reset just before. Then all of it again in bf16: K4's
               bf16 kernel at the three shapes (variant "bf16") against
               flash_attention_plain within one bf16 step, bit-identical on
               a second launch, one CUDA kernel a call where unsplit and no
               K/V pass (torch.profiler), timed beside its bound at the
               bf16 rate (989 TFLOP/s or 3.35 TB/s; the rate of its route,
               one bf16 product for S and two for P.V, 659 TFLOP/s,
               printed beside) and bf16 SDPA; the D = 42 shape on
               "bf16_fma"; a bf16 SpatialTransformer, 2 bf16 launches and
               no K/V pass, within 2e-2 of its scale of the plain attention.
     library   the library modules that reach no TPU kernel, each once on
               the card and once on the CPU on the same weights and inputs
               (batch 2, 8 bands): DynamicConv3d (K = 4, 64x64x64, 64 -> 64),
               PGCU (pan 256x256, ms 64x64), the Gaussian and free-PSF
               degradations (256x256), ChannelWiseAttention and
               AdaptiveGroupNorm (64x64x64), CompositeLoss and five loss-zoo
               losses (256x256), db2 dwt2d/idwt2d (256x256) and Haar
               dwt3d/idwt3d round trips; each output within 1e-4 of its
               scale, the round trips reconstructing their input, ms a call
               on the card.
  8. train     the training step (Trainer.train_step) of the full-width model
               with init_type "torch", on synthetic PanCollection-format
               scenes of 64x64 (WV3 8 bands, QB and GF2 4 bands), batch 8,
               the 4:4:8 SensorMixer through a DeviceFeeder of depth 2, the
               general_multi preset's settings (lr 1e-4, warmup 100, wd
               1e-4, EMA 0.9999, remat, L1, cosine schedule of 1000 steps):
               every parameter's gradient through K1 (forward and input
               gradient) against the plain convs at 8 and 4 bands; remat on
               and off with dropout on; 10 steps with the counts reset just
               before and read just after (K1 forward and input-gradient
               launches and weight gradients per step, K3 and K4 at 0);
               three steps twice from one seed; 30 steps at lr 2e-4 on one
               batch; the median step time at 8 and at 4 bands, a device-time
               breakdown of a step under torch.profiler, and K1's input
               gradient against the library's at every shape of a step.
               Then Trainer.compiled_step (lines "[train] graphed"), one CUDA
               graph of the whole step, against train_step from one start
               at 8 and 4 bands: the states bit for bit, the capture's
               seconds, each replay's K1 kernels read on the card by the
               profiler (130 forward + 65 input gradient in the captured
               order), both medians, the busy share, the peak memory, the
               card's name and power limit.
               Then bf16 training (lines "[train] bf16"): the same model as
               WavBEST(dtype=torch.bfloat16) on the same weights, every
               gradient through K1's bf16 instance against the plain bf16
               convs and the fp32 kernel at 8 bands (fixed t and noise,
               dropout off, the plain bf16 path's L1 signs); the bf16
               training forward against the served one; 10 steps of the
               preset through the mixer and feeder, counts reset just before
               and read just after (130 bf16 K1 forward + 65 input-gradient
               launches, 65 weight gradients, no fp32 launch, no plain conv
               a step; parameters, AdamW moments and EMA float32); two
               DistillTrainer steps with a bf16 student and teacher (5 x 65
               bf16 launches a step, no fp32 one); K1
               bf16's input gradient and the bf16 weight gradient at every
               shape of a step against their plain versions, timed beside
               the bf16 library and bound; the median 8-band step beside the
               fp32 step's and its device breakdown; the "[train] graphed
               bf16" lines as above.
  9. cli       the train/val entry point (tmdiff_tpu_torch/cli.py) at the
               general_multi preset's settings, through its `_run` seam on
               data built in memory: batch 8 of the train phase's 64x64
               scenes through the 4:4:8 mixer, two 256x256 scenes a sensor
               to validate, 7 steps through compiled_step (one capture a
               band count, then replays; one replay's K1 kernels read on the
               card), validation (EMA weights) and a checkpoint every 3,
               keep 2; counts reset just before the run and read just
               after. Then: I6 and I7 on disk and I3 pruned,
               the .mat files' shapes and stamp; I7 restored into a fresh
               state bit for bit, and one step on each bit for bit; a run
               stopped by SIGTERM after step 2 and resumed with
               path.resume "auto"; -p val on I7, its scores against the
               host's; I7 exported as a reference I7_gen.pth and imported
               back bit for bit. Prints s/step and img/s of the CLI loop,
               sec_per_image per sensor, checkpoint bytes and save/restore
               seconds.
 10. distill   `-p distill` through the CLI's `_run` from the cli phase's
               I7 checkpoint (EMA teacher): phases N = 10 and 5 of 6 steps
               on the train phase's batches, each student checkpointed
               (distill_N10, distill_N5, the student in both weight slots)
               and validated with ddim at N steps, each phase's steps
               through its DistillTrainer's compiled_step (one replay's K1
               kernels read on the card: two teacher calls and the
               student's forward and remat recompute through K1, its input
               gradient); counts reset just before and read just after (on
               the host they tick at each capture's eager step and
               capture). Then the distillation loss and every
               gradient through K1 against the plain convs at 8 and 4 bands
               from I7, with the plain path's L1 signs; prints s/step.
 11. controlnet the legacy UNet and the ControlNet adapter
               (models/legacy_unet.py, models/controlnet.py) at their
               defaults (channels 32, 64, 128, 256), 8 bands, batch 2,
               256x256, a live adapter (zero convs drawn off zero): a
               LegacyUNet and a ControlledLegacyUNet forward through K1
               against the plain convs (34 and 43 K1 launches, 9 and 19
               library convs: strided, transposed and the hint encoder's
               (1, 3, 3)); a 20-step ddim request with the controlled
               model against the plain convs; one fine-tune step
               (sd_locked) with every trainable gradient against the plain
               path's (its L1 signs), no gradient on the base encoder, the
               frozen weights unchanged by the Adam step; the controlled
               forward's K1 and library convs timed call by call. Then in
               bf16 on the same weights (lines "[controlnet] bf16"), at the
               JAX package's flagship legacy geometry (batch 8, its
               benchmarks/controlnet_bench.py): LegacyUNet, the controlled
               model and its only_mid_control twin, forward ms and img/s
               and controlled_over_base / mid_only_over_base, each against
               the plain bf16 convs, bf16 K1 launches only, library convs
               by kind; every K1 launch of the controlled forward against
               its plain version (H 256, 127, 63, 31; three parts), timed;
               a bf16 20-step controlled ddim and an sd_locked fine-tune
               step at batch 2 against the plain bf16 convs.
 12. mesh      the ("data", "space") mesh (tmdiff_tpu_torch/parallel/): four
               ranks spawned by parallel/dryrun.py on card 0 over gloo through
               host memory, the full-width seeded model written once; the WV3
               8-band batch 4 256x256 dpm++ request (10 steps) on (2, 2) and
               (1, 4) and the QB 4-band batch 1 512x512 request on (1, 4), each
               rank's image against the single-process image on the card, K1
               launches per rank 13 + 52 a denoise call, none off the tensor
               cores, no plain conv; the training step (WV3 8 bands, batch 8,
               64x64) on (2, 2): the train phase's gradient check and 3 steps
               against one process; seconds, halo exchanges and bytes per
               request, collectives per step, each mesh's backend; a
               strided, a 5x5 and a transposed library conv (fp32, bf16) on
               a (1, 2) space split of each data row against one process,
               output and gradients. With four
               cards visible the same under NCCL, a card a rank, and with two
               the training steps data-parallel on two cards. Then the meshed
               server: `python -m tmdiff_tpu_torch.serve`'s main() on the
               four gloo ranks (serve/mesh.py: rank 0 serves HTTP, the
               others follow), serve_lowlatency and serve_quality on (4, 1)
               and serve_quality on (2, 2), 16 concurrent requests each
               after the preset's warm-up, then SIGINT: every rank's
               launches bf16 on the tensor cores and as many batches as rank
               0, each image within 1e-2 of its one-process replay at its
               (seed, bucket, row), img/s and p50/p99 beside the http
               phase's; with four cards the same through torchrun under
               NCCL.
The last two lines of standard output are the card's name and power limit
and {"ok": true, "device": {...}}; the line before them is the
{"kernels": [...]} summary (K1, K3, K4, K1 bf16, K3 bf16, K4 bf16).

Tolerances (fp32 everywhere, TF32 off): a conv agrees with its plain version
to 1e-4 of the output's largest magnitude (fp32 sums of up to 27 * 256 or
9 * 512 terms in another order); attention to 2e-5 absolute at unit-normal
inputs (the JAX package's flash-attention bar); a forward pass to 5e-4
absolute, the repository's forward parity bar; a sampled image to 2e-3, its
sampling bar. Training: the L1 loss through K1 agrees with the plain
convs' to 1e-4 relative and every parameter's gradient to 1e-3 of its
largest magnitude (fp32 sums over a whole backward pass, 3xTF32 in K1,
cuDNN's fp32 weight gradient), both backward passes taking the L1 sign of
the plain path's prediction, which the x0 predictions must back: they agree
to 1e-5 absolute, and every element whose sign differs lies within their
difference of its target; remat on and off agree bit for bit. The CLI:
a restored checkpoint and a step after it bit for bit; the scores on the
card against the host's: SAM to 1e-5 relative (the numpy suite's), SSIM to
1e-3 (the host's Gaussian-window SSIM, the same statistic; the numpy
suite's uniform-window SSIM is printed beside it). Distillation: the loss
to 1e-4 relative and every gradient to 1e-3 of its scale as in training;
(prediction - target) to 1e-4 absolute, since the target passes two
teacher calls and a division by down to 0.155. bf16: a conv or an attention within one
bf16 step of its plain bf16 version (each element within half a bf16 step
of each side's value, two roundings of fp32 sums taken in another order,
plus the fp32 conv bar for the accumulation); a bf16 request within 1e-2
of the plain bf16 convs' (bf16 noise over 31 calls: a quantum of bf16 is
3.9e-3 at 1) and within 5e-2 of the fp32 request; a served image within
2e-3 of the same batch sampled in this process. The mesh: every rank's
image within 2e-3 of one process's (the sampling bar; K1 and K3 take the
unsharded call's split count, so a shard sums as one process does: 0 on
the card but for the 1x1x1 convs' and Linears' library products), the
training losses within 1e-4 relative, the gradients as in
the train phase; a meshed served bf16 image within 1e-2 of its one-process
replay (the bf16 request bar). The legacy
models: a forward through K1 within 5e-4 of the plain convs', the ddim
request within 2e-3, the fine-tune gradients as in the train phase; in
bf16 a forward and the ddim request within 1e-2 of their scale of the plain
bf16 convs'. bf16 training: every gradient through K1's bf16 instance
within twice the plain bf16 path's own gap to fp32 (floored at its median
over the parameters) and within 5e-2 of its scale of the plain bf16 path's;
the bf16 weight gradient within one bf16 step plus 1e-4 of scale of fp32
sums of the same operands.
"""
from __future__ import annotations

import contextlib
import copy
import dataclasses
import json
import logging
import os
import re
import shutil
import signal
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

CHANNELS = (32, 64, 128, 256)
SIZE, BATCH, SEED = 256, 2, 0
PEAK_FP32_FLOPS = 67e12  # H100 SXM, fp32 outside the tensor cores
PEAK_TF32X3_FLOPS = 495e12 / 3  # H100 SXM TF32 tensor cores, three products per multiply-add
PEAK_BYTES = 3.35e12     # H100 SXM HBM3
CONV_RTOL = 1e-4
# the weight-gradient kernel against cuDNN's fp32 weight gradient, of the
# gradient's scale: tests/test_torch_cuda.py's WGRAD_RTOL
WGRAD_RTOL = 5e-5
# K1 at its deepest sums (K = 27 x 256): one accumulation chain over the 16
# channel steps gave up to 5.96e-5 of the output's scale, a chain at every
# step (N tiles of 64, or 16 splits) 3.0-3.4e-6 (NVIDIA H100 80GB HBM3, 700 W)
K1_DEEP_SUM_RTOL, ONE_STEP_CHAIN_RTOL = 8e-5, 1e-5
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
# A head dim that is not a multiple of 4 takes the FMA variant.
FMA_ATTENTION_SHAPE = ((BATCH, 2, 300, 42), 200)
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


def library_ms(fn, reps: int) -> float:
    """cuda_ms of a PyTorch yardstick with cuDNN in benchmark mode: the
    warm-up call picks the algorithm (TF32 stays off)."""
    before = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = True
    try:
        fn()
        return cuda_ms(fn, reps)
    finally:
        torch.backends.cudnn.benchmark = before


def launched_variant(module, fn):
    """fn()'s result and the kernel variant it launched (module: a conv
    wrapper with per-variant launch counts)."""
    before = dict(module.variant_launches)
    out = fn()
    (variant,) = [v for v, n in module.variant_launches.items() if n != before[v]]
    return out, variant


def valid_taps(n: int) -> int:
    """Sum over n positions of the 3-tap window entries that fall inside."""
    return 1 if n == 1 else 3 * n - 2


def bound(flops: float, nbytes: float, peak: float = PEAK_FP32_FLOPS):
    t_ops, t_bytes = flops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def conv_bound(b, d, h, w, cin, cout, style, bias, accumulate, peak, elem_bytes=4):
    flops = 2.0 * b * cin * cout * valid_taps(d) * valid_taps(h) * valid_taps(w)
    nbytes = elem_bytes * (b * d * h * w * (cin + cout * (2 if accumulate else 1))
                    + 27 * cin * cout + (b * cin if style else 0) + (cout if bias else 0))
    return bound(flops, nbytes, peak)


def make_batch(rng, bands):
    ms = rng.uniform(0.05, 0.95, (BATCH, bands, SIZE, SIZE)).astype(np.float32)
    pan = (ms.mean(1, keepdims=True)
           + 0.05 * rng.standard_normal((BATCH, 1, SIZE, SIZE))).astype(np.float32)
    return {"PAN": pan, "MS": ms}


def record_calls(model, modconv, attr, pan, ms, prompt, x_t, t):
    """Runs encode + denoise once; returns {(phase, shape, flags, pre): count}
    of the calls to `modconv.<attr>` (a kernel wrapper), shape = x's shape +
    (Cout,), flags = which optional arguments were given, pre = (shift
    given, SiLU given), the pre-activation the call hands on."""
    seen = {}
    original = getattr(modconv, attr)
    phase = ["encode"]

    def recorder(x, kernel, *rest, **pre):
        key = (phase[0], tuple(x.shape) + (kernel.shape[-1],), tuple(a is not None for a in rest),
               (pre.get("shift") is not None, pre.get("act") is not None))
        seen[key] = seen.get(key, 0) + 1
        return original(x, kernel, *rest, **pre)

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
    """{(bands, shape, flags, pre): launches per dpm++ request} of one
    wrapper (record_calls' keys)."""
    shapes = {}
    for bands in (8, 4):
        pan = torch.rand(BATCH, 1, SIZE, SIZE, device=DEV, generator=gen)
        ms = torch.rand(BATCH, bands, SIZE, SIZE, device=DEV, generator=gen)
        x_t = torch.randn(BATCH, bands, SIZE, SIZE, device=DEV, generator=gen)
        prompt = torch.randn(PROMPT_DIM, device=DEV, generator=gen)
        t = torch.full((BATCH,), 500.0, device=DEV)
        for (phase, shape, flags, pre), n in record_calls(model, modconv, attr, pan, ms,
                                                          prompt, x_t, t).items():
            key = (bands, shape, flags, pre)
            shapes[key] = shapes.get(key, 0) + n * (NFE if phase == "denoise" else 1)
    return shapes


def kernel_phase(model, K, modconv, gen):
    # ((b, d, h, w, cin, cout), (style, bias, accumulate)) -> {bands: launches per request}
    # (the fp32 kernel takes no pre-activation: a conv given one counts with its shape)
    shapes = {}
    for (bands, shape, flags, _), n in path_shapes(model, modconv, "banded_conv3d",
                                                   gen).items():
        per = shapes.setdefault((shape, flags), {})
        per[bands] = per.get(bands, 0) + n
    print(f"[kernel] {len(shapes)} distinct 3x3x3 conv shapes and options", flush=True)
    totals = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0,
              "fp32_ffma_bound_ms": 0.0, "ops_s": 0.0, "bytes_s": 0.0}
    max_err = max_rel = deep_rel = 0.0
    variants = {}
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
                got, variant = launched_variant(
                    K, lambda: fn(x, k, st, bi, None if out is None else out.clone()))
                ref = K.conv3d_plain(x, k, st, bi, None if out is None else out.clone())
                torch.cuda.synchronize()
                err = (got - ref).abs().max().item()
                scale = ref.abs().max().item()
                if not err <= CONV_RTOL * scale:
                    fail(f"conv {shape} {fn.__name__}: max abs err {err} > {CONV_RTOL} x {scale}")
                errs.append(err)
                max_err, max_rel = max(max_err, err), max(max_rel, err / scale)
                if cin == 256:
                    deep_rel = max(deep_rel, err / scale)
            st, bi = path
            out = out0.clone() if acc else None
            ms_k = cuda_ms(lambda: K.banded_conv3d(x, k, st, bi, out), 10)
            ms_p = cuda_ms(lambda: K.conv3d_plain(x, k, st, bi, out), 1)
            xs = (x * s[:, None, None, None, :] if has_style else x).permute(0, 4, 1, 2, 3)
            wl = k.permute(4, 3, 0, 1, 2).contiguous()
            ms_l = library_ms(lambda: F.conv3d(xs, wl, bi, padding=1), 10)
        bnd, bound_by = conv_bound(b, d, h, w, cin, cout, has_style, has_bias, acc,
                                   PEAK_TF32X3_FLOPS)
        ffma_bnd, _ = conv_bound(b, d, h, w, cin, cout, has_style, has_bias, acc,
                                 PEAK_FP32_FLOPS)
        n8 = per.get(8, 0)
        variants[variant] = variants.get(variant, 0) + n8 + per.get(4, 0)
        print(f"[kernel] B{b} D{d} {h}x{w} {cin}->{cout} style={int(has_style)} "
              f"bias={int(has_bias)} acc={int(acc)} variant={variant} launches/request "
              f"8-band={n8} 4-band={per.get(4, 0)} ms={ms_k:.4f} plain_ms={ms_p:.4f} "
              f"library_ms={ms_l:.4f} bound_ms={bnd:.4f} ({bound_by}) "
              f"fp32_ffma_bound_ms={ffma_bnd:.4f} share_of_bound={bnd / ms_k:.3f} "
              f"err(K1 path, K1 all, K2 none)={errs[0]:.3g},{errs[1]:.3g},{errs[2]:.3g}",
              flush=True)
        for key, v in (("ms", ms_k), ("plain_ms", ms_p), ("library_ms", ms_l), ("bound_ms", bnd),
                       ("fp32_ffma_bound_ms", ffma_bnd)):
            totals[key] += n8 * v
        totals["ops_s" if bound_by == "operations" else "bytes_s"] += n8 * bnd
    totals["bound_by"] = "operations" if totals["ops_s"] >= totals["bytes_s"] else "bytes"
    print(f"[kernel] worst error / output scale at K = 27 x 256 (Cin 256): {deep_rel:.3g} "
          f"(bar {K1_DEEP_SUM_RTOL})", flush=True)
    if not deep_rel <= K1_DEEP_SUM_RTOL:
        fail(f"conv at K = 27 x 256: {deep_rel} of its scale > {K1_DEEP_SUM_RTOL}")
    print(f"[kernel] one 8-band batch-{BATCH} request, summed over its convs: "
          f"kernel {totals['ms']:.1f} ms, plain {totals['plain_ms']:.1f} ms, "
          f"F.conv3d {totals['library_ms']:.1f} ms, bound {totals['bound_ms']:.1f} ms "
          f"(fp32 FMA bound {totals['fp32_ffma_bound_ms']:.1f} ms); "
          f"max abs err {max_err:.3g}, max err / output scale {max_rel:.3g}; "
          f"variants over the 8- and 4-band launches per request {variants}", flush=True)
    return totals, max_err


@contextlib.contextmanager
def forced_splits(K, splits):
    """Within the block every tensor-core launch of K1 splits its 16-channel
    steps over `splits` blocks (at most one a step), as the C plan gives
    that count with its workspace: each accumulation chain spans fewer
    steps."""
    import ctypes

    planned = K.plan

    def plan(kd, x, d, cout, unsharded=None):
        b, h, w, cin = x.shape[0], x.shape[-3], x.shape[-2], x.shape[-1]
        nbytes, count = ctypes.c_longlong(0), ctypes.c_int(splits)
        variant = K.library().tmdiff_conv_plan(kd, K.DTYPES[x.dtype], b, d, h, w, cin, cout,
                                               x.data_ptr(), ctypes.byref(nbytes),
                                               ctypes.byref(count))
        workspace = torch.empty(nbytes.value, dtype=torch.uint8, device=x.device)
        return K.VARIANTS[variant], count.value, workspace

    K.plan = plan
    try:
        yield
    finally:
        K.plan = planned


def accumulation_phase(K, gen):
    """K1's error against the length of its accumulation chains, at the
    8-band 64x64 level's K = 27 x 256: the channel steps forced over 1, 2,
    4, 8 and 16 splits beside the plan's own count. With N tiles of 128
    (Cout 256) each split is one chain, 16 down to 1 of the 16 steps; with
    N tiles of 64 (Cout 64) every channel step starts a chain whatever the
    split count. Returns the planned shapes' worst error."""
    worst = 0.0
    for cout in (256, 64):
        x = torch.randn(BATCH, 8, 64, 64, 256, device=DEV, generator=gen)
        k = torch.randn(3, 3, 3, 256, cout, device=DEV, generator=gen) / (27 * 256) ** 0.5
        errs = {}
        with torch.no_grad():
            ref = K.conv3d_plain(x, k)
            for splits in (None, 1, 2, 4, 8, 16):
                with forced_splits(K, splits) if splits else contextlib.nullcontext():
                    got = K.banded_conv3d(x, k)
                torch.cuda.synchronize()
                errs[splits or "planned"] = rel_to_scale(got, ref)
        planned = K.plan(3, x, 8, cout)[1]
        worst = max(worst, errs["planned"])
        one_step = [errs[16]] if cout == 256 else list(errs.values())
        print(f"[accumulation] B{BATCH} D8 64x64 256->{cout} (K = 6912): error / output scale "
              f"by split count {', '.join(f'{n}: {e:.3g}' for n, e in errs.items())} "
              f"(the plan splits {planned} ways; bar {K1_DEEP_SUM_RTOL}, a chain at every "
              f"channel step {ONE_STEP_CHAIN_RTOL})", flush=True)
        if not (errs["planned"] <= K1_DEEP_SUM_RTOL and max(one_step) <= ONE_STEP_CHAIN_RTOL):
            fail(f"K1 at K = 6912, 256 -> {cout}: {errs}")
    return worst


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
              "fp32_ffma_bound_ms": 0.0, "ops_s": 0.0, "bytes_s": 0.0, "flops": 0.0,
              "useful_flops": 0.0}
    max_err = max_rel = 0.0
    variants = {}
    for (bands, shape, (has_style, has_bias), _), n in sorted(shapes.items()):
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
                got, variant = launched_variant(K3, lambda: K3.conv3x3_nhwc(x, w2, *args))
                ref = K3.conv3x3_nhwc_plain(x, w2, *args)
                torch.cuda.synchronize()
                err = (got - ref).abs().max().item()
                scale = ref.abs().max().item()
                if not err <= CONV_RTOL * scale:
                    fail(f"conv2d {shape}: max abs err {err} > {CONV_RTOL} x {scale}")
                errs.append(err)
                max_err, max_rel = max(max_err, err), max(max_rel, err / scale)
            ms_k = cuda_ms(lambda: K3.conv3x3_nhwc(x, w2, st, bi), 10)
            ms_p = cuda_ms(lambda: K3.conv3x3_nhwc_plain(x, w2, st, bi), 1)
            xs = (x * s[:, None, None, :] if has_style else x).permute(0, 3, 1, 2)
            wl = w2.permute(3, 2, 0, 1).contiguous()
            ms_l = library_ms(lambda: F.conv2d(xs, wl, bi, padding=1), 10)
        flops = 2.0 * b * c2 * cout2 * valid_taps(h) * valid_taps(w)
        useful = 2.0 * b * cin * cout * valid_taps(d) * valid_taps(h) * valid_taps(w)
        nbytes = 4.0 * (b * h * w * (c2 + cout2) + 9 * c2 * cout2
                        + (b * c2 if has_style else 0) + (cout2 if has_bias else 0))
        bnd, bound_by = bound(flops, nbytes, PEAK_TF32X3_FLOPS)
        ffma_bnd, _ = bound(flops, nbytes, PEAK_FP32_FLOPS)
        variants[variant] = variants.get(variant, 0) + n
        print(f"[conv2d] bands={d} B{b} {h}x{w} {c2}->{cout2} ({cin}->{cout} per band) "
              f"style={int(has_style)} bias={int(has_bias)} variant={variant} "
              f"launches/request={n} ms={ms_k:.4f} plain_ms={ms_p:.4f} library_ms={ms_l:.4f} "
              f"bound_ms={bnd:.4f} ({bound_by}) fp32_ffma_bound_ms={ffma_bnd:.4f} "
              f"share_of_bound={bnd / ms_k:.3f} GFLOP 2-D={flops / 1e9:.2f} "
              f"useful 3x3x3={useful / 1e9:.2f} ({flops / useful:.2f}x) "
              f"err(path, style+bias)={errs[0]:.3g},{errs[1]:.3g}", flush=True)
        if d == 8:
            for key, v in (("ms", ms_k), ("plain_ms", ms_p), ("library_ms", ms_l),
                           ("bound_ms", bnd), ("fp32_ffma_bound_ms", ffma_bnd), ("flops", flops),
                           ("useful_flops", useful)):
                totals[key] += n * v
            totals["ops_s" if bound_by == "operations" else "bytes_s"] += n * bnd
    totals["bound_by"] = "operations" if totals["ops_s"] >= totals["bytes_s"] else "bytes"
    print(f"[conv2d] one 8-band batch-{BATCH} auto request, summed over its K3 convs: "
          f"kernel {totals['ms']:.1f} ms, plain {totals['plain_ms']:.1f} ms, "
          f"F.conv2d {totals['library_ms']:.1f} ms, bound {totals['bound_ms']:.1f} ms "
          f"(fp32 FMA bound {totals['fp32_ffma_bound_ms']:.1f} ms); "
          f"2-D GFLOP {totals['flops'] / 1e9:.1f} for {totals['useful_flops'] / 1e9:.1f} useful; "
          f"max abs err {max_err:.3g}, max err / output scale {max_rel:.3g}; "
          f"variants over the 8- and 4-band launches per request {variants}", flush=True)
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
    """Counts the model's denoise calls while installed: `calls` all of
    them (denoise, denoise_deep, denoise_reuse), `reuse_calls` those on a
    cached trunk."""

    NAMES = ("denoise", "denoise_deep", "denoise_reuse")

    def __init__(self, model):
        self.model, self.calls, self.reuse_calls = model, 0, 0

    def __enter__(self):
        for name in self.NAMES:
            fn = getattr(self.model, name)

            def counted(*args, _fn=fn, _reuse=name == "denoise_reuse", **kw):
                self.calls += 1
                self.reuse_calls += _reuse
                return _fn(*args, **kw)

            setattr(self.model, name, counted)
        return self

    def __exit__(self, *exc):
        for name in self.NAMES:
            delattr(self.model, name)


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
            nfe.calls, before = 0, dict(K.variant_launches)
            t0 = time.perf_counter()
            img = sharp.sample(batch, sensor=sensor, method="dpm++", seed=seed + i)
            sec = time.perf_counter() - t0
            per_variant = {v: K.variant_launches[v] - before[v] for v in K.VARIANTS}
            results.append((sensor, batch, img, sec, nfe.calls, per_variant))
        launches, variants = K.launches, dict(K.variant_launches)
    expected = ENCODE_CONVS + NFE * DENOISE_CONVS
    for sensor, batch, img, sec, calls, per_variant in results:
        bands = batch["MS"].shape[1]
        ok = check_image(img, batch)
        n = sum(per_variant.values())
        print(f"[serve] sensor={sensor} bands={bands} batch={BATCH} {SIZE}x{SIZE}: "
              f"{sec:.3f} s, NFE {calls}, {calls / sec:.2f} denoise calls/s, "
              f"{n} kernel launches (expected {expected}) by variant {per_variant}, "
              f"finite and in [0, 1]: {ok}", flush=True)
        if not ok or calls != NFE or n != expected:
            fail(f"request {sensor}: ok={ok} nfe={calls} launches={n}")
        if per_variant["ffma"]:
            fail(f"request {sensor}: {per_variant['ffma']} launches off the tensor cores")
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
    return launches, variants, results


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
                nfe.calls, v1, v3 = 0, dict(K.variant_launches), dict(K3.variant_launches)
                t0 = time.perf_counter()
                img = sharp.sample(batch, sensor=sensor, method="dpm++", seed=seed + i)
                sec = time.perf_counter() - t0
                v1 = {v: K.variant_launches[v] - v1[v] for v in K.VARIANTS}
                v3 = {v: K3.variant_launches[v] - v3[v] for v in K.VARIANTS}
                k1, k3 = sum(v1.values()), sum(v3.values())
                err = float(np.abs(img - ref).max())
                ok = check_image(img, batch)
                print(f"[auto] sensor={sensor} bands={batch['MS'].shape[1]} batch={BATCH} "
                      f"{SIZE}x{SIZE}: {sec:.3f} s, NFE {nfe.calls}, "
                      f"{nfe.calls / sec:.2f} denoise calls/s, K1 launches {k1} {v1}, "
                      f"K3 launches {k3} {v3}, max abs err vs the banded request {err:.3g} "
                      f"(atol {SAMPLE_ATOL}), finite and in [0, 1]: {ok}", flush=True)
                if not ok or nfe.calls != NFE or k1 + k3 != ENCODE_CONVS + NFE * DENOISE_CONVS:
                    fail(f"auto request {sensor}: ok={ok} nfe={nfe.calls} launches={k1}+{k3}")
                if v1["ffma"] or v3["ffma"]:
                    fail(f"auto request {sensor}: launches off the tensor cores")
                if not err <= SAMPLE_ATOL:
                    fail(f"auto request {sensor} differs from the banded one by {err}")
            counts = {"K1": K.launches, "K3": K3.launches, "K4": K4.launches,
                      "K3_variants": dict(K3.variant_launches)}
    finally:
        model.use_conv_impl("banded")
    if counts["K3"] == 0:
        fail("the auto requests launched no conv3x3_nhwc kernel")
    if counts["K4"] != 0:
        fail("the auto requests launched a kernel off their path")
    return counts


PEAK_BF16_FLOPS = 989e12  # H100 SXM bf16 tensor cores, dense
# A bf16 conv against its plain version: every element within half a bf16
# step of each side's value (two roundings of fp32 sums taken in another
# order land at most one step apart) plus the fp32 conv bar for the tensor
# cores' accumulation.
BF16_CONV_RTOL = CONV_RTOL
# A launch given the pre-activation silu(x + shift): K1's SiLU (the MUFU's
# ex2 and rcp) rounds about one operand element in a thousand one bf16 step
# from F.silu's, which moves each output by its weights times that step:
# one bf16 step at the output's scale, as tests/test_torch_cuda.py holds it.
BF16_PREACT_RTOL = 2.0 ** -7
BF16_SAMPLE_ATOL = 1e-2  # a bf16 request against itself through the plain bf16 convs
BF16_VS_FP32 = 5e-2      # a bf16 request against the fp32 kernel request
BF16_VARIANTS = {"bf16", "bf16_splitk"}


def bf16_half_step(t):
    a = t.float().abs()
    e = torch.floor(torch.log2(torch.where(a > 0, a, torch.ones_like(a))))
    return torch.where(a > 0, torch.exp2(e - 8), torch.zeros_like(a))


def bf16_check(got, ref, what, rtol=BF16_CONV_RTOL):
    """Holds a bf16 kernel output against its plain version (module note
    above BF16_CONV_RTOL; BF16_PREACT_RTOL for a launch given a
    pre-activation); returns the largest |got - ref|."""
    torch.cuda.synchronize()
    if got.dtype != torch.bfloat16 or ref.dtype != torch.bfloat16:
        fail(f"{what}: dtypes {got.dtype} / {ref.dtype}, expected bfloat16")
    diff = (got.float() - ref.float()).abs()
    scale = ref.float().abs().max().item()
    over = diff > bf16_half_step(got) + bf16_half_step(ref) + rtol * scale
    if over.any():
        fail(f"{what}: {int(over.sum())} elements beyond one bf16 step of the plain version")
    return diff.max().item()


def bf16_conv_shapes(K, K3, modconv, model, gen):
    """The bf16 K1 and K3 instances at every conv shape (with options and
    pre-activation) of the bf16 model's one encode + one denoise at 8 and 4
    bands, "banded" for K1 and "auto" for K3: each entry (the path's
    options, then all of them, each with the path's pre-activation; K1's
    shapes also through the K2 entry without either) against its plain
    version, the variant taken, and times of kernel and plain version as
    the path calls them and of the bf16 library conv (cuDNN, benchmark
    mode, on the activated and styled operand) beside the bf16 bound.
    Returns per-request totals (8-band request) for each kernel and the
    largest error."""
    out = {}
    for name, mod, impl in (("conv3d", K, "banded"), ("conv3x3_nhwc", K3, "auto")):
        model.use_conv_impl(impl)
        try:
            shapes = path_shapes(model, modconv, "banded_conv3d" if mod is K else "conv3x3_nhwc",
                                 gen)
        finally:
            model.use_conv_impl("banded")
        totals = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0,
                  "ops_s": 0.0, "bytes_s": 0.0, "max_abs_err": 0.0, "shapes": len(shapes)}
        for (bands, shape, flags, (has_shift, has_act)), n in sorted(shapes.items()):
            *lead, cin, cout = shape
            taps = (3, 3, 3) if mod is K else (3, 3)
            x = torch.randn(*lead, cin, device=DEV, generator=gen).bfloat16()
            n_taps = 27 if mod is K else 9
            k = (torch.randn(*taps, cin, cout, device=DEV, generator=gen)
                 / (n_taps * cin) ** 0.5).bfloat16()
            s = (1.0 + 0.5 * torch.randn(lead[0], cin, device=DEV, generator=gen)).bfloat16()
            bias = torch.randn(cout, device=DEV, generator=gen).bfloat16()
            acc = torch.randn(*lead, cout, device=DEV, generator=gen).bfloat16()
            sh = torch.randn(lead[0], cin, device=DEV, generator=gen).bfloat16()
            pre = {"shift": sh if has_shift else None, "act": "silu"} if has_act else {}
            plain_fn = K.conv3d_plain if mod is K else K3.conv3x3_nhwc_plain
            entry = getattr(mod, "banded_conv3d" if mod is K else "conv3x3_nhwc")
            entries = [(entry, flags, pre), (entry, (True,) * len(flags), pre)]
            if mod is K:
                entries.append((K.banded_conv3d_v2, (False, False, False), {}))
            errs = []
            with torch.no_grad():
                for fn, given, kw in entries:
                    opts = [t if f else None for t, f in zip((s, bias, acc), given)]
                    fresh = lambda: [t.clone() if t is acc else t for t in opts]
                    got, variant = launched_variant(mod, lambda: fn(x, k, *fresh(), **kw))
                    if variant not in BF16_VARIANTS:
                        fail(f"bf16 {name} {shape} took the {variant} variant")
                    errs.append(bf16_check(got, plain_fn(x, k, *fresh(), **kw),
                                           f"bf16 {name} {shape} {fn.__name__} {given} "
                                           f"shift={has_shift and bool(kw)} silu={bool(kw)}",
                                           BF16_PREACT_RTOL if kw else BF16_CONV_RTOL))
                opts = [t if f else None for t, f in zip((s, bias, acc), flags)]
                ms_k = cuda_ms(lambda: entry(x, k, *opts, **pre), 10)
                ms_p = cuda_ms(lambda: plain_fn(x, k, *opts, **pre), 1)
                perm = (0, 4, 1, 2, 3) if mod is K else (0, 3, 1, 2)
                xa = K.preact(x, **pre)
                xs = (xa * s.view(lead[0], *[1] * (len(lead) - 1), cin) if flags[0] else xa)
                wl = k.permute(len(taps) + 1, len(taps), *range(len(taps))).contiguous()
                conv = F.conv3d if mod is K else F.conv2d
                bi = bias if flags[1] else None
                ms_l = library_ms(lambda: conv(xs.permute(*perm), wl, bi, padding=1), 10)
            positions = int(np.prod(lead))
            if mod is K:
                b, d, h, w = lead
                flops = 2.0 * b * cin * cout * valid_taps(d) * valid_taps(h) * valid_taps(w)
            else:
                b, h, w = lead
                flops = 2.0 * b * cin * cout * valid_taps(h) * valid_taps(w)
            nbytes = 2.0 * (positions * (cin + cout * (2 if len(flags) > 2 and flags[2] else 1))
                            + n_taps * cin * cout + (lead[0] * cin if flags[0] else 0)
                            + (cout if flags[1] else 0) + (lead[0] * cin if has_shift else 0))
            bnd, bound_by = bound(flops, nbytes, PEAK_BF16_FLOPS)
            print(f"[bf16] {name} bands={bands} {tuple(lead)} {cin}->{cout} options={flags} "
                  f"shift={int(has_shift)} silu={int(has_act)} variant={variant} launches/request={n} ms={ms_k:.4f} plain_ms={ms_p:.4f} "
                  f"library_ms(bf16)={ms_l:.4f} bound_ms={bnd:.4f} ({bound_by}) "
                  f"share_of_bound={bnd / ms_k:.3f} max abs err={max(errs):.3g}", flush=True)
            totals["max_abs_err"] = max(totals["max_abs_err"], *errs)
            if bands == 8:
                for key, v in (("ms", ms_k), ("plain_ms", ms_p), ("library_ms", ms_l),
                               ("bound_ms", bnd)):
                    totals[key] += n * v
                totals["ops_s" if bound_by == "operations" else "bytes_s"] += n * bnd
        totals["bound_by"] = "operations" if totals["ops_s"] >= totals["bytes_s"] else "bytes"
        print(f"[bf16] {name}: {totals['shapes']} shapes; one 8-band batch-{BATCH} {impl} bf16 "
              f"request, summed: kernel {totals['ms']:.1f} ms, plain {totals['plain_ms']:.1f} ms, "
              f"library {totals['library_ms']:.1f} ms, kernel/library "
              f"{totals['ms'] / totals['library_ms']:.3f}, bound {totals['bound_ms']:.1f} ms "
              f"({totals['bound_by']}); max abs err {totals['max_abs_err']:.3g}", flush=True)
        out[name] = totals
    return out


def bf16_phase(K, K3, modconv, gen, banded_results, seed):
    """The bf16 instances at every bf16 path shape, then the serve phase's
    WV3 8-band dpm++ request on the bf16 model (same seed, same weights)
    through "banded" and "auto": counts reset just before each request and
    read just after, every conv launch a bf16 one; each image against the
    "banded" request through the plain bf16 convs and against the fp32
    kernel request."""
    from tmdiff_tpu_torch.models.wavbest import WavBEST
    from tmdiff_tpu_torch.pipeline import Pansharpener

    model = WavBEST(CHANNELS, device=DEV, seed=SEED, dtype=torch.bfloat16)
    totals = bf16_conv_shapes(K, K3, modconv, model, gen)
    sharp = Pansharpener(model, device=DEV)
    sensor, batch, img32, sec32 = banded_results[0][:4]
    requests, plain, plain_sec = {}, None, None
    for impl in ("banded", "auto"):
        model.use_conv_impl(impl)
        try:
            sharp.sample(batch, sensor=sensor, seed=seed, steps=2)  # warm-up, outside the count
            torch.cuda.synchronize()
            K.reset_launches()
            K3.reset_launches()
            t0 = time.perf_counter()
            img = sharp.sample(batch, sensor=sensor, method="dpm++", seed=seed)
            sec = time.perf_counter() - t0
            k1, k3 = dict(K.dtype_launches), dict(K3.dtype_launches)
            variants = {v for m in (K, K3) for v, n in m.variant_launches.items() if n}
            if plain is None:  # the "auto" request is held against its "banded" twin's
                model.use_plain_conv(True)
                try:
                    t0 = time.perf_counter()
                    plain = sharp.sample(batch, sensor=sensor, method="dpm++", seed=seed)
                    plain_sec = time.perf_counter() - t0
                finally:
                    model.use_plain_conv(False)
        finally:
            model.use_conv_impl("banded")
        err, gap = float(np.abs(img - plain).max()), float(np.abs(img - img32).max())
        n = k1["bfloat16"] + k3["bfloat16"]
        print(f"[bf16] {impl} dpm++ request sensor={sensor} 8 bands batch {BATCH} {SIZE}x{SIZE}: "
              f"{sec:.3f} s (fp32 banded {sec32:.3f} s, ratio {sec32 / sec:.2f}x); K1 launches "
              f"by dtype {k1}, K3 {k3}, variants {sorted(variants)}; max abs err {err:.3g} "
              f"against the banded request through the plain bf16 convs ({plain_sec:.3f} s; atol "
              f"{BF16_SAMPLE_ATOL}); gap to the fp32 kernel request {gap:.3g} "
              f"(bar {BF16_VS_FP32})", flush=True)
        if not check_image(img, batch) or n != ENCODE_CONVS + NFE * DENOISE_CONVS:
            fail(f"bf16 {impl} request: image ok={check_image(img, batch)}, {n} bf16 launches")
        if k1["float32"] or k3["float32"] or not variants <= BF16_VARIANTS:
            fail(f"bf16 {impl} request launched {k1} / {k3}, variants {variants}")
        if impl == "auto" and k3["bfloat16"] == 0:
            fail("the bf16 auto request launched no K3 instance")
        if not (err <= BF16_SAMPLE_ATOL and gap <= BF16_VS_FP32):
            fail(f"bf16 {impl} request: err {err} vs plain, gap {gap} vs fp32")
        requests[impl] = {"s": sec, "fp32_s": sec32, "plain_s": plain_sec, "err": err,
                          "gap_to_fp32": gap, "K1": k1["bfloat16"], "K3": k3["bfloat16"]}
    return totals, requests


HTTP_REQUESTS = 16
HTTP_PRESETS = (("serve_quality.json", 8, ("WV2", "WV3")),
                ("serve_lowlatency.json", 4, ("QB", "GF2")))
HTTP_START_TIMEOUT = 300.0


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def http_post(base, **arrays):
    """(status, npz reply or error body, seconds) of one POST /v1/pansharpen."""
    import io
    import urllib.error
    import urllib.request

    buf = io.BytesIO()
    np.savez(buf, **arrays)
    req = urllib.request.Request(f"{base}/v1/pansharpen", data=buf.getvalue(), method="POST")
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=600) as r:
            body = r.read()
            return r.status, dict(np.load(io.BytesIO(body))), time.perf_counter() - t0
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode(errors="replace"), time.perf_counter() - t0


def http_get(base, path):
    import urllib.request

    with urllib.request.urlopen(f"{base}{path}", timeout=30) as r:
        return json.load(r)


def wait_healthy(base, proc, log_path, timeout):
    import urllib.error

    t0 = time.perf_counter()
    while time.perf_counter() - t0 < timeout:
        if proc.poll() is not None:
            fail(f"the server exited with {proc.returncode} before it was healthy:\n"
                 + open(log_path).read()[-4000:])
        try:
            if http_get(base, "/healthz") == {"ok": True}:
                return time.perf_counter() - t0
        except (urllib.error.URLError, ConnectionError, OSError):
            pass
        time.sleep(0.5)
    fail(f"the server was not healthy within {timeout} s")


def stop_server(proc):
    """SIGINT (the server prints its launch report and exits), then kill
    after 60 s."""
    if proc.poll() is not None:
        return
    proc.send_signal(signal.SIGINT)
    try:
        proc.wait(timeout=60)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()


def http_phase(seed, root):
    """`python -m tmdiff_tpu_torch.serve` with each serving preset (bf16,
    EMA weights) on a port checkpoint of the seeded full-width model (EMA =
    the weights), as subprocesses started together (their start-up and
    warm-up overlap; nothing is timed until every one is healthy): per
    preset, 16 concurrent requests through HTTP, all 200; latency, img/s
    and /v1/stats; then that server is stopped and its kernel launches (it
    prints them when stopped by SIGINT) checked: every conv launch a bf16
    one; each image against a direct Pansharpener.sample in this process on
    the bf16 model at the reply's seed and bucket, its batch rebuilt from
    the replies."""
    from tmdiff_tpu_torch.diffusion.schedules import NoiseSchedule
    from tmdiff_tpu_torch.models.wavbest import WavBEST
    from tmdiff_tpu_torch.pipeline import Pansharpener
    from tmdiff_tpu_torch.serve import __main__ as serve_main
    from tmdiff_tpu_torch.train.checkpoint import save_checkpoint
    from tmdiff_tpu_torch.train.trainer import Trainer

    repo = os.path.dirname(os.path.abspath(__file__))
    model = WavBEST(CHANNELS, device=DEV, seed=SEED)
    ckpt = save_checkpoint(os.path.join(root, "checkpoint"),
                           Trainer(model, NoiseSchedule.create("cosine", 1000)).init_state())
    del model
    direct = Pansharpener(WavBEST(CHANNELS, device=DEV, seed=SEED, dtype=torch.bfloat16),
                          device=DEV)
    torch.cuda.empty_cache()
    rng = np.random.default_rng(seed)
    servers = []
    t_start = time.perf_counter()
    try:
        for preset, bands, sensors in HTTP_PRESETS:
            cfg = os.path.join(repo, "tmdiff_tpu_torch", "config", "presets", preset)
            argv = ["-c", cfg, "--ckpt", ckpt, "--host", "127.0.0.1", "--port", str(free_port())]
            args, _, sampler_kw = serve_main.prepare(argv)
            if not (args.bf16 and args.use_ema):
                fail(f"{preset} does not serve bf16 EMA weights")
            log_path = os.path.join(root, preset + ".log")
            with open(log_path, "w") as log:
                proc = subprocess.Popen([sys.executable, "-m", "tmdiff_tpu_torch.serve", *argv],
                                        stdout=log, stderr=subprocess.STDOUT, cwd=repo)
            servers.append((preset, bands, sensors, args, sampler_kw, log_path, proc))
        ready = {}
        for preset, _, _, args, _, log_path, proc in servers:
            wait_healthy(f"http://127.0.0.1:{args.port}", proc, log_path, HTTP_START_TIMEOUT)
            ready[preset] = time.perf_counter() - t_start
        results = {}
        for preset, bands, sensors, args, sampler_kw, log_path, proc in servers:
            results[preset] = http_preset(preset, bands, sensors, args, sampler_kw, log_path,
                                          proc, direct, rng, ready[preset])
    finally:
        for *_, proc in servers:
            stop_server(proc)
    return results


def preset_requests(rng, bands, sensors):
    """HTTP_REQUESTS requests of a preset's geometry, sensors in turn."""
    reqs = []
    for i in range(HTTP_REQUESTS):
        ms = rng.uniform(0.05, 0.95, (bands, SIZE, SIZE)).astype(np.float32)
        pan = (ms.mean(0, keepdims=True)
               + 0.05 * rng.standard_normal((1, SIZE, SIZE))).astype(np.float32)
        reqs.append({"pan": pan, "ms": ms, "sensor": sensors[i % len(sensors)]})
    return reqs


def post_all(base, reqs):
    """(replies, wall seconds, /v1/stats) of `reqs` posted at once."""
    from concurrent.futures import ThreadPoolExecutor

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(reqs)) as pool:
        replies = list(pool.map(lambda r: http_post(base, **r), reqs))
    return replies, time.perf_counter() - t0, http_get(base, "/v1/stats")


def launch_reports(label, log):
    """Every {"kernel_launches": ...} line a server printed (one a rank)."""
    # ranks under torchrun share one stdout, so two reports may share a line
    key, decoder = '{"kernel_launches"', json.JSONDecoder()
    reports = [decoder.raw_decode(log, m.start())[0] for m in re.finditer(re.escape(key), log)]
    if not reports:
        fail(f"{label}: the server printed no launch report:\n{log[-4000:]}")
    return reports


def check_bf16_launches(label, launches):
    """Every conv launch of a served bf16 model a bf16 one, on a bf16
    tensor-core variant; no K3."""
    conv = launches["conv3d"]
    if conv["dtypes"]["float32"] or launches["conv3x3_nhwc"]["launches"] or not (
            conv["dtypes"]["bfloat16"] and set(k for k, n in conv["variants"].items() if n)
            <= BF16_VARIANTS):
        fail(f"{label}: the server's conv launches {launches}")


def replay_error(label, reqs, replies, direct, args, sampler_kw):
    """Each served image against a direct Pansharpener.sample in this
    process at its seed and bucket, every batch rebuilt from the replies
    that rode it: (largest abs difference, the batches (seed, bucket))."""
    bad = [(code, body) for code, body, _ in replies if code != 200]
    if bad:
        fail(f"{label}: {len(bad)} replies were not 200: {bad[:2]}")
    groups = {}
    for req, (_, reply, _) in zip(reqs, replies):
        key = (int(reply["seed"]), int(reply["bucket"]))
        groups.setdefault(key, {})[int(reply["row"])] = (req, reply["sr"])
    max_err = 0.0
    for (bseed, bucket), rows in sorted(groups.items()):
        order = [rows[i][0] for i in range(len(rows))]
        order += [order[-1]] * (bucket - len(order))
        ref = direct.sample({"PAN": np.stack([r["pan"] for r in order]),
                             "MS": np.stack([r["ms"] for r in order])},
                            sensor=[r["sensor"] for r in order], method=args.sampler,
                            steps=args.steps, seed=bseed, **(sampler_kw or {}))
        for i, (_, sr) in rows.items():
            if not check_image(sr, {"MS": ref[i]}):
                fail(f"{label}: reply image not finite in [0, 1] of shape {ref.shape[1:]}")
            max_err = max(max_err, float(np.abs(sr - ref[i]).max()))
    return max_err, sorted(groups)


def latency_summary(replies, wall):
    lat = np.array([t for _, _, t in replies]) * 1e3
    return {"img_per_s": len(replies) / wall, "wall_s": wall,
            "p50_ms": float(np.percentile(lat, 50)), "p99_ms": float(np.percentile(lat, 99)),
            "latency_ms": np.round(np.sort(lat), 1).tolist()}


def http_preset(preset, bands, sensors, args, sampler_kw, log_path, proc, direct, rng, ready_s,
                atol=SAMPLE_ATOL, label="[http]"):
    """One healthy server's requests, its launch reports (one a rank) and
    the replays."""
    base = f"http://127.0.0.1:{args.port}"
    reqs = preset_requests(rng, bands, sensors)
    try:
        replies, wall, stats = post_all(base, reqs)
    finally:
        stop_server(proc)
    reports = launch_reports(preset, open(log_path).read())
    for report in reports:
        check_bf16_launches(preset, report["kernel_launches"])
    max_err, batches = replay_error(preset, reqs, replies, direct, args, sampler_kw)
    if max_err > atol:
        fail(f"{preset}: served images differ from the direct requests by {max_err}")
    result = {"sampler": args.sampler, "steps": args.steps, "bands": bands,
              **latency_summary(replies, wall), "ready_s": ready_s, "stats": stats,
              "server_launches": reports[0]["kernel_launches"], "ranks": len(reports),
              "batches": batches, "max_abs_err": max_err}
    print(f"{label} {preset}: sampler {args.sampler} steps {args.steps} {sampler_kw or {}} "
          f"bf16, {bands} bands {SIZE}x{SIZE}, {len(reports)} rank(s); healthy {ready_s:.1f} s "
          f"after start (warm-up {args.warmup}); {HTTP_REQUESTS} concurrent requests in "
          f"{wall:.3f} s = {result['img_per_s']:.2f} img/s; latency ms p50 "
          f"{result['p50_ms']:.1f} p99 {result['p99_ms']:.1f} (all: {result['latency_ms']}); "
          f"batches (seed, bucket) {batches}; /v1/stats {json.dumps(stats)}; server launches "
          f"(rank 0) {json.dumps(reports[0]['kernel_launches'])}; images vs direct requests "
          f"max abs err {max_err:.3g} (atol {atol})", flush=True)
    return {k: v for k, v in result.items() if k != "latency_ms"}


def attention_bound(b, h, sq, skv, d, peak, elem_bytes=4):
    flops = 4.0 * b * h * sq * skv * d  # q.kT and p.v
    nbytes = elem_bytes * b * h * d * (2 * sq + 2 * skv)
    return bound(flops, nbytes, peak)


def attention_inputs(gen, b, h, sq, d, skv, dtype=torch.float32):
    return tuple(torch.randn(b, h, s, d, device=DEV, generator=gen).to(dtype)
                 for s in (sq, skv, skv))


# K4's bf16 kernel does S = Q.K^T in one bf16 product a multiply-add and
# P.V in two, on p's two bf16 parts (csrc/flash_attention.cu): the rate of
# its arithmetic
PEAK_BF16_ATTENTION_ROUTE = PEAK_BF16_FLOPS / 1.5


def attention_shapes(K4, gen, dtype):
    """K4 at every ATTENTION_SHAPES entry in `dtype` against its plain
    version (fp32: attention_reference to ATTENTION_ATOL; bf16:
    flash_attention_plain within one bf16 step), the variant (the tensor
    cores), a bit-identical second launch, and times beside the bound and
    SDPA in the same dtype; in bf16 also the CUDA kernels of one call (one
    kernel unsplit, no K/V pass); then the D = 42 shape on the FMA variant.
    Returns the per-shape numbers and the largest error."""
    from tmdiff_tpu_torch.bench_attention import kernel_launches, kernel_ms

    bf16 = dtype == torch.bfloat16
    tag, plain = ("bf16 ", K4.flash_attention_plain) if bf16 else ("", K4.attention_reference)
    per_shape, max_err = [], 0.0
    for label, (b, h, sq, d), skv in ATTENTION_SHAPES:
        q, k, v = attention_inputs(gen, b, h, sq, d, skv, dtype)
        with torch.no_grad():
            got, variant = launched_variant(K4, lambda: K4.flash_attention(q, k, v))
            ref = plain(q, k, v)
            again = K4.flash_attention(q, k, v)
            torch.cuda.synchronize()
            if bf16:
                err = bf16_check(got, ref, f"attention {tag}{label}")
            else:
                err = (got - ref).abs().max().item()
                if not err <= ATTENTION_ATOL:
                    fail(f"attention {label}: max abs err {err} > {ATTENTION_ATOL}")
            if variant != ("bf16" if bf16 else "tc"):
                fail(f"attention {tag}{label} took the {variant} variant, not the tensor cores")
            if not torch.equal(got, again):
                fail(f"attention {tag}{label}: two launches on one input differ")
            max_err = max(max_err, err)
            ms_k = cuda_ms(lambda: K4.flash_attention(q, k, v), 10)
            ms_p = cuda_ms(lambda: plain(q, k, v), 3)
            ms_l = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v), 10)
            per_kernel = kernel_ms(lambda: K4.flash_attention(q, k, v), 10)
            dev_l = sum(kernel_ms(lambda: F.scaled_dot_product_attention(q, k, v), 10).values())
            launched = kernel_launches(lambda: K4.flash_attention(q, k, v))
        dev_k = sum(per_kernel.values())
        plan = K4.device_plan(q, skv)
        parts = ", ".join(f"{name} {t:.4f}" for name, t in per_kernel.items())
        if bf16:
            bnd, bound_by = attention_bound(b, h, sq, skv, d, PEAK_BF16_FLOPS, 2)
            route_bnd, _ = attention_bound(b, h, sq, skv, d, PEAK_BF16_ATTENTION_ROUTE, 2)
            other = f"route_bound_ms={route_bnd:.4f} kernels_per_call={launched}"
            bar = "one bf16 step"
            if any("kv_split" in name for name in launched):
                fail(f"attention {tag}{label} ran a K/V pass: {launched}")
            if plan.splits == 1 and sum(launched.values()) != 1:
                fail(f"attention {tag}{label} is unsplit but launched {launched}")
        else:
            bnd, bound_by = attention_bound(b, h, sq, skv, d, PEAK_TF32X3_FLOPS)
            ffma_bnd, _ = attention_bound(b, h, sq, skv, d, PEAK_FP32_FLOPS)
            other = f"fp32_ffma_bound_ms={ffma_bnd:.4f}"
            bar = f"atol {ATTENTION_ATOL}"
        per_shape.append({"ms": ms_k, "plain_ms": ms_p, "library_ms": ms_l, "bound_ms": bnd,
                          "bound_by": bound_by})
        print(f"[attention] {tag}{label}: q {(b, h, sq, d)} Skv {skv} variant={variant} "
              f"splits={plan.splits} key_tile={plan.key_tile} rows/block={plan.rows} "
              f"ms={ms_k:.4f} plain_ms={ms_p:.4f} library_ms={ms_l:.4f} "
              f"device_ms={dev_k:.4f} ({parts}) library_device_ms={dev_l:.4f} "
              f"bound_ms={bnd:.4f} ({bound_by}) {other} "
              f"share_of_bound={bnd / ms_k:.3f} max abs err {err:.3g} ({bar}), "
              f"second launch bit-identical", flush=True)

    (b, h, sq, d), skv = FMA_ATTENTION_SHAPE
    q, k, v = attention_inputs(gen, b, h, sq, d, skv, dtype)
    with torch.no_grad():
        got, variant = launched_variant(K4, lambda: K4.flash_attention(q, k, v))
        ref = plain(q, k, v)
        torch.cuda.synchronize()
    if bf16:
        err = bf16_check(got, ref, f"attention bf16 at D = {d}")
        ok = variant == "bf16_fma"
    else:
        err = (got - ref).abs().max().item()
        ok = variant == "fma" and err <= ATTENTION_ATOL
    print(f"[attention] {tag}FMA variant: q {(b, h, sq, d)} Skv {skv} variant={variant} "
          f"max abs err {err:.3g}", flush=True)
    if not ok:
        fail(f"attention {tag}at D = {d}: variant {variant}, max abs err {err}")
    return per_shape, max(max_err, err)


def spatial_transformer_check(K4, gen, dtype):
    """The module's entry point: a SpatialTransformer (in `dtype`) over a
    64x64x256 image attending to the 768-wide prompt embedding as a
    one-token context, through K4 with the counts reset just before and
    read just after, and through the plain attention. Its proj_out starts
    at zero (the identity), so it is drawn at random here. fp32 within
    FORWARD_ATOL; bf16 within BF16_MODULE_RTOL of the output's scale, and no
    K/V pass among the bf16 forward's CUDA kernels.
    Returns (launches, launches by variant, the error)."""
    from tmdiff_tpu_torch.ops.attention import SpatialTransformer

    bf16 = dtype == torch.bfloat16
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(SEED)
        st = SpatialTransformer(256, heads=8, dim_head=64, context_dim=PROMPT_DIM, dtype=dtype)
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
        launches, variants = K4.launches, dict(K4.variant_launches)
        if bf16:
            from tmdiff_tpu_torch.bench_attention import kernel_launches

            launched = kernel_launches(lambda: st(x, ctx))
            if any("kv_split" in name for name in launched):
                fail(f"the bf16 SpatialTransformer ran a K/V pass: {launched}")
        for m in st.modules():
            if hasattr(m, "use_flash"):
                m.use_flash = False
        t0 = time.perf_counter()
        ref = st(x, ctx)
        torch.cuda.synchronize()
        sec_plain = time.perf_counter() - t0
    err = (y - ref).abs().max().item()
    scale = ref.abs().max().item()
    bar = BF16_MODULE_RTOL * scale if bf16 else FORWARD_ATOL
    tag = "bf16 " if bf16 else ""
    print(f"[attention] {tag}SpatialTransformer(8 x 64 heads) on {tuple(x.shape)} with a "
          f"{tuple(ctx.shape)} context: {sec * 1e3:.2f} ms through K4 ({launches} launches, "
          f"by variant {variants}), {sec_plain * 1e3:.2f} ms through the plain attention; "
          f"max abs err {err:.3g} (bar {bar:.3g}), output max |y| {scale:.3g}", flush=True)
    if tuple(y.shape) != tuple(x.shape) or not torch.isfinite(y).all():
        fail(f"{tag}SpatialTransformer output has the wrong shape or is not finite")
    if launches != 2 or variants["bf16" if bf16 else "tc"] != 2:
        fail(f"{tag}SpatialTransformer launched the attention kernel {launches} times ({variants})")
    if not err <= bar:
        fail(f"{tag}SpatialTransformer differs from the plain attention by {err}")
    return launches, variants, err


# The bf16 SpatialTransformer through K4 against the same module on the
# plain attention: each attention output within one bf16 step of the
# plain's, carried through bf16 projections, LayerNorms and the
# feed-forward (tests/test_torch_bf16.py's model bar).
BF16_MODULE_RTOL = 2e-2


def attention_phase(K4, gen):
    """fp32, then bf16: every shape, the FMA shape and the SpatialTransformer.
    Returns per dtype the totals over the SpatialTransformer's two
    attentions (the first two shapes), the largest error and the module's
    launches."""
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        per_shape, max_err = attention_shapes(K4, gen, dtype)
        launches, variants, _ = spatial_transformer_check(K4, gen, dtype)
        totals = {key: sum(p[key] for p in per_shape[:2])
                  for key in ("ms", "plain_ms", "library_ms", "bound_ms")}
        totals["bound_by"] = per_shape[0]["bound_by"]
        out[str(dtype).split(".")[-1]] = (totals, max_err, launches, variants)
    return out


# The library modules that reach no TPU kernel (ops/dynamic_conv.py,
# kernel_adaption.py, pgcu.py, the orphan blocks of models/blocks.py, the
# losses and the loss zoo, the generic wavelets): the card against the CPU
# on the same weights and inputs, each output within 1e-4 of its scale (fp32
# sums in another order, TF32 off on both).
LIBRARY_RTOL = CONV_RTOL
LIBRARY_REPS = 5
LIB_IMAGE, LIB_FEATURE = SIZE, 64  # image side; feature map side and channels


def _tensors(out):
    """The tensors of a module's or loss's output, in order."""
    if isinstance(out, torch.Tensor):
        return [out]
    if isinstance(out, dict):
        return [t for k in sorted(out) for t in _tensors(out[k])]
    return [t for o in out for t in _tensors(o)]


def library_cases():
    """(label, callable on the CPU, the same callable's card copy, CPU
    inputs, keyword inputs, border) at the reference's sizes: batch 2, 8
    bands. `border` is None but for a wavelet round trip, whose last output
    must give back its input away from a border of that width."""
    from tmdiff_tpu_torch.models.blocks import AdaptiveGroupNorm, ChannelWiseAttention
    from tmdiff_tpu_torch.ops import dynamic_conv, kernel_adaption, pgcu, wavelet
    from tmdiff_tpu_torch.train import loss_zoo, losses

    rng = np.random.default_rng(SEED)

    def normal(*shape):
        return torch.as_tensor(rng.standard_normal(shape).astype(np.float32))

    def uniform(*shape):
        return torch.as_tensor(rng.uniform(0.05, 0.95, shape).astype(np.float32))

    f, img, img4 = LIB_FEATURE, LIB_IMAGE, LIB_IMAGE // 4
    feat = f"8-band {f}x{f}x{f}"
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(SEED)
        dyn = dynamic_conv.DynamicConv3d(f, f, (3, 3, 3), num_kernels=4)
        torch.nn.init.normal_(dyn.bias, std=0.1)
        modules = {
            f"DynamicConv3d K=4, {feat} -> {f}": (dyn, [normal(BATCH, 8, f, f, f)],
                                                 {"temperature": 4.0}),
            f"PGCU, pan {img}x{img}, ms {img4}x{img4}, 8 bands": (
                pgcu.PGCU(8, 128, 3), [uniform(BATCH, img, img, 1), uniform(BATCH, img4, img4, 8)],
                {}),
            f"GaussianDegradation k5 x4, 8-band {img}x{img}": (
                kernel_adaption.GaussianDegradation(5, 4), [uniform(BATCH, img, img, 8)], {}),
            f"FreePSFDegradation x4, 8-band {img}x{img}": (
                kernel_adaption.FreePSFDegradation(4), [uniform(BATCH, img, img, 8)], {}),
            f"ChannelWiseAttention, {feat}": (ChannelWiseAttention(f, 16),
                                              [normal(BATCH, 8, f, f, f)], {}),
            f"AdaptiveGroupNorm, {feat}, style 256": (
                AdaptiveGroupNorm(f, 256, 8), [normal(BATCH, 8, f, f, f), normal(BATCH, 256)], {}),
        }
    for label, (m, args, kw) in modules.items():
        yield label, m.eval(), copy.deepcopy(m).to(DEV).eval(), args, kw, None

    pred, target = uniform(BATCH, img, img, 8), uniform(BATCH, img, img, 8)
    pan, lr_ms = uniform(BATCH, img, img, 1), uniform(BATCH, img4, img4, 8)
    ms = uniform(BATCH, img, img, 8)  # the upsampled MS of the zoo's spectral terms
    composite = losses.CompositeLoss([
        ("l1", 1.0, losses.l1), ("l2", 0.5, losses.l2),
        ("spectral", 0.3, lambda pred, lr_ms, **_: losses.spectral_consistency(pred, lr_ms)),
        ("gradient", 0.2, lambda pred, pan, **_: losses.gradient_matching(pred, pan)),
        ("highpass", 0.2, lambda pred, pan, **_: losses.highpass_matching(pred, pan)),
        ("ssim", 0.1, lambda pred, target, **_: losses.ssim_loss(pred, target))])
    yield (f"CompositeLoss (l1, l2, spectral, Sobel, high pass, SSIM), 8-band {img}x{img}",
           composite, composite, [], {"pred": pred, "target": target, "pan": pan, "lr_ms": lr_ms},
           None)
    for name, args in (("loss_func1", [target, pan, ms, pred]),
                       ("loss_func2", [target, pan, ms, pred]), ("loss_func8", [pan, ms, pred]),
                       ("loss_func22", [target, pred]), ("sam_loss", [target, pred])):
        fn = getattr(loss_zoo, name)
        yield f"loss zoo {name}, 8-band {img}x{img}", fn, fn, args, {}, None

    # the JAX conv API's library routes (ops/modconv.py): a strided
    # modulated conv, a transposed modulated conv and a 5x5x5 conv
    from tmdiff_tpu_torch.ops import modconv

    k3 = normal(3, 3, 3, f, f) / np.sqrt(27 * f)
    k5 = normal(5, 5, 5, f, f) / np.sqrt(125 * f)
    style = uniform(BATCH, f) + 0.5
    x = normal(BATCH, 8, f, f, f)
    yield (f"modulated_conv3d 3x3x3 stride (1, 2, 2) SAME, {feat}",
           lambda x, k, s: modconv.modulated_conv3d(x, k, s, stride=(1, 2, 2)),
           lambda x, k, s: modconv.modulated_conv3d(x, k, s, stride=(1, 2, 2)),
           [x, k3, style], {}, None)
    yield (f"modulated_conv_transpose3d 3x3x3 stride (1, 2, 2) SAME, {feat}",
           lambda x, k, s: modconv.modulated_conv_transpose3d(x, k, s, stride=(1, 2, 2)),
           lambda x, k, s: modconv.modulated_conv_transpose3d(x, k, s, stride=(1, 2, 2)),
           [x, k3, style], {}, None)
    yield (f"conv3d 5x5x5 SAME, {feat}", lambda x, k: modconv.conv3d(x, k),
           lambda x, k: modconv.conv3d(x, k), [x, k5], {}, None)

    def db2_round_trip(x):
        bands = wavelet.dwt2d(x, "db2")
        return (*bands, wavelet.idwt2d(*bands, "db2"))

    def haar3d_round_trip(x):
        bands = wavelet.dwt3d(x)
        return bands, wavelet.idwt3d(bands)

    # the reference's truncated db2 matrices lose a (4 / 2)-wide border
    yield f"db2 dwt2d + idwt2d, 8-band {img}x{img}", db2_round_trip, db2_round_trip, [pred], {}, 2
    yield (f"haar dwt3d + idwt3d, {feat}", haar3d_round_trip, haar3d_round_trip,
           [normal(BATCH, 8, f, f, f)], {}, 0)


def library_phase():
    """Each library case once on the card and once on the CPU: every output
    within LIBRARY_RTOL of its scale, finite, of the CPU's shape; the
    wavelet round trips reconstruct their input away from the db2 border;
    ms a call on the card by CUDA events."""
    results = {}
    for label, cpu_fn, dev_fn, args, kw, border in library_cases():
        dev_args = [a.to(DEV) for a in args]
        dev_kw = {k: v.to(DEV) if torch.is_tensor(v) else v for k, v in kw.items()}
        with torch.no_grad():
            ref = _tensors(cpu_fn(*args, **kw))
            got = _tensors(dev_fn(*dev_args, **dev_kw))
            torch.cuda.synchronize()
            ms = cuda_ms(lambda: dev_fn(*dev_args, **dev_kw), LIBRARY_REPS)
        err = 0.0
        for g, r in zip(got, ref, strict=True):
            if g.shape != r.shape or not torch.isfinite(g).all():
                fail(f"library {label}: output {tuple(g.shape)} (CPU {tuple(r.shape)}) or not finite")
            scale = max(r.abs().max().item(), 1e-30)
            err = max(err, (g.cpu() - r).abs().max().item() / scale)
        if border is not None:
            x, rec, m = args[0], ref[-1], border
            inner = (slice(None), slice(m, -m or None), slice(m, -m or None))
            if not torch.allclose(rec[inner], x[inner], atol=1e-4):
                fail(f"library {label}: the round trip does not reconstruct its input")
        print(f"[library] {label}: {len(got)} outputs, max err of scale {err:.3g} "
              f"(rtol {LIBRARY_RTOL}), {ms:.4f} ms on the card", flush=True)
        if not err <= LIBRARY_RTOL:
            fail(f"library {label}: card and CPU differ by {err:.3g} of scale")
        results[label] = {"ms": ms, "max_err_of_scale": err}
    return results


# The training step at the general_multi preset (tmdiff_tpu/config/presets):
# batch 8 of 64x64 patches per sensor, lr 1e-4 with 100 warmup steps of
# max_iter 300000, AdamW wd 1e-4, EMA 0.9999, remat, L1, cosine schedule of
# 1000 steps, init_type "torch".
TRAIN_SIZE, TRAIN_BATCH, TRAIN_SCENES = 64, 8, 24
TRAIN_STEPS, REPEAT_STEPS, LEARN_STEPS, TIMED_STEPS, PROFILED_STEPS = 10, 3, 30, 6, 3
TRAIN_SENSORS = {"QB": (4, 1), "GF2": (4, 2), "WV3": (8, 3)}  # bands, data seed
GRAD_LOSS_RTOL, GRAD_RTOL = 1e-4, 1e-3
# the x0 prediction through K1 against the plain convs at the gradient
# check's batches: 8.4e-7 (8 bands) and 9.8e-7 (4) measured on an NVIDIA
# H100 80GB HBM3 at 700 W
TRAIN_FORWARD_ATOL = 1e-5
# twice the preset's lr from the third step on (its warmup would give 3e-5 by
# step 30); at 2e-3 the loss of a tiny model first jumps up before it falls
LEARN_LR = 2e-4
TRAIN_CONVS = ENCODE_CONVS + DENOISE_CONVS  # one model call
# record_function ranges of the trainer and the conv backward
PROFILE_LABELS = ("train.loss", "train.optimizer", "conv3d.weight_grad")


def rel_to_scale(got, ref) -> float:
    return (got - ref).abs().max().item() / max(ref.abs().max().item(), 1e-30)


def train_setup():
    from tmdiff_tpu_torch.data.h5 import PanDataset
    from tmdiff_tpu_torch.data.synthetic import make_arrays
    from tmdiff_tpu_torch.diffusion.schedules import NoiseSchedule
    from tmdiff_tpu_torch.models.clip_text import load_prompt_table
    from tmdiff_tpu_torch.models.init_styles import apply_init_style
    from tmdiff_tpu_torch.models.wavbest import WavBEST
    from tmdiff_tpu_torch.train.trainer import Trainer

    def new_model(dtype=torch.float32):
        model = WavBEST(CHANNELS, device=DEV, seed=SEED, dtype=dtype)
        return apply_init_style(model, "torch", torch.Generator().manual_seed(SEED))

    def new_trainer(model, **overrides):
        kw = dict(lr=1e-4, weight_decay=1e-4, warmup_steps=100, max_iter=300_000,
                  loss_type="l1", ema_decay=0.9999, remat=True, seed=SEED)
        kw.update(overrides)
        return Trainer(model, NoiseSchedule.create("cosine", 1000), **kw)

    table, index, _ = load_prompt_table()
    prompts = {s: torch.as_tensor(table[index[s]], device=DEV) for s in TRAIN_SENSORS}
    datasets = {s: PanDataset(make_arrays(TRAIN_SCENES, bands, TRAIN_SIZE, seed=seed))
                for s, (bands, seed) in TRAIN_SENSORS.items()}
    return new_model, new_trainer, prompts, datasets


def mixer_for(datasets, seed):
    from tmdiff_tpu_torch.data.pipeline import BatchIterator, SensorMixer

    return SensorMixer({s: BatchIterator(ds, TRAIN_BATCH, seed=seed + i)
                        for i, (s, ds) in enumerate(datasets.items())}, seed=seed)


def device_batch(ds, gen):
    batch = ds.batch(np.arange(TRAIN_BATCH))
    batch = {k: torch.as_tensor(batch[k], device=DEV) for k in ("Res", "PAN", "MS")}
    t = torch.randint(1, 1001, (TRAIN_BATCH,), generator=gen, device=DEV)
    noise = torch.randn(batch["Res"].shape, generator=gen, device=DEV)
    return batch, t, noise


def fixed_loss(model, schedule, batch, prompt, t, noise):
    from tmdiff_tpu_torch.diffusion import gaussian

    return gaussian.diffusion_loss(lambda x, tt, pan, ms: model(x, tt, pan, ms, prompt), schedule,
                                   None, batch["Res"], batch["PAN"], batch["MS"], "l1",
                                   t=t, noise=noise)


def counts(K, K3, K4) -> dict:
    return {"k1_forward": K.launches - K.input_grad_launches,
            "k1_input_grad": K.input_grad_launches, "weight_grad": K.weight_grad_calls,
            "weight_grad_kernel": K.weight_grad_launches,
            "k1_off_tensor_cores": K.variant_launches["ffma"], "k3": K3.launches,
            "k4": K4.launches}


def reset_counts(*modules):
    torch.cuda.synchronize()
    for mod in modules:
        mod.reset_launches()


def predict(model, schedule, batch, prompt, t, noise):
    """The x0 prediction of the residual noised at fixed t and noise,
    dropout off."""
    from tmdiff_tpu_torch.diffusion import gaussian

    gamma = schedule.sqrt_alphas_cumprod_prev[t][:, None, None, None]
    return model(gaussian.q_sample(batch["Res"], gamma, noise), t, batch["PAN"], batch["MS"],
                 prompt)


def train_grads_phase(K, new_model, new_trainer, prompts, datasets, gen):
    """The L1 loss and every gradient through K1 against the plain convs,
    fixed t and noise, dropout off; then remat on and off with dropout on.
    The L1 gradient is sign(pred - target): where a prediction lies within
    the forward's rounding of its target the two paths may take other signs
    (one element in 262144 at |pred - target| = 3.4e-8 moved a cancelling
    bias gradient by 1.6e-3 of its scale), so both backward passes take the
    plain path's signs (GRAD_RTOL holds there). That holds only where the
    forward passes agree to TRAIN_FORWARD_ATOL and every element whose sign
    differs lies within their difference of its target, both checked; the
    gradients with each path's own signs are printed."""
    model = new_model()
    trainer = new_trainer(model)
    params = dict(model.named_parameters())
    worst_all = 0.0
    for sensor in ("WV3", "QB"):
        batch, t, noise = device_batch(datasets[sensor], gen)
        res = batch["Res"]
        out = {}
        for plain in (True, False):
            model.use_plain_conv(plain)
            K.reset_launches()
            pred = predict(model, trainer.schedule, batch, prompts[sensor], t, noise)
            if plain:
                pred_plain = pred.detach()
                sign = torch.sign(pred_plain - res)
            held = torch.mean((pred - res) * sign)  # the L1 loss, with the plain path's signs
            grads = torch.autograd.grad(held, list(params.values()), retain_graph=True)
            launches = (K.launches, K.input_grad_launches, K.weight_grad_calls)
            own = torch.autograd.grad(torch.mean(torch.abs(res - pred)), list(params.values()))
            out[plain] = (torch.mean(torch.abs(res - pred.detach())), grads, own, launches,
                          pred.detach())
        model.use_plain_conv(False)
        (lk, gk, ok, (n_k, n_in, n_w), pred_k), (lp, gp, op, (n_p, _, _), _) = out[False], out[True]
        loss_rel = abs(lk.item() - lp.item()) / abs(lp.item())
        errs = {name: rel_to_scale(a, b) for name, a, b in zip(params, gk, gp)}
        own_errs = {name: rel_to_scale(a, b) for name, a, b in zip(params, ok, op)}
        scales = {name: b.abs().max().item() for name, b in zip(params, gp)}
        worst, own_worst = max(errs, key=errs.get), max(own_errs, key=own_errs.get)
        worst_all = max(worst_all, errs[worst])
        over = {n: e for n, e in errs.items() if e > GRAD_RTOL}
        flips = torch.sign(pred_k - res) != sign
        forward_err = (pred_k - pred_plain).abs().max().item()
        flip_margin = (pred_plain - res).abs()[flips].max().item() if flips.any() else 0.0
        bands = batch["MS"].shape[1]
        print(f"[train] gradients {sensor} {bands}-band batch {TRAIN_BATCH} {TRAIN_SIZE}x"
              f"{TRAIN_SIZE}, fixed t and noise, dropout off: L1 loss K1 {lk.item():.7f} plain "
              f"{lp.item():.7f} (rel {loss_rel:.3g}, rtol {GRAD_LOSS_RTOL}); with the plain "
              f"path's signs, worst gradient {worst} at {errs[worst]:.3g} of its scale, "
              f"{len(errs) - len(over)} of {len(errs)} within {GRAD_RTOL}, median scale "
              f"{float(np.median(list(scales.values()))):.3g}; K1 launches {n_k} "
              f"({n_k - n_in} forward, {n_in} input gradient), {n_w} weight gradients; "
              f"plain path {n_p} launches", flush=True)
        print(f"[train]   with each path's own signs: worst gradient {own_worst} at "
              f"{own_errs[own_worst]:.3g} of its scale; {int(flips.sum())} of {flips.numel()} "
              f"elements take another sign through K1, at |pred - target| <= "
              f"{flip_margin:.3g} (bar: the forward difference); forward K1 vs plain "
              f"{forward_err:.3g} (atol {TRAIN_FORWARD_ATOL})", flush=True)
        if not loss_rel <= GRAD_LOSS_RTOL or over:
            fail(f"{sensor} training gradients differ from the plain path: {sorted(over)}")
        if not (forward_err <= TRAIN_FORWARD_ATOL and flip_margin <= forward_err):
            fail(f"{sensor} x0 prediction: K1 vs plain {forward_err}, an element of another "
                 f"sign at {flip_margin} from its target")
        if (n_k - n_in, n_in, n_w, n_p) != (TRAIN_CONVS, TRAIN_CONVS, TRAIN_CONVS, 0):
            fail(f"{sensor} gradient pass: launches {n_k - n_in}/{n_in}/{n_w}/{n_p}")

    batch, _, _ = device_batch(datasets["WV3"], gen)
    got = {}
    for remat in (True, False):
        trainer.remat = remat
        loss = trainer.loss(1, batch, prompts["WV3"])
        got[remat] = (loss.detach(), torch.autograd.grad(loss, list(params.values())))
    trainer.remat = True
    same = torch.equal(got[True][0], got[False][0]) and all(
        torch.equal(a, b) for a, b in zip(got[True][1], got[False][1]))
    diff = max(rel_to_scale(a, b) for a, b in zip(got[True][1], got[False][1]))
    print(f"[train] remat on vs off, dropout on, step seed 1: loss {got[True][0].item():.7f} / "
          f"{got[False][0].item():.7f}, bit-identical {same}, largest gradient difference "
          f"{diff:.3g} of scale", flush=True)
    if not same:
        fail("remat on and off differ")
    return worst_all


def run_steps(trainer, state, feeder, prompts, n):
    losses = []
    for _ in range(n):
        batch, sensor = next(feeder)
        state, metrics = trainer.train_step(state, batch, prompts[sensor])
        losses.append(metrics["l_pix"])
    return [x.item() for x in losses]


def train_main_phase(K, K3, K4, new_model, new_trainer, prompts, datasets):
    """The main path: TRAIN_STEPS of the preset through the mixer and feeder,
    counts reset just before and read just after; then REPEAT_STEPS twice
    from one seed."""
    from tmdiff_tpu_torch.runtime.prefetch import DeviceFeeder

    model = new_model()
    trainer = new_trainer(model)
    state = trainer.init_state()
    start = [p.detach().clone() for p in model.parameters()]
    feeder = DeviceFeeder(mixer_for(datasets, SEED), device=DEV, depth=2)
    try:
        reset_counts(K, K3, K4)
        t0 = time.perf_counter()
        losses = run_steps(trainer, state, feeder, prompts, TRAIN_STEPS)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        n = counts(K, K3, K4)
    finally:
        feeder.close()
    moved = max((p.detach() - s).abs().max().item() for p, s in zip(model.parameters(), start))
    ema_moved = max((e - s).abs().max().item() for e, s in zip(state.ema_params, start))
    per_step = {k: v / TRAIN_STEPS for k, v in n.items()}
    print(f"[train] {TRAIN_STEPS} steps of the preset through SensorMixer 4:4:8 and DeviceFeeder "
          f"(depth 2): {sec:.3f} s; losses {[round(x, 6) for x in losses]}; largest parameter "
          f"change {moved:.3g}, EMA change {ema_moved:.3g}; per step {per_step}", flush=True)
    if not all(np.isfinite(losses)) or not moved > 0 or not ema_moved > 0:
        fail("training losses not finite, or parameters or EMA did not move")
    expected = {"k1_forward": 2 * TRAIN_CONVS, "k1_input_grad": TRAIN_CONVS,
                "weight_grad": TRAIN_CONVS, "weight_grad_kernel": TRAIN_CONVS,
                "k1_off_tensor_cores": 0, "k3": 0, "k4": 0}
    if per_step != expected:
        fail(f"launches per training step {per_step}, expected {expected}")

    runs = []
    for _ in range(2):
        trainer = new_trainer(new_model())
        state = trainer.init_state()
        feeder = DeviceFeeder(mixer_for(datasets, SEED + 1), device=DEV, depth=2)
        try:
            runs.append(run_steps(trainer, state, feeder, prompts, REPEAT_STEPS))
        finally:
            feeder.close()
    print(f"[train] {REPEAT_STEPS} steps twice from one seed: {runs[0]} / {runs[1]}, equal "
          f"{runs[0] == runs[1]}", flush=True)
    if runs[0] != runs[1]:
        fail("two runs from one seed gave different losses")
    return n, losses


def train_learn_phase(new_model, new_trainer, prompts, datasets, gen):
    """LEARN_STEPS at LEARN_LR (warmup 2) on one batch with fixed t and noise:
    the loss (dropout off) must fall below its start."""
    model = new_model()
    trainer = new_trainer(model, lr=LEARN_LR, warmup_steps=2, max_iter=1000)
    state = trainer.init_state()
    batch, t, noise = device_batch(datasets["WV3"], gen)
    with torch.no_grad():
        before = fixed_loss(model, trainer.schedule, batch, prompts["WV3"], t, noise).item()
    losses = [trainer.train_step(state, batch, prompts["WV3"], t=t, noise=noise)[1]["l_pix"]
              for _ in range(LEARN_STEPS)]
    with torch.no_grad():
        after = fixed_loss(model, trainer.schedule, batch, prompts["WV3"], t, noise).item()
    print(f"[train] {LEARN_STEPS} steps at lr {LEARN_LR} on one 8-band batch, fixed t and noise: loss "
          f"(dropout off) {before:.6f} -> {after:.6f}; step losses "
          f"{[round(x.item(), 6) for x in losses[::5]]} (every fifth)", flush=True)
    if not after < before:
        fail("the loss did not fall on a fixed batch")


def _step_part(event) -> str:
    """The part of a training step that a CPU op's kernels belong to, by
    the op and its parents: autograd records the conv Function's forward as
    an op ("Conv3dFunction", in the first pass and in remat's recompute) and
    its backward as a backward node; the trainer and the weight gradient
    mark their ranges with record_function."""
    node = event
    while node is not None:
        name = node.name
        if name == "conv3d.weight_grad":
            return "weight_grad"
        if name == "Conv3dFunction":
            return "k1_forward"
        if "Conv3dFunctionBackward" in name:
            return "conv_backward"
        if name == "train.optimizer":
            return "optimizer_and_ema"
        if name == "train.loss":
            return "forward"
        node = node.cpu_parent
    return "rest_of_backward"


def profile_breakdown(prof, wall: float, steps: int, k1_input_grad_ms: float) -> dict:
    """Device ms per step by part: each kernel goes to the part of the CPU op
    it was launched from (_step_part), K1's kernels (conv_3x3_*) inside the
    conv backward to the input gradient. Where the profiler links K1's
    ctypes launches to no op, its input gradients take `k1_input_grad_ms`,
    their time by CUDA events at each shape of a step, and the weight
    gradient the device time of the kernels named wgrad_* (its kernel's and
    cuDNN's)."""
    from torch.autograd import DeviceType

    parts = dict.fromkeys(("k1_forward", "k1_input_grad", "weight_grad",
                           "forward_elementwise_and_matmuls", "rest_of_backward",
                           "optimizer_and_ema"), 0.0)
    by_name: dict[str, float] = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            if e.name not in PROFILE_LABELS:
                by_name[e.name] = by_name.get(e.name, 0.0) + e.device_time_total
            continue
        part = _step_part(e)
        for k in e.kernels:
            k1 = "conv_3x3" in k.name
            if part == "conv_backward":
                key = "k1_input_grad" if k1 else "rest_of_backward"
            elif part == "forward":
                key = "k1_forward" if k1 else "forward_elementwise_and_matmuls"
            else:
                key = part
            parts[key] += k.duration
    ms = lambda us: us / 1e3 / steps
    parts = {k: ms(v) for k, v in parts.items()}
    total = ms(sum(by_name.values()))
    k1_total = ms(sum(us for name, us in by_name.items() if "conv_3x3" in name))
    wgrad_total = ms(sum(us for name, us in by_name.items() if "wgrad" in name))
    linked = parts["k1_input_grad"] > 0
    if not linked:
        parts["k1_input_grad"] = k1_input_grad_ms
        parts["k1_forward"] = k1_total - k1_input_grad_ms
    if parts["weight_grad"] == 0:  # ctypes launches linked to no op: by kernel name
        parts["weight_grad"] = wgrad_total
    parts["unattributed"] = total - sum(parts.values())
    host = sorted((e for e in prof.key_averages() if e.key not in PROFILE_LABELS),
                  key=lambda e: -e.self_cpu_time_total)[:8]
    return {"device_ms": total, "wall_ms": wall * 1e3 / steps,
            "busy_share": total / 1e3 / wall * steps, "parts": parts, "k1_linked": linked,
            "k1_ms": k1_total,
            "top_kernels_ms": {name[:90]: ms(us) for name, us in
                               sorted(by_name.items(), key=lambda kv: -kv[1])[:8]},
            "top_host_ms": {f"{e.key[:60]} x{e.count // steps}": ms(e.self_cpu_time_total)
                            for e in host}}


def train_timing_phase(K, new_model, new_trainer, prompts, datasets, input_grad_ms,
                       sensors=("WV3", "QB"), dtype=torch.float32):
    """Median step seconds of the `dtype` model at each sensor's bands, then
    a profiled window; `input_grad_ms` = {bands: K1's input-gradient ms a
    step, by events}."""
    from torch.profiler import ProfilerActivity, profile

    from tmdiff_tpu_torch.data.pipeline import BatchIterator
    from tmdiff_tpu_torch.runtime.prefetch import DeviceFeeder

    tag = "[train] bf16" if dtype == torch.bfloat16 else "[train]"
    trainer = new_trainer(new_model(dtype))
    state = trainer.init_state()
    timing = {}
    for sensor in sensors:
        bands = TRAIN_SENSORS[sensor][0]
        source = ((b, sensor) for b in BatchIterator(datasets[sensor], TRAIN_BATCH, seed=SEED))
        feeder = DeviceFeeder(source, device=DEV, depth=2)
        try:
            run_steps(trainer, state, feeder, prompts, 3)  # warm-up
            secs = []
            for _ in range(TIMED_STEPS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                run_steps(trainer, state, feeder, prompts, 1)
                torch.cuda.synchronize()
                secs.append(time.perf_counter() - t0)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                run_steps(trainer, state, feeder, prompts, PROFILED_STEPS)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
        finally:
            feeder.close()
        med = float(np.median(secs))
        br = profile_breakdown(prof, wall, PROFILED_STEPS, input_grad_ms[bands])
        timing[bands] = {"median_s": med, "img_per_s": TRAIN_BATCH / med, "steps_s": secs, **br}
        parts = ", ".join(f"{k} {v:.3f}" for k, v in br["parts"].items())
        print(f"{tag} {bands}-band step, batch {TRAIN_BATCH} {TRAIN_SIZE}x{TRAIN_SIZE}: median "
              f"{med:.4f} s over {TIMED_STEPS} ({min(secs):.4f}-{max(secs):.4f}), "
              f"{TRAIN_BATCH / med:.1f} img/s; profiled {PROFILED_STEPS} steps: wall "
              f"{br['wall_ms']:.2f} ms/step, device {br['device_ms']:.2f} ms/step, busy share "
              f"{br['busy_share']:.3f}; device ms/step by part: {parts}; all K1 kernels "
              f"{br['k1_ms']:.3f} (K1 launches linked to their ops: {br['k1_linked']})",
              flush=True)
        for name, v in br["top_kernels_ms"].items():
            print(f"{tag}   device {v:9.3f} ms/step  {name}", flush=True)
        for name, v in br["top_host_ms"].items():
            print(f"{tag}   host   {v:9.3f} ms/step  {name}", flush=True)
    return timing


# compiled_step against train_step: steps compared from one start, then
# timed steps each way; the compiled run's last GRAPHED_PROFILED under the
# profiler
GRAPHED_STEPS, GRAPHED_TIMED, GRAPHED_PROFILED = 3, 5, 1
# K1's main kernel per wrapper launch, by variant (its weight pass and
# split-K reduce are further kernels of the same launch)
K1_KERNELS = {"ffma": "conv_3x3_ffma_kernel", "tf32x3": "conv_3x3_tf32x3_kernel",
              "tf32x3_splitk": "conv_3x3_tf32x3_kernel", "bf16": "conv_3x3_bf16_kernel",
              "bf16_splitk": "conv_3x3_bf16_kernel"}


def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]


def device_kernels(fn, steps: int = 1):
    """(the kernels fn() ran on the card, `steps` times, in start order as
    (name, device us); the wall seconds), read by torch.profiler; a CUDA
    graph's replay shows each of its kernel nodes."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA
                     and e.name not in PROFILE_LABELS), key=lambda e: e.time_range.start)
    return [(e.name, e.device_time_total) for e in events], wall


def k1_kernels(kernels) -> list:
    """K1's main kernels among `kernels` (device_kernels), in order, by
    their K1_KERNELS name: one per wrapper launch."""
    names = set(K1_KERNELS.values())
    return [n for name, _ in kernels for n in names if n in name]


def state_tensors(state) -> list:
    """(name, tensor) of every tensor of a TrainState: parameters, EMA,
    AdamW's moments and step counts, the lr."""
    out = [(f"param {n}", p.detach()) for n, p in state.model.named_parameters()]
    out += [(f"ema {i}", e) for i, e in enumerate(state.ema_params)]
    for i, p in enumerate(state.model.parameters()):
        out += [(f"adamw {i} {k}", v) for k, v in sorted(state.optimizer.state[p].items())]
    out += [(f"lr {i}", torch.as_tensor(g["lr"])) for i, g in
            enumerate(state.optimizer.param_groups)]
    return out


def state_gap(a, b) -> tuple:
    """(every tensor equal, the largest difference over its tensor's scale,
    that tensor's name) between two lists of state_tensors, which must name
    the same tensors."""
    if [n for n, _ in a] != [n for n, _ in b]:
        fail("two training states hold different tensors")
    gaps = {n: rel_to_scale(x.float(), y.float()) for (n, x), (_, y) in zip(a, b)
            if not torch.equal(x, y)}
    worst = max(gaps, key=gaps.get) if gaps else None
    return not gaps, (gaps[worst] if gaps else 0.0), worst


def train_graphed_phase(K, new_model, new_trainer, prompts, datasets, dtype=torch.float32):
    """Trainer.compiled_step against train_step on the full-width model of
    `dtype`, at 8 and 4 bands, from one start on the same batches: the
    eager run (GRAPHED_STEPS steps, its state kept, then GRAPHED_TIMED
    timed ones), then the compiled run (its first call: its own step, then
    the capture, whose seconds it gives; then replays, the same steps
    timed, and GRAPHED_PROFILED replays under the profiler, which read the
    K1 kernels each replay runs on the card and the busy share). Each run
    trains a copy of one seeded model; its peak memory is
    max_memory_allocated above what was allocated before the copy. Gated:
    the states after GRAPHED_STEPS and at the end bit for bit, and the
    losses; every replay runs the K1 kernels the capture recorded, in its
    order: 130 forward + 65 input gradient; the capture records the
    sequence the call's eager step and the eager run's first step
    launched."""
    from tmdiff_tpu_torch.data.pipeline import BatchIterator

    bf16 = dtype == torch.bfloat16
    tag = "[train] graphed" + (" bf16" if bf16 else "")
    gpu = card()
    out = {}
    for sensor in ("WV3", "QB"):
        bands = TRAIN_SENSORS[sensor][0]
        prompt = prompts[sensor]
        it = BatchIterator(datasets[sensor], TRAIN_BATCH, seed=SEED)
        n_all = GRAPHED_STEPS + GRAPHED_TIMED
        batches = [{k: torch.as_tensor(b[k], device=DEV) for k in ("Res", "PAN", "MS")}
                   for b, _ in zip(it, range(n_all + GRAPHED_PROFILED))]
        runs, start = {}, new_model(dtype)
        for path in ("eager", "compiled"):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            held = torch.cuda.memory_allocated()
            trainer = new_trainer(copy.deepcopy(start))
            state = trainer.init_state()
            step = trainer.compiled_step() if path == "compiled" else trainer.train_step
            feed = iter(batches)
            seq = []
            real = K._launch

            def recorder(x, kernel, style, bias, out, input_grad=False, unsharded=None, **pre):
                before = dict(K.variant_launches)
                y = real(x, kernel, style, bias, out, input_grad=input_grad, unsharded=unsharded,
                         **pre)
                seq.append((input_grad, next(v for v in K.VARIANTS
                                             if K.variant_launches[v] != before[v])))
                return y

            K._launch = recorder
            try:
                t0 = time.perf_counter()
                _, m = step(state, next(feed), prompt)
                torch.cuda.synchronize()
                first_s = time.perf_counter() - t0
            finally:
                K._launch = real
            losses = [m["l_pix"].item()]
            for _ in range(GRAPHED_STEPS - 1):
                losses.append(step(state, next(feed), prompt)[1]["l_pix"].item())
            after_n = [(n, t.clone()) for n, t in state_tensors(state)]
            secs = []
            for _ in range(GRAPHED_TIMED):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                step(state, next(feed), prompt)
                torch.cuda.synchronize()
                secs.append(time.perf_counter() - t0)
            runs[path] = {"first_s": first_s, "losses": losses, "after_n": after_n,
                          "end": [(n, t.clone()) for n, t in state_tensors(state)], "seq": seq,
                          "median_s": float(np.median(secs)),
                          "max_memory_allocated": torch.cuda.max_memory_allocated() - held}
            if path == "compiled":
                kernels, wall = device_kernels(lambda: step(state, next(feed), prompt),
                                               GRAPHED_PROFILED)
                runs[path].update(k1=k1_kernels(kernels),
                                  busy_share=sum(us for _, us in kernels) / 1e6 / wall,
                                  capture_s=sum(trainer.capture_seconds().values()))
                trainer.release_compiled()
        eager, comp = runs["eager"], runs["compiled"]
        same_n = state_gap(comp["after_n"], eager["after_n"])
        same_end = state_gap(comp["end"], eager["end"])
        half = len(comp["seq"]) // 2
        captured = comp["seq"][half:]
        fwd = sum(not ig for ig, _ in captured)
        per_replay = len(comp["k1"]) / GRAPHED_PROFILED
        res = {"capture_s": comp["capture_s"], "first_call_s": comp["first_s"],
               "replay_k1": per_replay, "replay_k1_forward": fwd,
               "replay_k1_input_grad": len(captured) - fwd,
               "bit_identical_after": {GRAPHED_STEPS: same_n[0], n_all: same_end[0]},
               "largest_gap_of_scale": max(same_n[1], same_end[1]),
               "losses_equal": comp["losses"] == eager["losses"],
               "median_s": comp["median_s"], "eager_median_s": eager["median_s"],
               "busy_share": comp["busy_share"],
               "max_memory_allocated": comp["max_memory_allocated"],
               "eager_max_memory_allocated": eager["max_memory_allocated"], "card": gpu}
        out[bands] = res
        print(f"{tag} {bands}-band step, batch {TRAIN_BATCH} {TRAIN_SIZE}x{TRAIN_SIZE}: capture "
              f"{res['capture_s']:.3f} s (first call {res['first_call_s']:.3f} s with its own "
              f"step); each of {GRAPHED_PROFILED} replays ran {per_replay:g} K1 kernels on the "
              f"card (profiler), {fwd} forward + {res['replay_k1_input_grad']} input gradient "
              f"in the captured order, as the eager step launched them; state after "
              f"{GRAPHED_STEPS} compiled steps against {GRAPHED_STEPS} eager ones bit for bit "
              f"{same_n[0]}, after {n_all} {same_end[0]} (largest gap "
              f"{res['largest_gap_of_scale']:.3g} of scale at {same_n[2] or same_end[2]}); "
              f"losses equal {res['losses_equal']}; median step compiled {res['median_s']:.4f} "
              f"s, eager {res['eager_median_s']:.4f} s over {GRAPHED_TIMED}; busy share "
              f"compiled {res['busy_share']:.3f}; max_memory_allocated compiled "
              f"{res['max_memory_allocated'] / 2**30:.2f} GiB, eager "
              f"{res['eager_max_memory_allocated'] / 2**30:.2f} GiB; {gpu}", flush=True)
        if comp["seq"][:half] != captured or eager["seq"] != captured:
            fail(f"{tag} {bands}-band: the capture launched another K1 sequence than the "
                 "eager step")
        want = [K1_KERNELS[v] for _, v in captured] * GRAPHED_PROFILED
        if comp["k1"] != want or (fwd, len(captured) - fwd) != (2 * TRAIN_CONVS, TRAIN_CONVS):
            fail(f"{tag} {bands}-band: {GRAPHED_PROFILED} replays ran {len(comp['k1'])} K1 "
                 f"kernels on the card; captured {fwd} forward + {len(captured) - fwd} input "
                 "gradient")
        if not (same_n[0] and same_end[0] and res["losses_equal"]):
            fail(f"{tag} {bands}-band: compiled steps differ from eager ones")
    return out


def input_grad_phase(K, new_model, new_trainer, prompts, datasets, sensor,
                     dtype=torch.float32):
    """K1's input gradient at every shape of one step of `sensor` in `dtype`
    against the library's (aten.convolution_backward for the input, TF32
    off, cuDNN in benchmark mode) and the plain version (fp32: CONV_RTOL;
    bf16: one bf16 step, bf16_check), beside its bound; and the weight
    gradient at the same shapes, its route's time (fp32: the weight-gradient
    kernel, within WGRAD_RTOL of scale of cuDNN's; bf16: cuDNN's, within one
    bf16 step plus 1e-4 of scale of the fp32 sums of the same bf16 operands)
    beside cuDNN's and its bound."""
    bf16 = dtype == torch.bfloat16
    tag = "[train] bf16" if bf16 else "[train]"
    peak, elem = (PEAK_BF16_FLOPS, 2) if bf16 else (PEAK_TF32X3_FLOPS, 4)
    trainer = new_trainer(new_model(dtype))
    state = trainer.init_state()
    batch = {k: torch.as_tensor(v, device=DEV) for k, v in datasets[sensor].batch(
        np.arange(TRAIN_BATCH)).items()}
    shapes = {}
    launch = K._launch

    def recorder(x, kernel, style, bias, out, input_grad=False, unsharded=None, **pre):
        if input_grad:
            key = tuple(x.shape) + (kernel.shape[-1],)
            shapes[key] = shapes.get(key, 0) + 1
        return launch(x, kernel, style, bias, out, input_grad, unsharded, **pre)

    K._launch = recorder
    try:
        trainer.train_step(state, batch, prompts[sensor])
    finally:
        K._launch = launch
    tot = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0, "weight_grad_ms": 0.0,
           "weight_grad_library_ms": 0.0, "weight_grad_bound_ms": 0.0,
           "weight_grad_fp32_bound_ms": 0.0, "ops_s": 0.0, "bytes_s": 0.0,
           "weight_grad_err_of_scale": 0.0}
    max_err = 0.0
    gen = torch.Generator(device=DEV).manual_seed(SEED)
    for (b, d, h, w, cout, cin), n in sorted(shapes.items()):
        dy = torch.randn(b, d, h, w, cout, device=DEV, generator=gen).to(dtype)
        k = (torch.randn(3, 3, 3, cin, cout, device=DEV, generator=gen) / (27 * cin) ** 0.5).to(dtype)
        x = torch.randn(b, d, h, w, cin, device=DEV, generator=gen).to(dtype)
        kt = k.flip((0, 1, 2)).transpose(3, 4).contiguous()
        with torch.no_grad():
            got = K._launch(dy, kt, None, None, None, True)
            ref = K.conv3d_plain(dy, kt)
            what = f"input gradient {(b, d, h, w, cout, cin)} {dtype}"
            if bf16:
                max_err = max(max_err, bf16_check(got, ref, what))
                err = (got.float() - ref.float()).abs().max().item() / ref.float().abs().max().item()
                dw, dw32 = K.conv3d_weight_grad(x, dy), K.conv3d_weight_grad(x.float(), dy.float())
                wscale = dw32.abs().max().item()
                over = ((dw.float() - dw32).abs() > 2 * bf16_half_step(dw32)
                        + BF16_CONV_RTOL * wscale)
                if dw.dtype != torch.bfloat16 or over.any():
                    fail(f"bf16 weight gradient {(b, d, h, w, cin, cout)}: {int(over.sum())} "
                         f"elements beyond one bf16 step of the fp32 sums")
                tot["weight_grad_err_of_scale"] = max(
                    tot["weight_grad_err_of_scale"], (dw.float() - dw32).abs().max().item() / wscale)
            else:
                err = rel_to_scale(got, ref)
                if not err <= CONV_RTOL:
                    fail(f"{what}: {err} of scale")
                max_err = max(max_err, (got - ref).abs().max().item())
                before = K.weight_grad_launches
                werr = rel_to_scale(K.conv3d_weight_grad(x, dy), K.weight_grad_library(x, dy))
                if K.weight_grad_launches != before + 1 or not werr <= WGRAD_RTOL:
                    fail(f"weight gradient {(b, d, h, w, cin, cout)}: {werr} of scale from "
                         f"cuDNN's, kernel launches {K.weight_grad_launches - before}")
                tot["weight_grad_err_of_scale"] = max(tot["weight_grad_err_of_scale"], werr)
            ms_k = cuda_ms(lambda: K._launch(dy, kt, None, None, None, True), 10)
            ms_p = cuda_ms(lambda: K.conv3d_plain(dy, kt), 3)
            wl = k.permute(4, 3, 0, 1, 2).contiguous(memory_format=torch.channels_last_3d)
            ms_l = library_ms(lambda: torch.ops.aten.convolution_backward(
                dy.permute(0, 4, 1, 2, 3), x.permute(0, 4, 1, 2, 3), wl, None, [1, 1, 1],
                [1, 1, 1], [1, 1, 1], False, [0, 0, 0], 1, [True, False, False]), 10)
            ms_w = cuda_ms(lambda: K.conv3d_weight_grad(x, dy), 10)
            ms_wl = cuda_ms(lambda: K.weight_grad_library(x, dy), 10)
        bnd, bound_by = conv_bound(b, d, h, w, cout, cin, False, False, False, peak, elem)
        # the weight gradient: the forward's multiply-adds, x and dy read, dW written
        wg_flops = 2.0 * b * cin * cout * valid_taps(d) * valid_taps(h) * valid_taps(w)
        wg_bytes = elem * (b * d * h * w * (cin + cout) + 27 * cin * cout)
        wg_bnd, _ = bound(wg_flops, wg_bytes, peak)
        wg_fp32, _ = bound(wg_flops, wg_bytes, PEAK_FP32_FLOPS)
        route = "cuDNN" if bf16 else "kernel"
        print(f"{tag} input gradient B{b} D{d} {h}x{w} {cout}->{cin} x{n}/step: K1 "
              f"{ms_k:.4f} ms, plain {ms_p:.4f}, library {ms_l:.4f}, bound {bnd:.4f} "
              f"({bound_by}); weight gradient ({route}) {ms_w:.4f} ms, cuDNN {ms_wl:.4f}, "
              f"bound {wg_bnd:.4f} (fp32 FMA {wg_fp32:.4f}); err {err:.3g} of scale",
              flush=True)
        for key, v in (("ms", ms_k), ("plain_ms", ms_p), ("library_ms", ms_l), ("bound_ms", bnd),
                       ("weight_grad_ms", ms_w), ("weight_grad_library_ms", ms_wl),
                       ("weight_grad_bound_ms", wg_bnd), ("weight_grad_fp32_bound_ms", wg_fp32)):
            tot[key] += n * v
        tot["ops_s" if bound_by == "operations" else "bytes_s"] += n * bnd
    tot["bound_by"] = "operations" if tot["ops_s"] >= tot["bytes_s"] else "bytes"
    rate = "bf16" if bf16 else "3xTF32"
    against = (f"; the {'bf16' if bf16 else 'kernel'} weight gradients within "
               f"{tot['weight_grad_err_of_scale']:.3g} of their scale of "
               f"{'fp32 sums' if bf16 else 'cuDNN'}")
    print(f"{tag} one {TRAIN_SENSORS[sensor][0]}-band step's input gradients, summed: K1 "
          f"{tot['ms']:.2f} ms, plain "
          f"{tot['plain_ms']:.2f}, library {tot['library_ms']:.2f}, bound {tot['bound_ms']:.2f} "
          f"({tot['bound_by']}); weight gradients {tot['weight_grad_ms']:.2f} ms, cuDNN "
          f"{tot['weight_grad_library_ms']:.2f}, bound {tot['weight_grad_bound_ms']:.2f} at "
          f"{rate} ({tot['weight_grad_fp32_bound_ms']:.2f} at fp32 FMA){against}; "
          f"{sum(shapes.values())} launches at {len(shapes)} shapes",
          flush=True)
    return tot, max_err


# bf16 training: every gradient through K1's bf16 instance within twice the
# plain bf16 path's own gap to the fp32 path (that gap floored at its median
# over the parameters: one gradient's gap is a draw of bf16 noise) of the
# plain bf16 path's, and within BF16_GRAD_CAP of the gradient's scale
BF16_GRAD_CAP = 5e-2
BF16_TRAIN_STEPS = 10


@contextlib.contextmanager
def counting_plain_convs(K, modconv):
    """Within the block, counts calls of the plain 3x3x3 conv (both names)
    in the list it yields."""
    calls = []
    originals = K.conv3d_plain, modconv.conv3d_plain

    def counted(*a, **k):
        calls.append(1)
        return originals[0](*a, **k)

    K.conv3d_plain = modconv.conv3d_plain = counted
    try:
        yield calls
    finally:
        K.conv3d_plain, modconv.conv3d_plain = originals


def bf16_grads_check(K, label, paths, params32, loss_of):
    """Gradients of `loss_of(model)` (the L1 loss with the plain bf16 path's
    signs) through the bf16 kernel, the plain bf16 convs and the fp32
    kernel: `paths` = {"kernel": model16, "plain": model16, "fp32":
    model32}, each model's parameters in one order; `params32` names them.
    Holds each kernel gradient within twice the plain path's own gap to
    fp32 (floored at its median) and BF16_GRAD_CAP of the plain path's, of
    the fp32 gradient's scale; returns the worst (gap, own, to fp32) row,
    the kernel pass's counts and its gradients by name."""
    grads, n = {}, {}
    for name in ("plain", "kernel", "fp32"):
        model = paths[name]
        model.use_plain_conv(name == "plain")
        reset_counts(K)
        ps = [p for _, p in model.named_parameters()]
        grads[name] = torch.autograd.grad(loss_of(model, name), ps, allow_unused=True)
        torch.cuda.synchronize()
        n[name] = (K.dtype_launches["bfloat16"], K.dtype_launches["float32"], K.input_grad_launches,
                   K.weight_grad_calls, {v for v, c in K.variant_launches.items() if c})
        model.use_plain_conv(False)
    rows = {}
    for i, pname in enumerate(params32):
        g32, gp, gk = grads["fp32"][i], grads["plain"][i], grads["kernel"][i]
        if g32 is None or not g32.abs().max().item() > 0:
            continue
        scale = g32.abs().max().item()
        rows[pname] = ((gk - gp).abs().max().item() / scale, (gp - g32).abs().max().item() / scale,
                       (gk - g32).abs().max().item() / scale)
    floor = float(np.median([own for _, own, _ in rows.values()]))
    over = {k: r for k, r in rows.items()
            if not (r[0] <= 2 * max(r[1], floor) and r[0] < BF16_GRAD_CAP)}
    worst = max(rows, key=lambda k: rows[k][0] / max(rows[k][1], floor))
    print(f"[{label}] bf16 gradients, L1 with the plain bf16 path's signs: {len(rows)} "
          f"gradients, worst {worst} at {rows[worst][0]:.3g} of scale against the plain bf16 "
          f"path, whose own gap to fp32 is {rows[worst][1]:.3g} (median {floor:.3g}); largest "
          f"gap to the plain path {max(r[0] for r in rows.values()):.3g} (cap {BF16_GRAD_CAP}), "
          f"to fp32 {max(r[2] for r in rows.values()):.3g}; kernel pass "
          f"launches (bf16, fp32, input gradient, weight gradients, variants) {n['kernel']}, "
          f"plain pass {n['plain'][:4]}", flush=True)
    if over:
        fail(f"{label} bf16 gradients beyond the bar: {over}")
    return rows[worst], n["kernel"], dict(zip(params32, grads["kernel"]))


def distill_bf16_steps(K, student, schedule, batch, prompt, steps=2):
    """`steps` DistillTrainer steps of a bf16 student (N = 10 of T = 1000)
    from a bf16 teacher on its starting weights: per step 5 x 65 bf16 K1
    launches (two teacher calls, the student's forward and remat's
    recompute, its input gradient), 65 weight gradients, no fp32 launch;
    finite losses, float32 state. Returns launches per step and s/step."""
    from tmdiff_tpu_torch.train.distill import DistillTrainer

    d_trainer = DistillTrainer(student, schedule, n_student_steps=10)
    state = d_trainer.init_state()
    teacher = {n: p.detach().clone() for n, p in student.named_parameters()}
    reset_counts(K)
    t0 = time.perf_counter()
    losses = [d_trainer.train_step(state, batch, prompt, teacher)[1]["l_pix"].item()
              for _ in range(steps)]
    sec = (time.perf_counter() - t0) / steps
    n = {"bf16": K.dtype_launches["bfloat16"] / steps, "fp32": K.dtype_launches["float32"] / steps,
         "input_grad": K.input_grad_launches / steps, "weight_grad": K.weight_grad_calls / steps}
    fp32_state = all(p.dtype == torch.float32 for p in [*student.parameters(), *state.ema_params])
    print(f"[train] bf16 DistillTrainer (N = 10), 8-band batch {TRAIN_BATCH} "
          f"{TRAIN_SIZE}x{TRAIN_SIZE}: {steps} steps, {sec:.4f} s/step, losses "
          f"{[round(x, 6) for x in losses]}; launches per step {n}; state float32 {fp32_state}",
          flush=True)
    want = {"bf16": 5 * TRAIN_CONVS, "fp32": 0, "input_grad": TRAIN_CONVS,
            "weight_grad": TRAIN_CONVS}
    if n != want or not all(np.isfinite(losses)) or not fp32_state:
        fail(f"bf16 distillation steps: launches {n} (want {want}), losses {losses}")
    return {"launches_per_step": n, "s_per_step": sec}


def train_bf16_phase(K, modconv, new_model, new_trainer, prompts, datasets, gen, fp32_timing):
    """bf16 training of the full-width model (WavBEST(dtype=torch.bfloat16),
    fp32 parameters, AdamW and EMA): every gradient through K1's bf16
    instance against the plain bf16 convs and the fp32 kernel (8 bands,
    fixed t and noise, dropout off); the bf16 training forward against the
    served one (its concat parts rounded apart); BF16_TRAIN_STEPS of the
    preset through the mixer and feeder, counts reset just before and read
    just after (130 bf16 K1 forward + 65 input-gradient launches, 65 weight
    gradients, no fp32 K1 launch, no plain conv a step; state fp32); K1
    bf16's input gradient and the bf16 weight gradient at every shape of a
    step against their plain versions; the median step at 8 bands beside
    the fp32 step, with its device breakdown."""
    from tmdiff_tpu_torch.runtime.prefetch import DeviceFeeder

    model16, model32 = new_model(torch.bfloat16), new_model()
    trainer = new_trainer(model16)
    batch, t, noise = device_batch(datasets["WV3"], gen)
    res, prompt = batch["Res"], prompts["WV3"]
    signs = {}

    def loss_of(model, name):
        pred = predict(model, trainer.schedule, batch, prompt, t, noise)
        if name == "plain":
            signs["s"] = torch.sign(pred.detach() - res)
        return torch.mean((pred - res) * signs["s"])

    names = [n for n, _ in model32.named_parameters()]
    worst, n_grad, _ = bf16_grads_check(K, "train", {"kernel": model16, "plain": model16,
                                                     "fp32": model32}, names, loss_of)
    if n_grad[:4] != (2 * TRAIN_CONVS, 0, TRAIN_CONVS, TRAIN_CONVS) or not n_grad[4] <= BF16_VARIANTS:
        fail(f"bf16 gradient pass launches {n_grad}")
    with torch.no_grad():
        served = predict(model16, trainer.schedule, batch, prompt, t, noise)
    trained = predict(model16, trainer.schedule, batch, prompt, t, noise).detach()
    forward_gap = rel_to_scale(trained, served)
    print(f"[train] bf16 training forward (concat parts rounded apart) against the served "
          f"forward (one rounding): {forward_gap:.3g} of scale", flush=True)

    state = trainer.init_state()
    feeder = DeviceFeeder(mixer_for(datasets, SEED), device=DEV, depth=2)
    try:
        with counting_plain_convs(K, modconv) as plain_calls:
            reset_counts(K)
            losses = run_steps(trainer, state, feeder, prompts, BF16_TRAIN_STEPS)
            torch.cuda.synchronize()
            n = {"k1_forward": K.launches - K.input_grad_launches,
                 "k1_input_grad": K.input_grad_launches, "weight_grad": K.weight_grad_calls,
                 "weight_grad_kernel": K.weight_grad_launches,
                 "bf16": K.dtype_launches["bfloat16"], "fp32": K.dtype_launches["float32"],
                 "plain": len(plain_calls)}
            variants = {v for v, c in K.variant_launches.items() if c}
    finally:
        feeder.close()
    per_step = {k: v / BF16_TRAIN_STEPS for k, v in n.items()}
    moments = [v for st in state.optimizer.state.values() for k, v in st.items() if k != "step"]
    fp32_state = all(x.dtype == torch.float32 for x in
                     [*model16.parameters(), *state.ema_params, *moments])
    print(f"[train] bf16: {BF16_TRAIN_STEPS} steps of the preset through SensorMixer 4:4:8 and "
          f"DeviceFeeder: losses {[round(x, 6) for x in losses]}; per step {per_step}, variants "
          f"{sorted(variants)}; parameters, AdamW moments ({len(moments)}) and EMA float32: "
          f"{fp32_state}", flush=True)
    want = {"k1_forward": 2 * TRAIN_CONVS, "k1_input_grad": TRAIN_CONVS,
            "weight_grad": TRAIN_CONVS, "weight_grad_kernel": 0, "bf16": 3 * TRAIN_CONVS,
            "fp32": 0, "plain": 0}
    if per_step != want or not variants <= BF16_VARIANTS:
        fail(f"bf16 launches per training step {per_step}, variants {variants}; want {want}")
    if not all(np.isfinite(losses)) or not fp32_state or len(moments) != 2 * len(names):
        fail("bf16 training: losses not finite or a parameter, moment or EMA not float32")
    distill = distill_bf16_steps(K, model16, trainer.schedule, batch, prompt)

    input_grad, input_grad_err = input_grad_phase(K, new_model, new_trainer, prompts, datasets,
                                                  "WV3", torch.bfloat16)
    timing = train_timing_phase(K, new_model, new_trainer, prompts, datasets,
                                {8: input_grad["ms"]}, ("WV3",), torch.bfloat16)[8]
    print(f"[train] bf16 8-band step median {timing['median_s']:.4f} s against the fp32 step's "
          f"{fp32_timing['median_s']:.4f} s in this run ({fp32_timing['median_s'] / timing['median_s']:.2f}x)",
          flush=True)
    graphed = train_graphed_phase(K, new_model, new_trainer, prompts, datasets, torch.bfloat16)
    return {"graphed": graphed, "counts": per_step, "distill": distill,
            "grad_worst_gap_own_to_fp32": worst, "forward_gap": forward_gap,
            "input_grad": input_grad, "input_grad_max_abs_err": input_grad_err,
            "timing": timing, "fp32_median_s": fp32_timing["median_s"]}


def train_phase(K, K3, K4, modconv, gen):
    new_model, new_trainer, prompts, datasets = train_setup()
    grad_err = train_grads_phase(K, new_model, new_trainer, prompts, datasets, gen)
    n, losses = train_main_phase(K, K3, K4, new_model, new_trainer, prompts, datasets)
    train_learn_phase(new_model, new_trainer, prompts, datasets, gen)
    input_grad = {TRAIN_SENSORS[sensor][0]: input_grad_phase(K, new_model, new_trainer, prompts,
                                                               datasets, sensor)
                  for sensor in ("WV3", "QB")}
    timing = train_timing_phase(K, new_model, new_trainer, prompts, datasets,
                                {bands: tot["ms"] for bands, (tot, _) in input_grad.items()})
    graphed = train_graphed_phase(K, new_model, new_trainer, prompts, datasets)
    bf16 = train_bf16_phase(K, modconv, new_model, new_trainer, prompts, datasets, gen,
                            timing[8])
    return {"counts": n, "grad_err": grad_err, "timing": timing, "input_grad": input_grad[8][0],
            "input_grad_err": max(err for _, err in input_grad.values()), "bf16": bf16,
            "graphed": graphed}


# The CLI at the general_multi preset: 7 steps, validation and a checkpoint
# every 3 (keep 2), two 256x256 scenes a sensor to validate, batch 2.
CLI_MAX_ITER, CLI_VAL_FREQ, CLI_KEEP = 7, 3, 2
CLI_VAL_SIZE, CLI_VAL_SCENES, CLI_VAL_BATCH = 256, 2, 2
CLI_STOP_AFTER = 2  # the step after which SIGTERM stops the preemption run
SSIM_ATOL, SAM_RTOL = 1e-3, 1e-5


def cli_config(root: str, name: str, **train) -> str:
    """The general_multi preset with the phase's settings, as a config file
    under `root` (whose experiments tree it is)."""
    from tmdiff_tpu_torch.config.config import PRESETS, load_commented_json

    cfg = load_commented_json(os.path.join(PRESETS, "general_multi.json"))
    cfg["name"] = name
    cfg["path"]["experiments_root"] = os.path.join(root, name)
    cfg["train"].update({"max_iter": CLI_MAX_ITER, "val_freq": CLI_VAL_FREQ, "print_freq": 1,
                         "ckpt_keep": CLI_KEEP, "use_ema_eval": True, **train})
    cfg["val_batch_size"] = CLI_VAL_BATCH
    path = os.path.join(root, f"{name}.json")
    with open(path, "w") as f:
        json.dump(cfg, f)
    return path


class CliProbe:
    """While installed: the end time of each training step (after a
    synchronize) and the K1 launches its wrapper counted on the host (a
    replay of a captured step counts none: its launches are read on the
    card), the K1 kernels one replay ran on the card (the first step at a
    batch shape its trainer has stepped before, under the profiler), each
    checkpoint save's seconds and bytes, and each validation's scores, read
    around the CLI's own calls (its loop steps through compiled_step)."""

    def __init__(self):
        self.step_ends, self.saves, self.scores = [], [], []
        self.host_launches = []  # per step: (K1 forward, input gradient, weight gradients)
        self.profiled = []  # per step: whether it ran under the profiler
        self.replay_k1 = None

    def __enter__(self):
        from tmdiff_tpu_torch.eval import harness
        from tmdiff_tpu_torch.ops.cuda import conv3d as K
        from tmdiff_tpu_torch.train import checkpoint, trainer

        self._saved = [(obj, name, getattr(obj, name)) for obj, name in (
            (trainer.Trainer, "compiled_step"), (checkpoint, "save_checkpoint"),
            (harness, "validate"))]
        compiled_step, save, validate = (f for _, _, f in self._saved)
        probe = self
        counted = lambda: (K.launches - K.input_grad_launches, K.input_grad_launches,
                           K.weight_grad_calls)

        def timed_compiled_step(tr):
            step, seen = compiled_step(tr), set()

            def timed_step(state, batch, *rest):
                shape, before, out = tuple(batch["MS"].shape), counted(), []
                run = lambda: out.append(step(state, batch, *rest))
                profiled = shape in seen and probe.replay_k1 is None
                if profiled:
                    probe.replay_k1 = len(k1_kernels(device_kernels(run)[0]))
                else:
                    run()
                probe.profiled.append(profiled)
                seen.add(shape)
                torch.cuda.synchronize()
                probe.step_ends.append(time.perf_counter())
                probe.host_launches.append(tuple(a - b for a, b in zip(counted(), before)))
                return out[0]

            return timed_step

        def timed_save(root, state, keep=None, mesh=None):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            path = save(root, state, keep=keep, mesh=mesh)
            self.saves.append((state.step, time.perf_counter() - t0,
                               os.path.getsize(os.path.join(path, checkpoint.STATE_FILE))))
            return path

        def scored(*args, **kw):
            out = validate(*args, **kw)
            self.scores.append(out)
            return out

        trainer.Trainer.compiled_step = timed_compiled_step
        checkpoint.save_checkpoint = timed_save
        harness.validate = scored
        return self

    def __exit__(self, *exc):
        for obj, name, f in self._saved:
            setattr(obj, name, f)

    def replays(self, first: int = 1) -> list:
        """1-based numbers of the steps, from `first`, that replayed a graph
        outside the profiler: the loop's steady state."""
        return [i for i, (h, p) in enumerate(zip(self.host_launches, self.profiled), 1)
                if i >= first and h == (0, 0, 0) and not p]

    def captures(self, per_step: tuple) -> int:
        """The steps that captured a graph, each of which counted its own
        step and the capture's (2 x `per_step`) on the host; every other
        step must be a replay that counted none."""
        twice = tuple(2 * n for n in per_step)
        if any(h not in (twice, (0, 0, 0)) for h in self.host_launches):
            fail(f"host-counted K1 launches per step {self.host_launches}: each a capture "
                 f"{twice} or a replay (0, 0, 0)")
        return self.host_launches.count(twice)


def run_cli(cfg_path, phase, datasets, stop=None):
    """The CLI's run of one config on `datasets` ((mixer, val_sets)), through
    its `_run` seam, with SIGTERM and SIGINT caught as `main` catches them;
    returns (trainer, state)."""
    from tmdiff_tpu_torch import cli
    from tmdiff_tpu_torch.config import parse_config

    args = cli.parse_args(["-c", cfg_path, "-p", phase])
    opt = parse_config(cfg_path, phase=phase)
    opt["log_eval"] = False
    with cli.stop_on_signals(phase in ("train", "distill")) as stop:
        return cli._run(args, opt, stop, datasets=datasets)


def same_state(a, b) -> list:
    """Names of the state's parts that differ between two TrainStates."""
    diff = []
    if a.step != b.step:
        diff.append("step")
    for (n, x), y in zip(a.model.state_dict().items(), b.model.state_dict().values()):
        if not torch.equal(x, y):
            diff.append(f"model.{n}")
    sa, sb = a.optimizer.state_dict(), b.optimizer.state_dict()
    for i in sa["state"]:
        for k, v in sa["state"][i].items():
            if not torch.equal(torch.as_tensor(v), torch.as_tensor(sb["state"][i][k])):
                diff.append(f"optimizer.{i}.{k}")
    if [float(g["lr"]) for g in sa["param_groups"]] != [float(g["lr"]) for g in
                                                        sb["param_groups"]]:
        diff.append("lr")
    if a.scheduler.state_dict() != b.scheduler.state_dict():
        diff.append("scheduler")
    diff += [f"ema.{i}" for i, (x, y) in enumerate(zip(a.ema_params, b.ema_params))
             if not torch.equal(x, y)]
    return diff


def cli_val_scores(state, val_sets, ref_scores):
    """The -p val run's scores (on the card) against the host's on the same
    predictions: SAM against the numpy suite's, SSIM against the host's
    Gaussian-window SSIM; the numpy suite's uniform-window SSIM printed
    beside them."""
    from tmdiff_tpu_torch.eval import metrics as M
    from tmdiff_tpu_torch.pipeline import Pansharpener

    sharp = Pansharpener(state.model, device=DEV)
    params = dict(zip((n for n, _ in state.model.named_parameters()), state.ema_params))
    worst = {"ssim": 0.0, "sam": 0.0, "ssim_uniform": 0.0}
    for sensor, ds in val_sets.items():
        host = {"ssim": [], "sam": [], "ssim_uniform": []}
        for start in range(0, len(ds), CLI_VAL_BATCH):
            batch = ds.batch(np.arange(start, min(start + CLI_VAL_BATCH, len(ds))))
            preds = sharp.sample(batch, sensor=sensor, seed=start, params=params)
            for b in range(preds.shape[0]):
                p, g = (np.transpose(a[b], (1, 2, 0)) for a in (preds, batch["HR"]))
                host["ssim"].append(M.ssim_gaussian(g, p, 1.0))
                host["sam"].append(M.sam(p, g))
                host["ssim_uniform"].append(M.ssim(p, g, 1.0))
        host = {k: float(np.mean(v)) for k, v in host.items()}
        dev = ref_scores[sensor]
        d_ssim = abs(dev[f"ssim_{sensor}"] - host["ssim"])
        d_sam = abs(dev[f"sam_{sensor}"] - host["sam"]) / abs(host["sam"])
        d_uni = abs(dev[f"ssim_{sensor}"] - host["ssim_uniform"])
        worst = {"ssim": max(worst["ssim"], d_ssim), "sam": max(worst["sam"], d_sam),
                 "ssim_uniform": max(worst["ssim_uniform"], d_uni)}
        print(f"[cli] -p val {sensor}: on the card SSIM {dev[f'ssim_{sensor}']:.6f} SAM "
              f"{dev[f'sam_{sensor}']:.6f}; on the host SSIM (Gaussian window) "
              f"{host['ssim']:.6f} (|diff| {d_ssim:.3g}, atol {SSIM_ATOL}), SAM {host['sam']:.6f} "
              f"(rel {d_sam:.3g}, rtol {SAM_RTOL}); the numpy suite's uniform-window SSIM "
              f"{host['ssim_uniform']:.6f} (|diff| {d_uni:.3g})", flush=True)
        if not (d_ssim <= SSIM_ATOL and d_sam <= SAM_RTOL):
            fail(f"-p val {sensor}: scores on the card differ from the host's")
    return worst


def cli_val_sets():
    """Two 256x256 synthetic scenes a sensor, the CLI's validation sets."""
    from tmdiff_tpu_torch.data.h5 import PanDataset
    from tmdiff_tpu_torch.data.synthetic import make_arrays

    return {s: PanDataset(make_arrays(CLI_VAL_SCENES, bands, CLI_VAL_SIZE, seed=20 + seed))
            for s, (bands, seed) in TRAIN_SENSORS.items()}


def cli_phase(K, K3, K4, train_median_s, root):
    """The CLI's train run under `root` (its I7 checkpoint stays there for the
    distill phase), counts reset just before and read just after, then the
    checks listed in the docstring."""
    import signal
    import threading

    import scipy.io as scio

    from tmdiff_tpu_torch.models.clip_text import clip_mode, get_prompt_embedding
    from tmdiff_tpu_torch.models.wavbest import WavBEST
    from tmdiff_tpu_torch.train import checkpoint as ckpt_lib

    _, _, _, train_sets = train_setup()
    val_sets = cli_val_sets()
    cfg = cli_config(root, "train")
    with CliProbe() as probe:
        reset_counts(K, K3, K4)
        t0 = time.perf_counter()
        trainer, state = run_cli(cfg, "train", (mixer_for(train_sets, SEED), val_sets))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n = counts(K, K3, K4)
    ckpt_dir = os.path.join(root, "train", "checkpoint")
    kept = sorted(os.listdir(ckpt_dir))
    steps = np.diff(probe.step_ends)
    # intervals that end at a replay, inside a stretch of training (not
    # across a validation)
    replays = set(probe.replays(2))
    loop = [d for i, d in enumerate(steps, 2) if (i - 1) % CLI_VAL_FREQ and i in replays]
    s_step = float(np.median(loop))
    print(f"[cli] train: {CLI_MAX_ITER} steps of batch {TRAIN_BATCH} {TRAIN_SIZE}x{TRAIN_SIZE} "
          f"with validation at {list(range(CLI_VAL_FREQ, CLI_MAX_ITER + 1, CLI_VAL_FREQ))}: "
          f"{wall:.2f} s in all; the loop's median {s_step:.4f} s/step "
          f"({TRAIN_BATCH / s_step:.1f} img/s) over its {len(loop)} replays of a captured "
          f"step (the train phase's compiled 8-band step {train_median_s[8]:.4f} s, 4-band "
          f"{train_median_s[4]:.4f} s); "
          f"launches {n}; checkpoints on disk {kept}", flush=True)
    if n["k1_forward"] == 0 or n["k1_input_grad"] == 0 or n["k3"] or n["k4"]:
        fail(f"the CLI's run launched {n}")
    # (the val run below installs a probe of its own)
    captures = probe.captures((2 * TRAIN_CONVS, TRAIN_CONVS, TRAIN_CONVS))
    replay_k1 = probe.replay_k1
    print(f"[cli] train ran compiled_step: {captures} captures (one a band count), "
          f"{len(probe.host_launches) - captures} replays; a replay ran {replay_k1} K1 "
          f"kernels on the card (profiler; {3 * TRAIN_CONVS} a step)", flush=True)
    if replay_k1 != 3 * TRAIN_CONVS or not 1 <= captures <= 2:
        fail(f"the CLI's compiled steps: {captures} captures, a replay ran {replay_k1} K1 "
             "kernels")
    if kept != ["I6", "I7"]:
        fail(f"checkpoints {kept}, expected I6 and I7 (I3 pruned)")
    saves = probe.saves
    for step, sec, nbytes in saves:
        print(f"[cli] checkpoint I{step}: {nbytes} bytes, saved in {sec:.3f} s", flush=True)
    mats = 0
    for sensor, ds in val_sets.items():
        for i in range(len(ds)):
            mat = scio.loadmat(os.path.join(root, "train", "results", sensor,
                                            f"output_mulExm_{i}.mat"))
            if (mat["sr"].shape != (CLI_VAL_SIZE, CLI_VAL_SIZE, ds.bands)
                    or str(mat["clip_mode"][0]) != clip_mode()):
                fail(f"{sensor} .mat {i}: shape {mat['sr'].shape}, stamp {mat['clip_mode']}")
            mats += 1
    scores = probe.scores
    if len(scores) != 2 * len(val_sets) or not all(
            np.isfinite(v) for sc in scores for v in sc.values()):
        fail(f"validation scores {scores}")
    sec_per_image = {k: v for sc in scores[-len(val_sets):] for k, v in sc.items()
                     if k.startswith("sec_per_image")}
    print(f"[cli] validations: {len(scores)} (EMA weights); {mats} .mat files of "
          f"{CLI_VAL_SIZE}x{CLI_VAL_SIZE}, stamped {clip_mode()!r}; last scores "
          f"{scores[-len(val_sets):]}", flush=True)

    # restore I7 into a fresh state: bit for bit; then one step on each
    new_trainer = dataclasses.replace(trainer, model=WavBEST(CHANNELS, device=DEV, seed=1))
    fresh = new_trainer.init_state()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ckpt_lib.restore_checkpoint(ckpt_dir, fresh, step=CLI_MAX_ITER)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    diff = same_state(state, fresh)
    print(f"[cli] I7 restored in {restore_s:.3f} s into a fresh state: parts that differ "
          f"{diff or 'none'}", flush=True)
    if diff:
        fail(f"the restored state differs: {diff[:8]}")
    batch, sensor = next(mixer_for(train_sets, SEED + 7))
    prompt = torch.as_tensor(get_prompt_embedding(sensor), device=DEV)
    trainer.train_step(state, batch, prompt)
    new_trainer.train_step(fresh, batch, prompt)
    diff = same_state(state, fresh)
    print(f"[cli] one more step on the state in memory and on the restored one: parts "
          f"that differ {diff or 'none'}", flush=True)
    if diff:
        fail(f"a step after the restore differs: {diff[:8]}")

    # SIGTERM after step 2, then path.resume "auto"
    cfg = cli_config(root, "auto", max_iter=1000, val_freq=1000)
    log = os.path.join(root, "auto", "logs", "train.log")
    done = threading.Event()

    def stop_after(marker):
        while not done.is_set():
            try:
                with open(log) as f:
                    if marker in f.read():
                        os.kill(os.getpid(), signal.SIGTERM)
                        return
            except OSError:
                pass
            time.sleep(0.02)

    killer = threading.Thread(target=stop_after, args=(f"step {CLI_STOP_AFTER} ",))
    killer.start()
    try:
        run_cli(cfg, "train", (mixer_for(train_sets, SEED), {}))
    finally:
        done.set()
        killer.join(10)
    auto_dir = os.path.join(root, "auto", "checkpoint")
    stopped = ckpt_lib.latest_step(auto_dir)
    if stopped is None or not CLI_STOP_AFTER <= stopped < 1000:
        fail(f"SIGTERM left checkpoint {stopped}")
    cfg = cli_config(root, "auto", max_iter=stopped + 1, val_freq=1000)
    with open(cfg) as f:
        auto = json.load(f)
    auto["path"]["resume"] = "auto"
    with open(cfg, "w") as f:
        json.dump(auto, f)
    run_cli(cfg, "train", (mixer_for(train_sets, SEED), {}))
    with open(log) as f:
        resumed = f"Auto-resumed from {auto_dir} at step {stopped}" in f.read()
    resumed_to = ckpt_lib.latest_step(auto_dir)
    print(f"[cli] SIGTERM after step {CLI_STOP_AFTER}: checkpoint I{stopped}; the run with "
          f"path.resume 'auto' resumed there: {resumed}, ended at I{resumed_to}", flush=True)
    if not resumed or resumed_to != stopped + 1:
        fail("path.resume 'auto' did not continue from the saved step")

    # -p val on I7 with the EMA weights
    cfg = cli_config(root, "val")
    with open(cfg) as f:
        val = json.load(f)
    val["path"]["resume"] = os.path.join(ckpt_dir, f"I{CLI_MAX_ITER}")
    with open(cfg, "w") as f:
        json.dump(val, f)
    with CliProbe() as probe:
        _, val_state = run_cli(cfg, "val", (None, val_sets))
    ref = {s: sc for s, sc in zip(val_sets, probe.scores)}
    metric_err = cli_val_scores(val_state, val_sets, ref)

    # I7 as a reference .pth and back
    exported = os.path.join(root, f"I{CLI_MAX_ITER}_gen.pth")
    ckpt_lib.export_reference_checkpoint(val_state, exported)
    back = dataclasses.replace(trainer, model=WavBEST(CHANNELS, device=DEV, seed=2))
    back = back.init_state()
    allow = os.environ.get("TMDIFF_ALLOW_FAKE_CLIP")
    os.environ["TMDIFF_ALLOW_FAKE_CLIP"] = "1"  # structural: no fidelity claimed
    try:
        ckpt_lib.import_reference_checkpoint(exported, back)
    finally:
        if allow is None:
            del os.environ["TMDIFF_ALLOW_FAKE_CLIP"]
    same = back.step == CLI_MAX_ITER and all(
        torch.equal(a, b)
        for a, b in zip(back.model.parameters(), val_state.model.parameters()))
    print(f"[cli] I{CLI_MAX_ITER}_gen.pth ({os.path.getsize(exported)} bytes) exported and "
          f"imported back: weights and step bit-identical {same}", flush=True)
    if not same:
        fail("the reference .pth round trip changed the weights")
    return {"launches": n, "s_per_step": s_step, "img_per_s": TRAIN_BATCH / s_step,
            "sec_per_image": sec_per_image, "checkpoint_bytes": saves[-1][2],
            "save_s": [sec for _, sec, _ in saves], "restore_s": restore_s,
            "captures": captures, "replay_k1": replay_k1,
            "score_err_vs_host": metric_err}


# -- samplers ------------------------------------------------------------------

# 3x3x3 convs of one denoise_reuse call: denoise's 52 less the skipped blocks
# (a down stage 4, the middle 2, an up stage 9) at each cache level
REUSE_CONVS = {1: DENOISE_CONVS - 6, 2: DENOISE_CONVS - 15, 3: DENOISE_CONVS - 28}
# a static refresh schedule of 7 refreshes in 20 steps, front-loaded
SAMPLER_MASK = tuple(i in (0, 1, 2, 4, 8, 12, 16) for i in range(20))
TILE, TILE_OVERLAP, TILE_BATCH = 256, 32, 8


@dataclasses.dataclass(frozen=True)
class SamplerRequest:
    label: str
    sensor: str
    bands: int
    batch: int
    size: int
    impl: str
    kwargs: dict
    nfe: int  # denoise calls the request must make
    encodes: int  # encode_condition calls
    # What the image is held against: "plain", the same request through the
    # plain convs; "twin", the plain image of `twin` (the same request under
    # the other lowering); "rows", row i against row i of request rows[i]'s
    # image; "path", nothing of its own: `twin` holds the same solver and
    # cache path against the plain convs.
    hold: str = "plain"
    twin: str = ""  # an earlier request whose batch and seed this one reuses
    rows: tuple = ()
    n_timestep: int = 1000


CFG3, CFG15 = "dpm++_cfg 20 g=3", "dpm++_cfg 20 g=1.5"
DDIM20, CACHED1 = "ddim 20", "ddim_cached 20 r=2 level 1"
ANCESTRAL_SHORT = "ancestral T=100, 10 frames"
SAMPLER_REQUESTS = (
    SamplerRequest("dpm++_noise 20", "WV3", 8, BATCH, SIZE, "banded",
                   dict(method="dpm++_noise", steps=20), 21, 1),
    SamplerRequest(CFG3, "WV3", 8, BATCH, SIZE, "banded",
                   dict(method="dpm++_cfg", guidance=3.0, steps=20), 20, 2),
    SamplerRequest(CFG15, "WV3", 8, BATCH, SIZE, "banded",
                   dict(method="dpm++_cfg", guidance=1.5, steps=20), 20, 2, hold="path",
                   twin=CFG3),
    SamplerRequest("dpm++_cfg 20 g=(3, 1.5)", "WV3", 8, BATCH, SIZE, "banded",
                   dict(method="dpm++_cfg", guidance=np.array([3.0, 1.5], np.float32), steps=20),
                   20, 2,
                   hold="rows", twin=CFG3, rows=(CFG3, CFG15)),
    SamplerRequest("regression", "WV3", 8, BATCH, SIZE, "banded", dict(method="regression"), 1, 1),
    SamplerRequest(DDIM20, "WV3", 8, BATCH, SIZE, "banded", dict(method="ddim", steps=20), 20, 1),
    SamplerRequest("ddim 50", "WV3", 8, BATCH, SIZE, "banded", dict(method="ddim", steps=50), 50, 1,
                   hold="path", twin=DDIM20),
    SamplerRequest(CACHED1, "WV3", 8, BATCH, SIZE, "banded",
                   dict(method="ddim_cached", steps=20, refresh_every=2, cache_level=1), 20, 1),
    SamplerRequest("ddim_cached 20 r=2 level 3", "WV3", 8, BATCH, SIZE, "banded",
                   dict(method="ddim_cached", steps=20, refresh_every=2, cache_level=3), 20, 1),
    SamplerRequest("ddim_cached 20 static mask (7 refreshes) level 1", "WV3", 8, BATCH, SIZE,
                   "banded", dict(method="ddim_cached", steps=20, refresh_mask=SAMPLER_MASK,
                                  refresh_mask_static=True, cache_level=1), 20, 1,
                   hold="path", twin=CACHED1),
    # the ancestral loop is held against the plain convs on a 100-step
    # schedule, and timed on the 1000-step one
    SamplerRequest(ANCESTRAL_SHORT, "QB", 4, 1, 128, "banded",
                   dict(method="ancestral", num_frames=10), 100, 1, n_timestep=100),
    SamplerRequest("ancestral T=1000, 10 frames", "QB", 4, 1, 128, "banded",
                   dict(method="ancestral", num_frames=10), 1000, 1, hold="path",
                   twin=ANCESTRAL_SHORT),
    SamplerRequest("dpm++_cfg 20 g=3 auto", "WV3", 8, BATCH, SIZE, "auto",
                   dict(method="dpm++_cfg", guidance=3.0, steps=20), 20, 2, hold="twin",
                   twin=CFG3),
    SamplerRequest("ddim_cached 20 r=2 level 1 auto", "WV3", 8, BATCH, SIZE, "auto",
                   dict(method="ddim_cached", steps=20, refresh_every=2, cache_level=1), 20, 1,
                   hold="twin", twin=CACHED1),
    SamplerRequest(f"sample_tiled 512x512 ddim 10 (tile {TILE}, overlap {TILE_OVERLAP}, "
                   f"{TILE_BATCH} crops a call)", "QB", 4, 1, 2 * SIZE, "banded",
                   dict(method="ddim", steps=10, tiled=True), 20, 2),
)


def sized_batch(rng, bands, b, size):
    ms = rng.uniform(0.05, 0.95, (b, bands, size, size)).astype(np.float32)
    pan = (ms.mean(1, keepdims=True)
           + 0.05 * rng.standard_normal((b, 1, size, size))).astype(np.float32)
    return {"PAN": pan, "MS": ms}


@contextlib.contextmanager
def recording(modconv, seen):
    """Records the (shape, options) of every call to modconv's K1 and K3
    wrappers in seen["K1"] / seen["K3"] while the block runs."""
    originals = {"K1": modconv.banded_conv3d, "K3": modconv.conv3x3_nhwc}

    def recorder(name):
        def call(x, kernel, *rest, **kw):
            key = (tuple(x.shape), tuple(kernel.shape), tuple(a is not None for a in rest))
            seen[name][key] = seen[name].get(key, 0) + 1
            return originals[name](x, kernel, *rest, **kw)
        return call

    modconv.banded_conv3d, modconv.conv3x3_nhwc = recorder("K1"), recorder("K3")
    try:
        yield seen
    finally:
        modconv.banded_conv3d, modconv.conv3x3_nhwc = originals["K1"], originals["K3"]


def sampler_request(sharp, req, batch, seed):
    kw = dict(req.kwargs)
    if kw.pop("tiled", False):
        return sharp.sample_tiled(batch, sensor=req.sensor, seed=seed, tile=TILE,
                                  overlap=TILE_OVERLAP, tile_batch=TILE_BATCH, **kw)
    return sharp.sample(batch, sensor=req.sensor, seed=seed, **kw)


def hold_shapes(K, K3, seen, gen):
    """Each kernel's wrapper against its plain version at every (shape,
    options) the sampler requests gave it, on random operands: the conv to
    CONV_RTOL of its output's scale. Returns the worst error of each."""
    worst = {"K1": 0.0, "K3": 0.0}
    cases = [("K1", K.banded_conv3d, K.conv3d_plain), ("K3", K3.conv3x3_nhwc,
                                                        K3.conv3x3_nhwc_plain)]
    with torch.no_grad():
        for name, kernel_fn, plain_fn in cases:
            for (xs, ks, flags) in sorted(seen[name]):
                cin, cout = ks[-2], ks[-1]
                taps = int(np.prod(ks[:-2]))
                x = torch.randn(xs, device=DEV, generator=gen)
                k = torch.randn(ks, device=DEV, generator=gen) / (taps * cin) ** 0.5
                opts = [1.0 + 0.5 * torch.randn(xs[0], cin, device=DEV, generator=gen),
                        torch.randn(cout, device=DEV, generator=gen),
                        torch.randn(xs[:-1] + (cout,), device=DEV, generator=gen)]
                args = [o if f else None for o, f in zip(opts, flags)]
                got = kernel_fn(x, k, *[a.clone() if a is not None and a.dim() > 2 else a
                                        for a in args])
                ref = plain_fn(x, k, *[a.clone() if a is not None and a.dim() > 2 else a
                                       for a in args])
                err = rel_to_scale(got, ref)
                worst[name] = max(worst[name], err)
                if not err <= CONV_RTOL:
                    fail(f"{name} at {xs} x {ks} {flags}: {err} of its scale")
    print(f"[samplers] K1 held against its plain version at {len(seen['K1'])} (shape, "
          f"options) of the sampler requests, worst {worst['K1']:.3g} of scale; K3 at "
          f"{len(seen['K3'])}, worst {worst['K3']:.3g} (rtol {CONV_RTOL})", flush=True)
    return worst


def held_against(req, outs, images, plains):
    """The reference images `req` is held against (see SamplerRequest.hold)
    and what they are, or (None, what holds its path)."""
    if req.hold == "plain":
        return plains[req.label], "the plain convs"
    if req.hold == "twin":
        return plains[req.twin], f"the plain convs' {req.twin!r}"
    if req.hold == "rows":
        rows = [images[label][0][i] for i, label in enumerate(req.rows)]
        return (np.stack(rows),) + outs[1:], "rows of " + " / ".join(repr(r) for r in req.rows)
    return None, f"its path held by {req.twin!r}"


def samplers_phase(model, K, K3, K4, modconv, seed):
    """The main path of this slice: every sampler of the Pansharpener at
    full width through its "banded" (K1) or "auto" (K1 and K3) model, each
    request with the counts reset just before and read just after, its
    denoise calls counted, its image (and frames) against the reference that
    its `hold` names, at SAMPLE_ATOL; then each wrapper against its plain
    version at every shape the requests gave it."""
    from tmdiff_tpu_torch.pipeline import Pansharpener

    sharps = {}
    rng = np.random.default_rng(seed + 100)
    seen = {"K1": {}, "K3": {}}
    results, images, plains, inputs = {}, {}, {}, {}
    for i, req in enumerate(SAMPLER_REQUESTS):
        if req.n_timestep not in sharps:
            sharps[req.n_timestep] = Pansharpener(model, device=DEV, n_timestep=req.n_timestep)
        sharp = sharps[req.n_timestep]
        batch, req_seed = inputs[req.twin] if req.twin else (
            sized_batch(rng, req.bands, req.batch, req.size), seed + i)
        inputs[req.label] = (batch, req_seed)
        model.use_conv_impl(req.impl)
        plain, plain_sec = None, None
        try:
            with DenoiseCounter(model) as nfe:
                with recording(modconv, seen):
                    reset_counts(K, K3, K4)
                    t0 = time.perf_counter()
                    out = sampler_request(sharp, req, batch, req_seed)
                    sec = time.perf_counter() - t0
                v1, v3 = dict(K.variant_launches), dict(K3.variant_launches)
                n4, calls, reuse = K4.launches, nfe.calls, nfe.reuse_calls
            if req.hold == "plain":
                model.use_plain_conv(True)
                try:
                    t0 = time.perf_counter()
                    plain = sampler_request(sharp, req, batch, req_seed)
                    plain_sec = time.perf_counter() - t0
                finally:
                    model.use_plain_conv(False)
        finally:
            model.use_conv_impl("banded")
        outs = out if isinstance(out, tuple) else (out,)
        images[req.label] = outs
        if plain is not None:
            plains[req.label] = plain if isinstance(plain, tuple) else (plain,)
        refs, against = held_against(req, outs, images, plains)
        err = None if refs is None else max(float(np.abs(a - b).max())
                                            for a, b in zip(outs, refs))
        ok = (outs[0].shape == batch["MS"].shape and all(
            bool(np.isfinite(a).all()) and a.min() >= 0.0 and a.max() <= 1.0 for a in outs))
        if len(outs) == 2:  # ancestral frames
            ok = ok and outs[1].shape[1:] == batch["MS"].shape and outs[1].shape[0] == 10
        k1, k3 = sum(v1.values()), sum(v3.values())
        level = req.kwargs.get("cache_level", 1)
        expected = (ENCODE_CONVS * req.encodes + DENOISE_CONVS * (calls - reuse)
                    + REUSE_CONVS[level] * reuse)
        held = (f"plain convs {plain_sec:.3f} s, " if plain_sec is not None else "") + (
            f"max abs err vs {against} {err:.3g} (atol {SAMPLE_ATOL})" if err is not None
            else f"not held on its own: {against}")
        print(f"[samplers] {req.label}: {req.sensor} {req.bands}-band batch {req.batch} "
              f"{req.size}x{req.size} ({req.impl}): {sec:.3f} s, NFE {calls} ({reuse} on a "
              f"cached trunk), {calls / sec:.2f} NFE/s; K1 launches {k1} {v1}, K3 launches "
              f"{k3} {v3} (expected {expected} in all); {held}; finite and in [0, 1]: {ok}",
              flush=True)
        if not ok or calls != req.nfe or k1 + k3 != expected or n4:
            fail(f"{req.label}: ok={ok} nfe={calls} launches={k1}+{k3}+{n4}")
        if v1["ffma"] or v3["ffma"] or (k3 == 0) == (req.impl == "auto"):
            fail(f"{req.label}: launches by variant K1 {v1} K3 {v3} under {req.impl!r}")
        if err is not None and not err <= SAMPLE_ATOL:
            fail(f"{req.label} differs from {against} by {err}")
        results[req.label] = {"s": sec, "nfe": calls, "nfe_per_s": calls / sec,
                              "k1_launches": k1, "k3_launches": k3, "k1_variants": v1,
                              "k3_variants": v3, "plain_s": plain_sec, "held_against": against,
                              "max_abs_err": err}
    cached, plain20 = results[CACHED1], results[DDIM20]
    level3 = results["ddim_cached 20 r=2 level 3"]
    print(f"[samplers] ddim_cached 20 r=2 (levels 1 / 3) {cached['s']:.3f} / "
          f"{level3['s']:.3f} s against ddim 20 {plain20['s']:.3f} s: "
          f"{plain20['s'] / cached['s']:.3f}x / {plain20['s'] / level3['s']:.3f}x; K1 launches "
          f"{cached['k1_launches']} / {level3['k1_launches']} against "
          f"{plain20['k1_launches']}", flush=True)
    worst = hold_shapes(K, K3, seen, torch.Generator(device=DEV).manual_seed(seed))
    return results, worst


# -- distillation ----------------------------------------------------------------

DISTILL_PHASES, DISTILL_STEPS = (10, 5), 6
# the x0 target passes two teacher calls and the one-jump solve, which
# divides by alpha_t'' - (sigma_t'' / sigma_t) alpha_t, 0.155 at t = 1000 of
# N = 10: (prediction - target) through K1 against the plain convs
DISTILL_DIFF_ATOL = 1e-4


def distill_grads_phase(K, root, gen):
    """The distillation loss (N = 10, SNR weight) and every gradient through
    K1 against the plain convs from the CLI phase's I7 checkpoint (teacher:
    its EMA weights; the student starts as the teacher), fixed i and noise,
    dropout off, both backward passes taking the plain path's L1 signs, as
    the train phase does: (prediction - target) agrees to DISTILL_DIFF_ATOL
    and every element of another sign lies within that difference of zero."""
    from tmdiff_tpu_torch.train import checkpoint as ckpt_lib
    from tmdiff_tpu_torch.train.distill import DistillTrainer

    new_model, new_trainer, prompts, datasets = train_setup()
    model = new_model()
    trainer = new_trainer(model)
    state = trainer.init_state()
    ckpt_lib.restore_checkpoint(os.path.join(root, "train", "checkpoint"), state,
                                step=CLI_MAX_ITER)
    names = [n for n, _ in model.named_parameters()]
    teacher = {n: e.detach().clone() for n, e in zip(names, state.ema_params)}
    model.load_state_dict(teacher)
    n_steps = DISTILL_PHASES[0]
    d_trainer = DistillTrainer(model, trainer.schedule, n_student_steps=n_steps)
    params = dict(model.named_parameters())
    worst_all = 0.0
    for sensor in ("WV3", "QB"):
        batch, _, noise = device_batch(datasets[sensor], gen)
        i = torch.randint(1, n_steps + 1, (TRAIN_BATCH,), generator=gen, device=DEV)
        out = {}
        for plain in (True, False):
            model.use_plain_conv(plain)
            K.reset_launches()
            x_t, t, target, w = d_trainer.teacher_target(batch, prompts[sensor], teacher, i, noise)
            diff = model(x_t, t, batch["PAN"], batch["MS"], prompts[sensor]) - target
            if plain:
                sign = torch.sign(diff.detach())
            held = torch.mean(w * diff * sign)
            grads = torch.autograd.grad(held, list(params.values()), retain_graph=True)
            launches = (K.launches, K.input_grad_launches, K.weight_grad_calls)
            own = torch.autograd.grad(torch.mean(w * diff.abs()), list(params.values()))
            out[plain] = (torch.mean(w * diff.detach().abs()), grads, own, launches, diff.detach())
        model.use_plain_conv(False)
        (lk, gk, ok, (n_k, n_in, n_w), dk), (lp, gp, op, (n_p, _, _), dp) = out[False], out[True]
        loss_rel = abs(lk.item() - lp.item()) / abs(lp.item())
        errs = {name: rel_to_scale(a, b) for name, a, b in zip(params, gk, gp)}
        own_errs = {name: rel_to_scale(a, b) for name, a, b in zip(params, ok, op)}
        worst, own_worst = max(errs, key=errs.get), max(own_errs, key=own_errs.get)
        worst_all = max(worst_all, errs[worst])
        over = {n: e for n, e in errs.items() if e > GRAD_RTOL}
        flips = torch.sign(dk) != sign
        diff_err = (dk - dp).abs().max().item()
        flip_margin = dp.abs()[flips].max().item() if flips.any() else 0.0
        print(f"[distill] gradients {sensor} {batch['MS'].shape[1]}-band batch {TRAIN_BATCH} "
              f"{TRAIN_SIZE}x{TRAIN_SIZE}, N={n_steps}, i={i.tolist()}, fixed noise, dropout "
              f"off: loss K1 {lk.item():.7f} plain {lp.item():.7f} (rel {loss_rel:.3g}, rtol "
              f"{GRAD_LOSS_RTOL}); with the plain path's signs, worst gradient {worst} at "
              f"{errs[worst]:.3g} of its scale, {len(errs) - len(over)} of {len(errs)} within "
              f"{GRAD_RTOL}; K1 launches {n_k} ({n_k - n_in} forward: two teacher calls and the "
              f"student's; {n_in} input gradient), {n_w} weight gradients; plain path {n_p}",
              flush=True)
        print(f"[distill]   with each path's own signs: worst gradient {own_worst} at "
              f"{own_errs[own_worst]:.3g} of its scale; {int(flips.sum())} of {flips.numel()} "
              f"elements take another sign through K1, at |pred - target| <= {flip_margin:.3g}; "
              f"(pred - target) K1 vs plain {diff_err:.3g} (atol {DISTILL_DIFF_ATOL})",
              flush=True)
        if not loss_rel <= GRAD_LOSS_RTOL or over:
            fail(f"{sensor} distillation gradients differ from the plain path: {sorted(over)}")
        if not (diff_err <= DISTILL_DIFF_ATOL and flip_margin <= diff_err):
            fail(f"{sensor} distillation: (pred - target) K1 vs plain {diff_err}, an element of "
                 f"another sign at {flip_margin}")
        if (n_k - n_in, n_in, n_w, n_p) != (3 * TRAIN_CONVS, TRAIN_CONVS, TRAIN_CONVS, 0):
            fail(f"{sensor} distillation gradient pass: launches {n_k - n_in}/{n_in}/{n_w}/{n_p}")
    return worst_all


def distill_phase(K, K3, K4, root):
    """`-p distill` through the CLI's `_run` from the cli phase's I7
    checkpoint: phases N = 10 and 5 of DISTILL_STEPS steps on the train
    phase's batches (4:4:8 mixer, batch 8, 64x64), each student validated
    with ddim at N steps on the cli phase's scenes; counts reset just
    before and read just after. Then the checkpoints, the student in both
    weight slots, and the gradient check above."""
    from tmdiff_tpu_torch.train import checkpoint as ckpt_lib

    _, _, _, train_sets = train_setup()
    val_sets = cli_val_sets()
    cfg = cli_config(root, "distill")
    with open(cfg) as f:
        opt = json.load(f)
    opt["path"]["resume"] = os.path.join(root, "train", "checkpoint", f"I{CLI_MAX_ITER}")
    opt["train"]["distill"] = {"phases": list(DISTILL_PHASES), "steps_per_phase": DISTILL_STEPS,
                               "lr": 1e-4}
    with open(cfg, "w") as f:
        json.dump(opt, f)
    with CliProbe() as probe:
        reset_counts(K, K3, K4)
        t0 = time.perf_counter()
        run_cli(cfg, "distill", (mixer_for(train_sets, SEED), val_sets))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n = counts(K, K3, K4)
    steps = len(DISTILL_PHASES) * DISTILL_STEPS
    ends = probe.step_ends
    # intervals that end at a replay within a phase, not across a phase's
    # checkpoint and validation
    replays = set(probe.replays(2))
    loop = [b - a for j, (a, b) in enumerate(zip(ends, ends[1:]), 1)
            if j % DISTILL_STEPS and j + 1 in replays]
    s_step = float(np.median(loop))
    val_convs = sum(len(val_sets) * (ENCODE_CONVS + DENOISE_CONVS * m) for m in DISTILL_PHASES)
    # the host counts a captured step's launches at its eager step and its
    # capture; a replay's are read on the card
    captures = probe.captures((4 * TRAIN_CONVS, TRAIN_CONVS, TRAIN_CONVS))
    expected = {"k1_forward": 2 * captures * 4 * TRAIN_CONVS + val_convs,
                "k1_input_grad": 2 * captures * TRAIN_CONVS,
                "weight_grad": 2 * captures * TRAIN_CONVS,
                "weight_grad_kernel": 2 * captures * TRAIN_CONVS,
                "k1_off_tensor_cores": 0, "k3": 0, "k4": 0}
    ckpt_root = os.path.join(root, "distill", "checkpoint")
    kept = sorted(os.path.relpath(os.path.join(d, s), ckpt_root)
                  for d, subs, _ in os.walk(ckpt_root) for s in subs if s.startswith("I"))
    both_slots = []
    for m in DISTILL_PHASES:
        sd = torch.load(os.path.join(ckpt_root, f"distill_N{m}", f"I{DISTILL_STEPS}",
                                     ckpt_lib.STATE_FILE), map_location=DEV, weights_only=True)
        both_slots.append(all(torch.equal(e, v) for e, v in zip(sd["ema_params"],
                                                                 sd["model"].values())))
    scores = probe.scores
    print(f"[distill] -p distill from I{CLI_MAX_ITER}: phases {list(DISTILL_PHASES)} of "
          f"{DISTILL_STEPS} steps, batch {TRAIN_BATCH} {TRAIN_SIZE}x{TRAIN_SIZE}: {wall:.2f} s "
          f"in all; median {s_step:.4f} s/step ({TRAIN_BATCH / s_step:.1f} img/s) over "
          f"{len(loop)} replays; compiled_step: {captures} captures (one a phase and band "
          f"count), {steps - captures} replays, a replay ran {probe.replay_k1} K1 kernels on "
          f"the card ({5 * TRAIN_CONVS} a step); host-counted launches {n} (expected "
          f"{expected}); checkpoints {kept}; the "
          f"student in both weight slots {both_slots}; ddim validations {len(scores)}, last "
          f"{scores[-len(val_sets):]}", flush=True)
    if n != expected or probe.replay_k1 != 5 * TRAIN_CONVS or len(probe.host_launches) != steps:
        fail(f"the distill run launched {n}; a replay ran {probe.replay_k1} K1 kernels")
    if kept != sorted(f"distill_N{m}/I{DISTILL_STEPS}" for m in DISTILL_PHASES):
        fail(f"distill checkpoints {kept}")
    if not all(both_slots) or len(scores) != len(DISTILL_PHASES) * len(val_sets) or not all(
            np.isfinite(v) for sc in scores for v in sc.values()):
        fail(f"distill students or validation scores: {both_slots} {scores}")
    grad_err = distill_grads_phase(K, root, torch.Generator(device=DEV).manual_seed(SEED))
    return {"launches": n, "s_per_step": s_step, "img_per_s": TRAIN_BATCH / s_step,
            "grad_err": grad_err, "captures": captures, "replay_k1": probe.replay_k1}


CONTROL_TASK = "control_canny"
CONTROL_STEPS = 20  # ddim steps of the controlled request
CONTROL_LR = 1e-4
# K1 launches of one call of the full-width legacy models (a concat part a
# launch): LegacyUNet = 2 heads + 6 strided stages x 2 + middle 2 + 3 up
# stages x (3 parts + 1) + final (3 parts + 1 + 2) = 34; the control branch
# adds its head, 3 strided stages and middle = 9
LEGACY_CONVS, CONTROL_CONVS = 34, 9
LEGACY_LIBRARY = {"strided": 6, "transposed": 3, "hint": 0}
CONTROL_LIBRARY = {"strided": 3, "transposed": 0, "hint": 7}


def controlnet_inputs(gen, bands=8, batch=BATCH):
    """The legacy models' inputs at batch x SIZE x SIZE: x_t, t, pan, ms,
    the WV3 prompt, a 3-channel hint and the task feature."""
    from tmdiff_tpu_torch.models.clip_text import load_prompt_table
    from tmdiff_tpu_torch.models.controlnet import task_feature

    table, index, _ = load_prompt_table()
    shape = (batch, bands, SIZE, SIZE)
    ms = torch.rand(shape, device=DEV, generator=gen)
    inputs = {"x_t": torch.randn(shape, device=DEV, generator=gen),
              "t": torch.linspace(250.0, 750.0, batch, device=DEV),
              "pan": ms.mean(1, keepdim=True)
              + 0.05 * torch.randn((batch, 1, SIZE, SIZE), device=DEV, generator=gen),
              "ms": ms, "prompt_emb": torch.as_tensor(table[index["WV3"]], device=DEV)}
    hint = torch.rand((batch, SIZE, SIZE, 3), device=DEV, generator=gen)
    return inputs, hint, task_feature(CONTROL_TASK)


def live_controlnet(base, gen):
    """A ControlledLegacyUNet on `base`'s weights after the init recipe, its
    zero convs (taps and hint path) drawn off zero from `gen`: the state of
    a trained adapter."""
    from tmdiff_tpu_torch.models.controlnet import (ControlledLegacyUNet,
                                                    init_control_from_base,
                                                    inject_base_params)

    model = init_control_from_base(inject_base_params(
        ControlledLegacyUNet(CHANNELS, device=DEV, seed=SEED + 1), base))
    zero_conv = re.compile(r"control\.(zero\d|hint\.zeroconv\d)\.weight$")
    with torch.no_grad():
        for name, p in model.named_parameters():
            if zero_conv.match(name):
                p.copy_(0.05 * torch.randn(p.shape, device=DEV, generator=gen))
    return model


def recorded_convs(K, lib, fn):
    """fn()'s result and the K1 launches (x, kernel, style, bias, out, pre:
    the launch's pre-activation keywords, {} for none) and library convs
    (kind, x, weight, bias) it made, as tensors kept for timing."""
    k1, convs = [], []
    launch, conv = K._launch, lib._Conv

    def record_launch(x, kernel, style, bias, out, input_grad=False, unsharded=None, **pre):
        k1.append((x, kernel, style, bias, None if out is None else out.clone(), pre))
        return launch(x, kernel, style, bias, out, input_grad, unsharded, **pre)

    class Recorded(conv):
        @staticmethod
        def forward(ctx, x, weight, kind):
            convs.append((kind, x, weight))
            return conv.forward(ctx, x, weight, kind)

    K._launch, lib._Conv = record_launch, Recorded
    try:
        return fn(), k1, convs
    finally:
        K._launch, lib._Conv = launch, conv


def controlnet_times(K, lib, k1, convs):
    """The summed device ms of the recorded K1 launches (kernel and plain
    version) and library convs, each call timed alone with events."""
    with torch.no_grad():
        ms = sum(cuda_ms(lambda a=a: K._launch(*a[:5], **a[5]), 3) for a in k1)
        plain_ms = sum(cuda_ms(lambda a=a: K.conv3d_plain(*a[:4], None, **a[5]), 1) for a in k1)
        by_kind = {}
        for kind, x, w in convs:
            by_kind[kind] = by_kind.get(kind, 0.0) + cuda_ms(lambda: lib._Conv.apply(x, w, kind), 3)
    return ms, plain_ms, by_kind


def controlnet_phase(K, modconv, gen):
    """The legacy UNet and the ControlNet adapter (models/legacy_unet.py,
    models/controlnet.py) at their defaults (channels 32, 64, 128, 256,
    embed 128, inter 32), 8 bands, batch BATCH, SIZE x SIZE: a LegacyUNet
    forward and a live ControlledLegacyUNet forward through K1 against the
    plain convs (FORWARD_ATOL), launches and library convs counted (counts
    reset just before and read just after), every launch on the tensor
    cores; the controlled model as a CONTROL_STEPS-step ddim request
    against the plain convs (SAMPLE_ATOL); one fine-tune step (sd_locked:
    the control branch trains) with every trainable gradient through K1
    within GRAD_RTOL of the plain path's (its L1 signs), no gradient on the
    base encoder and the frozen weights unchanged by the Adam step; the K1
    and library convs of the controlled forward timed call by call."""
    from tmdiff_tpu_torch.diffusion import gaussian
    from tmdiff_tpu_torch.diffusion.schedules import NoiseSchedule
    from tmdiff_tpu_torch.models.controlnet import (TASKS_TO_ID, trainable_labels,
                                                    trainable_parameters)
    from tmdiff_tpu_torch.models.legacy_unet import LegacyUNet
    from tmdiff_tpu_torch.ops import library_conv as lib

    task_id = TASKS_TO_ID[CONTROL_TASK]
    base = LegacyUNet(CHANNELS, device=DEV, seed=SEED)
    model = live_controlnet(base, gen)
    batch, hint, feat = controlnet_inputs(gen)
    control = dict(hint=hint, task_id=task_id, task_feat=feat)
    result = {}
    for label, net, kw, convs, library in (
            ("LegacyUNet", base, {}, LEGACY_CONVS, LEGACY_LIBRARY),
            ("ControlledLegacyUNet", model, control, LEGACY_CONVS + CONTROL_CONVS,
             {k: LEGACY_LIBRARY[k] + CONTROL_LIBRARY[k] for k in LEGACY_LIBRARY})):
        outs = {}
        for plain in (True, False):
            net.use_plain_conv(plain)
            with torch.no_grad():
                net(**batch, **kw)  # warm-up
                torch.cuda.synchronize()
                K.reset_launches()
                lib.reset_calls()
                t0 = time.perf_counter()
                outs[plain] = net(**batch, **kw)
                torch.cuda.synchronize()
                sec = time.perf_counter() - t0
            counted = (K.launches, K.variant_launches["ffma"], dict(lib.calls))
            outs[(plain, "s")], outs[(plain, "n")] = sec, counted
        net.use_plain_conv(False)
        err = (outs[False] - outs[True]).abs().max().item()
        print(f"[controlnet] {label} forward, 8-band batch {BATCH} {SIZE}x{SIZE}: K1 "
              f"{outs[(False, 's')] * 1e3:.2f} ms, plain convs {outs[(True, 's')] * 1e3:.2f} "
              f"ms; max abs err {err:.3g} (atol {FORWARD_ATOL}); K1 launches / off the tensor "
              f"cores / library convs {outs[(False, 'n')]} (expected {convs} / 0 / {library}); "
              f"plain path {outs[(True, 'n')]}", flush=True)
        if not err <= FORWARD_ATOL:
            fail(f"{label} forward through K1 differs from the plain convs by {err}")
        if outs[(False, "n")] != (convs, 0, library) or outs[(True, "n")][0]:
            fail(f"{label} forward launches {outs[(False, 'n')]}, plain {outs[(True, 'n')]}")
        result[label] = {"s": outs[(False, "s")], "plain_s": outs[(True, "s")],
                         "max_abs_err": err, "k1": convs}

    # the controlled model as a ddim request's denoiser
    ns = NoiseSchedule.create("cosine", 1000).to(DEV)
    shape = tuple(batch["x_t"].shape)
    x_T = torch.randn(shape, device=DEV, generator=gen)
    imgs = {}
    for plain in (True, False):
        model.use_plain_conv(plain)
        denoise = lambda x, t, pan, ms: model(x, t, pan, ms, batch["prompt_emb"], **control)
        with torch.no_grad():
            torch.cuda.synchronize()
            K.reset_launches()
            lib.reset_calls()
            t0 = time.perf_counter()
            imgs[plain] = gaussian.ddim_sample(denoise, ns, None, batch["pan"], batch["ms"],
                                               shape, steps=CONTROL_STEPS, x_init=x_T)
            torch.cuda.synchronize()
            imgs[(plain, "s")] = time.perf_counter() - t0
            imgs[(plain, "n")] = (K.launches, K.variant_launches["ffma"], sum(lib.calls.values()))
    model.use_plain_conv(False)
    gap = (imgs[False] - imgs[True]).abs().max().item()
    want = (CONTROL_STEPS * (LEGACY_CONVS + CONTROL_CONVS), 0,
            CONTROL_STEPS * (sum(LEGACY_LIBRARY.values()) + sum(CONTROL_LIBRARY.values())))
    print(f"[controlnet] ddim {CONTROL_STEPS} steps with the controlled model ({CONTROL_TASK} "
          f"hint), 8-band batch {BATCH} {SIZE}x{SIZE}: {imgs[(False, 's')]:.3f} s "
          f"({CONTROL_STEPS / imgs[(False, 's')]:.1f} NFE/s), plain convs "
          f"{imgs[(True, 's')]:.3f} s; max abs gap {gap:.3g} (atol {SAMPLE_ATOL}); K1 "
          f"launches / off the tensor cores / library convs {imgs[(False, 'n')]} (expected "
          f"{want})", flush=True)
    if not (gap <= SAMPLE_ATOL and torch.isfinite(imgs[False]).all()):
        fail(f"controlled ddim request differs from the plain convs by {gap}")
    if imgs[(False, "n")] != want:
        fail(f"controlled ddim request launches {imgs[(False, 'n')]}")
    result["ddim"] = {"s": imgs[(False, "s")], "plain_s": imgs[(True, "s")], "gap": gap,
                      "k1": want[0]}

    # one fine-tune step, sd_locked: gradients through K1 against the plain convs
    labels = trainable_labels(model, sd_locked=True)
    names = [n for n, _ in model.named_parameters()]
    params = [p for _, p in model.named_parameters()]
    target = torch.randn(shape, device=DEV, generator=gen)
    grads = {}
    for plain in (True, False):
        model.use_plain_conv(plain)
        torch.cuda.synchronize()
        K.reset_launches()
        t0 = time.perf_counter()
        pred = model(**batch, **control)
        if plain:
            sign = torch.sign(pred.detach() - target)
            pred_plain = pred.detach()
        held = torch.mean((pred - target) * sign)
        grads[plain] = dict(zip(names, torch.autograd.grad(held, params, allow_unused=True)))
        torch.cuda.synchronize()
        grads[(plain, "s")] = time.perf_counter() - t0
        grads[(plain, "n")] = (K.launches - K.input_grad_launches, K.input_grad_launches,
                               K.weight_grad_calls)
        if not plain:
            forward = (pred.detach() - pred_plain).abs().max().item()
    model.use_plain_conv(False)
    trained = [n for n in names if labels[n] == "train" and grads[True][n] is not None]
    errs = {n: rel_to_scale(grads[False][n], grads[True][n]) for n in trained}
    worst = max(errs, key=errs.get)
    encoder = [n for n in names if n.split(".")[0] in ("embed", "embed2", "conv1", "conv2",
                                                       "down1", "down2", "down3", "down1_1",
                                                       "down2_1", "down3_1", "middle1")]
    leaked = [n for n in encoder if grads[False][n] is not None
              and grads[False][n].abs().max().item() != 0.0]
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    opt = torch.optim.Adam(trainable_parameters(model, labels), lr=CONTROL_LR)
    for n, p in model.named_parameters():
        p.grad = grads[False][n]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    opt.step()
    torch.cuda.synchronize()
    step_s = grads[(False, "s")] + time.perf_counter() - t0
    moved = [n for n, p in model.named_parameters()
             if labels[n] == "freeze" and not torch.equal(p, before[n])]
    changed = sum(not torch.equal(p, before[n]) for n, p in model.named_parameters())
    print(f"[controlnet] fine-tune step (sd_locked, Adam lr {CONTROL_LR}), 8-band batch "
          f"{BATCH} {SIZE}x{SIZE}, L1 with the plain path's signs: {step_s:.3f} s (forward "
          f"and backward through K1 {grads[(False, 's')]:.3f} s, plain "
          f"{grads[(True, 's')]:.3f} s); {len(trained)} trainable gradients, worst {worst} at "
          f"{errs[worst]:.3g} of its scale (bar {GRAD_RTOL}); x0 prediction K1 vs plain "
          f"{forward:.3g}; base-encoder gradients nonzero: {leaked}; K1 launches (forward, "
          f"input gradient, weight gradients) {grads[(False, 'n')]}, plain path "
          f"{grads[(True, 'n')]}; {changed} parameters moved by the step, frozen ones moved: "
          f"{moved}", flush=True)
    if errs[worst] > GRAD_RTOL or leaked or moved or not changed:
        fail(f"controlnet fine-tune step: worst gradient {errs[worst]}, leaked {leaked}, "
             f"frozen moved {moved}")
    if grads[(True, "n")][0] or not all(grads[(False, "n")]):
        fail(f"controlnet fine-tune launches {grads[(False, 'n')]}, plain {grads[(True, 'n')]}")
    result["step"] = {"s": step_s, "grad_s": grads[(False, "s")],
                      "plain_grad_s": grads[(True, "s")], "grad_err": errs[worst],
                      "launches": grads[(False, "n")]}

    # the controlled forward's convs timed call by call
    with torch.no_grad():
        _, k1, convs = recorded_convs(K, lib, lambda: model(**batch, **control))
    k1_ms, k1_plain_ms, lib_ms = controlnet_times(K, lib, k1, convs)
    print(f"[controlnet] the controlled forward's convs, each call timed alone (events): K1 "
          f"{len(k1)} launches {k1_ms:.3f} ms (plain version {k1_plain_ms:.3f} ms); library "
          f"convs {len(convs)} calls {sum(lib_ms.values()):.3f} ms, by kind "
          f"{ {k: round(v, 3) for k, v in lib_ms.items()} }", flush=True)
    result["forward_convs"] = {"k1_ms": k1_ms, "k1_plain_ms": k1_plain_ms,
                               "library_ms": lib_ms, "k1_launches": len(k1),
                               "library_calls": len(convs)}
    result["bf16"] = controlnet_bf16_phase(K, modconv, gen, base, model)
    return result


# The JAX package's flagship legacy geometry (benchmarks/controlnet_bench.py:
# channels 32-256, 8 bands, 256x256, batch 8, bf16) and its three variants
CONTROL_BF16_BATCH, CONTROL_BF16_REPS = 8, 3
CONTROL_BF16_RTOL = 1e-2  # a bf16 forward or request against the plain bf16 convs, of scale
# cuDNN's bf16 weight gradient drifts from one rounding of the fp32 sums as
# the sum over positions lengthens: at the training shapes (2^18 positions)
# it stays within one bf16 step plus 1e-4 of scale, at the legacy forward's
# (2^22 at batch 8) a near-zero element lay 6.6e-4 of scale beyond one step
# (NVIDIA H100 80GB HBM3, 700 W). Held here to one bf16 step of the scale,
# the excess printed.
BF16_WEIGHT_GRAD_RTOL = 2.0 ** -8


def legacy_k1_bf16_shapes(K, k1):
    """Each recorded bf16 K1 launch (x, kernel, style, bias, out, pre) of a
    legacy forward, its pre-activation included, against its plain bf16
    version element by element (bf16_check), timed beside the plain
    version, the bf16 library conv (F.conv3d, cuDNN benchmark mode) and the
    bf16 bound; and the bf16 weight gradient of its operand bf16(a s) (a the
    activated x) with a random dy against fp32 sums of the same
    operands (beyond one bf16 step: BF16_WEIGHT_GRAD_RTOL of scale). Returns
    the sums, the largest error and the weight gradient's largest excess."""
    tot = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0, "ops_s": 0.0,
           "bytes_s": 0.0, "max_abs_err": 0.0, "weight_grad_excess_of_scale": 0.0,
           "weight_grad_over_1e-4": 0}
    shapes = set()
    gen = torch.Generator(device=DEV).manual_seed(SEED)
    with torch.no_grad():
        for x, k, st, bi, out, pre in k1:
            fresh = lambda: None if out is None else out.clone()
            b, d, h, w, cin = x.shape
            cout = k.shape[-1]
            shapes.add((h, w, cin, cout, out is not None))
            got, variant = launched_variant(K, lambda: K._launch(x, k, st, bi, fresh(), **pre))
            if variant not in BF16_VARIANTS:
                fail(f"legacy bf16 conv {tuple(x.shape)} -> {cout} took {variant}")
            tot["max_abs_err"] = max(tot["max_abs_err"], bf16_check(
                got, K.conv3d_plain(x, k, st, bi, fresh(), **pre),
                f"legacy bf16 conv {tuple(x.shape)} {sorted(pre)}",
                BF16_PREACT_RTOL if pre else BF16_CONV_RTOL))
            acc = fresh()
            tot["ms"] += cuda_ms(lambda: K._launch(x, k, st, bi, acc, **pre), 3)
            tot["plain_ms"] += cuda_ms(lambda: K.conv3d_plain(x, k, st, bi, acc, **pre), 1)
            xa = K.preact(x, **pre)
            xs = xa if st is None else xa * st.view(b, 1, 1, 1, cin)
            dy = torch.randn(got.shape, device=DEV, generator=gen).bfloat16()
            dw32 = K.conv3d_weight_grad(xs.float(), dy.float())
            excess = ((K.conv3d_weight_grad(xs, dy).float() - dw32).abs()
                      - 2 * bf16_half_step(dw32)).clamp(min=0) / dw32.abs().max()
            tot["weight_grad_excess_of_scale"] = max(tot["weight_grad_excess_of_scale"],
                                                     excess.max().item())
            tot["weight_grad_over_1e-4"] += int((excess > 1e-4).sum())
            if excess.max().item() > BF16_WEIGHT_GRAD_RTOL:
                fail(f"legacy bf16 weight gradient {tuple(x.shape)} -> {cout}: "
                     f"{excess.max().item()} of scale beyond one bf16 step")
            wl = k.permute(4, 3, 0, 1, 2).contiguous()
            tot["library_ms"] += library_ms(
                lambda: F.conv3d(xs.permute(0, 4, 1, 2, 3), wl, bi, padding=1), 3)
            bnd, by = conv_bound(b, d, h, w, cin, cout, st is not None, bi is not None,
                                 out is not None, PEAK_BF16_FLOPS, 2)
            tot["bound_ms"] += bnd
            tot["ops_s" if by == "operations" else "bytes_s"] += bnd
    tot["bound_by"] = "operations" if tot["ops_s"] >= tot["bytes_s"] else "bytes"
    tot["shapes"] = sorted(shapes)
    return tot


def controlnet_bf16_phase(K, modconv, gen, base32, model32):
    """The legacy models in bf16 on the fp32 phase's weights: LegacyUNet,
    the live ControlledLegacyUNet and its only_mid_control twin at the JAX
    package's flagship legacy geometry (batch CONTROL_BF16_BATCH): forward
    ms and img/s (CONTROL_BF16_REPS after a warm-up; controlled_over_base
    and mid_only_over_base as controlnet_bench.py prints them), each
    against the same model through the plain bf16 convs
    (CONTROL_BF16_RTOL of scale), only bf16 K1 launches, library convs by
    kind; every K1 launch of the controlled forward against its plain
    version element by element; a CONTROL_STEPS-step controlled ddim at
    batch BATCH against the plain bf16 convs; one sd_locked fine-tune step
    at batch BATCH held as the bf16 training step is (bf16_grads_check
    against the fp32 model), no base-encoder gradient, the frozen weights
    unchanged by the Adam step."""
    from tmdiff_tpu_torch.diffusion import gaussian
    from tmdiff_tpu_torch.diffusion.schedules import NoiseSchedule
    from tmdiff_tpu_torch.models.controlnet import (TASKS_TO_ID, ControlledLegacyUNet,
                                                    trainable_labels, trainable_parameters)
    from tmdiff_tpu_torch.models.legacy_unet import LegacyUNet
    from tmdiff_tpu_torch.ops import library_conv as lib

    bf16 = torch.bfloat16
    base = LegacyUNet(CHANNELS, device=DEV, seed=SEED, dtype=bf16)
    base.load_state_dict(base32.state_dict())
    models = {}
    for label, mid in (("controlled", False), ("mid_only", True)):
        models[label] = ControlledLegacyUNet(CHANNELS, device=DEV, seed=SEED + 1, dtype=bf16,
                                             only_mid_control=mid)
        models[label].load_state_dict(model32.state_dict())
    task_id = TASKS_TO_ID[CONTROL_TASK]
    inputs, hint, feat = controlnet_inputs(gen, batch=CONTROL_BF16_BATCH)
    control = dict(hint=hint, task_id=task_id, task_feat=feat)
    result = {}
    for label, net, kw, convs, library in (
            ("base", base, {}, LEGACY_CONVS, LEGACY_LIBRARY),
            *((label, models[label], control, LEGACY_CONVS + CONTROL_CONVS,
               {k: LEGACY_LIBRARY[k] + CONTROL_LIBRARY[k] for k in LEGACY_LIBRARY})
              for label in ("controlled", "mid_only"))):
        with torch.no_grad():
            net(**inputs, **kw)  # warm-up
            reset_counts(K)
            lib.reset_calls()
            with counting_plain_convs(K, modconv) as plain_calls:
                t0 = time.perf_counter()
                for _ in range(CONTROL_BF16_REPS):
                    y = net(**inputs, **kw)
                torch.cuda.synchronize()
                sec = (time.perf_counter() - t0) / CONTROL_BF16_REPS
            counted = (K.dtype_launches["bfloat16"] // CONTROL_BF16_REPS,
                       K.dtype_launches["float32"], len(plain_calls),
                       {k: v // CONTROL_BF16_REPS for k, v in lib.calls.items()})
            variants = {v for v, c in K.variant_launches.items() if c}
            net.use_plain_conv(True)
            plain = net(**inputs, **kw)
            net.use_plain_conv(False)
        err = rel_to_scale(y, plain)
        print(f"[controlnet] bf16 {label} forward, 8-band batch {CONTROL_BF16_BATCH} "
              f"{SIZE}x{SIZE}: {sec * 1e3:.2f} ms, {CONTROL_BF16_BATCH / sec:.2f} img/s; against "
              f"the plain bf16 convs {err:.3g} of scale (bar {CONTROL_BF16_RTOL}); output "
              f"{y.dtype}; bf16 / fp32 K1 launches, plain convs, library convs a forward "
              f"{counted} (expected {convs} / 0, 0, {library}), variants {sorted(variants)}",
              flush=True)
        if not (err <= CONTROL_BF16_RTOL and y.dtype == torch.float32
                and torch.isfinite(y).all()):
            fail(f"bf16 {label} forward: {err} of scale from the plain bf16 convs")
        if counted != (convs, 0, 0, library) or not variants <= BF16_VARIANTS:
            fail(f"bf16 {label} forward launches {counted}, variants {variants}")
        result[label] = {"ms": sec * 1e3, "img_per_s": CONTROL_BF16_BATCH / sec,
                         "err_of_scale": err, "k1": convs}
    result["controlled_over_base"] = result["controlled"]["ms"] / result["base"]["ms"]
    result["mid_only_over_base"] = result["mid_only"]["ms"] / result["base"]["ms"]
    print(f"[controlnet] bf16 controlled_over_base {result['controlled_over_base']:.3f}, "
          f"mid_only_over_base {result['mid_only_over_base']:.3f}", flush=True)

    model = models["controlled"]
    with torch.no_grad():
        _, k1, convs = recorded_convs(K, lib, lambda: model(**inputs, **control))
    shapes = legacy_k1_bf16_shapes(K, k1)
    lib_ms = controlnet_times(K, lib, [], convs)[2]
    print(f"[controlnet] bf16 controlled forward's {len(k1)} K1 launches at "
          f"{len(shapes['shapes'])} shapes (H, W, Cin, Cout, accumulate) "
          f"{shapes['shapes']}: each within one bf16 step of its plain version (largest "
          f"{shapes['max_abs_err']:.3g}); the bf16 weight gradient at each, beyond one bf16 "
          f"step of fp32 sums by at most {shapes['weight_grad_excess_of_scale']:.3g} of scale "
          f"(bar {BF16_WEIGHT_GRAD_RTOL:.3g}; {shapes['weight_grad_over_1e-4']} elements beyond "
          f"1e-4); K1 {shapes['ms']:.3f} ms, plain "
          f"{shapes['plain_ms']:.3f}, bf16 library conv {shapes['library_ms']:.3f}, bound "
          f"{shapes['bound_ms']:.3f} ({shapes['bound_by']}); library convs {len(convs)} calls "
          f"{sum(lib_ms.values()):.3f} ms by kind { {k: round(v, 3) for k, v in lib_ms.items()} }",
          flush=True)
    result["forward_convs"] = {**{k: v for k, v in shapes.items() if k != "shapes"},
                               "k1_launches": len(k1), "library_convs_ms": lib_ms}

    # a controlled ddim request in bf16 at the fp32 phase's batch
    inputs2, hint2, _ = controlnet_inputs(gen)
    control2 = dict(hint=hint2, task_id=task_id, task_feat=feat)
    ns = NoiseSchedule.create("cosine", 1000).to(DEV)
    shape = tuple(inputs2["x_t"].shape)
    x_T = torch.randn(shape, device=DEV, generator=gen)
    imgs = {}
    for plain in (True, False):
        model.use_plain_conv(plain)
        denoise = lambda x, t, pan, ms: model(x, t, pan, ms, inputs2["prompt_emb"], **control2)
        with torch.no_grad():
            reset_counts(K)
            t0 = time.perf_counter()
            imgs[plain] = gaussian.ddim_sample(denoise, ns, None, inputs2["pan"], inputs2["ms"],
                                               shape, steps=CONTROL_STEPS, x_init=x_T)
            torch.cuda.synchronize()
            imgs[(plain, "s")] = time.perf_counter() - t0
            imgs[(plain, "n")] = (K.dtype_launches["bfloat16"], K.dtype_launches["float32"])
    model.use_plain_conv(False)
    gap = rel_to_scale(imgs[False], imgs[True])
    want = (CONTROL_STEPS * (LEGACY_CONVS + CONTROL_CONVS), 0)
    print(f"[controlnet] bf16 ddim {CONTROL_STEPS} steps with the controlled model, 8-band "
          f"batch {BATCH} {SIZE}x{SIZE}: {imgs[(False, 's')]:.3f} s "
          f"({CONTROL_STEPS / imgs[(False, 's')]:.1f} NFE/s), plain bf16 convs "
          f"{imgs[(True, 's')]:.3f} s; {gap:.3g} of scale from the plain (bar "
          f"{CONTROL_BF16_RTOL}); bf16 / fp32 K1 launches {imgs[(False, 'n')]} (expected {want})",
          flush=True)
    if not (gap <= CONTROL_BF16_RTOL and torch.isfinite(imgs[False]).all()
            and imgs[(False, "n")] == want):
        fail(f"bf16 controlled ddim: {gap} of scale, launches {imgs[(False, 'n')]}")
    result["ddim"] = {"s": imgs[(False, "s")], "plain_s": imgs[(True, "s")], "gap": gap,
                      "k1": want[0]}

    # one sd_locked fine-tune step in bf16, held against the plain bf16 convs
    labels = trainable_labels(model, sd_locked=True)
    names = [n for n, _ in model.named_parameters()]
    target = torch.randn(shape, device=DEV, generator=gen)
    signs = {}

    def loss_of(net, name):
        pred = net(**inputs2, **control2)
        if name == "plain":
            signs["s"] = torch.sign(pred.detach() - target)
        return torch.mean((pred - target) * signs["s"])

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    worst, n_step, grads = bf16_grads_check(K, "controlnet", {"kernel": model, "plain": model,
                                                              "fp32": model32}, names, loss_of)
    encoder = ("embed", "embed2", "conv1", "conv2", "down1", "down2", "down3", "down1_1",
               "down2_1", "down3_1", "middle1")
    leaked = [n for n in names if n.split(".")[0] in encoder and grads[n] is not None
              and grads[n].abs().max().item() != 0.0]
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    opt = torch.optim.Adam(trainable_parameters(model, labels), lr=CONTROL_LR)
    for n, p in model.named_parameters():
        p.grad = grads[n]
    opt.step()
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    moved = [n for n, p in model.named_parameters()
             if labels[n] == "freeze" and not torch.equal(p, before[n])]
    changed = sum(not torch.equal(p, before[n]) for n, p in model.named_parameters())
    fp32_params = all(p.dtype == torch.float32 for p in model.parameters())
    print(f"[controlnet] bf16 fine-tune step (sd_locked, Adam lr {CONTROL_LR}), 8-band batch "
          f"{BATCH} {SIZE}x{SIZE}: the three gradient passes and the step {step_s:.3f} s; "
          f"base-encoder gradients nonzero: {leaked}; {changed} parameters moved, frozen ones "
          f"moved: {moved}; parameters float32: {fp32_params}", flush=True)
    if leaked or moved or not changed or not fp32_params:
        fail(f"bf16 controlnet fine-tune step: leaked {leaked}, frozen moved {moved}")
    if n_step[1] or not (n_step[0] and n_step[2] and n_step[3]) or not n_step[4] <= BF16_VARIANTS:
        fail(f"bf16 controlnet fine-tune launches {n_step}")
    result["step"] = {"grad_worst_gap_own_to_fp32": worst, "launches": n_step[:4]}
    return result


MESH_RANKS = 4
MESH_SHAPES = ((2, 2), (1, 4))
MESH_DP_RANKS = 2  # the data-parallel training world under NCCL, a card a rank
MESH_STEPS = 10  # dpm++ steps of a meshed request (11 denoise calls)
MESH_REQUESTS = (("WV3", 8, 4, SIZE, MESH_SHAPES), ("QB", 4, 1, 2 * SIZE, ((1, 4),)))
MESH_TRAIN_MESH, MESH_TRAIN_STEPS = (2, 2), 3
# the meshes of the NCCL worlds' compiled steps (Trainer.compiled_step against
# train_step), and the timed replays of each after the compared steps
MESH_COMPILED, MESH_COMPILED_TIMED = ((2, 2), (4, 1)), 5
MESH_LIBRARY_RTOL = 1e-5  # a library conv on a space split, of each tensor's scale
MESH_LOSS_RTOL = 1e-4
# the bf16 meshed steps against one process's bf16 steps: the first loss
# (the meshed forward computes one process's bits; the loss is summed over
# the ranks in another order), then the later ones (weights moved by
# gradients rounded per shard: each rank's weight gradient, ds and db, and
# the halo's edge rows, tests/test_torch_mesh_bf16_train.py)
MESH_BF16_LOSS_RTOL = (1e-4, 1e-3)
MESH_TIMEOUT = 420.0


def _plain_counter(modconv):
    """Wraps modconv's plain conv versions so that each call counts; returns
    the count dict."""
    seen = {"plain": 0}
    for name in ("conv3d_plain", "conv3x3_nhwc_plain"):
        fn = getattr(modconv, name)

        def counted(*args, _fn=fn, **kw):
            seen["plain"] += 1
            return _fn(*args, **kw)

        setattr(modconv, name, counted)
    return seen


def launch_recorder(seen: set, launch):
    """A K._launch that adds each launch's (input gradient or not, x's
    shape, the kernel's shape and strides, which of style, bias and out it
    was given, the unsharded call's (B, H)) to `seen`, then calls
    `launch`."""
    def record(x, kernel, style, bias, out, input_grad=False, unsharded=None, **pre):
        seen.add((bool(input_grad), tuple(x.shape), tuple(kernel.shape), tuple(kernel.stride()),
                  style is not None, bias is not None, out is not None, unsharded))
        return launch(x, kernel, style, bias, out, input_grad, unsharded, **pre)

    return record


def mesh_compiled(K, mesh, train_weights, train, dtype, distill=False):
    """One rank's Trainer.compiled_step against train_step on `mesh`, the
    training weights as WavBEST of `dtype` (a DistillTrainer, N = 5, the
    initial weights as its teacher `extra`, with `distill`): the eager run
    (MESH_TRAIN_STEPS train_steps on train["steps"], each timed), then a
    fresh trainer from the same weights stepping through compiled_step on
    the same batches (its first call runs its own step, then the capture),
    then MESH_COMPILED_TIMED timed replays and one under the profiler (the
    K1 kernels a replay ran on the card, the device's busy share of the
    wall and NCCL's kernels' part of it). Both runs record their first
    call's distinct K1 launches (launch_recorder) and host-counted
    launches. Returns what the rank measured: whether the compiled state
    equals the eager one bit for bit, and the rest."""
    from tmdiff_tpu_torch.diffusion.schedules import NoiseSchedule
    from tmdiff_tpu_torch.models.wavbest import WavBEST
    from tmdiff_tpu_torch.train.distill import DistillTrainer
    from tmdiff_tpu_torch.train.trainer import Trainer

    dev = mesh.device
    prompt = torch.as_tensor(train["prompt"], device=dev)
    batches = [{k: torch.as_tensor(v, device=dev) for k, v in b.items()} for b in train["steps"]]
    weights = torch.load(train_weights, map_location=dev, weights_only=True)
    runs = {}
    for path in ("eager", "compiled"):
        model = WavBEST(CHANNELS, device=dev, dtype=dtype)
        model.load_state_dict(weights)
        kw = dict(lr=1e-4, weight_decay=1e-4, warmup_steps=100, max_iter=300_000,
                  loss_type="l1", ema_decay=0.9999, remat=True, seed=SEED, mesh=mesh)
        if distill:
            trainer = DistillTrainer(model, NoiseSchedule.create("cosine", 1000),
                                     n_student_steps=5, **kw)
            extra = ({n: p.detach().clone() for n, p in model.named_parameters()},)
        else:
            trainer, extra = Trainer(model, NoiseSchedule.create("cosine", 1000), **kw), ()
        state = trainer.init_state()
        step = trainer.compiled_step() if path == "compiled" else trainer.train_step
        run = {"losses": [], "secs": [], "seen": set()}
        launch = K._launch
        for i, batch in enumerate(batches):
            torch.cuda.synchronize()
            K.reset_launches()
            K._launch = launch_recorder(run["seen"], launch) if i == 0 else launch
            t0 = time.perf_counter()
            try:
                _, m = step(state, batch, prompt, *extra)
            finally:
                K._launch = launch
            run["losses"].append(m["l_pix"].item())
            torch.cuda.synchronize()
            run["secs"].append(time.perf_counter() - t0)
            if i == 0:
                run["first"] = (K.launches - K.input_grad_launches, K.input_grad_launches,
                                K.weight_grad_calls)
        run["state"] = [(n, t.clone()) for n, t in state_tensors(state)]
        if path == "compiled":
            timed = []
            for i in range(MESH_COMPILED_TIMED):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                step(state, batches[i % len(batches)], prompt, *extra)
                torch.cuda.synchronize()
                timed.append(time.perf_counter() - t0)
            kernels, wall = device_kernels(lambda: step(state, batches[0], prompt, *extra))
            nccl_us = sum(us for name, us in kernels if "nccl" in name.lower())
            run.update(median_s=float(np.median(timed)), k1=k1_kernels(kernels),
                       busy_share=sum(us for _, us in kernels) / 1e6 / wall,
                       nccl_share=nccl_us / 1e6 / wall,
                       capture_s=sum(trainer.capture_seconds().values()),
                       captures=len(trainer.capture_seconds()))
            trainer.release_compiled()
        runs[path] = run
        del trainer, state, model, step
    eager, comp = runs["eager"], runs["compiled"]
    same, gap, where = state_gap(comp["state"], eager["state"])
    return {"bit_identical": same, "gap": gap, "gap_at": where,
            "losses_equal": comp["losses"] == eager["losses"], "losses": comp["losses"],
            "median_s": comp["median_s"], "eager_median_s": float(np.median(eager["secs"])),
            "first_call_s": comp["secs"][0], "capture_s": comp["capture_s"],
            "captures": comp["captures"], "k1": comp["k1"], "busy_share": comp["busy_share"],
            "nccl_share": comp["nccl_share"], "first_call_launches": comp["first"],
            "eager_first_launches": eager["first"], "same_launches": comp["seen"] == eager["seen"],
            "shard_launches": sorted(comp["seen"], key=repr)}


def mesh_worker(weights, train_weights, requests, train, train_mesh, compiled_meshes):
    """One rank of the mesh phase (parallel/dryrun.py runs it on every rank):
    each request on each of its meshes (a regression warm-up, then dpm++
    at MESH_STEPS, counts reset just before and read just after), then on
    `train_mesh` the gradient check (fixed t and noise, dropout off, the
    single-process path's L1 signs) and MESH_TRAIN_STEPS training steps
    (the first one's distinct K1 launches recorded), then compiled_step
    against train_step on each of `compiled_meshes` (mesh_compiled; a
    DistillTrainer too on the first), in fp32 and then in bf16
    (mesh_bf16_worker). On a gloo world on the card: compiled_step's
    refusal and the CLI loop's step. Returns what each rank measured and
    sampled."""
    from tmdiff_tpu_torch.diffusion.schedules import NoiseSchedule
    from tmdiff_tpu_torch.models.wavbest import WavBEST
    from tmdiff_tpu_torch.ops import modconv
    from tmdiff_tpu_torch.ops.cuda import conv3d as K
    from tmdiff_tpu_torch.parallel import mesh as mesh_lib
    from tmdiff_tpu_torch.pipeline import Pansharpener
    from tmdiff_tpu_torch.train.trainer import Trainer

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    plain = _plain_counter(modconv)
    shapes = list(dict.fromkeys([s for _, _, ss in requests for s in ss] + [train_mesh]
                                + list(compiled_meshes)))
    meshes = {shape: mesh_lib.make_mesh(*shape) for shape in shapes}
    dev = meshes[train_mesh].device
    model = WavBEST(CHANNELS, device=dev)
    model.load_state_dict(torch.load(weights, map_location=dev, weights_only=True))
    out = {"mesh": {s: repr(m) for s, m in meshes.items()}, "requests": [],
           "train_mesh": train_mesh}
    for sensor, batch, shapes in requests:
        for shape in shapes:
            sharp = Pansharpener(model, mesh=meshes[shape])
            sharp.sample(batch, sensor=sensor, method="regression", seed=SEED)  # warm-up
            with DenoiseCounter(model) as nfe:
                torch.cuda.synchronize()
                K.reset_launches()
                mesh_lib.reset_stats()
                plain["plain"] = 0
                t0 = time.perf_counter()
                img = sharp.sample(batch, sensor=sensor, method="dpm++", steps=MESH_STEPS,
                                   seed=SEED)
                torch.cuda.synchronize()
                sec = time.perf_counter() - t0
            out["requests"].append({
                "sensor": sensor, "mesh": shape, "s": sec, "nfe": nfe.calls, "img": img,
                "k1": K.launches, "variants": dict(K.variant_launches),
                "plain": plain["plain"], "stats": dict(mesh_lib.stats)})

    model = WavBEST(CHANNELS, device=dev)
    model.load_state_dict(torch.load(train_weights, map_location=dev, weights_only=True))
    mesh = meshes[train_mesh]
    trainer = Trainer(model, NoiseSchedule.create("cosine", 1000), lr=1e-4, weight_decay=1e-4,
                      warmup_steps=100, max_iter=300_000, loss_type="l1", ema_decay=0.9999,
                      remat=True, seed=SEED, mesh=mesh)
    state = trainer.init_state()
    params = list(model.parameters())
    prompt = torch.as_tensor(train["prompt"], device=dev)
    gbatch = {k: torch.as_tensor(v, device=dev) for k, v in train["check"].items()}
    placed = mesh.place(tuple(gbatch["MS"].shape))
    model.use_mesh(placed)
    batch = {k: placed.shard(v) for k, v in gbatch.items()}
    t = placed.shard(torch.as_tensor(train["t"], device=dev))
    noise, sign = (placed.shard(torch.as_tensor(train[k], device=dev)) for k in ("noise", "sign"))
    K.reset_launches()
    pred = predict(model, trainer.schedule, batch, prompt, t, noise)
    held = torch.mean((pred - batch["Res"]) * sign) / mesh.size
    state.optimizer.zero_grad(set_to_none=True)
    held.backward()
    loss = trainer.all_reduce_grads(state, held.detach())
    grads = [p.grad.cpu() for p in params] if mesh.rank == 0 else None
    out["grad_check"] = {"loss": loss.item(), "grads": grads,
                         "pred": placed.gather(pred.detach()).cpu(),
                         "launches": (K.launches, K.input_grad_launches, K.weight_grad_calls),
                         "plain": plain["plain"]}
    state = trainer.init_state()  # the weights are untouched: zero_grad only
    losses, secs, per_step = [], [], []
    launch, shard_launches = K._launch, set()
    for step, batch in enumerate(train["steps"]):
        torch.cuda.synchronize()
        K.reset_launches()
        mesh_lib.reset_stats()
        K._launch = launch_recorder(shard_launches, launch) if step == 0 else launch
        t0 = time.perf_counter()
        try:
            state, metrics = trainer.train_step(state, batch, prompt)
        finally:
            K._launch = launch
        losses.append(metrics["l_pix"].item())
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        per_step.append({"k1_forward": K.launches - K.input_grad_launches,
                         "k1_input_grad": K.input_grad_launches,
                         "weight_grad": K.weight_grad_calls,
                         "k1_off_tensor_cores": K.variant_launches["ffma"],
                         "stats": dict(mesh_lib.stats)})
    out["train"] = {"losses": losses, "s": secs, "per_step": per_step, "plain": plain["plain"],
                    "shard_launches": sorted(shard_launches, key=repr),
                    "ema": torch.cat([e.reshape(-1) for e in state.ema_params]).cpu()
                    if mesh.rank in (0, mesh.size - 1) else None}
    if mesh.device.type == "cuda" and not mesh.capturable:
        from tmdiff_tpu_torch import cli

        loop_step = cli.training_step(trainer, logging.getLogger("mesh_worker"), say=False)
        try:
            trainer.compiled_step()
            out["refusal"] = None
        except ValueError as err:
            out["refusal"] = str(err)
        out["loop_runs_train_step"] = loop_step == trainer.train_step
    del trainer, state, model, params
    out["compiled"] = {shape: mesh_compiled(K, meshes[shape], train_weights, train,
                                            torch.float32) for shape in compiled_meshes}
    if compiled_meshes:
        first = compiled_meshes[0]
        out["compiled_distill"] = {first: mesh_compiled(K, meshes[first], train_weights, train,
                                                        torch.float32, distill=True)}
    out["bf16"] = mesh_bf16_worker(K, mesh, train_weights, train, plain,
                                   [meshes[shape] for shape in compiled_meshes])
    if (2, 2) in meshes:
        out["library"] = mesh_library_worker(meshes[(2, 2)], dev)
    return out


# the library routes of the conv API on a (1, 2) space split: a strided, a
# 5x5 and a transposed conv (SAME), fp32 and bf16, at a (B, D, H, W, C)
# the size of a legacy UNet level
MESH_LIBRARY_CASES = (("strided", "modulated_conv3d", (3, 3, 3), (1, 2, 2)),
                      ("5x5", "conv3d", (1, 5, 5), (1, 1, 1)),
                      ("transposed", "modulated_conv_transpose3d", (3, 3, 3), (1, 2, 2)))
MESH_LIBRARY_X = (1, 8, 64, 64, 32)


def library_split_case(case, dtype, dev, seed, placed=None):
    """One conv of MESH_LIBRARY_CASES in `dtype` on `dev`, on the placement
    `placed` (its rows) or unsharded: the output and the gradients of
    sum(y * dy), dy made from `seed` at the global output shape (x's rows;
    the kernel's and the style's parts of the sums), as float32 CPU
    tensors, with the rank's s."""
    from tmdiff_tpu_torch.ops import modconv

    _, entry, kernel, stride = case
    g = torch.Generator().manual_seed(seed)
    c = MESH_LIBRARY_X[-1]
    x = torch.randn(MESH_LIBRARY_X, generator=g)
    k = torch.randn(kernel + (c, c), generator=g) / float(np.sqrt(np.prod(kernel) * c))
    style = 0.5 + torch.rand((MESH_LIBRARY_X[0], c), generator=g)
    shard = (lambda a: a) if placed is None else placed.shard
    xs = shard(x.to(dev, dtype)).clone().requires_grad_(True)
    ss = style.to(dev, dtype).requires_grad_(True)  # batch 1: replicated over "data"
    kk = k.to(dev).requires_grad_(True)
    fn = getattr(modconv, entry)
    if entry == "conv3d":
        y = fn(xs, kk, stride=stride, mesh=placed)
    else:
        y = fn(xs, kk, ss, stride=stride, mesh=placed)
    rows = y.shape[2] * (1 if placed is None else placed.space)
    dy = torch.randn((*y.shape[:2], rows, *y.shape[3:]), generator=g).to(dev, dtype)
    (y.float() * shard(dy).float()).sum().backward()
    f = lambda t: None if t is None else t.detach().float().cpu()
    return {"s": 0 if placed is None else placed.s, "y": f(y), "x": f(xs.grad),
            "kernel": f(kk.grad), "style": f(ss.grad)}


def mesh_library_worker(mesh22, dev):
    """Every case of MESH_LIBRARY_CASES in fp32 and bf16 on a (1, 2) space
    split: the (2, 2) mesh with its batch replicated over "data", so each
    data row's two space ranks split the height as a (1, 2) mesh does."""
    mesh12 = dataclasses.replace(mesh22, data=1)
    placed = mesh12.place(MESH_LIBRARY_X)
    if placed.split_batch or not placed.halo:
        fail(f"the library cases' placement {placed} is not a (1, 2) space split")
    return {(case[0], str(dtype)): library_split_case(case, dtype, dev, SEED + i, placed)
            for i, case in enumerate(MESH_LIBRARY_CASES)
            for dtype in (torch.float32, torch.bfloat16)}


def mesh_library_check(label, ranks) -> dict:
    """Each data row's two ranks' library cases, gathered (rows) and summed
    (the kernel's and style's gradients), against one process on card 0:
    fp32 within MESH_LIBRARY_RTOL of each tensor's scale, bf16 within one
    bf16 step at its scale."""
    worst = {}
    for i, case in enumerate(MESH_LIBRARY_CASES):
        for dtype in (torch.float32, torch.bfloat16):
            key = (case[0], str(dtype))
            ref = library_split_case(case, dtype, DEV, SEED + i)
            gaps = {}
            for pair in (ranks[:2], ranks[2:]):
                parts = sorted((r["library"][key] for r in pair), key=lambda r: r["s"])
                got = {"y": torch.cat([p["y"] for p in parts], 2),
                       "x": torch.cat([p["x"] for p in parts], 2),
                       "kernel": sum(p["kernel"].double() for p in parts)}
                if ref["style"] is not None:
                    got["style"] = sum(p["style"].double() for p in parts)
                for name, g in got.items():
                    scale = ref[name].abs().max().item()
                    bar = (MESH_LIBRARY_RTOL * scale if dtype == torch.float32
                           else 2.0 ** (np.floor(np.log2(scale)) - 7))
                    gap = (g.double() - ref[name].double()).abs().max().item()
                    gaps[name] = max(gaps.get(name, 0.0), gap / bar)
            worst[f"{case[0]} {str(dtype).replace('torch.', '')}"] = gaps
    print(f"[mesh] {label} library convs on a (1, 2) space split of each data row, "
          f"{MESH_LIBRARY_X} SAME, against one process (gap over the bar: fp32 "
          f"{MESH_LIBRARY_RTOL} of scale, bf16 one step at scale): "
          + "; ".join(f"{k} " + ", ".join(f"{n} {v:.3g}" for n, v in g.items())
                      for k, g in worst.items()), flush=True)
    if any(v > 1.0 for g in worst.values() for v in g.values()):
        fail(f"{label}: a library conv on a space split differs from one process: {worst}")
    return worst


def mesh_bf16_worker(K, mesh, train_weights, train, plain, compiled):
    """The bf16 part of a mesh phase rank: the training weights as
    WavBEST(dtype=torch.bfloat16) on `mesh`, the gradient check (fixed t and
    noise, dropout off, the single-process bf16 path's L1 signs) and
    MESH_TRAIN_STEPS bf16 steps, counts reset just before and read just
    after each. The first step also records each distinct K1 launch
    (launch_recorder) for mesh_launch_check. Then compiled_step against
    train_step in bf16 on each mesh of `compiled` (mesh_compiled)."""
    from tmdiff_tpu_torch.diffusion.schedules import NoiseSchedule
    from tmdiff_tpu_torch.models.wavbest import WavBEST
    from tmdiff_tpu_torch.parallel import mesh as mesh_lib
    from tmdiff_tpu_torch.train.trainer import Trainer

    dev = mesh.device
    model = WavBEST(CHANNELS, device=dev, dtype=torch.bfloat16)
    model.load_state_dict(torch.load(train_weights, map_location=dev, weights_only=True))
    trainer = Trainer(model, NoiseSchedule.create("cosine", 1000), lr=1e-4, weight_decay=1e-4,
                      warmup_steps=100, max_iter=300_000, loss_type="l1", ema_decay=0.9999,
                      remat=True, seed=SEED, mesh=mesh)
    state = trainer.init_state()
    params = list(model.parameters())
    prompt = torch.as_tensor(train["prompt"], device=dev)
    gbatch = {k: torch.as_tensor(v, device=dev) for k, v in train["check"].items()}
    placed = mesh.place(tuple(gbatch["MS"].shape))
    model.use_mesh(placed)
    batch = {k: placed.shard(v) for k, v in gbatch.items()}
    t = placed.shard(torch.as_tensor(train["t"], device=dev))
    noise, sign = (placed.shard(torch.as_tensor(train[k], device=dev))
                   for k in ("noise", "sign16"))
    torch.cuda.synchronize()
    K.reset_launches()
    plain["plain"] = 0
    pred = predict(model, trainer.schedule, batch, prompt, t, noise)
    held = torch.mean((pred - batch["Res"]) * sign) / mesh.size
    state.optimizer.zero_grad(set_to_none=True)
    held.backward()
    loss = trainer.all_reduce_grads(state, held.detach())
    torch.cuda.synchronize()
    check = {"loss": loss.item(), "grads": [p.grad.cpu() for p in params] if mesh.rank == 0
             else None,
             "launches": (K.dtype_launches["bfloat16"], K.dtype_launches["float32"],
                          K.input_grad_launches, K.weight_grad_calls),
             "plain": plain["plain"]}
    state = trainer.init_state()
    losses, secs, per_step = [], [], []
    launch, shard_launches = K._launch, set()
    for step, batch in enumerate(train["steps"]):
        torch.cuda.synchronize()
        K.reset_launches()
        mesh_lib.reset_stats()
        plain["plain"] = 0
        K._launch = launch_recorder(shard_launches, launch) if step == 0 else launch
        t0 = time.perf_counter()
        try:
            state, metrics = trainer.train_step(state, batch, prompt)
        finally:
            K._launch = launch
        losses.append(metrics["l_pix"].item())
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        per_step.append({"k1_forward": K.launches - K.input_grad_launches,
                         "k1_input_grad": K.input_grad_launches,
                         "weight_grad": K.weight_grad_calls,
                         "k1_fp32": K.dtype_launches["float32"],
                         "k1_off_bf16": K.launches - sum(K.variant_launches[v]
                                                         for v in BF16_VARIANTS),
                         "plain": plain["plain"], "stats": dict(mesh_lib.stats)})
    moments = [v for st in state.optimizer.state.values() for k, v in st.items() if k != "step"]
    fp32_state = all(x.dtype == torch.float32 for x in [*params, *state.ema_params, *moments])
    out = {"grad_check": check, "losses": losses, "s": secs, "per_step": per_step,
           "fp32_state": fp32_state, "shard_launches": sorted(shard_launches, key=repr),
           "ema": torch.cat([e.reshape(-1) for e in state.ema_params]).cpu()
           if mesh.rank in (0, mesh.size - 1) else None}
    del trainer, state, model, params, moments
    out["compiled"] = {(m.data, m.space): mesh_compiled(K, m, train_weights, train,
                                                        torch.bfloat16) for m in compiled}
    return out


def mesh_single(weights, train_weights, requests, train):
    """The mesh phase's cases in this process on the card: each request's
    image and seconds, the gradient check's loss, gradients, prediction and
    signs, the training steps' losses, and their bf16 references
    (mesh_single_bf16)."""
    from tmdiff_tpu_torch.diffusion.schedules import NoiseSchedule
    from tmdiff_tpu_torch.models.wavbest import WavBEST
    from tmdiff_tpu_torch.pipeline import Pansharpener
    from tmdiff_tpu_torch.train.trainer import Trainer

    model = WavBEST(CHANNELS, device=DEV)
    model.load_state_dict(torch.load(weights, map_location=DEV, weights_only=True))
    sharp = Pansharpener(model, device=DEV)
    images = {}
    for sensor, batch, _ in requests:
        sharp.sample(batch, sensor=sensor, method="regression", seed=SEED)  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        images[sensor] = sharp.sample(batch, sensor=sensor, method="dpm++", steps=MESH_STEPS,
                                      seed=SEED)
        images[sensor + "_s"] = time.perf_counter() - t0
    model = WavBEST(CHANNELS, device=DEV)
    model.load_state_dict(torch.load(train_weights, map_location=DEV, weights_only=True))
    trainer = Trainer(model, NoiseSchedule.create("cosine", 1000), lr=1e-4, weight_decay=1e-4,
                      warmup_steps=100, max_iter=300_000, loss_type="l1", ema_decay=0.9999,
                      remat=True, seed=SEED)
    state = trainer.init_state()
    params = list(model.parameters())
    prompt = torch.as_tensor(train["prompt"], device=DEV)
    batch = {k: torch.as_tensor(v, device=DEV) for k, v in train["check"].items()}
    t = torch.as_tensor(train["t"], device=DEV)
    noise = torch.as_tensor(train["noise"], device=DEV)
    pred = predict(model, trainer.schedule, batch, prompt, t, noise)
    sign = torch.sign(pred.detach() - batch["Res"])
    held = torch.mean((pred - batch["Res"]) * sign)
    grads = torch.autograd.grad(held, params)
    check = {"loss": held.item(), "grads": [g.cpu() for g in grads], "pred": pred.detach().cpu(),
             "sign": sign.cpu().numpy()}
    losses, secs = [], []
    for b in train["steps"]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = trainer.train_step(state, b, prompt)
        losses.append(metrics["l_pix"].item())
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    check["s"] = secs
    check["bf16"] = mesh_single_bf16(train_weights, train)
    return images, check, losses


def mesh_single_bf16(train_weights, train):
    """The bf16 references of the mesh phase in this process: the bf16
    model's x0 prediction at the check's t and noise, its L1 signs, its
    gradients and the fp32 model's (the same weights) under those signs;
    then MESH_TRAIN_STEPS bf16 steps' losses and seconds."""
    from tmdiff_tpu_torch.diffusion.schedules import NoiseSchedule
    from tmdiff_tpu_torch.models.wavbest import WavBEST
    from tmdiff_tpu_torch.train.trainer import Trainer

    weights = torch.load(train_weights, map_location=DEV, weights_only=True)
    model, model32 = (WavBEST(CHANNELS, device=DEV, dtype=dt)
                      for dt in (torch.bfloat16, torch.float32))
    model.load_state_dict(weights)
    model32.load_state_dict(weights)
    trainer = Trainer(model, NoiseSchedule.create("cosine", 1000), lr=1e-4, weight_decay=1e-4,
                      warmup_steps=100, max_iter=300_000, loss_type="l1", ema_decay=0.9999,
                      remat=True, seed=SEED)
    prompt = torch.as_tensor(train["prompt"], device=DEV)
    batch = {k: torch.as_tensor(v, device=DEV) for k, v in train["check"].items()}
    t = torch.as_tensor(train["t"], device=DEV)
    noise = torch.as_tensor(train["noise"], device=DEV)
    pred = predict(model, trainer.schedule, batch, prompt, t, noise)
    sign = torch.sign(pred.detach() - batch["Res"])
    grads = torch.autograd.grad(torch.mean((pred - batch["Res"]) * sign),
                                list(model.parameters()))
    pred32 = predict(model32, trainer.schedule, batch, prompt, t, noise)
    grads32 = torch.autograd.grad(torch.mean((pred32 - batch["Res"]) * sign),
                                  list(model32.parameters()))
    state = trainer.init_state()
    losses, secs = [], []
    for b in train["steps"]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = trainer.train_step(state, b, prompt)
        losses.append(metrics["l_pix"].item())
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    return {"grads": [g.cpu() for g in grads], "grads32": [g.cpu() for g in grads32],
            "sign": sign.cpu().numpy(), "losses": losses, "s": secs,
            "names": [n for n, _ in model.named_parameters()]}


def mesh_phase(K, root, served=None):
    """The ("data", "space") mesh (tmdiff_tpu_torch/parallel/) on card 0:
    MESH_RANKS ranks sharing the card over gloo through host memory, spawned
    by parallel/dryrun.py, each with the full-width model from seeded
    weights written once. The WV3 8-band batch 4 256x256 request (dpm++,
    MESH_STEPS steps) on (2, 2) and (1, 4) and the QB 4-band batch 1
    512x512 request on (1, 4): every rank's image within SAMPLE_ATOL of the
    single-process image on the card; K1 launches per rank 13 + 52 per
    denoise call (65 a model call), none off the tensor cores, no plain
    conv. Then the training step of the train phase (WV3 8 bands, batch 8,
    64x64, init "torch") on (2, 2): the gradient check of the train phase
    (the single-process path's L1 signs, every gradient within GRAD_RTOL of
    its scale, the x0 prediction within TRAIN_FORWARD_ATOL) and
    MESH_TRAIN_STEPS steps with their losses within MESH_LOSS_RTOL, the EMA
    equal across ranks; then the same in bf16 (WavBEST(dtype=torch.bfloat16),
    mesh_bf16_check: the gradient check at the `[train] bf16` bar, the
    losses against one process's bf16 steps, 130 + 65 bf16 K1 launches a
    step per rank and no fp32 one, half the fp32 step's halo bytes). Prints
    each mesh's backend and transport, seconds, halo exchanges and bytes
    per request, collectives per step. Under NCCL,
    a card a rank, the same cases run when MESH_RANKS cards are visible,
    and the training steps data-parallel on MESH_DP_RANKS cards when that
    many are; there Trainer.compiled_step runs against train_step
    (mesh_compiled, mesh_compiled_check: on each mesh of MESH_COMPILED, or
    the data-parallel one, in fp32 and bf16, and a DistillTrainer on the
    first; every rank's state bit for bit, a replay's K1 kernels read on
    the card). The gloo world checks that compiled_step refuses it. Every
    distinct K1 launch recorded, fp32 and bf16, is relaunched against its
    plain version (mesh_launch_check). Then the meshed server
    (mesh_serve_phase), beside `served`, the http phase's one-card
    results."""
    from tmdiff_tpu_torch.diffusion.schedules import NoiseSchedule
    from tmdiff_tpu_torch.models.wavbest import WavBEST
    from tmdiff_tpu_torch.parallel.dryrun import run_world
    from tmdiff_tpu_torch.train.checkpoint import save_checkpoint
    from tmdiff_tpu_torch.train.trainer import Trainer

    weights, train_weights = (os.path.join(root, n) for n in ("weights.pt", "train_weights.pt"))
    model = WavBEST(CHANNELS, device="cpu", seed=SEED)
    torch.save(model.state_dict(), weights)
    ckpt = save_checkpoint(os.path.join(root, "checkpoint"),
                           Trainer(model, NoiseSchedule.create("cosine", 1000)).init_state())
    new_model, _, prompts, datasets = train_setup()
    torch.save({k: v.cpu() for k, v in new_model().state_dict().items()}, train_weights)
    rng = np.random.default_rng(SEED)
    requests = [(sensor, sized_batch(rng, bands, b, size), shapes)
                for sensor, bands, b, size, shapes in MESH_REQUESTS]
    ds = datasets["WV3"]
    gen = torch.Generator().manual_seed(SEED)
    check = ds.batch(np.arange(TRAIN_BATCH))
    train = {"prompt": prompts["WV3"].cpu().numpy(),
             "check": {k: check[k] for k in ("Res", "PAN", "MS")},
             "t": torch.randint(1, 1001, (TRAIN_BATCH,), generator=gen).numpy(),
             "noise": torch.randn(check["Res"].shape, generator=gen).numpy(),
             "steps": [{k: v for k, v in ds.batch(np.arange(i, i + TRAIN_BATCH)).items()
                        if k in ("Res", "PAN", "MS")}
                       for i in range(1, 1 + MESH_TRAIN_STEPS)]}
    images, single_check, single_losses = mesh_single(weights, train_weights, requests, train)
    train["sign"] = single_check["sign"]
    train["sign16"] = single_check["bf16"]["sign"]
    cards = torch.cuda.device_count()
    # (label, ranks, device, backend, requests, training mesh)
    # (label, ranks, device, backend, requests, training mesh, compiled meshes)
    worlds = [("gloo", MESH_RANKS, "cuda:0", "gloo", requests, MESH_TRAIN_MESH, ())]
    if cards >= MESH_RANKS:
        worlds.append(("nccl", MESH_RANKS, "cuda", None, requests, MESH_TRAIN_MESH,
                       MESH_COMPILED))
    if cards >= MESH_DP_RANKS:
        dp = (MESH_DP_RANKS, 1)
        worlds.append((f"nccl data-parallel on {MESH_DP_RANKS} cards", MESH_DP_RANKS, "cuda",
                       None, [], dp, (dp,)))
    print(f"[mesh] torch {torch.__version__}, NCCL {'.'.join(map(str, torch.cuda.nccl.version()))}"
          f"; {cards} card(s) visible", flush=True)
    if cards < MESH_RANKS:
        print(f"[mesh] NCCL: {cards} card(s) visible, {MESH_RANKS} needed for the mesh cases "
              f"and {MESH_DP_RANKS} for the data-parallel step", flush=True)
    summary = {}
    for label, n, device, backend, reqs, train_mesh, compiled in worlds:
        t0 = time.perf_counter()
        ranks = run_world("chip_smoke:mesh_worker", n,
                          (weights, train_weights, reqs, train, train_mesh, compiled),
                          device=device, backend=backend, threads=2, timeout=MESH_TIMEOUT)
        wall = time.perf_counter() - t0
        summary[label] = mesh_check(label, ranks, images, single_check, single_losses, wall,
                                    train_mesh)
        if "refusal" in ranks[0]:
            mesh_refusal_check(label, ranks)
        for dtype, kept in (("float32", summary[label]), ("bfloat16", summary[label]["bf16"])):
            kept["launches_checked"] = mesh_launch_check(K, label, ranks, dtype)
        if "library" in ranks[0]:
            summary[label]["library_gap_over_bar"] = mesh_library_check(label, ranks)
    summary["serve"] = mesh_serve_phase(ckpt, root, served, np.random.default_rng(SEED + 1))
    return summary


def mesh_check(label, ranks, images, single_check, single_losses, wall, train_mesh):
    """Holds one world's results against the single-process ones, then its
    compiled runs against its train_steps (mesh_compiled_check, fp32 here,
    bf16 in mesh_bf16_check); prints them and returns the numbers kept in
    the summary line."""
    for shape, rep in ranks[0]["mesh"].items():
        print(f"[mesh] {label} {shape}: {rep}", flush=True)
    kept = {"world_s": wall, "requests": []}
    for i, first in enumerate(ranks[0]["requests"]):
        sensor, shape = first["sensor"], first["mesh"]
        ref = images[sensor]
        gaps = [np.abs(r["requests"][i]["img"] - ref) for r in ranks]
        gap = max(float(g.max()) for g in gaps)
        expected = ENCODE_CONVS + DENOISE_CONVS * first["nfe"]
        per_rank = [(r["requests"][i]["k1"], r["requests"][i]["variants"]["ffma"],
                     r["requests"][i]["plain"]) for r in ranks]
        secs = [r["requests"][i]["s"] for r in ranks]
        st = first["stats"]
        print(f"[mesh] {label} {sensor} {ref.shape[1]}-band batch {ref.shape[0]} "
              f"{ref.shape[2]}x{ref.shape[3]} dpm++ {MESH_STEPS} steps on {shape}: "
              f"{max(secs):.3f} s (single process {images[sensor + '_s']:.3f} s); NFE "
              f"{first['nfe']}; per rank K1 launches / off the tensor cores / plain convs "
              f"{per_rank} (expected {expected} / 0 / 0); rank 0: {st['exchanges']} halo "
              f"exchanges, {st['halo_bytes']} halo bytes sent, {st['collectives']} "
              f"collectives of {st['collective_bytes']} bytes; max abs gap to the "
              f"single-process image over the ranks {gap:.6g} (atol {SAMPLE_ATOL}), mean "
              f"{float(np.mean([g.mean() for g in gaps])):.3g}", flush=True)
        if not gap <= SAMPLE_ATOL:
            fail(f"{label} {sensor} on {shape}: image differs from single process by {gap}")
        if any(n != (expected, 0, 0) for n in per_rank):
            fail(f"{label} {sensor} on {shape}: launches per rank {per_rank}")
        kept["requests"].append({"sensor": sensor, "mesh": list(shape), "s": max(secs),
                                 "single_s": images[sensor + "_s"], "gap": gap,
                                 "k1_per_rank": first["k1"], "exchanges": st["exchanges"],
                                 "halo_bytes": st["halo_bytes"],
                                 "collectives": st["collectives"]})
    check = ranks[0]["grad_check"]
    errs = [rel_to_scale(a, b) for a, b in zip(check["grads"], single_check["grads"])]
    forward = (check["pred"] - single_check["pred"]).abs().max().item()
    loss_rel = abs(check["loss"] - single_check["loss"]) / abs(single_check["loss"])
    n_k, n_in, n_w = check["launches"]
    print(f"[mesh] {label} gradient check on {train_mesh}, WV3 8-band batch "
          f"{TRAIN_BATCH} {TRAIN_SIZE}x{TRAIN_SIZE}, fixed t and noise, dropout off, the "
          f"single-process L1 signs: loss rel {loss_rel:.3g} (rtol {GRAD_LOSS_RTOL}); worst "
          f"gradient {max(errs):.3g} of its scale (bar {GRAD_RTOL}); x0 prediction vs single "
          f"process {forward:.3g} (atol {TRAIN_FORWARD_ATOL}); rank 0 K1 launches {n_k} "
          f"({n_k - n_in} forward, {n_in} input gradient), {n_w} weight gradients", flush=True)
    if not (loss_rel <= GRAD_LOSS_RTOL and max(errs) <= GRAD_RTOL
            and forward <= TRAIN_FORWARD_ATOL):
        fail(f"{label} meshed gradients: loss {loss_rel}, worst {max(errs)}, forward {forward}")
    if (n_k - n_in, n_in, n_w) != (TRAIN_CONVS, TRAIN_CONVS, TRAIN_CONVS) or check["plain"]:
        fail(f"{label} meshed gradient pass launches {check['launches']}, plain {check['plain']}")
    losses = ranks[0]["train"]["losses"]
    steps = [r["train"]["per_step"] for r in ranks]
    secs = [max(r["train"]["s"][k] for r in ranks) for k in range(MESH_TRAIN_STEPS)]
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses, single_losses))
    ema_same = torch.equal(ranks[0]["train"]["ema"], ranks[-1]["train"]["ema"])
    last = steps[0][-1]
    print(f"[mesh] {label} {MESH_TRAIN_STEPS} training steps on {train_mesh}: losses "
          f"{losses} vs single process {single_losses} (worst rel {rel:.3g}, rtol "
          f"{MESH_LOSS_RTOL}); s/step {[round(s, 4) for s in secs]} (single process "
          f"{[round(s, 4) for s in single_check['s']]}); rank 0 per step "
          f"{ {k: v for k, v in last.items() if k != 'stats'} }, {last['stats']['exchanges']} "
          f"halo exchanges, {last['stats']['collectives']} collectives of "
          f"{last['stats']['collective_bytes']} bytes; EMA equal on ranks 0 and "
          f"{len(ranks) - 1}: {ema_same}", flush=True)
    if not rel <= MESH_LOSS_RTOL or not ema_same:
        fail(f"{label} meshed training: loss rel {rel}, EMA equal {ema_same}")
    want = {"k1_forward": 2 * TRAIN_CONVS, "k1_input_grad": TRAIN_CONVS,
            "weight_grad": TRAIN_CONVS, "k1_off_tensor_cores": 0}
    if any({k: v for k, v in s.items() if k != "stats"} != want for r in steps for s in r) or \
            any(r["train"]["plain"] for r in ranks):
        fail(f"{label} meshed training launches {steps}")
    kept.update(train_losses_rel=rel, train_s_per_step=float(np.median(secs)),
                train_single_s_per_step=float(np.median(single_check["s"])),
                grad_err=max(errs), collectives_per_step=last["stats"]["collectives"],
                halo_exchanges_per_step=last["stats"]["exchanges"])
    kept["compiled"] = mesh_compiled_check(label, [r["compiled"] for r in ranks], "float32")
    if "compiled_distill" in ranks[0]:
        kept["compiled"].update(mesh_compiled_check(
            label, [r["compiled_distill"] for r in ranks], "float32", distill=True))
    kept["bf16"] = mesh_bf16_check(label, ranks, single_check["bf16"], train_mesh,
                                   [s["stats"]["halo_bytes"] for s in steps[0]], kept)
    return kept


def mesh_compiled_check(label, runs, dtype, distill=False) -> dict:
    """Holds one world's compiled_step runs in `dtype` (mesh_compiled; per
    rank {mesh: result}): on every rank the state after MESH_TRAIN_STEPS
    compiled steps equals the state after as many train_steps bit for bit,
    and so do the losses; one capture; the first call counted twice the
    eager first step's K1 launches and weight gradients on the host (its
    own step and the capture) and the same distinct launches; each rank's
    replay ran 130 + 65 K1 kernels on the card (a distillation step 4 x 65
    + 65), each on the tensor cores of the dtype. Prints a `[mesh] <world>
    compiled` line a mesh; returns the numbers kept."""
    per_step = (4 if distill else 2) * TRAIN_CONVS, TRAIN_CONVS, TRAIN_CONVS
    kernel = K1_KERNELS["bf16" if dtype == "bfloat16" else "tf32x3"]
    kind = "distill" if distill else "train"
    gpu = card() if runs and runs[0] else None
    kept = {}
    for shape in runs[0]:
        rs = [r[shape] for r in runs]
        k1 = [len(r["k1"]) for r in rs]
        med, eager_med = max(r["median_s"] for r in rs), max(r["eager_median_s"] for r in rs)
        same = all(r["bit_identical"] for r in rs)
        losses = all(r["losses_equal"] for r in rs)
        res = {"median_s": med, "eager_median_s": eager_med,
               "busy_share": [r["busy_share"] for r in rs],
               "nccl_share": [r["nccl_share"] for r in rs],
               "capture_s": max(r["capture_s"] for r in rs),
               "first_call_s": max(r["first_call_s"] for r in rs), "replay_k1": k1,
               "bit_identical": same, "card": gpu}
        kept[f"{kind} {dtype} {shape}"] = res
        print(f"[mesh] {label} compiled {dtype} {kind} on {shape}: {MESH_TRAIN_STEPS} compiled "
              f"steps against {MESH_TRAIN_STEPS} train_steps from one start, state bit for bit "
              f"on every rank {same} (largest gap {max(r['gap'] for r in rs):.3g} of scale), "
              f"losses equal {losses}; a replay ran {k1} K1 kernels per rank on the card "
              f"(expected {per_step[0] + per_step[1]}, each {kernel}); first call's host "
              f"launches {rs[0]['first_call_launches']} (the eager step's "
              f"{rs[0]['eager_first_launches']}); median step compiled {med:.4f} s over "
              f"{MESH_COMPILED_TIMED} replays, eager {eager_med:.4f} s over {MESH_TRAIN_STEPS} "
              f"steps (slowest rank); busy share per rank "
              f"{[round(b, 3) for b in res['busy_share']]} (NCCL kernels "
              f"{[round(b, 3) for b in res['nccl_share']]}); capture {res['capture_s']:.3f} s "
              f"(first call {res['first_call_s']:.3f} s with its own step); {gpu}", flush=True)
        if not (same and losses):
            fail(f"{label} compiled {dtype} {kind} on {shape}: not the train_steps' state "
                 f"({[(r['gap'], r['gap_at']) for r in rs]})")
        twice = tuple(2 * n for n in per_step)
        for r in rs:
            if (r["captures"] != 1 or r["eager_first_launches"] != per_step
                    or r["first_call_launches"] != twice or not r["same_launches"]):
                fail(f"{label} compiled {dtype} {kind} on {shape}: {r['captures']} captures, "
                     f"first call's launches {r['first_call_launches']} against the eager "
                     f"step's {r['eager_first_launches']}, same distinct launches "
                     f"{r['same_launches']}")
            if r["k1"] != [kernel] * (per_step[0] + per_step[1]):
                fail(f"{label} compiled {dtype} {kind} on {shape}: a replay ran K1 kernels "
                     f"{sorted(set(r['k1']))} x {len(r['k1'])}")
    return kept


def mesh_refusal_check(label, ranks):
    """On a gloo world on the card, every rank's compiled_step raised,
    naming NCCL and train_step, and the CLI's loop steps through
    train_step; prints the `[mesh] <world> compiled` refusal line."""
    refusals = [r["refusal"] for r in ranks]
    print(f"[mesh] {label} compiled: compiled_step refused on every rank "
          f"{all(m and 'NCCL' in m and 'train_step' in m for m in refusals)} "
          f"({refusals[0]!r}); the CLI loop steps through train_step "
          f"{all(r['loop_runs_train_step'] for r in ranks)}", flush=True)
    if not all(m and "NCCL" in m and "train_step" in m for m in refusals) or not all(
            r["loop_runs_train_step"] for r in ranks):
        fail(f"{label}: compiled_step on a gloo mesh on the card: {refusals}")


def mesh_bf16_check(label, ranks, single, train_mesh, fp32_halo_bytes, fp32_kept):
    """Holds one world's bf16 training against one process's bf16 path:
    the gradient check at the `[train] bf16` bar (each gradient within twice
    the single-process bf16 gradient's own gap to fp32, floored at its
    median, and BF16_GRAD_CAP, of the fp32 gradient's scale), 130 + 65 bf16
    K1 launches, 65 weight gradients, no fp32 launch and no plain conv a
    step on every rank, the losses within MESH_BF16_LOSS_RTOL, the state
    float32 and the EMA equal across ranks, half the fp32 step's halo
    bytes. Prints the `[mesh] ... bf16 train` lines; returns the numbers
    kept."""
    check = ranks[0]["bf16"]["grad_check"]
    rows = {}
    for name, gm, g16, g32 in zip(single["names"], check["grads"], single["grads"],
                                  single["grads32"]):
        scale = g32.abs().max().item()
        if scale > 0:
            rows[name] = ((gm - g16).abs().max().item() / scale,
                          (g16 - g32).abs().max().item() / scale,
                          (gm - g32).abs().max().item() / scale)
    floor = float(np.median([own for _, own, _ in rows.values()]))
    over = {k: r for k, r in rows.items()
            if not (r[0] <= 2 * max(r[1], floor) and r[0] < BF16_GRAD_CAP)}
    worst = max(rows, key=lambda k: rows[k][0] / max(rows[k][1], floor))
    n16, n32, n_in, n_w = check["launches"]
    print(f"[mesh] {label} bf16 train gradient check on {train_mesh}, WV3 8-band batch "
          f"{TRAIN_BATCH} {TRAIN_SIZE}x{TRAIN_SIZE}, fixed t and noise, dropout off, the "
          f"single-process bf16 L1 signs: {len(rows)} gradients, worst {worst} at "
          f"{rows[worst][0]:.3g} of scale against one process's bf16 gradient, whose own gap "
          f"to fp32 is {rows[worst][1]:.3g} (median {floor:.3g}); largest gap "
          f"{max(r[0] for r in rows.values()):.3g} (cap {BF16_GRAD_CAP}), to fp32 "
          f"{max(r[2] for r in rows.values()):.3g}; rank 0 K1 launches bf16 {n16}, fp32 {n32}, "
          f"input gradient {n_in}, weight gradients {n_w}, plain convs {check['plain']}",
          flush=True)
    if over:
        fail(f"{label} meshed bf16 gradients beyond the bar: {over}")
    if (n16, n32, n_in, n_w) != (2 * TRAIN_CONVS, 0, TRAIN_CONVS, TRAIN_CONVS) or check["plain"]:
        fail(f"{label} meshed bf16 gradient pass launches {check['launches']}, plain "
             f"{check['plain']}")
    runs = [r["bf16"] for r in ranks]
    losses = runs[0]["losses"]
    rels = [abs(a - b) / abs(b) for a, b in zip(losses, single["losses"])]
    bars = [MESH_BF16_LOSS_RTOL[0]] + [MESH_BF16_LOSS_RTOL[1]] * (len(rels) - 1)
    secs = [max(r["s"][k] for r in runs) for k in range(MESH_TRAIN_STEPS)]
    ema_same = torch.equal(runs[0]["ema"], runs[-1]["ema"])
    last = runs[0]["per_step"][-1]
    halo = [s["stats"]["halo_bytes"] for s in runs[0]["per_step"]]
    counts = {k: v for k, v in last.items() if k != "stats"}
    print(f"[mesh] {label} bf16 train {MESH_TRAIN_STEPS} steps on {train_mesh}: losses "
          f"{losses} vs single-process bf16 {single['losses']} (rel {[f'{r:.3g}' for r in rels]}, "
          f"rtol {bars}); s/step {[round(s, 4) for s in secs]} (meshed fp32 median "
          f"{fp32_kept['train_s_per_step']:.4f}, single-process bf16 "
          f"{[round(s, 4) for s in single['s']]}); rank 0 per step {counts}, "
          f"{last['stats']['exchanges']} halo exchanges, halo bytes {halo} against the fp32 "
          f"step's {fp32_halo_bytes}, {last['stats']['collectives']} collectives of "
          f"{last['stats']['collective_bytes']} bytes; state float32 on every rank "
          f"{all(r['fp32_state'] for r in runs)}; EMA equal on ranks 0 and {len(ranks) - 1}: "
          f"{ema_same}", flush=True)
    if any(r > b for r, b in zip(rels, bars)) or not ema_same or \
            not all(r["fp32_state"] for r in runs):
        fail(f"{label} meshed bf16 training: loss rel {rels}, EMA equal {ema_same}")
    want = {"k1_forward": 2 * TRAIN_CONVS, "k1_input_grad": TRAIN_CONVS,
            "weight_grad": TRAIN_CONVS, "k1_fp32": 0, "k1_off_bf16": 0, "plain": 0}
    if any({k: v for k, v in s.items() if k != "stats"} != want
           for r in runs for s in r["per_step"]):
        fail(f"{label} meshed bf16 training launches {[r['per_step'] for r in runs]}")
    if any(2 * b != f for b, f in zip(halo, fp32_halo_bytes)):
        fail(f"{label} bf16 halo bytes {halo}, not half the fp32 step's {fp32_halo_bytes}")
    return {"losses_rel": rels, "s_per_step": float(np.median(secs)),
            "single_s_per_step": float(np.median(single["s"])),
            "grad_worst_gap_own_to_fp32": rows[worst], "halo_bytes_per_step": halo[-1],
            "fp32_halo_bytes_per_step": fp32_halo_bytes[-1], "counts_per_step": counts,
            "compiled": mesh_compiled_check(label, [r["compiled"] for r in runs], "bfloat16")}


def mesh_launch_check(K, label, ranks, dtype):
    """Every distinct K1 launch in `dtype` that the world's ranks recorded
    (the forward and remat's recompute on the space shards' H_l + 2 rows,
    the input gradient on the shards' dy; the eager training steps' and
    the compiled runs'), relaunched here on card 0 with its `unsharded`
    argument on seeded operands of its shape and strides (style, bias and
    out where it had them): bf16 within one bf16 step of the plain version
    (bf16_check), fp32 within CONV_RTOL of its scale; one launch on a
    tensor-core variant of the dtype, planned with the split count of the
    unsharded call, and each x either a shard of the unsharded height with
    its two halo rows or the whole height. Prints the `[mesh] ... train
    launches` line; returns the counts checked."""
    bf16 = dtype == "bfloat16"
    cast = torch.bfloat16 if bf16 else torch.float32
    variants = BF16_VARIANTS if bf16 else {"tf32x3", "tf32x3_splitk"}
    shapes = set()
    for r in ranks:
        part = r["bf16"] if bf16 else r["train"]
        shapes |= {(launch, r["train_mesh"][1]) for launch in part["shard_launches"]}
        compiled = r["bf16"]["compiled"] if bf16 else {**r["compiled"], **r.get(
            "compiled_distill", {})}
        for mesh_shape, run in compiled.items():
            shapes |= {(launch, mesh_shape[1]) for launch in run["shard_launches"]}
    gen = torch.Generator(device=DEV).manual_seed(SEED)
    rand = lambda *shape: torch.randn(shape, device=DEV, generator=gen)
    worst, heights, splits = 0.0, set(), set()
    for (input_grad, shape, kshape, kstride, styled, biased, accum, unsharded), space in sorted(
            shapes, key=repr):
        b, d, h, w, cin = shape
        cout = kshape[-1]
        what = (f"{label} meshed {dtype} {'input gradient' if input_grad else 'forward'} "
                f"{shape} -> {cout} (unsharded (B, H) {unsharded})")
        if unsharded is None:
            fail(f"{what}: not planned for the unsharded call")
        if h not in (unsharded[1], unsharded[1] // space + 2 if space > 1 else None):
            fail(f"{what}: neither the whole height nor a shard with its halo rows")
        x = rand(*shape).to(cast)
        k = torch.empty_strided(kshape, kstride, dtype=cast, device=DEV)
        k.copy_(rand(*kshape) / (27 * cin) ** 0.5)
        style = (1 + 0.1 * rand(b, cin)).to(cast) if styled else None
        bias = (0.1 * rand(cout)).to(cast) if biased else None
        out = rand(b, d, h, w, cout).to(cast) if accum else None
        K.reset_launches()
        with torch.no_grad():
            got = K._launch(x, k, style, bias, None if out is None else out.clone(), input_grad,
                            unsharded)
        ran = {v for v, n in K.variant_launches.items() if n}
        if (K.launches, K.dtype_launches[dtype]) != (1, 1) or not ran <= variants:
            fail(f"{what}: launched {dict(K.dtype_launches)} on {ran}")
        ref = K.conv3d_plain(x, k, style, bias, None if out is None else out.clone())
        if bf16:
            worst = max(worst, bf16_check(got, ref, what))
        else:
            torch.cuda.synchronize()
            err = (got - ref).abs().max().item()
            if not err <= CONV_RTOL * ref.abs().max().item():
                fail(f"{what}: max abs err {err} > {CONV_RTOL} of the plain version's scale")
            worst = max(worst, err)
        whole = torch.empty((unsharded[0], d, unsharded[1], w, cin), dtype=cast, device=DEV)
        n_split, n_whole = K.plan(3, x, d, cout, unsharded)[1], K.plan(3, whole, d, cout)[1]
        if n_split != n_whole:
            fail(f"{what}: split count {n_split}, the unsharded call's {n_whole}")
        heights.add(h)
        splits.add(n_split)
    n_in = sum(1 for launch, _ in shapes if launch[0])
    bar = "one bf16 step" if bf16 else f"{CONV_RTOL} of scale"
    print(f"[mesh] {label} {dtype} train launches: {len(shapes)} distinct K1 launches over the "
          f"ranks' first eager steps and compiled calls ({len(shapes) - n_in} forward, {n_in} "
          f"input gradient; x heights {sorted(heights)}) relaunched with their unsharded "
          f"(B, H): each within {bar} of its plain version (largest |err| {worst:.3g}), on a "
          f"{dtype} tensor-core variant, at the unsharded call's split count (counts "
          f"{sorted(splits)})", flush=True)
    return {"launches": len(shapes), "input_grad": n_in, "max_abs_err": worst}


# (preset, bands, sensors, --mesh-space) of the meshed serve cases: JAX's
# default of every rank on "data" for both presets, then the quality preset
# with the height over two ranks
MESH_SERVE_CASES = (("serve_lowlatency.json", 4, ("QB", "GF2"), 1),
                    ("serve_quality.json", 8, ("WV2", "WV3"), 1),
                    ("serve_quality.json", 8, ("WV2", "WV3"), 2))


def mesh_serve_client(port, reqs, got):
    """Rank 0's client thread: waits for /healthz, posts `reqs` at once,
    reads /v1/stats, then sends SIGINT to its own process (the server's
    stop, as an operator's); what it saw goes into `got`."""
    import urllib.error

    base = f"http://127.0.0.1:{port}"
    t0 = time.perf_counter()
    try:
        while True:
            try:
                if http_get(base, "/healthz") == {"ok": True}:
                    break
            except (urllib.error.URLError, ConnectionError, OSError):
                pass
            if time.perf_counter() - t0 > HTTP_START_TIMEOUT:
                got["error"] = f"not healthy within {HTTP_START_TIMEOUT} s"
                return
            time.sleep(0.5)
        got["ready_s"] = time.perf_counter() - t0
        got["replies"], got["wall_s"], got["stats"] = post_all(base, reqs)
    except Exception as err:  # reported by the parent, which fails the run
        got["error"] = repr(err)
    finally:
        os.kill(os.getpid(), signal.SIGINT)


def mesh_serve_worker(cases):
    """One rank of the mesh phase's serve cases: `python -m
    tmdiff_tpu_torch.serve`'s main() on every rank of this world, a case
    after another ((argv, port, requests)), each with the launch counts
    reset before it; rank 0 also runs `mesh_serve_client`. Returns per case
    this rank's serve/mesh.py stats and launch counts (and rank 0's
    client's results)."""
    import threading

    import torch.distributed as dist

    from tmdiff_tpu_torch.ops.cuda import conv2d as K3
    from tmdiff_tpu_torch.ops.cuda import conv3d as K
    from tmdiff_tpu_torch.ops.cuda import flash_attention as K4
    from tmdiff_tpu_torch.serve import __main__ as serve_main

    out = []
    for argv, port, reqs in cases:
        for mod in (K, K3, K4):
            mod.reset_launches()
        got = {}
        client = None
        if dist.get_rank() == 0:
            client = threading.Thread(target=mesh_serve_client, args=(port, reqs, got),
                                      daemon=True)
            client.start()
        stats = serve_main.main(argv)
        if client is not None:
            client.join(timeout=60)
        out.append({"mesh": stats, "launches": serve_main.launch_counts(), **got})
    return out


def mesh_serve_phase(ckpt, root, served, rng):
    """The meshed server (serve/mesh.py) on MESH_RANKS gloo ranks sharing
    card 0 (parallel/dryrun.py), each running `python -m
    tmdiff_tpu_torch.serve`'s main(): every MESH_SERVE_CASES case, 16
    concurrent requests through HTTP after the preset's warm-up, then
    SIGINT; every rank's launches bf16 on the tensor cores and as many
    batches as rank 0; each image against the one-process replay at its
    placement to BF16_SAMPLE_ATOL; img/s and p50/p99 beside the http
    phase's one-card figures (`served`). With MESH_RANKS cards visible the
    same cases under NCCL through torchrun, a card a rank."""
    from tmdiff_tpu_torch.models.wavbest import WavBEST
    from tmdiff_tpu_torch.parallel.dryrun import run_world
    from tmdiff_tpu_torch.pipeline import Pansharpener
    from tmdiff_tpu_torch.serve import __main__ as serve_main

    repo = os.path.dirname(os.path.abspath(__file__))
    presets = os.path.join(repo, "tmdiff_tpu_torch", "config", "presets")
    direct = Pansharpener(WavBEST(CHANNELS, device=DEV, seed=SEED, dtype=torch.bfloat16),
                          device=DEV)
    cases = []
    for preset, bands, sensors, space in MESH_SERVE_CASES:
        port = free_port()
        # (parsed in this process without --mesh-space, which needs a world)
        argv = ["-c", os.path.join(presets, preset), "--ckpt", ckpt, "--host", "127.0.0.1",
                "--port", str(port)]
        cases.append((preset, bands, sensors, space, argv + ["--mesh-space", str(space)], port,
                      preset_requests(rng, bands, sensors), serve_main.prepare(argv)))
    out = {}
    t0 = time.perf_counter()
    ranks = run_world("chip_smoke:mesh_serve_worker", MESH_RANKS,
                      ([(argv, port, reqs) for *_, argv, port, reqs, _ in cases],),
                      device="cuda:0", backend="gloo", threads=2, timeout=MESH_TIMEOUT)
    print(f"[mesh] serve: {len(cases)} servers on one {MESH_RANKS}-rank gloo world in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for i, (preset, bands, sensors, space, argv, port, reqs, parsed) in enumerate(cases):
        label = f"gloo {preset} on ({MESH_RANKS // space}, {space})"
        lead = ranks[0][i]
        if "error" in lead:
            fail(f"{label}: {lead['error']}")
        args, _, sampler_kw = parsed
        for r in ranks:
            check_bf16_launches(label, r[i]["launches"])
        per_rank = [(r[i]["mesh"]["batches"], r[i]["launches"]["conv3d"]["launches"])
                    for r in ranks]
        if len({b for b, _ in per_rank}) != 1 or any(r[i]["mesh"]["failed_batches"]
                                                      for r in ranks):
            fail(f"{label}: batches per rank {[r[i]['mesh'] for r in ranks]}")
        max_err, batches = replay_error(label, reqs, lead["replies"], direct, args, sampler_kw)
        result = {"mesh": [MESH_RANKS // space, space], "sampler": args.sampler,
                  **latency_summary(lead["replies"], lead["wall_s"]),
                  "ready_s": lead["ready_s"], "batches": batches, "max_abs_err": max_err,
                  "k1_per_rank": [n for _, n in per_rank], "stats": lead["stats"]}
        one = (served or {}).get(preset)
        beside = ("not run in this call" if one is None else
                  f"{one['img_per_s']:.2f} img/s, p50 {one['p50_ms']:.1f} p99 "
                  f"{one['p99_ms']:.1f} ms")
        print(f"[mesh] serve {label}: sampler {args.sampler} steps {args.steps} bf16, "
              f"{bands} bands {SIZE}x{SIZE}; healthy {lead['ready_s']:.1f} s after start "
              f"(warm-up {args.warmup}); {HTTP_REQUESTS} concurrent requests in "
              f"{lead['wall_s']:.3f} s = {result['img_per_s']:.2f} img/s; latency ms p50 "
              f"{result['p50_ms']:.1f} p99 {result['p99_ms']:.1f} (all: "
              f"{result['latency_ms']}); one card (http phase): {beside}; batches (seed, "
              f"bucket) {batches}, per rank (batches, K1 launches) {per_rank}, every launch "
              f"bf16 on the tensor cores; /v1/stats {json.dumps(lead['stats'])}; images vs the "
              f"one-process replay max abs err {max_err:.3g} (atol {BF16_SAMPLE_ATOL})",
              flush=True)
        if max_err > BF16_SAMPLE_ATOL:
            fail(f"{label}: served images differ from their replays by {max_err}")
        out[label] = {k: v for k, v in result.items() if k != "latency_ms"}
    if torch.cuda.device_count() >= MESH_RANKS:
        for preset, bands, sensors, space, argv, port, _, (args, _, sampler_kw) in cases:
            label = f"[mesh] serve nccl ({MESH_RANKS // space}, {space})"
            argv = list(argv)
            argv[argv.index("--port") + 1] = str(port := free_port())
            log_path = os.path.join(root, f"torchrun_{os.path.basename(preset)}_{space}.log")
            with open(log_path, "w") as log:
                proc = subprocess.Popen(
                    [sys.executable, "-m", "torch.distributed.run", "--standalone",
                     "--nproc-per-node", str(MESH_RANKS), "-m", "tmdiff_tpu_torch.serve",
                     *argv], stdout=log, stderr=subprocess.STDOUT, cwd=repo)
            try:
                ready = wait_healthy(f"http://127.0.0.1:{port}", proc, log_path,
                                     HTTP_START_TIMEOUT)
                args.port = port
                result = http_preset(preset, bands, sensors, args, sampler_kw, log_path, proc,
                                     direct, rng, ready, atol=BF16_SAMPLE_ATOL, label=label)
            finally:
                stop_server(proc)
            if result["ranks"] != MESH_RANKS:
                fail(f"{label} {preset}: {result['ranks']} launch reports")
            out[f"nccl {preset} on ({MESH_RANKS // space}, {space})"] = result
    else:
        print(f"[mesh] serve under NCCL: {torch.cuda.device_count()} card(s) visible, "
              f"{MESH_RANKS} needed", flush=True)
    return out


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
    took = {}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        took[name] = round(time.perf_counter() - t0, 1)
        return out

    timed("build", build_phase, build)
    if "--mesh-only" in sys.argv[1:]:
        # the mesh phase alone (for a call on several cards); no summary line
        mesh_root = tempfile.mkdtemp(prefix="tmdiff_mesh_")
        try:
            print(json.dumps({"mesh": timed("mesh", mesh_phase, K, mesh_root), "took": took}))
        finally:
            shutil.rmtree(mesh_root, ignore_errors=True)
        print(smi)
        return 0
    gen = torch.Generator(device=DEV).manual_seed(SEED)
    model = WavBEST(CHANNELS, device=DEV, seed=SEED)
    k1_totals, k1_err = timed("kernel", kernel_phase, model, K, modconv, gen)
    timed("accumulation", accumulation_phase, K, gen)
    k3_totals, k3_err = timed("conv2d", conv2d_phase, model, K3, modconv, gen)
    timed("model", model_phase, model, K, gen)
    k1_launches, k1_variants, banded_results = timed("serve", serve_phase, model, K, SEED)
    if k1_launches == 0:
        fail("the main path launched no conv3d kernel")
    auto_counts = timed("auto", auto_serve_phase, model, K, K3, K4, banded_results, SEED)
    bf16_totals, bf16_requests = timed("bf16", bf16_phase, K, K3, modconv, gen, banded_results,
                                       SEED)
    http_root = tempfile.mkdtemp(prefix="tmdiff_http_")
    try:
        served = timed("http", http_phase, SEED, http_root)
    finally:
        shutil.rmtree(http_root, ignore_errors=True)
    samplers, sampler_hold = timed("samplers", samplers_phase, model, K, K3, K4, modconv, SEED)
    k4 = timed("attention", attention_phase, K4, gen)
    k4_totals, k4_err, k4_launches, k4_variants = k4["float32"]
    k4b_totals, k4b_err, k4b_launches, k4b_variants = k4["bfloat16"]
    timed("library", library_phase)
    train = timed("train", train_phase, K, K3, K4, modconv, gen)
    root = tempfile.mkdtemp(prefix="tmdiff_cli_")
    try:
        cli = timed("cli", cli_phase, K, K3, K4,
                    {b: g["median_s"] for b, g in train["graphed"].items()}, root)
        distill = timed("distill", distill_phase, K, K3, K4, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    controlnet = timed("controlnet", controlnet_phase, K, modconv, gen)
    # the bf16 controlnet phase's plain batch-8 forwards leave tens of GB
    # cached; the mesh phase's ranks share this card
    torch.cuda.empty_cache()
    mesh_root = tempfile.mkdtemp(prefix="tmdiff_mesh_")
    try:
        meshed = timed("mesh", mesh_phase, K, mesh_root, served)
    finally:
        shutil.rmtree(mesh_root, ignore_errors=True)
    print(f"[done] all phases in {time.perf_counter() - t_start:.1f} s; seconds by phase "
          f"{took}", flush=True)

    per_request = (f"summed over the launches of one dpm++ request, 8 bands, batch {BATCH}, "
                   f"{SIZE}x{SIZE}, full width")
    bf16_entry = lambda name, totals, launches: {
        "route": "cuda", "source": "tmdiff_tpu_torch/csrc/conv3d.cu", "launches": launches,
        "max_abs_err": totals["max_abs_err"], "ms": totals["ms"], "plain_ms": totals["plain_ms"],
        "bound_ms": totals["bound_ms"], "bound_by": totals["bound_by"],
        "library_ms": totals["library_ms"], "peak_flops": PEAK_BF16_FLOPS,
        "times_are": per_request + f' in bf16 through the "{name}" model (library: the bf16 '
                                   "library conv)",
        "requests": bf16_requests,
        "http": {p: {k: v for k, v in r.items() if k != "stats"} for p, r in served.items()}}
    kernels = [
        {"name": "conv3d_333", "route": "cuda", "source": "tmdiff_tpu_torch/csrc/conv3d.cu",
         "replaces": "tmdiff_tpu/ops/pallas/banded_conv3d.py:101",
         "replaces_also": "tmdiff_tpu/ops/pallas/banded_conv3d.py:182",
         "launches": k1_launches, "variant_launches": k1_variants,
         "launches_auto": auto_counts["K1"], "max_abs_err": k1_err,
         "ms": k1_totals["ms"], "plain_ms": k1_totals["plain_ms"],
         "bound_ms": k1_totals["bound_ms"], "bound_by": k1_totals["bound_by"],
         "library_ms": k1_totals["library_ms"],
         "times_are": per_request + ' through the "banded" model',
         "train_launches": train["counts"],
         "train_launches_are": f"over {TRAIN_STEPS} training steps of batch {TRAIN_BATCH} "
                               f"{TRAIN_SIZE}x{TRAIN_SIZE}, full width, remat on",
         "train_input_grad": {k: train["input_grad"][k] for k in
                              ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
                               "weight_grad_ms", "weight_grad_library_ms",
                               "weight_grad_bound_ms", "weight_grad_err_of_scale")},
         "train_input_grad_max_abs_err": train["input_grad_err"],
         "train_grad_max_err_of_scale": train["grad_err"],
         "train_step": {f"{b}_band": {k: v for k, v in tm.items()
                                      if k not in ("steps_s", "top_kernels_ms",
                                                   "top_host_ms")}
                        for b, tm in train["timing"].items()},
         "train_step_graphed": {f"{b}_band": g for b, g in train["graphed"].items()},
         "train_step_graphed_is": f"Trainer.compiled_step, one CUDA graph of the whole step "
                                  f"per band count, against train_step from one start: "
                                  f"replay_k1 is the K1 kernels one replay ran on the card",
         "cli_launches": cli["launches"],
         "cli_launches_are": f"over the CLI's train run: {CLI_MAX_ITER} steps of batch "
                             f"{TRAIN_BATCH} {TRAIN_SIZE}x{TRAIN_SIZE} and two validations of "
                             f"{CLI_VAL_SCENES} {CLI_VAL_SIZE}x{CLI_VAL_SIZE} scenes a sensor",
         "cli": {k: cli[k] for k in ("s_per_step", "img_per_s", "sec_per_image",
                                      "checkpoint_bytes", "save_s", "restore_s", "captures",
                                      "replay_k1")},
         "sampler_launches": {label: r["k1_launches"] for label, r in samplers.items()},
         "sampler_launches_are": "per request of the samplers phase (NFE and seconds beside "
                                 "each in its [samplers] line)",
         "sampler_shapes_max_err_of_scale": sampler_hold["K1"],
         "distill_launches": distill["launches"],
         "distill_launches_are": f"over the CLI's -p distill run: phases {list(DISTILL_PHASES)} "
                                 f"of {DISTILL_STEPS} steps of batch {TRAIN_BATCH} "
                                 f"{TRAIN_SIZE}x{TRAIN_SIZE} and a ddim validation a phase",
         "distill_s_per_step": distill["s_per_step"],
         "distill_compiled": {k: distill[k] for k in ("captures", "replay_k1")},
         "distill_grad_max_err_of_scale": distill["grad_err"],
         "controlnet": controlnet,
         "controlnet_is": f"the legacy models at full width, 8-band batch {BATCH} "
                          f"{SIZE}x{SIZE}: forwards, a {CONTROL_STEPS}-step ddim request and "
                          "a fine-tune step; k1 is the K1 launches of each",
         "mesh": meshed,
         "mesh_is": f"{MESH_RANKS} ranks on one card per world (gloo through host memory; "
                    f"nccl: one card a rank where {MESH_RANKS} are visible); k1_per_rank is "
                    f"rank 0's K1 launches per request"},
        {"name": "conv3x3_nhwc", "route": "cuda", "source": "tmdiff_tpu_torch/csrc/conv3d.cu",
         "replaces": "tmdiff_tpu/ops/pallas/conv2d.py:43",
         "launches": auto_counts["K3"], "variant_launches": auto_counts["K3_variants"],
         "max_abs_err": k3_err,
         "ms": k3_totals["ms"], "plain_ms": k3_totals["plain_ms"],
         "bound_ms": k3_totals["bound_ms"], "bound_by": k3_totals["bound_by"],
         "library_ms": k3_totals["library_ms"],
         "times_are": per_request + ' through the "auto" model',
         "sampler_launches": {label: r["k3_launches"] for label, r in samplers.items()
                              if r["k3_launches"]},
         "sampler_shapes_max_err_of_scale": sampler_hold["K3"]},
        {"name": "flash_attention", "route": "cuda",
         "source": "tmdiff_tpu_torch/csrc/flash_attention.cu",
         "replaces": "tmdiff_tpu/ops/pallas/flash_attention.py:80",
         "launches": k4_launches, "variant_launches": k4_variants, "max_abs_err": k4_err,
         "ms": k4_totals["ms"], "plain_ms": k4_totals["plain_ms"],
         "bound_ms": k4_totals["bound_ms"], "bound_by": k4_totals["bound_by"],
         "library_ms": k4_totals["library_ms"],
         "times_are": f"summed over the two attentions of one SpatialTransformer forward, "
                      f"batch {BATCH}, 64x64x256, 8 heads x 64"},
        {"name": "flash_attention_bf16", "route": "cuda",
         "source": "tmdiff_tpu_torch/csrc/flash_attention.cu",
         "replaces": "tmdiff_tpu/ops/pallas/flash_attention.py:80",
         "launches": k4b_launches, "variant_launches": k4b_variants, "max_abs_err": k4b_err,
         "ms": k4b_totals["ms"], "plain_ms": k4b_totals["plain_ms"],
         "bound_ms": k4b_totals["bound_ms"], "bound_by": k4b_totals["bound_by"],
         "library_ms": k4b_totals["library_ms"], "peak_flops": PEAK_BF16_FLOPS,
         "times_are": f"summed over the two attentions of one bf16 SpatialTransformer "
                      f"forward, batch {BATCH}, 64x64x256, 8 heads x 64 (library: bf16 SDPA)"},
        {"name": "conv3d_333_bf16", "replaces": "tmdiff_tpu/ops/pallas/banded_conv3d.py:101",
         "replaces_also": "tmdiff_tpu/ops/pallas/banded_conv3d.py:182",
         **bf16_entry("banded", bf16_totals["conv3d"], bf16_requests["banded"]["K1"]),
         "train_launches": train["bf16"]["counts"],
         "train_launches_are": f"per bf16 training step of batch {TRAIN_BATCH} "
                               f"{TRAIN_SIZE}x{TRAIN_SIZE}, full width, remat on",
         "train_input_grad": {k: train["bf16"]["input_grad"][k] for k in
                              ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
                               "weight_grad_ms", "weight_grad_bound_ms",
                               "weight_grad_err_of_scale")},
         "train_input_grad_max_abs_err": train["bf16"]["input_grad_max_abs_err"],
         "train_step_8_band": {k: v for k, v in train["bf16"]["timing"].items()
                               if k not in ("steps_s", "top_kernels_ms", "top_host_ms")},
         "train_step_fp32_median_s": train["bf16"]["fp32_median_s"],
         "train_grad_worst_gap_own_to_fp32": train["bf16"]["grad_worst_gap_own_to_fp32"],
         "train_forward_gap_to_served": train["bf16"]["forward_gap"],
         "train_step_graphed": {f"{b}_band": g for b, g in train["bf16"]["graphed"].items()},
         "controlnet": controlnet["bf16"],
         "controlnet_is": f"the legacy models in bf16: forwards at 8-band batch "
                          f"{CONTROL_BF16_BATCH} {SIZE}x{SIZE} (forward_convs: the controlled "
                          f"forward's K1 launches, each timed alone), a {CONTROL_STEPS}-step "
                          f"ddim and a fine-tune step at batch {BATCH}"},
        {"name": "conv3x3_nhwc_bf16", "replaces": "tmdiff_tpu/ops/pallas/conv2d.py:43",
         **bf16_entry("auto", bf16_totals["conv3x3_nhwc"], bf16_requests["auto"]["K3"])},
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
