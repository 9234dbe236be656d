"""The convs of the legacy UNet and the ControlNet hint encoder that are no
TPU kernel's function. The JAX package runs each through XLA's conv, with no
Pallas kernel, so the port runs them through PyTorch's own conv (cuDNN on
the card) rather than widening the 3x3x3 kernel's entry (ops/modconv.py
takes 1x1x1 and SAME stride-1 3x3x3 kernels only):

  * "strided": 3x3x3, stride (1, 2, 2), padding (1, 0, 0): SAME over the
    bands, VALID in space (tmdiff_tpu/models/legacy_blocks.py:36-42,
    StridedDownStage's `down`);
  * "transposed": the transposed 3x3x3 conv of stride (1, 2, 2), padding
    (1, 0, 0) and output padding (0, 1, 1), torch's ConvTranspose3d; the
    JAX package's `lax.conv_transpose(h, kernel.swapaxes(-1, -2),
    padding=((1, 1), (2, 3), (2, 3)), transpose_kernel=True)`
    (legacy_blocks.py:54-76, TransposedUpStage's `up_kernel`);
  * "hint": (1, 3, 3), SAME, stride 1, on a depth-1 input (the hint
    encoder's stems and `share0-3`, tmdiff_tpu/models/controlnet.py:215-241,
    which the JAX package folds to a 2-D XLA conv).

Activations are (B, D, H, W, C) and kernels (kd, kh, kw, Cin, Cout) as
everywhere in the port. Each conv runs in x's dtype, float32 or bfloat16
(the weight and bias are cast to it): the forward and the backward with
TF32 off and cuDNN's deterministic algorithms (an autograd Function sets
the flags for both), as the weight gradient of ops/cuda/conv3d.py does; in
bf16 cuDNN accumulates in fp32 and rounds each result once. The bias is
added after the conv, in x's dtype, as the JAX package adds it (flax's
Conv, `out + bias.astype(out.dtype)` of the transposed conv, the hint
stems): in bf16 that is a second rounding, as there (aten's cuDNN route
adds a given bias after the conv too). `calls` counts the forward calls by
kind on every device, for the smoke run's report beside K1's launches.
`library_conv3d_rows` runs a conv of a kind with one kernel per batch row
(the ControlNet hint encoder's task-routed stems) as one grouped conv, the
batch folded into the groups.

`conv_nd` is XLA's conv_general_dilated for the library modules that reach
no TPU kernel (ops/dynamic_conv.py, ops/pgcu.py, utils/image_ops.py) and
for every conv of ops/modconv.py's API that is not a SAME stride-1 3x3x3 or
1x1x1 kernel: channels-last, a flax-layout kernel, XLA's "SAME"/"VALID" or
explicit padding, a stride per axis and feature groups, under the same
flags, forward and backward. `conv_transpose_nd` is lax.conv_transpose
with transpose_kernel=False (modconv.modulated_conv_transpose3d), through
`conv_nd` on the stride-dilated input (`dilate`, `transpose_padding`; on a
space-split mesh ops/modconv.py splits both over the height's shards).
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F

KINDS = {
    # kind: (kernel size, stride, padding, transposed, output padding)
    "strided": ((3, 3, 3), (1, 2, 2), (1, 0, 0), False, (0, 0, 0)),
    "transposed": ((3, 3, 3), (1, 2, 2), (1, 0, 0), True, (0, 1, 1)),
    "hint": ((1, 3, 3), (1, 1, 1), (0, 1, 1), False, (0, 0, 0)),
}
calls = dict.fromkeys(KINDS, 0)


def reset_calls() -> None:
    calls.update(dict.fromkeys(calls, 0))


def cudnn_fp32():
    """cuDNN with TF32 off (an fp32 conv stays fp32; a bf16 one takes bf16
    operands with fp32 accumulation) and its deterministic algorithms: the
    flags every library conv of the port runs under, in either dtype."""
    return torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=True,
                                      allow_tf32=False)


def widen_on_cpu(*tensors):
    """bf16 CPU operands (None allowed) as their exact fp32 values, others as
    given. PyTorch's CPU convs do not take a bf16 conv as one rounding of
    fp32 sums: oneDNN's bf16 weight gradient of a 3-D conv was off by half
    its scale at the hint trunk's shape (96 -> 256 channels, 32x32; NaN on
    other operands) and the native path's forward strays beyond one
    rounding, so on the CPU a bf16 conv runs in fp32 on the bf16 values and
    its result is rounded once: what cuDNN computes on the card."""
    t0 = tensors[0]
    if t0.device.type != "cpu" or t0.dtype != torch.bfloat16:
        return tensors
    return tuple(None if t is None else t.float() for t in tensors)


class _Conv(torch.autograd.Function):
    """aten.convolution of an NCDHW x and a torch-layout weight (no bias)
    in `groups` feature groups, and its backward, both under
    `cudnn_fp32`."""

    @staticmethod
    def forward(ctx, x, weight, kind, groups=1):
        _, stride, padding, transposed, out_pad = KINDS[kind]
        ctx.save_for_backward(x, weight)
        ctx.kind, ctx.groups = kind, groups
        with cudnn_fp32():
            y = torch.ops.aten.convolution(*widen_on_cpu(x, weight), None, stride, padding,
                                           [1, 1, 1], transposed, out_pad, groups)
        return y.to(x.dtype)

    @staticmethod
    def backward(ctx, dy):
        x, weight = ctx.saved_tensors
        _, stride, padding, transposed, out_pad = KINDS[ctx.kind]
        need_x, need_w = ctx.needs_input_grad[:2]
        with cudnn_fp32():
            dx, dw, _ = torch.ops.aten.convolution_backward(
                *widen_on_cpu(dy, x, weight), None, stride, padding, [1, 1, 1], transposed,
                out_pad, ctx.groups, [need_x, need_w, False])
        cast = lambda g: None if g is None else g.to(x.dtype)
        return cast(dx), cast(dw), None, None


def library_conv3d(x, kernel, bias=None, *, kind: str):
    """The conv `kind` (module doc) of x (B, D, H, W, Cin) with kernel
    (kd, kh, kw, Cin, Cout), plus bias: (B, D', H', W', Cout) in x's
    dtype."""
    size = KINDS[kind][0]
    if tuple(kernel.shape[:3]) != size or kernel.shape[3] != x.shape[-1]:
        raise ValueError(f'a "{kind}" conv takes a {size + (x.shape[-1],)} + (Cout,) kernel, '
                         f"got {tuple(kernel.shape)}")
    # torch's weight layouts: (Cout, Cin, k...) for a conv, (Cin, Cout, k...)
    # for a transposed one
    order = (3, 4, 0, 1, 2) if KINDS[kind][3] else (4, 3, 0, 1, 2)
    dt = x.dtype
    y = _Conv.apply(x.permute(0, 4, 1, 2, 3), kernel.to(dt).permute(order), kind)
    calls[kind] += 1
    y = y.permute(0, 2, 3, 4, 1).contiguous()
    return y if bias is None else y + bias.to(dt)


def library_conv3d_rows(x, kernels, bias=None, *, kind: str):
    """The conv `kind` (not "transposed") of each row of x (B, D, H, W, Cin)
    with its own kernel, `kernels` (B, kd, kh, kw, Cin, Cout), plus its own
    bias (B, Cout): (B, D', H', W', Cout) in x's dtype. One grouped conv:
    the rows are folded into the channels, row b's kernel is group b."""
    size = KINDS[kind][0]
    b, cin = x.shape[0], x.shape[-1]
    if KINDS[kind][3]:
        raise ValueError("library_conv3d_rows takes no transposed kind")
    if tuple(kernels.shape[1:4]) != size or kernels.shape[0] != b or kernels.shape[4] != cin:
        raise ValueError(f'a "{kind}" conv of rows takes ({b},) + {size + (cin,)} + (Cout,) '
                         f"kernels, got {tuple(kernels.shape)}")
    dt = x.dtype
    folded = x.permute(0, 4, 1, 2, 3).reshape(1, b * cin, *x.shape[1:4])
    # (B, kd, kh, kw, Cin, Cout) -> (B Cout, Cin, kd, kh, kw): group b's block is row b's kernel
    weight = kernels.to(dt).permute(0, 5, 4, 1, 2, 3).reshape(-1, cin, *size)
    y = _Conv.apply(folded, weight, kind, b)
    calls[kind] += 1
    y = y.reshape(b, -1, *y.shape[2:]).permute(0, 2, 3, 4, 1).contiguous()
    return y if bias is None else y + bias.to(dt)[:, None, None, None, :]


def per_axis(v, rank: int) -> tuple:
    return (int(v),) * rank if isinstance(v, int) else tuple(int(a) for a in v)


def xla_padding(padding, spatial: Sequence[int], kernel: Sequence[int], stride=1):
    """XLA's "SAME" / "VALID" (or explicit (lo, hi) pairs) as (lo, hi) per
    spatial axis; `stride` an int or one per axis. SAME at stride s gives
    ceil(n / s) outputs and puts the odd pixel of the padding after."""
    if padding == "VALID":
        return [(0, 0)] * len(spatial)
    if padding == "SAME":
        pads = []
        for n, k, s in zip(spatial, kernel, per_axis(stride, len(spatial))):
            total = max((-(-n // s) - 1) * s + k - n, 0)
            pads.append((total // 2, total - total // 2))
        return pads
    return [tuple(p) for p in padding]


class _ConvND(torch.autograd.Function):
    """aten.convolution of a channels-first h (already padded) with a
    torch-layout weight, no bias, and its backward, both under
    `cudnn_fp32`, in w's dtype. h may hold w's bf16 values in float32 (a
    space shard's halo, ops/modconv.py): the conv then runs on them in
    bf16, and h's gradient comes back in float32, unrounded (a float32 conv
    of the bf16 values), so that its halo rows' parts add up before the one
    rounding that one process makes."""

    @staticmethod
    def forward(ctx, h, w, stride, groups):
        ctx.save_for_backward(h, w)
        ctx.stride, ctx.groups = stride, groups
        rank = w.dim() - 2
        with cudnn_fp32():
            y = torch.ops.aten.convolution(*widen_on_cpu(h.to(w.dtype), w), None, stride,
                                           [0] * rank, [1] * rank, False, [0] * rank, groups)
        return y.to(w.dtype)

    @staticmethod
    def backward(ctx, dy):
        h, w = ctx.saved_tensors
        rank = w.dim() - 2
        need_h, need_w = ctx.needs_input_grad[:2]
        wide = need_h and h.dtype != w.dtype
        args = (None, ctx.stride, [0] * rank, [1] * rank, False, [0] * rank, ctx.groups)
        with cudnn_fp32():
            dh, dw, _ = torch.ops.aten.convolution_backward(
                *widen_on_cpu(dy.contiguous(), h.to(w.dtype), w), *args,
                [need_h and not wide, need_w, False])
            if wide:
                dh = torch.ops.aten.convolution_backward(
                    dy.to(h.dtype).contiguous(), h, w.to(h.dtype), *args, [True, False, False])[0]
        cast = lambda g, t: None if g is None else g.to(t.dtype)
        return cast(dh, h), cast(dw, w), None, None


def conv_nd(x, kernel, stride=1, padding="SAME", groups: int = 1, dtype=None):
    """XLA's conv_general_dilated on channels-last x (B, *spatial, Cin) with
    a flax-layout kernel (*kernel_size, Cin / groups, Cout): `stride` an int
    or one per spatial axis, `padding` "SAME", "VALID" or (lo, hi) pairs
    (negative ones crop); in x's dtype, or in `dtype` (bfloat16) on a
    float32 x that holds its values (x's gradient then comes back in
    float32, see _ConvND), forward and backward under `cudnn_fp32`."""
    rank = kernel.dim() - 2
    stride = per_axis(stride, rank)
    pads = xla_padding(padding, x.shape[1:-1], kernel.shape[:rank], stride)
    h = x.movedim(-1, 1)
    flat = [p for lo_hi in reversed(pads) for p in lo_hi]  # F.pad: last axis first
    if any(flat):
        h = F.pad(h, flat)
    w = kernel.to(dtype or x.dtype).permute(rank + 1, rank, *range(rank))
    return _ConvND.apply(h, w, list(stride), groups).movedim(1, -1)


def _transpose_padding(k: int, s: int, padding) -> tuple:
    """lax.conv_transpose's (lo, hi) padding of the stride-dilated input on
    one axis for "SAME" or "VALID" (of the forward conv it transposes)."""
    if padding == "SAME":
        total = k + s - 2
        lo = k - 1 if s > k - 1 else -(-total // 2)
    else:
        total = k + s - 2 + max(k - s, 0)
        lo = k - 1
    return lo, total - lo


def transpose_padding(kernel_size, stride, padding) -> list:
    """lax.conv_transpose's (lo, hi) padding of the stride-dilated input on
    each spatial axis: "SAME" or "VALID" (of the forward conv it
    transposes), or explicit (lo, hi) pairs as given."""
    if isinstance(padding, str):
        if padding not in ("SAME", "VALID"):
            raise ValueError(f"unknown padding {padding!r}")
        return [_transpose_padding(k, s, padding) for k, s in zip(kernel_size, stride)]
    return [tuple(p) for p in padding]


def dilate(x, stride, trailing=()):
    """Channels-last x (B, *spatial, C) with s - 1 zeros between elements of
    each spatial axis of stride s; on the axes in `trailing` (spatial axis
    numbers) also after the last one, so that a space shard dilates to its
    part of the dilated image."""
    if all(s == 1 for s in stride):
        return x
    size = [n * s if i in trailing else (n - 1) * s + 1
            for i, (n, s) in enumerate(zip(x.shape[1:-1], stride))]
    dilated = x.new_zeros((x.shape[0], *size, x.shape[-1]))
    dilated[(slice(None), *(slice(None, None, s) for s in stride))] = x
    return dilated


def conv_transpose_nd(x, kernel, stride=1, padding="SAME"):
    """lax.conv_transpose(x, kernel, stride, padding) with transpose_kernel
    False on channels-last x (B, *spatial, Cin) and a flax-layout kernel
    (*kernel_size, Cin, Cout), not flipped: x dilated by the stride (s - 1
    zeros between elements), padded ("SAME" / "VALID" as lax.conv_transpose
    pads them, or explicit (lo, hi) pairs of the dilated input), then a
    stride-1 `conv_nd`. In x's dtype; autograd differentiates the dilation
    and the conv."""
    rank = kernel.dim() - 2
    stride = per_axis(stride, rank)
    pads = transpose_padding(kernel.shape[:rank], stride, padding)
    return conv_nd(dilate(x, stride), kernel, 1, pads)
