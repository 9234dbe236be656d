"""SAME, stride-1 3x3x3 band-as-depth convolution: the CUDA kernel's wrapper
and its plain PyTorch version.

Both compute, for x (B, D, H, W, Cin), kernel (3, 3, 3, Cin, Cout), an
optional per-sample style s (B, Cin), an optional bias (Cout) and an
optional pre-activation of the input, act="silu" with an optional shift
(B, Cin) (a shift without the SiLU is refused),

    a = silu(x + shift[:, None, None, None, :])   (a = x without it)
    y = conv3d_same(a * s[:, None, None, None, :], kernel) + bias

with fp32 accumulation and the SAME zero padding applied to `a` (after the
activation). Given `out`, the result is added into `out` in place
(one launch per part of a channel concat, without materialising the concat).
Every tensor is float32, or every tensor is bfloat16. In bf16 they compute
what the Pallas kernel computes for bf16 operands: x * s rounded to bf16
once (the JAX package's `x * style.astype(x.dtype)`), the weight in bf16,
fp32 accumulation, and the bias and `out` added to the fp32 sum before one
rounding to bf16 (the JAX package adds them after the conv, in bf16: a
deliberate divergence of at most a rounding step).

`banded_conv3d` replaces the Pallas TPU kernel
`tmdiff_tpu/ops/pallas/banded_conv3d.py::banded_conv3d` and
`banded_conv3d_v2` its second entry point of the same function; both launch
the kernel of `tmdiff_tpu_torch/csrc/conv3d.cu` with three depth taps (its
header says what bounds it on an H100 and how it is tiled). The C entry
picks the kernel's variant by shape: the 3xTF32 tensor-core kernel where
Cin % 4 == 0 (with split-K where the output tiles underfill the card),
else the fp32 FMA kernel; in bf16 the bf16 tensor-core kernel (with the
same split-K rule) where Cin % 8 == 0, and every other bf16 shape raises.
`variant_launches` counts the launches of each variant, `dtype_launches`
those of each dtype. On a CPU tensor they compute the plain version; on a
CUDA tensor they launch the kernel or raise.

The pre-activation is applied in the bf16 kernel's operand pass, as it
stages each input halo (beside the style), where x is bf16 on a CUDA device
and no gradient is needed: the launch counts in `preact_fused`, and
x + shift and its SiLU are never written to device memory. Everywhere else
(float32, a gradient, the CPU) `preact` computes a with the PyTorch ops the
model used before, x + shift in x's dtype then F.silu, and the conv runs on
it unchanged; `preact_unfused` counts those calls. Both routes round at the
same three points in bf16 (the add, the SiLU, the style product); the
kernel's SiLU (the MUFU's ex2 and rcp) is within a bf16 step of F.silu's,
so an operand element of the fused launch is the unfused one's or one bf16
step from it (csrc/conv3d.cu, preact_halo).

The split count is the one decision of the plan that depends on the number
of output tiles, and it sets the order in which each output element is
summed. A call on a mesh shard (parallel/mesh.py) passes `unsharded`, the
(batch, height) of the unsharded call, and takes that call's split count:
each element of a shard is then summed as in the unsharded call, so a
meshed call computes the one-process bits.

Under a gradient both entries go through `Conv3dFunction`, on every device.
Its backward takes the input gradient through the same kernel: with y =
conv(x * s, W) + b,

    d(x * s) = conv_same(dy, W'),  W'[i, j, k] = W[2 - i, 2 - j, 2 - k].T

which is the forward function with Cin and Cout swapped. Then dx = d(x * s)
* s, ds = sum over (D, H, W) of x * d(x * s), and db = sum of dy. The weight
gradient (`conv3d_weight_grad`; the JAX package takes it from XLA's conv VJP
outside its Pallas kernel) goes by what its input shows: fp32 on a CUDA
device with Cin % 4 == 0, Cout % 4 == 0 and a 16-byte aligned x and dy
launches the csrc/conv3d.cu weight-gradient kernel (3xTF32 tensor cores,
deterministic, the style applied in the kernel, so x * s is never written);
every other call (bf16, another fp32 shape, the CPU) goes to
`aten.convolution_backward` (cuDNN on the card, TF32 off, deterministic
algorithms) on x * s (`weight_grad_route`). `input_grad_launches` counts the
kernel's launches for input gradients (a part of `launches`),
`weight_grad_launches` the weight-gradient kernel's launches and
`weight_grad_calls` every weight gradient computed on the card, by either
route. Without a gradient the entries launch the kernel directly, so serving
pays no autograd bookkeeping.

The backward runs in the forward's dtype. In bf16 it computes what XLA's
bf16 conv VJP computes in the JAX package: bf16 operands, fp32 sums, one
rounding to bf16 of each gradient. d(x * s) is the bf16 kernel instance on
dy (the same Cin % 8 rule, where Cin is the forward's Cout: a shape with no
instance raises); dW is cuDNN's bf16 weight gradient of bf16(x * s), the
forward's own operand, with fp32 accumulation (not quite one rounding: at a
legacy 256x256 shape a few elements near zero lay 1.3e-4 of scale beyond one
bf16 step of the fp32 sums); dx = d(x * s) * s and db are one rounding each,
and ds is an fp32 sum of the exact products x * d(x * s), rounded once. Under a gradient a concat part's conv is added to the
accumulated parts after its own rounding (ops/modconv.py, out of place),
where the served forward adds it in the kernel before the one rounding: the
bf16 training forward differs from the served one by at most a rounding
step a part (and rounds the parts as the JAX package does).
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from tmdiff_tpu_torch.ops.cuda import build
from tmdiff_tpu_torch.ops.library_conv import cudnn_fp32, widen_on_cpu
from tmdiff_tpu_torch.utils import profiling

# Launches of the CUDA kernel since the last reset_launches(), in all, by
# variant (tmdiff_conv_plan's numbering from 0) and by dtype; of them, those
# for input gradients; the weight gradients computed on the card (either
# route) and, of them, the weight-gradient kernel's launches (not counted in
# `launches`); and the convs given a pre-activation:
# the launches that applied it in the kernel (`preact_fused`) and the calls
# that computed it with PyTorch ops first (`preact_unfused`, any device).
VARIANTS = ("ffma", "tf32x3", "tf32x3_splitk", "bf16", "bf16_splitk")
DTYPES = {torch.float32: 0, torch.bfloat16: 1}  # the C entries' dtype codes
launches = 0
variant_launches = dict.fromkeys(VARIANTS, 0)
dtype_launches = {"float32": 0, "bfloat16": 0}
input_grad_launches = 0
weight_grad_calls = 0
weight_grad_launches = 0
preact_fused = 0
preact_unfused = 0


def reset_launches() -> None:
    global launches, input_grad_launches, weight_grad_calls, weight_grad_launches
    global preact_fused, preact_unfused
    launches = input_grad_launches = weight_grad_calls = weight_grad_launches = 0
    preact_fused = preact_unfused = 0
    variant_launches.update(dict.fromkeys(VARIANTS, 0))
    dtype_launches.update(dict.fromkeys(dtype_launches, 0))


def has_preact(shift, act) -> bool:
    """Whether (shift, act) asks for a pre-activation: act "silu", with or
    without a shift. Raises on another activation and on a shift without
    the SiLU."""
    if act not in (None, "silu"):
        raise ValueError(f"unknown activation {act!r}; expected None or 'silu'")
    if shift is not None and act is None:
        raise ValueError("a shift is applied only before act='silu'")
    return act is not None


def preact(x, shift=None, act=None):
    """silu(x + shift[:, None, None, None, :]) with PyTorch ops in x's dtype
    (the shift cast to it, the add left out without one): the unfused
    pre-activation, counted in `preact_unfused`. x itself where act is
    None."""
    global preact_unfused
    if not has_preact(shift, act):
        return x
    preact_unfused += 1
    if shift is not None:
        x = x + shift.to(x.dtype).reshape(shift.shape[0], *[1] * (x.dim() - 2), shift.shape[-1])
    return F.silu(x)


def count_launch(variants: dict, dtypes: dict, variant: str, dtype) -> None:
    """Adds one launch of `variant` in `dtype` to a wrapper's counters."""
    variants[variant] += 1
    dtypes[str(dtype).replace("torch.", "")] += 1


def bf16_operands(x, kernel, style=None, bias=None, out=None):
    """The bf16 kernel's operands as exact float32 tensors: bf16(x * s)
    (one rounding of the product), bf16(W), and the bias and `out` as
    given."""
    f = lambda t: None if t is None else t.float()
    if style is not None:  # (B, Cin) against x (B, ..., Cin)
        s = style.float().reshape(style.shape[0], *[1] * (x.dim() - 2), style.shape[1])
        x = (x.float() * s).to(torch.bfloat16)
    return x.float(), kernel.to(torch.bfloat16).float(), f(bias), f(out)


def conv3d_plain(x, kernel, style=None, bias=None, out=None, shift=None, act=None):
    """The kernel's function as 27 shifted-slice products in fp32; in bf16
    on the bf16 kernel's operands (bf16_operands), with one rounding of
    sum + bias + out at the end. A pre-activation is computed first
    (`preact`)."""
    x = preact(x, shift, act)
    if x.dtype == torch.bfloat16:
        xs, k, bias32, out32 = bf16_operands(x, kernel, style, bias, out)
        y = conv3d_plain(xs, k, None, bias32, out32).to(torch.bfloat16)
        return y if out is None else out.copy_(y)
    b, d, h, w, _ = x.shape
    if style is not None:
        x = x * style[:, None, None, None, :]
    xp = F.pad(x, (0, 0, 1, 1, 1, 1, 1, 1))
    y = None
    for i in range(3):
        for j in range(3):
            for k in range(3):
                term = torch.matmul(xp[:, i:i + d, j:j + h, k:k + w, :], kernel[i, j, k])
                y = term if y is None else y.add_(term)
    if bias is not None:
        y = y + bias
    if out is None:
        return y
    return out.add_(y)


_lib = None


def library():
    """The kernel's ctypes library, built and loaded at first use. It also
    holds the 3x3 NHWC entry of ops/cuda/conv2d.py, the same kernel with one
    depth tap."""
    global _lib
    if _lib is None:
        lib = build.load("conv3d")
        lib.tmdiff_conv_plan.argtypes = (
            [ctypes.c_int] * 8 + [ctypes.c_void_p, ctypes.POINTER(ctypes.c_longlong),
                                  ctypes.POINTER(ctypes.c_int)])
        lib.tmdiff_conv_plan.restype = ctypes.c_int
        lib.tmdiff_conv3d_333.argtypes = (
            [ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] + [ctypes.c_void_p] * 2
            + [ctypes.c_int] * 6 + [ctypes.c_longlong] * 2 + [ctypes.c_int] * 2
            + [ctypes.c_void_p] * 2)
        lib.tmdiff_conv3d_333.restype = ctypes.c_int
        lib.tmdiff_conv2d_33.argtypes = (
            [ctypes.c_int] + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
            + [ctypes.c_longlong] * 2 + [ctypes.c_int] + [ctypes.c_void_p] * 2)
        lib.tmdiff_conv2d_33.restype = ctypes.c_int
        lib.tmdiff_wgrad_plan.argtypes = (
            [ctypes.c_int] * 6 + [ctypes.c_void_p] * 2
            + [ctypes.POINTER(ctypes.c_longlong), ctypes.POINTER(ctypes.c_int)])
        lib.tmdiff_wgrad_plan.restype = ctypes.c_int
        lib.tmdiff_wgrad_333.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p] * 2)
        lib.tmdiff_wgrad_333.restype = ctypes.c_int
        lib.tmdiff_cuda_error_string.argtypes = [ctypes.c_int]
        lib.tmdiff_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


# (kd, dtype, B, D, H, W, Cin, Cout, x 16-byte aligned, device, unsharded)
# -> (variant, workspace bytes, splits): the C side's plan, asked once per
# shape.
_plans = {}


def _ask(kd, x, b, d, h, w, cin, cout, splits: int = 0):
    """tmdiff_conv_plan for that shape, asking for `splits` (0: the split-K
    rule): (variant number, workspace bytes, split count)."""
    nbytes, count = ctypes.c_longlong(0), ctypes.c_int(splits)
    variant = library().tmdiff_conv_plan(kd, DTYPES[x.dtype], b, d, h, w, cin, cout,
                                         x.data_ptr(), ctypes.byref(nbytes), ctypes.byref(count))
    return variant, nbytes.value, count.value


def plan(kd, x, d, cout, unsharded=None):
    """(variant name, split count, workspace) of the kernel for x
    (B, [D,] H, W, Cin) with kd depth taps on the current device: the C
    side's choice by shape and dtype, and a workspace of the bytes it asks
    for (the split or packed weight and any split-K partial sums), allocated
    here so that the kernel allocates nothing. With `unsharded`, the (B, H)
    of the unsharded call x is a mesh shard of, the split count is that
    call's (module doc). A bf16 shape that no bf16 instance takes raises: it
    never goes to an fp32 kernel or the plain version. A shape planned for
the first time is a `conv3d.plan` span (utils/profiling.py; `kd`, `shape`
= (B, D, H, W, Cin, Cout), `variant`)."""
    b, h, w, cin = x.shape[0], x.shape[-3], x.shape[-2], x.shape[-1]
    key = (kd, x.dtype, b, d, h, w, cin, cout, x.data_ptr() % 16 == 0, x.device.index,
           unsharded)
    if key not in _plans:
        with profiling.span("conv3d.plan", kd=kd, shape=(b, d, h, w, cin, cout)) as span:
            want = 0 if unsharded is None else _ask(kd, x, unsharded[0], d, unsharded[1], w,
                                                    cin, cout)[2]
            variant, nbytes, splits = _ask(kd, x, b, d, h, w, cin, cout, want)
            if variant < 0:
                raise ValueError(f"no {x.dtype} conv kernel instance for Cin = {cin} (needs "
                                 "Cin % 8 == 0) or an x that is not 16-byte aligned")
            _plans[key] = (VARIANTS[variant], nbytes, splits)
            span.set(variant=VARIANTS[variant])
    variant, nbytes, splits = _plans[key]
    workspace = torch.empty(nbytes, dtype=torch.uint8, device=x.device) if nbytes else None
    return variant, splits, workspace


def _check(x, kernel, style, bias, out, shift=None):
    build.check_operands("conv3d", tuple(DTYPES), x=x, kernel=kernel, style=style, bias=bias,
                         out=out, shift=shift)
    if x.dim() != 5 or not x.is_contiguous():
        raise ValueError(f"x must be a contiguous (B, D, H, W, Cin) tensor, got {tuple(x.shape)}")
    b, d, h, w, cin = x.shape
    if kernel.dim() != 5 or tuple(kernel.shape[:4]) != (3, 3, 3, cin):
        raise ValueError(f"kernel must be (3, 3, 3, {cin}, Cout), got {tuple(kernel.shape)}")
    cout = kernel.shape[4]
    st = kernel.stride()
    # (a size-1 Cout dimension's stride is never read)
    if (st[4] != 1 and cout > 1) or st[0] != 3 * st[1] or st[1] != 3 * st[2]:
        raise ValueError(f"kernel strides {st} do not give one tap stride and unit Cout stride")
    for name, t in (("style", style), ("shift", shift)):
        if t is not None and (tuple(t.shape) != (b, cin) or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous ({b}, {cin}) tensor")
    if bias is not None and (tuple(bias.shape) != (cout,) or bias.stride(0) != 1):
        raise ValueError(f"bias must be a unit-stride ({cout},) tensor")
    if out is not None and (tuple(out.shape) != (b, d, h, w, cout) or not out.is_contiguous()):
        raise ValueError(f"out must be a contiguous {(b, d, h, w, cout)} tensor")
    if x.dtype == torch.float32 and cout % 4 == 0:
        # the fp32 epilogue stores and reads the bias four channels at a time
        for name, t in (("bias", bias), ("out", out)):
            if t is not None and t.data_ptr() % 16:
                raise ValueError(f"{name} must be 16-byte aligned when Cout % 4 == 0")
    if x.dtype == torch.bfloat16 and cout % 2 == 0 and out is not None and out.data_ptr() % 4:
        raise ValueError("a bf16 out must be 4-byte aligned when Cout is even")
    if max(b * d * h * w * max(cin, cout), kernel.numel()) >= 2**31 or cin < 1 or cout < 1:
        raise ValueError(f"unsupported conv size {tuple(x.shape)} -> Cout {cout}")


def _launch(x, kernel, style, bias, out, input_grad: bool = False, unsharded=None,
            shift=None, act=None):
    """One launch of the kernel on a CUDA x (the plain version on a CPU x).
    A pre-activation (shift, act) is applied in the launch: bf16 only."""
    if x.device.type == "cpu":
        return conv3d_plain(x, kernel, style, bias, out, shift, act)
    if x.device.type != "cuda":
        raise ValueError(f"no conv3d kernel for device {x.device}")
    fused = has_preact(shift, act)
    if fused and x.dtype != torch.bfloat16:
        raise ValueError("only the bf16 kernel applies a pre-activation; compute preact() first")
    _check(x, kernel, style, bias, out, shift)
    b, d, h, w, cin = x.shape
    cout = kernel.shape[4]
    y = torch.empty((b, d, h, w, cout), dtype=x.dtype, device=x.device) if out is None else out
    if y.numel() == 0:
        return y
    ptr = lambda t: None if t is None else t.data_ptr()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        lib = library()
        variant, splits, workspace = plan(3, x, d, cout, unsharded=unsharded)
        err = lib.tmdiff_conv3d_333(
            DTYPES[x.dtype], x.data_ptr(), kernel.data_ptr(), ptr(style), ptr(shift), int(fused),
            ptr(bias), y.data_ptr(),
            b, d, h, w, cin, cout, kernel.stride(2), kernel.stride(3),
            int(out is not None), splits, ptr(workspace), stream)
    if err:
        raise RuntimeError(f"conv3d kernel launch failed: {lib.tmdiff_cuda_error_string(err).decode()}")
    global launches, input_grad_launches, preact_fused
    launches += 1
    input_grad_launches += input_grad
    preact_fused += fused
    count_launch(variant_launches, dtype_launches, variant, x.dtype)
    return y


def weight_grad_route(device_type: str, dtype, cin: int, cout: int, aligned: bool) -> str:
    """Where a weight gradient goes: "kernel" (the csrc/conv3d.cu weight
    gradient) for float32 on a CUDA device with Cin % 4 == 0, Cout % 4 == 0
    and x and dy 16-byte aligned (`aligned`: the kernel's TMA maps), else
    "cudnn" (`aten.convolution_backward`)."""
    if (device_type == "cuda" and dtype == torch.float32 and cin % 4 == 0 and cout % 4 == 0
            and aligned):
        return "kernel"
    return "cudnn"


# (B, D, H, W, Cin, Cout, device) -> (split count, workspace bytes): the C
# side's weight-gradient plan, asked once per shape
_wgrad_plans = {}


def wgrad_plan(x, dy):
    """(split count, workspace) of the weight-gradient kernel for x
    (B, D, H, W, Cin) and dy (..., Cout) on the current device: the C side's
    choice by shape, and a workspace of the bytes it asks for (the splits'
    partial sums), allocated here so that the kernel allocates nothing."""
    b, d, h, w, cin = x.shape
    cout = dy.shape[-1]
    key = (b, d, h, w, cin, cout, x.device.index)
    if key not in _wgrad_plans:
        nbytes, count = ctypes.c_longlong(0), ctypes.c_int(0)
        ok = library().tmdiff_wgrad_plan(b, d, h, w, cin, cout, x.data_ptr(), dy.data_ptr(),
                                         ctypes.byref(nbytes), ctypes.byref(count))
        if not ok:
            raise ValueError(f"no weight-gradient kernel for Cin {cin}, Cout {cout} (needs both "
                             "% 4 == 0) or an x or dy that is not 16-byte aligned")
        _wgrad_plans[key] = (count.value, nbytes.value)
    splits, nbytes = _wgrad_plans[key]
    workspace = torch.empty(nbytes, dtype=torch.uint8, device=x.device) if nbytes else None
    return splits, workspace


def _wgrad_launch(x, dy, style):
    """dW through the weight-gradient kernel (float32, CUDA, the route's
    shapes): x and dy contiguous, the style applied in the kernel."""
    global weight_grad_launches
    build.check_operands("wgrad", (torch.float32,), x=x, dy=dy, style=style)
    b, d, h, w, cin = x.shape
    cout = dy.shape[-1]
    if dy.shape[:4] != x.shape[:4] or not (x.is_contiguous() and dy.is_contiguous()):
        raise ValueError(f"x {tuple(x.shape)} and dy {tuple(dy.shape)} must be contiguous and "
                         "share (B, D, H, W)")
    if style is not None and (tuple(style.shape) != (b, cin) or not style.is_contiguous()):
        raise ValueError(f"style must be a contiguous ({b}, {cin}) tensor")
    if max(x.numel(), dy.numel(), 27 * cin * cout) >= 2**31:
        raise ValueError(f"unsupported weight-gradient size {tuple(x.shape)} -> Cout {cout}")
    dw = torch.empty((3, 3, 3, cin, cout), dtype=x.dtype, device=x.device)
    if x.numel() == 0 or dy.numel() == 0:
        return dw.zero_()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        lib = library()
        splits, workspace = wgrad_plan(x, dy)
        err = lib.tmdiff_wgrad_333(x.data_ptr(), None if style is None else style.data_ptr(),
                                   dy.data_ptr(), dw.data_ptr(), b, d, h, w, cin, cout, splits,
                                   None if workspace is None else workspace.data_ptr(), stream)
    if err:
        raise RuntimeError("weight-gradient kernel launch failed: "
                           f"{lib.tmdiff_cuda_error_string(err).decode()}")
    weight_grad_launches += 1
    return dw


def conv3d_weight_grad_plain(x, dy, style=None):
    """The weight gradient's function as 27 shifted-slice products, in the
    manner of `conv3d_plain`: dW[i, j, k] = sum over positions of
    pad(x * s)[.., d + i, h + j, w + k, :]^T dy, in x's dtype."""
    if style is not None:
        x = x * style[:, None, None, None, :]
    b, d, h, w, cin = x.shape
    xp = F.pad(x, (0, 0, 1, 1, 1, 1, 1, 1))
    g = dy.reshape(-1, dy.shape[-1])
    return torch.stack([
        torch.stack([
            torch.stack([xp[:, i:i + d, j:j + h, k:k + w, :].reshape(-1, cin).T @ g
                         for k in range(3)])
            for j in range(3)])
        for i in range(3)])


def conv3d_weight_grad(xs, dy, style=None):
    """dW (3, 3, 3, Cin, Cout) of the SAME conv of xs * style (xs (B, D, H,
    W, Cin), style (B, Cin) or None) with output gradient dy (B, D, H, W,
    Cout), in their dtype (float32, or bfloat16 with fp32 accumulation and
    one rounding). The kernel where `weight_grad_route` says so (the style
    applied in it); else `aten.convolution_backward` on channels-last-3d
    views of xs * style and dy (no copy), under the library convs' flags
    (ops/library_conv.py::cudnn_fp32: TF32 off, deterministic algorithms, so
    that a step repeats bit for bit); a bf16 one on the CPU in fp32 on the
    bf16 values (`widen_on_cpu`)."""
    global weight_grad_calls
    if xs.device.type == "cuda":
        weight_grad_calls += 1
    aligned = xs.data_ptr() % 16 == 0 and dy.data_ptr() % 16 == 0
    if weight_grad_route(xs.device.type, xs.dtype, xs.shape[-1], dy.shape[-1],
                         aligned) == "kernel":
        return _wgrad_launch(xs.contiguous(), dy.contiguous(), style)
    return weight_grad_library(xs, dy, style)


def weight_grad_library(xs, dy, style=None):
    """The cuDNN route of `conv3d_weight_grad` (module doc), uncounted: also
    the yardstick the kernel is timed and checked against on the card."""
    if style is not None:
        xs = xs * style[:, None, None, None, :]
    cin, cout = xs.shape[-1], dy.shape[-1]
    # read for its shape, dtype and layout only
    weight = torch.empty((cout, cin, 3, 3, 3), dtype=xs.dtype, device=xs.device,
                         memory_format=torch.channels_last_3d)
    with cudnn_fp32():
        _, dw, _ = torch.ops.aten.convolution_backward(
            *widen_on_cpu(dy.permute(0, 4, 1, 2, 3), xs.permute(0, 4, 1, 2, 3), weight), None,
            [1, 1, 1], [1, 1, 1], [1, 1, 1], False, [0, 0, 0], 1, [False, True, False])
    return dw.to(xs.dtype).permute(2, 3, 4, 1, 0)


class Conv3dFunction(torch.autograd.Function):
    """y = conv3d_same(x * s, kernel) + bias with the backward of the module
    doc; style and bias may be None. The forward and the input gradient run
    the kernel on a CUDA tensor and the plain version on a CPU tensor, both
    planned for `unsharded` (see plan), in float32 or bfloat16."""

    @staticmethod
    def forward(ctx, x, kernel, style, bias, unsharded=None):
        ctx.save_for_backward(x, kernel, style)
        ctx.unsharded = unsharded
        return _launch(x, kernel, style, bias, None, unsharded=unsharded)

    @staticmethod
    def backward(ctx, dy):
        x, kernel, style = ctx.saved_tensors
        need_x, need_k, need_s, need_b = ctx.needs_input_grad[:4]
        dy = dy.contiguous()
        dx = dk = ds = db = None
        if need_x or need_s:
            flipped = kernel.flip((0, 1, 2)).transpose(3, 4).contiguous()
            dxs = _launch(dy, flipped, None, None, None, input_grad=True,
                          unsharded=ctx.unsharded)
            if need_x:
                dx = dxs if style is None else dxs * style[:, None, None, None, :]
            if need_s:  # fp32 products and sum, one rounding in bf16
                ds = (x.float() * dxs.float()).sum((1, 2, 3)).to(x.dtype)
        if need_k:
            with torch.profiler.record_function("conv3d.weight_grad"):
                dk = conv3d_weight_grad(x, dy, style)
        if need_b:
            db = dy.sum((0, 1, 2, 3))
        return dx, dk, ds, db, None


def needs_grad(*tensors) -> bool:
    """Whether autograd would record an op on these tensors (None allowed)."""
    return torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors)


def _apply(x, kernel, style, bias, out, unsharded, shift, act):
    grad = needs_grad(x, kernel, style, bias, shift)
    pre = {}
    if x.device.type == "cuda" and x.dtype == torch.bfloat16 and not grad:
        if has_preact(shift, act):
            # the add and SiLU it stands for wrote a fresh tensor: a view (a
            # cropped decoder input) is copied into one for the kernel
            x = x.contiguous()
            pre = {"shift": None if shift is None else shift.to(x.dtype), "act": act}
    else:
        x = preact(x, shift, act)
    if not grad:
        return _launch(x, kernel, style, bias, out, unsharded=unsharded, **pre)
    y = Conv3dFunction.apply(x, kernel, style, bias, unsharded)
    return y if out is None else out.add_(y)


def banded_conv3d(x, kernel, style=None, bias=None, out=None, unsharded=None, *, shift=None,
                  act=None):
    """SAME 3x3x3 conv (see module doc); the port of K1, `banded_conv3d`.
    `unsharded`: the (B, H) of the unsharded call x is a mesh shard of.
    (shift, act): the input's pre-activation, applied in the launch where x
    is bf16 on a CUDA device and no gradient is needed, else by `preact`."""
    return _apply(x, kernel, style, bias, out, unsharded, shift, act)


def banded_conv3d_v2(x, kernel, style=None, bias=None, out=None, unsharded=None, *, shift=None,
                     act=None):
    """The port of K2, `banded_conv3d_v2`: the same function as K1 on TPU,
    tiled differently there. On Hopper one tiling serves both, so this entry
    launches the same kernel, with the same backward."""
    return _apply(x, kernel, style, bias, out, unsharded, shift, act)
