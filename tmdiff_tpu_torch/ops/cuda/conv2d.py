"""SAME, stride-1 3x3 NHWC convolution: the CUDA kernel's wrapper and its
plain PyTorch version.

Both compute, for x (B, H, W, Cin), w (3, 3, Cin, Cout), an optional
per-sample style s (B, Cin) and an optional bias (Cout),

    y = conv2d_same(x * s[:, None, None, :], w) + bias

with fp32 accumulation, in float32 or in bfloat16 (every tensor one dtype;
bf16 as ops/cuda/conv3d.py describes: bf16(x * s), bf16(W), fp32
accumulation, one rounding of sum + bias). It is the band-into-lanes form of
a 3x3x3 conv
(ops/modconv.py::_conv3d_bandlanes): the bands folded into channels and the
depth taps into a block-banded weight.

`conv3x3_nhwc` replaces the Pallas TPU kernel
`tmdiff_tpu/ops/pallas/conv2d.py::conv3x3_nhwc`. It launches the kernel of
`tmdiff_tpu_torch/csrc/conv3d.cu` with one depth tap (`tmdiff_conv2d_33`),
which takes any H and W; the TPU kernel needs H % 8 == 0. Its variant is
chosen by shape and dtype as for the 3x3x3 entry (ops/cuda/conv3d.py),
and `variant_launches` and `dtype_launches` count the launches of each. On
a CPU tensor it computes the plain version; on a CUDA tensor it launches
the kernel or raises. The kernel has no backward, as the TPU kernel has
none: the wrapper refuses inputs that need a gradient.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from tmdiff_tpu_torch.ops.cuda import build, conv3d as _conv3d

# Launches of the CUDA kernel since the last reset_launches(), in all, by
# variant (ops/cuda/conv3d.py's VARIANTS) and by dtype.
launches = 0
variant_launches = dict.fromkeys(_conv3d.VARIANTS, 0)
dtype_launches = {"float32": 0, "bfloat16": 0}


def reset_launches() -> None:
    global launches
    launches = 0
    variant_launches.update(dict.fromkeys(_conv3d.VARIANTS, 0))
    dtype_launches.update(dict.fromkeys(dtype_launches, 0))


def conv3x3_nhwc_plain(x, w, style=None, bias=None):
    """The kernel's function as 9 shifted-slice products in fp32; in bf16
    on the bf16 kernel's operands with one rounding at the end."""
    if x.dtype == torch.bfloat16:
        xs, w32, bias32, _ = _conv3d.bf16_operands(x, w, style, bias)
        return conv3x3_nhwc_plain(xs, w32, None, bias32).to(torch.bfloat16)
    _, h, wd, _ = x.shape
    if style is not None:
        x = x * style[:, None, None, :]
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    y = None
    for i in range(3):
        for j in range(3):
            term = torch.matmul(xp[:, i:i + h, j:j + wd, :], w[i, j])
            y = term if y is None else y.add_(term)
    return y if bias is None else y + bias


def _check(x, w, style, bias):
    build.check_operands("conv3x3_nhwc", tuple(_conv3d.DTYPES), x=x, w=w, style=style,
                         bias=bias)
    if x.dim() != 4 or not x.is_contiguous():
        raise ValueError(f"x must be a contiguous (B, H, W, Cin) tensor, got {tuple(x.shape)}")
    b, h, wd, cin = x.shape
    if w.dim() != 4 or tuple(w.shape[:3]) != (3, 3, cin):
        raise ValueError(f"w must be (3, 3, {cin}, Cout), got {tuple(w.shape)}")
    cout = w.shape[3]
    st = w.stride()
    if st[3] != 1 or st[0] != 3 * st[1]:
        raise ValueError(f"w strides {st} do not give one tap stride and unit Cout stride")
    if style is not None and (tuple(style.shape) != (b, cin) or not style.is_contiguous()):
        raise ValueError(f"style must be a contiguous ({b}, {cin}) tensor")
    if bias is not None and (tuple(bias.shape) != (cout,) or bias.stride(0) != 1):
        raise ValueError(f"bias must be a unit-stride ({cout},) tensor")
    if x.dtype == torch.float32 and bias is not None and cout % 4 == 0 and bias.data_ptr() % 16:
        raise ValueError("bias must be 16-byte aligned when Cout % 4 == 0")
    if max(b * h * wd * max(cin, cout), w.numel()) >= 2**31 or cin < 1 or cout < 1:
        raise ValueError(f"unsupported conv size {tuple(x.shape)} -> Cout {cout}")


def conv3x3_nhwc(x, w, style=None, bias=None, unsharded=None):
    """SAME 3x3 conv (see module doc); the port of K3, `conv3x3_nhwc`.
    `unsharded`: the (B, H) of the unsharded call x is a mesh shard of; the
    split count is planned for it (ops/cuda/conv3d.py::plan)."""
    if x.device.type == "cpu":
        return conv3x3_nhwc_plain(x, w, style, bias)
    if x.device.type != "cuda":
        raise ValueError(f"no conv3x3_nhwc kernel for device {x.device}")
    _check(x, w, style, bias)
    b, h, wd, cin = x.shape
    y = torch.empty((b, h, wd, w.shape[3]), dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y
    ptr = lambda t: None if t is None else t.data_ptr()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        lib = _conv3d.library()
        variant, splits, workspace = _conv3d.plan(1, x, 1, w.shape[3], unsharded=unsharded)
        err = lib.tmdiff_conv2d_33(
            _conv3d.DTYPES[x.dtype], x.data_ptr(), w.data_ptr(), ptr(style), ptr(bias),
            y.data_ptr(),
            b, h, wd, cin, w.shape[3], w.stride(1), w.stride(2), splits, ptr(workspace),
            stream)
    if err:
        raise RuntimeError(f"conv3x3_nhwc kernel launch failed: {lib.tmdiff_cuda_error_string(err).decode()}")
    global launches
    launches += 1
    _conv3d.count_launch(variant_launches, dtype_launches, variant, x.dtype)
    return y
