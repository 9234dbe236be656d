"""SAME, stride-1 3x3x3 band-as-depth convolution: the CUDA kernel's wrapper
and its plain PyTorch version.

Both compute, for x (B, D, H, W, Cin), kernel (3, 3, 3, Cin, Cout), an
optional per-sample style s (B, Cin) and an optional bias (Cout),

    y = conv3d_same(x * s[:, None, None, None, :], kernel) + bias

with fp32 accumulation. Given `out`, the result is added into `out` in place
(one launch per part of a channel concat, without materialising the concat).

`banded_conv3d` replaces the Pallas TPU kernel
`tmdiff_tpu/ops/pallas/banded_conv3d.py::banded_conv3d` and
`banded_conv3d_v2` its second entry point of the same function; both launch
the kernel of `tmdiff_tpu_torch/csrc/conv3d.cu` with three depth taps (its
header says what bounds it on an H100 and how it is tiled). On a CPU tensor
they compute the plain version; on a CUDA tensor they launch the kernel or
raise.

The kernel has no backward: the wrappers refuse inputs that need a gradient.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from tmdiff_tpu_torch.ops.cuda import build

# Launches of the CUDA kernel since the last reset_launches().
launches = 0


def reset_launches() -> None:
    global launches
    launches = 0


def conv3d_plain(x, kernel, style=None, bias=None, out=None):
    """The kernel's function as 27 shifted-slice products in fp32."""
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
        lib.tmdiff_conv3d_333.argtypes = (
            [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
            + [ctypes.c_longlong] * 2 + [ctypes.c_int, ctypes.c_void_p])
        lib.tmdiff_conv3d_333.restype = ctypes.c_int
        lib.tmdiff_conv2d_33.argtypes = (
            [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
            + [ctypes.c_longlong] * 2 + [ctypes.c_void_p])
        lib.tmdiff_conv2d_33.restype = ctypes.c_int
        lib.tmdiff_cuda_error_string.argtypes = [ctypes.c_int]
        lib.tmdiff_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _check(x, kernel, style, bias, out):
    build.check_operands("conv3d", x=x, kernel=kernel, style=style, bias=bias, out=out)
    if x.dim() != 5 or not x.is_contiguous():
        raise ValueError(f"x must be a contiguous (B, D, H, W, Cin) tensor, got {tuple(x.shape)}")
    b, d, h, w, cin = x.shape
    if kernel.dim() != 5 or tuple(kernel.shape[:4]) != (3, 3, 3, cin):
        raise ValueError(f"kernel must be (3, 3, 3, {cin}, Cout), got {tuple(kernel.shape)}")
    cout = kernel.shape[4]
    st = kernel.stride()
    if st[4] != 1 or st[0] != 3 * st[1] or st[1] != 3 * st[2]:
        raise ValueError(f"kernel strides {st} do not give one tap stride and unit Cout stride")
    if style is not None and (tuple(style.shape) != (b, cin) or not style.is_contiguous()):
        raise ValueError(f"style must be a contiguous ({b}, {cin}) tensor")
    if bias is not None and (tuple(bias.shape) != (cout,) or bias.stride(0) != 1):
        raise ValueError(f"bias must be a unit-stride ({cout},) tensor")
    if out is not None and (tuple(out.shape) != (b, d, h, w, cout) or not out.is_contiguous()):
        raise ValueError(f"out must be a contiguous {(b, d, h, w, cout)} tensor")
    if cout % 4 == 0:  # the epilogue stores and reads the bias four channels at a time
        for name, t in (("bias", bias), ("out", out)):
            if t is not None and t.data_ptr() % 16:
                raise ValueError(f"{name} must be 16-byte aligned when Cout % 4 == 0")
    if max(b * d * h * w * max(cin, cout), kernel.numel()) >= 2**31 or cin < 1 or cout < 1:
        raise ValueError(f"unsupported conv size {tuple(x.shape)} -> Cout {cout}")


def _launch(x, kernel, style, bias, out):
    if x.device.type == "cpu":
        return conv3d_plain(x, kernel, style, bias, out)
    if x.device.type != "cuda":
        raise ValueError(f"no conv3d kernel for device {x.device}")
    _check(x, kernel, style, bias, out)
    b, d, h, w, cin = x.shape
    cout = kernel.shape[4]
    y = torch.empty((b, d, h, w, cout), dtype=torch.float32, device=x.device) if out is None else out
    if y.numel() == 0:
        return y
    ptr = lambda t: None if t is None else t.data_ptr()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        lib = library()
        err = lib.tmdiff_conv3d_333(
            x.data_ptr(), kernel.data_ptr(), ptr(style), ptr(bias), y.data_ptr(),
            b, d, h, w, cin, cout, kernel.stride(2), kernel.stride(3),
            int(out is not None), stream)
    if err:
        raise RuntimeError(f"conv3d kernel launch failed: {lib.tmdiff_cuda_error_string(err).decode()}")
    global launches
    launches += 1
    return y


def banded_conv3d(x, kernel, style=None, bias=None, out=None):
    """SAME 3x3x3 conv (see module doc); the port of K1, `banded_conv3d`."""
    return _launch(x, kernel, style, bias, out)


def banded_conv3d_v2(x, kernel, style=None, bias=None, out=None):
    """The port of K2, `banded_conv3d_v2`: the same function as K1 on TPU,
    tiled differently there. On Hopper one tiling serves both, so this entry
    launches the same kernel."""
    return _launch(x, kernel, style, bias, out)
