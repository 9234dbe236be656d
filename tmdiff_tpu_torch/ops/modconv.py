"""3-D convolutions of WavBEST, band-as-depth channels-last layout.

Activations are (B, D, H, W, C) with the spectral bands as conv depth D;
kernels are (kd, kh, kw, Cin, Cout). Two kernel sizes occur:

  * SAME stride-1 3x3x3: the CUDA kernel (ops/cuda/conv3d.py) on a CUDA
    tensor, its plain version on a CPU tensor or when `plain=True`. A
    modulated conv passes its style to the kernel, which scales the operand
    as it loads it: conv(x * s, W) without writing x * s out.
  * 1x1x1: a (B*D*H*W, Cin) @ (Cin, Cout) matrix product.

The reference's per-sample modulated conv, w_b[o, i] = w[o, i] * s[b, i] with
no bias and no demodulation, equals conv(x_b * s_b, w) because the style
scales input channels only (tmdiff_tpu/ops/modconv.py pins this identity
against the torch reference golden).
"""
from __future__ import annotations

import torch

from tmdiff_tpu_torch.ops.cuda.conv3d import banded_conv3d, conv3d_plain


def conv3d(x, kernel, *, style=None, bias=None, out=None, plain: bool = False):
    """SAME stride-1 conv of x (B, D, H, W, Cin) with kernel (k, k, k, Cin,
    Cout), k in {1, 3}, of the style-scaled input, plus bias; added into `out`
    in place when given."""
    size = tuple(kernel.shape[:3])
    if size == (3, 3, 3):
        fn = conv3d_plain if plain else banded_conv3d
        return fn(x, kernel, style, bias, out)
    if size != (1, 1, 1):
        raise ValueError(f"only 1x1x1 and 3x3x3 kernels occur in WavBEST, got {size}")
    if style is not None:
        x = x * style[:, None, None, None, :]
    y = torch.matmul(x.reshape(-1, x.shape[-1]), kernel[0, 0, 0])
    y = y.reshape(*x.shape[:-1], kernel.shape[-1])
    if bias is not None:
        y = y + bias
    return y if out is None else out.add_(y)


def conv3d_cat(parts, kernel, *, bias=None, plain: bool = False):
    """conv3d(cat(parts, -1), kernel) + bias without materialising the concat:
    each part convolves with its slice of the kernel's input channels, and
    the parts accumulate into one output."""
    off, out = 0, None
    for p in parts:
        kpart = kernel[..., off:off + p.shape[-1], :]
        off += p.shape[-1]
        out = conv3d(p, kpart, bias=bias if out is None else None, out=out, plain=plain)
    if off != kernel.shape[-2]:
        raise ValueError(f"parts have {off} channels, kernel takes {kernel.shape[-2]}")
    return out


def modulated_conv3d(x, kernel, style, *, plain: bool = False):
    """y_b = conv3d(x_b * s_b, kernel) for style (B, Cin), no bias."""
    return conv3d(x, kernel, style=style, plain=plain)
