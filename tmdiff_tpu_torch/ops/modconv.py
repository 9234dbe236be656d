"""3-D convolutions of WavBEST, band-as-depth channels-last layout.

Activations are (B, D, H, W, C) with the spectral bands as conv depth D;
kernels are (kd, kh, kw, Cin, Cout). Two kernel sizes occur:

  * SAME stride-1 3x3x3, lowered by `impl`:
      - "banded" (the default): the 3x3x3 CUDA kernel (ops/cuda/conv3d.py)
        at every shape. The JAX package's TMDIFF_CONV3D_IMPL=banded.
      - "auto": the JAX package's TMDIFF_CONV3D_IMPL=auto with
        TMDIFF_BANDLANES_CONV=pallas. Where `_bandlanes_wins`, the bands are
        folded into channels and the conv runs as one 3x3 NHWC conv with a
        block-banded weight (`_conv3d_bandlanes`, the 3x3 CUDA kernel of
        ops/cuda/conv2d.py); every other 3x3x3 conv takes the 3x3x3 kernel.
    A modulated conv passes its style to the kernel, which scales the
    operand as it loads it: conv(x * s, W) without writing x * s out. Each
    kernel's plain version runs on a CPU tensor or when `plain=True`.
  * 1x1x1: a (B*D*H*W, Cin) @ (Cin, Cout) matrix product, under either impl.

The reference's per-sample modulated conv, w_b[o, i] = w[o, i] * s[b, i] with
no bias and no demodulation, equals conv(x_b * s_b, w) because the style
scales input channels only (tmdiff_tpu/ops/modconv.py pins this identity
against the torch reference golden).
"""
from __future__ import annotations

import torch

from tmdiff_tpu_torch.ops.cuda.conv2d import conv3x3_nhwc, conv3x3_nhwc_plain
from tmdiff_tpu_torch.ops.cuda.conv3d import banded_conv3d, conv3d_plain

IMPLS = ("banded", "auto")

# Output widths that "auto" keeps on the 3x3x3 kernel, or sends to the
# band-into-lanes form, whatever `_bandlanes_wins` would say otherwise: the
# JAX package's TMDIFF_CONV3D_AUTO_NATIVE and TMDIFF_CONV3D_AUTO_BANDLANES,
# empty as there by default.
AUTO_NATIVE_COUTS: frozenset = frozenset()
AUTO_BANDLANES_COUTS: frozenset = frozenset()


def _bandlanes_wins(d: int, kd: int, cout: int, h: int = 0) -> bool:
    """The JAX package's rule for the band-into-lanes lowering under "auto":
    every lane-starved (Cout < 128) multi-tap conv over more than one band,
    except deep-band half-lane levels (D >= 8 and Cout >= 64) at H <= 128
    (h = 0: unknown), which stay on the native 3-D conv; the override sets
    above come first."""
    native_excl = d >= 8 and cout >= 64 and (h == 0 or h <= 128)
    return (kd > 1 and d > 1 and cout < 128
            and (cout in AUTO_BANDLANES_COUTS or not native_excl)
            and cout not in AUTO_NATIVE_COUTS)


def banded_weight(kernel, d: int):
    """The (kh, kw, D*Cin, D*Cout) block-banded 2-D weight of a (kd, kh, kw,
    Cin, Cout) kernel over D bands: block (d_in, d_out) holds tap
    d_in - d_out + kd // 2 where that lies in the kernel, zero elsewhere."""
    kd, kh, kw, cin, cout = kernel.shape
    bands = torch.arange(d, device=kernel.device)
    idx = bands[:, None] - bands[None, :] + kd // 2  # tap per (d_in, d_out)
    valid = (idx >= 0) & (idx < kd)
    kg = kernel[idx.clamp(0, kd - 1)] * valid[:, :, None, None, None, None]
    return kg.permute(2, 3, 0, 4, 1, 5).reshape(kh, kw, d * cin, d * cout)


def _conv3d_bandlanes(x, kernel, style=None, bias=None, out=None, plain: bool = False):
    """SAME 3x3x3 conv with the bands folded into channels: (B, D, H, W, C)
    -> (B, H, W, D*C), one 3x3 conv with the block-banded weight (D/3 times
    the useful multiply-adds), and back. Style and bias go to the 2-D
    kernel, tiled over the bands; `out` accumulates after the unfold. Where
    the window overhangs the image (H or W < 3) the 3x3x3 kernel runs
    instead, as the JAX package routes such convs to the native conv."""
    b, d, h, w, cin = x.shape
    cout = kernel.shape[-1]
    if h < kernel.shape[1] or w < kernel.shape[2]:
        return (conv3d_plain if plain else banded_conv3d)(x, kernel, style, bias, out)
    x2 = x.permute(0, 2, 3, 1, 4).reshape(b, h, w, d * cin)
    s2 = None if style is None else style.repeat(1, d)
    b2 = None if bias is None else bias.repeat(d)
    y2 = (conv3x3_nhwc_plain if plain else conv3x3_nhwc)(x2, banded_weight(kernel, d), s2, b2)
    y = y2.view(b, h, w, d, cout).permute(0, 3, 1, 2, 4)
    return y.contiguous() if out is None else out.add_(y)


def conv3d(x, kernel, *, style=None, bias=None, out=None, plain: bool = False,
           impl: str = "banded"):
    """SAME stride-1 conv of x (B, D, H, W, Cin) with kernel (k, k, k, Cin,
    Cout), k in {1, 3}, of the style-scaled input, plus bias; added into `out`
    in place when given. `impl` picks the 3x3x3 lowering (module doc)."""
    if impl not in IMPLS:
        raise ValueError(f"unknown conv lowering {impl!r}; expected one of {IMPLS}")
    size = tuple(kernel.shape[:3])
    if size == (3, 3, 3):
        if impl == "auto" and _bandlanes_wins(x.shape[1], 3, kernel.shape[-1], x.shape[2]):
            return _conv3d_bandlanes(x, kernel, style, bias, out, plain)
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


def conv3d_cat(parts, kernel, *, bias=None, plain: bool = False, impl: str = "banded"):
    """conv3d(cat(parts, -1), kernel) + bias without materialising the concat:
    each part convolves with its slice of the kernel's input channels, and
    the parts accumulate into one output."""
    off, out = 0, None
    for p in parts:
        kpart = kernel[..., off:off + p.shape[-1], :]
        off += p.shape[-1]
        out = conv3d(p, kpart, bias=bias if out is None else None, out=out, plain=plain,
                     impl=impl)
    if off != kernel.shape[-2]:
        raise ValueError(f"parts have {off} channels, kernel takes {kernel.shape[-2]}")
    return out


def modulated_conv3d(x, kernel, style, *, plain: bool = False, impl: str = "banded"):
    """y_b = conv3d(x_b * s_b, kernel) for style (B, Cin), no bias."""
    return conv3d(x, kernel, style=style, plain=plain, impl=impl)
