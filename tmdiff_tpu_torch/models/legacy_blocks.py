"""Legacy non-wavelet UNet blocks (port of tmdiff_tpu/models/legacy_blocks.py):
the reference's earlier ablation of the modulated blocks, with a strided
conv for downsampling and a transposed conv for upsampling instead of the
Haar DWT / IDWT, and a FinalBlock of two ResBlocks.

Their ResBlocks are the main path's `ResBlockModulate` (blocks.py), so each
SAME 3x3x3 conv runs the 3x3x3 kernel (K1) on a CUDA tensor. The strided
and the transposed conv are no TPU kernel's function (XLA convs in the JAX
package) and run through ops/library_conv.py. The decoder's channel concat
[x, skip, cond] goes to the ResBlock as a tuple of parts, convolved without
materialising it. Module and parameter names are the JAX package's (flax
`up_kernel`/`up_bias` are the reference's `up1.weight`/`up1.bias`, which
utils/weights.py maps), so `from_flax` and `from_reference_state_dict`
fill them. Every block takes `dtype`, float32 or bfloat16, as the JAX
package's blocks do: parameters stay float32 and are cast at use, and a
library conv casts its input to `dtype` (flax's Conv of that dtype).
"""
from __future__ import annotations

import math

import torch
from torch import nn

from tmdiff_tpu_torch.models.blocks import ResBlockModulate, swish
from tmdiff_tpu_torch.ops.library_conv import KINDS, library_conv3d


class LibraryConv3d(nn.Module):
    """A biased conv of ops/library_conv.py's `kind`, weight (kd, kh, kw,
    Cin, Cout) lecun-normal as flax initialises it; `bias` a tensor to start
    from (zeros by default, as flax's). Runs in `dtype`."""

    def __init__(self, cin: int, cout: int, kind: str, bias=None, dtype=torch.float32):
        super().__init__()
        size = KINDS[kind][0]
        fan_in = math.prod(size) * cin
        self.weight = nn.Parameter(torch.randn(*size, cin, cout) / math.sqrt(fan_in))
        self.bias = nn.Parameter(torch.zeros(cout) if bias is None else bias)
        self.kind = kind
        self.dtype = dtype

    def forward(self, x):
        return library_conv3d(x.to(self.dtype), self.weight, self.bias, kind=self.kind)


class StridedDownStage(nn.Module):
    """ResBlock, swish, then the stride-(1, 2, 2) conv (H -> (H - 1) // 2)."""

    def __init__(self, cin: int, features: int, embed_dim: int, dtype=torch.float32):
        super().__init__()
        self.conv20 = ResBlockModulate(cin, features, embed_dim, dtype=dtype)
        self.down = LibraryConv3d(features, features, "strided", dtype=dtype)

    def forward(self, x, temb, zemb, rng=None):
        return self.down(swish(self.conv20(x, temb, zemb, rng)))


class TransposedUpStage(nn.Module):
    """[x, skip, cond] -> ResBlock -> swish -> the transposed conv ×2
    (h -> 2 h + 2); `cin` counts the three parts' channels."""

    def __init__(self, cin: int, features: int, embed_dim: int, dtype=torch.float32):
        super().__init__()
        self.conv20 = ResBlockModulate(cin, features, embed_dim, dtype=dtype)
        self.up1 = LibraryConv3d(features, features, "transposed", dtype=dtype)

    def forward(self, x, temb, zemb, skip, cond, rng=None):
        return self.up1(swish(self.conv20((x, skip, cond), temb, zemb, rng)))


class LegacyFinalBlock(nn.Module):
    """Two ResBlocks with a swish between; x may be a tuple of parts."""

    def __init__(self, cin: int, features: int, embed_dim: int, dtype=torch.float32):
        super().__init__()
        self.conv20 = ResBlockModulate(cin, features, embed_dim, dtype=dtype)
        self.conv21 = ResBlockModulate(features, features, embed_dim, dtype=dtype)

    def forward(self, x, temb, zemb, rng=None):
        h = swish(self.conv20(x, temb, zemb, rng))
        return self.conv21(h, temb, zemb, rng)
