"""WavBEST building blocks (port of tmdiff_tpu/models/blocks.py), eval mode.

Activations are (B, D, H, W, C) with the spectral bands as conv depth D.
Conv weights are kept in the JAX layout (kd, kh, kw, Cin, Cout); Linear
layers are torch's own (out, in). Module and parameter names follow the
reference torch classes, so a module's state_dict keys are the reference's
`sd.*` keys (utils/weights.py fills them):

  reference                     here
  AdaptionModulateBEST          AdaptionHead
  ResBlockModulateBEST          ResBlockModulate
  WaveletUPorDown               WaveletDown / WaveletUp
  ResblockDownOneModulateBEST   DownStage
  ResblockUpOneModulateBEST     UpStage
  FinalBlockModulateBEST        FinalBlock

A modulated conv's style Linear is a sibling of its conv in the reference
(`dense2` of a ResBlock's `conv21`, `dense1` of a wavelet block's `Conv_1`),
so it is one here too. The reference's dead parameters (the modulated convs'
biases, the wavelet blocks' `dense2`, the condition branch's time
projections) are not created. Dropout is identity in eval mode and is left
out. Decoder inputs may be tuples of channel parts; they are convolved as
their concat without materialising it.

Every conv module has a `plain` attribute: False sends its 3x3x3 convs to the
CUDA kernels on a CUDA tensor; True sends them to the kernels' plain versions
(see WavBEST.use_plain_conv). Its `impl` attribute picks the 3x3x3 lowering,
"banded" or "auto" (ops/modconv.py; see WavBEST.use_conv_impl).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from tmdiff_tpu_torch.ops import wavelet
from tmdiff_tpu_torch.ops.modconv import conv3d, conv3d_cat, modulated_conv3d


def swish(x):
    return F.silu(x)


def _lecun_normal(shape, fan_in):
    return nn.Parameter(torch.randn(shape) / math.sqrt(fan_in))


def linear(cin: int, cout: int, bias_value: float = 0.0) -> nn.Linear:
    """Linear with a lecun-normal weight and a constant bias, as the JAX
    package initialises its Dense layers (style projections start at 1)."""
    lin = nn.Linear(cin, cout)
    with torch.no_grad():
        lin.weight.normal_(0.0, 1.0 / math.sqrt(cin))
        lin.bias.fill_(bias_value)
    return lin


class Dense(nn.Module):
    """The reference's Linear wrapper: the Linear sits at `.dense`."""

    def __init__(self, cin: int, cout: int, bias_value: float = 0.0):
        super().__init__()
        self.dense = linear(cin, cout, bias_value)

    def forward(self, x):
        return self.dense(x)


class Conv3d(nn.Module):
    """Biased SAME 3-D conv; `x` may be a tuple of channel parts."""

    def __init__(self, cin: int, cout: int, k: int = 3):
        super().__init__()
        self.weight = _lecun_normal((k, k, k, cin, cout), k ** 3 * cin)
        self.bias = nn.Parameter(torch.zeros(cout))
        self.plain = False
        self.impl = "banded"

    def forward(self, x):
        if isinstance(x, tuple):
            return conv3d_cat(x, self.weight, bias=self.bias, plain=self.plain, impl=self.impl)
        return conv3d(x, self.weight, bias=self.bias, plain=self.plain, impl=self.impl)


class ModConv3d(nn.Module):
    """Bias-free conv whose input channels are scaled per sample by a style
    (B, Cin) computed by a sibling Linear."""

    def __init__(self, cin: int, cout: int, k: int = 3):
        super().__init__()
        self.weight = _lecun_normal((k, k, k, cin, cout), k ** 3 * cin)
        self.plain = False
        self.impl = "banded"

    def forward(self, x, style):
        return modulated_conv3d(x, self.weight, style, plain=self.plain, impl=self.impl)


class ResBlockModulate(nn.Module):
    """(+temb) -> swish -> conv -> swish -> modulated conv -> + 1x1-projected skip."""

    def __init__(self, cin: int, features: int, embed_dim: int, use_temb: bool = True):
        super().__init__()
        self.use_temb = use_temb
        self.conv20 = Conv3d(cin, features)
        self.conv21 = ModConv3d(features, features)
        self.dense2 = Dense(embed_dim, features, 1.0)
        if use_temb:
            self.dense1 = Dense(embed_dim, cin)
        if cin != features:
            self.res_conv = Conv3d(cin, features, 1)

    def forward(self, x, temb, zemb):
        parts = x if isinstance(x, tuple) else (x,)
        hs = parts
        if self.use_temb:
            d = self.dense1(temb)[:, None, None, None, :]
            off, hs = 0, []
            for p in parts:
                hs.append(p + d[..., off:off + p.shape[-1]])
                off += p.shape[-1]
        hs = tuple(swish(p) for p in hs)
        h = self.conv20(hs if isinstance(x, tuple) else hs[0])
        h = self.conv21(swish(h), self.dense2(zemb))
        if hasattr(self, "res_conv"):
            x = self.res_conv(x)
        elif isinstance(x, tuple):
            x = torch.cat(parts, dim=-1)
        return h + x


class AdaptionHead(nn.Module):
    """Entry head: 1x1x1 channel expansion -> swish -> modulated 3x3x3 conv."""

    def __init__(self, cin: int, features: int, embed_dim: int):
        super().__init__()
        self.conv20 = Conv3d(cin, features, 1)
        self.conv21 = ModConv3d(features, features)
        self.dense2 = Dense(embed_dim, features, 1.0)

    def forward(self, x, zemb):
        return self.conv21(swish(self.conv20(x)), self.dense2(zemb))


class WaveletDown(nn.Module):
    """Conv both branches, Haar-DWT H/W, keep LL/2; returns the conv branch's
    (LH, HL, HH) as the skip."""

    def __init__(self, features: int, embed_dim: int, use_temb: bool = True):
        super().__init__()
        self.use_temb = use_temb
        self.Conv_0 = Conv3d(features, features)
        self.Conv_2 = Conv3d(features, features, 1)
        self.Conv_1 = ModConv3d(features, features)
        self.dense1 = Dense(embed_dim, features, 1.0)
        if use_temb:
            self.Dense_0 = linear(embed_dim, features)

    def forward(self, x, temb, zemb):
        h = self.Conv_0(swish(x))
        x = self.Conv_2(x)
        h_ll, h_lh, h_hl, h_hh = wavelet.dwt2d(h)
        h = h_ll * 0.5
        x = wavelet.dwt2d_ll(x) * 0.5
        if self.use_temb:
            h = h + self.Dense_0(temb)[:, None, None, None, :]
        h = self.Conv_1(swish(h), self.dense1(zemb))
        return x + h, (h_lh, h_hl, h_hh)


class GroupedSkipConv(nn.Module):
    """3-group 3x3x3 conv over the three HF subbands without concatenating
    them: group g's block of the (3, 3, 3, C, 3F) kernel convolves part g."""

    def __init__(self, cin: int, features: int, groups: int = 3):
        super().__init__()
        self.features = features
        self.weight = _lecun_normal((3, 3, 3, cin, groups * features), 27 * cin)
        self.bias = nn.Parameter(torch.zeros(groups * features))
        self.plain = False
        self.impl = "banded"

    def forward(self, parts):
        f = self.features
        return tuple(
            conv3d(p, self.weight[..., g * f:(g + 1) * f],
                   bias=self.bias[g * f:(g + 1) * f], plain=self.plain, impl=self.impl)
            for g, p in enumerate(parts))


class WaveletUp(nn.Module):
    """Conv both branches, project the encoder's HF skip through a 3-group
    conv, IDWT back to full resolution."""

    def __init__(self, features: int, skip_channels: int, embed_dim: int):
        super().__init__()
        self.Conv_0 = Conv3d(features, features)
        self.Conv_2 = Conv3d(features, features, 1)
        self.convH_0 = nn.ModuleList([GroupedSkipConv(skip_channels, features)])
        self.Conv_1 = ModConv3d(features, features)
        self.dense1 = Dense(embed_dim, features, 1.0)
        self.Dense_0 = linear(embed_dim, features)

    def forward(self, x, temb, zemb, skip):
        h = self.Conv_0(swish(x))
        x = self.Conv_2(x)
        lh, hl, hh = (s * 2.0 for s in self.convH_0[0](tuple(s * 0.5 for s in skip)))
        h = wavelet.idwt2d(2.0 * h, lh, hl, hh)
        x = wavelet.idwt2d(2.0 * x, lh, hl, hh)
        h = h + self.Dense_0(temb)[:, None, None, None, :]
        h = self.Conv_1(swish(h), self.dense1(zemb))
        return x + h


class DownStage(nn.Module):
    """ResBlock (cin -> features) followed by wavelet downsampling."""

    def __init__(self, cin: int, features: int, embed_dim: int, use_temb: bool = True):
        super().__init__()
        self.conv20 = ResBlockModulate(cin, features, embed_dim, use_temb)
        self.down = WaveletDown(features, embed_dim, use_temb)

    def forward(self, x, temb, zemb):
        return self.down(self.conv20(x, temb, zemb), temb, zemb)


class UpStage(nn.Module):
    """ResBlock on the 3-way skip concat, then wavelet upsampling."""

    def __init__(self, cin: int, features: int, skip_channels: int, embed_dim: int):
        super().__init__()
        self.conv20 = ResBlockModulate(cin, features, embed_dim)
        self.up1 = WaveletUp(features, skip_channels, embed_dim)

    def forward(self, x, temb, zemb, skip):
        return self.up1(self.conv20(x, temb, zemb), temb, zemb, skip)


class FinalBlock(nn.Module):
    """Four ResBlocks, then a modulated 1x1x1 projection to one feature."""

    def __init__(self, cin: int, features: int, embed_dim: int, out_features: int = 1):
        super().__init__()
        self.conv20 = ResBlockModulate(cin, features, embed_dim)
        self.conv21 = ResBlockModulate(features, features, embed_dim)
        self.conv22 = ResBlockModulate(features, features, embed_dim)
        self.conv23 = ResBlockModulate(features, features, embed_dim)
        self.conv24 = ModConv3d(features, out_features, 1)
        self.dense2 = Dense(embed_dim, features, 1.0)

    def forward(self, x, temb, zemb):
        h = self.conv20(x, temb, zemb)
        h = self.conv21(h, temb, zemb)
        h = self.conv22(h, temb, zemb)
        h = self.conv23(h, temb, zemb)
        return self.conv24(swish(h), self.dense2(zemb))
