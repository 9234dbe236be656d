"""PGCU: probability-guided cross-modal MS upsampling (port of
tmdiff_tpu/ops/pgcu.py; reference `utils/PGCU.py:18-103`).

Per band, fine-scale feature vectors (PAN and the nearest-upsampled MS)
attend to coarse-scale vectors; the softmax over the coarse grid weighs the
coarse values into the 4x upsampled MS. The reference's loop over bands with
per-band Linear + LayerNorm is one einsum over a (bands, VecLen, L) tensor
with a per-band norm (`_BandProjection`), as in the JAX module.
Channels-last.

The convs are XLA convs in JAX (no Pallas kernel): here PyTorch's conv2d
(cuDNN on the card, fp32 with TF32 off) through ops/library_conv.py's
`conv_nd`, 3x3 SAME at stride 1, and the down-sampling blocks' stride-2 conv
padded (1, 1) on each side as torch's Conv2d(k=3, stride=2, padding=1) and
the JAX module do (XLA's SAME would pad (0, 1)). The nearest resize is
`jax.image.resize(..., "nearest")`'s: output i reads input floor((i + 0.5)
* in / out). Conv kernels keep the flax layout (kh, kw, Cin, Cout) and the
modules the flax names, so utils/weights.py::from_flax fills them.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from tmdiff_tpu_torch.ops.library_conv import conv_nd


class Conv2d(nn.Module):
    """flax nn.Conv (3x3 by default) on channels-last (B, H, W, C)."""

    def __init__(self, cin: int, cout: int, stride: int = 1, padding="SAME", k: int = 3):
        super().__init__()
        self.stride, self.padding = stride, padding
        self.weight = nn.Parameter(torch.randn(k, k, cin, cout) / math.sqrt(k * k * cin))
        self.bias = nn.Parameter(torch.zeros(cout))

    def forward(self, x):
        return conv_nd(x, self.weight, self.stride, self.padding) + self.bias.to(x.dtype)


def resize_nearest(x, h: int, w: int):
    """jax.image.resize(x, (B, h, w, C), "nearest") of x (B, H, W, C)."""
    def index(n_in, n_out):
        i = torch.floor((torch.arange(n_out, device=x.device, dtype=torch.float64) + 0.5)
                        * (n_in / n_out)).long()
        return i.clamp_(max=n_in - 1)

    return x[:, index(x.shape[1], h)][:, :, index(x.shape[2], w)]


class DownSamplingBlock(nn.Module):
    """3x3 conv at stride 2, padded (1, 1) (torch's padding=1), then a 2x2
    max pool of stride 2."""

    def __init__(self, cin: int, features: int):
        super().__init__()
        self.Conv = Conv2d(cin, features, stride=2, padding=((1, 1), (1, 1)))

    def forward(self, x):
        h = self.Conv(x).permute(0, 3, 1, 2)
        return F.max_pool2d(h, 2, 2).permute(0, 2, 3, 1)


class _BandProjection(nn.Module):
    """Per-band Linear(VecLen -> L) and per-band LayerNorm over L, as one
    einsum: (..., VecLen) -> (..., bands, L). `weight` is the flax
    `kernel`, (bands, VecLen, L)."""

    def __init__(self, vec_len: int, bands: int, band_vec_len: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.randn(bands, vec_len, band_vec_len) / math.sqrt(vec_len))
        self.bias = nn.Parameter(torch.zeros(bands, band_vec_len))
        self.norm_scale = nn.Parameter(torch.ones(bands, band_vec_len))
        self.norm_bias = nn.Parameter(torch.zeros(bands, band_vec_len))

    def forward(self, x):
        h = torch.einsum("...v,cvl->...cl", x, self.weight) + self.bias
        mean = h.mean(dim=-1, keepdim=True)
        var = h.var(dim=-1, unbiased=False, keepdim=True)
        h = (h - mean) * torch.rsqrt(var + self.eps)
        return h * self.norm_scale + self.norm_bias


class PGCU(nn.Module):
    """4x probability-guided upsampling: (pan (B, H, W, 1), ms (B, H/4,
    W/4, C)) -> (B, H, W, C)."""

    def __init__(self, channels: int = 4, vec_len: int = 128, num_blocks: int = 3):
        super().__init__()
        c = channels
        self.channels, self.band_len = c, vec_len // c
        self.FMConv = Conv2d(c, c)
        self.FPConv = Conv2d(1, c)
        self.FConv = Conv2d(2 * c, vec_len)
        # coarse towers: num_blocks blocks from the PAN, one fewer from the MS
        self.towers = {}
        for prefix, cin, n in (("GM", c, num_blocks - 1), ("GP", 1, num_blocks),
                               ("VM", c, num_blocks - 1), ("VP", 1, num_blocks)):
            names = []
            for i in range(n):
                self.add_module(f"{prefix}DSBlock{i}", DownSamplingBlock(cin if i == 0 else c, c))
                names.append(f"{prefix}DSBlock{i}")
            self.towers[prefix] = names
        self.GConv = Conv2d(2 * c, vec_len)
        self.VConv = Conv2d(2 * c, c)
        self.FLinear = _BandProjection(vec_len, c, self.band_len)
        self.GLinear = _BandProjection(vec_len, c, self.band_len)
        self.FineAdjust = Conv2d(c, c)

    def _tower(self, x, prefix):
        for name in self.towers[prefix]:
            x = getattr(self, name)(x)
        return x

    def forward(self, pan, ms):
        up_ms = resize_nearest(ms, pan.shape[1], pan.shape[2])
        f = self.FConv(torch.cat([self.FMConv(up_ms), self.FPConv(pan)], dim=-1))
        g = self.GConv(torch.cat([self._tower(ms, "GM"), self._tower(pan, "GP")], dim=-1))
        v = self.VConv(torch.cat([self._tower(ms, "VM"), self._tower(pan, "VP")], dim=-1))
        b, hh, ww, _ = f.shape
        _, oh, ow, _ = g.shape
        c = self.channels
        fq = self.FLinear(f)  # (B, H, W, C, L)
        gk = self.GLinear(g)  # (B, oh, ow, C, L)
        logits = torch.einsum("bhwcl,bijcl->bhwcij", fq, gk) / math.sqrt(self.band_len)
        prob = torch.softmax(logits.reshape(b, hh, ww, c, oh * ow), dim=-1)
        out = torch.einsum("bhwcij,bijc->bhwc", prob.reshape(b, hh, ww, c, oh, ow), v)
        return self.FineAdjust(out)
