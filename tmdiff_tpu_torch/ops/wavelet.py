"""Orthonormal 2-D Haar DWT / IDWT over channels-last (..., H, W, C) tensors,
as reshape butterflies (port of the fast path of tmdiff_tpu/ops/wavelet.py).

With a = x[2i, 2j], b = x[2i, 2j+1], c = x[2i+1, 2j], d = x[2i+1, 2j+1]:

    LL = (a+b+c+d)/2   LH = (a-b+c-d)/2   HL = (a+b-c-d)/2   HH = (a-b-c+d)/2

LH is the width detail and HL the height detail, as in the reference code
(`DWT_IDWT_Functions.py:47-58`), not its docstring.
"""
from __future__ import annotations

import torch


def _quads(x):
    *lead, h, w, c = x.shape
    if h % 2 or w % 2:
        raise ValueError(f"Haar DWT needs even H and W, got {h}x{w}")
    r = x.reshape(*lead, h // 2, 2, w // 2, 2, c)
    return r[..., 0, :, 0, :], r[..., 0, :, 1, :], r[..., 1, :, 0, :], r[..., 1, :, 1, :]


def dwt2d(x):
    """(..., H, W, C) -> (LL, LH, HL, HH), each (..., H/2, W/2, C)."""
    a, b, c, d = _quads(x)
    ll = (a + b + c + d) * 0.5
    lh = (a - b + c - d) * 0.5
    hl = (a + b - c - d) * 0.5
    hh = (a - b - c + d) * 0.5
    return ll, lh, hl, hh


def dwt2d_ll(x):
    """The LL band of dwt2d alone."""
    a, b, c, d = _quads(x)
    return (a + b + c + d) * 0.5


def idwt2d(ll, lh, hl, hh):
    """Inverse of dwt2d: four (..., h, w, C) bands -> (..., 2h, 2w, C)."""
    *lead, h2, w2, c = ll.shape
    a = (ll + lh + hl + hh) * 0.5
    b = (ll - lh + hl - hh) * 0.5
    cc = (ll + lh - hl - hh) * 0.5
    d = (ll - lh - hl + hh) * 0.5
    row0 = torch.stack([a, b], dim=-2)
    row1 = torch.stack([cc, d], dim=-2)
    out = torch.stack([row0, row1], dim=-4)
    return out.reshape(*lead, h2 * 2, w2 * 2, c)
