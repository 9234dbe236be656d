"""Pansharpening loss library (port of tmdiff_tpu/train/losses.py).

l1/l2/smooth_l1 are what the reference's training path uses; the other
terms distil its experimental loss zoo (train/loss_zoo.py holds the zoo
itself): spectral consistency through a low-pass degradation, PAN-gradient
matching through Sobel/Laplacian operators, high-pass matching and SSIM,
combined by CompositeLoss. All channels-last (B, H, W, C), differentiable.
"""
from __future__ import annotations

import dataclasses
import inspect
from typing import Callable, Sequence

import torch

from tmdiff_tpu_torch.utils import image_ops as ops


def l1(pred, target):
    return torch.mean(torch.abs(pred - target))


def l2(pred, target):
    return torch.mean((pred - target) ** 2)


def smooth_l1(pred, target):
    d = torch.abs(pred - target)
    return torch.mean(torch.where(d < 1.0, 0.5 * d ** 2, d - 0.5))


def spectral_consistency(pred, lr_ms, size: int = 5, sigma: float = 1.0, scale: int = 4):
    """Blur and subsample the prediction and match the low-resolution MS:
    the Wald-protocol spectral term."""
    lp = ops.gaussian_blur(pred, size, sigma)[:, ::scale, ::scale, :]
    return l1(lp, lr_ms)


def gradient_matching(pred, pan, mode: str = "sobel"):
    """Match the prediction's per-band spatial gradients to the PAN's."""
    pan_b = torch.broadcast_to(pan, pred.shape)
    if mode == "sobel":
        gx_p, gy_p = ops.sobel_gradient(pred)
        gx_t, gy_t = ops.sobel_gradient(pan_b)
        return 0.5 * (l1(gx_p, gx_t) + l1(gy_p, gy_t))
    if mode == "laplacian":
        return l1(ops.laplacian(pred), ops.laplacian(pan_b))
    raise NotImplementedError(mode)


def highpass_matching(pred, pan, size: int = 5, sigma: float = 1.0):
    """Match high-pass detail to the PAN's."""
    pan_b = torch.broadcast_to(pan, pred.shape)
    return l1(ops.get_hp(pred, size, sigma), ops.get_hp(pan_b, size, sigma))


def ssim_loss(pred, target, data_range: float = 1.0):
    return 1.0 - ops.ssim(pred, target, data_range)


@dataclasses.dataclass
class CompositeLoss:
    """Weighted sum of named loss terms, the shape every loss_funcN of the
    zoo instantiates. A term whose function takes only (pred, target) gets
    those; any other gets every keyword."""

    terms: Sequence[tuple[str, float, Callable]]

    def __call__(self, **kwargs):
        total = 0.0
        logs = {}
        for name, weight, fn in self.terms:
            val = fn(**kwargs) if _wants_kwargs(fn) else fn(kwargs["pred"], kwargs["target"])
            logs[name] = val
            total = total + weight * val
        return total, logs


def _wants_kwargs(fn):
    params = inspect.signature(fn).parameters
    return any(p.kind == p.VAR_KEYWORD for p in params.values()) or set(params) - {"pred",
                                                                                  "target"}


class AverageMeter:
    """Running average tracker (reference `core/mylib.py:156-176`)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val, n: int = 1):
        self.val = float(val)
        self.sum += float(val) * n
        self.count += n

    @property
    def avg(self):
        return self.sum / max(self.count, 1)
