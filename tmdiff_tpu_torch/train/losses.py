"""Pixel losses and a running average (port of the active part of
tmdiff_tpu/train/losses.py: l1/l2/smooth_l1 are what the reference's
training path uses; the loss zoo and CompositeLoss are not ported yet)."""
from __future__ import annotations

import torch


def l1(pred, target):
    return torch.mean(torch.abs(pred - target))


def l2(pred, target):
    return torch.mean((pred - target) ** 2)


def smooth_l1(pred, target):
    d = torch.abs(pred - target)
    return torch.mean(torch.where(d < 1.0, 0.5 * d ** 2, d - 0.5))


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
