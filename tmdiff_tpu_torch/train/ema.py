"""Exponential moving average of parameters (port of tmdiff_tpu/train/ema.py).

While step <= start_iter the EMA copies the parameters; afterwards
ema = decay * ema + (1 - decay) * params (reference `EmaUpdater.py:23-38`).
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch


def ema_factor(step: int, decay: float = 0.9999, start_iter: int = 0) -> np.float32:
    """The factor of EMA step `step`: decay once step > start_iter, else 0
    (a copy); float32, as the JAX package computes it."""
    return np.float32(decay) if step > start_iter else np.float32(0.0)


@torch.no_grad()
def ema_update(ema_params: Sequence[torch.Tensor], params: Sequence[torch.Tensor],
               step: Optional[int] = None, decay: float = 0.9999, start_iter: int = 0, *,
               factor: Optional[torch.Tensor] = None):
    """One EMA step, in place on `ema_params` (returned): ema * f +
    params * (1 - f) in float32, f = ema_factor(step, decay, start_iter).
    `factor`, a 0-d float32 tensor on the parameters' device, gives f
    instead (the trainer fills it before each step, so a captured step
    reads it on the device)."""
    ema_params = list(ema_params)
    if factor is None:
        factor = torch.tensor(ema_factor(step, decay, start_iter), device=ema_params[0].device)
    torch._foreach_mul_(ema_params, factor)
    torch._foreach_add_(ema_params, torch._foreach_mul([p.detach() for p in params], 1 - factor))
    return ema_params
