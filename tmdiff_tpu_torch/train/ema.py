"""Exponential moving average of parameters (port of tmdiff_tpu/train/ema.py).

While step <= start_iter the EMA copies the parameters; afterwards
ema = decay * ema + (1 - decay) * params (reference `EmaUpdater.py:23-38`).
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch


@torch.no_grad()
def ema_update(ema_params: Sequence[torch.Tensor], params: Sequence[torch.Tensor], step: int,
               decay: float = 0.9999, start_iter: int = 0):
    """One EMA step, in place on `ema_params` (returned). The factor and its
    complement are float32, as the JAX package computes them."""
    factor = np.float32(decay) if step > start_iter else np.float32(0.0)
    ema_params = list(ema_params)
    torch._foreach_mul_(ema_params, float(factor))
    torch._foreach_add_(ema_params, [p.detach() for p in params],
                        alpha=float(np.float32(1.0) - factor))
    return ema_params
