"""Diffusion beta schedules (port of tmdiff_tpu/diffusion/schedules.py),
float64 numpy, as the reference defines them
(`diffusion_general.py:29-132`):

  * linear: scale = 1000 / T, betas = linspace(scale 1e-6, scale 1e-2, T);
  * cosine: betas_for_alpha_bar with alpha_bar(t) = cos((t + 0.008) / 1.008 pi / 2)^2,
    clipped at max_beta = 0.999.
"""
from __future__ import annotations

import math

import numpy as np


def make_beta_schedule(schedule: str, n_timestep: int) -> np.ndarray:
    if schedule == "linear":
        scale = 1000.0 / n_timestep
        return np.linspace(scale * 1e-6, scale * 1e-2, n_timestep, dtype=np.float64)
    if schedule == "cosine":
        return betas_for_alpha_bar(
            n_timestep, lambda t: math.cos((t + 0.008) / 1.008 * math.pi / 2) ** 2)
    raise NotImplementedError(schedule)


def betas_for_alpha_bar(n: int, alpha_bar, max_beta: float = 0.999) -> np.ndarray:
    betas = []
    for i in range(n):
        t1 = i / n
        t2 = (i + 1) / n
        betas.append(min(1 - alpha_bar(t2) / alpha_bar(t1), max_beta))
    return np.array(betas, dtype=np.float64)
