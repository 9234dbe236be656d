"""Diffusion beta schedules (port of tmdiff_tpu/diffusion/schedules.py),
float64 numpy, as the reference defines them
(`diffusion_general.py:29-132`):

  * linear: scale = 1000 / T, betas = linspace(scale 1e-6, scale 1e-2, T);
  * cosine: betas_for_alpha_bar with alpha_bar(t) = cos((t + 0.008) / 1.008 pi / 2)^2,
    clipped at max_beta = 0.999.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch


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


@dataclasses.dataclass(frozen=True)
class NoiseSchedule:
    """The training part of the JAX package's NoiseSchedule: T and the
    length-(T + 1) fp32 table sqrt(append(1, alphas_cumprod)), so that index
    t in [1, T] gives sqrt(alpha_bar_t) (computed in float64, rounded once)."""

    num_timesteps: int
    sqrt_alphas_cumprod_prev: torch.Tensor

    @classmethod
    def create(cls, schedule: str = "cosine", n_timestep: int = 1000) -> "NoiseSchedule":
        acp = np.cumprod(1.0 - make_beta_schedule(schedule, n_timestep), axis=0)
        table = torch.as_tensor(np.sqrt(np.append(1.0, acp)).astype(np.float32))
        return cls(int(n_timestep), table)

    def to(self, device) -> "NoiseSchedule":
        return dataclasses.replace(
            self, sqrt_alphas_cumprod_prev=self.sqrt_alphas_cumprod_prev.to(device))
