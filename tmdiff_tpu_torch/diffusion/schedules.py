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
    """The JAX package's NoiseSchedule tables that the port uses, each
    computed in float64 and rounded once to float32, length T unless noted:
    the posterior mean coefficients and clipped log variance of the ancestral
    sampler, sqrt(1 / alpha_bar) and sqrt(1 / alpha_bar - 1), and the
    length-(T + 1) table sqrt(append(1, alphas_cumprod)), so that index
    t in [1, T] gives sqrt(alpha_bar_t)."""

    num_timesteps: int
    sqrt_alphas_cumprod_prev: torch.Tensor
    sqrt_recip_alphas_cumprod: torch.Tensor
    sqrt_recipm1_alphas_cumprod: torch.Tensor
    posterior_log_variance_clipped: torch.Tensor
    posterior_mean_coef1: torch.Tensor
    posterior_mean_coef2: torch.Tensor

    @classmethod
    def create(cls, schedule: str = "cosine", n_timestep: int = 1000) -> "NoiseSchedule":
        betas = make_beta_schedule(schedule, n_timestep)
        alphas = 1.0 - betas
        acp = np.cumprod(alphas, axis=0)
        acp_prev = np.append(1.0, acp[:-1])
        posterior_variance = betas * (1.0 - acp_prev) / (1.0 - acp)
        f32 = lambda a: torch.as_tensor(np.asarray(a).astype(np.float32))
        return cls(
            num_timesteps=int(n_timestep),
            sqrt_alphas_cumprod_prev=f32(np.sqrt(np.append(1.0, acp))),
            sqrt_recip_alphas_cumprod=f32(np.sqrt(1.0 / acp)),
            sqrt_recipm1_alphas_cumprod=f32(np.sqrt(1.0 / acp - 1.0)),
            posterior_log_variance_clipped=f32(np.log(np.maximum(posterior_variance, 1e-20))),
            posterior_mean_coef1=f32(betas * np.sqrt(acp_prev) / (1.0 - acp)),
            posterior_mean_coef2=f32((1.0 - acp_prev) * np.sqrt(alphas) / (1.0 - acp)))

    def to(self, device) -> "NoiseSchedule":
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self) if f.name != "num_timesteps"})
