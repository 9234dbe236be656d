"""Sinusoidal timestep embeddings (reference `gamma_embedding`,
`Hyper_unet_general.py:80-97`): frequencies exp(-log(10000) k / half) for
k < half, embedding [cos(t f), sin(t f)], zero-padded when dim is odd."""
from __future__ import annotations

import math

import torch


def gamma_embedding(timesteps, dim: int, max_period: float = 10000.0):
    """(N,) fractional timesteps -> (N, dim) fp32 embedding."""
    half = dim // 2
    freqs = torch.exp(
        -math.log(max_period)
        * torch.arange(half, dtype=torch.float32, device=timesteps.device) / half)
    args = timesteps.to(torch.float32)[:, None] * freqs[None]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
    return emb
