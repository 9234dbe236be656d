"""Gaussian diffusion, the training part (port of
tmdiff_tpu/diffusion/gaussian.py): forward noising, the pixel losses, the
x0-prediction denoising loss, x0 clipping and classifier-free-guidance
condition dropout.

As in the reference (`p_losses_dynamic`), training draws an integer t in
[1, T] per sample, noises the residual with gamma = sqrt(alpha_bar_t), feeds
the integer timestep to the denoiser and takes the L1/L2/smooth-L1 distance
between the clean residual and the network's output: the network predicts
x0. Randomness comes from an explicit torch.Generator; `diffusion_loss`
also takes t and the noise, so that a test can hand it the JAX package's
draws.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from tmdiff_tpu_torch.diffusion.schedules import NoiseSchedule

# denoise_fn(x_t, t, pan, ms) -> x0 prediction; conditioning closed over.
DenoiseFn = Callable[..., torch.Tensor]


def q_sample(x_start, sqrt_alpha_cumprod, noise):
    """Forward noising with a (possibly continuous) sqrt(alpha_bar) level."""
    c = sqrt_alpha_cumprod
    return c * x_start + torch.sqrt(1.0 - c ** 2) * noise


def pixel_loss(pred, target, loss_type: str = "l1"):
    if loss_type == "l1":
        return torch.mean(torch.abs(target - pred))
    if loss_type == "l2":
        return torch.mean((target - pred) ** 2)
    if loss_type == "smooth_l1":
        diff = torch.abs(target - pred)
        return torch.mean(torch.where(diff < 1.0, 0.5 * diff ** 2, diff - 0.5))
    raise NotImplementedError(loss_type)


def diffusion_loss(denoise_fn: DenoiseFn, ns: NoiseSchedule, generator: Optional[torch.Generator],
                   res, pan, ms, loss_type: str = "l1", *, t=None, noise=None):
    """Monte-Carlo denoising loss over a batch of residuals (B, C, H, W). t
    (B,) integers in [1, T] and the noise (res's shape) are drawn from
    `generator`, in that order, unless given. `ns` must be on res's device."""
    b = res.shape[0]
    if t is None:
        t = torch.randint(1, ns.num_timesteps + 1, (b,), generator=generator, device=res.device)
    if noise is None:
        noise = torch.randn(res.shape, generator=generator, device=res.device, dtype=res.dtype)
    gamma = ns.sqrt_alphas_cumprod_prev[t][:, None, None, None]
    x_recon = denoise_fn(q_sample(res, gamma, noise), t, pan, ms)
    return pixel_loss(x_recon, res, loss_type)


def clip_x0(x_recon, mode: str = "static"):
    if mode == "static":
        return torch.clamp(x_recon, -1.0, 1.0)
    if mode == "dynamic":
        return x_recon / torch.clamp(x_recon.abs().max(), min=1.0)
    if mode == "none":
        return x_recon
    raise NotImplementedError(mode)


def cfg_dropout_condition(generator: Optional[torch.Generator], cond, p_uncond: float,
                          per_sample: bool = False):
    """Training-side classifier-free guidance: zero the conditioning with
    probability p_uncond, one coin per batch (the reference's helper) or,
    with per_sample=True, one coin per example (what the trainer uses)."""
    if per_sample:
        keep = torch.rand(cond.shape[0], generator=generator, device=cond.device) >= p_uncond
        return cond * keep.reshape((-1,) + (1,) * (cond.dim() - 1)).to(cond.dtype)
    drop = torch.rand((), generator=generator, device=cond.device) < p_uncond
    return torch.where(drop, torch.zeros_like(cond), cond)
