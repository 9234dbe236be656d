"""Gaussian diffusion (port of tmdiff_tpu/diffusion/gaussian.py): forward
noising, the pixel losses, the x0-prediction denoising loss, x0 clipping,
classifier-free-guidance condition dropout, and the samplers that walk the
integer model-time grid: ancestral, DDIM, block-cached DDIM and the 1-NFE
regression shortcut.

As in the reference (`p_losses_dynamic`), training draws an integer t in
[1, T] per sample, noises the residual with gamma = sqrt(alpha_bar_t), feeds
the integer timestep to the denoiser and takes the L1/L2/smooth-L1 distance
between the clean residual and the network's output: the network predicts
x0. Randomness comes from an explicit torch.Generator; `diffusion_loss`
also takes t and the noise, and the samplers x_T (and the ancestral
sampler its per-step noise), so that a test can hand them the JAX
package's draws.

Where the JAX package runs a sampler as one `lax.scan`, the port runs the
same steps as a Python loop: the arithmetic and its order are the same, and
a "static" refresh schedule of the block-cached sampler is decomposed into
its chunks up front, where a runtime one (a bool tensor) is read step by
step.

On a sharded placement `mesh` (parallel/mesh.py) the samplers run on this
rank's shard: the ancestral sampler draws each step's noise at the global
shape and keeps its shard, and the dynamic x0 clip takes its maximum over
every rank. `shape` is then the shard's.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np

import torch
import torch.distributed as dist

from tmdiff_tpu_torch.diffusion.schedules import NoiseSchedule
from tmdiff_tpu_torch.parallel import mesh as mesh_lib

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


def clip_x0(x_recon, mode: str = "static", mesh=None):
    if mode == "static":
        return torch.clamp(x_recon, -1.0, 1.0)
    if mode == "dynamic":
        peak = x_recon.abs().max()
        if mesh is not None and (mesh.halo or mesh.split_batch):
            peak = mesh_lib.all_reduce_(peak, mesh, op=dist.ReduceOp.MAX)
        return x_recon / torch.clamp(peak, min=1.0)
    if mode == "none":
        return x_recon
    raise NotImplementedError(mode)


def cfg_dropout_condition(generator: Optional[torch.Generator], cond, p_uncond: float,
                          per_sample: bool = False, mesh=None):
    """Training-side classifier-free guidance: zero the conditioning with
    probability p_uncond, one coin per batch (the reference's helper) or,
    with per_sample=True, one coin per example (what the trainer uses). On a
    sharded placement `mesh` the coins are drawn for the global batch and
    this rank's are kept."""
    if per_sample:
        if mesh is None:
            keep = torch.rand(cond.shape[0], generator=generator, device=cond.device)
        else:
            keep = mesh.shard(torch.rand(mesh.global_shape(cond.shape)[0], generator=generator,
                                         device=cond.device))
        keep = keep >= p_uncond
        return cond * keep.reshape((-1,) + (1,) * (cond.dim() - 1)).to(cond.dtype)
    drop = torch.rand((), generator=generator, device=cond.device) < p_uncond
    return torch.where(drop, torch.zeros_like(cond), cond)


def posterior_mean_logvar(ns: NoiseSchedule, x_start, x_t, t: int):
    mean = ns.posterior_mean_coef1[t] * x_start + ns.posterior_mean_coef2[t] * x_t
    return mean, ns.posterior_log_variance_clipped[t]


def predict_start_from_noise(ns: NoiseSchedule, x_t, t: int, noise):
    return ns.sqrt_recip_alphas_cumprod[t] * x_t - ns.sqrt_recipm1_alphas_cumprod[t] * noise


def _timesteps(b: int, t: int, device):
    return torch.full((b,), int(t), dtype=torch.long, device=device)


def _normal(shape, generator, device):
    return torch.randn(shape, generator=generator, device=device, dtype=torch.float32)


def ancestral_sample(denoise_fn: DenoiseFn, ns: NoiseSchedule, generator, pan, ms, shape, *,
                     clip_mode: str = "static", legacy_noise_inversion: bool = False,
                     num_frames: Optional[int] = None, x_init=None, step_noise=None,
                     mesh=None):
    """The full T-step ancestral reverse loop (`p_sample_loop`). `ns` must
    be on the device of pan/ms (or of x_init).

    Returns the final residual, or (final, frames) when `num_frames` asks
    for snapshots: frame f is the state after step t where t % (T //
    num_frames) == 0. `x_init` (x_T) and `step_noise` ((T, *shape), row t
    the noise added after step t; row 0 unused) replace the draws from
    `generator` (x_T first, then one draw per step t > 0, from t = T - 1
    down). With `legacy_noise_inversion` the network's output is inverted
    as a noise prediction, as the reference's default `p_mean_variance`
    does. On a sharded placement `mesh`, x_T and each step's noise are
    drawn at the global shape and sharded; `x_init` and `step_noise` are
    this rank's shards."""
    T = ns.num_timesteps
    device = (x_init if x_init is not None else ms).device
    draw = lambda: (_normal(shape, generator, device) if mesh is None else
                    mesh.shard(_normal(mesh.global_shape(shape), generator, device)))
    x = x_init if x_init is not None else draw()
    interval = max(1, T // (num_frames or 10))
    frames = (torch.zeros(((T + interval - 1) // interval, *shape), device=device)
              if num_frames else None)
    for t in range(T - 1, -1, -1):
        out = denoise_fn(x, _timesteps(shape[0], t + 1, device), pan, ms)
        x_recon = predict_start_from_noise(ns, x, t, out) if legacy_noise_inversion else out
        mean, logvar = posterior_mean_logvar(ns, clip_x0(x_recon, clip_mode, mesh), x, t)
        if t > 0:
            noise = step_noise[t] if step_noise is not None else draw()
        else:
            noise = torch.zeros(shape, device=device)
        x = mean + noise * torch.exp(0.5 * logvar)
        if frames is not None and t % interval == 0:
            frames[t // interval] = x
    if num_frames:
        return x, frames
    return x


def alpha_at(ns: NoiseSchedule, u, x):
    """sqrt(alpha_bar_u): 0-d for an int u, (B, 1, ...) broadcasting
    against x for a (B,) tensor."""
    a = ns.sqrt_alphas_cumprod_prev[u]
    return a.reshape((-1,) + (1,) * (x.dim() - 1)) if a.dim() else a


def ddim_jump(ns: NoiseSchedule, x_t, x0_hat, t, s):
    """One deterministic DDIM (eta = 0) jump t -> s in the x0
    parameterisation,

        x_s = alpha_s x0_hat + (sigma_s / sigma_t) (x_t - alpha_t x0_hat),

    alpha(u) = `ns.sqrt_alphas_cumprod_prev[u]`, so a jump to s = 0 returns
    x0_hat. `t`, `s`: ints or (B,) integer tensors, t >= 1."""
    sigma = lambda au: torch.sqrt(torch.clamp(1.0 - au * au, min=0.0))
    a_t, a_s = alpha_at(ns, t, x_t), alpha_at(ns, s, x_t)
    ratio = sigma(a_s) / torch.clamp(sigma(a_t), min=1e-12)
    return a_s * x0_hat + ratio * (x_t - a_t * x0_hat)


def _ddim_grid(T: int, steps: int) -> list:
    grid = np.round(np.linspace(T, 0, steps + 1)).astype(np.int32)
    if len(np.unique(grid)) != steps + 1:
        raise ValueError(f"steps={steps} > T={T}: grid degenerates")
    return [(int(t), int(s)) for t, s in zip(grid[:-1], grid[1:])]


def ddim_sample(denoise_fn: DenoiseFn, ns: NoiseSchedule, generator, pan, ms, shape, *,
                steps: int = 50, clip_mode: str = "static", x_init=None, mesh=None):
    """Deterministic DDIM: `steps` x0-parameterised jumps down the uniform
    integer grid T = t_0 > ... > t_steps = 0, the sampler a progressively
    distilled N-step student is trained for (train/distill.py)."""
    pairs = _ddim_grid(ns.num_timesteps, steps)
    device = (x_init if x_init is not None else ms).device
    x = x_init if x_init is not None else _normal(shape, generator, device)
    for t, s in pairs:
        x0 = denoise_fn(x, _timesteps(shape[0], t, device), pan, ms)
        x = ddim_jump(ns, x, clip_x0(x0, clip_mode, mesh), t, s)
    return x


def _tree_map(fn, *trees):
    if isinstance(trees[0], (tuple, list)):
        return type(trees[0])(_tree_map(fn, *parts) for parts in zip(*trees))
    return fn(*trees)


def refresh_chunks(refresh_mask: Sequence[bool], steps: int) -> list:
    """The lengths of the chunks a static refresh schedule makes: each
    refresh step opens one (a full call, then reuse calls to the next
    refresh). Checks the mask's length and that it starts with a refresh.
    A tensor mask is read back to the host once."""
    if isinstance(refresh_mask, torch.Tensor):
        refresh_mask = refresh_mask.tolist()
    mask = np.asarray(refresh_mask, bool)
    if mask.shape != (steps,):
        raise ValueError(f"refresh_mask must have length steps={steps}, got shape {mask.shape}")
    if not mask[0]:
        raise ValueError("refresh_mask[0] must be True — no cached trunk exists yet")
    starts = [i for i in range(steps) if mask[i]]
    return [hi - lo for lo, hi in zip(starts, starts[1:] + [steps])]


def ddim_sample_blockcached(full_fn, reuse_fn, ns: NoiseSchedule, generator, pan, ms, shape, *,
                            steps: int = 20, refresh_every: int = 2, clip_mode: str = "static",
                            x_init=None, forecast: bool = False, refresh_mask=None,
                            mesh=None):
    """DDIM with cross-step deep-feature caching: a refresh step calls
    `full_fn(x, t) -> (x0_hat, deep)` (the whole network, returning its
    deep-trunk features), the steps up to the next refresh call
    `reuse_fn(x, t, deep) -> x0_hat` (the shallow path on the cached
    trunk). With `refresh_every=1` this is `ddim_sample`.

    The schedule: every `refresh_every`-th step (steps % refresh_every == 0),
    or `refresh_mask` (length `steps`, mask[0] True, exclusive with
    `forecast`): a sequence of bools or a bool tensor, read once on the host
    and decomposed into chunks before the first step.

    `forecast=True` extrapolates the trunk linearly instead of reusing it
    stale: reuse step i in [1, refresh_every) of chunk k consumes
    deep_k + (i / refresh_every) (deep_k - deep_{k-1}), with a zero slope in
    the first chunk."""
    if refresh_mask is None and steps % refresh_every:
        raise ValueError(f"steps={steps} must be divisible by refresh_every={refresh_every}")
    pairs = _ddim_grid(ns.num_timesteps, steps)
    device = (x_init if x_init is not None else ms).device
    x = x_init if x_init is not None else _normal(shape, generator, device)
    b = shape[0]

    def jump(x, x0, t, s):
        return ddim_jump(ns, x, clip_x0(x0, clip_mode, mesh), t, s)

    def refresh(x, t, s):
        x0, deep = full_fn(x, _timesteps(b, t, device))
        return jump(x, x0, t, s), deep

    def reuse(x, t, s, deep):
        return jump(x, reuse_fn(x, _timesteps(b, t, device), deep), t, s)

    if refresh_mask is not None:
        if forecast:
            raise ValueError("forecast is not supported with refresh_mask")
        lens = refresh_chunks(refresh_mask, steps)
    else:
        lens = [refresh_every] * (steps // refresh_every)

    fracs = np.arange(1, refresh_every, dtype=np.float32) / np.float32(refresh_every)
    i, deep_prev, have_prev = 0, None, 0.0
    for n in lens:
        t0, s0 = pairs[i]
        x, deep = refresh(x, t0, s0)
        if forecast:
            if deep_prev is None:
                deep_prev = _tree_map(torch.zeros_like, deep)
            slope = _tree_map(lambda d, p: have_prev * (d - p), deep, deep_prev)
        for k, (t, s) in enumerate(pairs[i + 1:i + n]):
            deep_k = (_tree_map(lambda d, sl: d + float(fracs[k]) * sl, deep, slope)
                      if forecast else deep)
            x = reuse(x, t, s, deep_k)
        deep_prev, have_prev, i = deep, 1.0, i + n
    return x


def regression_sample(denoise_fn: DenoiseFn, generator, pan, ms, shape, *, x_init=None):
    """The 1-NFE regression shortcut (`sample_by_regression`): one call at
    t = T + 1 on x_T (from `generator` unless given)."""
    device = (x_init if x_init is not None else ms).device
    x_T = x_init if x_init is not None else _normal(shape, generator, device)
    return denoise_fn(x_T, _timesteps(shape[0], 1001, device), pan, ms)


def cfg_denoise(denoise_fn: DenoiseFn, guidance: float):
    """Classifier-free guidance over the MS condition
    (`classifier_free_guidance_sample`): the unconditional branch zeroes MS,
    both branches in one call on the doubled batch."""

    def fn(x, t, pan, ms):
        out = denoise_fn(torch.cat([x, x]), torch.cat([t, t]), torch.cat([pan, pan]),
                         torch.cat([ms, torch.zeros_like(ms)]))
        cond, uncond = out.chunk(2)
        return (guidance + 1.0) * cond - guidance * uncond

    return fn
