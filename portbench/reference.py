"""The plain reference's shared part: what every model family's reference
(`portbench/references/<family>.py`) computes with. The operand precisions
(`products`, `PRECISIONS`), the noise schedules, the gamma embedding, the
two DDIM samplers the serving presets use and the training step (x0 L1
loss, AdamW with the HF linear warm-up, no clipping, the EMA) around a
family's forward, written in plain PyTorch from the equations.

It imports torch and numpy only: nothing of the program under test, of JAX
or of the JAX package. It computes in float32 with cuDNN's or the CPU's
plain convolutions and products, TF32 off (`products`). `precision` "fp8"
rounds every operand of every conv and Linear product, forward and
backward, to float8 e4m3: the control of a bfloat16 configuration; the
control of a float32 one is the card's own TF32 products
(`products(allow_tf32=True)`).

A family's reference model has `encode(pan, ms, prompt, rng=None,
**extra)`, the condition, and `denoise(x_t, t, cond, deep=None, level=1,
rng=None)`, the x0 prediction and the deep trunk's features (for the
block-cached sampler). `extra` is what a request or a batch carries beyond
PAN, MS and the sensor prompt (the family's `request_extra` and
`batch_extra`, stacked per key over a block's rows).

Training draws what the program draws, from the same seeds and in the same
order, so that one step of the reference is the program's step computed
again: t and the noise from the "tn" generator, the dropout masks from the
"drop" generator (each part and site in turn, at the (B, D, H, W, C) shape
of the program's activations), seeded per step by `step_seeds`.
"""
from __future__ import annotations

import contextlib
import math

import numpy as np
import torch

PROMPT_DIM = 768


# -- operand precision ----------------------------------------------------------


def round_fp8(t):
    """float32 rounded to float8 e4m3 (saturating at its largest finite 448)."""
    return t.clamp(-448.0, 448.0).to(torch.float8_e4m3fn).to(torch.float32)


class _Rounded(torch.autograd.Function):
    """The value rounded on the way in, and its gradient rounded on the way
    back, each by `round_fn`: around a conv or a Linear, the operands of
    its forward product (x, w) and of its backward products (the saved x
    and w, and the output's gradient, rounded by the output's _Rounded)."""

    @staticmethod
    def forward(ctx, t, round_fn, inward):
        ctx.round_fn, ctx.inward = round_fn, inward
        return round_fn(t) if inward else t.clone()

    @staticmethod
    def backward(ctx, g):
        return (g if ctx.inward else ctx.round_fn(g)), None, None


def rounding(round_fn):
    """(round an operand, round the gradient of an output) in one precision."""
    return (lambda t: _Rounded.apply(t, round_fn, True),
            lambda t: _Rounded.apply(t, round_fn, False))


PRECISIONS = {"fp32": None, "fp8": rounding(round_fp8)}


@contextlib.contextmanager
def products(allow_tf32: bool = False):
    """cuDNN's and cuBLAS's float32 products in TF32 (`allow_tf32`, the
    control of a float32 configuration) or in full float32 (the reference),
    the settings restored after."""
    flags = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = allow_tf32
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags


# -- noise schedule ---------------------------------------------------------------


def cosine_betas(n: int, max_beta: float = 0.999) -> np.ndarray:
    bar = lambda t: math.cos((t + 0.008) / 1.008 * math.pi / 2) ** 2
    return np.array([min(1 - bar((i + 1) / n) / bar(i / n), max_beta) for i in range(n)],
                    np.float64)


def linear_betas(n: int) -> np.ndarray:
    scale = 1000.0 / n
    return np.linspace(scale * 1e-6, scale * 1e-2, n, dtype=np.float64)


def sqrt_alpha_bar(schedule: str, n: int, device) -> torch.Tensor:
    """(n + 1,) float32: sqrt(alpha_bar_t) for t in [0, n], alpha_bar_0 = 1,
    computed in float64 and rounded once."""
    betas = {"cosine": cosine_betas, "linear": linear_betas}[schedule](n)
    acp = np.cumprod(1.0 - betas)
    return torch.as_tensor(np.sqrt(np.append(1.0, acp)).astype(np.float32), device=device)


def gamma_embedding(t, dim: int, max_period: float = 10000.0):
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    args = t.to(torch.float32)[:, None] * freqs[None]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
    return emb


# -- samplers -----------------------------------------------------------------------


def ddim_grid(T: int, steps: int) -> list:
    grid = np.round(np.linspace(T, 0, steps + 1)).astype(np.int32)
    return [(int(t), int(s)) for t, s in zip(grid[:-1], grid[1:])]


def ddim_jump(sab, x_t, x0, t: int, s: int):
    """x_s = a_s x0 + (sigma_s / sigma_t)(x_t - a_t x0), eta = 0."""
    sigma = lambda a: torch.sqrt(torch.clamp(1.0 - a * a, min=0.0))
    a_t, a_s = sab[t], sab[s]
    return a_s * x0 + sigma(a_s) / torch.clamp(sigma(a_t), min=1e-12) * (x_t - a_t * x0)


def sample(model, sab, pan, ms, prompt, x_T, method: str, steps: int,
           refresh_every: int = 2, cache_level: int = 1, extra=None):
    """The served image clamp(x_0 + ms, 0, 1) of a family's reference `model`
    under DDIM ("ddim") or block-cached DDIM ("ddim_cached": a full call
    every `refresh_every` steps, the shallow path on the cached trunk in
    between), x0 clipped to [-1, 1] at every step; `extra` goes to
    `model.encode`."""
    cond = model.encode(pan, ms, prompt, **(extra or {}))
    T = sab.shape[0] - 1
    b = x_T.shape[0]
    every = refresh_every if method == "ddim_cached" else 1
    x, deep = x_T, None
    for i, (t, s) in enumerate(ddim_grid(T, steps)):
        tt = torch.full((b,), t, dtype=torch.long, device=x.device)
        if i % every == 0:
            x0, deep = model.denoise(x, tt, cond, level=cache_level)
        else:
            x0, _ = model.denoise(x, tt, cond, deep, level=cache_level)
        x = ddim_jump(sab, x, torch.clamp(x0, -1.0, 1.0), t, s)
    return torch.clamp(x + ms, 0.0, 1.0)


# -- training -------------------------------------------------------------------------


def step_seeds(seed: int, step: int) -> tuple:
    """A step's seeds of its t/noise, dropout and guidance streams."""
    return tuple(int(s) for s in np.random.SeedSequence([seed, step]).generate_state(3, np.uint64))


def hf_linear(base_lr: float, warmup: int, total: int, step: int) -> float:
    warm = step / max(1.0, warmup)
    decay = (total - step) / max(1.0, total - warmup)
    return base_lr * min(max(min(warm, decay), 0.0), 1.0)


def train_steps(model, leaves: dict, batches: list, seed: int, train_cfg: dict, sab,
                loss_rows=None):
    """Runs len(batches) training steps of a family's reference `model`,
    whose parameters are `leaves` (name -> float32 leaf tensor requiring
    grad, in the layout `model` reads them in; updated in place), on
    batches [(Res, PAN, MS, prompt (B, 768), extra)], and returns
    {"losses": [float], "grads": [{name: norm of step k's gradient}],
    "params": {name: parameter after the last step, that layout}, "ema":
    {name: norm of the EMA after the last step}}. AdamW (decoupled decay,
    bias-corrected moments) at step k's lr hf_linear(k); no clipping; the
    EMA at train_cfg["ema_decay"] from the parameters, after each step, in
    float64. `extra` goes to `model.encode`.
    `loss_rows` (a fault for the harness's tests) takes the loss over the
    first that many rows of each batch."""
    dev = next(iter(leaves.values())).device
    b1, b2, eps = 0.9, 0.999, 1e-8
    lr0, wd = train_cfg["lr"], train_cfg["weight_decay"]
    m = {n: torch.zeros_like(p) for n, p in leaves.items()}
    v = {n: torch.zeros_like(p) for n, p in leaves.items()}
    ema = {n: p.detach().double() for n, p in leaves.items()}
    decay = train_cfg["ema_decay"]
    gen_tn, gen_drop = torch.Generator(device=dev), torch.Generator(device=dev)
    out = {"losses": [], "grads": []}
    for k, (res, pan, ms, prompt, extra) in enumerate(batches):
        s_tn, s_drop, _ = step_seeds(seed, k)
        gen_tn.manual_seed(s_tn)
        gen_drop.manual_seed(s_drop)
        T = sab.shape[0] - 1
        t = torch.randint(1, T + 1, (res.shape[0],), generator=gen_tn, device=dev)
        noise = torch.randn(res.shape, generator=gen_tn, device=dev)
        g = sab[t][:, None, None, None]
        x_t = g * res + torch.sqrt(1.0 - g ** 2) * noise
        cond = model.encode(pan, ms, prompt, rng=gen_drop, **extra)
        pred, _ = model.denoise(x_t, t, cond, rng=gen_drop)
        rows = res.shape[0] if loss_rows is None else loss_rows
        loss = torch.mean(torch.abs(res[:rows] - pred[:rows]))
        grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
        out["losses"].append(float(loss.detach()))
        lr = hf_linear(lr0, train_cfg["warmup_steps"], train_cfg["max_iter"], k)
        out["grads"].append({})
        with torch.no_grad():
            for (n, p), gr in zip(leaves.items(), grads):
                gr = torch.zeros_like(p) if gr is None else gr
                out["grads"][k][n] = float(torch.linalg.vector_norm(gr))
                p.mul_(1.0 - lr * wd)
                m[n].mul_(b1).add_(gr, alpha=1.0 - b1)
                v[n].mul_(b2).addcmul_(gr, gr, value=1.0 - b2)
                c1, c2 = 1.0 - b1 ** (k + 1), 1.0 - b2 ** (k + 1)
                denom = (v[n].sqrt() / math.sqrt(c2)).add_(eps)
                p.addcdiv_(m[n], denom, value=-lr / c1)
                ema[n].mul_(decay).add_(p.double(), alpha=1.0 - decay)
    out["ema"] = {n: float(torch.linalg.vector_norm(e)) for n, e in ema.items()}
    out["params"] = {n: p.detach() for n, p in leaves.items()}
    return out
