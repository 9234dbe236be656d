"""The plain reference of the benchmarked model: WavBEST, its noise
schedule, the two DDIM samplers the serving presets use, and the training
step (x0 L1 loss, AdamW with the HF linear warm-up, no clipping), written in
plain PyTorch from the model's equations.

It imports torch and numpy only: nothing of the program under test, of JAX
or of the JAX package. It takes the weights as the harness made them
(a name -> tensor mapping in the program's layout: conv kernels
(kd, kh, kw, Cin, Cout), Linear weights (out, in)) and computes in float32
in (B, C, D, H, W) layout with cuDNN's or the CPU's plain convolutions, TF32
off (`products`). `precision` "fp8" rounds every operand of every conv and
Linear product, forward and backward, to float8 e4m3: the control of a
bfloat16 configuration; the control of a float32 one is the card's own
TF32 products (`products(allow_tf32=True)`).

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
import torch.nn.functional as F

DROPOUT = 0.2
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


# -- the model's parameters -----------------------------------------------------


def param_spec(channels, embed_dim: int = 128, inter_dim: int = 32) -> list:
    """[(name, shape, fan_in, bias base or None)] of every WavBEST parameter,
    in the program's layout. A weight has a fan-in; a bias has its base
    value (1 for the Linear that computes a modulated conv's style, 0
    elsewhere)."""
    c0, c1, c2, c3 = channels
    e = embed_dim
    spec = []

    def lin(name, cin, cout, base=0.0):
        spec.append((f"{name}.weight", (cout, cin), cin, None))
        spec.append((f"{name}.bias", (cout,), None, base))

    def conv(name, cin, cout, k=3, bias=True):
        spec.append((f"{name}.weight", (k, k, k, cin, cout), k ** 3 * cin, None))
        if bias:
            spec.append((f"{name}.bias", (cout,), None, 0.0))

    def resblock(name, cin, f, temb=True):
        conv(f"{name}.conv20", cin, f)
        conv(f"{name}.conv21", f, f, bias=False)
        lin(f"{name}.dense2.dense", e, f, 1.0)
        if temb:
            lin(f"{name}.dense1.dense", e, cin)
        if cin != f:
            conv(f"{name}.res_conv", cin, f, 1)

    def head(name, f):
        conv(f"{name}.conv20", 1, f, 1)
        conv(f"{name}.conv21", f, f, bias=False)
        lin(f"{name}.dense2.dense", e, f, 1.0)

    def down(name, cin, f, temb=True):
        resblock(f"{name}.conv20", cin, f, temb)
        conv(f"{name}.down.Conv_0", f, f)
        conv(f"{name}.down.Conv_2", f, f, 1)
        conv(f"{name}.down.Conv_1", f, f, bias=False)
        lin(f"{name}.down.dense1.dense", e, f, 1.0)
        if temb:
            lin(f"{name}.down.Dense_0", e, f)

    def up(name, cin, f, skip):
        resblock(f"{name}.conv20", cin, f)
        conv(f"{name}.up1.Conv_0", f, f)
        conv(f"{name}.up1.Conv_2", f, f, 1)
        spec.append((f"{name}.up1.convH_0.0.weight", (3, 3, 3, skip, 3 * f), 27 * skip, None))
        spec.append((f"{name}.up1.convH_0.0.bias", (3 * f,), None, 0.0))
        conv(f"{name}.up1.Conv_1", f, f, bias=False)
        lin(f"{name}.up1.dense1.dense", e, f, 1.0)
        lin(f"{name}.up1.Dense_0", e, f)

    lin("embed2.0", 768, 4 * e)
    lin("embed2.2", 4 * e, 4 * e)
    lin("embed2.4", 4 * e, e)
    lin("embed.0", inter_dim, e)
    lin("embed.2", e, e)
    head("conv1", c0)
    head("conv2", c0)
    down("down1_1", c0, c1, False)
    down("down2_1", c1, c2, False)
    down("down3_1", c2, c3, False)
    down("down1", c0, c1)
    down("down2", c1, c2)
    down("down3", c2, c3)
    resblock("middle1", c3, c3)
    up("up1", 3 * c3, c2, c3)
    up("up2", 3 * c2, c1, c2)
    up("up3", 3 * c1, c0, c1)
    for i in range(4):
        resblock(f"final.conv2{i}", 3 * c0 if i == 0 else c0, c0)
    conv("final.conv24", c0, 1, 1, bias=False)
    lin("final.dense2.dense", e, c0, 1.0)
    return spec


def to_reference_layout(name: str, t):
    """A conv kernel (kd, kh, kw, Cin, Cout) as (Cout, Cin, kd, kh, kw);
    anything else as it is."""
    return t.permute(4, 3, 0, 1, 2).contiguous() if t.dim() == 5 else t


# -- the model --------------------------------------------------------------------


class WavBEST:
    """WavBEST's forward on `params` (name -> tensor, reference layout),
    float32, activations (B, C, D, H, W). `counter`, when given, is called
    as counter(kind, x, weight) for every conv ("conv3" for a SAME 3x3x3
    conv, "conv1" for a 1x1x1 one) and Linear ("linear")."""

    def __init__(self, params: dict, inter_dim: int = 32, precision: str = "fp32",
                 counter=None):
        self.p = params
        self.inter_dim = inter_dim
        same = lambda t: t
        self.q, self.qg = PRECISIONS[precision] or (same, same)
        self.counter = counter

    # operations
    def lin(self, x, name):
        w, b = self.p[name + ".weight"], self.p[name + ".bias"]
        if self.counter:
            self.counter("linear", x, w)
        return self.qg(F.linear(self.q(x), self.q(w), b))

    def conv(self, x, name, style=None, bias=True, weight=None, bias_t=None):
        w = self.p[name + ".weight"] if weight is None else weight
        b = (self.p[name + ".bias"] if bias else None) if bias_t is None else bias_t
        if style is not None:
            x = x * style[:, :, None, None, None]
        if self.counter:
            self.counter("conv3" if w.shape[-1] == 3 else "conv1", x, w, style is not None,
                         b is not None)
        return self.qg(F.conv3d(self.q(x), self.q(w), b, padding=w.shape[-1] // 2))

    @staticmethod
    def dropout(x, rng):
        """The program's dropout: the mask drawn at x's (B, D, H, W, C) shape."""
        if rng is None:
            return x
        b, c, d, h, w = x.shape
        keep = torch.rand((b, d, h, w, c), generator=rng, device=x.device) >= DROPOUT
        keep_prob = torch.tensor(1.0 - DROPOUT, dtype=x.dtype).item()
        return torch.where(keep.permute(0, 4, 1, 2, 3), x / keep_prob, 0.0)

    @staticmethod
    def dwt(x):
        a, b = x[..., 0::2, 0::2], x[..., 0::2, 1::2]
        c, d = x[..., 1::2, 0::2], x[..., 1::2, 1::2]
        return ((a + b + c + d) * 0.5, (a - b + c - d) * 0.5, (a + b - c - d) * 0.5,
                (a - b - c + d) * 0.5)

    @staticmethod
    def idwt(ll, lh, hl, hh):
        out = ll.new_empty(*ll.shape[:-2], 2 * ll.shape[-2], 2 * ll.shape[-1])
        out[..., 0::2, 0::2] = (ll + lh + hl + hh) * 0.5
        out[..., 0::2, 1::2] = (ll - lh + hl - hh) * 0.5
        out[..., 1::2, 0::2] = (ll + lh - hl - hh) * 0.5
        out[..., 1::2, 1::2] = (ll - lh - hl + hh) * 0.5
        return out

    @staticmethod
    def bcast(v):
        return v[:, :, None, None, None]

    # blocks
    def resblock(self, name, x, temb, zemb, rng):
        parts = x if isinstance(x, tuple) else (x,)
        hs = list(parts)
        if temb is not None and name + ".dense1.dense.weight" in self.p:
            d = self.bcast(self.lin(temb, name + ".dense1.dense"))
            off = 0
            for i, p in enumerate(parts):
                hs[i] = p + d[:, off:off + p.shape[1]]
                off += p.shape[1]
        hs = [self.dropout(F.silu(p), rng) for p in hs]
        h = self.conv(torch.cat(hs, 1), name + ".conv20")
        h = self.conv(self.dropout(F.silu(h), rng), name + ".conv21",
                      style=self.lin(zemb, name + ".dense2.dense"), bias=False)
        xin = torch.cat(parts, 1)
        if name + ".res_conv.weight" in self.p:
            xin = self.conv(xin, name + ".res_conv")
        return h + xin

    def head(self, name, x, zemb):
        h = F.silu(self.conv(x, name + ".conv20"))
        return self.conv(h, name + ".conv21", style=self.lin(zemb, name + ".dense2.dense"),
                         bias=False)

    def wavelet_down(self, name, x, temb, zemb, rng):
        h = self.conv(F.silu(x), name + ".Conv_0")
        x = self.conv(x, name + ".Conv_2")
        ll, lh, hl, hh = self.dwt(h)
        h = ll * 0.5
        x = self.dwt(x)[0] * 0.5
        if temb is not None:
            h = h + self.bcast(self.lin(temb, name + ".Dense_0"))
        h = self.conv(self.dropout(F.silu(h), rng), name + ".Conv_1",
                      style=self.lin(zemb, name + ".dense1.dense"), bias=False)
        return x + h, (lh, hl, hh)

    def wavelet_up(self, name, x, temb, zemb, skip, rng):
        h = self.conv(F.silu(x), name + ".Conv_0")
        x = self.conv(x, name + ".Conv_2")
        w, b = self.p[name + ".convH_0.0.weight"], self.p[name + ".convH_0.0.bias"]
        f = w.shape[0] // 3
        lh, hl, hh = (self.conv(s * 0.5, None, weight=w[g * f:(g + 1) * f],
                                bias_t=b[g * f:(g + 1) * f]) * 2.0
                      for g, s in enumerate(skip))
        h = self.idwt(2.0 * h, lh, hl, hh)
        x = self.idwt(2.0 * x, lh, hl, hh)
        h = h + self.bcast(self.lin(temb, name + ".Dense_0"))
        h = self.conv(self.dropout(F.silu(h), rng), name + ".Conv_1",
                      style=self.lin(zemb, name + ".dense1.dense"), bias=False)
        return x + h

    def down(self, name, x, temb, zemb, rng):
        return self.wavelet_down(name + ".down", self.resblock(name + ".conv20", x, temb, zemb,
                                                               rng), temb, zemb, rng)

    def up(self, name, x, temb, zemb, skip, rng):
        return self.wavelet_up(name + ".up1", self.resblock(name + ".conv20", x, temb, zemb, rng),
                               temb, zemb, skip, rng)

    # the model
    def prompt_embed(self, prompt):
        h = F.silu(self.lin(prompt, "embed2.0"))
        h = F.silu(self.lin(h, "embed2.2"))
        return F.silu(self.lin(h, "embed2.4"))

    def time_embed(self, t):
        h = F.silu(self.lin(gamma_embedding(t.reshape(-1), self.inter_dim), "embed.0"))
        return F.silu(self.lin(h, "embed.2"))

    def encode(self, pan, ms, prompt, rng=None):
        """pan (B, 1, H, W), ms (B, bands, H, W), prompt (B, 768)."""
        zemb = self.prompt_embed(prompt)
        c_h0 = self.head("conv1", (pan - ms)[:, None], zemb)
        c_h1, c_s1 = self.down("down1_1", c_h0, None, zemb, rng)
        c_h2, c_s2 = self.down("down2_1", c_h1, None, zemb, rng)
        c_h3, c_s3 = self.down("down3_1", c_h2, None, zemb, rng)
        return {"zemb": zemb, "feats": (c_h0, c_h1, c_h2, c_h3), "skips": (c_s1, c_s2, c_s3)}

    def denoise(self, x_t, t, cond, deep=None, level: int = 1, rng=None):
        """(x0 prediction (B, bands, H, W), deep-trunk features at `level`);
        with `deep` the cached trunk stands for the blocks it replaces."""
        zemb = cond["zemb"]
        c_h0, c_h1, c_h2, c_h3 = cond["feats"]
        c_s1, c_s2, c_s3 = cond["skips"]
        temb = self.time_embed(t)
        x_h0 = self.head("conv2", x_t[:, None], zemb)
        x_h1, _ = self.down("down1", x_h0, temb, zemb, rng)
        deep_out = None
        if deep is not None and level == 3:
            h = deep
        else:
            x_h2, _ = self.down("down2", x_h1, temb, zemb, rng)
            if deep is not None and level == 2:
                h = deep
            else:
                if deep is None:
                    x_h3, _ = self.down("down3", x_h2, temb, zemb, rng)
                    h = self.resblock("middle1", x_h3, temb, zemb, rng)
                else:
                    x_h3, h = deep
                if level == 1:
                    deep_out = (x_h3, h)
                h = self.up("up1", (h, c_h3, x_h3), temb, zemb, c_s3, rng)
            if level == 2:
                deep_out = h
            h = self.up("up2", (h, c_h2, x_h2), temb, zemb, c_s2, rng)
        if level == 3:
            deep_out = h
        h = self.up("up3", (h, c_h1, x_h1), temb, zemb, c_s1, rng)
        h = (h, c_h0, x_h0)
        for i in range(4):
            h = self.resblock(f"final.conv2{i}", h, temb, zemb, rng)
        out = self.conv(F.silu(h), "final.conv24", style=self.lin(zemb, "final.dense2.dense"),
                        bias=False)
        return out[:, 0], deep_out


# -- samplers -----------------------------------------------------------------------


def ddim_grid(T: int, steps: int) -> list:
    grid = np.round(np.linspace(T, 0, steps + 1)).astype(np.int32)
    return [(int(t), int(s)) for t, s in zip(grid[:-1], grid[1:])]


def ddim_jump(sab, x_t, x0, t: int, s: int):
    """x_s = a_s x0 + (sigma_s / sigma_t)(x_t - a_t x0), eta = 0."""
    sigma = lambda a: torch.sqrt(torch.clamp(1.0 - a * a, min=0.0))
    a_t, a_s = sab[t], sab[s]
    return a_s * x0 + sigma(a_s) / torch.clamp(sigma(a_t), min=1e-12) * (x_t - a_t * x0)


def sample(model: WavBEST, sab, pan, ms, prompt, x_T, method: str, steps: int,
           refresh_every: int = 2, cache_level: int = 1):
    """The served image clamp(x_0 + ms, 0, 1) of DDIM ("ddim") or of
    block-cached DDIM ("ddim_cached": a full call every `refresh_every`
    steps, the shallow path on the cached trunk in between), x0 clipped to
    [-1, 1] at every step."""
    cond = model.encode(pan, ms, prompt)
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


def train_steps(params: dict, batches: list, seed: int, train_cfg: dict, sab,
                inter_dim: int = 32, loss_rows=None):
    """Runs len(batches) training steps from `params` (name -> float32
    tensor, the program's layout) on batches [(Res, PAN, MS, prompt (B, 768))]
    and returns {"losses": [float], "grads": [{name: norm of step k's
    gradient}], "params": {name: parameter after the last step, the
    program's layout}, "ema": {name: norm of the EMA after the last step}}.
    AdamW (decoupled decay, bias-corrected moments) at step k's lr
    hf_linear(k); no clipping; the EMA at train_cfg["ema_decay"] from the
    parameters, after each step, in float64.
    `loss_rows` (a fault for the harness's tests) takes the loss over the
    first that many rows of each batch."""
    dev = next(iter(params.values())).device
    leaves = {n: to_reference_layout(n, t).detach().clone().requires_grad_(True)
              for n, t in params.items()}
    model = WavBEST(leaves, inter_dim)
    b1, b2, eps = 0.9, 0.999, 1e-8
    lr0, wd = train_cfg["lr"], train_cfg["weight_decay"]
    m = {n: torch.zeros_like(p) for n, p in leaves.items()}
    v = {n: torch.zeros_like(p) for n, p in leaves.items()}
    ema = {n: p.detach().double() for n, p in leaves.items()}
    decay = train_cfg["ema_decay"]
    gen_tn, gen_drop = torch.Generator(device=dev), torch.Generator(device=dev)
    out = {"losses": [], "grads": []}
    for k, (res, pan, ms, prompt) in enumerate(batches):
        s_tn, s_drop, _ = step_seeds(seed, k)
        gen_tn.manual_seed(s_tn)
        gen_drop.manual_seed(s_drop)
        T = sab.shape[0] - 1
        t = torch.randint(1, T + 1, (res.shape[0],), generator=gen_tn, device=dev)
        noise = torch.randn(res.shape, generator=gen_tn, device=dev)
        g = sab[t][:, None, None, None]
        x_t = g * res + torch.sqrt(1.0 - g ** 2) * noise
        cond = model.encode(pan, ms, prompt, rng=gen_drop)
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
    out["params"] = {n: (p.detach().permute(2, 3, 4, 1, 0) if p.dim() == 5 else p.detach())
                     for n, p in leaves.items()}
    return out
