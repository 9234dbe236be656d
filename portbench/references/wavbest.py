"""The plain reference of the WavBEST family (TMDiff, IEEE TGRS 2024): its
parameters (`param_spec`, in the program's layout), the layout the reference
computes in, and its forward (`WavBEST`: the condition encoder and the
denoiser), written in plain PyTorch from the model's equations.

It imports torch and the shared reference (`portbench/reference.py`: the
operand precisions and the gamma embedding) only: nothing of the program
under test, of JAX or of the JAX package. Conv kernels come in the
program's layout (kd, kh, kw, Cin, Cout) and are computed as
(Cout, Cin, kd, kh, kw); Linear weights (out, in) in both. Activations are
(B, C, D, H, W), float32.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from portbench.reference import PRECISIONS, gamma_embedding

DROPOUT = 0.2


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


def to_program_layout(name: str, t):
    """The inverse of `to_reference_layout`, as a view."""
    return t.permute(2, 3, 4, 1, 0) if t.dim() == 5 else t


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
