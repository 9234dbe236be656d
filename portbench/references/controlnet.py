"""The plain reference of the ControlNet family: the UniControl ControlNet
(Zhang et al., arXiv:2302.05543; Qin et al., arXiv:2305.11147) over TMDiff's
legacy UNet, as codgodtao/TMDiff's `utils/cldm_unicontrol.py` wires it: its
parameters (`param_spec`, in the program's layout), the layout the reference
computes in, and its forward (`ControlledLegacyUNet`: `encode`, the
condition, and `denoise`), written in plain PyTorch from the model's
equations.

It imports torch, numpy and the shared reference (`portbench/reference.py`:
the gamma embedding; the operand precisions come with WavBEST's blocks)
only: nothing of the program under test, of JAX or of the JAX package. The legacy UNet's ResBlocks, heads and embedding MLPs
are WavBEST's blocks, so it takes them from `portbench/references/
wavbest.py`, whose file it executes as it is (`_wavbest`). Conv kernels come
in the program's layout (kd, kh, kw, Cin, Cout) and are computed as (Cout,
Cin, kd, kh, kw), a transposed conv's as (Cin, Cout, kd, kh, kw); the hint
stems' stacked kernels (tasks, 1, 3, 3, Cin, Cout) as (tasks, Cout, Cin, 1,
3, 3); Linear weights (out, in) in both. Activations are (B, C, D, H, W),
float32.

Every conv and Linear product goes through the precision's rounding, the
strided, transposed, hint and zero convs included. `counter`, when given,
is called as counter(kind, x, weight) for every conv and Linear: "conv3"
for a SAME 3x3x3 conv and "conv1" for a 1x1x1 one (WavBEST's), "strided",
"transposed" and "hint" for the library convs, "zero" for a zero conv and
"linear"; the hint stems are called once per task present, on its rows.

Departures from `cldm_unicontrol.py`, each exact or the harness's choice:

* the denoiser is TMDiff's legacy UNet (stride-(1, 2, 2) convs down,
  transposed convs up, cropped to the skip), not Stable Diffusion's UNet,
  and its condition is `pan - ms`, as TMDiff adapts the ControlNet;
* the hint encoder reads only the hint and the task embedding, so `encode`
  runs it once per image and `denoise` adds its output at every step: the
  same numbers as running it at every step;
* a batch mixes tasks: each row's stems are its own task's experts, and the
  hypernetwork and the zero convs' styles take each row's task embedding
  (the reference code takes one task a batch); the rows are routed by their
  ids on the host, so the reference runs on the meta device too;
* the task features, the CLIP text embeddings of the task prompts in the
  reference code, are a weight of the model here (`task_features`), drawn
  from the seed with the other weights;
* the zero convs are drawn like any 1x1x1 conv, not zero: at zero the
  control branch would add nothing, and no check could see it;
* the block-cached sampler has no deep trunk to reuse here: `denoise`
  refuses `deep`.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference import gamma_embedding

TASKS = 13  # the UniControl tasks (`cldm_unicontrol.py:146-150`)
STEM = ((None, 16), (16, 16), (16, 32))  # each task's expert, hint channels first
TRUNK = ((32, 32), (32, 96), (96, 96), (96, 256))  # shared by every task
STRIDED = dict(stride=(1, 2, 2), padding=(1, 0, 0))
TRANSPOSED = dict(stride=(1, 2, 2), padding=(1, 0, 0), output_padding=(0, 1, 1))


def _wavbest() -> dict:
    """The names of `portbench/references/wavbest.py`, its file executed as
    it is, beside this one."""
    path = __file__[:-len("controlnet.py")] + "wavbest.py"
    names = {"__name__": "portbench_reference_wavbest_blocks", "__file__": path}
    with open(path) as f:
        exec(compile(f.read(), path, "exec"), names)
    return names


WavBEST = _wavbest()["WavBEST"]


# -- the model's parameters -----------------------------------------------------


def param_spec(channels, embed_dim: int = 128, inter_dim: int = 32, hint_channels: int = 3,
               tasks: int = TASKS) -> list:
    """[(name, shape, fan_in, bias base or None)] of every parameter of the
    controlled legacy UNet and of its task-feature table, in the program's
    layout. A weight has a fan-in; a bias has its base value (1 for the
    Linear that computes a modulated conv's style, 0 elsewhere, the zero
    convs' styles included). The task table has fan-in 1: unit-variance
    rows, as the sensor prompts have."""
    c0, c1, c2, c3 = channels
    e = embed_dim
    spec = []

    def lin(name, cin, cout, base=0.0):
        spec.append((f"{name}.weight", (cout, cin), cin, None))
        spec.append((f"{name}.bias", (cout,), None, base))

    def conv(name, cin, cout, k=(3, 3, 3), bias=True):
        spec.append((f"{name}.weight", (*k, cin, cout), int(np.prod(k)) * cin, None))
        if bias:
            spec.append((f"{name}.bias", (cout,), None, 0.0))

    def resblock(name, cin, f):
        conv(f"{name}.conv20", cin, f)
        conv(f"{name}.conv21", f, f, bias=False)
        lin(f"{name}.dense2.dense", e, f, 1.0)
        lin(f"{name}.dense1.dense", e, cin)
        if cin != f:
            conv(f"{name}.res_conv", cin, f, (1, 1, 1))

    def head(name, f):
        conv(f"{name}.conv20", 1, f, (1, 1, 1))
        conv(f"{name}.conv21", f, f, bias=False)
        lin(f"{name}.dense2.dense", e, f, 1.0)

    def down(name, cin, f):  # a ResBlock, then the strided conv
        resblock(f"{name}.conv20", cin, f)
        conv(f"{name}.down", f, f)

    def up(name, cin, f):  # a ResBlock on [x, skip, cond], then the transposed conv
        resblock(f"{name}.conv20", cin, f)
        conv(f"{name}.up1", f, f)

    def mlps(prefix):
        lin(f"{prefix}embed2.0", 768, 4 * e)
        lin(f"{prefix}embed2.2", 4 * e, 4 * e)
        lin(f"{prefix}embed2.4", 4 * e, e)
        lin(f"{prefix}embed.0", inter_dim, e)
        lin(f"{prefix}embed.2", e, e)

    def encoder(prefix):  # the x encoder and the middle
        head(f"{prefix}conv2", c0)
        down(f"{prefix}down1", c0, c1)
        down(f"{prefix}down2", c1, c2)
        down(f"{prefix}down3", c2, c3)
        resblock(f"{prefix}middle1", c3, c3)

    def zero(name, cin, cout):  # a zero conv and its task style
        conv(name, cin, cout, (1, 1, 1))
        lin(f"{name}.style", 4 * c0, cin)

    # the base model (LegacyUNet)
    mlps("")
    head("conv1", c0)
    down("down1_1", c0, c1)
    down("down2_1", c1, c2)
    down("down3_1", c2, c3)
    encoder("")
    up("up1", 3 * c3, c2)
    up("up2", 3 * c2, c1)
    up("up3", 3 * c1, c0)
    resblock("final.conv20", 3 * c0, c0)
    resblock("final.conv21", c0, c0)
    lin("out_proj", c0, 1)
    # the task hypernetwork and the control branch
    lin("task_hypernet.fc1", 768, 4 * c0)
    lin("task_hypernet.fc2", 4 * c0, 4 * c0)
    mlps("control.")
    for i, (cin, cout) in enumerate(STEM):
        cin = cin or hint_channels
        spec.append((f"control.hint.stem{i}_kernel", (tasks, 1, 3, 3, cin, cout), 9 * cin,
                     None))
        spec.append((f"control.hint.stem{i}_bias", (tasks, cout), None, 0.0))
    zero("control.hint.zeroconv0", 32, 32)
    for i, (cin, cout) in enumerate(TRUNK):
        conv(f"control.hint.share{i}", cin, cout, (1, 3, 3))
    zero("control.hint.zeroconv1", 256, c0)
    encoder("control.")
    for i, f in enumerate((c0, c1, c2, c3, c3)):
        zero(f"control.zero{i}", f, f)
    spec.append(("task_features", (tasks, 768), 1, None))
    return spec


def to_reference_layout(name: str, t):
    """A conv kernel (kd, kh, kw, Cin, Cout) as (Cout, Cin, kd, kh, kw), a
    transposed one (`up1`) as (Cin, Cout, kd, kh, kw), the stacked stems
    (tasks, 1, 3, 3, Cin, Cout) as (tasks, Cout, Cin, 1, 3, 3); anything
    else as it is."""
    if t.dim() == 6:
        return t.permute(0, 5, 4, 1, 2, 3).contiguous()
    if t.dim() == 5:
        order = (3, 4, 0, 1, 2) if name.endswith(".up1.weight") else (4, 3, 0, 1, 2)
        return t.permute(*order).contiguous()
    return t


# -- the model --------------------------------------------------------------------


class ControlledLegacyUNet(WavBEST):
    """The controlled legacy UNet's forward on `params` (name -> tensor,
    reference layout), float32, activations (B, C, D, H, W). WavBEST's
    blocks (`resblock`, `head`, `lin`, `conv`, the prompt and time MLPs)
    serve the legacy UNet unchanged; `precision` and `counter` as there
    (module doc). `control_scales` weigh the five residuals (middle last);
    `only_mid_control` keeps the middle's alone."""

    def __init__(self, params: dict, inter_dim: int = 32, precision: str = "fp32",
                 counter=None, control_scales=(1.0,) * 5, only_mid_control: bool = False):
        super().__init__(params, inter_dim, precision, counter)
        self.scales = tuple(control_scales)
        self.only_mid = only_mid_control

    # operations
    def library(self, x, name, kind, transposed=False, weight=None, bias=None, **geometry):
        """A conv through the precision's rounding, counted as `kind`."""
        w = self.p[name + ".weight"] if weight is None else weight
        b = self.p[name + ".bias"] if bias is None else bias
        if self.counter:
            self.counter(kind, x, w)
        conv = F.conv_transpose3d if transposed else F.conv3d
        return self.qg(conv(self.q(x), self.q(w), b, **geometry))

    def zero_conv(self, x, name, task_emb):
        """conv(x · s) + b, s = the Linear `name.style` of the task
        embedding (one row per batch row)."""
        style = self.lin(task_emb, name + ".style")
        return self.library(x * self.bcast(style), name, "zero")

    def mlp(self, prefix, x, first, second):
        """SiLU after each Linear: the time MLP (first, second = "embed.0",
        "embed.2") and the hypernetwork's (`task_hypernet.fc1`, `.fc2`)."""
        h = F.silu(self.lin(x, prefix + first))
        return F.silu(self.lin(h, prefix + second))

    def prompt_mlp(self, prefix, prompt):
        h = F.silu(self.lin(prompt, prefix + "embed2.0"))
        h = F.silu(self.lin(h, prefix + "embed2.2"))
        return F.silu(self.lin(h, prefix + "embed2.4"))

    # blocks
    def strided(self, name, x, temb, zemb, rng):
        h = F.silu(self.resblock(name + ".conv20", x, temb, zemb, rng))
        return self.library(h, name + ".down", "strided", **STRIDED)

    def transposed(self, name, parts, temb, zemb, rng, like):
        h = F.silu(self.resblock(name + ".conv20", parts, temb, zemb, rng))
        h = self.library(h, name + ".up1", "transposed", transposed=True, **TRANSPOSED)
        return h[..., :like.shape[-2], :like.shape[-1]]  # the skip's grid

    def encoder(self, prefix, x, temb, zemb, rng, hint_feat=None):
        """(taps at the four scales, the middle's output) of the x encoder
        under `prefix`; the hint encoder's output added to the head's."""
        h0 = self.head(prefix + "conv2", x, zemb)
        if hint_feat is not None:
            h0 = h0 + hint_feat
        h1 = self.strided(prefix + "down1", h0, temb, zemb, rng)
        h2 = self.strided(prefix + "down2", h1, temb, zemb, rng)
        h3 = self.strided(prefix + "down3", h2, temb, zemb, rng)
        return [h0, h1, h2, h3], self.resblock(prefix + "middle1", h3, temb, zemb, rng)

    def hint_encoder(self, hint, ids, task_emb):
        """(B, C0, 1, H, W): each row through its task's stems (the rows of
        one task together), a zero conv, the shared trunk, a zero conv.
        `hint` (B, hint channels, 1, H, W); `ids` the rows' task ids on the
        host."""
        rows = [hint[i:i + 1] for i in range(hint.shape[0])]
        for task in sorted(set(ids)):
            mine = [i for i, t in enumerate(ids) if t == task]
            h = torch.cat([rows[i] for i in mine])
            for li in range(len(STEM)):
                w = self.p[f"control.hint.stem{li}_kernel"][task]
                b = self.p[f"control.hint.stem{li}_bias"][task]
                h = F.silu(self.library(h, None, "hint", weight=w, bias=b, padding=(0, 1, 1)))
            for k, i in enumerate(mine):
                rows[i] = h[k:k + 1]
        h = self.zero_conv(torch.cat(rows), "control.hint.zeroconv0", task_emb)
        for li in range(len(TRUNK)):
            h = F.silu(self.library(h, f"control.hint.share{li}", "hint", padding=(0, 1, 1)))
        return self.zero_conv(h, "control.hint.zeroconv1", task_emb)

    # the model
    def encode(self, pan, ms, prompt, rng=None, hint=None, task=None):
        """pan (B, 1, H, W), ms (B, bands, H, W), prompt (B, 768); hint (B,
        H, W, hint channels) and task (B,) ids as numpy arrays, the rows as
        the harness stacks them (or None, the plain legacy UNet). What no
        step changes: the condition, the prompt's MLPs, and with a hint the
        task embedding and the hint encoder's output."""
        cond = {"cond": (pan - ms)[:, None], "zemb": self.prompt_mlp("", prompt)}
        if hint is None:
            return cond
        ids = [int(i) for i in np.asarray(task).reshape(-1)]
        table = self.p["task_features"]
        feats = torch.stack([table[i] for i in ids])
        task_emb = self.mlp("task_hypernet.", feats, "fc1", "fc2")
        hint = torch.as_tensor(np.ascontiguousarray(hint), dtype=torch.float32,
                               device=pan.device)
        cond.update(task_emb=task_emb, control_zemb=self.prompt_mlp("control.", prompt),
                    hint_feat=self.hint_encoder(hint.permute(0, 3, 1, 2)[:, :, None], ids,
                                                task_emb))
        return cond

    def denoise(self, x_t, t, cond, deep=None, level: int = 1, rng=None):
        """(x0 prediction (B, bands, H, W), None): the base's encoders and
        middle, the control residuals where `cond` holds a hint, the
        decoder. There is no deep trunk to reuse."""
        if deep is not None:
            raise ValueError("the controlled legacy UNet has no deep-trunk cache")
        zemb = cond["zemb"]
        gemb = gamma_embedding(t.reshape(-1), self.inter_dim)
        temb = self.mlp("", gemb, "embed.0", "embed.2")
        c0 = self.head("conv1", cond["cond"], zemb)
        c1 = self.strided("down1_1", c0, temb, zemb, rng)
        c2 = self.strided("down2_1", c1, temb, zemb, rng)
        c3 = self.strided("down3_1", c2, temb, zemb, rng)
        x = x_t[:, None]
        taps, h = self.encoder("", x, temb, zemb, rng)
        if "hint_feat" in cond:
            ctemb = self.mlp("control.", gemb, "embed.0", "embed.2")
            ctaps, cmid = self.encoder("control.", x, ctemb, cond["control_zemb"], rng,
                                       cond["hint_feat"])
            res = [self.zero_conv(v, f"control.zero{i}", cond["task_emb"])
                   for i, v in enumerate(ctaps + [cmid])]
            h = h + self.scales[4] * res[4]
            if not self.only_mid:
                taps = [v + s * r for v, s, r in zip(taps, self.scales, res)]
        x0, x1, x2, x3 = taps
        h = self.transposed("up1", (h, c3, x3), temb, zemb, rng, c2)
        h = self.transposed("up2", (h, c2, x2), temb, zemb, rng, c1)
        h = self.transposed("up3", (h, c1, x1), temb, zemb, rng, x)
        h = self.resblock("final.conv20", (h, c0, x0), temb, zemb, rng)
        h = self.resblock("final.conv21", F.silu(h), temb, zemb, rng)
        return self.lin(h.movedim(1, -1), "out_proj")[..., 0], None

