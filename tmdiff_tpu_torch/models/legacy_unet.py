"""LegacyUNet: the pre-wavelet WavBEST ablation assembled end to end (port of
tmdiff_tpu/models/legacy_unet.py). Same dual-encoder wiring and conditioning
as WavBEST, with strided-conv downsampling and transposed-conv upsampling
(models/legacy_blocks.py) instead of the DWT / IDWT.

The legacy blocks' spatial math (VALID stride-2 down: H -> (H - 1) // 2; the
transposed conv up: h -> 2 h + 2, cropped to the skip's grid) needs H and W
at least 16 and divisible by 8 (256 maps to 127, 63, 31 and back).

`prompt_embed`, `time_embeds`, `encode`, `middle` and `decode` are the
forward's pieces, shared with models/controlnet.py::ControlledLegacyUNet as
in the JAX package, so the plain and the controlled model run one wiring on
identically named modules. Inputs as WavBEST's: x_t (B, bands, H, W), t
(B,), pan (B, 1, H, W) (or a tensor that broadcasts against ms), ms (B,
bands, H, W), a prompt embedding (768,) or (B, 768). With train=True dropout
draws from `rng`, a torch.Generator on the model's device.

The facade's contract is WavBEST's: `encode_condition(pan, ms, prompt_emb)`
holds what no diffusion step changes (the condition `pan - ms` and the
embedded prompt), `denoise(x_t, t, cache)` the rest, and `forward` is the
two together. Unlike WavBEST's, the legacy condition encoder reads the time
embedding, so it runs in `denoise`, at every step. There is no deep-trunk
split (`denoise_deep` / `denoise_reuse`), so the block-cached sampler
refuses these models (`REFUSED_SAMPLERS`, read by pipeline.py), and they
run on one process: `use_mesh` takes None only.

`dtype` (float32, or bfloat16 as the JAX package's `LegacyUNet(dtype=...)`)
is the type the blocks compute in; parameters stay float32. The time
embedding, the prompt, the condition `pan - ms` and x_t are cast to it on
the way in, and the output is float32 in either type.
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from tmdiff_tpu_torch.models.blocks import (AdaptionHead, ResBlockModulate, dropout_rng,
                                            linear, swish)
from tmdiff_tpu_torch.models.legacy_blocks import (
    LegacyFinalBlock,
    StridedDownStage,
    TransposedUpStage,
)
from tmdiff_tpu_torch.models.wavbest import PromptMLP, TimeMLP
from tmdiff_tpu_torch.ops.embedding import gamma_embedding
from tmdiff_tpu_torch.utils.device import resolve_device


def prompt_embed(mod, prompt_emb, batch: int):
    """(the prompt embedding (batch, 768), zemb): a (768,) prompt expanded
    over the batch, and `mod`'s prompt MLP of it."""
    if prompt_emb.dim() == 1:
        prompt_emb = prompt_emb.expand(batch, prompt_emb.shape[0])
    return prompt_emb, swish(mod.embed2(prompt_emb.to(mod.dtype)))


def time_embeds(mod, t):
    """(gemb, temb): the gamma time embedding and `mod`'s time MLP of it."""
    gemb = gamma_embedding(t.reshape(-1), mod.inter_dim).to(mod.dtype)
    return gemb, swish(mod.embed(gemb))


def encode(mod, cond, xt, temb, zemb, rng=None):
    """Dual encoder: (cond taps), (x taps) at scales c0..c3."""
    c_h0 = mod.conv1(cond, zemb)
    c_h1 = mod.down1_1(c_h0, temb, zemb, rng)
    c_h2 = mod.down2_1(c_h1, temb, zemb, rng)
    c_h3 = mod.down3_1(c_h2, temb, zemb, rng)
    x_h0 = mod.conv2(xt, zemb)
    x_h1 = mod.down1(x_h0, temb, zemb, rng)
    x_h2 = mod.down2(x_h1, temb, zemb, rng)
    x_h3 = mod.down3(x_h2, temb, zemb, rng)
    return (c_h0, c_h1, c_h2, c_h3), (x_h0, x_h1, x_h2, x_h3)


def middle(mod, x_h3, temb, zemb, rng=None):
    return mod.middle1(x_h3, temb, zemb, rng)


def crop_to(h, ref):
    """The legacy size math (down: H -> (H - 1) // 2, up: h -> 2 h + 2)
    overshoots by 1-2 pixels a stage: crop to the skip's grid."""
    return h[:, :, :ref.shape[2], :ref.shape[3], :]


def decode(mod, h, c_taps, x_taps, xt, temb, zemb, rng=None):
    """The decoder from the middle's output: (B, bands, H, W) float32."""
    c_h0, c_h1, c_h2, c_h3 = c_taps
    x_h0, x_h1, x_h2, x_h3 = x_taps
    h = crop_to(mod.up1(h, temb, zemb, c_h3, x_h3, rng), c_h2)
    h = crop_to(mod.up2(h, temb, zemb, c_h2, x_h2, rng), c_h1)
    h = crop_to(mod.up3(h, temb, zemb, c_h1, x_h1, rng), xt)
    h = mod.final((h, c_h0, x_h0), temb, zemb, rng)
    return mod.out_proj(h)[..., 0].to(torch.float32)


class LegacyUNet(nn.Module):
    """The legacy denoiser. Parameters are drawn from `seed` on the CPU and
    moved to `device`: CUDA unless the caller passes another; with no
    device given and no GPU, construction raises. `dtype`: float32 or
    bfloat16 (module doc)."""

    # the samplers of pipeline.py this model cannot run, with the reason
    REFUSED_SAMPLERS = {"ddim_cached": "it has no deep-trunk cache (denoise_deep, "
                                       "denoise_reuse)"}

    def __init__(self, channels: Sequence[int] = (32, 64, 128, 256), embed_dim: int = 128,
                 inter_dim: int = 32, *, device=None, seed: int = 0, dtype=torch.float32):
        super().__init__()
        if dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"LegacyUNet runs in float32 or bfloat16, got {dtype}")
        device = resolve_device(device)
        self.channels, self.inter_dim, self.dtype = tuple(channels), inter_dim, dtype
        c0, c1, c2, c3 = channels
        e, d = embed_dim, dtype
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            self.embed2 = PromptMLP(e, d)
            self.embed = TimeMLP(inter_dim, e, d)
            self.conv1 = AdaptionHead(1, c0, e, d)
            self.down1_1 = StridedDownStage(c0, c1, e, d)
            self.down2_1 = StridedDownStage(c1, c2, e, d)
            self.down3_1 = StridedDownStage(c2, c3, e, d)
            self.conv2 = AdaptionHead(1, c0, e, d)
            self.down1 = StridedDownStage(c0, c1, e, d)
            self.down2 = StridedDownStage(c1, c2, e, d)
            self.down3 = StridedDownStage(c2, c3, e, d)
            self.middle1 = ResBlockModulate(c3, c3, e, dtype=d)
            self.up1 = TransposedUpStage(3 * c3, c2, e, d)
            self.up2 = TransposedUpStage(3 * c2, c1, e, d)
            self.up3 = TransposedUpStage(3 * c1, c0, e, d)
            self.final = LegacyFinalBlock(3 * c0, c0, e, d)
            self.out_proj = linear(c0, 1, dtype=d)
        self.to(device)
        self.eval()

    @property
    def device(self) -> torch.device:
        return self.out_proj.weight.device

    def use_mesh(self, mesh=None) -> "LegacyUNet":
        """The entry points' call (WavBEST.use_mesh): the legacy models run
        on one process, so `mesh` must be None (an unsharded call)."""
        if mesh is not None:
            raise ValueError(f"{type(self).__name__} runs on one process: it takes no "
                             "sharded call (use_mesh(None))")
        for m in self.modules():
            if hasattr(m, "mesh"):
                m.mesh = None
        return self

    def use_plain_conv(self, flag: bool = True) -> "LegacyUNet":
        """Route every SAME 3x3x3 conv to the plain PyTorch version (True) or
        to the CUDA kernel on a CUDA device (False, the default). The
        library convs are the same either way."""
        for m in self.modules():
            if hasattr(m, "plain"):
                m.plain = flag
        return self

    def encode_condition(self, pan, ms, prompt_emb):
        """{"cond": (pan - ms) as (B, bands, H, W, 1) in the model's dtype,
        "prompt": the (B, 768) prompt embedding, "zemb": its MLP}: what no
        step changes (no dropout site)."""
        prompt, zemb = prompt_embed(self, prompt_emb, ms.shape[0])
        return {"cond": (pan - ms).to(self.dtype)[..., None], "prompt": prompt, "zemb": zemb}

    def denoise(self, x_t, t, cache, *, train: bool = False, rng=None):
        """(B, bands, H, W) float32 x0-prediction from `encode_condition`'s
        cache: the time embedding, both encoders, the middle and the
        decoder."""
        rng = dropout_rng(train, rng)
        _, temb = time_embeds(self, t)
        zemb = cache["zemb"]
        xt = x_t.to(self.dtype)[..., None]
        c_taps, x_taps = encode(self, cache["cond"], xt, temb, zemb, rng)
        h = middle(self, x_taps[3], temb, zemb, rng)
        return decode(self, h, c_taps, x_taps, xt, temb, zemb, rng)

    def forward(self, x_t, t, pan, ms, prompt_emb, *, train: bool = False, rng=None):
        cache = self.encode_condition(pan, ms, prompt_emb)
        return self.denoise(x_t, t, cache, train=train, rng=rng)
