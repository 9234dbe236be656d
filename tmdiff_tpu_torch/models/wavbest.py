"""WavBEST: text-modulated wavelet UNet denoiser (port of
tmdiff_tpu/models/wavbest.py).

Inputs are the noisy residual x_t (B, bands, H, W), timesteps (B,), PAN
(B, 1, H, W), upsampled MS (B, bands, H, W) and a sensor prompt embedding
(768,) or (B, 768). Both image streams become (B, D=bands, H, W, 1), so every
conv is a 3-D conv with the bands as depth and one network serves 4- and
8-band sensors.

The condition branch takes no time embedding, so its features are the same
at every diffusion step: `encode_condition` computes them once per image and
`denoise` consumes them. `forward` is the two together. `denoise_deep` and
`denoise_reuse` split `denoise` at the deep trunk for block-cached sampling.

`dtype` (float32, or bfloat16 as the JAX package's `WavBEST(dtype=...)`)
is the type the blocks compute in; parameters stay float32. The prompt, the
time embedding, the condition `pan - ms` and x_t are cast to it on the way
in, and the denoise output is float32 in either type (the deep-trunk
features of denoise_deep keep `dtype`), so samplers run in float32 and a
training loss stays float32: a bf16 model trains with float32 parameters,
AdamW state and EMA (train/trainer.py), its convs' forward and input
gradient on K1's bf16 instance.

Each takes `train` (False by default, as serving runs): with train=True,
dropout draws its masks from `rng`, a torch.Generator on the model's device,
as the JAX model draws from its "dropout" rng collection.
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from tmdiff_tpu_torch.models.blocks import (
    AdaptionHead,
    DownStage,
    FinalBlock,
    ResBlockModulate,
    UpStage,
    dropout_rng,
    linear,
    swish,
)
from tmdiff_tpu_torch.ops.embedding import gamma_embedding
from tmdiff_tpu_torch.ops.modconv import IMPLS
from tmdiff_tpu_torch.utils.device import resolve_device


class TimeMLP(nn.Sequential):
    """The time-embedding MLP: inter_dim -> embed_dim -> embed_dim, SiLU
    between (the JAX package's TimeMLP; its lin0/lin1 are layers 0/2)."""

    def __init__(self, inter_dim: int, embed_dim: int, dtype=torch.float32):
        super().__init__(linear(inter_dim, embed_dim, dtype=dtype), nn.SiLU(),
                         linear(embed_dim, embed_dim, dtype=dtype))


class PromptMLP(nn.Sequential):
    """The prompt MLP: 768 -> 4 embed_dim -> 4 embed_dim -> embed_dim, SiLU
    between (the JAX package's PromptMLP; its lin0/lin1/lin2 are layers
    0/2/4)."""

    def __init__(self, embed_dim: int, dtype=torch.float32):
        e = embed_dim
        super().__init__(linear(768, 4 * e, dtype=dtype), nn.SiLU(),
                         linear(4 * e, 4 * e, dtype=dtype), nn.SiLU(),
                         linear(4 * e, e, dtype=dtype))


class WavBEST(nn.Module):
    """Flagship denoiser. Parameters are drawn from `seed` on the CPU (so a
    seed gives the same weights on every machine) and moved to `device`:
    CUDA unless the caller passes another; with no device given and no GPU,
    construction raises."""

    def __init__(self, channels: Sequence[int] = (32, 64, 128, 256),
                 embed_dim: int = 128, inter_dim: int = 32, *, device=None,
                 seed: int = 0, dtype=torch.float32):
        super().__init__()
        if dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"WavBEST runs in float32 or bfloat16, got {dtype}")
        device = resolve_device(device)
        self.inter_dim = inter_dim
        self.dtype = dtype
        c0, c1, c2, c3 = channels
        e, d = embed_dim, dtype
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            self.embed2 = PromptMLP(e, d)
            self.embed = TimeMLP(inter_dim, e, d)
            self.conv1 = AdaptionHead(1, c0, e, d)
            self.conv2 = AdaptionHead(1, c0, e, d)
            self.down1_1 = DownStage(c0, c1, e, use_temb=False, dtype=d)
            self.down2_1 = DownStage(c1, c2, e, use_temb=False, dtype=d)
            self.down3_1 = DownStage(c2, c3, e, use_temb=False, dtype=d)
            self.down1 = DownStage(c0, c1, e, dtype=d)
            self.down2 = DownStage(c1, c2, e, dtype=d)
            self.down3 = DownStage(c2, c3, e, dtype=d)
            self.middle1 = ResBlockModulate(c3, c3, e, dtype=d)
            self.up1 = UpStage(3 * c3, c2, c3, e, d)
            self.up2 = UpStage(3 * c2, c1, c2, e, d)
            self.up3 = UpStage(3 * c1, c0, c1, e, d)
            self.final = FinalBlock(3 * c0, c0, e, dtype=d)
        self.to(device)
        self.eval()

    @property
    def device(self) -> torch.device:
        return self.final.conv24.weight.device

    def use_plain_conv(self, flag: bool = True) -> "WavBEST":
        """Route every 3x3x3 conv to the plain PyTorch version (True) or to
        the CUDA kernel on a CUDA device (False, the default). For holding
        the kernel against its plain version on the same device."""
        for m in self.modules():
            if hasattr(m, "plain"):
                m.plain = flag
        return self

    def use_conv_impl(self, impl: str = "banded") -> "WavBEST":
        """Pick the 3x3x3 conv lowering of every conv (ops/modconv.py):
        "banded", the default, runs each through the 3x3x3 kernel; "auto"
        folds the bands of the lane-starved convs into channels and runs
        them through the 3x3 NHWC kernel, as the JAX package does under
        TMDIFF_CONV3D_IMPL=auto and TMDIFF_BANDLANES_CONV=pallas."""
        if impl not in IMPLS:
            raise ValueError(f"unknown conv lowering {impl!r}; expected one of {IMPLS}")
        for m in self.modules():
            if hasattr(m, "impl"):
                m.impl = impl
        return self

    def use_mesh(self, mesh=None) -> "WavBEST":
        """Run on this rank's shard of a sharded call: `mesh` is the mesh
        placed for the call's images (parallel/mesh.py, `Mesh.place`), or
        None for an unsharded call. Every 3x3x3 conv then exchanges halo
        rows where the placement splits the height, and dropout keeps this
        rank's shard of the global masks. The entry points (Pansharpener,
        Trainer) set it on every call."""
        for m in self.modules():
            if hasattr(m, "mesh"):
                m.mesh = mesh
        return self

    # -- embeddings -----------------------------------------------------------

    def prompt_embed(self, prompt_emb, batch: int):
        if prompt_emb.dim() == 1:
            prompt_emb = prompt_emb.expand(batch, prompt_emb.shape[0])
        return swish(self.embed2(prompt_emb.to(self.dtype)))

    def time_embed(self, t):
        return swish(self.embed(gamma_embedding(t.reshape(-1), self.inter_dim).to(self.dtype)))

    # -- condition branch (time-independent) ----------------------------------

    def encode_condition(self, pan, ms, prompt_emb, *, train: bool = False, rng=None):
        """-> dict of condition features and HF skips, constant across steps.
        On a space-sharded call, pan and ms are this rank's rows, and the
        divisibility check holds on them."""
        h, w = ms.shape[-2], ms.shape[-1]
        if h % 8 or w % 8:
            raise ValueError(
                f"WavBEST needs H and W divisible by 8 (three Haar wavelet "
                f"halvings); got {h}x{w}")
        rng = dropout_rng(train, rng)
        zemb = self.prompt_embed(prompt_emb, ms.shape[0])
        cond = (pan - ms).to(self.dtype)[..., None]
        c_h0 = self.conv1(cond, zemb)
        c_h1, c_s1 = self.down1_1(c_h0, None, zemb, rng)
        c_h2, c_s2 = self.down2_1(c_h1, None, zemb, rng)
        c_h3, c_s3 = self.down3_1(c_h2, None, zemb, rng)
        return {"zemb": zemb, "feats": (c_h0, c_h1, c_h2, c_h3),
                "skips": (c_s1, c_s2, c_s3)}

    # -- denoising given the cached condition ---------------------------------

    def _denoise_impl(self, x_t, t, cond_cache, deep=None, *, cache_level: int = 1,
                      train: bool = False, rng=None):
        """The shared denoise body. Given `deep`, the cached deep-trunk state
        of an earlier call, the blocks it stands for are skipped:
          * cache_level=1: deep = (x_h3, h_mid); skips down3 + middle1;
          * cache_level=2: deep = h_up1 (the up1 output); skips down3 +
            middle1 + up1;
          * cache_level=3: deep = h_up2 (the up2 output); skips down2 +
            down3 + middle1 + up1 + up2, the whole trunk at 1/4 resolution
            and below.
        Returns (out, deep_out), deep_out at the same level."""
        if cache_level not in (1, 2, 3):
            raise ValueError(f"cache_level must be 1, 2 or 3, got {cache_level}")
        rng = dropout_rng(train, rng)
        zemb = cond_cache["zemb"]
        c_h0, c_h1, c_h2, c_h3 = cond_cache["feats"]
        c_s1, c_s2, c_s3 = cond_cache["skips"]
        temb = self.time_embed(t)
        xt = x_t.to(self.dtype)[..., None]
        x_h0 = self.conv2(xt, zemb)
        x_h1, _ = self.down1(x_h0, temb, zemb, rng)
        if deep is not None and cache_level == 3:
            h = deep
        else:
            x_h2, _ = self.down2(x_h1, temb, zemb, rng)
            if deep is not None and cache_level == 2:
                h = deep
            else:
                if deep is None:
                    x_h3, _ = self.down3(x_h2, temb, zemb, rng)
                    h = self.middle1(x_h3, temb, zemb, rng)
                else:
                    x_h3, h = deep
                if cache_level == 1:
                    deep_out = (x_h3, h)
                h = self.up1((h, c_h3, x_h3), temb, zemb, c_s3, rng)
            if cache_level == 2:
                deep_out = h
            h = self.up2((h, c_h2, x_h2), temb, zemb, c_s2, rng)
        if cache_level == 3:
            deep_out = h
        h = self.up3((h, c_h1, x_h1), temb, zemb, c_s1, rng)
        out = self.final((h, c_h0, x_h0), temb, zemb, rng)
        # float32 for a float32 or bfloat16 model (a wider one keeps its type)
        return out[..., 0].to(torch.promote_types(self.dtype, torch.float32)), deep_out

    def denoise(self, x_t, t, cond_cache, *, train: bool = False, rng=None):
        """(B, bands, H, W) float32 x0-prediction of the clean residual."""
        return self._denoise_impl(x_t, t, cond_cache, train=train, rng=rng)[0]

    def denoise_deep(self, x_t, t, cond_cache, *, cache_level: int = 1, train: bool = False,
                     rng=None):
        """`denoise` that also returns the deep-trunk features, for a
        sampler to reuse over the next steps (block caching; see
        `_denoise_impl` for what each level holds)."""
        return self._denoise_impl(x_t, t, cond_cache, cache_level=cache_level, train=train,
                                  rng=rng)

    def denoise_reuse(self, x_t, t, cond_cache, deep, *, cache_level: int = 1,
                      train: bool = False, rng=None):
        """`denoise` on a cached deep trunk: the skipped blocks' features
        carry the earlier step's t; the shallow encoder, the decoder and the
        time embedding run at this t."""
        return self._denoise_impl(x_t, t, cond_cache, deep, cache_level=cache_level,
                                  train=train, rng=rng)[0]

    def forward(self, x_t, t, pan, ms, prompt_emb, *, train: bool = False, rng=None):
        cache = self.encode_condition(pan, ms, prompt_emb, train=train, rng=rng)
        return self.denoise(x_t, t, cache, train=train, rng=rng)
