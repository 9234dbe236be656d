"""WavBEST: text-modulated wavelet UNet denoiser (port of
tmdiff_tpu/models/wavbest.py), eval mode.

Inputs are the noisy residual x_t (B, bands, H, W), timesteps (B,), PAN
(B, 1, H, W), upsampled MS (B, bands, H, W) and a sensor prompt embedding
(768,) or (B, 768). Both image streams become (B, D=bands, H, W, 1), so every
conv is a 3-D conv with the bands as depth and one network serves 4- and
8-band sensors.

The condition branch takes no time embedding, so its features are the same
at every diffusion step: `encode_condition` computes them once per image and
`denoise` consumes them. `forward` is the two together.
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
    linear,
    swish,
)
from tmdiff_tpu_torch.ops.embedding import gamma_embedding
from tmdiff_tpu_torch.ops.modconv import IMPLS
from tmdiff_tpu_torch.utils.device import resolve_device


class WavBEST(nn.Module):
    """Flagship denoiser. Parameters are drawn from `seed` on the CPU (so a
    seed gives the same weights on every machine) and moved to `device`:
    CUDA unless the caller passes another; with no device given and no GPU,
    construction raises."""

    def __init__(self, channels: Sequence[int] = (32, 64, 128, 256),
                 embed_dim: int = 128, inter_dim: int = 32, *, device=None,
                 seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        self.inter_dim = inter_dim
        c0, c1, c2, c3 = channels
        e = embed_dim
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            self.embed2 = nn.Sequential(linear(768, 4 * e), nn.SiLU(),
                                        linear(4 * e, 4 * e), nn.SiLU(),
                                        linear(4 * e, e))
            self.embed = nn.Sequential(linear(inter_dim, e), nn.SiLU(), linear(e, e))
            self.conv1 = AdaptionHead(1, c0, e)
            self.conv2 = AdaptionHead(1, c0, e)
            self.down1_1 = DownStage(c0, c1, e, use_temb=False)
            self.down2_1 = DownStage(c1, c2, e, use_temb=False)
            self.down3_1 = DownStage(c2, c3, e, use_temb=False)
            self.down1 = DownStage(c0, c1, e)
            self.down2 = DownStage(c1, c2, e)
            self.down3 = DownStage(c2, c3, e)
            self.middle1 = ResBlockModulate(c3, c3, e)
            self.up1 = UpStage(3 * c3, c2, c3, e)
            self.up2 = UpStage(3 * c2, c1, c2, e)
            self.up3 = UpStage(3 * c1, c0, c1, e)
            self.final = FinalBlock(3 * c0, c0, e)
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

    # -- embeddings -----------------------------------------------------------

    def prompt_embed(self, prompt_emb, batch: int):
        if prompt_emb.dim() == 1:
            prompt_emb = prompt_emb.expand(batch, prompt_emb.shape[0])
        return swish(self.embed2(prompt_emb.to(torch.float32)))

    def time_embed(self, t):
        return swish(self.embed(gamma_embedding(t.reshape(-1), self.inter_dim)))

    # -- condition branch (time-independent) ----------------------------------

    def encode_condition(self, pan, ms, prompt_emb):
        """-> dict of condition features and HF skips, constant across steps."""
        h, w = ms.shape[-2], ms.shape[-1]
        if h % 8 or w % 8:
            raise ValueError(
                f"WavBEST needs H and W divisible by 8 (three Haar wavelet "
                f"halvings); got {h}x{w}")
        zemb = self.prompt_embed(prompt_emb, ms.shape[0])
        cond = (pan - ms).to(torch.float32)[..., None]
        c_h0 = self.conv1(cond, zemb)
        c_h1, c_s1 = self.down1_1(c_h0, None, zemb)
        c_h2, c_s2 = self.down2_1(c_h1, None, zemb)
        c_h3, c_s3 = self.down3_1(c_h2, None, zemb)
        return {"zemb": zemb, "feats": (c_h0, c_h1, c_h2, c_h3),
                "skips": (c_s1, c_s2, c_s3)}

    # -- denoising given the cached condition ---------------------------------

    def denoise(self, x_t, t, cond_cache):
        """(B, bands, H, W) x0-prediction of the clean residual."""
        zemb = cond_cache["zemb"]
        c_h0, c_h1, c_h2, c_h3 = cond_cache["feats"]
        c_s1, c_s2, c_s3 = cond_cache["skips"]
        temb = self.time_embed(t)
        xt = x_t.to(torch.float32)[..., None]
        x_h0 = self.conv2(xt, zemb)
        x_h1, _ = self.down1(x_h0, temb, zemb)
        x_h2, _ = self.down2(x_h1, temb, zemb)
        x_h3, _ = self.down3(x_h2, temb, zemb)
        h = self.middle1(x_h3, temb, zemb)
        h = self.up1((h, c_h3, x_h3), temb, zemb, c_s3)
        h = self.up2((h, c_h2, x_h2), temb, zemb, c_s2)
        h = self.up3((h, c_h1, x_h1), temb, zemb, c_s1)
        out = self.final((h, c_h0, x_h0), temb, zemb)
        return out[..., 0]

    def forward(self, x_t, t, pan, ms, prompt_emb):
        return self.denoise(x_t, t, self.encode_condition(pan, ms, prompt_emb))
