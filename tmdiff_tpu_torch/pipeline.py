"""Pansharpening facade (port of tmdiff_tpu/pipeline.py, the `dpm++`
sampler): encode the PAN/MS condition once per image, run 30-step singlestep
order-3 DPM-Solver++ (logSNR steps, dynamic thresholding, denoise-to-zero:
31 denoiser calls), add the upsampled MS back and clip to [0, 1]."""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from tmdiff_tpu_torch.diffusion.dpm_solver import DPMSolver, NoiseScheduleVP, WrappedModel
from tmdiff_tpu_torch.diffusion.schedules import make_beta_schedule
from tmdiff_tpu_torch.models.clip_text import load_prompt_table
from tmdiff_tpu_torch.utils.device import resolve_device
from tmdiff_tpu_torch.utils.residual import res2img


class Pansharpener:
    """A denoiser, its noise schedule and the frozen sensor-prompt table as
    one sampling API. Runs on CUDA unless `device` says otherwise; with no
    device given and no GPU, construction raises."""

    def __init__(self, model, schedule_name: str = "cosine", n_timestep: int = 1000,
                 model_type: str = "x_start", device=None):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.model_type = model_type
        self.nsvp = NoiseScheduleVP("discrete", betas=make_beta_schedule(schedule_name, n_timestep))
        table, self.prompt_index, self.is_real_clip = load_prompt_table()
        # a copy: the loaded table is cached and shared, and a caller may pin a row
        self.prompt_table = torch.as_tensor(table, device=self.device).clone()

    def prompt_embedding(self, sensor):
        """(768,) for one sensor name, or (B, 768) for one name per batch row."""
        if isinstance(sensor, str):
            return self.prompt_table[self.prompt_index[sensor]]
        return self.prompt_table[[self.prompt_index[s] for s in sensor]]

    @torch.inference_mode()
    def sample(self, batch: dict, sensor="QB", method: str = "dpm++", seed: int = 0,
               steps: Optional[int] = None, x_init=None) -> np.ndarray:
        """Pansharpen one batch {"PAN": (B, 1, H, W), "MS": (B, bands, H, W)}
        into images in [0, 1], as a numpy array. x_T is drawn from a
        torch.Generator seeded by `seed` unless `x_init` gives it."""
        if method != "dpm++":
            raise ValueError(f"unknown sampler {method!r}; the port has 'dpm++'")
        pan = torch.as_tensor(batch["PAN"], dtype=torch.float32, device=self.device)
        ms = torch.as_tensor(batch["MS"], dtype=torch.float32, device=self.device)
        cache = self.model.encode_condition(pan, ms, self.prompt_embedding(sensor))
        if x_init is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            x_T = torch.randn(ms.shape, generator=gen, device=self.device)
        else:
            x_T = torch.as_tensor(x_init, dtype=torch.float32, device=self.device)
        wrapped = WrappedModel(lambda x, t: self.model.denoise(x, t, cache), self.model_type)
        res = DPMSolver(wrapped, self.nsvp).sample(
            x_T, steps=steps or 30, order=3, skip_type="logSNR", method="singlestep",
            denoise_to_zero=True)
        return torch.clamp(res2img(res, ms), 0.0, 1.0).cpu().numpy()
