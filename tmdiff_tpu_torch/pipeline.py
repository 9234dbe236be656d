"""Pansharpening facade (port of tmdiff_tpu/pipeline.py): encode the PAN/MS
condition once per image, run a sampler over the residual, add the
upsampled MS back and clip to [0, 1].

Samplers (`method`):
  * "dpm++"       30-step singlestep order-3 DPM-Solver++ (logSNR steps,
                  dynamic thresholding, denoise-to-zero: 31 denoiser calls);
  * "dpm++_noise" 50-step multistep order 3 with denoise-to-zero (51 calls);
  * "dpm++_cfg"   classifier-free guided 50-step multistep order 2 (50 calls
                  on the doubled batch), the unconditional branch on zeroed
                  MS; `guidance` a scalar or one scale per sample;
  * "ancestral"   the full T-step reverse loop, x0 semantics or the
                  reference's noise inversion (`legacy_noise_inversion`),
                  with `num_frames` snapshots;
  * "regression"  one call at t = T + 1 on x_T;
  * "ddim"        deterministic DDIM on the uniform integer grid (`steps`,
                  50 by default), the sampler distilled students are scored
                  with;
  * "ddim_cached" DDIM that refreshes the deep trunk every `refresh_every`
                  steps (or on a `refresh_mask` schedule) and runs the
                  shallow path on the cached one in between, at
                  `cache_level` 1-3, optionally `forecast` linearly.

x_T is drawn from a torch.Generator seeded by `seed` unless `x_init` gives
it; the ancestral sampler draws its per-step noise from the same generator
unless `step_noise` gives it. `sample(..., params=...)` runs with other
weights than the model's own (the EMA weights of a training run, as the JAX
facade takes `params`): the model's parameters are swapped for the given
tensors for the call (torch.func.functional_call) and come back untouched.
`sample_tiled` runs scenes larger than a tile through `sample` crop by crop.

`mesh` (parallel/mesh.py, one process per rank, every rank calling `sample`
with the same arguments) shards each call as the JAX facade's mesh does: the
batch over "data", the image height over "space", the weights replicated,
with the fallback to replication along an axis that does not divide. x_T
and the ancestral noise are drawn at the global shape from `seed` and
sharded; PAN, MS, `x_init`, `step_noise` and a per-sample guidance are
sharded; the output is gathered, so every rank returns the whole batch.

Spans of a `sample` call (utils/profiling.py, while its recorder is on):
`sample.h2d` (PAN, MS and the prompt rows to the device), `sample.encode`
(`encode_condition`), `sample.loop` (x_T to the residual) with one
`sample.denoise` around every network call (`kind` = "denoise", "deep" or
"reuse"), and `sample.d2h` (res2img, clamp, gather and the copy to numpy).

A batch may carry `HINT` (B, H, W, C) and `TASK` (B,) task ids for a model
that takes them (models/controlnet.py::ControlledLegacyUNet, whose
`hint_channels` says so): they go to its `encode_condition` as `hint` and
`task`, one task per row; a model that takes none refuses them. A model's
`REFUSED_SAMPLERS` (method -> reason) names the samplers it cannot run.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from tmdiff_tpu_torch.diffusion import gaussian
from tmdiff_tpu_torch.diffusion.dpm_solver import DPMSolver, NoiseScheduleVP, WrappedModel
from tmdiff_tpu_torch.diffusion.schedules import NoiseSchedule, make_beta_schedule
from tmdiff_tpu_torch.models.clip_text import load_prompt_table
from tmdiff_tpu_torch.utils import profiling
from tmdiff_tpu_torch.utils.device import resolve_device
from tmdiff_tpu_torch.utils.residual import res2img

METHODS = ("dpm++", "dpm++_noise", "dpm++_cfg", "ancestral", "regression", "ddim",
           "ddim_cached")


class Pansharpener:
    """A denoiser, its noise schedule and the frozen sensor-prompt table as
    one sampling API. Runs on CUDA unless `device` says otherwise; with no
    device given and no GPU, construction raises."""

    def __init__(self, model, schedule_name: str = "cosine", n_timestep: int = 1000,
                 model_type: str = "x_start", device=None, mesh=None):
        self.mesh = mesh
        self.device = resolve_device(device if mesh is None or device is not None
                                     else mesh.device)
        self.model = model.to(self.device).eval()
        self._closure = _Closure(self.model)
        self.model_type = model_type
        self.ns = NoiseSchedule.create(schedule_name, n_timestep).to(self.device)
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
               steps: Optional[int] = None, guidance=3.0, legacy_noise_inversion: bool = False,
               num_frames: Optional[int] = None, params=None, x_init=None, step_noise=None,
               refresh_every: int = 2, cache_level: int = 1, forecast: bool = False,
               refresh_mask=None, refresh_mask_static: bool = False):
        """Pansharpen one batch {"PAN": (B, 1, H, W), "MS": (B, bands, H, W)}
        into images in [0, 1], as a numpy array; with `num_frames`
        (ancestral only), (final, frames). `params`, a mapping of every
        parameter name of the model to a tensor on its device, replaces the
        model's weights for this call. `refresh_mask` (ddim_cached): one
        bool per step, the first True, decomposed into its chunks on the host
        before the run. `refresh_mask_static` is accepted for the JAX
        facade's signature: there it picks a specialised program over traced
        data, and the port's host loop runs both the same way."""
        if method not in METHODS:
            raise ValueError(f"unknown sampler {method!r}; expected one of {METHODS}")
        refused = getattr(self.model, "REFUSED_SAMPLERS", {})
        if method in refused:
            raise ValueError(f"{type(self.model).__name__} does not run {method!r}: "
                             f"{refused[method]}")
        if ("HINT" in batch or "TASK" in batch) and not getattr(self.model, "hint_channels",
                                                                 None):
            raise ValueError(f"{type(self.model).__name__} takes no HINT or TASK")
        if method != "ddim_cached":
            refresh_every, cache_level, forecast, refresh_mask = 2, 1, False, None
        if refresh_mask is not None:
            # checked on the host before the run, as the JAX facade checks it
            gaussian.refresh_chunks(refresh_mask, steps or 20)
            if forecast:
                raise ValueError("forecast is not supported with refresh_mask")
            refresh_mask = tuple(bool(v) for v in np.asarray(refresh_mask, bool))
        opts = dict(steps=steps, guidance=guidance, legacy=legacy_noise_inversion,
                    num_frames=num_frames, x_init=x_init, step_noise=step_noise,
                    refresh_every=refresh_every, cache_level=cache_level, forecast=forecast,
                    refresh_mask=refresh_mask)
        run = lambda: self._sample(batch, sensor, method, seed, **opts)
        if params is None:
            return run()
        return torch.func.functional_call(
            self._closure, {"model." + k: v for k, v in params.items()}, (run,), strict=True)

    def _tensor(self, a):
        return None if a is None else torch.as_tensor(a, dtype=torch.float32, device=self.device)

    def _sample(self, batch, sensor, method, seed, *, steps, guidance, legacy, num_frames,
                x_init, step_noise, refresh_every, cache_level, forecast, refresh_mask):
        model, dev = self.model, self.device
        mesh = None if self.mesh is None else self.mesh.place(np.shape(batch["MS"]))
        model.use_mesh(mesh)
        shard = (lambda a, lead=0: a) if mesh is None else mesh.shard
        with profiling.span("sample.h2d"):
            pan = shard(torch.as_tensor(batch["PAN"], dtype=torch.float32, device=dev))
            ms_global = torch.as_tensor(batch["MS"], dtype=torch.float32, device=dev)
            ms = shard(ms_global)
            prompt_emb = self.prompt_embedding(sensor)
            if prompt_emb.dim() == 2:
                prompt_emb = shard(prompt_emb)
            control = {}
            if "HINT" in batch or "TASK" in batch:  # the model refuses one without the other
                control = {"hint": self._tensor(batch.get("HINT")),
                           "task": None if batch.get("TASK") is None
                           else np.asarray(batch["TASK"]).astype(np.int64)}
        with profiling.span("sample.encode"):
            cache = model.encode_condition(pan, ms, prompt_emb, **control)
        frames = None
        with profiling.span("sample.loop"):
            gen = torch.Generator(device=dev).manual_seed(seed)
            x_T = self._tensor(x_init)
            if x_T is None:
                x_T = torch.randn(ms_global.shape, generator=gen, device=dev)
            x_T = shard(x_T)
            if step_noise is not None:
                step_noise = shard(self._tensor(step_noise), 1)
            if np.ndim(guidance) > 0:
                guidance = shard(np.asarray(guidance, np.float32))
            denoise = _spanned("denoise", lambda x, t, *_: model.denoise(x, t, cache))
            shape = tuple(ms.shape)

            if method == "ancestral":
                res = gaussian.ancestral_sample(
                    denoise, self.ns, gen, pan, ms, shape, legacy_noise_inversion=legacy,
                    num_frames=num_frames, x_init=x_T, step_noise=step_noise, mesh=mesh)
                if num_frames:
                    res, frames = res
            elif method == "regression":
                res = gaussian.regression_sample(denoise, gen, pan, ms, shape, x_init=x_T)
            elif method == "ddim":
                res = gaussian.ddim_sample(denoise, self.ns, gen, pan, ms, shape, steps=steps or 50,
                                           x_init=x_T, mesh=mesh)
            elif method == "ddim_cached":
                full = _spanned("deep", lambda x, t: model.denoise_deep(
                    x, t, cache, cache_level=cache_level))
                reuse = _spanned("reuse", lambda x, t, deep: model.denoise_reuse(
                    x, t, cache, deep, cache_level=cache_level))
                res = gaussian.ddim_sample_blockcached(
                    full, reuse, self.ns, gen, pan, ms, shape, steps=steps or 20,
                    refresh_every=refresh_every, x_init=x_T, forecast=forecast,
                    refresh_mask=refresh_mask, mesh=mesh)
            elif method == "dpm++_cfg":
                # both branches' condition features are time-independent: each
                # is encoded once, and the guidance wrapper concatenates them
                if np.ndim(guidance) == 0:
                    scale = float(np.float32(guidance))
                else:
                    scale = torch.as_tensor(np.asarray(guidance, np.float32), device=dev)
                wrapped = WrappedModel(
                    _spanned("denoise", lambda x, t, c: model.denoise(x, t, c)),
                    model_type=self.model_type,
                    guidance_type="classifier-free", guidance_scale=scale, condition=cache,
                    unconditional_condition=model.encode_condition(pan, torch.zeros_like(ms),
                                                                   prompt_emb))
                res = DPMSolver(wrapped, self.nsvp, mesh=mesh).sample(
                    x_T, steps=steps or 50, order=2, skip_type="logSNR", method="multistep")
            else:
                solver = DPMSolver(WrappedModel(denoise, self.model_type), self.nsvp, mesh=mesh)
                if method == "dpm++":
                    res = solver.sample(x_T, steps=steps or 30, order=3, skip_type="logSNR",
                                        method="singlestep", denoise_to_zero=True)
                else:  # dpm++_noise
                    res = solver.sample(x_T, steps=steps or 50, order=3, skip_type="logSNR",
                                        method="multistep", denoise_to_zero=True)
        gather = (lambda a, lead=0: a) if mesh is None else mesh.gather
        with profiling.span("sample.d2h"):
            out = gather(torch.clamp(res2img(res, ms), 0.0, 1.0)).cpu().numpy()
            if frames is None:
                return out
            return out, gather(torch.clamp(res2img(frames, ms[None]), 0.0, 1.0),
                               1).cpu().numpy()

    def sample_tiled(self, batch: dict, sensor="QB", tile: int = 256, overlap: int = 32,
                     tile_batch: int = 8, **kw):
        """Pansharpen scenes larger than a tile: overlapping `tile` x `tile`
        crops go through `sample`, `tile_batch` crops a call (the last call
        padded to `tile_batch` with copies of its last crop), and are blended
        with a separable linear feather over the overlap, normalised by the
        summed weights. A scene that fits one tile is `sample` itself. Crop
        call c0 samples with seed `seed + c0`; a scene with one side shorter
        than a tile is edge-padded to it and cropped back. A per-sample (B,)
        guidance is repeated for every crop of a call."""
        pan = np.asarray(batch["PAN"], np.float32)
        ms = np.asarray(batch["MS"], np.float32)
        B, C, H, W = ms.shape
        if H <= tile and W <= tile:
            return self.sample(batch, sensor=sensor, **kw)
        if not 0 <= overlap < tile:
            raise ValueError(f"need 0 <= overlap={overlap} < tile={tile}")
        if H < tile or W < tile:
            spec = ((0, 0), (0, 0), (0, max(0, tile - H)), (0, max(0, tile - W)))
            full = self.sample_tiled({"PAN": np.pad(pan, spec, mode="edge"),
                                      "MS": np.pad(ms, spec, mode="edge")},
                                     sensor=sensor, tile=tile, overlap=overlap,
                                     tile_batch=tile_batch, **kw)
            return full[:, :, :H, :W]

        def starts(size):
            ss = list(range(0, size - tile, tile - overlap))
            return ss + [size - tile]  # the last tile flush with the border

        ramp = np.minimum(np.arange(1, tile + 1), np.arange(tile, 0, -1)).astype(np.float32)
        ramp = np.minimum(ramp, max(overlap, 1))
        win = ramp[:, None] * ramp[None, :]
        out = np.zeros((B, C, H, W), np.float32)
        wsum = np.zeros((H, W), np.float32)
        crops = [(y, x) for y in starts(H) for x in starts(W)]
        seed0 = int(kw.pop("seed", 0))
        guidance = kw.pop("guidance", None)
        per_sample = guidance is not None and np.ndim(guidance) > 0
        if per_sample and len(np.atleast_1d(guidance)) != B:
            raise ValueError(f"per-sample guidance has {len(np.atleast_1d(guidance))} "
                             f"entries but the scene batch is {B}")
        for c0 in range(0, len(crops), tile_batch):
            chunk = crops[c0:c0 + tile_batch]
            n_real = len(chunk)
            if len(crops) > tile_batch and n_real < tile_batch:
                chunk = chunk + [chunk[-1]] * (tile_batch - n_real)
            pan_t = np.concatenate([pan[:, :, y:y + tile, x:x + tile] for y, x in chunk])
            ms_t = np.concatenate([ms[:, :, y:y + tile, x:x + tile] for y, x in chunk])
            sensors = sensor if isinstance(sensor, str) else list(sensor) * len(chunk)
            g_kw = {}
            if guidance is not None:
                g_kw["guidance"] = (np.tile(np.atleast_1d(guidance), len(chunk))
                                    if per_sample else guidance)
            preds = self.sample({"PAN": pan_t, "MS": ms_t}, sensor=sensors, seed=seed0 + c0,
                                **g_kw, **kw)
            for i, (y, x) in enumerate(chunk[:n_real]):
                out[:, :, y:y + tile, x:x + tile] += preds[i * B:(i + 1) * B] * win
                wsum[y:y + tile, x:x + tile] += win
        return out / wsum


def _spanned(kind: str, fn):
    """`fn`, each call inside a `sample.denoise` span of `kind`."""
    def call(*args):
        with profiling.span("sample.denoise", kind=kind):
            return fn(*args)
    return call


class _Closure(torch.nn.Module):
    """Holds the model as its submodule and runs a callable: functional_call
    on it swaps the model's parameters for a whole sampling run."""

    def __init__(self, model):
        super().__init__()
        self.model = model

    def forward(self, fn):
        return fn()
