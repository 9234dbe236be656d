"""Validation harness (port of tmdiff_tpu/eval/harness.py): run the sampler
over a dataset, write .mat artifacts, aggregate metrics.

Per image, as the reference's val loop: sample, clamp to [0, 1], save
`output_mulExm_{idx}.mat` with key "sr" scaled back to sensor counts
(H, W, C), score SSIM and SAM against the ground truth, and report
per-sensor means and seconds per image. As in the JAX package, images go
through the sampler in batches, the mean divides by the sensor's own count,
and full-resolution sets (no ground truth) are scored by the no-reference
suite (D_lambda, D_s, QNR, FCC, SF, SD) against the low-resolution MS and
the PAN.
"""
from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Optional

import numpy as np
import torch

from tmdiff_tpu_torch.eval import metrics as M
from tmdiff_tpu_torch.eval import metrics_torch as MT
from tmdiff_tpu_torch.utils.export import save_mat as write_mat


def validate(sharpener, dataset, sensor: str, result_dir: Optional[str] = None,
             method: str = "dpm++", steps: Optional[int] = None, batch_size: int = 4,
             max_images: int = -1, save_mat: bool = True, full_suite: bool = False,
             seed: int = 0, params=None, log_file: Optional[str] = None,
             reference_parity: bool = False, device_metrics: bool = True,
             score: bool = True) -> dict:
    """Scores of `dataset` through `sharpener.sample` (with `params` when
    given: e.g. the EMA weights), keyed `{metric}_{sensor}`, plus
    `sec_per_image_{sensor}`.

    `log_file` appends one JSON line of metrics per image.
    `reference_parity=True` declares that the numbers will be compared with
    the reference's, which is meaningless while the prompt table is the
    placeholder: it goes through `require_real_clip`.
    `device_metrics=True` scores SSIM and SAM of each batch on the
    sampler's device (`metrics_torch`, the reference's torch twins): SAM is
    the numpy suite's to 1e-5; SSIM takes a Gaussian window
    (`metrics.ssim_gaussian` on the host), where the numpy suite's takes a
    uniform one, so the two may differ by more than the JAX package's
    harness states (1e-3). `full_suite`, full-resolution sets and
    `device_metrics=False` take the numpy suite.

    `score=False` only samples, and returns {}: a rank other than 0 of a
    meshed sampler takes part in every sampling call, and rank 0 scores."""
    if reference_parity:
        from tmdiff_tpu_torch.models.clip_text import require_real_clip

        require_real_clip("eval.harness.validate(reference_parity=True)")
    n = len(dataset) if max_images <= 0 else min(max_images, len(dataset))
    if result_dir:
        os.makedirs(result_dir, exist_ok=True)
    fast = device_metrics and dataset.has_reference and not full_suite
    sums: dict[str, float] = {}
    idx_out = 0
    t0 = time.time()
    with open(log_file, "a") if log_file else contextlib.nullcontext() as log_fh:
        for start in range(0, n, batch_size):
            batch = dataset.batch(np.arange(start, min(start + batch_size, n)))
            preds = sharpener.sample(batch, sensor=sensor, method=method, steps=steps,
                                     seed=seed + start, params=params)
            if not score:
                continue
            if fast:
                with torch.no_grad():
                    pred_t = torch.as_tensor(preds, device=sharpener.device)
                    gt_t = torch.as_tensor(batch["HR"], device=sharpener.device)
                    ssim_v = MT.ssim_per_image(pred_t, gt_t, 1.0).cpu().numpy()
                    sam_v = MT.sam_per_image(gt_t, pred_t).cpu().numpy()
            for b in range(preds.shape[0]):
                pred_hwc = np.transpose(preds[b], (1, 2, 0))
                gt_hwc = np.transpose(batch["HR"][b], (1, 2, 0))
                if save_mat and result_dir:
                    write_mat(os.path.join(result_dir, f"output_mulExm_{idx_out}.mat"), pred_hwc,
                             img_scale=dataset.img_scale)
                if not dataset.has_reference:
                    vals = M.evaluate_fr(np.transpose(batch["LR"][b], (1, 2, 0)),
                                         batch["PAN"][b, 0], pred_hwc)
                elif full_suite:
                    vals = M.evaluate_rr(gt_hwc, pred_hwc, 1.0)
                elif fast:
                    vals = {"ssim": float(ssim_v[b]), "sam": float(sam_v[b])}
                else:
                    vals = {"ssim": M.ssim(pred_hwc, gt_hwc, 1.0), "sam": M.sam(pred_hwc, gt_hwc)}
                if log_fh:
                    log_fh.write(json.dumps({"idx": idx_out, "sensor": sensor,
                                             **{k: float(v) for k, v in vals.items()}}) + "\n")
                for k, v in vals.items():
                    sums[k] = sums.get(k, 0.0) + v
                idx_out += 1
    if not score:
        return {}
    out = {f"{k}_{sensor}": v / idx_out for k, v in sums.items()}
    out[f"sec_per_image_{sensor}"] = (time.time() - t0) / max(idx_out, 1)
    return out

