"""Evaluation artifacts (port of the .mat writer and the display stretch of
tmdiff_tpu/utils/export.py; its h5 -> PNG exporter, which needs cv2, is not
ported)."""
from __future__ import annotations

import numpy as np


def to_uint8(img: np.ndarray, percentile_clip: float = 99.5) -> np.ndarray:
    """(H, W, C) float -> uint8 with a percentile stretch (satellite counts
    are heavy-tailed; a plain max scales to near-black images)."""
    hi = np.percentile(img, percentile_clip)
    lo = np.percentile(img, 100 - percentile_clip)
    out = np.clip((img - lo) / max(hi - lo, 1e-9), 0, 1)
    return (out * 255.0).round().astype(np.uint8)


def save_mat(path: str, sr_hwc: np.ndarray, img_scale: float = 1.0):
    """The validation artifact {"sr": (H, W, C) x scale}, as the reference's
    val loop writes it, stamped with the CLIP conditioning mode so that
    placeholder-table outputs identify themselves."""
    import scipy.io as scio

    from tmdiff_tpu_torch.models.clip_text import clip_mode

    scio.savemat(path, {"sr": sr_hwc * img_scale, "clip_mode": clip_mode()})
