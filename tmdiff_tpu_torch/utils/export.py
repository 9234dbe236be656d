"""Evaluation artifacts (port of tmdiff_tpu/utils/export.py): the display
stretch, the h5 -> PNG exporter and the .mat writer. The JAX package writes
its PNGs through cv2; the port has a small PNG writer of its own (zlib and
struct, 8-bit RGB or grey, no filtering), which stores the same pixels."""
from __future__ import annotations

import json
import os
import struct
import zlib
from typing import Optional, Sequence

import numpy as np


def to_uint8(img: np.ndarray, percentile_clip: float = 99.5) -> np.ndarray:
    """(H, W, C) float -> uint8 with a percentile stretch (satellite counts
    are heavy-tailed; a plain max scales to near-black images)."""
    hi = np.percentile(img, percentile_clip)
    lo = np.percentile(img, 100 - percentile_clip)
    out = np.clip((img - lo) / max(hi - lo, 1e-9), 0, 1)
    return (out * 255.0).round().astype(np.uint8)


def write_png(path: str, img: np.ndarray) -> None:
    """An (H, W, 3) RGB or (H, W) grey uint8 image as an 8-bit PNG."""
    img = np.ascontiguousarray(img)
    if img.dtype != np.uint8 or img.ndim not in (2, 3) or (img.ndim == 3 and img.shape[2] != 3):
        raise ValueError(f"write_png takes (H, W) or (H, W, 3) uint8, got {img.dtype} {img.shape}")
    h, w = img.shape[:2]
    color = 2 if img.ndim == 3 else 0
    rows = b"".join(b"\x00" + img[i].tobytes() for i in range(h))  # filter 0 a row

    def chunk(kind: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0)))
        f.write(chunk(b"IDAT", zlib.compress(rows, 6)))
        f.write(chunk(b"IEND", b""))


def export_h5_to_png(h5_path: str, out_dir: str, rgb_bands: Sequence[int] = (2, 1, 0),
                     max_images: int = -1, questions: Optional[str] = None,
                     img_scale: Optional[float] = None) -> int:
    """Writes RGB composites of the file's `gt` (or `lms`) images as
    img_{i}.png; with `questions`, a question.jsonl naming each image (the
    reference's PNGfile.py). Returns the number of images written."""
    from tmdiff_tpu_torch.data.h5 import load_pancollection

    data = load_pancollection(h5_path, img_scale)
    os.makedirs(out_dir, exist_ok=True)
    imgs = data["gt"]
    n = imgs.shape[0] if max_images <= 0 else min(max_images, imgs.shape[0])
    rows = []
    for i in range(n):
        rgb = np.transpose(imgs[i][list(rgb_bands)], (1, 2, 0))
        path = os.path.join(out_dir, f"img_{i}.png")
        write_png(path, to_uint8(rgb))
        rows.append({"image": os.path.basename(path), "question": questions or ""})
    if questions is not None:
        with open(os.path.join(out_dir, "question.jsonl"), "w") as f:
            for row in rows:
                f.write(json.dumps(row) + "\n")
    return n


def save_mat(path: str, sr_hwc: np.ndarray, img_scale: float = 1.0):
    """The validation artifact {"sr": (H, W, C) x scale}, as the reference's
    val loop writes it, stamped with the CLIP conditioning mode so that
    placeholder-table outputs identify themselves."""
    import scipy.io as scio

    from tmdiff_tpu_torch.models.clip_text import clip_mode

    scio.savemat(path, {"sr": sr_hwc * img_scale, "clip_mode": clip_mode()})
