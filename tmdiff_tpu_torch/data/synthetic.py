"""Synthetic PanCollection-format data for tests and CI (the port's copy of
tmdiff_tpu/data/synthetic.py: the same numpy draws, so the same seed gives
the same arrays bit for bit).

Generates small correlated MS/PAN scenes (smooth random fields + shared
structure so pansharpening metrics behave sensibly), optionally written as
.h5 files with the reference key layout, so the full train/val path runs
with no real satellite data or downloads (SURVEY.md §4 test plan item c).
"""
from __future__ import annotations

import numpy as np


def make_scene(rng: np.random.Generator, bands: int, size: int, scale: int = 4,
               noise: float = 0.015, detail: float = 0.08):
    """One scene: returns (gt, ms, lms, pan) in [0, 1], reference layouts.

    Structure (the physics pansharpening exploits, cf. PanCollection):
    - a LOW-frequency "material" field at 8×8 blocks — survives the ÷scale
      downsample, so `lms` recovers it exactly;
    - a HIGH-frequency "detail" field at 2×2 blocks, shared across bands
      with per-band gain — `ms`/`lms` average it away but `pan` keeps it,
      so a conditional model can beat the lms identity baseline by a wide
      margin (residual std ≈ detail·√(1−1/scale²) per pixel), while any
      unconditional predictor cannot;
    - per-band iid pixel `noise` — the irreducible floor for ANY predictor
      (bounds best SAM at ≈ noise-driven angle ≪ the lms baseline's).
    """
    base = rng.random((size // 8, size // 8))
    up = np.kron(base, np.ones((8, 8)))[:size, :size]
    det = np.kron(rng.standard_normal((size // 2, size // 2)),
                  np.ones((2, 2)))[:size, :size]
    # deterministic per-band detail gains (a fixed sensor property, like a
    # real spectral response): learnable, and makes the lms error show up
    # in SAM (band-differential), not just ERGAS/SSIM (common-mode)
    gains = 1.0 + 0.5 * np.cos(2.0 * np.pi * np.arange(bands) / max(bands, 1))
    gt = np.stack([
        np.clip(0.35 + 0.4 * up + detail * gains[b] * det
                + noise * rng.standard_normal((size, size))
                + 0.05 * b / max(bands - 1, 1), 0, 1)
        for b in range(bands)
    ])
    pan = gt.mean(axis=0, keepdims=True)
    small = size // scale
    ms = gt.reshape(bands, small, scale, small, scale).mean(axis=(2, 4))
    lms = np.kron(ms, np.ones((scale, scale)))[:, :size, :size]
    return gt.astype(np.float32), ms.astype(np.float32), lms.astype(np.float32), pan.astype(np.float32)


def make_arrays(n: int = 8, bands: int = 4, size: int = 32, seed: int = 0,
                noise: float = 0.015) -> dict:
    rng = np.random.default_rng(seed)
    scenes = [make_scene(rng, bands, size, noise=noise) for _ in range(n)]
    gt, ms, lms, pan = (np.stack(z) for z in zip(*scenes))
    return {"gt": gt, "ms": ms, "lms": lms, "pan": pan, "img_scale": 1.0}


def write_h5(path: str, n: int = 8, bands: int = 4, size: int = 32,
             seed: int = 0, img_scale: float = 2047.0,
             full_resolution: bool = False, noise: float = 0.015):
    """Write a synthetic file in raw counts so loaders exercise the ÷scale.

    `full_resolution=True` omits the `gt` key — the PanCollection FR (real
    full-scale, no-reference) file layout."""
    import h5py

    data = make_arrays(n, bands, size, seed, noise=noise)
    keys = ("ms", "lms", "pan") if full_resolution else ("gt", "ms", "lms", "pan")
    with h5py.File(path, "w") as f:
        for key in keys:
            f.create_dataset(key, data=data[key] * img_scale)
    return path
