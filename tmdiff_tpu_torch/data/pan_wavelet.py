"""Wavelet-augmented dataset variant (port of
tmdiff_tpu/data/pan_wavelet.py; reference `data/PAN.py:33-205`): the
dataset of the `dpm++_noise` / `regression` model variants that take an
extra `wav` conditioning tensor. numpy only, as the JAX package's:

  * a level-1 db1 (Haar) decomposition of lms and pan; `wav` packs
    [lms_LL, pan_H, pan_D, pan_V] along the channels;
  * an optional high-pass pre-filter x - boxFilter(x) on ms and pan;
  * normalisation to [-1, 1] (per-array min/max) or [0, 1] (by the sensor
    scale);
  * augmentations: flips and random channel erasure of the MS, drawn from a
    seeded numpy generator (the same draws as the JAX package's).
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from tmdiff_tpu_torch.data.h5 import infer_img_scale


def _haar_level1(x: np.ndarray):
    """(..., H, W) -> (LL, (H, V, D)) with pywt's wavedec2 db1 conventions
    (cH the horizontal edges), orthonormal."""
    a = x[..., 0::2, 0::2]
    b = x[..., 0::2, 1::2]
    c = x[..., 1::2, 0::2]
    d = x[..., 1::2, 1::2]
    ll = (a + b + c + d) / 2.0
    ch = (a + b - c - d) / 2.0
    cv = (a - b + c - d) / 2.0
    cd = (a - b - c + d) / 2.0
    return ll, (ch, cv, cd)


def _box_filter(x: np.ndarray, ksize: int = 5) -> np.ndarray:
    from scipy.ndimage import uniform_filter

    return uniform_filter(x, size=(1, 1, ksize, ksize))


class WaveletPanDataset:
    """Returns dicts {LR, PAN, MS, HR, Res, wav} of (C, H, W) arrays."""

    def __init__(self, path_or_arrays, img_scale: Optional[float] = None, norm_range: bool = True,
                 wavelets: bool = True, highpass: bool = False, hp_ksize: int = 5,
                 aug_prob: float = 0.0, data_len: int = -1, seed: int = 3407):
        if isinstance(path_or_arrays, str):
            import h5py

            scale = infer_img_scale(path_or_arrays) if img_scale is None else img_scale
            with h5py.File(path_or_arrays, "r") as f:
                raw = {k: np.asarray(f[k], np.float32) for k in f.keys()}
        else:
            raw = {k: np.asarray(v, np.float32) for k, v in path_or_arrays.items()
                   if k != "img_scale"}
            scale = img_scale or float(path_or_arrays.get("img_scale", 1.0))
        if "gt" not in raw:
            raw["gt"] = raw["lms"]

        if highpass:
            raw["ms"] = raw["ms"] - _box_filter(raw["ms"], hp_ksize)
            raw["pan"] = raw["pan"] - _box_filter(raw["pan"], hp_ksize)

        if wavelets:
            lms_ll, _ = _haar_level1(raw["lms"])
            _, (pan_h, pan_v, pan_d) = _haar_level1(raw["pan"])
            wav_parts = [lms_ll, pan_h, pan_d, pan_v]  # the reference's order

        def norm(x):
            if not norm_range:
                return x / scale
            x = x - x.min()
            x = x / x.max()
            return 2.0 * x - 1.0

        self.pan = norm(raw["pan"])
        self.ms = norm(raw["ms"])
        self.lms = norm(raw["lms"])
        self.gt = norm(raw["gt"])
        self.wav = np.concatenate([norm(p) for p in wav_parts], axis=1) if wavelets else None
        self.img_scale = scale
        n = self.ms.shape[0]
        self.length = n if data_len <= 0 else min(data_len, n)
        self.aug_prob = aug_prob
        self.rng = np.random.default_rng(seed)

    def __len__(self):
        return self.length

    @property
    def bands(self) -> int:
        return self.gt.shape[1]

    def _augment(self, sample: dict) -> dict:
        """A random flip of every image alike, then a random erasure of MS
        channels (the reference's geo_trans and RandomEraseChannel)."""
        if self.rng.random() < self.aug_prob:
            axis = -1 if self.rng.random() < 0.5 else -2
            sample = {k: np.flip(v, axis=axis).copy() for k, v in sample.items()}
        if self.rng.random() < self.aug_prob:
            ms = sample["MS"].copy()
            erase = self.rng.random(ms.shape[0]) < 0.5
            ms[erase] = 0.0
            sample["MS"] = ms
        return sample

    def _gather(self, index) -> dict:
        out = {"LR": self.ms[index], "PAN": self.pan[index], "MS": self.lms[index],
               "HR": self.gt[index], "Res": self.gt[index] - self.lms[index]}
        if self.wav is not None:
            out["wav"] = self.wav[index]
        return out

    def __getitem__(self, index):
        out = self._gather(index)
        return self._augment(out) if self.aug_prob > 0 else out

    def batch(self, idx: np.ndarray) -> dict:
        """Rows `idx` stacked, without augmentation."""
        return self._gather(idx)
