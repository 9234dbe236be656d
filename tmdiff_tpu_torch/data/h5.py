"""PanCollection h5 data model (port of tmdiff_tpu/data/h5.py), numpy only.

Files hold `gt` (HRMS), `ms` (LRMS), `lms` (upsampled MS) and `pan`, each
(N, C, H, W) counts; values divide by 1023 (GaoFen-2, 10-bit) or 2047 (11-bit
sensors), inferred from the file name or given. A sample is
  {LR, PAN, MS (= lms), HR, Res = HR - MS}  with Res in [-1, 1]
(the diffusion target is the residual). `h5py` is imported only where a file
is read, so the rest runs where it is not installed.

The batch gathers are numpy with the semantics of the native host kernels
(runtime/native.py, which computes the same bits in C++): rows gathered in
index order, uint16 counts times the float32 reciprocal of the scale, other
counts divided by the float32 scale, the residual as one float32
subtraction. `merge_patches_4x4`, `split_patches_4x4` and `repack_h5_merged`
make the 16-to-1 merged training variant.
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np

KEYS = ("gt", "ms", "lms", "pan")


def infer_img_scale(path: str) -> float:
    return 1023.0 if "gf2" in os.path.basename(path).lower() else 2047.0


def counts_to_float(src: np.ndarray, scale: float) -> np.ndarray:
    """Sensor counts -> float32 in [0, 1]."""
    if src.dtype != np.uint16:
        return np.asarray(src, np.float32) / np.float32(scale)
    return src.astype(np.float32) * np.float32(1.0 / scale)


def load_pancollection(path: str, img_scale: Optional[float] = None) -> dict:
    import h5py

    scale = infer_img_scale(path) if img_scale is None else img_scale
    out = {}
    with h5py.File(path, "r") as f:
        for key in KEYS:
            if key in f:
                out[key] = counts_to_float(np.asarray(f[key]), scale)
    # full-resolution sets ship no ground truth: keep lms in its place for
    # shapes, and record the absence for evaluation
    out["has_reference"] = "gt" in out
    if not out["has_reference"]:
        out["gt"] = out["lms"]
    out["img_scale"] = scale
    return out


class PanDataset:
    """In-RAM dataset with the reference's sample semantics."""

    def __init__(self, path_or_arrays, img_scale: Optional[float] = None, data_len: int = -1):
        if isinstance(path_or_arrays, str):
            data = load_pancollection(path_or_arrays, img_scale)
        else:
            data = dict(path_or_arrays)
        self.gt = data.get("gt")
        self.ms = data["ms"]
        self.lms = data["lms"]
        self.pan = data["pan"]
        self.has_reference = bool(data.get("has_reference", self.gt is not None))
        if self.gt is None:
            self.gt = self.lms
        self.img_scale = float(data.get("img_scale", img_scale or 2047.0))
        n = self.ms.shape[0]
        self.length = n if data_len <= 0 else min(data_len, n)

    def __len__(self):
        return self.length

    @property
    def bands(self) -> int:
        return self.gt.shape[1]

    def __getitem__(self, index):
        hr = self.gt[index]
        lms = self.lms[index]
        return {"LR": self.ms[index], "PAN": self.pan[index], "MS": lms, "HR": hr,
                "Res": hr - lms}

    def batch(self, idx: np.ndarray) -> dict:
        """Batched gather of the rows `idx`, as float32 arrays."""
        idx = np.asarray(idx, np.int64)
        take = lambda a: np.ascontiguousarray(a, np.float32)[idx]
        hr, lms = take(self.gt), take(self.lms)
        return {"LR": take(self.ms), "PAN": take(self.pan), "MS": lms, "HR": hr,
                "Res": hr - lms}


class LazyPanDataset:
    """PanDataset for sets larger than RAM: the arrays stay in the h5 file and
    each batch reads and normalises only its rows. Same sample semantics and
    interface (len, bands, batch, __getitem__, has_reference)."""

    def __init__(self, path: str, img_scale: Optional[float] = None, data_len: int = -1):
        import h5py

        self._file = h5py.File(path, "r")
        self.img_scale = float(infer_img_scale(path) if img_scale is None else img_scale)
        self.has_reference = "gt" in self._file
        self._gt_key = "gt" if self.has_reference else "lms"
        n = self._file["ms"].shape[0]
        self.length = n if data_len <= 0 else min(data_len, n)

    def __len__(self):
        return self.length

    @property
    def bands(self) -> int:
        return self._file[self._gt_key].shape[1]

    def _read(self, key: str, uniq: np.ndarray) -> np.ndarray:
        return counts_to_float(np.asarray(self._file[key][uniq]), self.img_scale)

    def batch(self, idx: np.ndarray) -> dict:
        # h5py's fancy indexing takes strictly increasing unique indices:
        # read the unique rows once and fan them back out
        uniq, inv = np.unique(np.asarray(idx), return_inverse=True)
        hr = self._read(self._gt_key, uniq)[inv]
        lms = self._read("lms", uniq)[inv]
        return {"LR": self._read("ms", uniq)[inv], "PAN": self._read("pan", uniq)[inv],
                "MS": lms, "HR": hr, "Res": hr - lms}

    def __getitem__(self, index):
        b = self.batch(np.array([index]))
        return {k: v[0] for k, v in b.items()}

    def close(self):
        self._file.close()


def merge_patches_4x4(imgs: np.ndarray) -> np.ndarray:
    """(16, C, h, w) -> (C, 4h, 4w), the patches tiled row-major."""
    b, c, h, w = imgs.shape
    if b != 16:
        raise ValueError(f"merge_patches_4x4 takes 16 patches, got {b}")
    return imgs.reshape(4, 4, c, h, w).transpose(2, 0, 3, 1, 4).reshape(c, 4 * h, 4 * w)


def split_patches_4x4(patch: np.ndarray) -> np.ndarray:
    """(C, 4h, 4w) -> (16, C, h, w), the inverse of merge_patches_4x4."""
    c, ph, pw = patch.shape
    h, w = ph // 4, pw // 4
    return patch.reshape(c, 4, h, 4, w).transpose(1, 3, 0, 2, 4).reshape(16, c, h, w)


def repack_h5_merged(src: str, dst: str):
    """Offline 16-to-1 patch merger writing the 256x256 training variant of
    a PanCollection file (the reference's `read_h5`): every run of 16
    consecutive samples becomes one, a trailing partial run is dropped."""
    import h5py

    with h5py.File(src, "r") as f:
        arrays = {k: np.asarray(f[k], np.float32) for k in KEYS if k in f}
    merged = {k: [] for k in arrays}
    n = next(iter(arrays.values())).shape[0]
    for i in range(0, n - 15, 16):
        for k, v in arrays.items():
            merged[k].append(merge_patches_4x4(v[i:i + 16]))
    with h5py.File(dst, "w") as f:
        for k, v in merged.items():
            f.create_dataset(k, data=np.stack(v))
