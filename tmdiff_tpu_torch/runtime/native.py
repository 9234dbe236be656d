"""ctypes bindings of the C++ host-ops library (runtime/host_ops.cpp; port
of tmdiff_tpu/runtime/native.py).

The library is compiled by g++ at first use into the package's git-ignored
`build/` directory, under a name that carries a hash of the source, so an
edited source is rebuilt. A failed build or load raises. Each function
takes `native`: True (the default) runs the C++ kernel, False the numpy
code of data/h5.py; the results are the same bits (one float32 operation an
element either way). Nothing here falls back from one to the other.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

from tmdiff_tpu_torch.data import h5

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_HERE, "host_ops.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "build")
GXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17", "-pthread"]

_lock = threading.Lock()
_lib = None


def library_path() -> str:
    h = hashlib.sha256()
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    h.update(" ".join(GXX_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"libhost_ops-{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compiles host_ops.cpp unless a library of the same source exists;
    returns its path. Raises RuntimeError when g++ fails."""
    lib = library_path()
    if os.path.exists(lib):
        return lib
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.tmp"
    proc = subprocess.run(["g++", *GXX_FLAGS, SOURCE, "-o", tmp], capture_output=True, text=True,
                          timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed on {SOURCE}:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)
    return lib


def get_lib() -> ctypes.CDLL:
    """The loaded library, built first if needed."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            i64p = np.ctypeslib.ndpointer(np.int64, flags="C")
            f32p = np.ctypeslib.ndpointer(np.float32, flags="C")
            u16p = np.ctypeslib.ndpointer(np.uint16, flags="C")
            lib.gather_scale_f32.argtypes = [f32p, i64p, ctypes.c_int64, ctypes.c_int64,
                                             ctypes.c_float, f32p]
            lib.gather_residual_f32.argtypes = [f32p, f32p, i64p, ctypes.c_int64,
                                                ctypes.c_int64, f32p]
            lib.u16_to_f32_scale.argtypes = [u16p, ctypes.c_int64, ctypes.c_float, f32p]
            for fn in (lib.gather_scale_f32, lib.gather_residual_f32, lib.u16_to_f32_scale):
                fn.restype = None
            _lib = lib
        return _lib


def _rows(idx, n: int) -> np.ndarray:
    idx = np.ascontiguousarray(idx, np.int64)
    if idx.ndim != 1 or (idx.size and (idx.min() < 0 or idx.max() >= n)):
        raise IndexError(f"row indices must be a 1-D array in [0, {n})")
    return idx


def gather_scale(src: np.ndarray, idx: np.ndarray, scale: float = 1.0,
                 native: bool = True) -> np.ndarray:
    """out[i] = src[idx[i]] * float32(1 / scale), over axis 0."""
    src = np.ascontiguousarray(src, np.float32)
    idx = _rows(idx, src.shape[0])
    if not native:
        return src[idx] * np.float32(1.0 / scale)
    out = np.empty((len(idx), *src.shape[1:]), np.float32)
    get_lib().gather_scale_f32(src, idx, len(idx), int(np.prod(src.shape[1:], dtype=np.int64)),
                               1.0 / scale, out)
    return out


def gather_residual(hr: np.ndarray, lms: np.ndarray, idx: np.ndarray,
                    native: bool = True) -> np.ndarray:
    """out[i] = hr[idx[i]] - lms[idx[i]]."""
    hr = np.ascontiguousarray(hr, np.float32)
    lms = np.ascontiguousarray(lms, np.float32)
    if hr.shape != lms.shape:
        raise ValueError(f"hr {hr.shape} and lms {lms.shape} differ")
    idx = _rows(idx, hr.shape[0])
    if not native:
        return hr[idx] - lms[idx]
    out = np.empty((len(idx), *hr.shape[1:]), np.float32)
    get_lib().gather_residual_f32(hr, lms, idx, len(idx),
                                  int(np.prod(hr.shape[1:], dtype=np.int64)), out)
    return out


def counts_to_float(src: np.ndarray, scale: float, native: bool = True) -> np.ndarray:
    """Sensor counts -> float32 in [0, 1]: data/h5.py::counts_to_float, the
    uint16 case in C++ when `native`."""
    if not native or src.dtype != np.uint16:
        return h5.counts_to_float(src, scale)
    src = np.ascontiguousarray(src)
    out = np.empty(src.shape, np.float32)
    get_lib().u16_to_f32_scale(src.reshape(-1), src.size, 1.0 / scale, out.reshape(-1))
    return out
