"""Builds the CUDA sources under `tmdiff_tpu_torch/csrc/` into shared
libraries with a plain C interface and loads them with ctypes; also holds the
operand checks that every kernel wrapper makes before a launch.

Each library is compiled by `nvcc` for `sm_90a` at first use, into
`tmdiff_tpu_torch/build/` (git-ignored), under a name that carries a hash of
its source, so an edited source is rebuilt and an unchanged one is not.
Nothing here runs at import time: this module is imported on machines with
no CUDA toolkit.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# name -> {"seconds": build seconds (0.0 when cached), "log": nvcc's output}
build_info: dict[str, dict] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: put the CUDA toolkit's bin on PATH or set CUDA_HOME")
    return path


def build(name: str) -> str:
    """Compile `csrc/<name>.cu` unless a library of the same source exists;
    returns the library's path."""
    src = os.path.join(CSRC, name + ".cu")
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    lib = os.path.join(BUILD_DIR, f"lib{name}-{digest}.so")
    if os.path.exists(lib):
        build_info.setdefault(name, {"seconds": 0.0, "log": "cached"})
        return lib
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.tmp"
    t0 = time.perf_counter()
    proc = subprocess.run([nvcc_path(), *NVCC_FLAGS, "-o", tmp, src],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)
    build_info[name] = {"seconds": time.perf_counter() - t0,
                        "log": proc.stdout + proc.stderr}
    return lib


def sources() -> list[str]:
    """Names of the CUDA sources under `csrc/`, without `.cu`."""
    return sorted(n[:-3] for n in os.listdir(CSRC) if n.endswith(".cu"))


def build_all() -> list[str]:
    """Compile every source under `csrc/` at once, one nvcc each; returns
    the libraries' paths."""
    names = sources()
    with ThreadPoolExecutor(len(names)) as pool:
        return list(pool.map(build, names))


def load(name: str) -> ctypes.CDLL:
    """Loads the library of `csrc/<name>.cu`, built first if needed."""
    return ctypes.CDLL(build(name))


def check_operands(kernel_name: str, /, **tensors) -> None:
    """The checks every kernel wrapper makes: each given tensor is float32,
    on the first one's device, and needs no gradient (no kernel here has a
    backward)."""
    first, ref = next(iter(tensors.items()))
    for name, t in tensors.items():
        if t is None:
            continue
        if t.device != ref.device:
            raise ValueError(f"{name} is on {t.device}, {first} on {ref.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.requires_grad and torch.is_grad_enabled():
            raise RuntimeError(f"the {kernel_name} kernel has no backward; "
                               "call it under torch.no_grad()")
