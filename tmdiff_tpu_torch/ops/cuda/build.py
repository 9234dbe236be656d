"""Builds the CUDA sources under `tmdiff_tpu_torch/csrc/` into shared
libraries with a plain C interface and loads them with ctypes; also holds the
operand checks that every kernel wrapper makes before a launch.

Each library is compiled by `nvcc` for `sm_90a` at first use, into
`tmdiff_tpu_torch/build/` (git-ignored), under a name that carries a hash of
its source and of the shared headers (`csrc/*.cuh`), so an edited source or
header is rebuilt and an unchanged one is not.
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


def digest(name: str) -> str:
    """Hash of `csrc/<name>.cu`, every header `csrc/*.cuh` (a source may
    include any of them) and the nvcc flags: the library's name carries it,
    so an edit to the source or to a header rebuilds it."""
    h = hashlib.sha256()
    headers = sorted(n for n in os.listdir(CSRC) if n.endswith(".cuh"))
    for part in [name + ".cu", *headers]:
        with open(os.path.join(CSRC, part), "rb") as f:
            h.update(part.encode() + b"\0" + f.read() + b"\0")
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def build(name: str) -> str:
    """Compile `csrc/<name>.cu` unless a library of the same source and
    headers exists; returns the library's path."""
    src = os.path.join(CSRC, name + ".cu")
    lib = os.path.join(BUILD_DIR, f"lib{name}-{digest(name)}.so")
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


def check_operands(kernel_name: str, /, dtypes=(torch.float32,), **tensors) -> None:
    """The checks every kernel wrapper makes before a launch: each given
    tensor has the first one's dtype, one of `dtypes` (those the kernel has
    instances for), lies on the first one's device, and needs no gradient.
    A launch records no backward: the 3x3x3 conv's entries take a gradient
    through their autograd Function (ops/cuda/conv3d.py), whose forward and
    backward launch under no gradient; K3 and K4 have no backward, as their
    Pallas kernels have no VJP, so their wrappers refuse such inputs."""
    first, ref = next(iter(tensors.items()))
    if ref.dtype not in dtypes:
        names = " or ".join(str(d).replace("torch.", "") for d in dtypes)
        raise TypeError(f"{first} must be {names}, got {ref.dtype}")
    for name, t in tensors.items():
        if t is None:
            continue
        if t.device != ref.device:
            raise ValueError(f"{name} is on {t.device}, {first} on {ref.device}")
        if t.dtype != ref.dtype:
            raise TypeError(f"{name} is {t.dtype}, {first} {ref.dtype}: one launch takes one dtype")
        if t.requires_grad and torch.is_grad_enabled():
            raise RuntimeError(f"a {kernel_name} kernel launch has no backward; "
                               "call it under torch.no_grad()")
