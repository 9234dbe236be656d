"""Non-causal attention over (B, H, S, D) tensors: the CUDA kernel's wrapper
and its plain PyTorch version.

Both compute softmax(q kᵀ · scale) v with an fp32 softmax, scale defaulting
to D ** -0.5, for q (B, H, Sq, D) and k, v (B, H, Skv, D); Sq and Skv may
differ (cross-attention).

`flash_attention` replaces the Pallas TPU kernel
`tmdiff_tpu/ops/pallas/flash_attention.py::flash_attention` and launches the
kernel of `tmdiff_tpu_torch/csrc/flash_attention.cu` (its header says what
bounds it on an H100 and how it is tiled). It takes D up to 256 and masks
the ragged edges itself, so nothing is padded. On a CPU tensor it computes
`attention_reference`; on a CUDA tensor it launches the kernel or raises.
The kernel has no backward: the wrapper refuses inputs that need a gradient.
"""
from __future__ import annotations

import ctypes

import torch

from tmdiff_tpu_torch.ops.cuda import build

MAX_HEAD_DIM = 256
MAX_BATCH_HEADS = 65535  # the kernel's second grid dimension

# Launches of the CUDA kernel since the last reset_launches().
launches = 0


def reset_launches() -> None:
    global launches
    launches = 0


def attention_reference(q, k, v, scale=None):
    """Plain einsum attention (fp32 softmax)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    s = torch.einsum("bhqd,bhkd->bhqk", q, k).float() * scale
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype), v)


_lib = None


def library():
    """The kernel's ctypes library, built and loaded at first use."""
    global _lib
    if _lib is None:
        lib = build.load("flash_attention")
        lib.tmdiff_flash_attention.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_void_p])
        lib.tmdiff_flash_attention.restype = ctypes.c_int
        lib.tmdiff_flash_error_string.argtypes = [ctypes.c_int]
        lib.tmdiff_flash_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _check(q, k, v):
    build.check_operands("flash_attention", q=q, k=k, v=v)
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dim() != 4 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous (B, H, S, D) tensor, got {tuple(t.shape)}")
    b, h, sq, d = q.shape
    skv = k.shape[2]
    if tuple(k.shape) != (b, h, skv, d) or tuple(v.shape) != (b, h, skv, d):
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} must be ({b}, {h}, Skv, {d})")
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"head dim {d} outside 1..{MAX_HEAD_DIM}")
    if not 1 <= b * h <= MAX_BATCH_HEADS or sq < 1 or skv < 1:
        raise ValueError(f"unsupported attention size q {tuple(q.shape)}, Skv {skv}")
    if max(q.numel(), k.numel()) >= 2**31:
        raise ValueError(f"tensors of {max(q.numel(), k.numel())} elements exceed 32-bit indexing")


def flash_attention(q, k, v, scale=None):
    """softmax(q kᵀ · scale) v (see module doc); the port of K4."""
    if q.device.type == "cpu":
        return attention_reference(q, k, v, scale)
    if q.device.type != "cuda":
        raise ValueError(f"no flash_attention kernel for device {q.device}")
    _check(q, k, v)
    b, h, sq, d = q.shape
    if scale is None:
        scale = d ** -0.5
    o = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        lib = library()
        err = lib.tmdiff_flash_attention(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                                         b * h, sq, k.shape[2], d, float(scale), stream)
    if err:
        raise RuntimeError(f"flash_attention kernel launch failed: {lib.tmdiff_flash_error_string(err).decode()}")
    global launches
    launches += 1
    return o
