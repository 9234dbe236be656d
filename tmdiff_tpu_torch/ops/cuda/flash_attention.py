"""Non-causal attention over (B, H, S, D) tensors: the CUDA kernel's wrapper,
its plan, and its plain PyTorch versions.

All compute softmax(q kᵀ · scale) v with an fp32 softmax, scale defaulting
to D ** -0.5, for q (B, H, Sq, D) and k, v (B, H, Skv, D); Sq and Skv may
differ (cross-attention). q, k and v are all float32 or all bfloat16.

`flash_attention` replaces the Pallas TPU kernel
`tmdiff_tpu/ops/pallas/flash_attention.py::flash_attention` and launches the
kernels of `tmdiff_tpu_torch/csrc/flash_attention.cu` (its header says what
bounds them on an H100 and how they are tiled). It takes D up to 256 and
masks the ragged edges itself, so nothing is padded. `plan` picks the
kernel's variant by D and the dtype: in float32 the 3xTF32 tensor-core
kernel for D % 4 == 0 (with split-KV where the query tiles underfill the
card), else the fp32 FMA kernel; `variant_launches` counts the launches of
each. In bf16 it computes what the Pallas kernel computes for bf16 operands
(each tile cast to fp32, both products and the softmax in fp32, the output
rounded to bf16 once): the bf16 tensor-core kernel ("bf16": bf16 wgmma, K
and V read in place by TMA, p as two bf16 parts) for D % 8 == 0 (16-byte
bf16 rows), else the FMA kernel over bf16 loads ("bf16_fma"); the kernels
read and write bf16 in device memory. On a CPU tensor it computes
`flash_attention_plain`, that function in plain PyTorch; on a CUDA tensor it
launches the kernel or raises. The kernel has no backward: the wrapper
refuses inputs that need a gradient.

`attention_reference` is the port of the JAX package's `attention_reference`
(p rounded to v's dtype before p·v, as there); the attention library's
`use_flash=False` takes it. In float32 it equals `flash_attention_plain`.

`attention_partials` and `merge_partials` are the plain versions of the
kernel's split-KV: each split's unnormalised output and softmax statistics,
and their combination. The tests hold them against the JAX package; the
card path does not use them.
"""
from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

from tmdiff_tpu_torch.ops.cuda import build

MAX_HEAD_DIM = 256
MAX_BATCH_HEADS = 65535  # the kernel's second grid dimension
KEY_TILES = {torch.float32: (8, 16, 32, 64), torch.bfloat16: (16, 32, 64, 128)}

# Launches of the CUDA kernel since the last reset_launches(), in all and by
# variant: fp32 FMA, 3xTF32 tensor cores, and their bf16 instances.
VARIANTS = ("fma", "tc", "bf16_fma", "bf16")
launches = 0
variant_launches = dict.fromkeys(VARIANTS, 0)


def reset_launches() -> None:
    global launches
    launches = 0
    variant_launches.update(dict.fromkeys(VARIANTS, 0))


def attention_reference(q, k, v, scale=None):
    """Plain einsum attention (fp32 softmax)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    s = torch.einsum("bhqd,bhkd->bhqk", q, k).float() * scale
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype), v)


def flash_attention_plain(q, k, v, scale=None):
    """The kernel's function in plain PyTorch: q, k, v upcast to fp32,
    softmax(q kᵀ · scale) v in fp32, rounded once to q's dtype."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def attention_partials(q, k, v, splits, key_tile=64, scale=None):
    """The kernel's split-KV in plain PyTorch: the keys, cut into tiles of
    `key_tile`, go to `splits` ranges of ceil(tiles / splits) whole tiles;
    split i gives its unnormalised output O_i = sum_j exp(s_j - m_i) v_j,
    its row max m_i and its sum l_i = sum_j exp(s_j - m_i), each stacked
    over the splits. A split past the last key gives O = 0, m = -inf,
    l = 0."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    skv = k.shape[2]
    per = _cdiv(_cdiv(skv, key_tile), splits) * key_tile  # keys per split
    outs, maxes, sums = [], [], []
    for i in range(splits):
        lo, hi = i * per, min(skv, (i + 1) * per)
        if lo >= hi:
            outs.append(torch.zeros_like(q, dtype=torch.float32))
            maxes.append(torch.full(q.shape[:-1], -math.inf, device=q.device))
            sums.append(torch.zeros(q.shape[:-1], device=q.device))
            continue
        s = torch.einsum("bhqd,bhkd->bhqk", q, k[:, :, lo:hi]).float() * scale
        m = s.amax(-1)
        p = torch.exp(s - m[..., None])
        outs.append(torch.einsum("bhqk,bhkd->bhqd", p, v[:, :, lo:hi].float()))
        maxes.append(m)
        sums.append(p.sum(-1))
    return torch.stack(outs), torch.stack(maxes), torch.stack(sums)


def merge_partials(o, m, l):
    """Combines attention_partials' splits, in split order:
    sum_i exp(m_i - M) O_i / sum_i exp(m_i - M) l_i with M = max_i m_i."""
    mx = m.amax(0)
    num, den = torch.zeros_like(o[0]), torch.zeros_like(l[0])
    for oi, mi, li in zip(o, m, l):
        w = torch.exp(mi - mx)
        num += w[..., None] * oi
        den += w * li
    return num / den[..., None]


class Plan(NamedTuple):
    variant: str          # one of VARIANTS
    rows: int             # query rows per block
    key_tile: int         # keys per staged K/V tile
    splits: int           # blocks that share one query tile's keys
    workspace_bytes: int  # K/V images (float32) and split partials (tensor cores only)


def head_tile(d: int) -> int:
    """D padded up to the tensor-core kernels' head-dim tile."""
    return 64 if d <= 64 else 128 if d <= 128 else 256


def max_key_tile(dt: int, dtype: torch.dtype = torch.float32) -> int:
    """The longest key tile whose stages fit shared memory (and, in bf16,
    whose S and P fit the registers beside O and the tile's accumulator) at
    head tile dt."""
    if dtype == torch.bfloat16:
        return {64: 128, 128: 64, 256: 32}[dt]
    return {64: 64, 128: 32, 256: 16}[dt]


def plan(b: int, h: int, sq: int, skv: int, d: int, sm_count: int,
         dtype: torch.dtype = torch.float32) -> Plan:
    """The kernel's variant and tiling for q (b, h, sq, d) of `dtype` and Skv
    keys on a card of `sm_count` SMs (one block per SM):
      * the tensor cores where a row is whole 16-byte chunks: "tc" at D % 4
        == 0 in float32, "bf16" at D % 8 == 0 in bfloat16; else the FMA
        kernel, "fma" or "bf16_fma" (64 rows, 64 keys, no split);
      * 128 query rows per block (two consumer warpgroups of 64), 64 at
        D > 128, where both consumers share the rows and split the columns;
      * key tile: the smallest of KEY_TILES[dtype] that covers Skv, else the
        largest, at most max_key_tile(head tile, dtype): 64 / 32 / 16 in
        float32 and 128 / 64 / 32 in bfloat16 at head tile 64 / 128 / 256;
      * splits: where the blocks fall short of one wave, the key tiles are
        shared out over floor(SMs / blocks) blocks (at most one per tile),
        whole tiles each, so the grid comes as close to one wave as it can
        without passing it;
      * workspace: in float32 the split K/V^T images (per (batch*head, key
        tile), head tile * key tile values of K and of V^T, each as TF32 hi
        and lo: 16 bytes an element pair), 256-byte aligned; then, split, the
        fp32 partial O and (m, l) of every split and query row. In bfloat16
        the kernel reads K and V in place: only the partials, only when
        split.
    """
    bf16 = dtype == torch.bfloat16
    if d % (8 if bf16 else 4):
        return Plan("bf16_fma" if bf16 else "fma", 64, 64, 1, 0)
    dt = head_tile(d)
    rows = 64 if dt == 256 else 128
    tiles = KEY_TILES[dtype]
    key_tile = min(next((t for t in tiles if t >= skv), tiles[-1]), max_key_tile(dt, dtype))
    n_tiles = _cdiv(skv, key_tile)
    blocks = b * h * _cdiv(sq, rows)
    splits = max(1, min(n_tiles, sm_count // blocks))
    splits = _cdiv(n_tiles, _cdiv(n_tiles, splits))  # every split owns a tile
    partials = 4 * splits * b * h * sq * (d + 2) if splits > 1 else 0
    if bf16:
        return Plan("bf16", rows, key_tile, splits, partials)
    nbytes = b * h * n_tiles * 16 * dt * key_tile
    if partials:
        nbytes = _cdiv(nbytes, 256) * 256 + partials
    return Plan("tc", rows, key_tile, splits, nbytes)


_lib = None


def library():
    """The kernel's ctypes library, built and loaded at first use."""
    global _lib
    if _lib is None:
        lib = build.load("flash_attention")
        lib.tmdiff_flash_attention.argtypes = (
            [ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_float]
            + [ctypes.c_int] * 4
            + [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p])
        lib.tmdiff_flash_attention.restype = ctypes.c_int
        lib.tmdiff_flash_error_string.argtypes = [ctypes.c_int]
        lib.tmdiff_flash_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


# (B, H, Sq, D, Skv, dtype, device index) -> Plan; device index -> SM count.
_plans: dict[tuple, Plan] = {}
_sm_counts: dict[int, int] = {}


def device_plan(q, skv: int) -> Plan:
    """`plan` for q on its card, asked of the card once per device and
    kept per shape."""
    dev = q.device.index
    key = (*q.shape, skv, q.dtype, dev)
    if key not in _plans:
        if dev not in _sm_counts:
            _sm_counts[dev] = torch.cuda.get_device_properties(dev).multi_processor_count
        b, h, sq, d = q.shape
        _plans[key] = plan(b, h, sq, skv, d, _sm_counts[dev], q.dtype)
    return _plans[key]


def _check(q, k, v):
    build.check_operands("flash_attention", dtypes=(torch.float32, torch.bfloat16), q=q, k=k, v=v)
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
    row = 16 // q.element_size()  # elements of a 16-byte chunk
    if d % row == 0:  # the tensor-core variants read and write 16-byte rows
        for name, t in (("q", q), ("k", k), ("v", v)):
            if t.data_ptr() % 16:
                raise ValueError(f"{name} must be 16-byte aligned when D % {row} == 0")


def flash_attention(q, k, v, scale=None):
    """softmax(q kᵀ · scale) v (see module doc); the port of K4."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, scale)
    if q.device.type != "cuda":
        raise ValueError(f"no flash_attention kernel for device {q.device}")
    if q.device.index != torch.cuda.current_device():
        with torch.cuda.device(q.device):
            return flash_attention(q, k, v, scale)
    _check(q, k, v)
    b, h, sq, d = q.shape
    skv = k.shape[2]
    if scale is None:
        scale = d ** -0.5
    o = torch.empty_like(q)
    p = device_plan(q, skv)
    ws = (torch.empty(p.workspace_bytes, dtype=torch.uint8, device=q.device)
          if p.workspace_bytes else None)
    lib = library()
    err = lib.tmdiff_flash_attention(
        int(q.dtype == torch.bfloat16), q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        b * h, sq, skv, d, float(scale), int(p.variant in ("tc", "bf16")), p.rows, p.key_tile,
        p.splits, None if ws is None else ws.data_ptr(), p.workspace_bytes,
        # the current stream's handle without building a Stream object
        # (several microseconds a call; the one-key cross-attention is bound
        # by the host)
        torch._C._cuda_getCurrentRawStream(q.device.index))
    if err:
        raise RuntimeError(f"flash_attention kernel launch failed: {lib.tmdiff_flash_error_string(err).decode()}")
    global launches
    launches += 1
    variant_launches[p.variant] += 1
    return o
