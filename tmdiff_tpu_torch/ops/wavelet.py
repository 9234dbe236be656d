"""Discrete wavelet transforms over channels-last tensors (port of
tmdiff_tpu/ops/wavelet.py).

Two paths, as in the JAX package:
  * the orthonormal 2-D Haar transform as reshape butterflies, the one
    WavBEST calls (`dwt2d`, `idwt2d`, `dwt2d_ll` with their defaults). With
    a = x[2i, 2j], b = x[2i, 2j+1], c = x[2i+1, 2j], d = x[2i+1, 2j+1]:

        LL = (a+b+c+d)/2   LH = (a-b+c-d)/2   HL = (a+b-c-d)/2   HH = (a-b-c+d)/2

    LH is the width detail and HL the height detail, as in the reference code
    (`DWT_IDWT_Functions.py:47-58`), not its docstring;
  * the reference's banded analysis / synthesis matrices for any even-length
    orthogonal filter bank (haar, db1-3 from published constants, any dbN
    by spectral factorisation, `register_wavelet` for others), built once
    per size in numpy (the JAX package's construction, copied) and applied
    as einsums: 2-D (`impl="matrix"`, or "auto" off the Haar fast path, odd
    sizes included), 1-D and 3-D.

`dwt2d`/`idwt2d` take (..., H, W, C) and (LL, LH, HL, HH), each (..., H/2,
W/2, C); `dwt1d` transforms the second-to-last axis of (..., L, C); `dwt3d`
transforms (..., D, H, W, C) into 8 subbands keyed "lll".."hhh" (depth,
height, width). Gradients come from autograd: every path is linear.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch

_R2 = 1.0 / math.sqrt(2.0)

# Filter banks: (dec_lo, dec_hi, rec_lo, rec_hi), pywt sign/order conventions.
# The values are standard published wavelet coefficients (constants, not code).
_D2 = math.sqrt(2.0)
_DB2_LO = np.array(
    [-0.12940952255092145, 0.22414386804185735, 0.836516303737469, 0.48296291314469025]
)
_DB3_LO = np.array(
    [
        0.035226291882100656,
        -0.08544127388224149,
        -0.13501102001039084,
        0.4598775021193313,
        0.8068915093133388,
        0.3326705529509569,
    ]
)


def _qmf(w: np.ndarray) -> np.ndarray:
    """Quadrature-mirror filter (pywt convention): qmf(w)[k] = (-1)^k · w[n-1-k]."""
    n = len(w)
    return np.array([(-1) ** k * w[n - 1 - k] for k in range(n)])


def _bank(dec_lo: np.ndarray) -> dict:
    """Derive the full 4-filter bank from the decomposition low-pass,
    matching pywt's orthogonal-wavelet conventions."""
    dec_lo = np.asarray(dec_lo, dtype=np.float64)
    rec_lo = dec_lo[::-1].copy()
    rec_hi = _qmf(rec_lo)
    dec_hi = rec_hi[::-1].copy()
    return {"dec_lo": dec_lo, "dec_hi": dec_hi, "rec_lo": rec_lo, "rec_hi": rec_hi}


FILTER_BANKS: dict[str, dict] = {
    "haar": _bank(np.array([_R2, _R2])),
    "db1": _bank(np.array([_R2, _R2])),
    "db2": _bank(_DB2_LO),
    "db3": _bank(_DB3_LO),
}


def _daubechies_dec_lo(n: int) -> np.ndarray:
    """Daubechies-N decomposition low-pass by spectral factorisation (the
    standard minimal-phase construction — keep the |z| < 1 root of each
    quadratic factor of P(y), y = (2 − z − z⁻¹)/4). Matches pywt's dbN
    coefficient tables to fp64 (pinned in tests against the db2/db3
    published constants above)."""
    if n == 1:
        return np.array([_R2, _R2])
    # P(y) = Σ_{k<n} C(n-1+k, k) y^k  (vanishing-moment halfband condition)
    p_y = [math.comb(n - 1 + k, k) for k in range(n)]
    y_roots = np.roots(p_y[::-1])
    z_roots = []
    for y in y_roots:
        zr = np.roots([1.0, 4.0 * y - 2.0, 1.0])
        z_roots.append(zr[np.argmin(np.abs(zr))])
    rec_lo = np.real(np.poly([-1.0] * n + z_roots))
    rec_lo *= math.sqrt(2.0) / rec_lo.sum()
    return rec_lo[::-1].copy()  # pywt stores dec_lo = reversed rec_lo


def register_wavelet(name: str, dec_lo) -> None:
    """Ingest an arbitrary orthogonal filter bank (pywt `dec_lo` convention:
    even length, Σ = √2); the remaining three filters derive by QMF. The
    reference accepts any pywt wavelet name (`DWT_IDWT_layer.py:31-36`) —
    this is the equivalent extension point without a pywt dependency."""
    dec_lo = np.asarray(dec_lo, dtype=np.float64)
    if dec_lo.ndim != 1 or len(dec_lo) % 2:
        raise ValueError("dec_lo must be a 1-D even-length filter")
    if abs(dec_lo.sum() - math.sqrt(2.0)) > 1e-6:
        raise ValueError("orthogonal bank requires sum(dec_lo) == sqrt(2)")
    FILTER_BANKS[name] = _bank(dec_lo)


def available_wavelets() -> list[str]:
    return sorted(FILTER_BANKS.keys()) + ["dbN (any N, generated)"]


def get_bank(wavelet: str) -> dict:
    if wavelet in FILTER_BANKS:
        return FILTER_BANKS[wavelet]
    if wavelet.startswith("db") and wavelet[2:].isdigit():
        FILTER_BANKS[wavelet] = _bank(_daubechies_dec_lo(int(wavelet[2:])))
        return FILTER_BANKS[wavelet]
    try:  # real pywt, when the environment has it
        import pywt

        w = pywt.Wavelet(wavelet)
        if not w.orthogonal:
            raise ValueError(f"wavelet {wavelet!r} is not orthogonal")
        register_wavelet(wavelet, np.asarray(w.dec_lo))
        return FILTER_BANKS[wavelet]
    except ImportError:
        pass
    raise ValueError(
        f"unknown wavelet {wavelet!r}; available: {available_wavelets()}, "
        "or ingest coefficients via register_wavelet(name, dec_lo)"
    )


# ---------------------------------------------------------------------------
# Matrix construction — replicates the reference banded-matrix semantics
# (`DWT_IDWT_layer.py:270-319` for analysis, `:362-410` for synthesis) so the
# generic path is numerically identical, including odd-size truncation.
# ---------------------------------------------------------------------------


def _banded(n_rows: int, n_full: int, band: np.ndarray) -> np.ndarray:
    m = np.zeros((n_rows, n_full + len(band) - 2))
    for i in range(n_rows):
        # Clip at the right edge: the reference's construction never hits this
        # for the even sizes it supports; clipping extends odd-size support.
        avail = min(len(band), m.shape[1] - 2 * i)
        m[i, 2 * i : 2 * i + avail] = band[:avail]
    return m


@functools.lru_cache(maxsize=None)
def analysis_matrices(size: int, wavelet: str = "haar"):
    """(L, H): analysis operators, shapes (size//2, size) and (size - size//2, size).

    The reference uses the *reconstruction* filters for analysis
    (`DWT_2D.__init__`, `DWT_IDWT_layer.py:262-264`); we keep that convention.
    """
    bank = get_bank(wavelet)
    band_lo, band_hi = bank["rec_lo"], bank["rec_hi"]
    length = len(band_lo)
    half = length // 2
    end = None if half == 1 else (-half + 1)
    lo = _banded(size // 2, size, band_lo)[:, half - 1 : end]
    hi = _banded(size - size // 2, size, band_hi)[:, half - 1 : end]
    return lo, hi


@functools.lru_cache(maxsize=None)
def synthesis_matrices(size: int, wavelet: str = "haar"):
    """(L, H) synthesis operators; reference uses reversed decomposition filters
    (`IDWT_2D.__init__`, `DWT_IDWT_layer.py:352-356`)."""
    bank = get_bank(wavelet)
    band_lo = bank["dec_lo"][::-1]
    band_hi = bank["dec_hi"][::-1]
    length = len(band_lo)
    half = length // 2
    end = None if half == 1 else (-half + 1)
    lo = _banded(size // 2, size, band_lo)[:, half - 1 : end]
    hi = _banded(size - size // 2, size, band_hi)[:, half - 1 : end]
    return lo, hi


# ---------------------------------------------------------------------------
# Fast Haar path: reshape butterflies over (..., H, W, C).
# ---------------------------------------------------------------------------


def _quads(x):
    *lead, h, w, c = x.shape
    if h % 2 or w % 2:
        raise ValueError(f"Haar DWT needs even H and W, got {h}x{w}")
    r = x.reshape(*lead, h // 2, 2, w // 2, 2, c)
    return r[..., 0, :, 0, :], r[..., 0, :, 1, :], r[..., 1, :, 0, :], r[..., 1, :, 1, :]


def _haar_dwt2d(x):
    a, b, c, d = _quads(x)
    ll = (a + b + c + d) * 0.5
    lh = (a - b + c - d) * 0.5
    hl = (a + b - c - d) * 0.5
    hh = (a - b - c + d) * 0.5
    return ll, lh, hl, hh


def _haar_idwt2d(ll, lh, hl, hh):
    *lead, h2, w2, c = ll.shape
    a = (ll + lh + hl + hh) * 0.5
    b = (ll - lh + hl - hh) * 0.5
    cc = (ll + lh - hl - hh) * 0.5
    d = (ll - lh - hl + hh) * 0.5
    row0 = torch.stack([a, b], dim=-2)
    row1 = torch.stack([cc, d], dim=-2)
    out = torch.stack([row0, row1], dim=-4)
    return out.reshape(*lead, h2 * 2, w2 * 2, c)


# ---------------------------------------------------------------------------
# Generic matrix path (even-length filters; odd sizes truncate as the
# reference's matrices do).
# ---------------------------------------------------------------------------


def _on(m: np.ndarray, like):
    return torch.as_tensor(m, dtype=like.dtype, device=like.device)


def _matrix_dwt2d(x, wavelet: str):
    h, w = x.shape[-3], x.shape[-2]
    lo_h, hi_h = (_on(m, x) for m in analysis_matrices(h, wavelet))
    lo_w, hi_w = (_on(m, x) for m in analysis_matrices(w, wavelet))

    def rows(m, arr):
        return torch.einsum("ph,...hwc->...pwc", m, arr)

    def cols(arr, m):
        return torch.einsum("...hwc,qw->...hqc", arr, m)

    xl = rows(lo_h, x)
    xh = rows(hi_h, x)
    # LH = low rows x high columns (width detail), HL = high rows x low columns
    return cols(xl, lo_w), cols(xl, hi_w), cols(xh, lo_w), cols(xh, hi_w)


def _matrix_idwt2d(ll, lh, hl, hh, wavelet: str, out_h: int, out_w: int):
    lo_h, hi_h = (_on(m, ll) for m in synthesis_matrices(out_h, wavelet))
    lo_w, hi_w = (_on(m, ll) for m in synthesis_matrices(out_w, wavelet))

    def up(arr, mh, mw):
        arr = torch.einsum("ph,...pwc->...hwc", mh, arr)
        return torch.einsum("...hqc,qw->...hwc", arr, mw)

    return up(ll, lo_h, lo_w) + up(lh, lo_h, hi_w) + up(hl, hi_h, lo_w) + up(hh, hi_h, hi_w)


# ---------------------------------------------------------------------------
# Public 2-D API
# ---------------------------------------------------------------------------


def dwt2d(x, wavelet: str = "haar", impl: str = "auto"):
    """2-D DWT over (..., H, W, C) -> (LL, LH, HL, HH). impl "fast" (Haar
    butterflies, even sizes), "matrix", or "auto": fast where it applies."""
    h, w = x.shape[-3], x.shape[-2]
    use_fast = wavelet in ("haar", "db1") and h % 2 == 0 and w % 2 == 0
    if impl == "matrix" or (impl == "auto" and not use_fast):
        return _matrix_dwt2d(x, wavelet)
    if not use_fast:
        raise ValueError(f"fast impl needs haar + even sizes, got {wavelet} {h}x{w}")
    return _haar_dwt2d(x)


def idwt2d(ll, lh, hl, hh, wavelet: str = "haar", impl: str = "auto"):
    """Inverse of dwt2d: four (..., h, w, C) bands -> (..., 2h, 2w, C)."""
    out_h = ll.shape[-3] + hh.shape[-3]
    out_w = ll.shape[-2] + hh.shape[-2]
    use_fast = wavelet in ("haar", "db1") and out_h % 2 == 0 and out_w % 2 == 0
    if impl == "matrix" or (impl == "auto" and not use_fast):
        return _matrix_idwt2d(ll, lh, hl, hh, wavelet, out_h, out_w)
    if not use_fast:
        raise ValueError("fast impl needs haar + even sizes")
    return _haar_idwt2d(ll, lh, hl, hh)


def dwt2d_ll(x, wavelet: str = "haar"):
    """The LL band of dwt2d alone (reference `DWT_2D_tiny`)."""
    h, w = x.shape[-3], x.shape[-2]
    if wavelet in ("haar", "db1") and h % 2 == 0 and w % 2 == 0:
        a, b, c, d = _quads(x)
        return (a + b + c + d) * 0.5
    return dwt2d(x, wavelet)[0]


# ---------------------------------------------------------------------------
# 1-D and 3-D (reference DWT_1D/3D, IDWT_1D/3D). 1-D transforms the
# second-to-last axis of (..., L, C); 3-D transforms (..., D, H, W, C).
# ---------------------------------------------------------------------------


def dwt1d(x, wavelet: str = "haar"):
    lo, hi = (_on(m, x) for m in analysis_matrices(x.shape[-2], wavelet))
    return torch.einsum("pl,...lc->...pc", lo, x), torch.einsum("pl,...lc->...pc", hi, x)


def idwt1d(lo_part, hi_part, wavelet: str = "haar"):
    n = lo_part.shape[-2] + hi_part.shape[-2]
    lo, hi = (_on(m, lo_part) for m in synthesis_matrices(n, wavelet))
    return (torch.einsum("pl,...pc->...lc", lo, lo_part)
            + torch.einsum("pl,...pc->...lc", hi, hi_part))


def dwt3d(x, wavelet: str = "haar"):
    """3-D DWT over (..., D, H, W, C) -> dict of 8 subbands keyed
    'lll'..'hhh' (depth, height, width order)."""

    def split_axis(arr, axis):
        lo, hi = dwt1d(torch.movedim(arr, axis, -2), wavelet)
        return torch.movedim(lo, -2, axis), torch.movedim(hi, -2, axis)

    out = {"": x}
    for axis in (-4, -3, -2):
        nxt = {}
        for key, arr in out.items():
            nxt[key + "l"], nxt[key + "h"] = split_axis(arr, axis)
        out = nxt
    return out


def idwt3d(subbands: dict, wavelet: str = "haar"):
    def merge_axis(lo, hi, axis):
        merged = idwt1d(torch.movedim(lo, axis, -2), torch.movedim(hi, axis, -2), wavelet)
        return torch.movedim(merged, -2, axis)

    out = dict(subbands)
    for pos, axis in ((2, -2), (1, -3), (0, -4)):
        out = {key: merge_axis(out[key + "l"], out[key + "h"], axis)
               for key in {k[:pos] for k in out}}
    return out[""]
