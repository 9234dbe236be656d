"""The port's wavelets (tmdiff_tpu_torch/ops/wavelet.py) on the CPU: every
key of the reference golden dwt.npz (Haar and db2 2-D, Haar 1-D and 3-D) at
tests/test_wavelet.py's tolerances, the generic filter banks and banded
matrices against the JAX package's (same numpy construction, so equal), the
matrix, 1-D and 3-D paths against JAX's on the same inputs within 1e-5, and
the Haar butterflies WavBEST calls unchanged bit for bit."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tmdiff_tpu.ops import wavelet as jax_wavelet
from tmdiff_tpu_torch.ops import wavelet

torch.set_num_threads(2)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
ATOL = 1e-5


@pytest.fixture(scope="module")
def g():
    return np.load(os.path.join(GOLDEN, "dwt.npz"))


def _hwc(x):
    return np.moveaxis(x, 1, -1)


def _t(a):
    return torch.as_tensor(np.array(a, np.float32))


def _randn(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("wav", ["haar", "db2"])
def test_golden_2d(g, wav):
    """haar_* and db2_* keys: the four bands at 1e-4 (the JAX test's bar),
    the reconstruction, and the same bands within 1e-5 of JAX's."""
    x = _hwc(g[f"{wav}_x"])
    bands = wavelet.dwt2d(_t(x), wavelet=wav)
    jbands = jax_wavelet.dwt2d(jnp.asarray(x), wavelet=wav)
    for name, mine, ref in zip(("ll", "lh", "hl", "hh"), bands, jbands):
        np.testing.assert_allclose(mine.numpy(), _hwc(g[f"{wav}_{name}"]), atol=1e-4)
        np.testing.assert_allclose(mine.numpy(), np.asarray(ref), atol=ATOL)
    rec = wavelet.idwt2d(*bands, wavelet=wav)
    np.testing.assert_allclose(rec.numpy(), _hwc(g[f"{wav}_rec"]), atol=1e-4)
    np.testing.assert_allclose(rec.numpy(), np.asarray(jax_wavelet.idwt2d(*jbands, wavelet=wav)),
                               atol=ATOL)


def test_golden_1d(g):
    """haar1d_* keys: the reference transforms the last axis of (N, C, L),
    the port the second-to-last of (N, L, C)."""
    x = np.moveaxis(g["haar1d_x"], 1, -1)
    lo, hi = wavelet.dwt1d(_t(x))
    np.testing.assert_allclose(lo.numpy(), np.moveaxis(g["haar1d_lo"], 1, -1), atol=1e-5)
    np.testing.assert_allclose(hi.numpy(), np.moveaxis(g["haar1d_hi"], 1, -1), atol=1e-5)
    np.testing.assert_allclose(wavelet.idwt1d(lo, hi).numpy(), x, atol=1e-5)


def test_golden_3d(g):
    """haar3d_* keys: the eight subbands and the round trip."""
    x = np.moveaxis(g["haar3d_x"], 1, -1)
    bands = wavelet.dwt3d(_t(x))
    jbands = jax_wavelet.dwt3d(jnp.asarray(x))
    assert sorted(bands) == sorted(jbands)
    for name in ["lll", "llh", "lhl", "lhh", "hll", "hlh", "hhl", "hhh"]:
        np.testing.assert_allclose(bands[name].numpy(), np.moveaxis(g[f"haar3d_{name}"], 1, -1),
                                   atol=1e-5)
        np.testing.assert_allclose(bands[name].numpy(), np.asarray(jbands[name]), atol=ATOL)
    np.testing.assert_allclose(wavelet.idwt3d(bands).numpy(), x, atol=1e-5)


def test_haar_butterflies_unchanged():
    """dwt2d / idwt2d / dwt2d_ll at their defaults are the butterflies
    WavBEST has always called, bit for bit, and agree with JAX's."""
    x = _t(_randn(0, (2, 4, 16, 12, 3)))
    r = x.reshape(2, 4, 8, 2, 6, 2, 3)
    a, b, c, d = r[..., 0, :, 0, :], r[..., 0, :, 1, :], r[..., 1, :, 0, :], r[..., 1, :, 1, :]
    expect = ((a + b + c + d) * 0.5, (a - b + c - d) * 0.5, (a + b - c - d) * 0.5,
              (a - b - c + d) * 0.5)
    bands = wavelet.dwt2d(x)
    for got, ref in zip(bands, expect):
        assert torch.equal(got, ref)
    assert torch.equal(wavelet.dwt2d_ll(x), expect[0])
    rec = wavelet.idwt2d(*bands)
    assert torch.equal(rec, wavelet._haar_idwt2d(*bands))
    np.testing.assert_allclose(rec.numpy(), x.numpy(), atol=1e-6)
    jbands = jax_wavelet.dwt2d(jnp.asarray(x.numpy()))
    for got, ref in zip(bands, jbands):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)
    with pytest.raises(ValueError, match="fast impl"):
        wavelet.dwt2d(x[..., :7, :, :], impl="fast")


def test_daubechies_generation_matches_published():
    np.testing.assert_allclose(wavelet._daubechies_dec_lo(2), wavelet._DB2_LO, atol=1e-10)
    np.testing.assert_allclose(wavelet._daubechies_dec_lo(3), wavelet._DB3_LO, atol=1e-10)


@pytest.mark.parametrize("name", ["haar", "db2", "db3", "db4", "db6", "db8"])
def test_banks_and_matrices_match_jax(name):
    """The same numpy construction: equal banks and analysis / synthesis
    matrices (even and odd sizes); a generated bank is orthogonal."""
    bank, ref = wavelet.get_bank(name), jax_wavelet.get_bank(name)
    for k in ("dec_lo", "dec_hi", "rec_lo", "rec_hi"):
        np.testing.assert_array_equal(bank[k], ref[k])
    lo = bank["dec_lo"]
    assert np.isclose((lo * lo).sum(), 1.0)
    for k in range(1, len(lo) // 2):
        assert abs(np.dot(lo, np.roll(lo, 2 * k))) < 1e-9
    for size in (8, 13, 16):
        for mine, theirs in ((wavelet.analysis_matrices(size, name),
                              jax_wavelet.analysis_matrices(size, name)),
                             (wavelet.synthesis_matrices(size, name),
                              jax_wavelet.synthesis_matrices(size, name))):
            for m, t in zip(mine, theirs):
                np.testing.assert_array_equal(m, t)


@pytest.mark.parametrize("name,shape", [("db2", (2, 16, 12, 3)), ("db3", (1, 20, 20, 2)),
                                        ("db4", (1, 32, 32, 2)), ("haar", (1, 7, 9, 2))])
def test_matrix_path_matches_jax(name, shape):
    """dwt2d and idwt2d through the banded matrices (odd sizes through
    "auto"'s fallback) against JAX's, and the interior of the round trip
    (the reference's truncated matrices lose a (filter / 2 - 1)-wide
    border)."""
    x = _randn(1, shape)
    bands = wavelet.dwt2d(_t(x), wavelet=name, impl="matrix")
    jbands = jax_wavelet.dwt2d(jnp.asarray(x), wavelet=name, impl="matrix")
    for got, ref in zip(bands, jbands):
        assert tuple(got.shape) == ref.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)
    rec = wavelet.idwt2d(*bands, wavelet=name, impl="matrix")
    np.testing.assert_allclose(
        rec.numpy(), np.asarray(jax_wavelet.idwt2d(*jbands, wavelet=name, impl="matrix")),
        atol=ATOL)
    if shape[1] % 2 == 0 and shape[2] % 2 == 0:
        m = len(wavelet.get_bank(name)["dec_lo"]) // 2
        np.testing.assert_allclose(rec.numpy()[:, m:-m, m:-m], x[:, m:-m, m:-m], atol=1e-4)


def test_fast_equals_matrix_and_odd_sizes():
    x = _t(_randn(2, (2, 8, 12, 5)))
    for f, m in zip(wavelet.dwt2d(x, impl="fast"), wavelet.dwt2d(x, impl="matrix")):
        np.testing.assert_allclose(f.numpy(), m.numpy(), atol=1e-6)
    ll, lh, hl, hh = wavelet.dwt2d(_t(_randn(3, (1, 7, 9, 2))))
    assert tuple(ll.shape) == (1, 3, 4, 2) and tuple(hh.shape) == (1, 4, 5, 2)
    np.testing.assert_allclose(wavelet.dwt2d_ll(_t(_randn(3, (1, 7, 9, 2)))).numpy(), ll.numpy())


@pytest.mark.parametrize("name", ["haar", "db2"])
def test_1d_3d_match_jax(name):
    x1 = _randn(4, (2, 16, 3))
    for got, ref in zip(wavelet.dwt1d(_t(x1), name), jax_wavelet.dwt1d(jnp.asarray(x1), name)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)
    x3 = _randn(5, (1, 4, 8, 8, 2))
    bands = wavelet.dwt3d(_t(x3), name)
    jbands = jax_wavelet.dwt3d(jnp.asarray(x3), name)
    for k in bands:
        np.testing.assert_allclose(bands[k].numpy(), np.asarray(jbands[k]), atol=ATOL)
    np.testing.assert_allclose(wavelet.idwt3d(bands, name).numpy(),
                               np.asarray(jax_wavelet.idwt3d(jbands, name)), atol=ATOL)


def test_register_wavelet():
    wavelet.register_wavelet("custom_db2", wavelet._DB2_LO)
    a = wavelet.dwt2d(_t(_randn(6, (1, 16, 16, 1))), "custom_db2")
    b = wavelet.dwt2d(_t(_randn(6, (1, 16, 16, 1))), "db2")
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    with pytest.raises(ValueError, match="even-length"):
        wavelet.register_wavelet("bad", [0.5, 0.5, 0.5])
    with pytest.raises(ValueError, match="sqrt"):
        wavelet.register_wavelet("bad", [0.5, 0.5, 0.5, 0.5])
    with pytest.raises(ValueError, match="unknown wavelet"):
        wavelet.get_bank("sym5x")


def test_linearity_gradient():
    """The transform is orthonormal: the gradient of the bands' sum of
    squares is 2x, on both paths, as jax.grad gives."""
    x = _t(_randn(7, (1, 8, 8, 1))).requires_grad_()
    for impl in ("fast", "matrix"):
        x.grad = None
        sum(b.square().sum() for b in wavelet.dwt2d(x, impl=impl)).backward()
        np.testing.assert_allclose(x.grad.numpy(), 2 * x.detach().numpy(), atol=1e-4)
