"""The port's data and utility helpers on the CPU, each against the JAX
package's on the same inputs: the 4x4 patch merge / split and the merged
h5 repack (data/h5.py), the wavelet dataset variant (data/pan_wavelet.py),
the DIP utilities (utils/dip.py; optimize against optax), profiling
(utils/profiling.py), the PNG exporter (utils/export.py, its own PNG writer
against cv2's files) and the native host ops (runtime/native.py) bit for bit
against the port's numpy code. Also tests/test_aux.py's and
tests/test_data_config.py's cases on the port."""
import json
import os

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tmdiff_tpu.data import h5 as jax_h5
from tmdiff_tpu.data import pan_wavelet as jax_pan_wavelet
from tmdiff_tpu.data.synthetic import make_arrays, write_h5
from tmdiff_tpu.utils import dip as jax_dip
from tmdiff_tpu.utils import export as jax_export
from tmdiff_tpu_torch.data import h5, pan_wavelet
from tmdiff_tpu_torch.runtime import native
from tmdiff_tpu_torch.utils import dip, export, profiling

torch.set_num_threads(2)


# --- data/h5.py --------------------------------------------------------------


def test_patch_merge_roundtrip(rng):
    imgs = rng.standard_normal((16, 3, 8, 8)).astype(np.float32)
    merged = h5.merge_patches_4x4(imgs)
    assert merged.shape == (3, 32, 32)
    np.testing.assert_array_equal(merged, jax_h5.merge_patches_4x4(imgs))
    np.testing.assert_array_equal(h5.split_patches_4x4(merged), imgs)
    with pytest.raises(ValueError, match="16 patches"):
        h5.merge_patches_4x4(imgs[:15])


def test_repack_h5_merged_matches_jax(tmp_path):
    """17 samples: one merged sample of 4x4 patches, the 17th dropped; the
    same datasets as the JAX package's file."""
    import h5py

    src = write_h5(str(tmp_path / "qb.h5"), n=17, bands=4, size=8)
    h5.repack_h5_merged(src, str(tmp_path / "port.h5"))
    jax_h5.repack_h5_merged(src, str(tmp_path / "jax.h5"))
    with h5py.File(tmp_path / "port.h5") as a, h5py.File(tmp_path / "jax.h5") as b:
        assert sorted(a) == sorted(b) == sorted(h5.KEYS)
        for k in a:
            assert a[k].shape[0] == 1
            np.testing.assert_array_equal(a[k][()], b[k][()])


# --- data/pan_wavelet.py -----------------------------------------------------

WAVELET_SETS = {
    "wavelets": dict(img_scale=1.0),
    "highpass_norm01": dict(img_scale=1.0, norm_range=False, highpass=True, wavelets=False),
    "augment": dict(img_scale=1.0, aug_prob=1.0, seed=0),
    "augment_half": dict(img_scale=1.0, aug_prob=0.5, seed=5, data_len=3),
}


@pytest.mark.parametrize("name", sorted(WAVELET_SETS))
def test_wavelet_dataset_matches_jax(name):
    """Every sample (augmented ones drawn in turn from the same seed) and a
    batch equal the JAX dataset's bit for bit: the same numpy code."""
    arrays = make_arrays(n=4, bands=4, size=16)
    ours = pan_wavelet.WaveletPanDataset(arrays, **WAVELET_SETS[name])
    ref = jax_pan_wavelet.WaveletPanDataset(arrays, **WAVELET_SETS[name])
    assert len(ours) == len(ref) and ours.bands == ref.bands
    for i in range(len(ours)):
        a, b = ours[i], ref[i]
        assert sorted(a) == sorted(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    a, b = ours.batch(np.array([1, 0])), ref.batch(np.array([1, 0]))
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])


def test_wavelet_dataset_cases(rng):
    """tests/test_aux.py's cases: wav channels, ranges, an orthonormal
    level-1 Haar, a zero-mean high pass."""
    s = pan_wavelet.WaveletPanDataset(make_arrays(n=4, bands=4, size=16), img_scale=1.0)[0]
    assert s["wav"].shape == (7, 8, 8)
    assert s["HR"].min() >= -1.0 - 1e-6 and s["HR"].max() <= 1.0 + 1e-6
    x = rng.standard_normal((2, 1, 8, 8)).astype(np.float32)
    ll, (ch, cv, cd) = pan_wavelet._haar_level1(x)
    np.testing.assert_allclose(np.sum(x ** 2), sum(np.sum(z ** 2) for z in (ll, ch, cv, cd)),
                               rtol=1e-5)
    hp = pan_wavelet.WaveletPanDataset(make_arrays(n=2, bands=4, size=16), img_scale=1.0,
                                       norm_range=False, highpass=True, wavelets=False)[0]
    assert "wav" not in hp and abs(float(hp["PAN"].mean())) < 0.2


# --- utils/dip.py ------------------------------------------------------------


def test_dip_noise_and_tv():
    g = torch.Generator().manual_seed(0)
    z = dip.get_noise(g, (1, 8, 8, 3))
    assert z.shape == (1, 8, 8, 3) and 0 <= float(z.min()) and float(z.max()) <= 0.1
    assert dip.get_noise(g, (1, 8, 8, 3), noise_type="n").shape == (1, 8, 8, 3)
    grid = dip.get_noise(g, (2, 8, 6, 3), method="meshgrid")
    ref = jax_dip.get_noise(jax.random.key(0), (2, 8, 6, 3), method="meshgrid")
    np.testing.assert_allclose(grid.numpy(), np.asarray(ref), atol=1e-7)
    assert float(dip.tv_loss(torch.ones(1, 8, 8, 1))) == 0.0
    x = np.random.default_rng(1).random((2, 8, 8, 3)).astype(np.float32)
    np.testing.assert_allclose(float(dip.tv_loss(torch.as_tensor(x))),
                               float(jax_dip.tv_loss(jnp.asarray(x))), rtol=1e-5)
    with pytest.raises(ValueError):
        dip.get_noise(g, (1, 4, 4, 1), method="spiral")


@pytest.mark.parametrize("optimizer", ["adam", "sgd"])
def test_dip_optimize_matches_optax(optimizer):
    """torch.optim's loop against the JAX package's optax loop after 50
    steps: the parameters within 1e-5 of their scale and the last loss
    within 1e-4 relative (torch's Adam forms the moments with lerp and
    divides by sqrt(v) / sqrt(1 - b2^t), optax by sqrt(v / (1 - b2^t)):
    the parameters drift apart by 5.2e-6 of their scale over 50 steps, the
    loss by 2.8e-5 relative; SGD by 0), and the quadratic solved."""
    target = np.linspace(-1.0, 3.0, 6).astype(np.float32)
    params, loss = dip.optimize(lambda p: torch.sum((p - torch.as_tensor(target)) ** 2),
                                torch.zeros(6), num_iter=50, lr=0.05, optimizer=optimizer)
    ref, ref_loss = jax_dip.optimize(lambda p: jnp.sum((p - target) ** 2), jnp.zeros(6),
                                     num_iter=50, lr=0.05, optimizer=optimizer)
    ref = np.asarray(ref)
    np.testing.assert_allclose(params.numpy(), ref, atol=1e-5 * np.abs(ref).max())
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=1e-4)
    solved, _ = dip.optimize(lambda p: torch.sum((p - 3.0) ** 2), torch.zeros(4), num_iter=200,
                             lr=0.1)
    np.testing.assert_allclose(solved.numpy(), 3.0, atol=1e-2)


# --- utils/profiling.py ------------------------------------------------------


def test_cost_analysis_and_params():
    """A 64x64 matmul counts 2 * 64^3 FLOPs (XLA's cost analysis gives as
    many); parameters of a dict and of a module."""
    costs = profiling.cost_analysis(lambda a, b: a @ b, torch.ones(64, 64), torch.ones(64, 64))
    assert costs["flops"] == 2 * 64 ** 3
    assert profiling.param_count({"a": np.ones((3, 4)), "b": [np.ones(5)]}) == 17
    assert profiling.param_count(torch.nn.Linear(3, 4)) == 16


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path / "tr")):
        torch.ones(8, 8) @ torch.ones(8, 8)
    with open(tmp_path / "tr" / "trace.json") as f:
        assert "traceEvents" in json.load(f)


# --- utils/export.py ---------------------------------------------------------


def test_png_export_matches_jax(tmp_path):
    """The port's PNGs decode (cv2) to the pixels of the JAX package's cv2
    files; the same question.jsonl."""
    src = write_h5(str(tmp_path / "x.h5"), n=3, bands=4, size=16)
    assert export.export_h5_to_png(src, str(tmp_path / "port"), max_images=2,
                                   questions="describe") == 2
    assert jax_export.export_h5_to_png(src, str(tmp_path / "jax"), max_images=2,
                                       questions="describe") == 2
    for i in range(2):
        ours = cv2.imread(str(tmp_path / "port" / f"img_{i}.png"), cv2.IMREAD_UNCHANGED)
        ref = cv2.imread(str(tmp_path / "jax" / f"img_{i}.png"), cv2.IMREAD_UNCHANGED)
        assert ours.shape == (16, 16, 3)
        np.testing.assert_array_equal(ours, ref)
    assert not (tmp_path / "port" / "img_2.png").exists()
    assert ((tmp_path / "port" / "question.jsonl").read_text()
            == (tmp_path / "jax" / "question.jsonl").read_text())
    with pytest.raises(ValueError, match="uint8"):
        export.write_png(str(tmp_path / "bad.png"), np.zeros((4, 4, 3), np.float32))


# --- runtime/native.py -------------------------------------------------------


def test_native_matches_numpy_bit_for_bit(rng):
    """The C++ gathers and the count conversion give the bits of the port's
    numpy code (data/h5.py) and of the JAX package's host ops."""
    from tmdiff_tpu.runtime import native as jax_native

    src = rng.random((10, 3, 4, 4)).astype(np.float32)
    lms = rng.random((10, 3, 4, 4)).astype(np.float32)
    idx = np.array([3, 1, 1, 9, 0])
    got = native.gather_scale(src, idx, 2047.0)
    np.testing.assert_array_equal(got, native.gather_scale(src, idx, 2047.0, native=False))
    np.testing.assert_array_equal(got, jax_native.gather_scale(src, idx, 2047.0))
    res = native.gather_residual(src, lms, idx)
    np.testing.assert_array_equal(res, native.gather_residual(src, lms, idx, native=False))
    np.testing.assert_array_equal(res, src[idx] - lms[idx])
    counts = rng.integers(0, 2048, (5, 4, 8, 8)).astype(np.uint16)
    for scale in (2047.0, 1023.0):
        out = native.counts_to_float(counts, scale)
        np.testing.assert_array_equal(out, h5.counts_to_float(counts, scale))
        np.testing.assert_array_equal(out, native.counts_to_float(counts, scale, native=False))
    f32 = counts.astype(np.float32)
    np.testing.assert_array_equal(native.counts_to_float(f32, 2047.0), h5.counts_to_float(f32, 2047.0))


def test_native_refuses(rng, tmp_path, monkeypatch):
    """Out-of-range rows raise; a source g++ cannot build raises, with no
    numpy fallback."""
    src = rng.random((4, 2)).astype(np.float32)
    with pytest.raises(IndexError):
        native.gather_scale(src, np.array([4]))
    bad = tmp_path / "bad.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", str(bad))
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.gather_scale(src, np.array([1]))
