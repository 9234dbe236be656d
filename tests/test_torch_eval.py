"""The port's evaluation (tmdiff_tpu_torch/eval: the numpy metric suite,
the metrics on tensors, the validation harness; utils/export.py) against the
JAX package on the same seeded inputs, on the CPU."""
import json
import os

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.io as scio
import torch

from tmdiff_tpu.data.h5 import PanDataset as JaxPanDataset
from tmdiff_tpu.eval import harness as jax_harness
from tmdiff_tpu.eval import metrics as JM
from tmdiff_tpu.eval import metrics_jnp as MJ
from tmdiff_tpu_torch.data.h5 import PanDataset
from tmdiff_tpu_torch.data.synthetic import make_arrays, write_h5
from tmdiff_tpu_torch.eval import harness
from tmdiff_tpu_torch.eval import metrics as M
from tmdiff_tpu_torch.eval import metrics_torch as MT
from tmdiff_tpu_torch.models.clip_text import clip_mode
from tmdiff_tpu_torch.utils.export import save_mat, to_uint8

torch.set_num_threads(2)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")


def _images(bands, seed, size=32):
    """A ground truth scene (H, W, C) and a prediction near it, in [0, 1]."""
    data = make_arrays(1, bands, size, seed=seed)
    gt = np.transpose(data["gt"][0], (1, 2, 0)).astype(np.float64)
    rng = np.random.default_rng(seed + 100)
    pred = np.clip(gt + 0.03 * rng.standard_normal(gt.shape), 0.0, 1.0)
    lms = np.transpose(data["ms"][0], (1, 2, 0)).astype(np.float64)
    pan = data["pan"][0, 0].astype(np.float32)
    return gt, pred, lms, pan


@pytest.mark.parametrize("bands", [4, 8])
def test_numpy_suite_matches_jax(bands):
    """evaluate_rr (Q4 at 4 bands), evaluate_fr and mean_scores to 1e-6
    relative (the same numpy code; the port's Gaussian pyramid in place of
    cv2's)."""
    gt, pred, lms, pan = _images(bands, seed=bands)
    for ours, ref in ((M.evaluate_rr(gt, pred, 1.0), JM.evaluate_rr(gt, pred, 1.0)),
                      (M.evaluate_fr(lms, pan, pred), JM.evaluate_fr(lms, pan, pred))):
        assert ours.keys() == ref.keys()
        for k in ref:
            np.testing.assert_allclose(ours[k], ref[k], rtol=1e-6, atol=1e-12, err_msg=k)
    assert ("q4" in M.evaluate_rr(gt, pred)) == (bands == 4)
    chw = lambda a: np.transpose(a, (2, 0, 1))
    ours = M.mean_scores([chw(gt)] * 2, [chw(pred), chw(gt)], round_to=6)
    assert ours == JM.mean_scores([chw(gt)] * 2, [chw(pred), chw(gt)], round_to=6)


@pytest.mark.parametrize("shape", [(32, 32), (17, 13), (5, 7), (64, 48)])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_pyr_down_matches_cv2(shape, dtype):
    """The port's pyramid step against cv2.pyrDown twice: the same sizes,
    to the input type's rounding (1.2e-7 measured in float32)."""
    img = np.random.default_rng(0).random(shape).astype(dtype)
    ref = cv2.pyrDown(cv2.pyrDown(img))
    got = M._pyr_down(img, 2)
    assert got.shape == ref.shape and got.dtype == ref.dtype
    np.testing.assert_allclose(got, ref, rtol=0, atol=4 * np.finfo(dtype).eps)


def test_metrics_torch_match_the_goldens():
    """The reference's torch twins (tests/golden/metrics_jnp.npz) at
    tests/test_metrics_jnp.py's tolerances."""
    g = np.load(os.path.join(GOLDEN, "metrics_jnp.npz"))
    t = lambda k: torch.as_tensor(g[k])
    np.testing.assert_allclose(MT.sam(t("xt"), t("xp")).item(), g["sam"], rtol=1e-5)
    np.testing.assert_allclose(MT.scc(t("x1"), t("y1")).item(), g["scc"], rtol=1e-4)
    np.testing.assert_allclose(MT.q_index(t("a"), t("b")).item(), g["qindex"], rtol=1e-4)
    np.testing.assert_allclose(MT.d_lambda(t("lms"), t("ps")).item(), g["d_lambda"][0],
                               rtol=1e-3, atol=1e-5)
    np.testing.assert_allclose(MT.d_s(t("lms"), t("pan"), t("lpan"), t("ps")).item(),
                               g["d_s"][0], rtol=1e-3, atol=1e-5)


@pytest.mark.parametrize("bands,size", [(4, 32), (8, 24)])
def test_metrics_torch_match_metrics_jnp(bands, size):
    """Random batches through both packages' twins: to 2e-5 relative (float32
    reductions in another order; 2.4e-6 measured)."""
    rng = np.random.default_rng(bands)
    x = rng.random((3, bands, size, size)).astype(np.float32)
    y = np.clip(x + 0.05 * rng.standard_normal(x.shape), 0, 1).astype(np.float32)
    lms = rng.random((3, bands, size // 4, size // 4)).astype(np.float32)
    pan = rng.random((3, 1, size, size)).astype(np.float32)
    lpan = rng.random((3, 1, size // 4, size // 4)).astype(np.float32)
    t, j = (lambda a: torch.as_tensor(a)), jnp.asarray
    pairs = [
        (MT.sam(t(x), t(y)), MJ.sam(j(x), j(y))),
        (MT.sam_per_image(t(x), t(y)), MJ.sam_per_image(j(x), j(y))),
        (MT.scc(t(x), t(y)), MJ.scc(j(x), j(y))),
        (MT.q_index(t(x[:, 0]), t(y[:, 0])), MJ.q_index(j(x[:, 0]), j(y[:, 0]))),
        (MT.d_lambda(t(lms), t(y)), MJ.d_lambda(j(lms), j(y))),
        (MT.d_s(t(lms), t(pan), t(lpan), t(y)), MJ.d_s(j(lms), j(pan), j(lpan), j(y))),
        (MT.ssim_per_image(t(y), t(x)), MJ.ssim_per_image(j(y), j(x))),
    ]
    for ours, ref in pairs:
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=2e-5, atol=1e-7)
    np.testing.assert_allclose(MT.ssim_per_image(t(x), t(x)).numpy(), 1.0, atol=1e-5)


def test_ssim_and_sam_on_tensors_against_the_numpy_suite():
    """The harness's two scores on a validation-like batch (halfway between
    the upsampled MS and the truth): SAM equals the numpy suite's to 1e-5
    relative, SSIM the host's Gaussian-window SSIM (float64) to 1e-5. The
    numpy suite's uniform-window SSIM is another statistic: 4.1e-3 away
    here, so the JAX harness's 1e-3 between the two does not hold."""
    data = make_arrays(2, 8, 64, seed=5)
    gt = data["gt"].astype(np.float32)
    pred = np.clip(data["lms"] + 0.5 * (data["gt"] - data["lms"]), 0, 1).astype(np.float32)
    ssim_t = MT.ssim_per_image(torch.as_tensor(pred), torch.as_tensor(gt)).numpy()
    sam_t = MT.sam_per_image(torch.as_tensor(gt), torch.as_tensor(pred)).numpy()
    ssim_j = np.asarray(MJ.ssim_per_image(jnp.asarray(pred), jnp.asarray(gt)))
    for b in range(2):
        p, g = np.transpose(pred[b], (1, 2, 0)), np.transpose(gt[b], (1, 2, 0))
        np.testing.assert_allclose(sam_t[b], M.sam(p, g), rtol=1e-5)
        np.testing.assert_allclose(ssim_t[b], M.ssim_gaussian(g, p, 1.0), rtol=1e-5)
        np.testing.assert_allclose(ssim_j[b], M.ssim_gaussian(g, p, 1.0), rtol=1e-5)
        assert abs(ssim_t[b] - M.ssim(p, g, 1.0)) > 1e-3


class _StubSharpener:
    """Both packages' validate() call `sample` and read `device`: the same
    deterministic predictions for the same batch and seed."""

    device = torch.device("cpu")

    def __init__(self):
        self.calls = []

    def sample(self, batch, sensor, method, steps, seed, params):
        self.calls.append((method, steps, seed, params))
        rng = np.random.default_rng(seed)
        noise = 0.02 * rng.standard_normal(np.asarray(batch["MS"]).shape)
        return np.clip(np.asarray(batch["MS"]) + noise, 0, 1).astype(np.float32)


@pytest.mark.parametrize("kwargs", [
    {}, {"device_metrics": False}, {"full_suite": True}, {"max_images": 3, "batch_size": 2},
])
def test_validate_matches_jax(tmp_path, kwargs):
    """RR sets: the same scores (to 1e-5 relative: SSIM and SAM on tensors
    against jnp, or the same numpy suite), the same .mat files and the same
    per-image log lines as the JAX harness."""
    arrays = make_arrays(5, 4, 24, seed=2)
    runs = {}
    for name, fn, ds in (("port", harness.validate, PanDataset(arrays)),
                         ("jax", jax_harness.validate, JaxPanDataset(arrays))):
        out = tmp_path / name
        sharp = _StubSharpener()
        scores = fn(sharp, ds, "QB", result_dir=str(out), method="dpm++", steps=7,
                    log_file=str(out / "log.jsonl"), params={"w": 1}, seed=3,
                    **{"batch_size": 2, **kwargs})
        runs[name] = (scores, out, sharp.calls)
    (ours, out, calls), (ref, ref_out, ref_calls) = runs["port"], runs["jax"]
    assert calls == ref_calls and all(c[3] == {"w": 1} for c in calls)
    assert ours.keys() == ref.keys()
    for k in ref:
        if not k.startswith("sec_per_image"):
            np.testing.assert_allclose(ours[k], ref[k], rtol=1e-5, err_msg=k)
    mats = sorted(os.listdir(ref_out))
    assert sorted(os.listdir(out)) == mats
    n = kwargs.get("max_images", 5)
    assert len([m for m in mats if m.endswith(".mat")]) == n
    for m in (m for m in mats if m.endswith(".mat")):
        a, b = scio.loadmat(str(out / m)), scio.loadmat(str(ref_out / m))
        np.testing.assert_array_equal(a["sr"], b["sr"])
        assert a["sr"].shape == (24, 24, 4) and str(a["clip_mode"][0]) == clip_mode()
    lines = [json.loads(x) for x in (out / "log.jsonl").read_text().splitlines()]
    ref_lines = [json.loads(x) for x in (ref_out / "log.jsonl").read_text().splitlines()]
    assert [x["idx"] for x in lines] == [x["idx"] for x in ref_lines] == list(range(n))
    for x, y in zip(lines, ref_lines):
        assert x.keys() == y.keys()
        np.testing.assert_allclose([x[k] for k in x if k not in ("idx", "sensor")],
                                   [y[k] for k in y if k not in ("idx", "sensor")], rtol=1e-5)


def test_validate_routes_full_resolution_sets(tmp_path):
    """A set without ground truth is scored by the no-reference suite, as in
    the JAX harness, with QNR = (1 - D_lambda)(1 - D_s)."""
    path = write_h5(str(tmp_path / "fr_wv3.h5"), n=1, bands=4, size=32, full_resolution=True)
    ds = PanDataset(path)
    assert not ds.has_reference
    scores = harness.validate(_StubSharpener(), ds, "WV3", result_dir=str(tmp_path / "out"),
                              batch_size=1)
    ref = jax_harness.validate(_StubSharpener(), JaxPanDataset(path), "WV3",
                               result_dir=str(tmp_path / "ref"), batch_size=1)
    for k in ("d_lambda_WV3", "d_s_WV3", "qnr_WV3", "fcc_WV3", "sf_WV3", "sd_WV3"):
        np.testing.assert_allclose(scores[k], ref[k], rtol=1e-6, err_msg=k)
    assert "ssim_WV3" not in scores and "sam_WV3" not in scores
    np.testing.assert_allclose(scores["qnr_WV3"],
                               (1 - scores["d_lambda_WV3"]) * (1 - scores["d_s_WV3"]), rtol=1e-6)


def test_validate_reference_parity_needs_real_clip(tmp_path, monkeypatch):
    monkeypatch.delenv("TMDIFF_ALLOW_FAKE_CLIP", raising=False)
    ds = PanDataset(make_arrays(1, 4, 16))
    with pytest.raises(RuntimeError, match="real CLIP"):
        harness.validate(_StubSharpener(), ds, "QB", reference_parity=True)


def test_export_helpers(tmp_path):
    from tmdiff_tpu.utils import export as jax_export

    img = np.random.default_rng(1).random((16, 12, 4)) * 3.0
    np.testing.assert_array_equal(to_uint8(img), jax_export.to_uint8(img))
    save_mat(str(tmp_path / "a.mat"), img, img_scale=2047.0)
    jax_export.save_mat(str(tmp_path / "b.mat"), img, img_scale=2047.0)
    a, b = scio.loadmat(str(tmp_path / "a.mat")), scio.loadmat(str(tmp_path / "b.mat"))
    np.testing.assert_array_equal(a["sr"], b["sr"])
    assert str(a["clip_mode"][0]) == str(b["clip_mode"][0]) == clip_mode()
