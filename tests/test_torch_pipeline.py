"""The port's dpm++ sampling slice (tmdiff_tpu_torch/pipeline.py and
diffusion/) against the reference golden and the JAX Pansharpener, on the
CPU. x_T is made with numpy and handed to both packages: torch's and JAX's
random streams differ."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tmdiff_tpu.diffusion import dpm_solver as jax_dpm
from tmdiff_tpu.diffusion.schedules import make_beta_schedule as jax_betas
from tmdiff_tpu.models import WavBEST as JaxWavBEST
from tmdiff_tpu.models.clip_text import load_prompt_table as jax_prompt_table
from tmdiff_tpu.pipeline import Pansharpener as JaxPansharpener
from tmdiff_tpu_torch.diffusion import dpm_solver
from tmdiff_tpu_torch.diffusion.schedules import make_beta_schedule
from tmdiff_tpu_torch.models.clip_text import load_prompt_table
from tmdiff_tpu_torch.models.wavbest import WavBEST
from tmdiff_tpu_torch.pipeline import Pansharpener
from tmdiff_tpu_torch.utils.weights import from_flax, from_reference_state_dict

torch.set_num_threads(2)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
CHANNELS = (8, 16, 32, 64)


def _random_flax_params(model, seed=0):
    x = jnp.zeros((1, 4, 16, 16))
    tree = jax.eval_shape(model.init, jax.random.key(0), x, jnp.ones(1), x[:, :1], x,
                          jnp.zeros(768))
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        names = [str(p.key) for p in path]
        if names[-1] == "kernel":
            fan_in = int(np.prod(leaf.shape[:-1]))
            return (rng.standard_normal(leaf.shape) / np.sqrt(fan_in)).astype(np.float32)
        base = 1.0 if "style" in names else 0.0
        return (base + 0.1 * rng.standard_normal(leaf.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, tree)


def test_dpm_golden():
    """Reference weights and x_T reproduce the reference's dpm++ image;
    atol 2e-3, the bar of tests/test_pipeline_golden.py."""
    g = np.load(os.path.join(GOLDEN, "pipeline.npz"))
    sd = {k[3:]: g[k] for k in g.files if k.startswith("sd.")}
    model = from_reference_state_dict(WavBEST(CHANNELS, device="cpu"), sd)
    sharp = Pansharpener(model, device="cpu")
    sharp.prompt_table[sharp.prompt_index["QB"]] = torch.as_tensor(g["prompt"])
    out = sharp.sample({"PAN": g["pan"], "MS": g["ms"]}, sensor="QB", method="dpm++",
                       x_init=g["x_T"])
    np.testing.assert_allclose(out, np.clip(g["y_dpm"], 0.0, 1.0), atol=2e-3)


def test_matches_jax_pansharpener():
    """Same random weights, same numpy x_T, a mixed-sensor batch; atol 2e-3,
    the sampling bar."""
    jmodel = JaxWavBEST(channels=CHANNELS)
    params = _random_flax_params(jmodel, seed=7)
    port = from_flax(WavBEST(CHANNELS, device="cpu"), jax.tree.map(np.asarray, params))
    rng = np.random.default_rng(11)
    ms = rng.uniform(0.1, 0.9, (2, 4, 16, 16)).astype(np.float32)
    batch = {"PAN": ms.mean(1, keepdims=True), "MS": ms}
    x_T = rng.standard_normal(ms.shape).astype(np.float32)
    sensors = ["QB", "GF2"]
    ref = JaxPansharpener(jmodel, params).sample(batch, sensor=sensors, method="dpm++", x_init=x_T)
    out = Pansharpener(port, device="cpu").sample(batch, sensor=sensors, method="dpm++", x_init=x_T)
    assert out.shape == ms.shape and out.min() >= 0.0 and out.max() <= 1.0
    np.testing.assert_allclose(out, np.asarray(ref), atol=2e-3)


def test_solver_pieces_match_jax():
    """Schedule, time grid and order schedule equal the JAX package's numpy
    exactly; the float32 block coefficients equal its scanned table's."""
    betas = make_beta_schedule("cosine", 1000)
    ns, jns = dpm_solver.NoiseScheduleVP("discrete", betas), jax_dpm.NoiseScheduleVP("discrete", betas)
    t = np.linspace(1e-3, 1.0, 37)
    for name in ("marginal_log_mean_coeff", "marginal_alpha", "marginal_std", "marginal_lambda",
                 "model_input_time"):
        np.testing.assert_array_equal(getattr(ns, name)(t), getattr(jns, name)(t), err_msg=name)
    lam = jns.marginal_lambda(t)
    np.testing.assert_array_equal(ns.inverse_lambda(lam), jns.inverse_lambda(lam))
    solver = dpm_solver.DPMSolver(dpm_solver.WrappedModel(None), ns)
    jsolver = jax_dpm.DPMSolver(jax_dpm.WrappedModel(None), jns)
    for steps in range(1, 41):
        for order in (1, 2, 3):
            assert solver._singlestep_orders(steps, order) == jsolver._singlestep_orders(steps, order)
    ts = solver.get_time_steps("logSNR", 1.0, 1e-3, 11)
    np.testing.assert_array_equal(ts, jsolver.get_time_steps("logSNR", 1.0, 1e-3, 11))
    rows = solver.block_coefficients(ts[:10])
    assert len(rows) == 9 and all(v.dtype == np.float32 for r in rows for v in r.values())
    s, t1 = float(ts[0]), float(ts[1])
    lam3 = jns.marginal_lambda(jsolver.get_time_steps("logSNR", s, t1, 3))
    h = lam3[-1] - lam3[0]
    r2 = float((lam3[2] - lam3[0]) / h)
    assert rows[0]["sig_t"] == np.float32(jns.marginal_std(t1))
    assert rows[0]["phi_22"] == np.float32(np.expm1(-r2 * h) / (r2 * h) + 1.0)


@pytest.mark.parametrize("model_type", ["x_start", "noise"])
def test_solver_matches_jax_on_a_linear_model(model_type):
    """The whole 30-step singlestep order-3 run with denoise-to-zero on a
    model linear in x and t, in both packages; atol 1e-5 (fp32 rounding)."""
    betas = make_beta_schedule("cosine", 1000)
    x_T = np.random.default_rng(2).standard_normal((2, 3, 8, 8)).astype(np.float32)
    model = lambda x, t: 0.7 * x + 1e-3 * t.reshape((-1,) + (1,) * (x.ndim - 1))
    jout = jax_dpm.DPMSolver(jax_dpm.WrappedModel(model, model_type),
                             jax_dpm.NoiseScheduleVP("discrete", betas)).sample(
        jnp.asarray(x_T), steps=30, order=3, skip_type="logSNR", method="singlestep",
        denoise_to_zero=True)
    out = dpm_solver.DPMSolver(dpm_solver.WrappedModel(model, model_type),
                               dpm_solver.NoiseScheduleVP("discrete", betas)).sample(
        torch.as_tensor(x_T), steps=30, order=3, skip_type="logSNR", method="singlestep",
        denoise_to_zero=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=1e-5)


def test_dynamic_thresholding_at_full_size(monkeypatch):
    """At batch 2, 8 bands, 256x256 a (B, bands*H*W) quantile stays under
    torch.quantile's 2**24-element limit; above it the port goes row by row.
    Both against numpy's linear quantile; rtol 1e-6."""
    rng = np.random.default_rng(0)
    x0 = (1.5 * rng.standard_normal((2, 8, 256, 256))).astype(np.float32)
    assert x0.size <= dpm_solver._QUANTILE_MAX
    s = np.maximum(np.quantile(np.abs(x0).reshape(2, -1), 0.995, axis=1), 1.0)[:, None, None, None]
    ref = np.clip(x0, -s, s) / s
    np.testing.assert_allclose(dpm_solver.dynamic_thresholding(torch.as_tensor(x0)).numpy(), ref,
                               rtol=1e-6)
    monkeypatch.setattr(dpm_solver, "_QUANTILE_MAX", 1000)
    np.testing.assert_allclose(dpm_solver.dynamic_thresholding(torch.as_tensor(x0)).numpy(), ref,
                               rtol=1e-6)


def test_schedules_and_prompt_table():
    g = np.load(os.path.join(GOLDEN, "schedules.npz"))
    for schedule in ("linear", "cosine"):
        for n in (100, 1000):
            np.testing.assert_allclose(make_beta_schedule(schedule, n), g[f"{schedule}_{n}"], rtol=1e-12)
            np.testing.assert_array_equal(make_beta_schedule(schedule, n), jax_betas(schedule, n))
    table, index, real = load_prompt_table()
    jtable, jindex, jreal = jax_prompt_table()
    np.testing.assert_array_equal(table, jtable)
    assert index == jindex and real == jreal


def test_sampler_api(monkeypatch):
    """x_T comes from the seed; an unknown method raises; no device and no
    GPU raises."""
    model = WavBEST(CHANNELS, device="cpu", seed=1)
    sharp = Pansharpener(model, n_timestep=100, device="cpu")
    rng = np.random.default_rng(5)
    ms = rng.uniform(size=(1, 4, 16, 16)).astype(np.float32)
    batch = {"PAN": ms[:, :1], "MS": ms}
    a = sharp.sample(batch, seed=4, steps=3)
    np.testing.assert_array_equal(a, sharp.sample(batch, seed=4, steps=3))
    assert not np.array_equal(a, sharp.sample(batch, seed=5, steps=3))
    with pytest.raises(ValueError, match="unknown sampler"):
        sharp.sample(batch, method="ancestral")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Pansharpener(model)
