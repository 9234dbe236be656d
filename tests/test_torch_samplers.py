"""The port's samplers (tmdiff_tpu_torch/diffusion/dpm_solver.py,
diffusion/gaussian.py, pipeline.py) against the reference goldens and the
JAX package on the CPU: every DPM-Solver golden of tests/golden/dpm_solver.npz
on the toy models of tests/test_dpm_solver.py, each gaussian sampler against
its JAX twin on a toy denoiser, every Pansharpener method against the JAX
Pansharpener on the same weights (from_flax), the legacy ancestral golden,
sample_tiled, and the refusals. x_T, the per-step noise and the regression
sampler's draw are made with numpy (or by JAX's own key) and handed to both
packages: torch's and JAX's random streams differ."""
import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tmdiff_tpu.diffusion import dpm_solver as jax_dpm
from tmdiff_tpu.diffusion import gaussian as jax_gaussian
from tmdiff_tpu.diffusion.schedules import NoiseSchedule as JaxNoiseSchedule
from tmdiff_tpu.models import WavBEST as JaxWavBEST
from tmdiff_tpu.pipeline import Pansharpener as JaxPansharpener
from tmdiff_tpu_torch.diffusion import gaussian
from tmdiff_tpu_torch.diffusion.dpm_solver import (DPMSolver, NoiseScheduleVP, WrappedModel,
                                                   wrap_model)
from tmdiff_tpu_torch.diffusion.schedules import NoiseSchedule
from tmdiff_tpu_torch.models.wavbest import WavBEST
from tmdiff_tpu_torch.pipeline import Pansharpener
from tmdiff_tpu_torch.utils.weights import from_flax, from_reference_state_dict
from flax_params import random_flax_params

torch.set_num_threads(2)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
CHANNELS = (8, 16, 32, 64)
# end-to-end sampling, the bar of tests/test_pipeline_golden.py
SAMPLE_ATOL = 2e-3


def _t(a):
    return torch.as_tensor(np.array(a, np.float32))


# -- DPM-Solver on the toy models ----------------------------------------------


def toy(x, t, *extra):
    t4 = t.reshape(-1, 1, 1, 1).to(torch.float32)
    out = torch.tanh(x) * 0.7 + torch.sin(x * 2.0) * (t4 / 1000.0)
    if extra:
        out = out + 0.1 * extra[0]
    return out


def toy_linear(x, t, *extra):
    t4 = t.reshape(-1, 1, 1, 1).to(torch.float32)
    return 0.3 * x + 0.05 * (t4 / 1000.0) * x


def jax_toy(x, t, *extra):
    t4 = t.reshape(-1, 1, 1, 1).astype(jnp.float32)
    out = jnp.tanh(x) * 0.7 + jnp.sin(x * 2.0) * (t4 / 1000.0)
    if extra:
        out = out + 0.1 * extra[0]
    return out


def jax_toy_linear(x, t, *extra):
    t4 = t.reshape(-1, 1, 1, 1).astype(jnp.float32)
    return 0.3 * x + 0.05 * (t4 / 1000.0) * x


@pytest.fixture(scope="module")
def golden():
    g = np.load(os.path.join(GOLDEN, "dpm_solver.npz"))
    return g, NoiseScheduleVP("discrete", betas=g["betas"]), _t(g["x_T"]), _t(g["cond"])


CASES = [
    ("ms3_noise", "noise", "dpmsolver++", "dynamic_thresholding", None,
     dict(steps=50, order=3, skip_type="logSNR", method="multistep", denoise_to_zero=True)),
    ("ms2_short", "x_start", "dpmsolver++", "dynamic_thresholding", None,
     dict(steps=8, order=2, skip_type="time_uniform", method="multistep")),
    ("ssfix2_eps", "noise", "dpmsolver", None, None,
     dict(steps=10, order=2, skip_type="time_uniform", method="singlestep_fixed")),
    ("ms2_cfg", "noise", "dpmsolver++", "dynamic_thresholding", 3.0,
     dict(steps=50, order=2, skip_type="logSNR", method="multistep")),
]


@pytest.mark.parametrize("name,mtype,algo,correct,guidance,kwargs", CASES,
                         ids=[c[0] for c in CASES])
def test_solver_goldens(golden, name, mtype, algo, correct, guidance, kwargs):
    """The reference solver's outputs at tests/test_dpm_solver.py's bar
    (rtol 2e-3, atol 5e-4)."""
    g, ns, x_T, cond = golden
    net = toy_linear if name == "ssfix2_eps" else toy
    if guidance is not None:
        wrapped = WrappedModel(net, mtype, "classifier-free", guidance, cond, torch.zeros_like(cond))
    else:
        wrapped = WrappedModel(net, mtype)
    x = DPMSolver(wrapped, ns, algorithm_type=algo, correcting_x0_fn=correct).sample(x_T, **kwargs)
    np.testing.assert_allclose(x.numpy(), g[name], rtol=2e-3, atol=5e-4, err_msg=name)


@pytest.mark.parametrize("order", [2, 3])
def test_adaptive_golden(golden, order):
    """The adaptive solver (float32 time and step size) against the
    reference's host loop on the linear toy, at the JAX test's bar (rtol
    5e-3, atol 2e-3), taking as many steps as the JAX package's loop."""
    g, ns, x_T, _ = golden
    solver = DPMSolver(WrappedModel(toy_linear, "noise"), ns, algorithm_type="dpmsolver",
                       correcting_x0_fn=None)
    x, stats = solver.sample_adaptive(x_T, order=order, return_stats=True)
    np.testing.assert_allclose(x.numpy(), g[f"adaptive{order}_eps"], rtol=5e-3, atol=2e-3)
    jsolver = jax_dpm.DPMSolver(
        jax_dpm.WrappedModel(jax_toy_linear, model_type="noise"),
        jax_dpm.NoiseScheduleVP("discrete", betas=g["betas"]), algorithm_type="dpmsolver",
        correcting_x0_fn=None)
    jx, jstats = jsolver.sample_adaptive(jnp.asarray(g["x_T"]), order=order, return_stats=True)
    assert stats == {k: int(v) for k, v in jstats.items()}
    np.testing.assert_allclose(x.numpy(), np.asarray(jx), rtol=1e-4, atol=1e-5)


def test_adaptive_chunked_is_bitwise(golden):
    """Segments of three iterations give the single run's result and counts
    bit for bit; a budget that runs out warns (the JAX package returns
    silently there) and returns the state reached."""
    g, ns, x_T, _ = golden
    solver = DPMSolver(WrappedModel(toy_linear, "noise"), ns, algorithm_type="dpmsolver",
                       correcting_x0_fn=None)
    x_one, st_one = solver.sample_adaptive(x_T, order=2, max_loops=500, return_stats=True)
    x_chunk, st_chunk = solver.sample_adaptive_chunked(x_T, order=2, max_loops=500,
                                                       segment_loops=3, return_stats=True)
    assert st_one == st_chunk and st_one["steps_attempted"] > 3
    assert torch.equal(x_one, x_chunk)
    with pytest.warns(RuntimeWarning, match="max_loops=4"):
        x4, st4 = solver.sample_adaptive(x_T, order=2, max_loops=4, return_stats=True)
    assert st4["steps_attempted"] == 4
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        solver.sample_adaptive(x_T, order=2, max_loops=500)


def test_inverse_and_add_noise_goldens(golden):
    g, ns, x_T, _ = golden
    solver = DPMSolver(WrappedModel(toy_linear, "noise"), ns, correcting_x0_fn=None)
    x = solver.inverse(_t(g["inverse_input"]), steps=8, order=2, skip_type="time_uniform",
                       method="multistep")
    np.testing.assert_allclose(x.numpy(), g["inverse_ms2"], rtol=2e-3, atol=5e-4)
    xt = solver.add_noise(x_T, g["add_noise_t"], noise=_t(g["add_noise_eps"]))
    np.testing.assert_allclose(xt.numpy(), g["add_noise_xt"], atol=1e-5)
    one = solver.add_noise(x_T, [0.5], noise=_t(g["add_noise_eps"][1:2]))
    np.testing.assert_allclose(one.numpy(), g["add_noise_xt"][1], atol=1e-5)


SOLVER_VARIANTS = [
    ("ms3_taylor_pp", "x_start", "dpmsolver++", "taylor", "multistep", 3, "logSNR"),
    ("ms2_eps", "noise", "dpmsolver", "dpmsolver", "multistep", 2, "time_quadratic"),
    ("ms3_eps_taylor", "v", "dpmsolver", "taylor", "multistep", 3, "time_uniform"),
    ("ss3_eps", "score", "dpmsolver", "dpmsolver", "singlestep", 3, "logSNR"),
    ("ss3_taylor_pp", "noise", "dpmsolver++", "taylor", "singlestep", 3, "time_uniform"),
    ("ss2_pp", "x_start", "dpmsolver++", "dpmsolver", "singlestep", 2, "time_quadratic"),
]


@pytest.mark.parametrize("name,mtype,algo,solver_type,method,order,skip", SOLVER_VARIANTS,
                         ids=[c[0] for c in SOLVER_VARIANTS])
def test_solver_variants_match_jax(golden, name, mtype, algo, solver_type, method, order, skip):
    """Model types, algorithm and solver types and skip types the goldens
    leave out, 16 steps (the steady multistep table included), against the
    JAX solver on the same toy (the linear one under noise prediction, where
    the other diverges as the goldens' note says); rtol 1e-4, atol 1e-5
    (float32 rounding)."""
    g, ns, x_T, _ = golden
    kw = dict(steps=16, order=order, skip_type=skip, method=method, t_end=1e-3)
    net, jnet = (toy, jax_toy) if algo == "dpmsolver++" else (toy_linear, jax_toy_linear)
    x = DPMSolver(WrappedModel(net, mtype), ns, algorithm_type=algo, correcting_x0_fn=None,
                  solver_type=solver_type).sample(x_T, **kw)
    jx = jax_dpm.DPMSolver(jax_dpm.WrappedModel(jnet, mtype),
                           jax_dpm.NoiseScheduleVP("discrete", betas=g["betas"]),
                           algorithm_type=algo, correcting_x0_fn=None,
                           solver_type=solver_type).sample(jnp.asarray(g["x_T"]), **kw)
    np.testing.assert_allclose(x.numpy(), np.asarray(jx), rtol=1e-4, atol=1e-5, err_msg=name)


def test_cfg_per_sample_guidance_and_dict_conditions(golden):
    """A (B,) guidance scales each sample as its scalar run does; conditions
    given as dicts of tensors are concatenated leaf by leaf; a scale of 1
    makes one call at the batch's size."""
    g, ns, x_T, cond = golden
    x_T, cond = torch.cat([x_T, -0.5 * x_T]), torch.cat([cond, 0.5 * cond])  # two samples
    calls = []

    def net(x, t, c):
        calls.append(x.shape[0])
        return toy(x, t, c["feat"][0])

    def wrapped(scale, uncond=True):
        return WrappedModel(net, "noise", "classifier-free", scale, {"feat": (cond,)},
                            {"feat": (torch.zeros_like(cond),)} if uncond else None)

    kw = dict(steps=12, order=2, skip_type="logSNR", method="multistep")
    scales = torch.tensor([3.0, 1.5])
    both = DPMSolver(wrapped(scales), ns).sample(x_T, **kw)
    for i in (0, 1):
        one = DPMSolver(wrapped(float(scales[i])), ns).sample(x_T, **kw)
        np.testing.assert_allclose(both[i].numpy(), one[i].numpy(), rtol=1e-6, atol=1e-6)
    calls.clear()
    t = torch.full((x_T.shape[0],), 500.0)
    a = wrapped(1.0).noise(x_T, t, 0.5, 0.8)
    b = wrapped(3.0, uncond=False).noise(x_T, t, 0.5, 0.8)
    assert torch.allclose(a, b, atol=1e-6) and calls == [x_T.shape[0]] * 2
    # wrap_model: the reference model_wrapper's call shape, model_kwargs passed on
    w = wrap_model(lambda x, t, c, scale: scale * toy(x, t, c), model_type="noise",
                   guidance_type="classifier-free", guidance_scale=2.0, condition=cond,
                   unconditional_condition=torch.zeros_like(cond), model_kwargs={"scale": 0.5})
    want = WrappedModel(lambda x, t, c: 0.5 * toy(x, t, c), "noise", "classifier-free", 2.0, cond,
                        torch.zeros_like(cond))
    assert torch.equal(w.x0(x_T, t, 0.5, 0.8), want.x0(x_T, t, 0.5, 0.8))


# -- gaussian samplers against their JAX twins ---------------------------------


def _toy_denoise(x, t, pan, ms):
    return torch.tanh(x) * 0.7 + 0.1 * ms + torch.sin(x) * (t.reshape(-1, 1, 1, 1) / 1000.0)


def _jax_toy_denoise(x, t, pan, ms):
    return jnp.tanh(x) * 0.7 + 0.1 * ms + jnp.sin(x) * (t.reshape(-1, 1, 1, 1) / 1000.0)


@pytest.mark.parametrize("legacy", [False, True])
def test_ancestral_matches_jax(legacy):
    """T = 40, x_T and every step's noise injected, 8 frames; atol 1e-5."""
    T, shape = 40, (2, 3, 8, 8)
    rng = np.random.default_rng(1)
    ms = rng.uniform(size=shape).astype(np.float32)
    x_T = rng.standard_normal(shape).astype(np.float32)
    noise = rng.standard_normal((T, *shape)).astype(np.float32)
    kw = dict(legacy_noise_inversion=legacy, num_frames=8)
    out, frames = gaussian.ancestral_sample(
        _toy_denoise, NoiseSchedule.create("cosine", T), None, None, _t(ms), shape,
        x_init=_t(x_T), step_noise=_t(noise), **kw)
    jout, jframes = jax_gaussian.ancestral_sample(
        _jax_toy_denoise, JaxNoiseSchedule.create("cosine", T), jax.random.key(0), None,
        jnp.asarray(ms), shape, x_init=jnp.asarray(x_T), step_noise=jnp.asarray(noise), **kw)
    assert frames.shape == jframes.shape == (8, *shape)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=1e-5)
    np.testing.assert_allclose(frames.numpy(), np.asarray(jframes), atol=1e-5)


def test_ddim_regression_cfg_match_jax():
    """ddim at 7 steps, the regression shortcut and the cfg_denoise
    combinator on the toy denoiser against JAX; atol 1e-5."""
    shape = (2, 3, 8, 8)
    rng = np.random.default_rng(2)
    ms = rng.uniform(size=shape).astype(np.float32)
    pan = ms.mean(1, keepdims=True)
    x_T = rng.standard_normal(shape).astype(np.float32)
    out = gaussian.ddim_sample(_toy_denoise, NoiseSchedule.create("cosine", 1000), None, None,
                               _t(ms), shape, steps=7, x_init=_t(x_T))
    jout = jax_gaussian.ddim_sample(_jax_toy_denoise, JaxNoiseSchedule.create("cosine", 1000),
                                    None, None, jnp.asarray(ms), shape, steps=7,
                                    x_init=jnp.asarray(x_T))
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=1e-5)
    key = jax.random.key(4)
    jreg = jax_gaussian.regression_sample(_jax_toy_denoise, key, None, jnp.asarray(ms), shape)
    reg = gaussian.regression_sample(_toy_denoise, None, None, _t(ms), shape,
                                     x_init=_t(jax.random.normal(key, shape)))
    np.testing.assert_allclose(reg.numpy(), np.asarray(jreg), atol=1e-5)
    t = torch.tensor([10, 900])
    cfg = gaussian.cfg_denoise(_toy_denoise, 2.5)(_t(x_T), t, _t(pan), _t(ms))
    jcfg = jax_gaussian.cfg_denoise(_jax_toy_denoise, 2.5)(
        jnp.asarray(x_T), jnp.asarray(t.numpy()), jnp.asarray(pan), jnp.asarray(ms))
    np.testing.assert_allclose(cfg.numpy(), np.asarray(jcfg), atol=1e-5)
    with pytest.raises(ValueError, match="grid degenerates"):
        gaussian.ddim_sample(_toy_denoise, NoiseSchedule.create("cosine", 10), None, None,
                             _t(ms), shape, steps=11)


def test_schedule_tables_match_jax():
    ours, ref = NoiseSchedule.create("cosine", 100), JaxNoiseSchedule.create("cosine", 100)
    for name in ("sqrt_alphas_cumprod_prev", "sqrt_recip_alphas_cumprod",
                 "sqrt_recipm1_alphas_cumprod", "posterior_log_variance_clipped",
                 "posterior_mean_coef1", "posterior_mean_coef2"):
        np.testing.assert_array_equal(getattr(ours, name).numpy(), np.asarray(getattr(ref, name)),
                                      err_msg=name)


# -- the Pansharpener's methods against the JAX Pansharpener -------------------


@pytest.fixture(scope="module")
def carried():
    jmodel = JaxWavBEST(channels=CHANNELS)
    params = random_flax_params(jmodel, seed=7)
    port = from_flax(WavBEST(CHANNELS, device="cpu"), jax.tree.map(np.asarray, params))
    return jmodel, params, port


def _request(bands, seed, b=2, size=16):
    rng = np.random.default_rng(seed)
    ms = rng.uniform(0.1, 0.9, (b, bands, size, size)).astype(np.float32)
    pan = (ms.mean(1, keepdims=True) + 0.05 * rng.standard_normal((b, 1, size, size)))
    return {"PAN": pan.astype(np.float32), "MS": ms}, rng.standard_normal(ms.shape).astype(np.float32)


METHOD_CASES = [
    ("dpm++_noise", 8, "WV3", dict(steps=12)),
    ("dpm++_cfg", 4, ["QB", "GF2"], dict(steps=10, guidance=np.array([3.0, 1.5], np.float32))),
    ("dpm++_cfg", 8, "WV3", dict(steps=10, guidance=2.0)),
    ("regression", 8, ["WV3", "WV3"], {}),
    ("ddim", 4, ["QB", "GF2"], dict(steps=5)),
]


@pytest.mark.parametrize("method,bands,sensor,kw", METHOD_CASES,
                         ids=[f"{c[0]}-{c[1]}band-{i}" for i, c in enumerate(METHOD_CASES)])
def test_methods_match_jax(carried, method, bands, sensor, kw):
    """Same weights, same x_T (for regression, JAX's own draw for the seed),
    4 and 8 bands, mixed sensors, a scalar and a (B,) guidance; atol 2e-3,
    the sampling bar."""
    jmodel, params, port = carried
    batch, x_T = _request(bands, seed=bands + len(method))
    if method == "regression":  # JAX draws x_T from the seed's key whatever x_init says
        x_T = np.array(jax.random.normal(jax.random.fold_in(jax.random.key(0), 3),
                                         batch["MS"].shape))
    ref = JaxPansharpener(jmodel, params).sample(batch, sensor=sensor, method=method, seed=3,
                                                 x_init=x_T, **kw)
    out = Pansharpener(port, device="cpu").sample(batch, sensor=sensor, method=method, seed=3,
                                                  x_init=x_T, **kw)
    assert out.shape == batch["MS"].shape and out.min() >= 0.0 and out.max() <= 1.0
    np.testing.assert_allclose(out, np.asarray(ref), atol=SAMPLE_ATOL)


def test_ancestral_method_matches_jax(carried):
    """The ancestral method (x0 semantics, T = 20, x_T and step noise
    injected) with 4 frames, final image and frames; atol 2e-3."""
    jmodel, params, port = carried
    batch, x_T = _request(4, seed=21)
    noise = np.random.default_rng(22).standard_normal((20, *x_T.shape)).astype(np.float32)
    kw = dict(sensor="QB", method="ancestral", num_frames=4, x_init=x_T, step_noise=noise)
    ref, ref_frames = JaxPansharpener(jmodel, params, n_timestep=20).sample(batch, **kw)
    out, frames = Pansharpener(port, n_timestep=20, device="cpu").sample(batch, **kw)
    assert frames.shape == (4, *x_T.shape)
    np.testing.assert_allclose(out, np.asarray(ref), atol=SAMPLE_ATOL)
    np.testing.assert_allclose(frames, np.asarray(ref_frames), atol=SAMPLE_ATOL)


def test_ancestral_legacy_golden():
    """The reference's legacy ancestral loop (T = 100, its recorded per-step
    noise) from pipeline.npz; atol 2e-3, tests/test_pipeline_golden.py's bar."""
    g = np.load(os.path.join(GOLDEN, "pipeline.npz"))
    sd = {k[3:]: g[k] for k in g.files if k.startswith("sd.")}
    model = from_reference_state_dict(WavBEST(CHANNELS, device="cpu"), sd)
    sharp = Pansharpener(model, n_timestep=int(g["T_anc"]), device="cpu")
    sharp.prompt_table[sharp.prompt_index["QB"]] = torch.as_tensor(g["prompt"])
    out = sharp.sample({"PAN": g["pan"], "MS": g["ms"]}, sensor="QB", method="ancestral",
                       legacy_noise_inversion=True, x_init=g["x_T"], step_noise=g["step_noise"])
    np.testing.assert_allclose(out, np.clip(g["y_anc"][None], 0.0, 1.0), atol=SAMPLE_ATOL)


def test_sample_tiled_matches_jax(carried):
    """A 40x24 scene in 16x16 tiles (overlap 4, 4 crops a call, the last call
    padded) and a 40x12 one (edge-padded to a tile's width), ddim at 3 steps
    with one x_T for every call, and a (B,) guidance through dpm++_cfg;
    atol 2e-3."""
    jmodel, params, port = carried
    jsharp, sharp = JaxPansharpener(jmodel, params), Pansharpener(port, device="cpu")
    x_T = np.random.default_rng(30).standard_normal((8, 4, 16, 16)).astype(np.float32)
    # 6 crops in calls of 4 (the second padded), then 3 crops in one call
    for h, w, n in ((40, 24, 8), (40, 12, 6)):
        batch, _ = _request(4, seed=h + w, size=max(h, w))
        batch = {k: v[..., :h, :w] for k, v in batch.items()}
        x_T = x_T[:n]
        kw = dict(sensor="QB", tile=16, overlap=4, tile_batch=4, method="ddim", steps=3,
                  x_init=x_T, seed=9)
        out = sharp.sample_tiled(batch, **kw)
        assert out.shape == (2, 4, h, w)
        np.testing.assert_allclose(out, np.asarray(jsharp.sample_tiled(batch, **kw)),
                                   atol=SAMPLE_ATOL)
    kw = dict(sensor=["QB", "GF2"], tile=16, overlap=4, tile_batch=4, method="dpm++_cfg",
              steps=4, guidance=np.array([2.0, 0.5], np.float32), x_init=x_T)
    np.testing.assert_allclose(sharp.sample_tiled(batch, **kw),
                               np.asarray(jsharp.sample_tiled(batch, **kw)), atol=SAMPLE_ATOL)
    with pytest.raises(ValueError, match="per-sample guidance has 3 entries"):
        sharp.sample_tiled(batch, **{**kw, "guidance": np.ones(3)})


@pytest.mark.parametrize("kw,message", [
    (dict(refresh_mask=[True, False]), "length steps"),
    (dict(refresh_mask=[False, True, True, True]), r"refresh_mask\[0\]"),
    (dict(refresh_mask=[True] * 4, forecast=True), "forecast"),
    (dict(refresh_every=3), "divisible by refresh_every"),
    (dict(cache_level=4), "cache_level"),
], ids=["mask_length", "mask_first", "forecast_mask", "steps_refresh", "cache_level"])
def test_refusals_match_jax(carried, kw, message):
    """ddim_cached's argument checks raise as the JAX facade's do."""
    jmodel, params, port = carried
    batch, _ = _request(4, seed=40)
    args = dict(sensor="QB", method="ddim_cached", steps=4, **kw)
    with pytest.raises(ValueError, match=message):
        JaxPansharpener(jmodel, params).sample(batch, **args)
    with pytest.raises(ValueError, match=message):
        Pansharpener(port, device="cpu").sample(batch, **args)


def test_seeded_draws_and_unknown_method(carried):
    """Without x_init every method draws from the seed's generator: the same
    seed the same image, another seed another; an unknown method raises."""
    _, _, port = carried
    sharp = Pansharpener(port, n_timestep=20, device="cpu")
    batch, _ = _request(4, seed=50)
    for method in ("ancestral", "regression", "ddim", "dpm++_noise"):
        a = sharp.sample(batch, method=method, seed=1, steps=4 if method != "ancestral" else None)
        b = sharp.sample(batch, method=method, seed=1, steps=4 if method != "ancestral" else None)
        c = sharp.sample(batch, method=method, seed=2, steps=4 if method != "ancestral" else None)
        assert np.array_equal(a, b) and not np.array_equal(a, c), method
    with pytest.raises(ValueError, match="unknown sampler"):
        sharp.sample(batch, method="euler")


def test_minimal_slice_runs(monkeypatch, capsys):
    """python -m tmdiff_tpu_torch.minimal_slice on the CPU, the model cut to
    widths (4, 8, 8, 16): finite scores and an image in [0, 1]."""
    from tmdiff_tpu_torch import minimal_slice

    monkeypatch.setattr(minimal_slice, "WavBEST",
                        lambda channels, **kw: WavBEST((4, 8, 8, 16), **kw))
    scores = minimal_slice.main(["--device", "cpu"])
    assert {"sam", "ergas", "ssim"} <= set(scores) and np.isfinite(list(scores.values())).all()
    assert "pred range:" in capsys.readouterr().out
