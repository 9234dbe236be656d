"""The continuous "linear" VP schedule of the port's DPM-Solver
(tmdiff_tpu_torch/diffusion/dpm_solver.py) against the JAX package's on the
CPU: the marginals and inverse_lambda at rtol 1e-12 (both float64 numpy),
and the solver on tests/test_dpm_solver.py's toy models (singlestep orders
1-3, multistep, the adaptive solver) against the JAX solver on the same
schedule, at that test's bars (rtol 2e-3, atol 5e-4; adaptive rtol 5e-3,
atol 2e-3), the adaptive step counts equal. The discrete schedule's bits
are held by tests/test_torch_samplers.py's goldens.

JAX's "linear" inverse_lambda returns 2 t where the official
implementation's closed form (the port's) returns t: the port keeps the
inverse that inverts marginal_lambda, and the test pins the factor. The
solver comparisons hand JAX the same inverse (`jax_inverse_fixed`: its own
result halved, an exact operation), so that the grids and intermediate
times agree and everything else is compared."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_samplers import jax_toy, jax_toy_linear, toy, toy_linear
from tmdiff_tpu.diffusion import dpm_solver as jax_dpm
from tmdiff_tpu_torch.diffusion.dpm_solver import (DPMSolver, NoiseScheduleVP, WrappedModel,
                                                   _Schedule32)

torch.set_num_threads(2)

BETAS = [(0.1, 20.0), (0.05, 12.0)]


@pytest.mark.parametrize("beta_0,beta_1", BETAS)
def test_linear_marginals_match_jax(beta_0, beta_1):
    """log alpha, alpha, sigma, lambda over t in [1e-3, 1] and inverse_lambda
    over that lambda range against JAX's "linear" schedule, rtol 1e-12;
    inverse_lambda inverts lambda; the model's time label is t itself."""
    ours = NoiseScheduleVP("linear", continuous_beta_0=beta_0, continuous_beta_1=beta_1)
    ref = jax_dpm.NoiseScheduleVP("linear", continuous_beta_0=beta_0, continuous_beta_1=beta_1)
    assert (ours.total_N, ours.T) == (ref.total_N, ref.T) == (1000, 1.0)
    t = np.linspace(1e-3, 1.0, 997)
    for name in ("marginal_log_mean_coeff", "marginal_alpha", "marginal_std",
                 "marginal_lambda"):
        np.testing.assert_allclose(getattr(ours, name)(t), getattr(ref, name)(t), rtol=1e-12,
                                   err_msg=name)
    lam = ours.marginal_lambda(t)
    np.testing.assert_allclose(ours.inverse_lambda(lam), t, rtol=1e-9)
    # JAX's closed form has a factor 2 more (module doc)
    np.testing.assert_allclose(2.0 * ours.inverse_lambda(lam), ref.inverse_lambda(lam),
                               rtol=1e-12)
    assert ours.model_input_time(0.25) == 0.25


@pytest.fixture
def jax_inverse_fixed(monkeypatch):
    """JAX's "linear" inverse_lambda (numpy and traced) halved: the closed
    form that inverts its marginal_lambda (module doc)."""
    for cls in (jax_dpm.NoiseScheduleVP, jax_dpm._TracedScheduleVP):
        def halved(self, lamb, _inverse=cls.inverse_lambda):
            out = _inverse(self, lamb)
            return out / 2.0 if self.schedule == "linear" else out

        monkeypatch.setattr(cls, "inverse_lambda", halved)


def test_linear_float32_schedule_matches_jax_traced(jax_inverse_fixed):
    """The adaptive solver's float32 schedule on "linear" against JAX's
    traced twin: lambda and inverse_lambda within float32 rounding."""
    ns = NoiseScheduleVP("linear")
    ours, ref = _Schedule32(ns), jax_dpm._TracedScheduleVP(jax_dpm.NoiseScheduleVP("linear"))
    for v in (1e-3, 0.137, 0.5, 0.999):
        t = torch.tensor(v, dtype=torch.float32)
        lam = ours.lam(t)
        np.testing.assert_allclose(lam.item(), float(ref.lam(jnp.float32(v))), rtol=2e-6)
        np.testing.assert_allclose(ours.inverse_lambda(lam).item(),
                                   float(ref.inverse_lambda(jnp.float32(lam.item()))), rtol=2e-6)


def _x_T():
    return np.random.default_rng(5).standard_normal((2, 3, 8, 8)).astype(np.float32)


# (name, model type, algorithm, correcting_x0_fn, sample kwargs)
CASES = [
    ("ss1", "noise", "dpmsolver++", None,
     dict(steps=12, order=1, skip_type="time_uniform", method="singlestep")),
    ("ss2", "noise", "dpmsolver++", None,
     dict(steps=12, order=2, skip_type="logSNR", method="singlestep")),
    ("ss3_eps", "noise", "dpmsolver", None,
     dict(steps=15, order=3, skip_type="logSNR", method="singlestep")),
    ("ms3_thresh", "noise", "dpmsolver++", "dynamic_thresholding",
     dict(steps=20, order=3, skip_type="logSNR", method="multistep", denoise_to_zero=True)),
    ("ms2_x0", "x_start", "dpmsolver++", None,
     dict(steps=8, order=2, skip_type="time_quadratic", method="multistep")),
]


@pytest.mark.parametrize("name,mtype,algo,correct,kwargs", CASES, ids=[c[0] for c in CASES])
def test_linear_solver_matches_jax(jax_inverse_fixed, name, mtype, algo, correct, kwargs):
    """Fixed-grid solvers on the "linear" schedule, the toy model of
    tests/test_dpm_solver.py, against the JAX solver on the
    same schedule and inputs: rtol 2e-3, atol 5e-4."""
    x_T = _x_T()
    ours = DPMSolver(WrappedModel(toy, mtype), NoiseScheduleVP("linear"), algorithm_type=algo,
                     correcting_x0_fn=correct).sample(torch.as_tensor(x_T), **kwargs)
    ref = jax_dpm.DPMSolver(jax_dpm.WrappedModel(jax_toy, model_type=mtype),
                            jax_dpm.NoiseScheduleVP("linear"), algorithm_type=algo,
                            correcting_x0_fn=correct).sample(jnp.asarray(x_T), **kwargs)
    assert torch.isfinite(ours).all()
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=2e-3, atol=5e-4,
                               err_msg=name)


@pytest.mark.parametrize("order", [2, 3])
def test_linear_adaptive_matches_jax(jax_inverse_fixed, order):
    """The adaptive solver on the "linear" schedule (float32 time and step
    size) against JAX's, the linear toy: the same step counts, the result
    within rtol 5e-3, atol 2e-3."""
    x_T = _x_T()
    x, stats = DPMSolver(WrappedModel(toy_linear, "noise"), NoiseScheduleVP("linear"),
                         algorithm_type="dpmsolver", correcting_x0_fn=None).sample_adaptive(
        torch.as_tensor(x_T), order=order, return_stats=True)
    jx, jstats = jax_dpm.DPMSolver(
        jax_dpm.WrappedModel(jax_toy_linear, model_type="noise"),
        jax_dpm.NoiseScheduleVP("linear"), algorithm_type="dpmsolver",
        correcting_x0_fn=None).sample_adaptive(jnp.asarray(x_T), order=order,
                                               return_stats=True)
    assert stats == {k: int(v) for k, v in jstats.items()}
    assert stats["steps_accepted"] > 3
    np.testing.assert_allclose(x.numpy(), np.asarray(jx), rtol=5e-3, atol=2e-3)


def test_unknown_schedule_refused():
    with pytest.raises(NotImplementedError, match="cosine"):
        NoiseScheduleVP("cosine")
    with pytest.raises(ValueError, match="betas"):
        NoiseScheduleVP("discrete")
