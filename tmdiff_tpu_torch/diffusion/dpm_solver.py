"""DPM-Solver and DPM-Solver++ (port of tmdiff_tpu/diffusion/dpm_solver.py).

The solver subset of the official implementation (`core/dpm_solver_pytorch.py`)
that the reference drives:

  * the discrete VP schedule in continuous time (log alpha piecewise linear
    in t) and the continuous "linear" VP schedule;
  * model types noise / x_start / v / score, unconditional or with
    classifier-free guidance (`model_wrapper`, `:184-348`), the guidance a
    scalar or one scale per sample;
  * algorithm types dpmsolver++ (data prediction) and dpmsolver (noise
    prediction), solver types 'dpmsolver' and 'taylor';
  * singlestep orders 1-3 on the DPM-Solver-fast order schedule
    (`:497-555`), singlestep_fixed, multistep orders 1-3 with
    `lower_order_final` (`:1215-1258`), denoise-to-zero, dynamic
    thresholding (quantile 0.995, `:430-439`);
  * the adaptive step size (`dpm_solver_adaptive:982-1044`), `add_noise`
    (`:1045-1063`) and ODE inversion (`inverse:1065-1079`).

Every time step and coefficient of a fixed grid is float64 numpy on the
host; the device runs only model calls and linear combinations of tensors.
Where the JAX package stacks a uniform run of steps into a scanned float32
table (the order-3 singlestep blocks, the steady multistep steps), the port
rounds the same coefficients to float32 and combines them in float32, in
the same order; the short ramps use Python floats, as its unrolled steps
do, so the two packages agree to rounding. The adaptive solver's time and
step size are float32 scalars, computed as the JAX package's traced
schedule computes them, so that both take the same accept/reject decisions;
its loop runs on the host and reads one scalar (the error norm) back per
iteration.

On a sharded placement (`DPMSolver.mesh`, parallel/mesh.py) each rank holds
its shard of x, and the two reductions over a sample are made over the
ranks that hold it: the thresholding quantile on the sample's values
gathered over its space group, the adaptive error norm as a sum of squares
over the space group, divided by the global count, then the max over the
data group, so every rank takes the same accept/reject decision.
"""
from __future__ import annotations

import dataclasses
import math
import warnings
from typing import Any, Callable, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from tmdiff_tpu_torch.parallel import mesh as mesh_lib


class NoiseScheduleVP:
    """VP schedule in continuous time t in (0, T] (float64 numpy):

      * "discrete" (given the betas): log alpha(t) is the piecewise-linear
        interpolant of 0.5 log(alpha_bar_i) over t_i = (i + 1) / N;
      * "linear": the continuous VP-SDE with beta(t) linear from
        `continuous_beta_0` to `continuous_beta_1`, log alpha(t) =
        -(beta_1 - beta_0) t^2 / 4 - beta_0 t / 2, N = 1000, and the
        model's time label t itself. Its inverse_lambda is the closed form
        of the official implementation, which inverts marginal_lambda; the
        JAX package's has a factor 2 more (it returns 2 t), a deliberate
        divergence."""

    def __init__(self, schedule: str = "discrete", betas: Optional[np.ndarray] = None,
                 continuous_beta_0: float = 0.1, continuous_beta_1: float = 20.0):
        self.schedule = schedule
        self.T = 1.0
        if schedule == "discrete":
            if betas is None:
                raise ValueError('the "discrete" schedule needs its betas')
            betas = np.asarray(betas, dtype=np.float64)
            self.log_alpha_array = 0.5 * np.cumsum(np.log(1.0 - betas))
            self.total_N = len(self.log_alpha_array)
            self.t_array = np.linspace(0.0, 1.0, self.total_N + 1)[1:]
        elif schedule == "linear":
            self.total_N = 1000
            self.beta_0, self.beta_1 = continuous_beta_0, continuous_beta_1
        else:
            raise NotImplementedError(f"unknown VP schedule {schedule!r}")

    def marginal_log_mean_coeff(self, t):
        t = np.asarray(t, dtype=np.float64)
        if self.schedule == "discrete":
            return np.interp(t, self.t_array, self.log_alpha_array)
        return -0.25 * t**2 * (self.beta_1 - self.beta_0) - 0.5 * t * self.beta_0

    def marginal_alpha(self, t):
        return np.exp(self.marginal_log_mean_coeff(t))

    def marginal_std(self, t):
        return np.sqrt(1.0 - np.exp(2.0 * self.marginal_log_mean_coeff(t)))

    def marginal_lambda(self, t):
        log_mean = self.marginal_log_mean_coeff(t)
        return log_mean - 0.5 * np.log(1.0 - np.exp(2.0 * log_mean))

    def inverse_lambda(self, lamb):
        lamb = np.asarray(lamb, dtype=np.float64)
        if self.schedule == "discrete":
            log_alpha = -0.5 * np.logaddexp(0.0, -2.0 * lamb)
            return np.interp(log_alpha, self.log_alpha_array[::-1], self.t_array[::-1])
        tmp = 2.0 * (self.beta_1 - self.beta_0) * np.logaddexp(-2.0 * lamb, 0.0)
        return tmp / (np.sqrt(self.beta_0**2 + tmp) + self.beta_0) / (self.beta_1 - self.beta_0)

    def model_input_time(self, t):
        """Continuous t -> the model's time label (discrete: its step)."""
        if self.schedule == "discrete":
            return (np.asarray(t, dtype=np.float64) - 1.0 / self.total_N) * 1000.0
        return t


def _f32(v) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float32)


def _interp32(x, xp, fp):
    """jnp.interp of one float32 scalar over float32 tables (the adaptive
    solver's schedule lookups, done as the JAX package does them)."""
    i = int(np.clip(np.searchsorted(xp.numpy(), x.item(), side="right"), 1, len(xp) - 1))
    df, dx, delta = fp[i] - fp[i - 1], xp[i] - xp[i - 1], x - xp[i - 1]
    eps = float(np.spacing(np.finfo(np.float32).eps))
    dx0 = bool(dx.abs() <= eps)
    f = fp[i - 1] if dx0 else fp[i - 1] + (delta / dx) * df
    if x < xp[0]:
        return fp[0]
    if x > xp[-1]:
        return fp[-1]
    return f


class _Schedule64:
    """The schedule's scalars as Python floats (float64): the fixed grids'
    time steps and coefficients."""

    expm1 = staticmethod(math.expm1)

    def __init__(self, ns: NoiseScheduleVP):
        self.ns = ns

    @staticmethod
    def item(v) -> float:
        return v

    def lam(self, t):
        return float(self.ns.marginal_lambda(t))

    def alpha(self, t):
        return float(self.ns.marginal_alpha(t))

    def std(self, t):
        return float(self.ns.marginal_std(t))

    def inverse_lambda(self, lamb):
        return float(self.ns.inverse_lambda(lamb))

    def model_input_time(self, t):
        return float(self.ns.model_input_time(t))


class _Schedule32:
    """The schedule in float32 0-d tensors: the counterpart of the JAX
    package's traced schedule for the adaptive solver's runtime time."""

    expm1 = staticmethod(torch.expm1)

    def __init__(self, ns: NoiseScheduleVP):
        self.schedule = ns.schedule
        self.total_N = ns.total_N
        if ns.schedule == "discrete":
            self.t_array = _f32(ns.t_array)
            self.log_alpha_array = _f32(ns.log_alpha_array)
        else:
            self.beta_0, self.beta_1 = ns.beta_0, ns.beta_1

    def log_alpha(self, t):
        if self.schedule == "discrete":
            return _interp32(t, self.t_array, self.log_alpha_array)
        return -0.25 * t**2 * (self.beta_1 - self.beta_0) - 0.5 * t * self.beta_0

    def alpha(self, t):
        return torch.exp(self.log_alpha(t))

    def std(self, t):
        return torch.sqrt(1.0 - torch.exp(2.0 * self.log_alpha(t)))

    def lam(self, t):
        la = self.log_alpha(t)
        return la - 0.5 * torch.log(1.0 - torch.exp(2.0 * la))

    def inverse_lambda(self, lamb):
        if self.schedule == "discrete":
            log_alpha = -0.5 * torch.logaddexp(_f32(0.0), -2.0 * lamb)
            return _interp32(log_alpha, self.log_alpha_array.flip(0), self.t_array.flip(0))
        tmp = 2.0 * (self.beta_1 - self.beta_0) * torch.logaddexp(-2.0 * lamb, _f32(0.0))
        return tmp / (torch.sqrt(self.beta_0**2 + tmp) + self.beta_0) / (self.beta_1 - self.beta_0)

    def model_input_time(self, t):
        if self.schedule == "discrete":
            return (t - 1.0 / self.total_N) * 1000.0
        return t

    @staticmethod
    def item(v) -> float:
        return v.item()


# torch.quantile refuses inputs of more than 2**24 elements.
_QUANTILE_MAX = 2 ** 24


def dynamic_thresholding(x0, ratio: float = 0.995, max_val: float = 1.0, mesh=None):
    """Per-sample quantile clamp (`dpm_solver_pytorch.py:430-439`). On a
    space-sharded placement `mesh` the sample's values are gathered over
    its space group first, so the quantile is the unsharded one."""
    b = x0.shape[0]
    a = x0.abs().reshape(b, -1)
    if mesh is not None and mesh.halo:
        a = torch.cat(mesh_lib.all_gather(a, mesh, mesh.space_group), dim=1)
    if a.numel() <= _QUANTILE_MAX:
        s = torch.quantile(a, ratio, dim=1)
    else:
        s = torch.stack([torch.quantile(row, ratio) for row in a])
    s = s.clamp(min=max_val).reshape((b,) + (1,) * (x0.dim() - 1))
    return torch.clamp(x0, -s, s) / s


def _tree_cat(u, c):
    """Concatenates two conditions along the batch: tensors, or dicts,
    tuples and lists of them (cached condition features)."""
    if isinstance(u, dict):
        return {k: _tree_cat(u[k], c[k]) for k in u}
    if isinstance(u, (tuple, list)):
        return type(u)(_tree_cat(a, b) for a, b in zip(u, c))
    return torch.cat([u, c])


@dataclasses.dataclass
class WrappedModel:
    """Model-type conversion and guidance (`model_wrapper`,
    `dpm_solver_pytorch.py:296-344`): `model(x, t_input)` unconditionally,
    `model(x, t_input, cond)` under classifier-free guidance, where the
    conditions may be tensors or dicts of cached features and
    `guidance_scale` a float or one scale per sample, (B,)."""

    model: Callable
    model_type: str = "x_start"
    guidance_type: str = "uncond"
    guidance_scale: object = 1.0
    condition: object = None
    unconditional_condition: object = None

    def __post_init__(self):
        if self.model_type not in ("noise", "x_start", "v", "score"):
            raise ValueError(f"unknown model_type {self.model_type!r}")
        if self.guidance_type not in ("uncond", "classifier-free"):
            raise ValueError(f"unknown guidance_type {self.guidance_type!r}")

    def _cfg_active(self):
        # a scale of exactly 1 combines to the conditional branch alone
        # (uncond + 1 (cond - uncond) = cond): one call at the batch's size
        if self.guidance_type != "classifier-free" or self.unconditional_condition is None:
            return False
        static = isinstance(self.guidance_scale, (int, float))
        return not (static and self.guidance_scale == 1.0)

    def _raw(self, x, t_input):
        if self.guidance_type == "uncond":
            return self.model(x, t_input)
        return self.model(x, t_input, self.condition)

    def noise(self, x, t_input, alpha_t, sigma_t):
        """The noise prediction; under guidance combined in noise space, as
        the reference combines it, from one call on the doubled batch."""
        if self._cfg_active():
            x2 = torch.cat([x, x])
            t2 = torch.cat([t_input, t_input])
            c2 = _tree_cat(self.unconditional_condition, self.condition)
            out = self.model(x2, t2, c2)
            uncond, cond = self._to_noise(x2, out, alpha_t, sigma_t).chunk(2)
            gs = self.guidance_scale
            if isinstance(gs, torch.Tensor) and gs.dim() > 0:
                gs = gs.reshape((-1,) + (1,) * (x.dim() - 1))
            return uncond + gs * (cond - uncond)
        return self._to_noise(x, self._raw(x, t_input), alpha_t, sigma_t)

    def _to_noise(self, x, out, alpha_t, sigma_t):
        if self.model_type == "noise":
            return out
        if self.model_type == "x_start":
            return (x - alpha_t * out) / sigma_t
        if self.model_type == "v":
            return alpha_t * out + sigma_t * x
        return -sigma_t * out  # score

    def x0(self, x, t_input, alpha_t, sigma_t):
        """The x0 prediction. Direct conversions, except under guidance,
        whose combination is defined in noise space."""
        if self._cfg_active():
            eps = self.noise(x, t_input, alpha_t, sigma_t)
            return (x - sigma_t * eps) / alpha_t
        out = self._raw(x, t_input)
        if self.model_type == "x_start":
            return out
        if self.model_type == "noise":
            return (x - sigma_t * out) / alpha_t
        if self.model_type == "v":
            return alpha_t * x - sigma_t * out
        return (x + sigma_t ** 2 * out) / alpha_t  # score


def wrap_model(model, ns=None, model_type="x_start", guidance_type="uncond",
               guidance_scale=1.0, condition=None, unconditional_condition=None,
               model_kwargs=None):
    """The reference `model_wrapper`'s call shape."""
    if model_kwargs:
        base = model
        model = lambda x, t, *cond: base(x, t, *cond, **model_kwargs)
    return WrappedModel(model=model, model_type=model_type, guidance_type=guidance_type,
                        guidance_scale=guidance_scale, condition=condition,
                        unconditional_condition=unconditional_condition)


def _taylor_d(d1_0, d1_1, r1, r2):
    """The first and second divided differences of the 'taylor' solver type
    at order 3, from the two first-order ones."""
    return (r2 * d1_0 - r1 * d1_1) / (r2 - r1), 2.0 * (d1_1 - d1_0) / (r2 - r1)


@dataclasses.dataclass
class DPMSolver:
    """DPM-Solver over a WrappedModel."""

    wrapped: WrappedModel
    ns: NoiseScheduleVP
    algorithm_type: str = "dpmsolver++"
    correcting_x0_fn: Optional[str] = "dynamic_thresholding"
    thresholding_ratio: float = 0.995
    thresholding_max_val: float = 1.0
    solver_type: str = "dpmsolver"
    # the placement of x on a mesh (parallel/mesh.py), None unsharded
    mesh: Optional[Any] = None

    def _correct_x0(self, x0):
        if self.correcting_x0_fn is None:
            return x0
        if self.correcting_x0_fn == "dynamic_thresholding":
            return dynamic_thresholding(x0, self.thresholding_ratio, self.thresholding_max_val,
                                        self.mesh)
        raise NotImplementedError(self.correcting_x0_fn)

    def _eval_with(self, x, t_input, alpha_t, sigma_t):
        """The corrected x0 prediction under dpmsolver++
        (`data_prediction_fn:447-456`), the noise prediction under dpmsolver."""
        if self.algorithm_type == "dpmsolver++":
            return self._correct_x0(self.wrapped.x0(x, t_input, alpha_t, sigma_t))
        return self.wrapped.noise(x, t_input, alpha_t, sigma_t)

    def _t_input(self, x, tin):
        return torch.full((x.shape[0],), float(tin), dtype=torch.float32, device=x.device)

    def _eval(self, x, t, sch=None):
        sch = sch or self._sch
        c = sch.item
        return self._eval_with(x, self._t_input(x, c(sch.model_input_time(t))),
                               c(sch.alpha(t)), c(sch.std(t)))

    def _x0_pred(self, x, t: float):
        sch = self._sch
        return self._correct_x0(self.wrapped.x0(
            x, self._t_input(x, sch.model_input_time(t)), sch.alpha(t), sch.std(t)))

    @property
    def _sch(self):
        return _Schedule64(self.ns)

    # -- updates ------------------------------------------------------------
    # Each update takes the schedule `sch` whose scalars it combines: the
    # fixed grids' float64 one (the default) or the adaptive solver's
    # float32 one. `sch.item` turns a coefficient into the Python float that
    # multiplies a tensor.

    def _first_update(self, x, s, t, model_s, sch=None):
        """DPM-Solver-1 / DDIM (`dpm_solver_first_update:563-609`)."""
        sch = sch or self._sch
        c = sch.item
        h = sch.lam(t) - sch.lam(s)
        if self.algorithm_type == "dpmsolver++":
            return (c(sch.std(t) / sch.std(s)) * x
                    - c(sch.alpha(t) * sch.expm1(-h)) * model_s)
        return (c(sch.alpha(t) / sch.alpha(s)) * x
                - c(sch.std(t) * sch.expm1(h)) * model_s)

    def _model_at_ratio(self, sch, x, s, t, model_s, r1):
        """The model at s1 = lambda^-1(lambda_s + r1 h), reached from x by
        the first-order step (the intermediate point of orders 2 and 3)."""
        c = sch.item
        lam_s = sch.lam(s)
        h = sch.lam(t) - lam_s
        s1 = sch.inverse_lambda(lam_s + r1 * h)
        if self.algorithm_type == "dpmsolver++":
            x_s1 = (c(sch.std(s1) / sch.std(s)) * x
                    - c(sch.alpha(s1) * sch.expm1(-r1 * h)) * model_s)
        else:
            x_s1 = (c(sch.alpha(s1) / sch.alpha(s)) * x
                    - c(sch.std(s1) * sch.expm1(r1 * h)) * model_s)
        return self._eval(x_s1, s1, sch)

    def _second_update(self, sch, x, s, t, model_s, model_s1, r1, solver_type):
        """Singlestep order 2 from the model at s and at s1 (`:610-690`)."""
        c = sch.item
        h = sch.lam(t) - sch.lam(s)
        d = model_s1 - model_s
        if self.algorithm_type == "dpmsolver++":
            phi_1 = sch.expm1(-h)
            base = c(sch.std(t) / sch.std(s)) * x - c(sch.alpha(t) * phi_1) * model_s
            if solver_type == "dpmsolver":
                return base - c((0.5 / r1) * (sch.alpha(t) * phi_1)) * d
            return base + c((1.0 / r1) * (sch.alpha(t) * (phi_1 / h + 1.0))) * d
        phi_1 = sch.expm1(h)
        base = c(sch.alpha(t) / sch.alpha(s)) * x - c(sch.std(t) * phi_1) * model_s
        if solver_type == "dpmsolver":
            return base - c((0.5 / r1) * (sch.std(t) * phi_1)) * d
        return base - c((1.0 / r1) * (sch.std(t) * (phi_1 / h - 1.0))) * d

    def _third_update(self, sch, x, s, t, model_s, model_s1, r1, r2, solver_type):
        """Singlestep order 3 from the model at s and at s1 (`:691-816`)."""
        c = sch.item
        lam_s = sch.lam(s)
        h = sch.lam(t) - lam_s
        s2 = sch.inverse_lambda(lam_s + r2 * h)
        d1_0 = (1.0 / r1) * (model_s1 - model_s)
        if self.algorithm_type == "dpmsolver++":
            phi_12, phi_1 = sch.expm1(-r2 * h), sch.expm1(-h)
            phi_22 = sch.expm1(-r2 * h) / (r2 * h) + 1.0
            phi_2 = phi_1 / h + 1.0
            phi_3 = phi_2 / h - 0.5
            x_s2 = (c(sch.std(s2) / sch.std(s)) * x - c(sch.alpha(s2) * phi_12) * model_s
                    + c((r2 / r1) * (sch.alpha(s2) * phi_22)) * (model_s1 - model_s))
            model_s2 = self._eval(x_s2, s2, sch)
            base = c(sch.std(t) / sch.std(s)) * x - c(sch.alpha(t) * phi_1) * model_s
            if solver_type == "dpmsolver":
                return base + c((1.0 / r2) * (sch.alpha(t) * phi_2)) * (model_s2 - model_s)
            d1, d2 = _taylor_d(d1_0, (1.0 / r2) * (model_s2 - model_s), r1, r2)
            return base + c(sch.alpha(t) * phi_2) * d1 - c(sch.alpha(t) * phi_3) * d2
        phi_12, phi_1 = sch.expm1(r2 * h), sch.expm1(h)
        phi_22 = sch.expm1(r2 * h) / (r2 * h) - 1.0
        phi_2 = phi_1 / h - 1.0
        phi_3 = phi_2 / h - 0.5
        x_s2 = (c(sch.alpha(s2) / sch.alpha(s)) * x - c(sch.std(s2) * phi_12) * model_s
                - c((r2 / r1) * (sch.std(s2) * phi_22)) * (model_s1 - model_s))
        model_s2 = self._eval(x_s2, s2, sch)
        base = c(sch.alpha(t) / sch.alpha(s)) * x - c(sch.std(t) * phi_1) * model_s
        if solver_type == "dpmsolver":
            return base - c((1.0 / r2) * (sch.std(t) * phi_2)) * (model_s2 - model_s)
        d1, d2 = _taylor_d(d1_0, (1.0 / r2) * (model_s2 - model_s), r1, r2)
        return base - c(sch.std(t) * phi_2) * d1 - c(sch.std(t) * phi_3) * d2

    def _singlestep_update(self, x, s, t, order: int, r1=None, r2=None):
        """Singlestep order-k update with k model evaluations (`:610-816`);
        r1, r2 are the intermediate logSNR ratios."""
        sch = self._sch
        model_s = self._eval(x, s)
        if order == 1:
            return self._first_update(x, s, t, model_s)
        if order == 2:
            r1 = 0.5 if r1 is None else r1
            model_s1 = self._model_at_ratio(sch, x, s, t, model_s, r1)
            return self._second_update(sch, x, s, t, model_s, model_s1, r1, self.solver_type)
        if order != 3:
            raise ValueError(f"order must be 1, 2 or 3, got {order}")
        r1 = 1.0 / 3.0 if r1 is None else r1
        r2 = 2.0 / 3.0 if r2 is None else r2
        model_s1 = self._model_at_ratio(sch, x, s, t, model_s, r1)
        return self._third_update(sch, x, s, t, model_s, model_s1, r1, r2, self.solver_type)

    def _multistep_update(self, x, model_prev: Sequence, t_prev: Sequence, t, order):
        """Multistep order-k update from cached model values (`:817-928`)."""
        if order == 1:
            return self._first_update(x, t_prev[-1], t, model_prev[-1])
        sch = self._sch
        lam = [sch.lam(tp) for tp in t_prev] + [sch.lam(t)]
        t0 = t_prev[-1]
        sig, al = sch.std, sch.alpha
        pp = self.algorithm_type == "dpmsolver++"
        if order == 2:
            h0 = lam[-2] - lam[-3]
            h = lam[-1] - lam[-2]
            d1_0 = (1.0 / (h0 / h)) * (model_prev[-1] - model_prev[-2])
            if pp:
                phi_1 = math.expm1(-h)
                base = (sig(t) / sig(t0)) * x - (al(t) * phi_1) * model_prev[-1]
                if self.solver_type == "dpmsolver":
                    return base - 0.5 * (al(t) * phi_1) * d1_0
                return base + (al(t) * (phi_1 / h + 1.0)) * d1_0
            phi_1 = math.expm1(h)
            base = (al(t) / al(t0)) * x - (sig(t) * phi_1) * model_prev[-1]
            if self.solver_type == "dpmsolver":
                return base - 0.5 * (sig(t) * phi_1) * d1_0
            return base - (sig(t) * (phi_1 / h - 1.0)) * d1_0
        h1 = lam[-3] - lam[-4]
        h0 = lam[-2] - lam[-3]
        h = lam[-1] - lam[-2]
        r0, r1 = h0 / h, h1 / h
        d1_0 = (1.0 / r0) * (model_prev[-1] - model_prev[-2])
        d1_1 = (1.0 / r1) * (model_prev[-2] - model_prev[-3])
        d1 = d1_0 + (r0 / (r0 + r1)) * (d1_0 - d1_1)
        d2 = (1.0 / (r0 + r1)) * (d1_0 - d1_1)
        if pp:
            phi_1 = math.expm1(-h)
            phi_2 = phi_1 / h + 1.0
            phi_3 = phi_2 / h - 0.5
            return ((sig(t) / sig(t0)) * x - (al(t) * phi_1) * model_prev[-1]
                    + (al(t) * phi_2) * d1 - (al(t) * phi_3) * d2)
        phi_1 = math.expm1(h)
        phi_2 = phi_1 / h - 1.0
        phi_3 = phi_2 / h - 0.5
        return ((al(t) / al(t0)) * x - (sig(t) * phi_1) * model_prev[-1]
                - (sig(t) * phi_2) * d1 - (sig(t) * phi_3) * d2)

    # -- time grids ----------------------------------------------------------

    def get_time_steps(self, skip_type, t_T, t_0, n):
        if skip_type == "logSNR":
            lam_T = self.ns.marginal_lambda(t_T)
            lam_0 = self.ns.marginal_lambda(t_0)
            return self.ns.inverse_lambda(np.linspace(lam_T, lam_0, n + 1))
        if skip_type == "time_uniform":
            return np.linspace(t_T, t_0, n + 1)
        if skip_type == "time_quadratic":
            return np.linspace(t_T ** 0.5, t_0 ** 0.5, n + 1) ** 2
        raise ValueError(f"unknown skip_type {skip_type!r}")

    def _singlestep_orders(self, steps, order):
        """DPM-Solver-fast order schedule (`:497-555`)."""
        if order == 3:
            k = steps // 3 + 1
            if steps % 3 == 0:
                return [3] * (k - 2) + [2, 1]
            if steps % 3 == 1:
                return [3] * (k - 1) + [1]
            return [3] * (k - 1) + [2]
        if order == 2:
            if steps % 2 == 0:
                return [2] * (steps // 2)
            return [2] * (steps // 2) + [1]
        return [1] * steps

    # -- sampling loops ------------------------------------------------------

    def sample(self, x, steps: int = 20, order: int = 3, skip_type: str = "time_uniform",
               method: str = "multistep", t_start: Optional[float] = None,
               t_end: Optional[float] = None, lower_order_final: bool = True,
               denoise_to_zero: bool = False):
        t_0 = 1.0 / self.ns.total_N if t_end is None else t_end
        t_T = self.ns.T if t_start is None else t_start
        if method == "multistep":
            x = self._sample_multistep(x, steps, order, skip_type, t_T, t_0, lower_order_final)
        elif method in ("singlestep", "singlestep_fixed"):
            x = self._sample_singlestep(x, steps, order, skip_type, t_T, t_0,
                                        fixed=method == "singlestep_fixed")
        elif method == "adaptive":
            x = self.sample_adaptive(x, order=order, t_start=t_T, t_end=t_0)
        else:
            raise ValueError(f"unknown method {method!r}")
        if denoise_to_zero:
            x = self._x0_pred(x, t_0)
        return x

    def add_noise(self, x, t, noise=None, generator: Optional[torch.Generator] = None):
        """x_t = alpha_t x + sigma_t noise for a batch of times t
        (`dpm_solver_pytorch.py:1045-1063`): (t_size, B, *shape), or
        (B, *shape) for a single time. Noise comes from `generator` unless
        given."""
        t = np.atleast_1d(np.asarray(t, dtype=np.float64))
        alpha = torch.as_tensor(self.ns.marginal_alpha(t), dtype=x.dtype, device=x.device)
        sigma = torch.as_tensor(self.ns.marginal_std(t), dtype=x.dtype, device=x.device)
        if noise is None:
            noise = torch.randn((t.shape[0], *x.shape), generator=generator, dtype=x.dtype,
                                device=x.device)
        expand = (-1,) + (1,) * x.dim()
        xt = alpha.reshape(expand) * x[None] + sigma.reshape(expand) * noise
        return xt[0] if t.shape[0] == 1 else xt

    def inverse(self, x, steps: int = 20, t_start: Optional[float] = None,
                t_end: Optional[float] = None, order: int = 2, skip_type: str = "time_uniform",
                method: str = "multistep", lower_order_final: bool = True,
                denoise_to_zero: bool = False):
        """Integrates the diffusion ODE forward (data -> noise): the same
        solver from t_start = 1/N to t_end = T (`dpm_solver_pytorch.py:1065-1079`);
        the updates hold for either sign of h."""
        t_0 = 1.0 / self.ns.total_N if t_start is None else t_start
        t_T = self.ns.T if t_end is None else t_end
        if not (t_0 > 0 and t_T > 0):
            raise ValueError("inverse needs positive start and end times")
        return self.sample(x, steps=steps, t_start=t_0, t_end=t_T, order=order,
                           skip_type=skip_type, method=method,
                           lower_order_final=lower_order_final, denoise_to_zero=denoise_to_zero)

    def _sample_multistep(self, x, steps, order, skip_type, t_T, t_0, lower_order_final):
        if steps < order:
            raise ValueError(f"multistep order {order} needs at least {order} steps")
        ts = self.get_time_steps(skip_type, t_T, t_0, steps)
        model_prev = [self._eval(x, float(ts[0]))]
        t_prev = [float(ts[0])]
        for step in range(1, order):  # the warm-up ramp at rising orders
            t = float(ts[step])
            x = self._multistep_update(x, model_prev, t_prev, t, step)
            t_prev.append(t)
            model_prev.append(self._eval(x, t))
        use_lower_final = lower_order_final and steps < 10
        if use_lower_final or steps - order < 4:
            # the JAX package unrolls short runs; so does the port
            for step in range(order, steps + 1):
                t = float(ts[step])
                step_order = min(order, steps + 1 - step) if use_lower_final else order
                x = self._multistep_update(x, model_prev[-order:], t_prev[-order:], t,
                                           step_order)
                t_prev.append(t)
                if step < steps:
                    model_prev.append(self._eval(x, t))
            return x
        return self._multistep_steady(x, ts, order, model_prev[-order:], steps)

    def multistep_coefficients(self, ts, order, steps):
        """float32 coefficients of the steady steps order..steps-1, the
        values of the JAX package's scanned table (`_multistep_scan`)."""
        lam = self.ns.marginal_lambda(ts)
        alpha = self.ns.marginal_alpha(ts)
        sigma = self.ns.marginal_std(ts)
        t_inputs = self.ns.model_input_time(ts)
        rows = []
        for step in range(order, steps):
            h = lam[step] - lam[step - 1]
            row = {"h": h, "sig_ratio": sigma[step] / sigma[step - 1],
                   "alpha_ratio": alpha[step] / alpha[step - 1], "alpha_t": alpha[step],
                   "sigma_t": sigma[step], "t_input": t_inputs[step],
                   "r0": (lam[step - 1] - lam[step - 2]) / h}
            if order == 3:
                row["r1"] = (lam[step - 2] - lam[step - 3]) / h
            rows.append({k: np.float32(v) for k, v in row.items()})
        return rows

    def _multistep_steady(self, x, ts, order, ring, steps):
        """The steady multistep steps, every scalar in float32 as the JAX
        package's scan body combines them, then the last update to
        ts[steps] (no model call after it) as an unrolled step."""
        ring = list(ring)
        f = float  # exact: each value is a float32
        pp = self.algorithm_type == "dpmsolver++"
        for c in self.multistep_coefficients(ts, order, steps):
            h = c["h"]
            if pp:
                phi_1 = np.expm1(-h)
                base = f(c["sig_ratio"]) * x - f(c["alpha_t"] * phi_1) * ring[-1]
                factor = c["alpha_t"]
                phi_2 = phi_1 / h + np.float32(1.0)
            else:
                phi_1 = np.expm1(h)
                base = f(c["alpha_ratio"]) * x - f(c["sigma_t"] * phi_1) * ring[-1]
                factor = c["sigma_t"]
                phi_2 = phi_1 / h - np.float32(1.0)
            d1_0 = (ring[-1] - ring[-2]) / f(c["r0"])
            if order == 2:
                if self.solver_type == "dpmsolver":
                    x_new = base + f(np.float32(-0.5) * factor * phi_1) * d1_0
                elif pp:
                    x_new = base + f(factor * (phi_1 / h + np.float32(1.0))) * d1_0
                else:
                    x_new = base + f(-factor * (phi_1 / h - np.float32(1.0))) * d1_0
            else:
                d1_1 = (ring[-2] - ring[-3]) / f(c["r1"])
                rsum = c["r0"] + c["r1"]
                d1 = d1_0 + f(c["r0"] / rsum) * (d1_0 - d1_1)
                d2 = (d1_0 - d1_1) / f(rsum)
                phi_3 = phi_2 / h - np.float32(0.5)
                if pp:
                    x_new = base + f(factor * phi_2) * d1 - f(factor * phi_3) * d2
                else:
                    x_new = base - f(factor * phi_2) * d1 - f(factor * phi_3) * d2
            new_model = self._eval_with(x_new, self._t_input(x_new, c["t_input"]),
                                        f(c["alpha_t"]), f(c["sigma_t"]))
            x, ring = x_new, ring[1:] + [new_model]
        t_prev = [float(t) for t in ts[steps - order: steps]]
        return self._multistep_update(x, ring, t_prev, float(ts[steps]), order)

    def _sample_singlestep(self, x, steps, order, skip_type, t_T, t_0, fixed=False):
        if fixed:
            k = steps // order
            orders = [order] * k
            ts_outer = self.get_time_steps(skip_type, t_T, t_0, k)
        else:
            orders = self._singlestep_orders(steps, order)
            k = len(orders)
            if skip_type == "logSNR":
                ts_outer = self.get_time_steps(skip_type, t_T, t_0, k)
            else:
                full = self.get_time_steps(skip_type, t_T, t_0, steps)
                ts_outer = full[np.cumsum([0] + orders)]
        # the uniform order-3 prefix, as the JAX package's scan runs it
        start = n3 = 0
        while n3 < len(orders) and orders[n3] == 3:
            n3 += 1
        if n3 >= 2 and self.algorithm_type == "dpmsolver++" and self.solver_type == "dpmsolver":
            x = self._singlestep3_blocks(x, ts_outer[: n3 + 1], skip_type)
            start = n3
        for step in range(start, len(orders)):
            step_order = orders[step]
            s, t = float(ts_outer[step]), float(ts_outer[step + 1])
            lam_inner = self.ns.marginal_lambda(self.get_time_steps(skip_type, s, t, step_order))
            h = lam_inner[-1] - lam_inner[0]
            r1 = None if step_order <= 1 else float((lam_inner[1] - lam_inner[0]) / h)
            r2 = None if step_order <= 2 else float((lam_inner[2] - lam_inner[0]) / h)
            x = self._singlestep_update(x, s, t, step_order, r1=r1, r2=r2)
        return x

    def block_coefficients(self, ts_blocks, skip_type="logSNR"):
        """Per-block float32 coefficients of the order-3 blocks, the values
        of the JAX package's scanned table (`_singlestep3_scan`)."""
        ns = self.ns
        rows = []
        for i in range(len(ts_blocks) - 1):
            s, t = float(ts_blocks[i]), float(ts_blocks[i + 1])
            lam = ns.marginal_lambda(self.get_time_steps(skip_type, s, t, 3))
            h = lam[-1] - lam[0]
            r1 = float((lam[1] - lam[0]) / h)
            r2 = float((lam[2] - lam[0]) / h)
            s1 = float(ns.inverse_lambda(lam[0] + r1 * h))
            s2 = float(ns.inverse_lambda(lam[0] + r2 * h))
            row = dict(
                sig_s=ns.marginal_std(s), sig_s1=ns.marginal_std(s1),
                sig_s2=ns.marginal_std(s2), sig_t=ns.marginal_std(t),
                al_s1=ns.marginal_alpha(s1), al_s2=ns.marginal_alpha(s2),
                al_t=ns.marginal_alpha(t), al_s=ns.marginal_alpha(s),
                phi_11=np.expm1(-r1 * h), phi_12=np.expm1(-r2 * h),
                phi_1=np.expm1(-h), phi_22=np.expm1(-r2 * h) / (r2 * h) + 1.0,
                phi_2=np.expm1(-h) / h + 1.0, r2_over_r1=r2 / r1, inv_r2=1.0 / r2,
                tin_s=ns.model_input_time(s), tin_s1=ns.model_input_time(s1),
                tin_s2=ns.model_input_time(s2))
            rows.append({k: np.float32(v) for k, v in row.items()})
        return rows

    def _singlestep3_blocks(self, x, ts_blocks, skip_type):
        """Consecutive singlestep order-3 blocks, three model evaluations each
        (`singlestep_dpm_solver_third_update`, `dpm_solver_pytorch.py:693-816`),
        every scalar combined in float32 as in the JAX scan body."""

        def ev(x_, tin, al, sig):
            return self._eval_with(x_, self._t_input(x_, tin), float(al), float(sig))

        f = float  # exact: each coefficient is a float32 value
        for c in self.block_coefficients(ts_blocks, skip_type):
            m_s = ev(x, c["tin_s"], c["al_s"], c["sig_s"])
            x_s1 = f(c["sig_s1"] / c["sig_s"]) * x - f(c["al_s1"] * c["phi_11"]) * m_s
            m_s1 = ev(x_s1, c["tin_s1"], c["al_s1"], c["sig_s1"])
            x_s2 = (f(c["sig_s2"] / c["sig_s"]) * x - f(c["al_s2"] * c["phi_12"]) * m_s
                    + f(c["r2_over_r1"] * c["al_s2"] * c["phi_22"]) * (m_s1 - m_s))
            m_s2 = ev(x_s2, c["tin_s2"], c["al_s2"], c["sig_s2"])
            x = (f(c["sig_t"] / c["sig_s"]) * x - f(c["al_t"] * c["phi_1"]) * m_s
                 + f(c["inv_r2"] * c["al_t"] * c["phi_2"]) * (m_s2 - m_s))
        return x

    # -- adaptive step size ----------------------------------------------------

    def sample_adaptive(self, x, order: int = 3, t_start: Optional[float] = None,
                        t_end: Optional[float] = None, h_init: float = 0.05,
                        atol: float = 0.0078, rtol: float = 0.05, theta: float = 0.9,
                        t_err: float = 1e-5, max_loops: int = 128, return_stats: bool = False):
        """Adaptive step-size singlestep solver ('dpmsolver' solver type,
        orders 2 and 3, `dpm_solver_adaptive:982-1044`), at most `max_loops`
        iterations: the embedded order-(k-1)/k error estimate, a step
        accepted where the rms of (x_hi - x_lo) / delta is at most 1, and the
        logSNR step h <- min(theta h E^(-1/order), lambda_0 - lambda_s). Time
        and step size are float32. Where the budget runs out before t_end the
        JAX package returns silently; the port returns the same state and
        warns. With `return_stats`, also {"steps_attempted",
        "steps_accepted"} (NFE = attempted x order)."""
        if order not in (2, 3):
            raise ValueError("the adaptive solver has orders 2 and 3")
        t_0 = 1.0 / self.ns.total_N if t_end is None else t_end
        sch = _Schedule32(self.ns)
        t0 = _f32(t_0)
        lambda_0 = sch.lam(t0)
        x_prev, s, h = x, _f32(self.ns.T if t_start is None else t_start), _f32(h_init)
        n = n_acc = 0
        while bool((s - t0).abs() > t_err) and n < max_loops:
            t = sch.inverse_lambda(sch.lam(s) + h)
            model_s = self._eval(x, s, sch)
            if order == 2:
                x_lower = self._first_update(x, s, t, model_s, sch)
                model_s1 = self._model_at_ratio(sch, x, s, t, model_s, 0.5)
                x_higher = self._second_update(sch, x, s, t, model_s, model_s1, 0.5, "dpmsolver")
            else:
                r1, r2 = 1.0 / 3.0, 2.0 / 3.0
                model_s1 = self._model_at_ratio(sch, x, s, t, model_s, r1)
                x_lower = self._second_update(sch, x, s, t, model_s, model_s1, r1, "dpmsolver")
                x_higher = self._third_update(sch, x, s, t, model_s, model_s1, r1, r2,
                                              "dpmsolver")
            delta = torch.clamp(rtol * torch.maximum(x_lower.abs(), x_prev.abs()), min=atol)
            err = self._error_norm(torch.square((x_higher - x_lower) / delta))
            e = _f32(err.item())  # the one scalar read back per iteration
            if bool(e <= 1.0):
                x, x_prev, s = x_higher, x_lower, t
                n_acc += 1
            h = torch.minimum(theta * h * e ** (-1.0 / order), lambda_0 - sch.lam(s))
            n += 1
        if bool((s - t0).abs() > t_err):
            warnings.warn(f"adaptive DPM-Solver stopped at t={s.item():.6g} short of "
                          f"t_end={t_0:.6g}: max_loops={max_loops} iterations spent",
                          RuntimeWarning, stacklevel=2)
        if return_stats:
            return x, {"steps_attempted": n, "steps_accepted": n_acc}
        return x

    def _error_norm(self, sq):
        """max over the batch of the rms over each sample of `sq`'s
        values, over the mesh's shards where x is sharded."""
        b = sq.shape[0]
        mesh = self.mesh
        if mesh is None or not (mesh.halo or mesh.split_batch):
            return torch.sqrt(torch.mean(sq.reshape(b, -1), dim=1)).max()
        ms = sq.reshape(b, -1).sum(dim=1)
        n = sq[0].numel()
        if mesh.halo:
            mesh_lib.all_reduce_(ms, mesh, group=mesh.space_group)
            n *= mesh.space
        err = torch.sqrt(ms / n).max()
        if mesh.split_batch:
            mesh_lib.all_reduce_(err, mesh, op=dist.ReduceOp.MAX, group=mesh.data_group)
        return err

    def sample_adaptive_chunked(self, x, order: int = 3, t_start: Optional[float] = None,
                                t_end: Optional[float] = None, h_init: float = 0.05,
                                atol: float = 0.0078, rtol: float = 0.05, theta: float = 0.9,
                                t_err: float = 1e-5, max_loops: int = 500,
                                segment_loops: int = 50, return_stats: bool = False):
        """`sample_adaptive` with the JAX package's bounded-dispatch
        signature. Its loop already runs on the host, so the segments change
        nothing: this is `sample_adaptive` at this `max_loops`, the same
        result bit for bit."""
        if segment_loops < 1:
            raise ValueError("segment_loops must be at least 1")
        return self.sample_adaptive(x, order, t_start, t_end, h_init, atol, rtol, theta, t_err,
                                    max_loops, return_stats)
