"""DPM-Solver++ singlestep sampling (port of the part of
tmdiff_tpu/diffusion/dpm_solver.py that the `dpm++` sampler runs).

The reference drives the official implementation
(`core/dpm_solver_pytorch.py`) with a discrete VP schedule, an x_start (or
noise) model, data prediction (dpmsolver++) with the 'dpmsolver' solver type,
singlestep orders 1-3 on the DPM-Solver-fast order schedule, logSNR time
steps, dynamic thresholding (quantile 0.995) and denoise-to-zero.

Every time step and coefficient is float64 numpy on the host; the device runs
only model calls and linear combinations of tensors. The uniform order-3
prefix uses coefficients rounded to float32 and combined in float32, as the
JAX package's scanned table is; the short tail uses Python floats, as its
unrolled steps do, so the two packages agree to rounding.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import numpy as np
import torch


class NoiseScheduleVP:
    """Discrete VP schedule: log alpha(t) is the piecewise-linear interpolant
    of 0.5 log(alpha_bar_i) over t_i = (i + 1) / N (float64 numpy)."""

    def __init__(self, schedule: str = "discrete", betas: Optional[np.ndarray] = None):
        if schedule != "discrete" or betas is None:
            raise NotImplementedError("the port has the discrete schedule, given its betas")
        betas = np.asarray(betas, dtype=np.float64)
        self.log_alpha_array = 0.5 * np.cumsum(np.log(1.0 - betas))
        self.total_N = len(self.log_alpha_array)
        self.T = 1.0
        self.t_array = np.linspace(0.0, 1.0, self.total_N + 1)[1:]

    def marginal_log_mean_coeff(self, t):
        return np.interp(np.asarray(t, dtype=np.float64), self.t_array, self.log_alpha_array)

    def marginal_alpha(self, t):
        return np.exp(self.marginal_log_mean_coeff(t))

    def marginal_std(self, t):
        return np.sqrt(1.0 - np.exp(2.0 * self.marginal_log_mean_coeff(t)))

    def marginal_lambda(self, t):
        log_mean = self.marginal_log_mean_coeff(t)
        return log_mean - 0.5 * np.log(1.0 - np.exp(2.0 * log_mean))

    def inverse_lambda(self, lamb):
        log_alpha = -0.5 * np.logaddexp(0.0, -2.0 * np.asarray(lamb, dtype=np.float64))
        return np.interp(log_alpha, self.log_alpha_array[::-1], self.t_array[::-1])

    def model_input_time(self, t):
        """Continuous t -> the model's discrete time label."""
        return (np.asarray(t, dtype=np.float64) - 1.0 / self.total_N) * 1000.0


# torch.quantile refuses inputs of more than 2**24 elements.
_QUANTILE_MAX = 2 ** 24


def dynamic_thresholding(x0, ratio: float = 0.995, max_val: float = 1.0):
    """Per-sample quantile clamp (`dpm_solver_pytorch.py:430-439`)."""
    b = x0.shape[0]
    a = x0.abs().reshape(b, -1)
    if a.numel() <= _QUANTILE_MAX:
        s = torch.quantile(a, ratio, dim=1)
    else:
        s = torch.stack([torch.quantile(row, ratio) for row in a])
    s = s.clamp(min=max_val).reshape((b,) + (1,) * (x0.dim() - 1))
    return torch.clamp(x0, -s, s) / s


@dataclasses.dataclass
class WrappedModel:
    """x0 prediction from an unconditional model(x, t_input) trained as
    x_start or noise (`model_wrapper`, `dpm_solver_pytorch.py:296-312`)."""

    model: Callable
    model_type: str = "x_start"

    def __post_init__(self):
        if self.model_type not in ("x_start", "noise"):
            raise ValueError(f"model_type must be 'x_start' or 'noise', got {self.model_type!r}")

    def x0(self, x, t_input, alpha_t, sigma_t):
        out = self.model(x, t_input)
        if self.model_type == "x_start":
            return out
        return (x - sigma_t * out) / alpha_t


@dataclasses.dataclass
class DPMSolver:
    """DPM-Solver++ (data prediction, 'dpmsolver' solver type) with dynamic
    thresholding of every x0 prediction."""

    wrapped: WrappedModel
    ns: NoiseScheduleVP
    thresholding_ratio: float = 0.995
    thresholding_max_val: float = 1.0

    def _x0(self, x, t_input, alpha_t, sigma_t):
        x0 = self.wrapped.x0(x, t_input, alpha_t, sigma_t)
        return dynamic_thresholding(x0, self.thresholding_ratio, self.thresholding_max_val)

    def _eval(self, x, t: float):
        t_input = torch.full((x.shape[0],), float(self.ns.model_input_time(t)),
                             dtype=torch.float32, device=x.device)
        return self._x0(x, t_input, self._alpha(t), self._sigma(t))

    def _lam(self, t):
        return float(self.ns.marginal_lambda(t))

    def _alpha(self, t):
        return float(self.ns.marginal_alpha(t))

    def _sigma(self, t):
        return float(self.ns.marginal_std(t))

    # -- updates ------------------------------------------------------------

    def _first_update(self, x, s, t, model_s):
        """DPM-Solver-1 / DDIM (`dpm_solver_first_update:563-609`)."""
        h = self._lam(t) - self._lam(s)
        return (self._sigma(t) / self._sigma(s)) * x - (
            self._alpha(t) * math.expm1(-h)) * model_s

    def _singlestep_update(self, x, s, t, order: int, r1=None, r2=None):
        """Singlestep order-k update with k model evaluations (`:610-816`);
        r1, r2 are the intermediate logSNR ratios."""
        if order == 1:
            return self._first_update(x, s, t, self._eval(x, s))
        lam_s, lam_t = self._lam(s), self._lam(t)
        h = lam_t - lam_s
        sig, al = self._sigma, self._alpha
        if order == 2:
            r1 = 0.5 if r1 is None else r1
            s1 = float(self.ns.inverse_lambda(lam_s + r1 * h))
            model_s = self._eval(x, s)
            phi_11, phi_1 = math.expm1(-r1 * h), math.expm1(-h)
            x_s1 = (sig(s1) / sig(s)) * x - (al(s1) * phi_11) * model_s
            model_s1 = self._eval(x_s1, s1)
            base = (sig(t) / sig(s)) * x - (al(t) * phi_1) * model_s
            return base - (0.5 / r1) * (al(t) * phi_1) * (model_s1 - model_s)
        if order != 3:
            raise ValueError(f"order must be 1, 2 or 3, got {order}")
        r1 = 1.0 / 3.0 if r1 is None else r1
        r2 = 2.0 / 3.0 if r2 is None else r2
        s1 = float(self.ns.inverse_lambda(lam_s + r1 * h))
        s2 = float(self.ns.inverse_lambda(lam_s + r2 * h))
        model_s = self._eval(x, s)
        phi_11 = math.expm1(-r1 * h)
        phi_12 = math.expm1(-r2 * h)
        phi_1 = math.expm1(-h)
        phi_22 = math.expm1(-r2 * h) / (r2 * h) + 1.0
        phi_2 = phi_1 / h + 1.0
        x_s1 = (sig(s1) / sig(s)) * x - (al(s1) * phi_11) * model_s
        model_s1 = self._eval(x_s1, s1)
        x_s2 = ((sig(s2) / sig(s)) * x - (al(s2) * phi_12) * model_s
                + (r2 / r1) * (al(s2) * phi_22) * (model_s1 - model_s))
        model_s2 = self._eval(x_s2, s2)
        return ((sig(t) / sig(s)) * x - (al(t) * phi_1) * model_s
                + (1.0 / r2) * (al(t) * phi_2) * (model_s2 - model_s))

    # -- time grids ----------------------------------------------------------

    def get_time_steps(self, skip_type, t_T, t_0, n):
        if skip_type != "logSNR":
            raise ValueError(f"the port has logSNR time steps, got {skip_type!r}")
        lam_T = self.ns.marginal_lambda(t_T)
        lam_0 = self.ns.marginal_lambda(t_0)
        return self.ns.inverse_lambda(np.linspace(lam_T, lam_0, n + 1))

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

    # -- driver ----------------------------------------------------------------

    def sample(self, x, steps: int = 20, order: int = 3, skip_type: str = "logSNR",
               method: str = "singlestep", denoise_to_zero: bool = False):
        if method != "singlestep":
            raise ValueError(f"the port has the singlestep method, got {method!r}")
        t_0 = 1.0 / self.ns.total_N
        t_T = self.ns.T
        orders = self._singlestep_orders(steps, order)
        ts_outer = self.get_time_steps(skip_type, t_T, t_0, len(orders))
        n3 = 0
        while n3 < len(orders) and orders[n3] == 3:
            n3 += 1
        start = 0
        if n3 >= 2:
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
        if denoise_to_zero:
            x = self._eval(x, t_0)
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
        b = x.shape[0]

        def ev(x_, tin, al, sig):
            t_input = torch.full((b,), float(tin), dtype=torch.float32, device=x_.device)
            return self._x0(x_, t_input, float(al), float(sig))

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
