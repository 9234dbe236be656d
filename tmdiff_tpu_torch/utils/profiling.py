"""Tracing, throughput counters and cost analysis (port of
tmdiff_tpu/utils/profiling.py):

  * `trace(logdir)`: torch.profiler around a block (CPU, and CUDA where a
    card is present), a Chrome trace written under `logdir`;
  * `Throughput`: steps/s and images/s EMA counters on the host clock;
  * `cost_analysis(fn, *args)`: the FLOPs of one call counted by
    torch.utils.flop_counter (matmuls, convs, attention; no byte or
    transcendental count: -1, the JAX package's mark of a missing count);
  * `param_count(params)`: trainable parameter count.
"""
from __future__ import annotations

import contextlib
import os
import time
from collections.abc import Mapping
from typing import Optional

import numpy as np
import torch
from torch.utils.flop_counter import FlopCounterMode


@contextlib.contextmanager
def trace(logdir: str):
    """Profiles the block and writes `logdir/trace.json` (Chrome format)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


class Throughput:
    """EMA throughput tracker: call .step(n_images) once per train step."""

    def __init__(self, ema: float = 0.95):
        self.ema = ema
        self._last: Optional[float] = None
        self.steps_per_sec = 0.0
        self.images_per_sec = 0.0
        self.total_steps = 0

    def step(self, n_images: int = 0):
        now = time.perf_counter()
        if self._last is not None:
            dt = max(now - self._last, 1e-9)
            sps, ips = 1.0 / dt, n_images / dt
            if self.total_steps <= 1:
                self.steps_per_sec, self.images_per_sec = sps, ips
            else:
                self.steps_per_sec = self.ema * self.steps_per_sec + (1 - self.ema) * sps
                self.images_per_sec = self.ema * self.images_per_sec + (1 - self.ema) * ips
        self._last = now
        self.total_steps += 1

    def per_chip(self, n_devices: Optional[int] = None) -> dict:
        """The rates in all and per device: `n_devices`, else the visible
        CUDA devices (one where there is none: a host-only run)."""
        n = n_devices or max(torch.cuda.device_count(), 1)
        return {"devices": n,
                "steps_per_sec": self.steps_per_sec,
                "steps_per_sec_per_chip": self.steps_per_sec / n,
                "images_per_sec": self.images_per_sec,
                "images_per_sec_per_chip": self.images_per_sec / n}


def cost_analysis(fn, *args, **kwargs) -> dict:
    """The FLOPs of fn(*args, **kwargs), run once under FlopCounterMode."""
    with FlopCounterMode(display=False) as counter:
        fn(*args, **kwargs)
    return {"flops": float(counter.get_total_flops()), "bytes_accessed": -1.0,
            "transcendentals": -1.0}


def _leaves(params):
    if isinstance(params, torch.nn.Module):
        yield from params.parameters()
    elif isinstance(params, Mapping):
        for v in params.values():
            yield from _leaves(v)
    elif isinstance(params, (list, tuple)):
        for v in params:
            yield from _leaves(v)
    else:
        yield params


def param_count(params) -> int:
    """Elements of a module's parameters, or of the arrays or tensors of a
    nested dict / list."""
    return int(sum(np.prod(p.shape) for p in _leaves(params)))
