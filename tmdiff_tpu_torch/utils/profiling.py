"""Spans, tracing and cost analysis (port of tmdiff_tpu/utils/profiling.py;
its `Throughput`, an EMA of per-step rates that nothing read, is not
ported):

  * the span recorder (below): `span(name, **attrs)` around a block,
    `begin` / `end` for a span that one thread opens and another closes,
    `enable`, `disable`, `recording()` and `drain()`;
  * `trace(logdir)`: torch.profiler around a block (CPU, and CUDA where a
    card is present) with the recorder on, a Chrome trace and the block's
    spans written under `logdir`;
  * `cost_analysis(fn, *args)`: the FLOPs of one call counted by
    torch.utils.flop_counter (matmuls, convs, attention; no byte or
    transcendental count: -1, the JAX package's mark of a missing count);
  * `param_count(params)`: trainable parameter count.

The span recorder is one per process. A span is a `Span`: its name, its
start and end in ns on `time.time_ns()` (the clock torch.profiler stamps
its events on, so a span and a profiler event, host or device, lie on one
axis), its id, its parent's id (the innermost span open on the thread that
began it; 0 at the top), that thread's id and a small dict of attributes.
Recording is off until `enable()` (or inside `recording()` or `trace()`):
while it is off, `span` returns one shared context manager that does
nothing, after one boolean check, `begin` returns None and nothing is
stored. A span is kept if recording is on when it ends. Kept spans wait in
one buffer of at most CAPACITY spans until `drain()` takes them; spans that
find it full are dropped, and `drain()` warns how many. The recorder counts
nothing: counts come from the spans' attributes and the program's own
counters.
"""
from __future__ import annotations

import contextlib
import itertools
import json
import os
import threading
import time
import warnings
from collections.abc import Mapping
from typing import NamedTuple, Optional

import numpy as np
import torch
from torch.utils.flop_counter import FlopCounterMode

CAPACITY = 1 << 18  # spans kept between two drains


class Span(NamedTuple):
    name: str
    start: int  # ns, time.time_ns()
    end: int
    id: int
    parent: int  # 0: none
    thread: int
    attrs: dict


_on = False
_kept: list = []
_dropped = 0
_lock = threading.Lock()
_ids = itertools.count(1)
_local = threading.local()


def _stack() -> list:
    """The ids of the spans open on this thread, innermost last."""
    try:
        return _local.stack
    except AttributeError:
        _local.stack = []
        return _local.stack


def _keep(opened: "_Open", end: int) -> None:
    global _dropped
    if not _on:
        return
    done = Span(opened.name, opened.start, end, opened.id, opened.parent, opened.thread,
                opened.attrs)
    with _lock:
        if len(_kept) < CAPACITY:
            _kept.append(done)
        else:
            _dropped += 1


class _Open:
    """A span begun and not yet ended; as a context manager it is the
    innermost span of its thread while its block runs."""

    __slots__ = ("name", "attrs", "id", "parent", "thread", "start")

    def __init__(self, name: str, attrs: dict):
        self.name, self.attrs = name, attrs
        self.id = next(_ids)
        self.thread = threading.get_ident()
        stack = _stack()
        self.parent = stack[-1] if stack else 0
        self.start = time.time_ns()

    def set(self, **attrs) -> None:
        """Adds attributes found inside the span."""
        self.attrs.update(attrs)

    def __enter__(self):
        _stack().append(self.id)
        self.start = time.time_ns()
        return self

    def __exit__(self, *exc):
        end = time.time_ns()
        _stack().pop()
        _keep(self, end)
        return False


class _Off:
    """What `span` returns while recording is off: one shared object."""

    start = 0

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs) -> None:
        pass


_OFF = _Off()


def span(name: str, **attrs):
    """A context manager that records the block as a span `name` with
    `attrs` (more may be added inside with `.set(**attrs)`; `.start` is
    its start, 0 while recording is off)."""
    if not _on:
        return _OFF
    return _Open(name, attrs)


def begin(name: str, **attrs) -> Optional[_Open]:
    """Opens a span that `end` closes, on any thread; its parent is the
    innermost span open here. Returns its handle (None while recording
    is off)."""
    if not _on:
        return None
    return _Open(name, attrs)


def end(handle: Optional[_Open], **attrs) -> None:
    """Closes a span `begin` opened, adding `attrs`; None does nothing."""
    if handle is not None:
        handle.attrs.update(attrs)
        _keep(handle, time.time_ns())


def enable() -> None:
    global _on
    _on = True


def disable() -> None:
    global _on
    _on = False


@contextlib.contextmanager
def recording():
    """The recorder on for the block, off after it."""
    enable()
    try:
        yield
    finally:
        disable()


def drain() -> list:
    """The kept spans, in the order they ended; the buffer is emptied."""
    global _kept, _dropped
    with _lock:
        out, dropped, _kept, _dropped = _kept, _dropped, [], 0
    if dropped:
        warnings.warn(f"the span buffer was full: {dropped} spans dropped", RuntimeWarning)
    return out


@contextlib.contextmanager
def trace(logdir: str):
    """Profiles the block with torch.profiler and records the program's
    spans over it (the recorder on for the block, off after it). Writes
    `logdir/trace.json` (Chrome format) and `logdir/spans.json`: the spans
    `drain()` returns at the end, as objects with `start_ns` and `end_ns`
    on the trace's clock (an event of trace.json at `ts` us lies at
    ts * 1000 + its `baseTimeNanoseconds`)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof, recording():
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
    spans = [{"name": s.name, "start_ns": s.start, "end_ns": s.end, "id": s.id,
              "parent": s.parent, "thread": s.thread, "attrs": s.attrs} for s in drain()]
    with open(os.path.join(logdir, "spans.json"), "w") as f:
        json.dump(spans, f, default=str)


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
