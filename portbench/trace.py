"""The traced window of a `--trace 1` run: the profiler collects the
device's activity (CUDA only, no host operators, and its results are read
raw, so neither its cost on the host's path nor its post-processing grows
with the host's work), and the harness's own spans say what the host was
doing. Both are on the wall clock in nanoseconds (the profiler's time base),
so a device operation and a host span can be set side by side."""
from __future__ import annotations

import time
from collections import defaultdict

import numpy as np


class Spans:
    """The harness's spans: name -> [(start ns, end ns)], wall clock."""

    def __init__(self):
        self.spans = defaultdict(list)

    def add(self, name: str, start: int, end: int) -> None:
        self.spans[name].append((start, end))

    def within(self, name: str, start: int, end: int) -> list:
        return [(a, b) for a, b in self.spans.get(name, ()) if a >= start and b <= end]


class Kernels:
    """Every operation that ran on the device (kernels, copies, fills):
    `names` the distinct names, and per operation its name's index, start
    and end (ns), as arrays."""

    def __init__(self, names: list, name_id, start, end):
        self.names = names
        self.name_id = np.asarray(name_id, np.int64)
        self.start = np.asarray(start, np.int64)
        self.end = np.asarray(end, np.int64)

    @classmethod
    def of(cls, ops) -> "Kernels":
        """From (name, start ns, end ns) triples."""
        index: dict = {}
        ids = [index.setdefault(name, len(index)) for name, _, _ in ops]
        return cls(list(index), ids, [a for _, a, _ in ops], [b for _, _, b in ops])

    def __len__(self):
        return len(self.start)

    def clipped(self, start: int, end: int):
        """(name ids, starts, ends) of the operations cut to [start, end],
        those with nothing left dropped."""
        a, b = np.maximum(self.start, start), np.minimum(self.end, end)
        keep = b > a
        return self.name_id[keep], a[keep], b[keep]

    def merged(self, start: int, end: int):
        """The union of the operations' intervals inside [start, end], as
        disjoint sorted (starts, ends)."""
        _, a, b = self.clipped(start, end)
        if len(a) == 0:
            return a, b
        order = np.argsort(a, kind="stable")
        a, b = a[order], np.maximum.accumulate(b[order])
        new = np.empty(len(a), bool)
        new[0] = True
        new[1:] = a[1:] > b[:-1]
        first = np.flatnonzero(new)
        last = np.append(first[1:] - 1, len(a) - 1)
        return a[first], b[last]

    def busy_seconds(self, start: int, end: int) -> float:
        a, b = self.merged(start, end)
        return float((b - a).sum()) / 1e9

    def gaps(self, start: int, end: int) -> list:
        """The (a, b) stretches of [start, end] with no operation running."""
        a, b = self.merged(start, end)
        lo = np.concatenate([[start], b])
        hi = np.concatenate([a, [end]])
        return [(int(x), int(y)) for x, y in zip(lo, hi) if y > x]

    def by_name(self, start: int, end: int) -> dict:
        """Device seconds of each operation name inside [start, end]."""
        ids, a, b = self.clipped(start, end)
        sums = np.bincount(ids, weights=(b - a).astype(np.float64), minlength=len(self.names))
        return {self.names[i]: float(sums[i]) / 1e9 for i in np.flatnonzero(sums)}

    def seconds_within(self, names, spans) -> float:
        """Device seconds of the operations whose name holds one of `names`
        and that begin and end inside one of `spans` ((a, b) ns, disjoint)."""
        hit = np.array([any(n in name for n in names) for name in self.names], bool)
        if not hit.any() or not spans:
            return 0.0
        sel = hit[self.name_id]
        a, b = self.start[sel], self.end[sel]
        spans = sorted(spans)
        s0 = np.array([s for s, _ in spans], np.int64)
        s1 = np.array([e for _, e in spans], np.int64)
        i = np.searchsorted(s0, a, side="right") - 1
        ok = (i >= 0) & (b <= s1[np.maximum(i, 0)])
        return float((b[ok] - a[ok]).sum()) / 1e9


class DeviceTrace:
    """The profiler around a window; `kernels` (Kernels) once it closes."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.kernels = None
        self._on = False

    def __enter__(self):
        if self.enabled:
            from torch.autograd import profiler

            prof = profiler.profile(use_device="cuda", use_cpu=False, use_kineto=True)
            prof._prepare_trace()
            prof._start_trace()
            self._on = True
        return self

    def __exit__(self, *exc):
        if not self._on:
            return False
        import torch
        from torch.autograd import profiler

        torch.cuda.synchronize()
        result = profiler._disable_profiler()
        self._on = False
        cuda = torch.autograd.DeviceType.CUDA
        self.kernels = Kernels.of([(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
                                   for e in result.events()
                                   if e.device_type() == cuda and e.duration_ns() > 0])
        return False


def breakdown(kernels: Kernels, spans: Spans, start: int, end: int, host_names: list) -> dict:
    """{"device_ops": the 10 operations with most device seconds in the
    window, "idle_gaps": the device's idle seconds in the window by the host
    span (of `host_names`, in that order of precedence) under each gap's
    midpoint, "no span" where none is open}; the top 10 of each."""
    gaps = np.array(kernels.gaps(start, end), np.int64).reshape(-1, 2)
    mid = (gaps[:, 0] + gaps[:, 1]) / 2
    label = np.full(len(gaps), len(host_names))  # index of the label; last: "no span"
    for k, name in reversed(list(enumerate(host_names))):
        held = sorted(spans.spans.get(name, ()))
        if not held:
            continue
        s0 = np.array([a for a, _ in held], np.float64)
        s1 = np.array([b for _, b in held], np.float64)
        i = np.searchsorted(s0, mid, side="right") - 1
        label[(i >= 0) & (mid <= s1[np.maximum(i, 0)])] = k
    seconds = np.bincount(label, weights=(gaps[:, 1] - gaps[:, 0]) / 1e9,
                          minlength=len(host_names) + 1)
    idle = {n: float(v) for n, v in zip(list(host_names) + ["no span"], seconds) if v > 0}
    top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]
    return {"device_ops": top(kernels.by_name(start, end)), "idle_gaps": top(idle)}


def now_ns() -> int:
    return time.time_ns()
