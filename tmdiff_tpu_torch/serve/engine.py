"""Inference engine: dynamic batching of pansharpening requests onto one
sampler (port of tmdiff_tpu/serve/engine.py).

What the engine keeps from the JAX package's:
  * requests (one image each) are grouped by MS shape; sensors mix freely
    within a batch (one prompt embedding per row);
  * a batch is padded up to a fixed bucket size (powers of two up to
    `max_batch` by default) by repeating the last request, so the batch
    shapes the device sees are few and known ahead of time (`warmup()` runs
    each before traffic arrives);
  * one worker thread owns the device: it drains the queue, waits at most
    `max_delay_ms` after a group's first request for requests of its shape,
    runs the sampler, and resolves each request's future. One batch is in
    flight at a time, as in the JAX package.
`sharp` may also be a `serve/mesh.py::MeshLeader`: the same engine then
serves over every rank of a torchrun world, each batch sharded over the
("data", "space") mesh (the JAX package's engine likewise runs unchanged on
a meshed sampler).
A model that takes a hint and a task (models/controlnet.py::
ControlledLegacyUNet: its `hint_channels` and `task_index`) gets both with
every request, checked at submit; requests of different tasks share a
batch (the hints and the task ids go to the sampler as the batch's `HINT`
and `TASK`, one row each, padded rows copying the last), so the engine
never splits a group by task.
Batch k (counted from 0) samples with seed k. A request's future carries
`placement` = {"seed", "bucket", "row"} once resolved: the batch's seed and
padded size and the request's row in it, which reproduce its image through
a one-process `Pansharpener.sample` (x_T is drawn for the whole bucket from
the seed, on a mesh at the global shape too, and no row of a batch reads
another).

On the GPU nothing is compiled per shape, but the first batch of a shape
still pays for building the kernel libraries, the kernels' per-shape plans
and the caching allocator's first blocks; `warmup()` moves that before the
first request.

Spans (utils/profiling.py, while its recorder is on): `engine.request`,
from submit() to the future resolved (opened on the client's thread, closed
on the worker; `batch` = its batch's seed, `sampled_ns` = the start of its
batch's sampler call); on the worker `engine.wait` (blocked on the queue
for a group's first request), `engine.collect` (the first request to the
group's close; `batch`, `n`, `closed` = "full", "deadline" or "shutdown",
`requeued` = the requests of another shape put back), `engine.assemble`
(stack, pad, guidance), `engine.sample` (the sampler call; `batch`,
`bucket`, `tasks` = the distinct tasks of its requests, 0 without tasks)
and `engine.resolve`. `stats["task_groups"]` sums `tasks` over the batches.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
import time
from concurrent.futures import Future
from typing import Optional, Sequence

import numpy as np

from tmdiff_tpu_torch.utils import profiling


@dataclasses.dataclass
class _Request:
    pan: np.ndarray  # (1, H, W)
    ms: np.ndarray  # (bands, H, W)
    sensor: str
    future: Future
    enqueued_at: float
    guidance: Optional[float] = None  # CFG scale; None: the engine's default
    span: object = None  # its engine.request span (profiling.begin)
    hint: Optional[np.ndarray] = None  # (H, W, hint channels), with `task`
    task: Optional[int] = None  # the task's id in the model's `task_index`


class EngineOverloaded(RuntimeError):
    """Raised by submit() when the pending queue holds `max_queue` requests:
    backpressure that the HTTP layer turns into a 503, rather than letting
    latency grow without bound."""


def _model_of(sharp):
    """The model behind `sharp`: a Pansharpener's `model`, or that of the
    sampler an object holds as its `sharp` (a MeshLeader, a wrapper)."""
    while sharp is not None and not hasattr(sharp, "model"):
        sharp = getattr(sharp, "sharp", None)
    return getattr(sharp, "model", None)


def _bucket(n: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


@dataclasses.dataclass
class InferenceEngine:
    """Batches concurrent pansharpening requests onto one sampler.

    `sharp` is a `tmdiff_tpu_torch.pipeline.Pansharpener` (model, schedule
    and prompt table, on its device) or a MeshLeader in front of a meshed
    one. `submit()` is thread-safe and returns a Future of the (bands, H, W)
    sharpened image in [0, 1].
    """

    sharp: object
    method: str = "dpm++"
    steps: Optional[int] = None
    guidance: float = 3.0  # default CFG scale (dpm++_cfg only)
    max_batch: int = 8
    max_delay_ms: float = 15.0
    buckets: Optional[Sequence[int]] = None
    max_queue: Optional[int] = None  # pending-request bound; None: unbounded
    # further keyword arguments of Pansharpener.sample, passed on as given:
    # the method-specific settings of a deployment (ddim_cached's
    # refresh_every, cache_level, forecast, refresh_mask), fixed per engine
    sampler_kw: Optional[dict] = None

    def __post_init__(self):
        if self.buckets is None:
            b, bs = 1, []
            while b < self.max_batch:
                bs.append(b)
                b *= 2
            self.buckets = tuple(bs) + (self.max_batch,)
        self._queue: "queue.Queue[Optional[_Request]]" = queue.Queue()
        self._seed = 0
        self._lock = threading.Lock()
        self.stats = {
            "requests": 0,
            "batches": 0,
            "padded_slots": 0,
            "batch_size_hist": {},
            "latency_ms_sum": 0.0,
            "rejected": 0,  # present from the start, so /v1/stats keeps one schema
            "task_groups": 0,  # distinct tasks summed over batches
        }
        model = _model_of(self.sharp)
        self.hint_channels = getattr(model, "hint_channels", None)
        self.task_index = getattr(model, "task_index", {})
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    # -- public API ----------------------------------------------------------

    def submit(self, pan, ms, sensor: str = "QB", guidance: Optional[float] = None,
               hint=None, task: Optional[str] = None) -> Future:
        """`guidance` (dpm++_cfg engines only) overrides the engine's default
        for this request; requests at different scales share a batch, the
        scales going to the sampler as one (B,) vector. `hint` (H, W, the
        model's `hint_channels`) and `task` (a name of its `task_index`)
        come with every request to a model that takes them, and with none
        to another."""
        pan = np.asarray(pan, np.float32)
        ms = np.asarray(ms, np.float32)
        if pan.ndim == 2:
            pan = pan[None]
        if pan.ndim != 3 or ms.ndim != 3:
            raise ValueError(
                f"submit() takes one image per request: pan (1,H,W), "
                f"ms (bands,H,W); got {pan.shape} / {ms.shape}")
        if pan.shape[-2:] != ms.shape[-2:]:
            # refused here: stacked with its group, it would fail the whole batch
            raise ValueError(
                f"pan spatial dims {pan.shape[-2:]} must match ms "
                f"{ms.shape[-2:]} (ms is the upsampled LMS)")
        if guidance is not None and self.method != "dpm++_cfg":
            # only the CFG sampler reads it: ignoring it would let a client
            # believe it swept scales on a ddim or dpm++ deployment
            raise ValueError(
                f"guidance= is only meaningful on a dpm++_cfg engine "
                f"(this engine runs {self.method!r})")
        hint, task_id = self._control(hint, task, ms.shape[-2:])
        if self.max_queue is not None and self._queue.qsize() >= self.max_queue:
            self.stats["rejected"] += 1
            raise EngineOverloaded(f"pending queue at limit ({self.max_queue}); retry later")
        fut: Future = Future()
        self._queue.put(_Request(pan, ms, sensor, fut, time.monotonic(), guidance,
                                 profiling.begin("engine.request"), hint, task_id))
        return fut

    def _control(self, hint, task, size) -> tuple:
        """(hint as float32, the task's id), both None for a model that takes
        neither; refused here, as a bad `pan` is, since stacked with its
        group a bad one would fail the whole batch."""
        if self.hint_channels is None:
            if hint is not None or task is not None:
                raise ValueError("this engine's model takes no hint or task")
            return None, None
        if hint is None or task is None:
            raise ValueError(f"this engine's model takes a hint (H, W, {self.hint_channels}) "
                             "and a task with every request")
        hint = np.asarray(hint, np.float32)
        if hint.shape != (*size, self.hint_channels):
            raise ValueError(f"hint shape {hint.shape}: expected {(*size, self.hint_channels)} "
                             "(the MS image's H and W, the model's hint channels)")
        if task not in self.task_index:
            raise ValueError(f"unknown task {task!r}; expected one of {sorted(self.task_index)}")
        return hint, self.task_index[task]

    def warmup(self, shapes: Sequence[tuple[int, int, int]], sensor: str = "QB") -> None:
        """Runs every (shape, bucket) batch once before traffic arrives,
        through submit() as a request would. `shapes` are (bands, H, W).
        Each bucket's requests are submitted and awaited on their own:
        submitted together, the worker would merge them into the largest
        bucket."""
        for bands, h, w in shapes:
            ms = np.zeros((bands, h, w), np.float32)
            pan = np.zeros((1, h, w), np.float32)
            control = {}
            if self.hint_channels is not None:  # a zero hint and the task of id 0
                control = {"hint": np.zeros((h, w, self.hint_channels), np.float32),
                           "task": min(self.task_index, key=self.task_index.get)}
            for b in self.buckets:
                futs = [self.submit(pan, ms, sensor, **control) for _ in range(b)]
                for f in futs:
                    f.result()

    def shutdown(self) -> None:
        self._queue.put(None)
        self._worker.join(timeout=60)

    # -- worker ----------------------------------------------------------------

    def _run(self):
        while True:
            with profiling.span("engine.wait"):
                req = self._queue.get()
            if req is None:
                return
            with profiling.span("engine.collect") as span:
                group, leftovers, closed = self._collect(req)
                with self._lock:
                    seed = self._seed
                    self._seed += 1
                span.set(batch=seed, n=len(group), closed=closed,
                         requeued=0 if closed == "shutdown" else len(leftovers))
            if closed == "shutdown":
                # run the group, fail what waits behind it
                self._execute(group, [], seed)
                for r in leftovers:
                    if not r.future.done():
                        r.future.set_exception(RuntimeError("engine shut down"))
                return
            self._execute(group, leftovers, seed)

    def _collect(self, req) -> tuple:
        """(group, leftovers, how the group closed): requests of `req`'s MS
        shape taken from the queue until the group is full, `max_delay_ms`
        after `req`, or the queue hands out the shutdown mark; those of
        another shape seen meanwhile are the leftovers."""
        group = [req]
        key = req.ms.shape  # one batch takes one MS shape, any sensors
        deadline = time.monotonic() + self.max_delay_ms / 1e3
        leftovers = []
        while len(group) < self.max_batch:
            timeout = deadline - time.monotonic()
            if timeout <= 0:
                return group, leftovers, "deadline"
            try:
                nxt = self._queue.get(timeout=timeout)
            except queue.Empty:
                return group, leftovers, "deadline"
            if nxt is None:
                return group, leftovers, "shutdown"
            if nxt.ms.shape == key:
                group.append(nxt)
            else:
                leftovers.append(nxt)
        return group, leftovers, "full"

    def _execute(self, group: list, leftovers: list, seed: int):
        # requests of another shape seen while collecting go back to the
        # front, in arrival order, under the queue's mutex (producers may be
        # putting; this thread is the only consumer, so no notify is needed)
        with self._queue.mutex:
            for r in reversed(leftovers):
                self._queue.queue.appendleft(r)
        try:
            with profiling.span("engine.assemble"):
                n = len(group)
                b = _bucket(n, self.buckets)
                pan = np.stack([r.pan for r in group] + [group[-1].pan] * (b - n))
                ms = np.stack([r.ms for r in group] + [group[-1].ms] * (b - n))
                sensors = [r.sensor for r in group] + [group[-1].sensor] * (b - n)
                kw = dict(self.sampler_kw or {})
                if self.method == "dpm++_cfg":
                    gvec = [r.guidance if r.guidance is not None else self.guidance
                            for r in group]
                    kw["guidance"] = np.asarray(gvec + [gvec[-1]] * (b - n), np.float32)
                batch = {"PAN": pan, "MS": ms}
                tasks = 0
                if group[0].hint is not None:
                    rows = group + [group[-1]] * (b - n)
                    batch["HINT"] = np.stack([r.hint for r in rows])
                    batch["TASK"] = np.asarray([r.task for r in rows], np.int64)
                    tasks = len({r.task for r in group})
            with profiling.span("engine.sample", batch=seed, bucket=b, tasks=tasks) as sampled:
                out = self.sharp.sample(batch, sensor=sensors, method=self.method,
                                        steps=self.steps, seed=seed, **kw)
            with profiling.span("engine.resolve"):
                now = time.monotonic()
                self.stats["requests"] += n
                self.stats["batches"] += 1
                self.stats["padded_slots"] += b - n
                self.stats["task_groups"] += tasks
                hist = self.stats["batch_size_hist"]
                hist[n] = hist.get(n, 0) + 1
                for i, r in enumerate(group):
                    self.stats["latency_ms_sum"] += (now - r.enqueued_at) * 1e3
                    r.future.placement = {"seed": seed, "bucket": b, "row": i}
                    r.future.set_result(np.asarray(out[i]))
                    profiling.end(r.span, batch=seed, sampled_ns=sampled.start)
        except Exception as err:  # resolve the group's futures; the worker lives on
            for r in group:
                if not r.future.done():
                    r.future.set_exception(err)
                    profiling.end(r.span, batch=seed, error=type(err).__name__)
