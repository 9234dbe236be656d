"""The span recorder (utils/profiling.py) and the spans the port records at
its layer boundaries, on the CPU: off records nothing; parents on one
thread and a span that crosses threads; the bounded buffer; the clock
shared with torch.profiler and `trace`'s spans.json; InferenceEngine's
worker spans on a stub sampler; a tiny WavBEST through
`Pansharpener.sample`; the ControlNet's `sample.hint` span and the engine's
count of tasks a batch; DeviceFeeder and its Prefetcher; the CPU
`compiled_step`. The card-only spans (`step.capture` then `step.replay`,
`conv3d.plan`) are tested in tests/test_torch_cuda.py."""
import json
import threading

import numpy as np
import pytest
import torch

from tmdiff_tpu_torch.diffusion.schedules import NoiseSchedule
from tmdiff_tpu_torch.models.clip_text import load_prompt_table
from tmdiff_tpu_torch.models.wavbest import WavBEST
from tmdiff_tpu_torch.pipeline import Pansharpener
from tmdiff_tpu_torch.profile_request import busy_seconds
from tmdiff_tpu_torch.runtime.prefetch import DeviceFeeder
from tmdiff_tpu_torch.serve.engine import InferenceEngine
from tmdiff_tpu_torch.train.trainer import Trainer
from tmdiff_tpu_torch.utils import profiling

torch.set_num_threads(2)

CHANNELS = (8, 16, 32, 64)


@pytest.fixture(autouse=True)
def fresh_recorder():
    profiling.disable()
    profiling.drain()
    yield
    profiling.disable()
    profiling.drain()


def by_name(spans) -> dict:
    out = {}
    for s in spans:
        out.setdefault(s.name, []).append(s)
    return out


def test_off_records_nothing():
    a, b = profiling.span("x", k=1), profiling.span("y")
    assert a is b  # one shared no-op
    with a as opened:
        opened.set(k=2)
        assert opened.start == 0
    assert profiling.begin("r") is None
    profiling.end(None, k=1)
    assert profiling.drain() == []


def test_parent_and_child_on_one_thread():
    with profiling.recording():
        with profiling.span("outer", a=1) as outer:
            with profiling.span("inner") as inner:
                inner.set(b=2)
        with profiling.span("next"):
            pass
    with profiling.span("after"):  # recording is off again
        pass
    spans = by_name(profiling.drain())
    assert sorted(spans) == ["inner", "next", "outer"]
    (o,), (i,), (n,) = spans["outer"], spans["inner"], spans["next"]
    assert o.parent == 0 and n.parent == 0 and i.parent == o.id == outer.id
    assert i.id == inner.id and len({o.id, i.id, n.id}) == 3
    assert o.start <= i.start <= i.end <= o.end <= n.start <= n.end
    assert o.attrs == {"a": 1} and i.attrs == {"b": 2}
    assert o.thread == i.thread == threading.get_ident()


def test_a_span_begun_on_one_thread_ends_on_another():
    with profiling.recording():
        with profiling.span("client") as client:
            handle = profiling.begin("request", n=1)
        worker = threading.Thread(target=lambda: profiling.end(handle, done=True))
        worker.start()
        worker.join(timeout=10)
        assert not worker.is_alive()
    spans = by_name(profiling.drain())
    (req,) = spans["request"]
    assert req.parent == client.id and req.thread == threading.get_ident()
    assert req.attrs == {"n": 1, "done": True} and req.end >= req.start


def test_the_buffer_is_bounded(monkeypatch):
    monkeypatch.setattr(profiling, "CAPACITY", 3)
    with profiling.recording():
        for k in range(5):
            with profiling.span("s", k=k):
                pass
    with pytest.warns(RuntimeWarning, match="2 spans dropped"):
        kept = profiling.drain()
    assert [s.attrs["k"] for s in kept] == [0, 1, 2]
    assert profiling.drain() == []


def test_spans_share_the_profilers_clock():
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with profiling.recording(), profiling.span("program"):
            with torch.profiler.record_function("probe"):
                torch.ones(8, 8) @ torch.ones(8, 8)
    (program,) = profiling.drain()
    probe = [e for e in prof.profiler.kineto_results.events() if e.name() == "probe"]
    assert len(probe) == 1
    assert program.start <= probe[0].start_ns() <= program.end


def test_trace_writes_the_spans_on_the_traces_clock(tmp_path):
    with profiling.trace(str(tmp_path / "tr")):
        with profiling.span("program", n=3):
            with torch.profiler.record_function("probe"):
                torch.ones(8, 8) @ torch.ones(8, 8)
    assert profiling.span("later") is profiling.span("other")  # off after the block
    with open(tmp_path / "tr" / "trace.json") as f:
        chrome = json.load(f)
    with open(tmp_path / "tr" / "spans.json") as f:
        (span,) = json.load(f)
    assert span["name"] == "program" and span["attrs"] == {"n": 3}
    probe = [e for e in chrome["traceEvents"] if e.get("name") == "probe"]
    at = probe[0]["ts"] * 1000 + chrome["baseTimeNanoseconds"]
    assert span["start_ns"] - 1000 <= at <= span["end_ns"]


def test_busy_seconds_counts_overlaps_once():
    assert busy_seconds([(0, 4), (1, 2), (3, 6), (8, 9)]) == 7
    assert busy_seconds([]) == 0


class StubSampler:
    """Pansharpener.sample's signature; each batch's images are zeros."""

    def sample(self, batch, **kw):
        return np.zeros_like(batch["MS"])


def engine_spans(max_delay_ms, submits, max_batch=2, shutdown_first=False):
    """Runs `submits` ((bands, size) a request) through an engine on the
    stub; returns (spans by name, futures)."""
    with profiling.recording():
        engine = InferenceEngine(StubSampler(), method="ddim", steps=1, max_batch=max_batch,
                                 max_delay_ms=max_delay_ms)
        futs = [engine.submit(np.zeros((1, s, s), np.float32), np.zeros((b, s, s), np.float32))
                for b, s in submits]
        if not shutdown_first:
            for f in futs:
                f.result(timeout=30)
        engine.shutdown()
    return by_name(profiling.drain()), futs


def check_batches(spans, futs):
    """One wait, collect, assemble, sample and resolve a batch, in that
    order on the worker; each request's span names its batch and that
    batch's sampler start."""
    sample = {s.attrs["batch"]: s for s in spans["engine.sample"]}
    collect = {s.attrs["batch"]: s for s in spans["engine.collect"]}
    assert sorted(sample) == sorted(collect) == list(range(len(sample)))
    for name in ("engine.assemble", "engine.resolve"):
        assert len(spans[name]) == len(sample)
    # a wait for every group, and one more for the shutdown mark
    assert len(spans["engine.wait"]) == len(sample) + 1
    worker = {s.thread for k, v in spans.items() if k != "engine.request" for s in v}
    assert len(worker) == 1 and threading.get_ident() not in worker
    for k, s in sample.items():
        assert collect[k].end <= s.start
    reqs = spans["engine.request"]
    assert len(reqs) == len(futs)
    for r in reqs:
        assert r.attrs["sampled_ns"] == sample[r.attrs["batch"]].start
        assert r.start <= r.attrs["sampled_ns"] <= r.end
    assert sorted(f.placement["seed"] for f in futs) == sorted(r.attrs["batch"] for r in reqs)
    return collect, sample


def test_engine_spans_full_and_deadline():
    spans, futs = engine_spans(2000.0, [(4, 8), (4, 8)])
    collect, sample = check_batches(spans, futs)
    assert collect[0].attrs == {"batch": 0, "n": 2, "closed": "full", "requeued": 0}
    assert sample[0].attrs == {"batch": 0, "bucket": 2, "tasks": 0}
    spans, futs = engine_spans(5.0, [(4, 8)])
    collect, _ = check_batches(spans, futs)
    assert collect[0].attrs == {"batch": 0, "n": 1, "closed": "deadline", "requeued": 0}


def test_engine_spans_requeue_a_second_shape():
    spans, futs = engine_spans(300.0, [(4, 8), (8, 8), (4, 8)])
    collect, sample = check_batches(spans, futs)
    assert collect[0].attrs == {"batch": 0, "n": 2, "closed": "full", "requeued": 1}
    assert collect[1].attrs == {"batch": 1, "n": 1, "closed": "deadline", "requeued": 0}
    assert sample[1].attrs == {"batch": 1, "bucket": 1, "tasks": 0}
    assert futs[1].placement == {"seed": 1, "bucket": 1, "row": 0}


def test_engine_spans_at_shutdown():
    spans, futs = engine_spans(60_000.0, [(4, 8)], max_batch=4, shutdown_first=True)
    assert futs[0].result(timeout=30).shape == (4, 8, 8)
    (collect,) = spans["engine.collect"]
    assert collect.attrs == {"batch": 0, "n": 1, "closed": "shutdown", "requeued": 0}
    assert len(spans["engine.request"]) == 1


@pytest.fixture(scope="module")
def sharp():
    return Pansharpener(WavBEST(CHANNELS, device="cpu", seed=0), n_timestep=100, device="cpu")


def sampler_spans(sharp, **kw):
    rng = np.random.default_rng(0)
    ms = rng.uniform(0.05, 0.95, (2, 4, 16, 16)).astype(np.float32)
    with profiling.recording():
        out = sharp.sample({"PAN": ms.mean(1, keepdims=True), "MS": ms}, sensor="QB", **kw)
    assert out.shape == ms.shape
    return by_name(profiling.drain())


@pytest.mark.parametrize("method,steps,kinds", [
    ("ddim", 1, ["denoise"]),
    # ddim_cached refreshes the deep trunk every second step
    ("ddim_cached", 20, ["deep", "reuse"] * 10),
])
def test_sampler_spans(sharp, method, steps, kinds):
    spans = sampler_spans(sharp, method=method, steps=steps)
    assert sorted(spans) == ["sample.d2h", "sample.denoise", "sample.encode", "sample.h2d",
                             "sample.loop"]
    (h2d,), (enc,), (loop,), (d2h,) = (spans[f"sample.{k}"] for k in ("h2d", "encode", "loop",
                                                                      "d2h"))
    assert h2d.end <= enc.start and enc.end <= loop.start and loop.end <= d2h.start
    denoise = sorted(spans["sample.denoise"], key=lambda s: s.start)
    assert [s.attrs["kind"] for s in denoise] == kinds
    assert all(s.parent == loop.id and loop.start <= s.start <= s.end <= loop.end
               for s in denoise)


def test_controlnet_hint_span_and_task_counts():
    """A tiny ControlledLegacyUNet behind the engine: two batches of mixed
    tasks give `engine.sample` spans with their distinct tasks, the
    `task_groups` counter their sum, and one `sample.hint` span inside each
    `sample.encode` with the batch's rows and distinct tasks."""
    from tmdiff_tpu_torch.models.controlnet import ControlledLegacyUNet

    model = ControlledLegacyUNet((8, 8, 16, 16), embed_dim=16, inter_dim=8, device="cpu")
    engine = InferenceEngine(Pansharpener(model, n_timestep=100, device="cpu"),
                             method="ddim", steps=1, max_batch=4, max_delay_ms=2000.0)
    rng = np.random.default_rng(1)
    tasks = [["control_canny", "control_depth", "control_canny", "control_seg"],
             ["control_hed", "control_hed"]]
    try:
        with profiling.recording():
            for group in tasks:
                futs = [engine.submit(rng.random((1, 16, 16), np.float32),
                                      rng.random((4, 16, 16), np.float32), "WV3",
                                      hint=rng.random((16, 16, 3), np.float32), task=t)
                        for t in group]
                for f in futs:
                    f.result(timeout=60)
    finally:
        engine.shutdown()
    spans = by_name(profiling.drain())
    sample = {s.attrs["batch"]: s for s in spans["engine.sample"]}
    assert [sample[k].attrs["tasks"] for k in (0, 1)] == [3, 1]
    assert engine.stats["task_groups"] == 4 and engine.stats["batches"] == 2
    hints = sorted(spans["sample.hint"], key=lambda s: s.start)
    encodes = sorted(spans["sample.encode"], key=lambda s: s.start)
    assert [h.attrs for h in hints] == [{"rows": 4, "tasks": 3}, {"rows": 2, "tasks": 1}]
    for h, e in zip(hints, encodes):
        assert h.parent == e.id and e.start <= h.start <= h.end <= e.end


def test_feeder_spans():
    items = [{"x": np.full((2, 3), k, np.float32)} for k in range(4)]
    with profiling.recording():
        feeder = DeviceFeeder(iter(items), device="cpu", depth=2)
        got = [int(item["x"][0, 0]) for item in feeder]
        feeder.close()
    assert got == [0, 1, 2, 3]
    spans = by_name(profiling.drain())
    # a source wait and a staging an item; the call that hands out the last
    # item and the one that ends the iteration each find the end
    assert len(spans["feed.source"]) == 6 and len(spans["feed.stage"]) == 4
    assert len(spans["feed.handoff"]) == 4
    # the Prefetcher's thread: four items and the end of its source
    assert len(spans["feed.produce"]) == 5
    main = threading.get_ident()
    assert {s.thread for s in spans["feed.produce"]} != {main}
    assert {s.thread for k in ("feed.source", "feed.stage", "feed.handoff")
            for s in spans[k]} == {main}


def test_compiled_step_spans_on_the_cpu():
    trainer = Trainer(WavBEST(CHANNELS, device="cpu", seed=0),
                      NoiseSchedule.create("cosine", 100), warmup_steps=1, max_iter=10, seed=3)
    state = trainer.init_state()
    step = trainer.compiled_step()
    rng = np.random.default_rng(0)
    batch = {k: rng.uniform(0, 1, (2, c, 16, 16)).astype(np.float32)
             for k, c in (("Res", 4), ("PAN", 1), ("MS", 4))}
    table, index, _ = load_prompt_table()
    with profiling.recording():
        for _ in range(2):
            state, _ = step(state, batch, np.asarray(table[index["QB"]], np.float32))
    spans = by_name(profiling.drain())
    assert sorted(spans) == ["step.begin", "step.copy_in", "step.end"]
    assert all(len(v) == 2 for v in spans.values())
    for k in range(2):
        copy_in, begin, end = (sorted(spans[n], key=lambda s: s.start)[k]
                               for n in ("step.copy_in", "step.begin", "step.end"))
        assert copy_in.end <= begin.start and begin.end <= end.start
