"""The readers of the program's spans (portbench/spans.py and the
metrics it lists) on records made by hand, and whole CPU runs of a serve
and the train mix at a test size through `spans.run_cell`, with the
program's recorder on and off."""
import pytest
import torch

from portbench import spans, spec
from portbench.record import Record
from portbench.trace import Kernels
from tmdiff_tpu_torch.utils.profiling import Span

torch.set_num_threads(2)
CPU = torch.device("cpu")
SERVE = "wavbest-bf16.serve-quality"
TRAIN = "wavbest-fp32.train-joint"
MS = 1_000_000
WORKER, CLIENT = 7, 9


def read(cell, name, record):
    return cell.reader(name).read(record)


class Made:
    """Spans made by hand, ids in order."""

    def __init__(self):
        self.spans = []

    def add(self, name, start_ms, end_ms, parent=None, thread=WORKER, **attrs):
        s = Span(name, int(start_ms * MS), int(end_ms * MS), len(self.spans) + 1,
                 0 if parent is None else parent.id, thread, attrs)
        self.spans.append(s)
        return s


def batch(made, k, t0, requests):
    """One batch on the worker from t0 ms: collect 5 ms, assemble 1, sample
    20 (two denoise calls of 2 and 4 ms), resolve 1; `requests` submitted
    at the given ms."""
    made.add("engine.collect", t0, t0 + 5, batch=k, n=len(requests))
    made.add("engine.assemble", t0 + 5, t0 + 6)
    sample = made.add("engine.sample", t0 + 6, t0 + 26, batch=k, bucket=len(requests))
    loop = made.add("sample.loop", t0 + 8, t0 + 24, parent=sample)
    made.add("sample.denoise", t0 + 9, t0 + 11, parent=loop, kind="deep")
    made.add("sample.denoise", t0 + 12, t0 + 16, parent=loop, kind="reuse")
    made.add("engine.resolve", t0 + 26, t0 + 27)
    for at in requests:
        made.add("engine.request", at, t0 + 27, thread=CLIENT, batch=k,
                 sampled_ns=sample.start)


def serve_record():
    """A 100 ms window: batch 0 inside it (requests at 0 and 2 ms), batch 1
    past its close (a request at 90 ms); the device busy from 6 to 16 ms."""
    cell = spec.load(SERVE)
    rec = Record(cell, 1.0, start=0, end=100 * MS)
    made = Made()
    made.add("engine.wait", -5, 0)
    batch(made, 0, 0, [0, 2])
    made.add("engine.wait", 27, 90)
    batch(made, 1, 90, [90])
    rec.program_spans = made.spans
    rec.kernels = Kernels.of([("k", 6 * MS, 16 * MS)])
    return cell, rec


def test_serve_readers():
    cell, rec = serve_record()
    # waits 6 and 4 ms to the sampler's start: p90 of [4, 6]
    assert read(cell, "engine.queue_wait_ms.serve", rec) == pytest.approx(5.8)
    assert read(cell, "engine.collect_ms.serve", rec) == pytest.approx(5.0)
    assert read(cell, "sample.launch_ms.serve", rec) == pytest.approx(3.0)
    # the worker inside collect, assemble, sample or resolve for 27 ms of
    # the window and for 10 more past 90 ms, the device busy 10 of them
    assert read(cell, "device.idle_host.serve", rec) == pytest.approx(100 * 27 / 100)


def test_idle_host_reads_the_device_trace():
    cell, rec = serve_record()
    rec.kernels = None
    assert read(cell, "device.idle_host.serve", rec) is None
    assert spans.busy_within(Kernels.of([("a", 0, 4), ("b", 2, 6), ("c", 8, 12)]), 1, 11,
                             [(0, 3), (5, 9), (10, 20)]) == pytest.approx(5e-9)


def test_train_readers():
    cell = spec.load(TRAIN)
    rec = Record(cell, 1.0, start=0, end=100 * MS)
    rec.steps = [8, 4]
    made = Made()
    for t0 in (0, 50, 150):  # the last past the window's close
        made.add("feed.handoff", t0, t0 + 1)
        made.add("feed.source", t0 + 1, t0 + 4)
        made.add("feed.stage", t0 + 4, t0 + 6)
        made.add("step.copy_in", t0 + 10, t0 + 11)
        made.add("step.begin", t0 + 11, t0 + 13)
        made.add("step.replay", t0 + 13, t0 + 20)
        made.add("step.end", t0 + 20, t0 + 21)
    made.add("feed.produce", 1, 30, thread=CLIENT)
    rec.program_spans = made.spans
    assert read(cell, "feed.source_wait_ms.train", rec) == pytest.approx(3.0)
    assert read(cell, "feed.stage_ms.train", rec) == pytest.approx(3.0)
    assert read(cell, "step.host_ms.train", rec) == pytest.approx(4.0)


def test_readers_of_a_run_without_program_spans_return_nothing():
    cell, rec = serve_record()
    del rec.program_spans
    for name in spans.PROGRAM_METRICS["serve"]:
        assert read(cell, name, rec) is None
    cell = spec.load(TRAIN)
    rec = Record(cell, 1.0, start=0, end=100 * MS)
    rec.steps = [8]
    for name in spans.PROGRAM_METRICS["train"]:
        assert read(cell, name, rec) is None


def small(name, **traffic):
    cell = spec.load(name)
    cell.config["model"]["channel_multiplier"] = [8, 8, 16, 16]
    cell.traffic.update(traffic)
    return cell


@pytest.mark.parametrize("record_spans", [True, False])
def test_cpu_runs_read_the_programs_spans(record_spans):
    cell = small("wavbest-bf16.serve-lowlatency", size=16, pool=3, rate_per_s=6.0)
    cell.check["sample"] = 4
    record, check, _ = spans.run_cell(cell, 2**31 + 41, 1.0, CPU, record_spans, traced=False)
    assert all(v <= lim for v, lim in check.values()), check
    got = spans.program_readings(cell, record)
    if record_spans:
        assert set(got["program"]) == set(spans.PROGRAM_METRICS["serve"]) - {
            "device.idle_host.serve"}
        assert got["spans"] > 0 and got["built_in_window"] == {"conv3d.plan": 0,
                                                               "step.capture": 0}
        count, mean_ms = got["host_ms"]["engine.sample"]
        assert count > 0 and mean_ms > 0
    else:
        assert got["program"] == {} and got["spans"] == 0 and got["host_ms"] == {}
    cell = small(TRAIN, size=16, pool=16, warm_steps=4)
    cell.config["train"]["ema_decay"] = 0.9
    record, check, _ = spans.run_cell(cell, 2**31 + 43, 0.5, CPU, record_spans, traced=False)
    got = spans.program_readings(cell, record)
    assert all(v <= lim for v, lim in check.values()), check
    want = set(spans.PROGRAM_METRICS["train"]) if record_spans else set()
    assert set(got["program"]) == want
