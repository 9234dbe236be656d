"""The metric arithmetic, on records made by hand: p90 over every request
from its due time with failures counted, the window's rate, union idle,
rooflines and MFU from counts, each read through the metric's own file."""
import json
import math
import statistics

import numpy as np
import pytest

from portbench import arith, spec
from portbench.record import Record
from portbench.trace import Kernels, Spans, breakdown

SERVE = "wavbest-bf16.serve-quality"
TRAIN = "wavbest-fp32.train-joint"
MS = 1_000_000


def read(cell, name, record):
    return cell.reader(name).read(record)


def test_percentile_is_numpys_linear_one():
    xs = list(np.random.default_rng(0).random(137))
    for q in (50, 90, 95):
        assert arith.percentile(xs, q) == pytest.approx(np.percentile(xs, q))


def test_percentile_counts_a_failure_as_slowest():
    xs = [1.0] * 95 + [math.inf] * 5
    assert arith.percentile(xs, 90) == 1.0
    assert arith.percentile([1.0] * 5 + [math.inf] * 5, 90) == math.inf


def serve_record(lat_ms, failed=0, window_s=10.0, served_late=0):
    cell = spec.load(SERVE)
    rec = Record(cell, 12.5, start=0, end=int(window_s * 1e9))
    due = np.linspace(0, window_s * 1e9, len(lat_ms), endpoint=False)
    rec.requests = [{"due": int(d), "done": int(d + lat * MS), "ok": True}
                    for d, lat in zip(due, lat_ms)]
    rec.requests += [{"due": 0, "done": None, "ok": False} for _ in range(failed)]
    return cell, rec


def test_serve_p90_is_over_every_request_from_its_due_time():
    lat = list(range(1, 101))  # ms
    cell, rec = serve_record(lat)
    assert read(cell, "serve_p90_ms", rec) == pytest.approx(np.percentile(lat, 90))
    cell, rec = serve_record(lat[:90], failed=10)
    # ten failures among 100: the 90th percentile reaches past every served one
    assert read(cell, "serve_p90_ms", rec) == pytest.approx(1e9)
    cell, rec = serve_record(lat[:95], failed=5)
    assert read(cell, "serve_p90_ms", rec) == pytest.approx(np.percentile(lat[:95] + [1e12] * 5,
                                                                          90))


def test_setup_s_is_the_time_before_the_window():
    cell, rec = serve_record([100.0] * 50, window_s=10.0)
    assert read(cell, "setup_s", rec) == 12.5


def test_batch_fill_and_sample_span():
    cell, rec = serve_record([1.0])
    rec.engine_delta = {"requests": 30, "padded_slots": 10, "batches": 6}
    assert read(cell, "engine.batch_fill.serve", rec) == pytest.approx(75.0)
    rec.batches = [{"start": 0, "end": 400 * MS, "bucket": 8},
                   {"start": 500 * MS, "end": 700 * MS, "bucket": 4},
                   {"start": 9900 * MS, "end": 10100 * MS, "bucket": 2}]  # ends past the close
    assert read(cell, "sample.batch_ms.serve", rec) == pytest.approx(300.0)


def test_union_idle_counts_overlapping_kernels_once():
    ops = [("a", 0, 4), ("b", 2, 6), ("c", 8, 9), ("d", 12, 20), ("a", 3, 5)]
    kernels = Kernels.of(ops)
    assert kernels.busy_seconds(0, 10) == pytest.approx(7e-9)
    assert kernels.gaps(0, 10) == [(6, 8), (9, 10)]
    assert kernels.by_name(0, 10) == pytest.approx({"a": 6e-9, "b": 4e-9, "c": 1e-9})
    assert kernels.busy_seconds(13, 15) == pytest.approx(2e-9)
    assert kernels.gaps(21, 30) == [(21, 30)]
    cell, rec = serve_record([1.0], window_s=1e-8)
    rec.kernels = kernels
    assert read(cell, "device.idle.serve", rec) == pytest.approx(30.0)


def test_breakdown_names_the_host_span_under_each_gap():
    spans = Spans()
    spans.add("sample", 0, 7)
    out = breakdown(Kernels.of([("k1", 0, 4), ("k2", 5, 9)]), spans, 0, 12, ["sample"])
    assert out["device_ops"] == [["k1", 4e-9], ["k2", 4e-9]]
    assert out["idle_gaps"] == [["no span", 3e-9], ["sample", 1e-9]]


def test_roofline_and_mfu_from_counts():
    cell, rec = serve_record([1.0], window_s=10.0)
    work = {8: {"k1_flops": 989e12 * 0.2, "k1_bytes": 1e9, "model_flops": 989e12 * 0.5},
            4: {"k1_flops": 1.0, "k1_bytes": 3.35e12 * 0.05, "model_flops": 989e12 * 0.1}}
    rec.serve_work = work.__getitem__
    rec.batches = [{"start": 0, "end": 2000 * MS, "bucket": 8},
                   {"start": 3000 * MS, "end": 4000 * MS, "bucket": 4}]
    # K1 kernels 0.5 s in the first batch, 0.25 s in the second; others not counted
    rec.kernels = Kernels.of([("conv_3x3_bf16_kernel<3,64,64>", 0, 500 * MS),
                              ("elementwise", 600 * MS, 900 * MS),
                              ("conv_3x3_splitk_reduce", 3000 * MS, 3250 * MS)])
    # least time 0.2 s (compute-bound) + 0.05 s (bandwidth-bound) over 0.75 s
    assert read(cell, "k1_roofline.serve", rec) == pytest.approx(100 * 0.25 / 0.75)
    # 0.6 peak-seconds of model work over 3 s of sampler spans
    assert read(cell, "mfu.serve", rec) == pytest.approx(100 * 0.6 / 3.0)


def test_train_metrics():
    cell = spec.load(TRAIN)
    rec = Record(cell, 20.0, start=0, end=int(3e9))
    rec.steps = [8, 4, 8, 4, 4, 8]
    work = {8: {"k1_flops": 495e12 * 0.01, "k1_bytes": 0.0, "model_flops": 495e12 * 0.02},
            4: {"k1_flops": 495e12 * 0.005, "k1_bytes": 0.0, "model_flops": 495e12 * 0.01}}
    rec.train_work = work.__getitem__
    rec.kernels = Kernels.of([("conv_3x3_tf32x3_kernel", 0, int(0.3e9)),
                              ("wgrad", int(0.3e9), int(1e9))])
    rec.spans.add("feed", 0, 2 * MS)
    rec.spans.add("feed", 10 * MS, 11 * MS)
    assert read(cell, "train_step_s", rec) == pytest.approx(0.5)
    assert read(cell, "k1_roofline.train", rec) == pytest.approx(100 * 0.045 / 0.3)
    assert read(cell, "mfu.train", rec) == pytest.approx(100 * 0.09 / 3.0)
    assert read(cell, "train.feed_wait_ms.train", rec) == pytest.approx(1.5)
    assert read(cell, "device.idle.train", rec) == pytest.approx(100 * (1 - 1 / 3))


def test_a_reader_with_nothing_to_read_returns_nothing():
    cell, rec = serve_record([1.0])
    for name in ("k1_roofline.serve", "device.idle.serve", "sample.batch_ms.serve",
                 "mfu.serve"):
        assert read(cell, name, rec) is None
    cell = spec.load(TRAIN)
    rec = Record(cell, 1.0, start=0, end=1)
    for name in ("k1_roofline.train", "mfu.train", "train.feed_wait_ms.train",
                 "train_step_s"):
        assert read(cell, name, rec) is None


def test_spread_is_the_quartile_distance_over_the_median():
    xs = [10.0, 10.2, 9.9, 10.1, 10.4, 9.8]
    q1, _, q3 = statistics.quantiles(xs, n=4)
    assert arith.spread(xs) == pytest.approx((q3 - q1) / statistics.median(xs))


def test_spreads_tool_reads_result_lines(tmp_path, capsys):
    from portbench import spreads

    paths = []
    for i, v in enumerate([10.0, 10.2, 9.9, 10.1, 13.0, 9.8]):
        p = tmp_path / f"run{i}.json"
        p.write_text("log line\n" + json.dumps({"correct": i != 1, "check": {},
                                                "metrics": {"m": {"value": v, "unit": "s"}}}))
        paths.append(str(p))
    spreads.main(paths)
    out = capsys.readouterr().out
    assert "run1.json: not correct" in out
    assert f"without the farthest {arith.spread([10.0, 10.2, 9.9, 10.1, 9.8])!r}" in out
