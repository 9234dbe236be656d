"""The ControlNet family's cell (`controlnet-bf16.serve-hint`) on the CPU: at
a tiny width it runs correct through the harness's `serve.py` and the
port's InferenceEngine, and with the program's control residuals dropped
(the fault its limit is set against) it fails; the library convs' work
counts (`families/controlnet.py::LibConvWork`) equal a brute-force count of
the products that meet the input; the plain reference runs on the meta
device; and a checkout without the family's file refuses the cell at once
in `spec.load`."""
import json
import os
import shutil
import time

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from portbench import counts, inputs, run, serve, spec

torch.set_num_threads(2)
CPU = torch.device("cpu")
CELL = "controlnet-bf16.serve-hint"
SEED = 2**31 + 91


def small(cell):
    cell.config["model"]["channel_multiplier"] = [8, 8, 16, 16]
    cell.traffic.update(size=16, pool=3, rate_per_s=4.0)
    cell.traffic["engine"] = {**cell.traffic["engine"], "max_batch": 4, "steps": 3}
    cell.check["sample"] = 3
    return cell


def serve_run(cell):
    record, check, peak = serve.run(cell, SEED, 1.0, False, CPU, time.perf_counter())
    return run.result_line(cell, record, check, peak, False, 0, len(record.requests), "cpu")


def test_the_cell_runs_correct_and_a_dropped_control_fails(monkeypatch):
    cell = small(spec.load(CELL))
    line = serve_run(cell)
    assert line["correct"] and line["attempted"] == 4, line["check"]
    assert line["check"]["unanswered"]["value"] == 0
    build = cell.family.build

    def dropped(model, weights, device):
        net = build(model, weights, device)
        net.control_scales = (0.0,) * 5
        return net

    monkeypatch.setattr(cell.family, "build", dropped)
    faulty = serve_run(cell)
    gap = faulty["check"]["image_gap"]
    assert not faulty["correct"] and gap["value"] > gap["limit"]


def products(kind, x, w):
    """The multiply-adds of a conv of ones by ones, counted by the conv."""
    ones_x, ones_w = torch.ones_like(x), torch.ones_like(w)
    if kind == "transposed":
        y = F.conv_transpose3d(ones_x, ones_w, stride=(1, 2, 2), padding=(1, 0, 0),
                               output_padding=(0, 1, 1))
    elif kind == "strided":
        y = F.conv3d(ones_x, ones_w, stride=(1, 2, 2), padding=(1, 0, 0))
    else:
        y = F.conv3d(ones_x, ones_w, padding=(0, 1, 1))
    return int(y.sum())


@pytest.mark.parametrize("kind,x,w", [  # x (B, Cin, D, H, W), w in the reference's layout
    ("strided", (2, 3, 8, 40, 40), (5, 3, 3, 3, 3)),
    ("strided", (1, 2, 4, 13, 10), (3, 2, 3, 3, 3)),
    ("transposed", (2, 3, 8, 31, 31), (3, 4, 3, 3, 3)),
    ("transposed", (1, 2, 4, 7, 12), (2, 3, 3, 3, 3)),
    ("hint", (2, 3, 1, 40, 33), (16, 3, 1, 3, 3)),
    ("hint", (3, 16, 1, 9, 11), (32, 16, 1, 3, 3)),
])
def test_library_conv_work_equals_a_brute_force_count(kind, x, w):
    cell = spec.load(CELL)
    work = cell.family.LibConvWork(2)
    xs, ws = torch.empty(x), torch.empty(w)
    work(kind, xs, ws)
    assert work.flops == 2 * products(kind, xs, ws) and work.convs == 1
    if kind == "transposed":
        out = F.conv_transpose3d(xs, ws, stride=(1, 2, 2), padding=(1, 0, 0),
                                 output_padding=(0, 1, 1))
    else:
        out = F.conv3d(xs, ws, **(dict(stride=(1, 2, 2), padding=(1, 0, 0))
                                   if kind == "strided" else dict(padding=(0, 1, 1))))
    cout = w[1] if kind == "transposed" else w[0]
    assert work.bytes == 2 * (xs.numel() + ws.numel() + cout + out.numel())
    work("conv3", xs, ws)
    work("zero", xs, ws)
    assert work.convs == 1  # K1's and the zero convs' work is not the library's


def test_the_reference_runs_on_the_meta_device():
    """The cell's counts at full size: the reference on the meta device,
    each row's stems routed by its task id on the host."""
    cell = spec.load(CELL)
    m, t = cell.config["model"], cell.traffic
    work = cell.family.libconv_work(m, t, 8, 2)
    # a step: 9 strided (the condition, the x and the control encoders) and 3
    # transposed; once a batch the hint trunk's 4 and 3 stems a task present
    tasks = len({int(cell.family.request_extra(t, 0, i)["task"]) for i in range(8)})
    assert work["libconv_convs"] == 12 * t["engine"]["steps"] + 4 + 3 * tasks
    assert work["libconv_flops"] > 0 and work["libconv_bytes"] > 0
    got = counts.serve_batch(cell.family, m, t, 8, 2)
    assert got["k1_convs"] == 35 * t["engine"]["steps"]
    assert got["model_flops"] > got["k1_flops"] + work["libconv_flops"]


def test_a_checkout_without_the_family_refuses_the_cell(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(spec.ROOT, "portbench"), root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(os.path.join(spec.ROOT, "BENCHMARK.json"), root / "BENCHMARK.json")
    assert spec.load(CELL, str(root)).name == CELL
    os.remove(root / "portbench" / "families" / "controlnet.py")
    with pytest.raises(ValueError, match="no portbench/families/controlnet.py"):
        spec.load(CELL, str(root))


def test_request_extras_are_drawn_from_the_seed():
    cell = spec.load(CELL)
    t = cell.traffic
    a, b = (cell.family.request_extra(t, SEED, 3) for _ in range(2))
    assert a["hint"].shape == (t["size"], t["size"], 3) and a["hint"].dtype == np.float32
    assert np.array_equal(a["hint"], b["hint"]) and a["task"] == b["task"]
    assert 0 <= a["hint"].min() and a["hint"].max() < 1
    tasks = {int(cell.family.request_extra(t, SEED, i)["task"]) for i in range(200)}
    assert tasks == set(range(13))
    stacked = inputs.stack([cell.family.request_extra(t, SEED, i) for i in range(3)])
    assert stacked["hint"].shape == (3, t["size"], t["size"], 3)
    assert json.load(open(os.path.join(spec.ROOT, "portbench", "configs",
                                       "controlnet-bf16.json")))["reduced"] == []
