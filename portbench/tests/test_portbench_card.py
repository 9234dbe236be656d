"""On the card (marked `cuda`, skipped without one): a run of each one-card
cell at its own sizes and for BENCHMARK.json's `run_seconds`, as the
benchmark runs it, comes out correct, and each cell's control reads past
its limit. (A window of a few seconds is too short for `train-joint`'s EMA
check: after some 30 steps the EMA's change lies a few float32 steps from
its base-1 biases, and `ema_gap` reads 0.4.)"""
import json
import os
import subprocess
import sys

import pytest

from portbench import control, spec

SECONDS = json.load(open(os.path.join(spec.ROOT, "BENCHMARK.json")))["run_seconds"]

CELLS = ["wavbest-bf16.serve-quality", "wavbest-fp32.train-joint",
         "wavbest-bf16.serve-lowlatency"]


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_short_run_is_correct(card, name):
    proc = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", name, "--seed",
                           "2147483999", "--seconds", str(SECONDS), "--trace", "0"],
                          cwd=spec.ROOT, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert '"correct": true' in proc.stdout.splitlines()[-1]


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_the_limit(card, name):
    cell = spec.load(name)
    if cell.traffic["kind"] == "serve":
        got = control.serve_readings(cell, 2147483998, card)
        assert got["control_image_gap"] > cell.check["limits"]["image_gap"]
    else:
        got = control.train_readings(cell, 2147483998, card)
        assert any(got[f"control_{k}"] > v for k, v in cell.check["limits"].items())
