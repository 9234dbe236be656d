"""Whole runs of each cell's mix on the CPU at a test size, past the look
for a card: a sound run comes out correct, and a run with the timed path
broken underneath comes out not correct, once for each fault the cell can
have (an answer altered where it is produced, a sampler step that returns
its state unchanged; a training step that returns its state unchanged,
half of the batch left out of the loss, an EMA left unchanged or moved at
another decay)."""
import time

import numpy as np
import pytest
import torch

from portbench import run, serve, spec, train

torch.set_num_threads(2)
CPU = torch.device("cpu")


def small(name, **traffic):
    cell = spec.load(name)
    cell.config["model"]["channel_multiplier"] = [8, 8, 16, 16]
    cell.traffic.update(traffic)
    return cell


def serve_run(name, alter=None):
    cell = small(name, size=16, pool=3, rate_per_s=6.0)
    cell.check["sample"] = 4
    record, check, peak = serve.run(cell, 2**31 + 41, 1.0, False, CPU, time.perf_counter(),
                                    alter)
    return run.result_line(cell, record, check, peak, False, 0, len(record.requests), "cpu")


def train_run(fault=None):
    cell = small("wavbest-fp32.train-joint", size=16, pool=16, warm_steps=4)
    # a decay whose change after a few warm-up steps lies above float32's
    # resolution at this size
    cell.config["train"]["ema_decay"] = 0.9
    record, check, peak = train.run(cell, 2**31 + 43, 0.5, False, CPU, time.perf_counter(),
                                    fault)
    return run.result_line(cell, record, check, peak, False, record.failed, len(record.steps),
                           "cpu")


def altered(out):
    out = np.array(out)
    out[0] += 0.2
    return out


@pytest.mark.parametrize("name", ["wavbest-bf16.serve-lowlatency", "wavbest-bf16.serve-quality"])
def test_serve_sound_and_faults(name, monkeypatch):
    sound = serve_run(name)
    assert sound["correct"], sound["check"]
    assert sound["attempted"] == 6 and sound["failed"] == 0
    assert not serve_run(name, alter=altered)["correct"]
    from tmdiff_tpu_torch.diffusion import gaussian

    monkeypatch.setattr(gaussian, "ddim_jump", lambda ns, x_t, x0, t, s: x_t)
    frozen = serve_run(name)
    assert not frozen["correct"] and frozen["check"]["image_gap"]["value"] > 0.5


def test_train_sound_run():
    out = train_run()
    assert out["correct"], out["check"]
    assert out["check"]["loss_gap"]["value"] < 1e-5


def test_train_step_that_returns_its_state_unchanged():
    def frozen(trainer):
        trainer._update = lambda state: torch.zeros((), device=trainer.device)

    out = train_run(frozen)
    assert not out["correct"]
    assert out["check"]["grad_gap"]["value"] == pytest.approx(1.0)
    assert out["check"]["change_gap"]["value"] == pytest.approx(1.0)


def test_train_half_batch_left_out():
    def half(trainer):
        loss = trainer.loss
        trainer.loss = lambda step, batch, prompt, *a, **kw: loss(
            step, {k: v[:len(v) // 2] for k, v in batch.items()}, prompt, *a, **kw)

    out = train_run(half)
    assert not out["correct"]


@pytest.mark.parametrize("decay,gap", [(1.0, 1.0), (0.99, 0.9)])
def test_train_ema_left_unchanged_or_at_another_decay(decay, gap):
    def ema(trainer):
        trainer.ema_decay = decay

    out = train_run(ema)
    assert not out["correct"]
    assert out["check"]["ema_gap"]["value"] == pytest.approx(gap, rel=1e-2)
    assert out["check"]["grad_gap"]["value"] < 1e-3

