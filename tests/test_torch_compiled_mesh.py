"""Trainer.compiled_step over the port's mesh on the CPU (train/trainer.py on
parallel/mesh.py), where every rank runs the step body uncaptured, as one
CPU process does; the card's captured step is held by
tests/test_torch_cuda.py and chip_smoke.py's mesh phase.

  * on a (2, 2) gloo world, compiled steps against `train_step`s from the
    same start, bit for bit on every rank: losses, parameters, AdamW's
    moments, step counts and lr, the EMA, the step count; in fp32 and bf16,
    and for a DistillTrainer on (1, 2);
  * the compiled meshed step with the JAX trainer's t and noise, dropout
    off, against the JAX Trainer's jitted step on its 8-device (4, 2) mesh:
    the losses within rtol 1e-5, step 0's all-reduced gradients within 1e-5
    of their scale and the parameters after the last step within atol
    5e-3, rtol 2e-3 (tests/test_torch_mesh_train.py's bars). At 32x32: at
    16x16 the JAX Trainer's own (4, 2) gradients are not its single
    device's (up to 6.3 of their scale off, where its (8, 1) mesh's are
    equal; the deepest level's two rows over two space devices), a fault of
    the reference that its loss does not show;
  * whether a call captures is agreed by every rank: a state that looks new
    on one rank (its fingerprint stubbed) makes every rank build a new
    entry at that call;
  * the CLI under torchrun on two CPU ranks steps through compiled_step
    (its log says so) and writes the checkpoint the same run through
    train_step writes, bit for bit.

Worlds are spawned by parallel/dryrun.py (torchrun for the CLI) and run
tests/torch_mesh_workers.py (torch and the port only), in the background
while the JAX trainer runs here. Widths (4, 8, 8, 16), 16x16 (32x32
against JAX), batch 8.
"""
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import flax.linen as flax_nn
import jax
import numpy as np
import optax
import pytest
import torch

from flax_params import random_flax_params
from test_torch_mesh_train import (GRAD_RTOL, LOSS_RTOL, PARAM_ATOL, PARAM_RTOL, _batches,
                                   _config, _jax_draws, _NoDropout, _rel_to_scale)
from tmdiff_tpu.diffusion.schedules import NoiseSchedule as JaxNoiseSchedule
from tmdiff_tpu.models import WavBEST as JaxWavBEST
from tmdiff_tpu.parallel import make_mesh as jax_make_mesh
from tmdiff_tpu.train.trainer import Trainer as JaxTrainer
from tmdiff_tpu_torch.models.clip_text import load_prompt_table
from tmdiff_tpu_torch.models.wavbest import WavBEST
from tmdiff_tpu_torch.parallel.dryrun import run_world
from tmdiff_tpu_torch.train import checkpoint as ckpt_lib
from tmdiff_tpu_torch.utils.weights import from_flax

torch.set_num_threads(2)

TESTS = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(TESTS)
CHANNELS = (4, 8, 8, 16)
N_STEPS = 3
DISTILL = {"distill_n": 5}
JAX_DRAWS = {"dropout": False, "compiled": True}
# rank 1 sees its state as new from its third call on
STUB = {"compiled": True, "stub_fingerprint": (1, 2)}
CLI_STEPS = 2
JAX_SIZE = 32


@pytest.fixture(scope="module")
def carried():
    jmodel = JaxWavBEST(channels=CHANNELS)
    params = random_flax_params(jmodel, seed=11)
    port = from_flax(WavBEST(CHANNELS, device="cpu"), jax.tree.map(np.asarray, params))
    state = {k: v.numpy() for k, v in port.state_dict().items()}
    table, index, _ = load_prompt_table()
    return jmodel, params, state, _batches(N_STEPS), np.asarray(table[index["WV3"]], np.float32)


def _cli_config(root, name):
    cfg, exp = _config(root, name)
    opt = json.loads(open(cfg).read())
    opt["train"].update(max_iter=CLI_STEPS, val_freq=1000)
    open(cfg, "w").write(json.dumps(opt))
    return cfg, exp


def _argv(cfg):
    return ["-c", cfg, "-p", "train", "--device", "cpu", "--sampler", "regression"]


@pytest.fixture(scope="module")
def worlds(carried, tmp_path_factory):
    """The worlds, started together in the background: (2, 2) with compiled
    and eager steps in fp32 and bf16 (dropout and remat on), compiled steps
    with JAX's draws (dropout off) and compiled steps with rank 1's
    fingerprint stubbed; (1, 2) with compiled and eager distillation steps;
    the CLI under torchrun (compiled) and in a 2-rank world with its loop's
    step set to train_step."""
    _, _, state, batches, prompt = carried
    args = ((2, 2), state, batches, prompt)
    tasks4 = [("train", args, {"compiled": True}), ("train", args, {}),
              ("train", args, {"compiled": True, "dtype": "bfloat16"}),
              ("train", args, {"dtype": "bfloat16"}),
              ("train", ((2, 2), state, _batches(2, size=JAX_SIZE), prompt),
               dict(JAX_DRAWS, draws=_jax_draws(_batches(2, size=JAX_SIZE)))),
              ("train", args, STUB)]
    d_args = ((1, 2), state, batches[:2], prompt)
    tasks2 = [("train", d_args, dict(DISTILL, compiled=True)), ("train", d_args, DISTILL)]
    root = tmp_path_factory.mktemp("cli")
    compiled_cfg, compiled_exp = _cli_config(root, "compiled")
    eager_cfg, eager_exp = _cli_config(root, "eager")
    env = {**os.environ, "PYTHONPATH": ROOT, "OMP_NUM_THREADS": "1"}
    torchrun = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "2",
         "-m", "tmdiff_tpu_torch.cli", *_argv(compiled_cfg)],
        cwd=root, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        with ThreadPoolExecutor(3) as pool:
            run = lambda n, target, *a: pool.submit(run_world, target, n, *a, sys_path=[TESTS],
                                                    threads=1, timeout=300)
            yield {4: run(4, "torch_mesh_workers:run_all", (tasks4,)),
                   2: run(2, "torch_mesh_workers:run_all", (tasks2,)),
                   "cli_eager": run(2, "torch_mesh_workers:cli_main", (_argv(eager_cfg), True)),
                   "cli": (torchrun, compiled_exp, eager_exp)}
    finally:
        torchrun.kill()
        torchrun.wait()


@pytest.fixture(scope="module")
def jax_run(carried):
    """The JAX Trainer's steps on its (4, 2) mesh, dropout off, the port's
    weights (from_flax) and hyperparameters (remat off there: recomputing
    changes no value): the losses, step 0's gradients and the parameters
    after the last step, under the port's names. The step reports
    `optax.global_norm(grads)`; with it patched to the identity the jitted
    step returns the gradient tree itself."""
    jmodel, params, _, _, prompt = carried
    with pytest.MonkeyPatch.context() as m:
        m.setattr(flax_nn, "Dropout", _NoDropout)
        m.setattr(optax, "global_norm", lambda tree: tree)
        trainer = JaxTrainer(model=jmodel, schedule=JaxNoiseSchedule.create("cosine", 1000),
                             lr=2e-3, warmup_steps=2, max_iter=1000,
                             mesh=jax_make_mesh(data=4, space=2), remat=False)
        state, losses, grads = trainer.state_from_params(params), [], None
        for batch in _batches(2, size=JAX_SIZE):
            state, metrics = trainer.train_step(state, batch, prompt)
            losses.append(float(metrics["l_pix"]))
            if grads is None:
                grads = jax.tree.map(np.asarray, metrics["grad_norm"])
    as_port = lambda tree: {k: v.numpy() for k, v in from_flax(
        WavBEST(CHANNELS, device="cpu"), tree).state_dict().items()}
    return {"losses": losses, "grads": as_port(grads),
            "params": as_port(jax.tree.map(np.asarray, state.params))}


# JAX's trainer runs while the worlds do
@pytest.fixture(scope="module")
def world4(worlds, jax_run):
    return worlds[4].result()


def _assert_same(a, b):
    """Two runs of the worker's `train` equal bit for bit."""
    assert a["losses"] == b["losses"]
    assert (a["step"], a["lr"], a["adamw_steps"]) == (b["step"], b["lr"], b["adamw_steps"])
    for name, p in a["params"].items():
        np.testing.assert_array_equal(p, b["params"][name], err_msg=name)
    for name, g in a["grads"].items():
        np.testing.assert_array_equal(g, b["grads"][name], err_msg=name)
    np.testing.assert_array_equal(a["ema"], b["ema"])
    assert len(a["moments"]) == len(b["moments"])
    for x, y in zip(a["moments"], b["moments"]):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_compiled_steps_equal_train_steps_on_the_mesh(world4, dtype):
    """N_STEPS compiled steps on (2, 2) against N_STEPS train_steps, on every
    rank, bit for bit; one entry built at the first call, none after; the
    vote and the all-reduce are the two collectives of a compiled step."""
    first = 0 if dtype == "float32" else 2
    for rank in world4:
        compiled, eager = rank[first], rank[first + 1]
        _assert_same(compiled, eager)
        assert compiled["fresh"] == [True] + [False] * (N_STEPS - 1)
        assert compiled["captures"] == 0  # nothing is captured on the CPU
        assert (compiled["stats"]["collectives"], eager["stats"]["collectives"]) == (2, 1)
        assert compiled["stats"]["exchanges"] == eager["stats"]["exchanges"] > 0
    for rank in world4[1:]:
        _assert_same(rank[first], world4[0][first])


def test_compiled_meshed_step_matches_the_jax_mesh(world4, jax_run):
    """The compiled step on (2, 2) with the JAX trainer's t and noise,
    dropout off, against the JAX Trainer's jitted step on its (4, 2) mesh:
    the bars of the module doc."""
    for rank in world4:
        got = rank[4]
        np.testing.assert_allclose(got["losses"], jax_run["losses"], rtol=LOSS_RTOL)
        for name, g in jax_run["grads"].items():
            assert _rel_to_scale(got["grads"][name], g) <= GRAD_RTOL, name
        for name, p in jax_run["params"].items():
            np.testing.assert_allclose(got["params"][name], p, atol=PARAM_ATOL,
                                       rtol=PARAM_RTOL, err_msg=name)


def test_capture_decision_is_agreed_by_every_rank(world4):
    """Rank 1's fingerprint is stubbed to change from its third call on:
    every rank builds a new entry at that call (on a card: the eager step
    and a capture), none at the second; the steps stay those of the
    unstubbed compiled run, bit for bit."""
    for rank in world4:
        assert rank[5]["fresh"] == [True, False, True]
        _assert_same(rank[5], rank[0])


def test_compiled_distill_steps_on_space_mesh(worlds):
    """Two compiled DistillTrainer steps (N = 5, the teacher's weights as
    the static `extra`) on (1, 2) against two train_steps, bit for bit on
    both ranks."""
    for rank in worlds[2].result():
        _assert_same(rank[0], rank[1])
        assert rank[0]["fresh"] == [True, False]


def test_cli_under_torchrun_steps_through_compiled_step(worlds):
    """-p train on two CPU ranks under torchrun, CLI_STEPS steps: the log
    says each step runs compiled_step, uncaptured on the CPU; the final
    checkpoint equals, bit for bit, the one the same run writes when its
    loop's step is train_step."""
    worlds["cli_eager"].result()
    proc, compiled_exp, eager_exp = worlds["cli"]
    out, err = proc.communicate(timeout=300)
    assert proc.returncode == 0, out[-3000:] + err[-3000:]
    log = (compiled_exp / "logs" / "train.log").read_text()
    assert "mesh of 2 ranks: each step runs compiled_step (uncaptured on the CPU)" in log
    assert "runs train_step" not in log
    assert "each step runs train_step" in (eager_exp / "logs" / "train.log").read_text()
    path = lambda exp: str(exp / "checkpoint" / f"I{CLI_STEPS}" / ckpt_lib.STATE_FILE)
    got, want = (torch.load(path(e), weights_only=True) for e in (compiled_exp, eager_exp))
    assert got["step"] == want["step"] == CLI_STEPS
    for name, p in want["model"].items():
        assert torch.equal(got["model"][name], p), name
    for a, b in zip(got["ema_params"], want["ema_params"]):
        assert torch.equal(a, b)
    for st_a, st_b in zip(got["optimizer"]["state"].values(),
                          want["optimizer"]["state"].values()):
        for k in st_b:
            assert torch.equal(st_a[k], st_b[k]), k
