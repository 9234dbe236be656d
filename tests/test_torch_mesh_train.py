"""Training over the port's mesh on the CPU (tmdiff_tpu_torch/train on
parallel/mesh.py): Trainer.train_step on a (2, 2) gloo world against the
single-process port (dropout on, remat on) and against the JAX Trainer on
its 8-device (4, 2) mesh (JAX's t and noise injected, dropout off on both
sides); a distillation step on (1, 2); and the CLI under torchrun on two
ranks (-p train with a validation and a checkpoint, then -p val from it).
Worlds are spawned by parallel/dryrun.py and run
tests/torch_mesh_workers.py (torch and the port only). Widths (4, 8, 8,
16), 16x16, batch 8. Tolerances are stated at each check."""
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import flax.linen as flax_nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.io as scio
import torch

from tmdiff_tpu.diffusion.schedules import NoiseSchedule as JaxNoiseSchedule
from tmdiff_tpu.models import WavBEST as JaxWavBEST
from tmdiff_tpu.parallel import make_mesh as jax_make_mesh
from tmdiff_tpu.train.trainer import Trainer as JaxTrainer
from tmdiff_tpu_torch import cli
from tmdiff_tpu_torch.data.synthetic import write_h5
from tmdiff_tpu_torch.models.clip_text import load_prompt_table
from tmdiff_tpu_torch.models.wavbest import WavBEST
from tmdiff_tpu_torch.parallel.dryrun import run_world
from tmdiff_tpu_torch.train import checkpoint as ckpt_lib
from tmdiff_tpu_torch.utils.weights import from_flax
from flax_params import random_flax_params
from torch_mesh_workers import train as train_worker

torch.set_num_threads(2)

TESTS = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(TESTS)
CHANNELS = (4, 8, 8, 16)
SEED = 3407  # the trainers' default seed
# losses: the JAX test's meshed-vs-single bar (tests/test_train.py)
LOSS_RTOL = 1e-5
# step-0 gradients after the all-reduce, of each gradient's scale
GRAD_RTOL = 1e-5
# parameters after two steps: the JAX test's bars, whose reasoning
# (tests/test_train.py:190-197) holds here: Adam's 1/(sqrt(v) + eps) turns
# reassociation noise on near-zero second moments into sign flips of up to
# the lr (2e-3 here)
PARAM_ATOL, PARAM_RTOL = 5e-3, 2e-3


def _rel_to_scale(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30)


def _batches(n=2, b=8, bands=4, size=16):
    rng = np.random.default_rng(1)
    out = []
    for _ in range(n):
        ms = rng.uniform(0.1, 0.9, (b, bands, size, size)).astype(np.float32)
        pan = (ms.mean(1, keepdims=True) + 0.05 * rng.standard_normal((b, 1, size, size)))
        res = 0.1 * rng.standard_normal((b, bands, size, size))
        out.append({"Res": res.astype(np.float32), "PAN": pan.astype(np.float32), "MS": ms})
    return out


@pytest.fixture(scope="module")
def carried():
    jmodel = JaxWavBEST(channels=CHANNELS)
    params = random_flax_params(jmodel, seed=11)
    port = from_flax(WavBEST(CHANNELS, device="cpu"), jax.tree.map(np.asarray, params))
    state = {k: v.numpy() for k, v in port.state_dict().items()}
    table, index, _ = load_prompt_table()
    return jmodel, params, state, _batches(), np.asarray(table[index["WV3"]], np.float32)


def _jax_draws(batches, seed=SEED, T=1000):
    """The t and noise the JAX trainer draws at each step: fold_in(fold_in(
    key(seed), step), 0), split into t's key and the noise's."""
    t, noise = [], []
    for step, batch in enumerate(batches):
        rng = jax.random.fold_in(jax.random.fold_in(jax.random.key(seed), step), 0)
        rng_t, rng_noise = jax.random.split(rng)
        t.append(np.asarray(jax.random.randint(rng_t, (len(batch["Res"]),), 1, T + 1), np.int64))
        noise.append(np.asarray(jax.random.normal(rng_noise, batch["Res"].shape, jnp.float32)))
    return {"t": t, "noise": noise}


DISTILL = {"distill_n": 5, "dropout": True}


@pytest.fixture(scope="module")
def worlds(carried):
    """Both worlds, started together in the background: (2, 2) with two
    steps with dropout on and two with JAX's draws and dropout off; (1, 2)
    with one distillation step."""
    _, _, state, batches, prompt = carried
    tasks = [("train", ((2, 2), state, batches, prompt), {}),
             ("train", ((2, 2), state, batches, prompt),
              {"draws": _jax_draws(batches), "dropout": False})]
    with ThreadPoolExecutor(2) as pool:
        yield {4: pool.submit(run_world, "torch_mesh_workers:run_all", 4, (tasks,),
                              sys_path=[TESTS], threads=1, timeout=300),
               2: pool.submit(run_world, "torch_mesh_workers:train", 2,
                              ((1, 2), state, batches[:1], prompt), DISTILL,
                              sys_path=[TESTS], threads=1, timeout=300)}


@pytest.fixture(scope="module")
def single(carried):
    _, _, state, batches, prompt = carried
    return train_worker(None, state, batches, prompt)


class _NoDropout(flax_nn.Module):
    """flax's Dropout as the identity, for a comparison without masks."""

    rate: float = 0.0
    broadcast_dims: tuple = ()
    deterministic: bool = None

    @flax_nn.compact
    def __call__(self, x, deterministic=None, rng=None):
        return x


@pytest.fixture(scope="module")
def jax_losses(carried):
    """The JAX Trainer's two losses on its (4, 2) mesh, dropout off, the
    same weights (from_flax) and hyperparameters as the port's; remat off
    there (recomputing changes no value, and compiles slower)."""
    jmodel, params, _, batches, prompt = carried
    with pytest.MonkeyPatch.context() as m:
        m.setattr(flax_nn, "Dropout", _NoDropout)
        trainer = JaxTrainer(model=jmodel, schedule=JaxNoiseSchedule.create("cosine", 1000),
                             lr=2e-3, warmup_steps=2, max_iter=1000,
                             mesh=jax_make_mesh(data=4, space=2), remat=False)
        state = trainer.state_from_params(params)
        losses = []
        for batch in batches:
            state, metrics = trainer.train_step(state, batch, prompt)
            losses.append(float(metrics["l_pix"]))
    return losses


# the single-process and JAX references are computed while the worlds run
@pytest.fixture(scope="module")
def world4(worlds, single, jax_losses):
    return worlds[4].result()


def test_meshed_steps_match_single_process(world4, single):
    """Two steps on (2, 2), remat and dropout on (the masks drawn at the
    global shape and sharded): the losses within rtol 1e-5, every step-0
    gradient within 1e-5 of its scale, the parameters within the JAX
    test's bars, and the parameters and the EMA identical on every rank."""
    res = [r[0] for r in world4]
    np.testing.assert_allclose(res[0]["losses"], single["losses"], rtol=LOSS_RTOL)
    for name, g in single["grads"].items():
        assert _rel_to_scale(res[0]["grads"][name], g) <= GRAD_RTOL, name
    for name, p in single["params"].items():
        np.testing.assert_allclose(res[0]["params"][name], p, atol=PARAM_ATOL, rtol=PARAM_RTOL,
                                   err_msg=name)
    for r in res[1:]:
        assert r["losses"] == res[0]["losses"]
        for name, p in res[0]["params"].items():
            np.testing.assert_array_equal(r["params"][name], p, err_msg=name)
        np.testing.assert_array_equal(r["ema"], res[0]["ema"])
    # one flat all-reduce of the gradients and the loss a step
    assert res[0]["stats"]["collectives"] == 1


def test_meshed_steps_match_the_jax_mesh(world4, jax_losses):
    """The port on (2, 2) with the JAX trainer's t and noise handed to it,
    against the JAX Trainer on its (4, 2) mesh, dropout off on both sides,
    the same weights (from_flax) and hyperparameters: the losses within
    rtol 1e-5, as tests/test_train.py holds JAX's meshed run to its own."""
    for r in world4:
        np.testing.assert_allclose(r[1]["losses"], jax_losses, rtol=LOSS_RTOL)


def test_distill_step_on_space_mesh(worlds, carried):
    """One DistillTrainer step (N = 5) on (1, 2): the teacher's two calls and
    the student on halo-exchanging shards; the loss within rtol 1e-5 and
    every gradient within 1e-5 of its scale of the single-process step."""
    _, _, state, batches, prompt = carried
    want = train_worker(None, state, batches[:1], prompt, **DISTILL)
    for r in worlds[2].result():
        np.testing.assert_allclose(r["losses"], want["losses"], rtol=LOSS_RTOL)
        for name, g in want["grads"].items():
            assert _rel_to_scale(r["grads"][name], g) <= GRAD_RTOL, name


# -- the CLI under torchrun ----------------------------------------------------


def _config(root, name, **extra):
    paths = {}
    for i, sensor in enumerate(["qb", "gf2", "wv3"]):
        scale = 1023.0 if sensor == "gf2" else 2047.0
        train = root / f"train_{sensor}.h5"
        if not train.exists():
            write_h5(str(train), n=6, bands=4, size=16, seed=i, img_scale=scale)
            write_h5(str(root / f"val_{sensor}.h5"), n=2, bands=4, size=16, seed=10 + i,
                     img_scale=scale)
        paths[sensor] = (str(train), str(root / f"val_{sensor}.h5"))
    cfg = {
        "name": name,
        "path": {"log": "logs", "results": "results", "checkpoint": "checkpoint",
                 "resume": None, "experiments_root": str(root / name)},
        "datasets": {
            **{f"train_{s}": {"dataroot": paths[s][0], "batch_size": 2, "use_shuffle": True,
                              "data_len": -1} for s in paths},
            **{f"val_{s.upper()}": {"dataroot": paths[s][1], "data_len": 1} for s in paths},
        },
        "model": {
            "beta_schedule": {"train": {"schedule": "cosine", "n_timestep": 1000},
                              "val": {"schedule": "cosine", "n_timestep": 1000}},
            "init_type": "kaiming",
            "unet": {"channel_multiplier": list(CHANNELS)},
            "diffusion": {"loss_type": "l1"},
        },
        "train": {"val_freq": 3, "print_freq": 1, "max_iter": 3, "optimizer": {"lr": 1e-3}},
        "val_max_images": 1,
        "val_batch_size": 1,
        **extra,
    }
    path = root / f"{name}.json"
    path.write_text(json.dumps(cfg))
    return str(path), root / name


def _torchrun(cfg, phase, cwd):
    """The CLI on two CPU ranks under torchrun, started (a Popen)."""
    env = {**os.environ, "PYTHONPATH": ROOT, "OMP_NUM_THREADS": "1"}
    return subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "2",
         "-m", "tmdiff_tpu_torch.cli", "-c", cfg, "-p", phase, "--device", "cpu",
         "--sampler", "regression"],
        cwd=cwd, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def _finish(proc):
    try:
        out, err = proc.communicate(timeout=300)
    finally:
        proc.kill()
    assert proc.returncode == 0, out[-3000:] + err[-3000:]
    return out


def _mats(exp):
    return {m.parent.name: scio.loadmat(str(m))["sr"]
            for m in sorted((exp / "results").rglob("output_mulExm_*.mat"))}


def test_cli_train_and_val_under_torchrun(tmp_path, monkeypatch):
    """-p train on two ranks (every rank on "data": no parallel block), 3
    steps with a validation (the 1-call regression sampler) and a
    checkpoint at step 3: every file written
    once (one log of each, one .mat a sensor, one provenance.json, I3), the
    checkpoint within the parameter bars of the same run in one process;
    then -p val from it on a (1, 2) mesh (the height split): its images
    within 1e-5 of their scale of the train run's validation of the same
    weights."""
    monkeypatch.chdir(tmp_path)
    cfg, exp = _config(tmp_path, "mesh")
    single_cfg, single_exp = _config(tmp_path, "single")
    run = _torchrun(cfg, "train", tmp_path)
    try:  # the single-process run meanwhile
        cli.main(["-c", single_cfg, "-p", "train", "--device", "cpu", "--sampler",
                  "regression"])
    finally:
        out = _finish(run)
    # the validation printed by rank 0 alone
    assert sorted(line.split()[1] for line in out.splitlines()) == ["GF2", "QB", "WV3"]
    assert sorted(os.listdir(exp / "logs")) == ["train.log", "val.log"]
    log = (exp / "logs" / "train.log").read_text()
    assert "mesh: Mesh(data=2, space=1" in log and "backend=gloo" in log
    assert log.count("step 3 QB") == 1
    assert (exp / "provenance.json").exists()
    assert sorted(os.listdir(exp / "checkpoint")) == ["I3"]
    assert sorted(_mats(exp)) == ["GF2", "QB", "WV3"]
    assert len(list((exp / "results").rglob("*.mat"))) == 3

    meshed = torch.load(str(exp / "checkpoint" / "I3" / ckpt_lib.STATE_FILE), weights_only=True)
    ref = torch.load(str(single_exp / "checkpoint" / "I3" / ckpt_lib.STATE_FILE),
                     weights_only=True)
    assert meshed["step"] == ref["step"] == 3
    for name, p in ref["model"].items():
        np.testing.assert_allclose(meshed["model"][name].numpy(), p.numpy(), atol=PARAM_ATOL,
                                   rtol=PARAM_RTOL, err_msg=name)

    resume = str(exp / "checkpoint")
    val_cfg, val_exp = _config(tmp_path, "mesh_val", parallel={"data": 1, "space": 2})
    opt = json.loads(open(val_cfg).read())
    opt["path"]["resume"] = resume
    open(val_cfg, "w").write(json.dumps(opt))
    _finish(_torchrun(val_cfg, "val", tmp_path))
    assert "mesh: Mesh(data=1, space=2" in (val_exp / "logs" / "train.log").read_text()
    # -p val restores the online weights of I3, which the train run's
    # validation at step 3 sampled (batch 1 falls back to replication there)
    got, want = _mats(val_exp), _mats(exp)
    assert sorted(got) == ["GF2", "QB", "WV3"]
    for sensor, img in want.items():
        assert np.abs(got[sensor] - img).max() <= 1e-5 * np.abs(img).max(), sensor
