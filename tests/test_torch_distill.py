"""The port's progressive distillation (tmdiff_tpu_torch/train/distill.py,
gaussian.ddim_jump / ddim_sample, cli.py -p distill) against the JAX package
on the CPU: the DDIM algebra of tests/test_distill.py, the distillation loss
and every gradient against jax.grad of the JAX DistillTrainer's loss with the
student index and the noise drawn by JAX's key and handed to the port, the
T % 2N refusal, remat, a falling loss, and `-p distill` through the port's
and the JAX CLI side by side on one config."""
import json
import os
import re
import signal

import flax.linen as flax_nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.io as scio
import torch

from tmdiff_tpu.diffusion import gaussian as jax_gaussian
from tmdiff_tpu.diffusion.schedules import NoiseSchedule as JaxNoiseSchedule
from tmdiff_tpu.models import WavBEST as JaxWavBEST
from tmdiff_tpu.train import distill as jax_distill
from tmdiff_tpu_torch import cli
from tmdiff_tpu_torch.data.synthetic import write_h5
from tmdiff_tpu_torch.diffusion import gaussian
from tmdiff_tpu_torch.diffusion.schedules import NoiseSchedule
from tmdiff_tpu_torch.models import blocks
from tmdiff_tpu_torch.models.clip_text import load_prompt_table
from tmdiff_tpu_torch.models.wavbest import WavBEST
from tmdiff_tpu_torch.train.distill import DistillTrainer, progressive_target
from tmdiff_tpu_torch.utils.weights import from_flax
from flax_params import random_flax_params

torch.set_num_threads(2)

CHANNELS = (8, 16, 32, 64)


def _t(a):
    return torch.as_tensor(np.array(a, np.float32))


@pytest.fixture(scope="module")
def schedules():
    return NoiseSchedule.create("cosine", 100), JaxNoiseSchedule.create("cosine", 100)


def _normal(rng, shape=(2, 4, 8, 8)):
    return rng.standard_normal(shape).astype(np.float32)


# -- the DDIM algebra -----------------------------------------------------------


def test_ddim_jump_algebra(schedules, rng):
    """A jump to model time 0 returns x0; two jumps with one x0 are one jump;
    both against JAX's ddim_jump on the same inputs (atol 1e-6)."""
    ns, jns = schedules
    x_t, x0 = _normal(rng), _normal(rng)
    t = np.array([100, 60])
    zero = gaussian.ddim_jump(ns, _t(x_t), _t(x0), torch.as_tensor(t), torch.zeros(2, dtype=torch.long))
    np.testing.assert_allclose(zero.numpy(), x0, atol=1e-6)
    t = np.array([100, 80])
    tt = torch.as_tensor(t)
    two = gaussian.ddim_jump(ns, gaussian.ddim_jump(ns, _t(x_t), _t(x0), tt, tt - 25), _t(x0),
                             tt - 25, tt - 50)
    one = gaussian.ddim_jump(ns, _t(x_t), _t(x0), tt, tt - 50)
    np.testing.assert_allclose(two.numpy(), one.numpy(), atol=1e-5)
    ref = jax_gaussian.ddim_jump(jns, jnp.asarray(x_t), jnp.asarray(x0), jnp.asarray(t),
                                 jnp.asarray(t - 50))
    np.testing.assert_allclose(one.numpy(), np.asarray(ref), atol=1e-6)
    # scalar times, as the samplers pass them
    np.testing.assert_allclose(
        gaussian.ddim_jump(ns, _t(x_t), _t(x0), 70, 35).numpy(),
        np.asarray(jax_gaussian.ddim_jump(jns, jnp.asarray(x_t), jnp.asarray(x0), 70, 35)),
        atol=1e-6)


def test_progressive_target_recovers_perfect_teacher_x0(schedules, rng):
    """A teacher with one consistent x0 at both half-jumps implies that x0
    as the student's target (atol 1e-4, also with t2 = 0), and the port's
    target equals JAX's on the same inputs (atol 1e-5)."""
    ns, jns = schedules
    x0, noise = _normal(rng), _normal(rng)
    t = torch.tensor([100, 50])
    t1, t2 = t - 25, t - 50
    a = ns.sqrt_alphas_cumprod_prev[t][:, None, None, None]
    x_t = a * _t(x0) + torch.sqrt(1 - a * a) * _t(noise)
    x_t2 = gaussian.ddim_jump(ns, gaussian.ddim_jump(ns, x_t, _t(x0), t, t1), _t(x0), t1, t2)
    tgt = progressive_target(ns, x_t, x_t2, t, t2)
    np.testing.assert_allclose(tgt.numpy(), x0, atol=1e-4, rtol=1e-4)
    ref = jax_distill.progressive_target(jns, jnp.asarray(x_t.numpy()), jnp.asarray(x_t2.numpy()),
                                         jnp.asarray(t.numpy()), jnp.asarray(t2.numpy()))
    np.testing.assert_allclose(tgt.numpy(), np.asarray(ref), atol=1e-5)
    zero = torch.zeros_like(t)
    x_to0 = gaussian.ddim_jump(ns, gaussian.ddim_jump(ns, x_t, _t(x0), t, t1), _t(x0), t1, zero)
    np.testing.assert_allclose(progressive_target(ns, x_t, x_to0, t, zero).numpy(), x0, atol=1e-4)


def test_ddim_sample_constant_model_returns_x0(schedules):
    ns, _ = schedules
    x0 = torch.full((1, 4, 8, 8), 0.25)
    for steps in (1, 4, 10):
        out = gaussian.ddim_sample(lambda x, t, pan, ms: x0.expand_as(x), ns,
                                   torch.Generator().manual_seed(0), None, x0, x0.shape,
                                   steps=steps)
        np.testing.assert_allclose(out.numpy(), x0.numpy(), atol=1e-6)


def test_distill_trainer_validates_grid():
    with pytest.raises(ValueError, match="divisible"):
        DistillTrainer(model=None, schedule=NoiseSchedule.create("cosine", 100),
                       n_student_steps=8)


# -- the loss and its gradients against JAX ------------------------------------


def _batch(bands=4, seed=0, b=2, size=16):
    rng = np.random.default_rng(seed)
    ms = rng.uniform(0.05, 0.95, (b, bands, size, size)).astype(np.float32)
    pan = (ms.mean(1, keepdims=True) + 0.05 * rng.standard_normal((b, 1, size, size)))
    res = (0.1 * rng.standard_normal((b, bands, size, size))).astype(np.float32)
    return {"Res": res, "PAN": pan.astype(np.float32), "MS": ms}


def _prompt(sensor="QB"):
    table, index, _ = load_prompt_table()
    return np.asarray(table[index[sensor]], np.float32)


def _rel_to_scale(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return np.abs(got - ref).max() / np.abs(ref).max()


class _NoDropout(flax_nn.Module):
    """flax's Dropout as the identity, for a comparison without masks."""
    rate: float
    deterministic: bool = None

    @flax_nn.compact
    def __call__(self, x, deterministic=None, rng=None):
        return x


@pytest.mark.parametrize("loss_type", ["l1", "l2"])
def test_distill_loss_and_gradients_match_jax(monkeypatch, loss_type):
    """JAX DistillTrainer._loss_fn under jax.value_and_grad against the
    port's loss and backward: student and teacher weights from two seeds
    (from_flax), N = 5 of T = 100, the SNR weight, remat, dropout off on
    both sides (the masks cannot match), the student index and the noise
    drawn by JAX's split of the key and handed to the port. The loss to
    1e-5 relative and every parameter's gradient to 1e-4 of its largest
    magnitude."""
    monkeypatch.setattr(flax_nn, "Dropout", _NoDropout)
    monkeypatch.setattr(blocks, "DROPOUT", 0.0)
    jmodel = JaxWavBEST(channels=CHANNELS)
    params, teacher = random_flax_params(jmodel, 1), random_flax_params(jmodel, 2)
    jtrainer = jax_distill.DistillTrainer(model=jmodel, schedule=JaxNoiseSchedule.create("cosine", 100),
                                          n_student_steps=5, loss_type=loss_type)
    batch, prompt = _batch(), _prompt()
    key = jax.random.key(5)
    want, jgrads = jax.jit(jax.value_and_grad(jtrainer._loss_fn))(
        params, key, {k: jnp.asarray(v) for k, v in batch.items()}, jnp.asarray(prompt), teacher)
    rng_i, rng_noise = jax.random.split(jax.random.fold_in(key, 0))
    i = jax.random.randint(rng_i, (2,), 1, 6)
    noise = jax.random.normal(rng_noise, batch["Res"].shape, jnp.float32)

    port = from_flax(WavBEST(CHANNELS, device="cpu"), jax.tree.map(np.asarray, params))
    t_port = from_flax(WavBEST(CHANNELS, device="cpu"), jax.tree.map(np.asarray, teacher))
    trainer = DistillTrainer(port, NoiseSchedule.create("cosine", 100), n_student_steps=5,
                             loss_type=loss_type)
    loss = trainer.loss(0, {k: _t(v) for k, v in batch.items()}, _t(prompt),
                        {n: p.detach() for n, p in t_port.named_parameters()},
                        i=torch.as_tensor(np.array(i), dtype=torch.int64), noise=_t(noise))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want), rtol=1e-5)
    ref = from_flax(WavBEST(CHANNELS, device="cpu"), jax.tree.map(np.asarray, jgrads)).state_dict()
    for name, p in port.named_parameters():
        assert _rel_to_scale(p.grad, ref[name]) <= 1e-4, name
    assert all(p.grad is None for p in t_port.parameters())  # the teacher takes no gradient


def _tiny(remat=True, **kw):
    model = WavBEST((4, 8, 8, 16), device="cpu", seed=0)
    return DistillTrainer(model, NoiseSchedule.create("cosine", 100), n_student_steps=5,
                          lr=2e-3, warmup_steps=1, max_iter=100, remat=remat, **kw)


def test_remat_and_draws():
    """Dropout on: remat on and off give bit-identical losses and gradients
    (the recompute draws the same masks); the same step draws the same i
    and noise, another step others."""
    batch = {k: _t(v) for k, v in _batch(size=16).items()}
    out = []
    for remat in (True, False):
        trainer = _tiny(remat)
        teacher = {n: p.detach().clone() for n, p in trainer.model.named_parameters()}
        loss = trainer.loss(3, batch, _t(_prompt()), teacher)
        out.append((loss.detach(), torch.autograd.grad(loss, list(trainer.model.parameters()))))
    assert torch.equal(out[0][0], out[1][0])
    assert all(torch.equal(a, b) for a, b in zip(out[0][1], out[1][1]))
    trainer = _tiny()
    teacher = {n: p.detach().clone() for n, p in trainer.model.named_parameters()}
    assert not torch.equal(trainer.loss(4, batch, _t(_prompt()), teacher).detach(), out[0][0])


def test_distill_phase_learns():
    """12 steps from a teacher equal to the initial student (lr 2e-3, warmup
    1) on 8 synthetic 4-band scenes: the mean of the last three losses
    below the first three's, as tests/test_distill.py asks of JAX's."""
    from tmdiff_tpu_torch.data.h5 import PanDataset
    from tmdiff_tpu_torch.data.pipeline import BatchIterator
    from tmdiff_tpu_torch.data.synthetic import make_arrays

    it = BatchIterator(PanDataset(make_arrays(n=8, bands=4, size=16, seed=3)), 8, seed=3)
    trainer = _tiny()
    state = trainer.init_state()
    teacher = {n: p.detach().clone() for n, p in trainer.model.named_parameters()}
    losses = [float(trainer.train_step(state, next(it), _prompt(), teacher)[1]["l_pix"])
              for _ in range(12)]
    assert np.isfinite(losses).all() and state.step == 12
    assert np.mean(losses[-3:]) < np.mean(losses[:3]), losses


# -- -p distill through both CLIs -----------------------------------------------


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    root = tmp_path_factory.mktemp("distill_cli")
    paths = {}
    for i, sensor in enumerate(["qb", "gf2", "wv3"]):
        paths[f"train_{sensor}"] = write_h5(str(root / f"train_{sensor}.h5"), n=6, bands=4,
                                            size=16, seed=i, img_scale=2047.0)
        paths[f"val_{sensor}"] = write_h5(str(root / f"val_{sensor}.h5"), n=2, bands=4, size=16,
                                          seed=10 + i, img_scale=2047.0)
    cfg = {
        "name": "teacher",
        "path": {"log": "logs", "results": "results", "checkpoint": "checkpoint", "resume": None},
        "datasets": {
            **{f"train_{s}": {"dataroot": paths[f"train_{s}"], "batch_size": 2,
                              "use_shuffle": True, "data_len": -1} for s in ("qb", "gf2", "wv3")},
            **{f"val_{s.upper()}": {"dataroot": paths[f"val_{s}"], "data_len": 1}
               for s in ("qb", "gf2", "wv3")},
        },
        "model": {
            "beta_schedule": {"train": {"schedule": "cosine", "n_timestep": 1000},
                              "val": {"schedule": "cosine", "n_timestep": 1000}},
            "init_type": None,
            "unet": {"channel_multiplier": [4, 8, 8, 16]},
            "diffusion": {"loss_type": "l1"},
        },
        "train": {"val_freq": 100, "print_freq": 1, "max_iter": 2, "optimizer": {"lr": 1e-3},
                  "use_ema_eval": True,
                  "distill": {"phases": [10, 5], "steps_per_phase": 3, "lr": 1e-3}},
        "val_max_images": 1,
        "val_batch_size": 1,
    }
    return root, cfg


def _write(root, cfg, name):
    path = root / f"{name}.json"
    path.write_text(json.dumps(cfg))
    return str(path)


class _Recorder:
    """Records what each CLI hands the distillation step (batch, prompt row)
    and the sampler (sensor, method, seed, steps); the sampler returns the
    batch's MS with noise seeded by the call's seed. SIGTERM at the given
    distillation step count."""

    def __init__(self, preempt_at=None):
        self.batches, self.samples, self.steps = [], [], 0
        self.preempt_at = preempt_at

    def sample(self, batch, sensor="QB", method="dpm++", seed=0, steps=None, **kw):
        ms = np.asarray(batch["MS"])
        self.samples.append((sensor, method, seed, steps, ms.shape))
        noise = 0.02 * np.random.default_rng(seed).standard_normal(ms.shape)
        return np.clip(ms + noise, 0, 1).astype(np.float32)

    def step(self, batch, emb):
        self.steps += 1
        self.batches.append(({k: np.asarray(batch[k]) for k in ("Res", "PAN", "MS")},
                             np.asarray(emb)))
        if self.steps == self.preempt_at:
            os.kill(os.getpid(), signal.SIGTERM)  # handled before the loop's next check


def _patch_port(m, rec):
    from tmdiff_tpu_torch import pipeline
    from tmdiff_tpu_torch.train import distill

    compiled = distill.DistillTrainer.compiled_step

    def compiled_step(self):
        step = compiled(self)

        def recorded(state, batch, emb, teacher):
            given = {k: batch[k].clone() for k in ("Res", "PAN", "MS")}
            out = step(state, batch, emb, teacher)
            rec.step(given, emb)
            return out

        return recorded

    # the CLI's loop steps through compiled_step in one process
    m.setattr(distill.DistillTrainer, "compiled_step", compiled_step)
    m.setattr(pipeline.Pansharpener, "sample", lambda self, batch, **kw: rec.sample(batch, **kw))


def _patch_jax(m, rec):
    """The JAX CLI with a four-element state and steps that only count: its
    decisions stay, the model's compile does not."""
    from tmdiff_tpu import pipeline
    from tmdiff_tpu.train.trainer import Trainer, TrainState

    def init_state(self, batch, emb):
        w = {"w": jnp.arange(4, dtype=jnp.float32)}
        return TrainState(step=jnp.zeros((), jnp.int32), params=w, opt_state={"m": w["w"]},
                          ema_params={"w": w["w"] + 1})

    def train_step(self, state, batch, emb, *extra):
        rec.step(batch, emb)
        return state.replace(step=state.step + 1), {"l_pix": jnp.float32(0.0)}

    m.setattr(Trainer, "init_state", init_state)
    m.setattr(Trainer, "train_step", train_step)
    m.setattr(pipeline.Pansharpener, "sample", lambda self, batch, **kw: rec.sample(batch, **kw))


_EVENTS = [
    (r"Begin progressive distillation: (.*)", "begin"),
    (r"distill N=(\d+) step (\d+) l_distill: ", "stepped"),
    (r"distill N=(\d+) done -> (\S+)", "done"),
    (r"Preemption signal: phase N=(\d+) stopped at step (\S+); PARTIAL student "
     r"checkpointed to (\S+), validation skipped", "partial"),
    (r"step (\d+) (QB|GF2|WV3) ", "validated"),
    (r"Restored checkpoint from (\S+)", "restored"),
]


def _events(log_path, exp_root, teacher_root):
    events, scores = [], []
    for line in log_path.read_text().splitlines():
        msg = line.split(" - INFO: ", 1)[-1].replace(str(exp_root), "<exp>")
        msg = msg.replace(str(teacher_root), "<teacher>")
        for pattern, name in _EVENTS:
            m = re.match(pattern, msg)
            if m:
                events.append((name, *m.groups()))
                if name == "validated":
                    scores.append([float(v) for k, v in re.findall(
                        r"'(\w+)': (?:np\.float\d+\()?([-+\d.e]+)", msg)
                        if not k.startswith("sec_per_image")])
                break
    return events, scores


def _listing(root):
    return sorted(str(p.relative_to(root)) for p in root.rglob("*")
                  if p.is_file() and "checkpoint" not in p.parts)


def test_distill_phase_matches_the_jax_cli(workspace, monkeypatch):
    """One config through both CLIs: a teacher checkpoint from two training
    steps, then -p distill over phases N = 10 and 5 of 3 steps each (the
    port's steps real, the JAX package's counting), and again with a
    SIGTERM in the second phase. Both must agree on the batches and prompt
    rows of every step, the sampler's calls (ddim at N steps, each phase's
    student), the log's decisions, the checkpoints (distill_N10, distill_N5,
    then distill_N5_partial with validation skipped), the scores and the
    .mat files. The port's student checkpoints hold the student in both
    weight slots."""
    from tmdiff_tpu import cli as jax_cli
    from tmdiff_tpu_torch.train import checkpoint as ckpt_lib

    root, cfg = workspace
    monkeypatch.chdir(root)
    runs = {}
    for name, run_cli, patch, extra in (("port", cli.main, _patch_port, ["--device", "cpu"]),
                                        ("jax", jax_cli.main, _patch_jax, [])):
        own = json.loads(json.dumps(cfg))
        own["name"] = f"{name}_teacher"
        own["path"]["experiments_root"] = str(root / f"{name}_teacher")
        with monkeypatch.context() as m:
            if name == "jax":
                patch(m, _Recorder())
            run_cli(["-c", _write(root, own, f"{name}_teacher"), "-p", "train", *extra])
        out = []
        for label, preempt_at in (("full", None), ("preempted", 5)):
            rec = _Recorder(preempt_at)
            d_cfg = json.loads(json.dumps(own))
            exp = root / f"{name}_{label}"
            d_cfg["name"] = f"{name}_{label}"
            d_cfg["path"]["experiments_root"] = str(exp)
            d_cfg["path"]["resume"] = str(root / f"{name}_teacher" / "checkpoint")
            with monkeypatch.context() as m:
                patch(m, rec)
                run_cli(["-c", _write(root, d_cfg, f"{name}_{label}"), "-p", "distill", *extra])
            ckpts = sorted(str(p.relative_to(exp / "checkpoint"))
                           for p in (exp / "checkpoint").glob("*/*"))
            out.append((rec, ckpts, _events(exp / "logs" / "train.log", exp,
                                            root / f"{name}_teacher"), exp))
        runs[name] = out
        assert signal.getsignal(signal.SIGTERM) is signal.SIG_DFL

    for (rec, ckpts, (events, scores), exp), (jrec, jckpts, (jevents, jscores), jexp) in zip(
            runs["port"], runs["jax"]):
        assert ckpts == jckpts
        assert events == jevents
        assert len(rec.batches) == len(jrec.batches) == rec.steps
        for (batch, emb), (jbatch, jemb) in zip(rec.batches, jrec.batches):
            for k in batch:
                np.testing.assert_array_equal(batch[k], jbatch[k], err_msg=k)
            np.testing.assert_allclose(emb, jemb, rtol=1e-6)
        assert rec.samples == jrec.samples
        np.testing.assert_allclose(scores, jscores, rtol=2e-5)
        assert _listing(exp / "results") == _listing(jexp / "results")
        for rel in _listing(exp / "results"):
            a, b = (scio.loadmat(str(r / "results" / rel)) for r in (exp, jexp))
            np.testing.assert_array_equal(a["sr"], b["sr"])

    (full, preempted) = runs["port"]
    assert full[1] == ["distill_N10/I3", "distill_N5/I3"]
    assert [e[0] for e in full[2][0]] == (["restored", "begin"] + ["stepped"] * 3 + ["done"]
                                          + ["validated"] * 3 + ["stepped"] * 3 + ["done"]
                                          + ["validated"] * 3)
    assert {s[1:4:2] for s in full[0].samples} == {("ddim", 10), ("ddim", 5)}
    assert preempted[1] == ["distill_N10/I3", "distill_N5_partial/I2"]
    assert [e[0] for e in preempted[2][0]][-3:] == ["stepped", "stepped", "partial"]
    state = torch.load(str(full[3] / "checkpoint" / "distill_N5" / "I3" / ckpt_lib.STATE_FILE),
                       weights_only=True)
    assert all(torch.equal(e, state["model"][n])
               for n, e in zip(state["model"], state["ema_params"]))
