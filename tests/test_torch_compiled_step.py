"""Trainer.compiled_step (train/trainer.py) on the CPU, where it runs the
step body on its static inputs without a capture: three compiled steps
against three `train_step`s from one start, bit for bit (parameters, AdamW's
moments and step counts, the schedule, the EMA, the metrics), in fp32 and
bf16, for Trainer and DistillTrainer, with the CFG coin and a gradient clip,
across a change of band count and across the ends of the lr warm-up and of
the EMA's copy phase; the draws of steps k and k + 1 on one batch; a
checkpoint resumed across the two paths; the refusal of a gloo mesh on a card.
`train_step` itself is held against the JAX trainer by
tests/test_torch_train.py and tests/test_torch_distill.py, and the captured
step against train_step on the card by tests/test_torch_cuda.py. Tiny
widths (8, 16, 32, 64) at 16x16, batch 2."""
import numpy as np
import pytest
import torch

from tmdiff_tpu_torch.diffusion import gaussian
from tmdiff_tpu_torch.diffusion.schedules import NoiseSchedule
from tmdiff_tpu_torch.models import blocks
from tmdiff_tpu_torch.models.clip_text import load_prompt_table
from tmdiff_tpu_torch.models.wavbest import WavBEST
from tmdiff_tpu_torch.parallel.mesh import Mesh
from tmdiff_tpu_torch.train import checkpoint as ckpt
from tmdiff_tpu_torch.train.distill import DistillTrainer
from tmdiff_tpu_torch.train.trainer import Trainer

torch.set_num_threads(2)

CHANNELS = (8, 16, 32, 64)
T = 100
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _batch(bands=4, seed=0, b=2):
    rng = np.random.default_rng(seed)
    ms = rng.uniform(0.05, 0.95, (b, bands, 16, 16)).astype(np.float32)
    pan = ms.mean(1, keepdims=True) + 0.05 * rng.standard_normal((b, 1, 16, 16))
    pan = pan.astype(np.float32)
    res = (0.1 * rng.standard_normal((b, bands, 16, 16))).astype(np.float32)
    return {"Res": res, "PAN": pan, "MS": ms}


def _prompt(sensor="QB"):
    table, index, _ = load_prompt_table()
    return np.asarray(table[index[sensor]], np.float32)


def _trainer(kind="train", dtype="float32", **kw):
    """A trainer of a seeded model: warm-up of one step and the EMA's copy
    phase up to step 1, so a three-step run crosses both ends."""
    model = WavBEST(CHANNELS, device="cpu", seed=0, dtype=DTYPES[dtype])
    cls = DistillTrainer if kind == "distill" else Trainer
    extra = {"n_student_steps": 5} if kind == "distill" else {}
    return cls(model, NoiseSchedule.create("cosine", T), lr=2e-3, warmup_steps=1,
               max_iter=1000, ema_decay=0.9, ema_start=1, seed=11, **extra, **kw)


def _teacher(trainer):
    return {n: p.detach().clone() for n, p in trainer.model.named_parameters()}


def _state_tensors(state) -> dict:
    out = {f"param {n}": p.detach() for n, p in state.model.named_parameters()}
    out.update({f"ema {i}": e for i, e in enumerate(state.ema_params)})
    for i, p in enumerate(state.model.parameters()):
        out.update({f"adamw {i} {k}": v for k, v in state.optimizer.state[p].items()})
    sched = state.scheduler.state_dict()
    out["schedule"] = torch.tensor([state.step, sched["last_epoch"], sched["_step_count"]])
    out["lr"] = torch.tensor([float(g["lr"]) for g in state.optimizer.param_groups],
                             dtype=torch.float64)
    return out


def _assert_same_state(a, b):
    ta, tb = _state_tensors(a), _state_tensors(b)
    assert list(ta) == list(tb)
    differ = [k for k in ta if not torch.equal(ta[k], tb[k])]
    assert not differ, differ[:5]


def _assert_same_metrics(ma, mb):
    assert ma.keys() == mb.keys() == {"l_pix", "lr", "grad_norm"}
    assert ma["lr"] == mb["lr"]
    assert torch.equal(ma["l_pix"], mb["l_pix"]) and torch.equal(ma["grad_norm"], mb["grad_norm"])


# a band-count change between calls: 4, 8, 4 bands
BATCHES = ((4, 0), (8, 1), (4, 2))


@pytest.mark.parametrize("kind,dtype,kw", [
    ("train", "float32", {"p_uncond": 0.3}),
    ("train", "float32", {"grad_clip": 0.05}),
    ("train", "bfloat16", {"p_uncond": 0.3, "grad_clip": 0.05}),
    ("distill", "float32", {"grad_clip": 0.05}),
    ("distill", "bfloat16", {}),
], ids=["fp32-cfg", "fp32-clip", "bf16-cfg-clip", "distill-fp32-clip", "distill-bf16"])
def test_compiled_step_matches_train_step(kind, dtype, kw):
    """Three compiled steps against three train_steps from one start, bit
    for bit after every step, metrics included; the lr and the EMA factor
    change inside the run."""
    eager, compiled = _trainer(kind, dtype, **kw), _trainer(kind, dtype, **kw)
    s_e, s_c = eager.init_state(), compiled.init_state()
    _assert_same_state(s_e, s_c)
    extra = (_teacher(eager),) if kind == "distill" else ()
    step = compiled.compiled_step()
    lrs = []
    for bands, seed in BATCHES:
        batch = _batch(bands, seed)
        _, m_e = eager.train_step(s_e, batch, _prompt(), *extra)
        _, m_c = step(s_c, batch, _prompt(), *extra)
        _assert_same_metrics(m_e, m_c)
        _assert_same_state(s_e, s_c)
        lrs.append(m_c["lr"])
    assert s_c.step == 3 and lrs[0] == 0.0 < lrs[2] < lrs[1]
    # one static-input set a batch shape: the 4-band one was reused
    assert len(compiled._captured) == 2


def test_ema_copies_then_averages_in_compiled_steps():
    """ema_start = 1: the first step's EMA is the parameters, the second
    averages with the factor 0.9 (read on the device at each step)."""
    trainer = _trainer()
    state = trainer.init_state()
    step = trainer.compiled_step()
    step(state, _batch(), _prompt())
    params = [p.detach().clone() for p in trainer.model.parameters()]
    assert all(torch.equal(e, p) for e, p in zip(state.ema_params, params))
    step(state, _batch(seed=1), _prompt())
    want = [e * np.float32(0.9) + p * (1 - torch.tensor(0.9))
            for e, p in zip(params, trainer.model.parameters())]
    assert all(torch.equal(e, w) for e, w in zip(state.ema_params, want))


def test_steps_draw_anew_on_one_batch(monkeypatch):
    """Steps k and k + 1 on one batch draw other t, noise and dropout
    masks, each the generators' draws for its step; remat's recompute
    draws the first pass's masks."""
    seen, masks = [], []
    loss, dropout = gaussian.diffusion_loss, blocks.dropout

    def spy_loss(*args, t=None, noise=None, **kw):
        seen.append((t.clone(), noise.clone()))
        return loss(*args, t=t, noise=noise, **kw)

    def spy_dropout(x, rate, rng, mesh=None):
        y = dropout(x, rate, rng, mesh)
        masks.append(y != 0)
        return y

    monkeypatch.setattr(gaussian, "diffusion_loss", spy_loss)
    monkeypatch.setattr(blocks, "dropout", spy_dropout)
    trainer = _trainer()
    state = trainer.init_state()
    step = trainer.compiled_step()
    batch = _batch()
    per_call = []
    for _ in range(2):
        before = len(masks)
        step(state, batch, _prompt())
        per_call.append(masks[before:])
    (t0, n0), (t1, n1) = seen
    assert not torch.equal(t0, t1) and not torch.equal(n0, n1)
    for k, (t, n) in enumerate(seen):
        gen = trainer.generators(k)["tn"]
        assert torch.equal(t, torch.randint(1, T + 1, (2,), generator=gen))
        assert torch.equal(n, torch.randn(n.shape, generator=gen))
    first, second = per_call
    half = len(first) // 2  # the model call's masks, then its recompute's
    assert len(first) == len(second) == 2 * half > 0
    assert all(torch.equal(a, b) for a, b in zip(first[:half], first[half:]))
    assert not torch.equal(first[0], second[0])


@pytest.mark.parametrize("first", ["compiled", "eager"])
def test_checkpoint_resumes_across_the_paths(tmp_path, first):
    """Two steps on one path, a checkpoint, a fresh state restored from it;
    then a step on the other path from the restored state equals a step on
    the first path from the original one, bit for bit."""
    trainer = _trainer(p_uncond=0.3)
    state = trainer.init_state()
    step = trainer.compiled_step() if first == "compiled" else trainer.train_step
    for bands, seed in BATCHES[:2]:
        step(state, _batch(bands, seed), _prompt())
    ckpt.save_checkpoint(str(tmp_path), state)
    other = _trainer(p_uncond=0.3)
    fresh = ckpt.restore_checkpoint(str(tmp_path), other.init_state())
    _assert_same_state(state, fresh)
    resumed = other.train_step if first == "compiled" else other.compiled_step()
    batch = _batch(4, 5)
    _, m = step(state, batch, _prompt())
    _, m_r = resumed(fresh, batch, _prompt())
    _assert_same_metrics(m, m_r)
    _assert_same_state(state, fresh)


def test_compiled_step_refuses_a_mesh_of_ranks():
    """A gloo mesh of ranks on a card raises, naming NCCL and train_step
    (gloo's collectives go through host memory, which no CUDA graph holds);
    an NCCL mesh on a card and a CPU mesh of two ranks give the callable
    (captured on every rank; uncaptured on the CPU), and so does a mesh of
    one rank. The trainer's device is set to a card after it is built on
    the CPU: the rule reads only the device and the mesh."""
    mesh = lambda backend, device, data=2: Mesh(
        data=data, space=1, rank=0, backend=backend, device=torch.device(device),
        space_group=None, data_group=None, world_group=None)
    trainer = lambda m: Trainer(WavBEST(CHANNELS, device="cpu", seed=0),
                                NoiseSchedule.create("cosine", T), mesh=m)
    on_card = trainer(mesh("gloo", "cuda:0"))
    on_card.device = torch.device("cuda", 0)
    with pytest.raises(ValueError, match="2 ranks needs NCCL.*gloo through host memory.*"
                                         "use train_step"):
        on_card.compiled_step()
    nccl = trainer(mesh("nccl", "cuda:0"))
    nccl.device = torch.device("cuda", 0)
    assert callable(nccl.compiled_step())
    assert callable(trainer(mesh("gloo", "cpu")).compiled_step())
    assert callable(trainer(mesh("gloo", "cpu", data=1)).compiled_step())
