"""The port's checkpoints (tmdiff_tpu_torch/train/checkpoint.py,
TrainState.state_dict) and sampling with given weights
(Pansharpener.sample(params=...)), on the CPU at widths (4, 8, 8, 16) and
16x16: a round trip is bit for bit and so is a step after it; `keep`,
`latest_step` and `weights_only` behave as the JAX package's; the reference
`.pth` goes both ways between the two packages."""
import os

import jax
import numpy as np
import pytest
import torch

from tmdiff_tpu.diffusion.schedules import NoiseSchedule as JaxNoiseSchedule
from tmdiff_tpu.models import WavBEST as JaxWavBEST
from tmdiff_tpu.train import checkpoint as jax_ckpt
from tmdiff_tpu.train.trainer import Trainer as JaxTrainer
from tmdiff_tpu.utils import torch_import
from tmdiff_tpu_torch.diffusion.schedules import NoiseSchedule
from tmdiff_tpu_torch.models.wavbest import WavBEST
from tmdiff_tpu_torch.pipeline import Pansharpener
from tmdiff_tpu_torch.train import checkpoint as ckpt
from tmdiff_tpu_torch.train.trainer import Trainer

from flax_params import random_flax_params

torch.set_num_threads(2)

CHANNELS = (4, 8, 8, 16)


def _trainer(seed=0, **kw):
    return Trainer(WavBEST(CHANNELS, device="cpu", seed=seed),
                   NoiseSchedule.create("cosine", 10), lr=1e-3, warmup_steps=2, max_iter=50,
                   remat=False, **kw)


def _batch(seed=0, bands=4):
    rng = np.random.default_rng(seed)
    return ({"Res": (0.1 * rng.standard_normal((2, bands, 16, 16))).astype(np.float32),
             "PAN": rng.random((2, 1, 16, 16)).astype(np.float32),
             "MS": rng.random((2, bands, 16, 16)).astype(np.float32)},
            rng.standard_normal(768).astype(np.float32))


def _flat(state):
    """Every tensor of a state, with its name, in a fixed order."""
    out = [("step", torch.tensor(state.step))]
    out += [(f"model.{k}", v) for k, v in state.model.state_dict().items()]
    for i, s in sorted(state.optimizer.state_dict()["state"].items()):
        out += [(f"opt.{i}.{k}", v if torch.is_tensor(v) else torch.tensor(v))
                for k, v in sorted(s.items())]
    out += [("lr", torch.tensor([g["lr"] for g in state.optimizer.param_groups]))]
    out += [(f"ema.{i}", e) for i, e in enumerate(state.ema_params)]
    return out


def _assert_same(a, b):
    fa, fb = _flat(a), _flat(b)
    assert [n for n, _ in fa] == [n for n, _ in fb]
    for (name, x), (_, y) in zip(fa, fb):
        assert torch.equal(x, y), name


@pytest.fixture(scope="module")
def trained():
    """A trainer after three steps."""
    trainer = _trainer()
    state = trainer.init_state()
    for i in range(3):
        trainer.train_step(state, *_batch(i))
    return trainer, state


def test_round_trip_is_bit_identical(trained, tmp_path):
    """Save, restore into a fresh state: model, moments, lr, schedule, EMA
    and step equal bit for bit; then one step on each gives the same bits."""
    trainer, state = trained
    path = ckpt.save_checkpoint(str(tmp_path), state)
    assert os.path.basename(path) == "I3" and ckpt.latest_step(str(tmp_path)) == 3
    assert os.listdir(path) == [ckpt.STATE_FILE]
    other = _trainer(seed=5)
    fresh = other.init_state()
    ckpt.restore_checkpoint(str(tmp_path), fresh)
    _assert_same(state, fresh)
    assert fresh.scheduler.last_epoch == state.scheduler.last_epoch == 3
    twin = _trainer()
    twin_state = twin.init_state()
    twin_state.load_state_dict(state.state_dict())
    batch, prompt = _batch(9)
    trainer.train_step(state, batch, prompt)
    other.train_step(fresh, batch, prompt)
    _assert_same(state, fresh)


def test_keep_and_latest_step(tmp_path):
    """`keep` prunes to the newest checkpoints; half-written directories and
    other names are not checkpoints."""
    trainer = _trainer()
    state = trainer.init_state()
    assert ckpt.latest_step(str(tmp_path / "none")) is None
    with pytest.raises(FileNotFoundError):
        ckpt.restore_checkpoint(str(tmp_path / "none"), state)
    os.makedirs(tmp_path / "I99.tmp-1")
    os.makedirs(tmp_path / "I98")  # no state file: a cut-off save
    for step in (1, 2, 3, 4):
        state.step = step
        ckpt.save_checkpoint(str(tmp_path), state, keep=2)
    assert sorted(n for n in os.listdir(tmp_path) if n[1:].isdigit()) == ["I3", "I4", "I98"]
    assert ckpt.latest_step(str(tmp_path)) == 4
    state.step = 0
    ckpt.restore_checkpoint(str(tmp_path), state, step=3)
    assert state.step == 3


def test_weights_only_resumes_like_the_reference(trained, tmp_path):
    """weights_only: the step and the weights; a fresh optimiser and
    schedule; the EMA set to the weights (the JAX package's mode)."""
    trainer, state = trained
    ckpt.save_checkpoint(str(tmp_path), state)
    other = _trainer(seed=5)
    fresh = other.init_state()
    ckpt.restore_checkpoint(str(tmp_path), fresh, weights_only=True)
    assert fresh.step == state.step and len(fresh.optimizer.state) == 0
    assert fresh.scheduler.last_epoch == 0
    assert all(torch.equal(a, b) for a, b in zip(fresh.model.parameters(),
                                                  state.model.parameters()))
    assert all(torch.equal(e, p) for e, p in zip(fresh.ema_params, fresh.model.parameters()))


def _jax_state(params):
    trainer = JaxTrainer(model=JaxWavBEST(channels=CHANNELS),
                         schedule=JaxNoiseSchedule.create("cosine", 10))
    return trainer.state_from_params(params)


def _forwards_agree(port_model, jax_params, seed=1):
    """The port's forward against the JAX model's on the same numpy inputs,
    to 5e-4 (the repository's forward parity bar)."""
    batch, prompt = _batch(seed)
    t = np.array([3.0, 7.0], np.float32)
    ref = jax.jit(JaxWavBEST(channels=CHANNELS).apply)(
        jax_params, batch["Res"], t, batch["PAN"], batch["MS"], prompt)
    with torch.no_grad():
        y = port_model(*(torch.as_tensor(a) for a in (batch["Res"], t, batch["PAN"], batch["MS"],
                                                       prompt)))
    np.testing.assert_allclose(y.numpy(), np.asarray(ref), atol=5e-4)


def test_reference_pth_goes_both_ways(tmp_path, monkeypatch):
    """The port's export loads into the JAX package's
    import_reference_checkpoint, and the JAX package's save_torch_checkpoint
    into the port's import; each side's forward then agrees with the other's
    at 5e-4. The port's export and import are exact inverses."""
    monkeypatch.setenv("TMDIFF_ALLOW_FAKE_CLIP", "1")
    # JAX -> port
    params = random_flax_params(JaxWavBEST(channels=CHANNELS))
    jax_pth = str(tmp_path / "I12_gen.pth")
    torch_import.save_torch_checkpoint(params, jax_pth)
    trainer = _trainer(seed=3)
    state = trainer.init_state()
    ckpt.import_reference_checkpoint(jax_pth, state)
    assert state.step == 12 and len(state.optimizer.state) == 0
    assert all(torch.equal(e, p) for e, p in zip(state.ema_params, state.model.parameters()))
    _forwards_agree(state.model, params)
    # port -> JAX
    port_pth = ckpt.export_reference_checkpoint(state, str(tmp_path / "I12_port_gen.pth"))
    sd = torch.load(port_pth, weights_only=True)
    assert all(k.startswith("denoise_fn.") for k in sd)
    template = _jax_state(random_flax_params(JaxWavBEST(channels=CHANNELS), seed=7))
    jstate = jax_ckpt.import_reference_checkpoint(port_pth, template)
    _forwards_agree(state.model, jstate.params)
    # port -> port, bit for bit
    other = _trainer(seed=4).init_state()
    ckpt.import_reference_checkpoint(port_pth, other)
    assert all(torch.equal(a, b) for a, b in zip(other.model.parameters(),
                                                  state.model.parameters()))


def test_reference_import_needs_real_clip(tmp_path, monkeypatch):
    monkeypatch.delenv("TMDIFF_ALLOW_FAKE_CLIP", raising=False)
    state = _trainer().init_state()
    path = ckpt.export_reference_checkpoint(state, str(tmp_path / "I1_gen.pth"))
    with pytest.raises(RuntimeError, match="real CLIP"):
        ckpt.import_reference_checkpoint(path, state)


def test_sample_with_given_weights_leaves_training_alone(trained):
    """Sampling with the EMA weights equals sampling a model that holds
    them (to 1e-6), differs from sampling with the online weights, and
    leaves the model's parameters, the optimiser and the next
    training step as they were, bit for bit."""
    trainer, state = trained
    names = [n for n, _ in state.model.named_parameters()]
    ema = dict(zip(names, state.ema_params))
    before = [p.detach().clone() for p in state.model.parameters()]
    batch, _ = _batch(4)
    sharp = Pansharpener(state.model, n_timestep=10, device="cpu")
    got = sharp.sample(batch, sensor="QB", steps=3, params=ema)
    assert all(torch.equal(a, b) for a, b in zip(before, state.model.parameters()))
    holder = WavBEST(CHANNELS, device="cpu")
    holder.load_state_dict(ema)
    ref = Pansharpener(holder, n_timestep=10, device="cpu").sample(batch, sensor="QB", steps=3)
    # the CPU's fp32 matmuls block their sums by the operands' addresses:
    # 1.8e-7 measured between the two models
    np.testing.assert_allclose(got, ref, atol=1e-6)
    own = sharp.sample(batch, sensor="QB", steps=3)
    assert np.abs(own - got).max() > 1e-3
    # the next step equals a twin's that never sampled
    twin = _trainer()
    twin_state = twin.init_state()
    twin_state.load_state_dict(state.state_dict())
    b, p = _batch(11)
    trainer.train_step(state, b, p)
    twin.train_step(twin_state, b, p)
    _assert_same(state, twin_state)
    with pytest.raises(RuntimeError):
        sharp.sample(batch, sensor="QB", steps=3, params=dict(list(ema.items())[:-1]))
