"""bf16 training of the port on the CPU against the JAX package's bf16
training: the conv's backward (`Conv3dFunction` in bf16: K1's input gradient
as the bf16 plain version, the bf16 weight gradient) against jax.vjp of the
JAX K1 and modulated conv in bf16, one bf16 WavBEST loss and every gradient
through `Trainer.loss` against jax.value_and_grad of the JAX bf16 model's
`diffusion_loss`, three bf16 training steps (fp32 parameters, AdamW state
and EMA; bit-identical again from the same seed), and the bf16
`DistillTrainer` loss against the JAX distillation loss. Inputs are made
with numpy from a seed; the JAX side runs K1 as tests/test_torch_bf16.py
does (the banded lowering, Pallas in interpret mode, at SIZE 32).

The bars:
  * ROUNDING BAR (the conv's gradients), test_torch_bf16.py's: each element
    within half a bf16 step of every bf16 rounding either side makes, plus
    1e-6 of scale. dx = d(x s) * s carries the two sides' roundings of
    d(x s) through the product: each is within one half step of dx, so dx
    takes three half steps a side. ds and db are fp32 sums of the bf16
    products, rounded once (the port's rule), held against the fp32 sums of
    the JAX VJP's own d(x s) and dy: XLA:CPU accumulates the JAX VJP's bf16
    reduce_sum over the broadcast axes in bf16, which puts its own ds and db
    more than 1e-2 of their scale off the fp32 sums at this test's 8192
    terms (the test asserts it), so those two are no reference of a
    rounding's width.
  * MODEL BAR (a loss and its gradients): every parameter's gradient gap to
    JAX-bf16 (max |difference| over max |JAX-fp32 gradient|) within twice
    JAX-bf16's own gap to JAX-fp32, that own gap floored at the median own
    gap over all parameters (a gradient's own gap is one draw of bf16 noise:
    in the sweep of tests/bf16_grad_sweep.py, six runs over 4 and 8 bands
    and three weight seeds at 32x32, the raw ratio reached 4.64 where a
    draw was small, at most 1.67 against the floored gap); and each gradient
    within 5e-2 of its scale of JAX-fp32, the cap the sweep supports (the
    port's gap to JAX-fp32 reached 0.043; JAX-bf16's own reached
    0.94, on the bias gradients it accumulates in bf16). The loss within
    2e-2 of JAX-bf16's and of JAX-fp32's (the forward's MODEL cap; the sweep
    reached 1.6e-2). The losses are L2: an L1 gradient is sign(pred -
    target), and bf16's forward noise flips the sign of elements near their
    target on either side, noise that says nothing of the backward (with L1
    the port's gap to JAX-fp32 reached 0.134 in the same sweep).
"""
import flax.linen as flax_nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flax_params import random_flax_params
from test_torch_bf16 import assert_within_roundings
from tmdiff_tpu.diffusion import gaussian as jax_gaussian
from tmdiff_tpu.diffusion.schedules import NoiseSchedule as JaxNoiseSchedule
from tmdiff_tpu.models import WavBEST as JaxWavBEST
from tmdiff_tpu.ops import modconv as jax_modconv
from tmdiff_tpu.ops.pallas import banded_conv3d as pallas_conv
from tmdiff_tpu.train import distill as jax_distill
from tmdiff_tpu_torch.diffusion.schedules import NoiseSchedule
from tmdiff_tpu_torch.models import blocks
from tmdiff_tpu_torch.models.wavbest import WavBEST
from tmdiff_tpu_torch.ops.cuda import conv3d as K
from tmdiff_tpu_torch.train.distill import DistillTrainer
from tmdiff_tpu_torch.train.trainer import Trainer
from tmdiff_tpu_torch.utils.weights import from_flax

torch.set_num_threads(2)

CHANNELS = (8, 16, 32, 64)
SIZE = 32  # the smallest size at which the JAX model's banded lowering takes Pallas K1
GRAD_CAP = 5e-2
LOSS_CAP = 2e-2


def _np(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32), np.float64)


def _bf(a):
    """numpy (float32) -> the bf16-rounded values as float32 numpy."""
    return _np(jnp.asarray(a, jnp.float32).astype(jnp.bfloat16)).astype(np.float32)


@pytest.fixture
def jax_banded(monkeypatch):
    """The JAX package's "banded" lowering (Pallas K1 where eligible)."""
    monkeypatch.setattr(jax_modconv, "CONV3D_IMPL", "banded")


def test_bf16_conv_gradients_match_jax_vjp(rng, jax_banded):
    """Conv3dFunction in bf16 on the plain path (the CPU): with style and
    bias, the gradients of x, the kernel (through its cast to bf16), the
    style and the bias against jax.vjp (eager) of the JAX package's bf16
    `modulated_conv3d` + bias at a shape the Pallas K1 takes; the bare conv's
    dx and dW against jax.vjp of `banded_conv3d` itself. ROUNDING BAR."""
    b, d, h, w, cin, cout = 2, 8, 16, 8, 16, 32
    x = _bf(rng.standard_normal((b, d, h, w, cin)))
    k = (rng.standard_normal((3, 3, 3, cin, cout)) / np.sqrt(27 * cin)).astype(np.float32)
    s = _bf(1 + 0.5 * rng.standard_normal((b, cin)))
    bias = _bf(0.1 * rng.standard_normal(cout))
    dy = _bf(rng.standard_normal((b, d, h, w, cout)))
    jb = lambda a: jnp.asarray(a).astype(jnp.bfloat16)

    def port(style, with_bias):
        xt = torch.tensor(x).bfloat16().requires_grad_()
        kt = torch.tensor(k).requires_grad_()
        st = torch.tensor(s).bfloat16().requires_grad_()
        bt = torch.tensor(bias).bfloat16().requires_grad_()
        y = K.banded_conv3d(xt, kt.bfloat16(), st if style else None, bt if with_bias else None)
        assert y.dtype == torch.bfloat16 and y.grad_fn is not None
        y.backward(torch.tensor(dy).bfloat16())
        grads = (xt.grad, kt.grad, st.grad, bt.grad)
        assert all(g is None or g.dtype == t.dtype for g, t in zip(grads, (xt, kt, st, bt)))
        return [None if g is None else g.float().numpy() for g in grads]

    # the bare conv: K1's input gradient route and the bf16 weight gradient
    _, vjp = jax.vjp(pallas_conv.banded_conv3d, jb(x), jnp.asarray(k))
    jdx, jdk = (_np(g) for g in vjp(jb(dy)))
    gx, gk, gs, gb = port(False, False)
    assert gs is None and gb is None
    assert_within_roundings(gx, jdx, [gx, jdx])
    assert_within_roundings(gk, jdk, [gk, jdk])

    # the modulated conv with its bias
    def jax_fn(x, k, s, bias):
        y = jax_modconv.modulated_conv3d(x, k, s)
        return y + bias.astype(y.dtype)

    _, vjp = jax.vjp(jax_fn, jb(x), jnp.asarray(k), jb(s), jb(bias))
    jdx, jdk, jds, jdb = (_np(g) for g in vjp(jb(dy)))
    xs = jb(x) * jb(s)[:, None, None, None, :]
    _, vjp = jax.vjp(pallas_conv.banded_conv3d, xs, jnp.asarray(k))
    jdxs = _np(vjp(jb(dy))[0])  # the JAX VJP's d(x s), bf16
    gx, gk, gs, gb = port(True, True)
    assert_within_roundings(gx, jdx, [gx, jdx] * 3)
    assert_within_roundings(gk, jdk, [gk, jdk])
    ds_ref = _bf((x.astype(np.float64) * jdxs).sum((1, 2, 3)))
    db_ref = _bf(dy.astype(np.float64).sum((0, 1, 2, 3)))
    assert_within_roundings(gs, ds_ref, [gs, ds_ref])
    assert_within_roundings(gb, db_ref, [gb, db_ref])
    # why not JAX's own ds and db: they stray from the fp32 sums by percents
    # of their scale (module doc)
    off = lambda got, ref: np.abs(got - ref).max() / np.abs(ref).max()
    assert off(jds, ds_ref) > 1e-2 and off(jdb, db_ref) > 1e-2


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_dropout_scales_kept_elements_as_flax(dtype):
    """The port's dropout divides a kept element by 1 - rate in x's dtype,
    rounded once: bit for bit what flax's Dropout computes for the same
    element (`inputs / keep_prob`, the Python float taking x's dtype), in
    bf16 and in fp32; dropped elements are zero."""
    x = np.random.default_rng(4).standard_normal(20000).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    want = _np(jnp.asarray(x).astype(jdt) / (1.0 - blocks.DROPOUT))
    xt = torch.as_tensor(_np(jnp.asarray(x).astype(jdt)), dtype=torch.float32).to(dtype)
    got = blocks.dropout(xt, blocks.DROPOUT, torch.Generator().manual_seed(0))
    kept = (got != 0).numpy()
    assert got.dtype == dtype and 0.75 < kept.mean() < 0.85
    np.testing.assert_array_equal(got.float().numpy()[kept], want[kept])


class _NoDropout(flax_nn.Module):
    """flax's Dropout as the identity, for a comparison without masks."""
    rate: float
    deterministic: bool = None

    @flax_nn.compact
    def __call__(self, x, deterministic=None, rng=None):
        return x


def _batch(bands, seed, b=2):
    rng = np.random.default_rng(seed)
    ms = rng.uniform(0.05, 0.95, (b, bands, SIZE, SIZE)).astype(np.float32)
    pan = (ms.mean(1, keepdims=True)
           + 0.05 * rng.standard_normal((b, 1, SIZE, SIZE))).astype(np.float32)
    res = (0.1 * rng.standard_normal((b, bands, SIZE, SIZE))).astype(np.float32)
    return {"Res": res, "PAN": pan, "MS": ms}, rng.standard_normal(768).astype(np.float32)


def _t(a):
    return torch.as_tensor(np.asarray(a, np.float32))


def assert_gradients_model_bar(grads, ref32, ref16):
    """MODEL BAR (module doc) on every gradient of `grads` ({name: port
    gradient}) against `ref32` and `ref16` (JAX's fp32 and bf16 gradients
    under the port's names)."""
    rows = {}
    for name, g in grads.items():
        assert g.dtype == torch.float32, name
        got, a, b = (np.asarray(t, np.float64) for t in (g, ref32[name], ref16[name]))
        scale = np.abs(a).max()
        rows[name] = (np.abs(got - b).max() / scale, np.abs(b - a).max() / scale,
                      np.abs(got - a).max() / scale)
    floor = np.median([own for _, own, _ in rows.values()])
    for name, (gap, own, to_fp32) in rows.items():
        assert gap <= 2 * max(own, floor) and to_fp32 < GRAD_CAP, (name, gap, own, floor, to_fp32)


def assert_wavbest_gradients(port, grads32, grads16):
    """The bar on a WavBEST's parameters (float32, as their gradients) from
    JAX gradient trees."""
    as_port = lambda tree: from_flax(WavBEST(CHANNELS, device="cpu"),
                                     jax.tree.map(np.asarray, tree)).state_dict()
    assert all(p.dtype == torch.float32 for p in port.parameters())
    assert_gradients_model_bar({n: p.grad for n, p in port.named_parameters()},
                               as_port(grads32), as_port(grads16))


def assert_loss_bar(got, jax16, jax32):
    assert abs(got - jax16) <= LOSS_CAP * abs(jax32), (got, jax16, jax32)
    assert abs(got - jax32) <= LOSS_CAP * abs(jax32), (got, jax16, jax32)


def test_bf16_loss_and_gradients_match_jax(monkeypatch, jax_banded):
    """`Trainer.loss` of a bf16 WavBEST (4 bands, batch 2, SIZE x SIZE,
    remat on) on from_flax weights, t and noise drawn by JAX's split of the
    key and handed to the port, dropout off on both sides (the masks cannot
    match), against jax.value_and_grad of the JAX bf16 model's
    `diffusion_loss` (and the fp32 model's, for JAX's own gap): MODEL BAR on
    the loss and every gradient. The loss is float32, the parameters and
    their gradients too."""
    monkeypatch.setattr(blocks, "DROPOUT", 0.0)
    params = random_flax_params(JaxWavBEST(channels=CHANNELS), seed=7)
    batch, prompt = _batch(4, 11)
    ns, key = JaxNoiseSchedule.create("cosine", 1000), jax.random.key(7)
    out = {}
    for dtype in (jnp.float32, jnp.bfloat16):
        model = JaxWavBEST(channels=CHANNELS, dtype=dtype)

        def jloss(p, model=model):
            return jax_gaussian.diffusion_loss(
                lambda x, t, pan, ms: model.apply(p, x, t, pan, ms, jnp.asarray(prompt)), ns, key,
                *(jnp.asarray(batch[k]) for k in ("Res", "PAN", "MS")), "l2")

        out[dtype] = jax.jit(jax.value_and_grad(jloss))(params)
    rng_t, rng_noise = jax.random.split(key)
    t = jax.random.randint(rng_t, (2,), 1, 1001)
    noise = jax.random.normal(rng_noise, batch["Res"].shape, jnp.float32)

    port = from_flax(WavBEST(CHANNELS, device="cpu", dtype=torch.bfloat16),
                     jax.tree.map(np.asarray, params))
    trainer = Trainer(port, NoiseSchedule.create("cosine", 1000), loss_type="l2")
    assert trainer.remat
    loss = trainer.loss(0, {k: _t(v) for k, v in batch.items()}, _t(prompt),
                        t=torch.as_tensor(np.array(t), dtype=torch.int64), noise=_t(noise))
    assert loss.dtype == torch.float32
    loss.backward()
    assert_loss_bar(loss.item(), float(out[jnp.bfloat16][0]), float(out[jnp.float32][0]))
    assert_wavbest_gradients(port, out[jnp.float32][1], out[jnp.bfloat16][1])


def _bf16_trainer(seed=3407):
    model = WavBEST(CHANNELS, device="cpu", seed=0, dtype=torch.bfloat16)
    return Trainer(model, NoiseSchedule.create("cosine", 100), lr=2e-3, warmup_steps=1,
                   max_iter=1000, seed=seed, p_uncond=0.3)


def test_bf16_train_steps_keep_fp32_state_and_repeat(monkeypatch):
    """Three bf16 `train_step`s (dropout on, remat on): the losses are
    finite, the parameters, AdamW's moments and the EMA stay float32 and
    move, every conv forward and input gradient ran in bf16 (the plain
    version's launches recorded by dtype), and a second run from the same
    seed gives the same losses and parameters bit for bit."""
    launches = []
    launch = K._launch

    def record(x, kernel, style, bias, out, input_grad=False, unsharded=None):
        launches.append((x.dtype, input_grad))
        return launch(x, kernel, style, bias, out, input_grad, unsharded)

    monkeypatch.setattr(K, "_launch", record)

    def run():
        trainer = _bf16_trainer()
        state = trainer.init_state()
        before = [p.detach().clone() for p in trainer.model.parameters()]
        losses = []
        for i in range(3):
            batch, prompt = _batch(4 + 4 * (i % 2), i)
            batch = {k: v[:, :, :16, :16] for k, v in batch.items()}
            losses.append(float(trainer.train_step(state, batch, prompt)[1]["l_pix"]))
        return trainer, state, before, losses

    trainer, state, before, losses = run()
    params = list(trainer.model.parameters())
    assert np.isfinite(losses).all() and state.step == 3
    assert all(p.dtype == torch.float32 for p in params)
    assert all(e.dtype == torch.float32 for e in state.ema_params)
    moments = [v for st in state.optimizer.state.values() for k, v in st.items() if k != "step"]
    assert len(moments) == 2 * len(params) and all(m.dtype == torch.float32 for m in moments)
    assert all(not torch.equal(p, b) for p, b in zip(params, before))
    assert all(not torch.equal(e, b) for e, b in zip(state.ema_params, before))
    # per step: the forward, remat's recompute and the input gradient of 65 convs
    assert len(launches) == 3 * 3 * 65 and {dt for dt, _ in launches} == {torch.bfloat16}
    assert sum(g for _, g in launches) == 3 * 65
    trainer2, _, _, losses2 = run()
    assert losses2 == losses
    assert all(torch.equal(a, b) for a, b in zip(params, trainer2.model.parameters()))


def test_bf16_distill_loss_and_gradients_match_jax(monkeypatch):
    """The bf16 `DistillTrainer` (student and teacher bf16 WavBESTs from two
    weight seeds, N = 5 of T = 100, the SNR weight, remat, L2) against
    jax.value_and_grad of the JAX DistillTrainer's `_loss_fn` with the bf16
    model (and the fp32 one, for JAX's own gap), the student index and the
    noise drawn by JAX's key and handed to the port, dropout off on both
    sides: MODEL BAR on the loss and every gradient; the teacher takes no
    gradient. The JAX trainer refuses the banded lowering on its device
    mesh, so its convs take its default lowering (XLA's bf16 conv)."""
    monkeypatch.setattr(flax_nn, "Dropout", _NoDropout)
    monkeypatch.setattr(blocks, "DROPOUT", 0.0)
    params = random_flax_params(JaxWavBEST(channels=CHANNELS), 1)
    teacher = random_flax_params(JaxWavBEST(channels=CHANNELS), 2)
    batch, prompt = _batch(4, 12)
    key = jax.random.key(5)
    out = {}
    for dtype in (jnp.float32, jnp.bfloat16):
        jtrainer = jax_distill.DistillTrainer(
            model=JaxWavBEST(channels=CHANNELS, dtype=dtype),
            schedule=JaxNoiseSchedule.create("cosine", 100), n_student_steps=5, loss_type="l2")
        out[dtype] = jax.jit(jax.value_and_grad(jtrainer._loss_fn))(
            params, key, {k: jnp.asarray(v) for k, v in batch.items()}, jnp.asarray(prompt),
            teacher)
    rng_i, rng_noise = jax.random.split(jax.random.fold_in(key, 0))
    i = jax.random.randint(rng_i, (2,), 1, 6)
    noise = jax.random.normal(rng_noise, batch["Res"].shape, jnp.float32)

    new = lambda tree: from_flax(WavBEST(CHANNELS, device="cpu", dtype=torch.bfloat16),
                                 jax.tree.map(np.asarray, tree))
    port, t_port = new(params), new(teacher)
    trainer = DistillTrainer(port, NoiseSchedule.create("cosine", 100), n_student_steps=5,
                             loss_type="l2")
    loss = trainer.loss(0, {k: _t(v) for k, v in batch.items()}, _t(prompt),
                        {n: p.detach() for n, p in t_port.named_parameters()},
                        i=torch.as_tensor(np.array(i), dtype=torch.int64), noise=_t(noise))
    loss.backward()
    assert_loss_bar(loss.item(), float(out[jnp.bfloat16][0]), float(out[jnp.float32][0]))
    assert_wavbest_gradients(port, out[jnp.float32][1], out[jnp.bfloat16][1])
    assert all(p.grad is None for p in t_port.parameters())
