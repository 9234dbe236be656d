"""The port's training slice (tmdiff_tpu_torch/train, diffusion/gaussian.py,
the conv kernel's backward, dropout, init styles) against the JAX package on
the CPU, where every 3x3x3 conv and its input gradient run the kernel's
plain version. Tiny widths (8, 16, 32, 64) at 16x16; each tolerance is stated
beside its check with the value measured when it was set."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from tmdiff_tpu.diffusion import gaussian as jax_gaussian
from tmdiff_tpu.diffusion.schedules import NoiseSchedule as JaxNoiseSchedule
from tmdiff_tpu.models import WavBEST as JaxWavBEST
from tmdiff_tpu.models.init_styles import apply_init_style as jax_apply_init_style
from tmdiff_tpu.ops.pallas import banded_conv3d as pallas_conv
from tmdiff_tpu.train import losses as jax_losses
from tmdiff_tpu.train.ema import ema_update as jax_ema_update
from tmdiff_tpu.train.trainer import hf_linear_schedule as jax_hf_linear_schedule
from tmdiff_tpu_torch.diffusion import gaussian
from tmdiff_tpu_torch.diffusion.schedules import NoiseSchedule
from tmdiff_tpu_torch.models import blocks
from tmdiff_tpu_torch.models.clip_text import load_prompt_table
from tmdiff_tpu_torch.models.init_styles import STYLES, apply_init_style
from tmdiff_tpu_torch.models.wavbest import WavBEST
from tmdiff_tpu_torch.ops import modconv
from tmdiff_tpu_torch.ops.cuda import conv3d as K
from tmdiff_tpu_torch.train import losses
from tmdiff_tpu_torch.train.ema import ema_update
from tmdiff_tpu_torch.train.trainer import Trainer, hf_linear_schedule, step_seeds
from tmdiff_tpu_torch.utils.weights import from_flax, torch_key

torch.set_num_threads(2)

CHANNELS = (8, 16, 32, 64)
T = 1000


def _t(a):
    return torch.as_tensor(np.asarray(a, np.float32))


def _rel_to_scale(got, ref):
    """max |got - ref| / max |ref|."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return np.abs(got - ref).max() / np.abs(ref).max()


def _jax_tree(model):
    x = jnp.zeros((1, 4, 16, 16))
    return jax.eval_shape(model.init, jax.random.key(0), x, jnp.ones(1), x[:, :1], x,
                          jnp.zeros(768))


def _random_params(tree, seed=0):
    """Seeded numpy values for a JAX WavBEST tree: lecun-scaled kernels,
    small random biases, style biases near 1."""
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        names = [str(p.key) for p in path]
        if names[-1] == "kernel":
            fan_in = int(np.prod(leaf.shape[:-1]))
            return (rng.standard_normal(leaf.shape) / np.sqrt(fan_in)).astype(np.float32)
        base = 1.0 if "style" in names else 0.0
        return (base + 0.1 * rng.standard_normal(leaf.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, tree)


def _as_port(tree):
    """A JAX-layout tree (params or gradients) as the port's state_dict."""
    return from_flax(WavBEST(CHANNELS, device="cpu"), jax.tree.map(np.asarray, tree)).state_dict()


@pytest.fixture(scope="module")
def carried():
    jmodel = JaxWavBEST(channels=CHANNELS)
    params = _random_params(_jax_tree(jmodel))
    return jmodel, params


def _batch(bands=4, seed=0, b=2):
    rng = np.random.default_rng(seed)
    ms = rng.uniform(0.05, 0.95, (b, bands, 16, 16)).astype(np.float32)
    pan = (ms.mean(1, keepdims=True) + 0.05 * rng.standard_normal((b, 1, 16, 16))).astype(np.float32)
    res = (0.1 * rng.standard_normal((b, bands, 16, 16))).astype(np.float32)
    return {"Res": res, "PAN": pan, "MS": ms}


def _prompt(sensor="QB"):
    table, index, _ = load_prompt_table()
    return np.asarray(table[index[sensor]], np.float32)


# -- the conv kernel's backward ----------------------------------------------


def test_conv_backward_matches_jax_vjp(rng):
    """Conv3dFunction's backward (plain on the CPU: the input gradient as the
    forward conv of dy with the flipped, transposed kernel) against jax.vjp
    of the JAX package's K1 (Pallas in interpret mode, its custom VJP) at a
    shape the TPU kernel takes; to 1e-5 of each gradient's largest magnitude
    (measured 5.0e-7 for dx, 4.8e-7 for dW)."""
    x = rng.standard_normal((2, 8, 8, 8, 16)).astype(np.float32)
    k = (rng.standard_normal((3, 3, 3, 16, 32)) / np.sqrt(27 * 16)).astype(np.float32)
    g = rng.standard_normal((2, 8, 8, 8, 32)).astype(np.float32)
    y, vjp = jax.vjp(pallas_conv.banded_conv3d, jnp.asarray(x), jnp.asarray(k))
    jdx, jdk = vjp(jnp.asarray(g))
    xt, kt = _t(x).requires_grad_(), _t(k).requires_grad_()
    yt = K.banded_conv3d(xt, kt)
    yt.backward(_t(g))
    assert yt.grad_fn is not None and K.launches == 0
    assert _rel_to_scale(yt.detach(), y) <= 1e-5
    assert _rel_to_scale(xt.grad, jdx) <= 1e-5
    assert _rel_to_scale(kt.grad, jdk) <= 1e-5


def _f_conv3d(x, k, style=None, bias=None):
    """F.conv3d of NDHWC x with a (3, 3, 3, Cin, Cout) kernel, autograd's."""
    if style is not None:
        x = x * style[:, None, None, None, :]
    y = F.conv3d(x.permute(0, 4, 1, 2, 3), k.permute(4, 3, 0, 1, 2), bias, padding=1)
    return y.permute(0, 2, 3, 4, 1)


@pytest.mark.parametrize("case", ["style_bias", "parts", "group_views", "v2_accumulate"])
def test_conv_backward_matches_f_conv3d(rng, case):
    """Gradients of every operand through the port's conv entries against
    F.conv3d's autograd in float64: style and bias, concat parts (kernel
    slices along Cin, added out of place), the grouped skip conv's Cout
    slices of one weight, and the K2 entry accumulating into `out`; to 1e-5
    of each gradient's largest magnitude (measured at most 4.3e-7)."""
    d64 = lambda a: torch.as_tensor(a, dtype=torch.float64).requires_grad_()
    d32 = lambda a: torch.as_tensor(a, dtype=torch.float32).requires_grad_()
    x = rng.standard_normal((2, 4, 6, 5, 12))
    w = rng.standard_normal((3, 3, 3, 12, 18)) / np.sqrt(27 * 12)
    s = 1.0 + 0.5 * rng.standard_normal((2, 12))
    b = rng.standard_normal(18)
    gy = rng.standard_normal((2, 4, 6, 5, 18))
    out0 = rng.standard_normal((2, 4, 6, 5, 18))

    def run(conv, to):
        xs, ws, ss, bs = to(x), to(w), to(s), to(b)
        if case == "style_bias":
            y = conv(xs, ws, ss, bs)
        elif case == "parts":
            y = conv((xs[..., :4], xs[..., 4:9], xs[..., 9:]), ws, None, bs)
        elif case == "group_views":
            y = torch.cat([conv(xs, ws[..., g * 6:(g + 1) * 6], None, bs[g * 6:(g + 1) * 6])
                           for g in range(3)], -1)
        else:
            y = conv(xs, ws, ss, bs, out=to(out0) * 1.0)
        (y * torch.as_tensor(gy, dtype=y.dtype)).sum().backward()
        return y, [t.grad for t in (xs, ws, ss, bs)]

    def port(xs, ws, ss, bs, out=None):
        if isinstance(xs, tuple):
            return modconv.conv3d_cat(xs, ws, bias=bs)
        if out is not None:
            return K.banded_conv3d_v2(xs, ws, ss, bs, out=out)
        return modconv.conv3d(xs, ws, style=ss, bias=bs)

    def ref(xs, ws, ss, bs, out=None):
        if isinstance(xs, tuple):
            xs = torch.cat(xs, -1)
        y = _f_conv3d(xs, ws, ss, bs)
        return y if out is None else y + out

    y, grads = run(port, d32)
    y_ref, grads_ref = run(ref, d64)
    assert _rel_to_scale(y.detach(), y_ref.detach()) <= 1e-5
    for name, g, gr in zip(("x", "kernel", "style", "bias"), grads, grads_ref):
        if gr is None:
            assert g is None, name
            continue
        assert _rel_to_scale(g, gr) <= 1e-5, name


def test_conv_grad_without_grad_launches_directly():
    """No operand needs a gradient: the result carries no graph (the entry
    launches the kernel directly); under a gradient it has one."""
    x, k = torch.randn(1, 3, 4, 4, 4), torch.randn(3, 3, 3, 4, 8)
    assert K.banded_conv3d(x, k).grad_fn is None
    assert K.banded_conv3d(x, k.requires_grad_()).grad_fn is not None
    with torch.no_grad():
        assert K.banded_conv3d(x, k).grad_fn is None


def test_auto_lowering_refuses_gradients():
    x = torch.randn(1, 4, 8, 8, 8)
    k = torch.randn(3, 3, 3, 8, 8, requires_grad=True)
    with pytest.raises(ValueError, match='"auto" conv lowering has no backward'):
        modconv.conv3d(x, k, impl="auto")
    model = WavBEST(CHANNELS, device="cpu").use_conv_impl("auto")
    with pytest.raises(ValueError, match='needs the "banded" conv lowering'):
        Trainer(model, NoiseSchedule.create("cosine", 10))


# -- schedule, EMA, losses -----------------------------------------------------


def test_schedule_ema_losses_match_jax(rng):
    """hf_linear_schedule (float64 here, float32 in JAX), ema_update (float32
    factors as in JAX) and the pixel losses; rtol 1e-6 (measured 9.9e-8)."""
    for args in ((1e-3, 100, 1000), (2e-3, 2, 1000), (1e-4, 0, 10)):
        fn, jfn = hf_linear_schedule(*args), jax_hf_linear_schedule(*args)
        for step in (0, 1, 2, 50, 99, 100, 101, 550, 999, 1000, 2000):
            np.testing.assert_allclose(fn(step), float(jfn(step)), rtol=1e-6, atol=0)
    e, p = rng.standard_normal((2, 5, 7)).astype(np.float32)
    for step, start in ((1, 0), (5, 5), (6, 5)):
        got = ema_update([_t(e).clone()], [_t(p)], step, 0.9999, start)[0]
        want = jax_ema_update({"w": jnp.asarray(e)}, {"w": jnp.asarray(p)}, step, 0.9999, start)
        np.testing.assert_allclose(got.numpy(), np.asarray(want["w"]), rtol=1e-6)
    pred, target = (rng.standard_normal((2, 3, 4, 4)).astype(np.float32) * 2 for _ in range(2))
    for name in ("l1", "l2", "smooth_l1"):
        want = float(getattr(jax_losses, name)(jnp.asarray(pred), jnp.asarray(target)))
        np.testing.assert_allclose(float(getattr(losses, name)(_t(pred), _t(target))), want,
                                   rtol=1e-6)
        np.testing.assert_allclose(
            float(gaussian.pixel_loss(_t(pred), _t(target), name)),
            float(jax_gaussian.pixel_loss(jnp.asarray(pred), jnp.asarray(target), name)),
            rtol=1e-6)
    x = _t(rng.standard_normal((2, 3)) * 3)
    for mode in ("static", "dynamic", "none"):
        np.testing.assert_allclose(gaussian.clip_x0(x, mode).numpy(),
                                   np.asarray(jax_gaussian.clip_x0(jnp.asarray(x.numpy()), mode)),
                                   rtol=1e-6)
    meter = losses.AverageMeter()
    for v in (1.0, 2.0, 6.0):
        meter.update(v)
    assert meter.avg == 3.0


# -- the loss and its gradients against JAX ------------------------------------


def test_diffusion_loss_and_gradients_match_jax(carried):
    """The x0 L1 loss with t and noise drawn by JAX's own split of the key
    and handed to the port, on the same weights (from_flax), eval mode;
    the loss to 1e-5 relative (measured 4.2e-7) and every parameter's
    gradient to 1e-4 of that gradient's largest magnitude (measured at most
    4.1e-6)."""
    jmodel, params = carried
    ns = JaxNoiseSchedule.create("cosine", T)
    batch, prompt = _batch(), _prompt()
    key = jax.random.key(5)

    def jloss(p):
        return jax_gaussian.diffusion_loss(
            lambda x, t, pan, ms: jmodel.apply(p, x, t, pan, ms, jnp.asarray(prompt)), ns, key,
            *(jnp.asarray(batch[k]) for k in ("Res", "PAN", "MS")), "l1")

    want, jgrads = jax.jit(jax.value_and_grad(jloss))(params)
    rng_t, rng_noise = jax.random.split(key)
    t = jax.random.randint(rng_t, (2,), 1, T + 1)
    noise = jax.random.normal(rng_noise, batch["Res"].shape, jnp.float32)

    port = from_flax(WavBEST(CHANNELS, device="cpu"), jax.tree.map(np.asarray, params))
    loss = gaussian.diffusion_loss(
        lambda x, tt, pan, ms: port(x, tt, pan, ms, _t(prompt)), NoiseSchedule.create("cosine", T),
        None, *(_t(batch[k]) for k in ("Res", "PAN", "MS")), "l1",
        t=torch.as_tensor(np.array(t), dtype=torch.int64), noise=_t(noise))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want), rtol=1e-5)
    ref = _as_port(jgrads)
    for name, p in port.named_parameters():
        assert _rel_to_scale(p.grad, ref[name]) <= 1e-4, name


def test_optimizer_step_matches_optax(carried):
    """From equal gradients, three steps of AdamW (wd 1e-4) under the HF
    schedule (warmup 2, so steps 1 and 2 have lr > 0) and the EMA, against
    optax.adamw and the JAX ema_update run on the same numbers (every leaf
    flattened into one vector: both updates are elementwise); to 1e-6
    (measured 2.4e-7 absolute on the parameters, 1.2e-7 on the EMA)."""
    jmodel, params = carried
    port = from_flax(WavBEST(CHANNELS, device="cpu"), jax.tree.map(np.asarray, params))
    flat = lambda ts: np.concatenate([np.asarray(t, np.float32).ravel() for t in ts])
    rng = np.random.default_rng(9)
    grads = [[rng.standard_normal(p.shape).astype(np.float32) for p in port.parameters()]
             for _ in range(3)]
    lr_fn = jax_hf_linear_schedule(1e-3, 2, 1000)
    tx = optax.adamw(learning_rate=lr_fn, weight_decay=1e-4)
    jp = {"w": jnp.asarray(flat(p.detach() for p in port.parameters()))}
    opt_state, ema = tx.init(jp), jp
    for step, g in enumerate(grads):
        updates, opt_state = tx.update({"w": jnp.asarray(flat(g))}, opt_state, jp)
        jp = optax.apply_updates(jp, updates)
        ema = jax_ema_update(ema, jp, step + 1, 0.9, 0)

    trainer = Trainer(port, NoiseSchedule.create("cosine", 10), lr=1e-3, warmup_steps=2,
                      max_iter=1000, ema_decay=0.9)
    state = trainer.init_state()
    for g in grads:
        for p, gp in zip(port.parameters(), g):
            p.grad = torch.as_tensor(gp)
        trainer.apply_gradients(state)
    assert state.step == 3
    np.testing.assert_allclose(flat(p.detach() for p in port.parameters()), np.asarray(jp["w"]),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(flat(state.ema_params), np.asarray(ema["w"]), rtol=1e-6, atol=1e-6)


# -- dropout, remat, determinism, learning ------------------------------------


def test_dropout_statistics():
    """Keep rate 0.8 +- 0.01 over 1e6 elements, kept values scaled by 1.25,
    masks independent per draw, one seed giving the same masks."""
    x = torch.ones(1000, 1000)
    g = torch.Generator().manual_seed(0)
    a, b = blocks.dropout(x, 0.2, g), blocks.dropout(x, 0.2, g)
    keep_a, keep_b = a != 0, b != 0
    assert abs(keep_a.float().mean().item() - 0.8) <= 0.01
    assert torch.all(a[keep_a] == 1.25)
    # independent masks: P(both kept) ~ 0.64
    assert abs((keep_a & keep_b).float().mean().item() - 0.64) <= 0.01
    again = blocks.dropout(x, 0.2, torch.Generator().manual_seed(0))
    assert torch.equal(again, a)
    assert blocks.dropout(x, 0.2, None) is x


def test_resblock_parts_draw_independent_masks():
    """A tuple input draws one mask per part, in turn from the generator."""
    torch.manual_seed(0)
    block = blocks.ResBlockModulate(6, 4, 8, use_temb=False)
    seen = []
    real = blocks.dropout

    def spy(x, rate, rng, mesh=None):
        out = real(x, rate, rng, mesh)
        seen.append(out != 0)
        return out

    parts = tuple(torch.full((1, 2, 4, 4, 2), 5.0) for _ in range(3))
    blocks.dropout = spy
    try:
        block(parts, None, torch.randn(1, 8), torch.Generator().manual_seed(1))
    finally:
        blocks.dropout = real
    assert len(seen) == 4  # three parts, then before conv21
    assert not torch.equal(seen[0], seen[1]) and not torch.equal(seen[1], seen[2])


def _tiny_trainer(remat=True, seed=3407, **kw):
    model = WavBEST(CHANNELS, device="cpu", seed=0)
    return Trainer(model, NoiseSchedule.create("cosine", 100), lr=2e-3, warmup_steps=2,
                   max_iter=1000, remat=remat, seed=seed, **kw)


def test_remat_gives_the_same_gradients():
    """Dropout on, one step seed: the recompute draws the same masks, so
    remat on and off give bit-identical losses and gradients."""
    batch = {k: _t(v) for k, v in _batch().items()}
    out = []
    for remat in (True, False):
        trainer = _tiny_trainer(remat)
        loss = trainer.loss(7, batch, _t(_prompt()))
        grads = torch.autograd.grad(loss, list(trainer.model.parameters()))
        out.append((loss.detach(), grads))
    assert torch.equal(out[0][0], out[1][0])
    assert all(torch.equal(a, b) for a, b in zip(out[0][1], out[1][1]))
    # dropout is on: another step's seed gives another loss
    trainer = _tiny_trainer()
    assert not torch.equal(trainer.loss(8, batch, _t(_prompt())).detach(), out[0][0])


def test_step_seeds_and_trajectory_are_deterministic():
    """The same seed gives the same loss trajectory bit for bit; another seed
    another one."""
    def run(seed):
        trainer = _tiny_trainer(seed=seed, p_uncond=0.3)
        state = trainer.init_state()
        return [float(trainer.train_step(state, _batch(seed=i), _prompt())[1]["l_pix"])
                for i in range(3)]

    assert step_seeds(1, 2) == step_seeds(1, 2) != step_seeds(1, 3)
    first = run(11)
    assert first == run(11)
    assert first != run(12)


def test_loss_decreases():
    """16 steps at lr 2e-3 (warmup 2) on one synthetic 4-band batch of 8:
    the mean of the last four losses below the first four's, as
    tests/test_train.py asks of the JAX trainer."""
    from tmdiff_tpu_torch.data.h5 import PanDataset
    from tmdiff_tpu_torch.data.pipeline import BatchIterator
    from tmdiff_tpu_torch.data.synthetic import make_arrays

    it = BatchIterator(PanDataset(make_arrays(n=8, bands=4, size=16, seed=0)), 8, seed=0)
    trainer = _tiny_trainer()
    state = trainer.init_state()
    before = [p.detach().clone() for p in trainer.model.parameters()]
    out = [trainer.train_step(state, next(it), _prompt())[1] for _ in range(16)]
    losses_ = [float(m["l_pix"]) for m in out]
    assert state.step == 16 and np.isfinite(losses_).all()
    assert np.mean(losses_[-4:]) < np.mean(losses_[:4]), losses_
    assert out[0]["lr"] == 0.0 and out[2]["lr"] == pytest.approx(2e-3)
    assert all(float(m["grad_norm"]) > 0 for m in out)
    moved = [not torch.equal(a, b) for a, b in zip(before, trainer.model.parameters())]
    ema_moved = [not torch.equal(a, b) for a, b in zip(before, state.ema_params)]
    assert all(moved) and all(ema_moved)


def test_cfg_dropout_condition():
    """Per-sample coins zero whole examples; the per-batch coin all or none;
    p = 1 zeros everything and p = 0 nothing."""
    ms = torch.randn(64, 4, 2, 2)
    g = torch.Generator().manual_seed(0)
    out = gaussian.cfg_dropout_condition(g, ms, 0.5, per_sample=True)
    kept = out.reshape(64, -1).abs().amax(1) > 0
    assert 10 < kept.sum() < 54
    assert torch.equal(out[kept], ms[kept])
    outb = gaussian.cfg_dropout_condition(g, ms, 0.5)
    assert torch.equal(outb, ms) or not outb.any()
    assert not gaussian.cfg_dropout_condition(g, ms, 1.0, per_sample=True).any()
    assert torch.equal(gaussian.cfg_dropout_condition(g, ms, 0.0, per_sample=True), ms)


# -- init styles --------------------------------------------------------------


# the JAX style is applied to these modules' subtree (its rules look only at a
# leaf's own path and its siblings): conv kernels and biases, 1x1x1 convs,
# style and temb Dense layers, a grouped skip conv and the prompt MLP
INIT_MODULES = ("conv1", "down1", "up1", "final", "embed2")


@pytest.mark.parametrize("style", STYLES)
def test_init_styles_match_jax_rules(carried, style):
    """Leaf by leaf against the JAX package's apply_init_style: zero and unit
    biases equal, leaves the style keeps unchanged equal, "torch"'s uniform
    leaves inside +-1/sqrt(fan_in) in both (within 2 % of it and standard
    deviations within 15 % of each other for leaves of 500 elements or
    more), other standard deviations within 15 % at 500 elements or more,
    and orthogonal weights orthogonal to 1e-5."""
    jmodel, params = carried
    sub = {"params": {k: params["params"][k] for k in INIT_MODULES}}
    jtree = jax_apply_init_style(sub, style, jax.random.key(0))
    want = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(jtree)[0]:
        key, kind = torch_key(tuple(str(p.key) for p in path))
        arr = np.array(leaf)
        want[key] = torch.as_tensor(arr.reshape(arr.shape[-2:]).T if kind == "linear" else arr)
    model = from_flax(WavBEST(CHANNELS, device="cpu"), jax.tree.map(np.asarray, params))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    apply_init_style(model, style, torch.Generator().manual_seed(0))
    got = model.state_dict()
    assert len(want) > 60 and set(want) <= set(got)
    for name, w in want.items():
        g = got[name]
        assert g.shape == w.shape, name
        if torch.equal(w, before[name]):
            assert torch.equal(g, before[name]), name
        elif not w.any() or torch.all(w == 1.0):
            assert torch.equal(g, w), name
        elif style == "torch" and g.dim() in (1, 5):
            bound = 1.0 / np.sqrt(np.prod(got[name.replace(".bias", ".weight")].shape[:-1]))
            assert max(g.abs().max().item(), w.abs().max().item()) <= bound * (1 + 1e-6), name
            if g.numel() >= 500:
                assert g.abs().max().item() >= 0.98 * bound, name
                assert abs(g.std().item() / w.std().item() - 1.0) <= 0.15, name
        elif g.numel() >= 500:
            assert abs(g.std().item() / w.std().item() - 1.0) <= 0.15, name
        if style == "orthogonal" and g.dim() in (2, 5):
            flat_w = g.T if g.dim() == 2 else g.reshape(-1, g.shape[-1])
            gram = flat_w.T @ flat_w if flat_w.shape[0] >= flat_w.shape[1] else flat_w @ flat_w.T
            assert torch.allclose(gram, torch.eye(gram.shape[0]), atol=1e-5), name
