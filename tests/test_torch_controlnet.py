"""The port's ControlNet adapter (tmdiff_tpu_torch/models/controlnet.py) on the
CPU, on the JAX package's own fixture of tests/test_controlnet.py (channels
(8, 12, 16, 20), embed 16, inter 8, batch 2, 4 bands, 16x16, a 3-channel
hint, the control_canny task feature): the JAX models are initialised as
there and the port's filled from their flax trees with `from_flax`.

  * against JAX: the plain and the controlled model at zero init, and a
    live controlled model (every zero conv set off zero), to FORWARD_RTOL of
    scale; `init_control_from_base` and `trainable_labels` name for name;
    two Adam fine-tune steps (lr 1e-2, sd_locked) against
    `optax.multi_transform` at LOSS_RTOL;
  * each invariant of tests/test_controlnet.py: zero-init identity bit for
    bit against the port's LegacyUNet, the control path live,
    `only_mid_control`, the init copy, the gradient split (exact zeros on
    the base encoder and the task hypernetwork), the task-independent MoE
    checkpoint, the hint path's bootstrap in four Adam steps, and a 3-step
    `ddim_sample` steered by the hint;
  * the same two fine-tune steps data-parallel on a gloo (2, 1) world
    (tests/torch_mesh_workers.py::controlnet_finetune) against one process,
    the counterpart of `test_sharded_finetune_matches_single_device`.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tmdiff_tpu.models import controlnet as jcn
from tmdiff_tpu.models.legacy_unet import LegacyUNet as JaxLegacyUNet
from tmdiff_tpu_torch.diffusion import gaussian
from tmdiff_tpu_torch.diffusion.schedules import NoiseSchedule
from tmdiff_tpu_torch.models.controlnet import (
    ALL_TASKS_NUM,
    TASKS_TO_ID,
    ControlledLegacyUNet,
    init_control_from_base,
    inject_base_params,
    task_feature,
    trainable_labels,
    trainable_parameters,
)
from tmdiff_tpu_torch.models.legacy_unet import LegacyUNet
from tmdiff_tpu_torch.parallel.dryrun import run_world
from tmdiff_tpu_torch.utils.weights import _flatten, from_flax, torch_key

torch.set_num_threads(2)

TESTS = os.path.dirname(os.path.abspath(__file__))
CH = (8, 12, 16, 20)
B, D, H, W = 2, 4, 16, 16
KW = dict(embed_dim=16, inter_dim=8)
# a forward against the JAX model on the same weights, of the output's scale
FORWARD_RTOL = 1e-4
# fine-tune losses against optax's and one process's (the JAX sharded test's)
LOSS_RTOL = 1e-5


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def batch():
    k = jax.random.PRNGKey(0)
    ks = jax.random.split(k, 4)
    return dict(x_t=jax.random.normal(ks[0], (B, D, H, W)), t=jnp.array([3.0, 7.0]),
                pan=jax.random.normal(ks[1], (B, D, H, W)),
                ms=jax.random.normal(ks[2], (B, D, H, W)),
                prompt_emb=jax.random.normal(ks[3], (768,)))


@pytest.fixture(scope="module")
def hint():
    return jax.random.normal(jax.random.PRNGKey(9), (B, H, W, 3))


@pytest.fixture(scope="module")
def models(batch, hint):
    """The JAX fixture (base checkpoint injected into the controlled tree)
    and the port's two models filled from it."""
    controlled = jcn.ControlledLegacyUNet(channels=CH, **KW)
    base = JaxLegacyUNet(channels=CH, **KW)
    feat = jcn.task_feature("control_canny")
    cp = controlled.init(jax.random.PRNGKey(1), **batch, hint=hint,
                         task_id=TASKS_TO_ID["control_canny"], task_feat=feat)
    bp = base.init(jax.random.PRNGKey(2), **batch)
    cp = {"params": jcn.inject_base_params(cp["params"], bp["params"])}
    port_c = from_flax(ControlledLegacyUNet(CH, **KW, device="cpu"), _np(cp["params"]))
    port_b = from_flax(LegacyUNet(CH, **KW, device="cpu"), _np(bp["params"]))
    return controlled, base, cp, bp, feat, port_c, port_b


def _t(batch):
    return {k: torch.as_tensor(np.asarray(v)) for k, v in batch.items()}


def _run(model, batch, **kw):
    with torch.no_grad():
        return model(**_t(batch), **kw).numpy()


def _live(params, names=("zero0", "zero4", "hint.zeroconv0", "hint.zeroconv1"), value=0.05):
    """A copy of a flax tree with the named control zero convs' kernels set
    to `value`."""
    params = jax.tree.map(lambda x: x, params)
    control = params["control"]
    for name in names:
        node = control
        for part in name.split("."):
            node = node[part]
        node["kernel"] = jnp.full_like(node["kernel"], value)
    return params


def _rel(got, ref) -> float:
    return float(np.abs(np.asarray(got) - np.asarray(ref)).max() / np.abs(ref).max())


def test_task_table_and_feature():
    assert ALL_TASKS_NUM == 13 and TASKS_TO_ID == jcn.TASKS_TO_ID
    np.testing.assert_array_equal(task_feature("control_hed"),
                                  np.asarray(jcn.task_feature("control_hed")))


def test_zero_init_identity(models, batch, hint):
    """With the zero convs at zero the controlled model is the port's plain
    LegacyUNet bit for bit, with and without a hint; both match JAX."""
    controlled, base, cp, bp, feat, port_c, port_b = models
    y_base = _run(port_b, batch)
    y_ctrl = _run(port_c, batch, hint=torch.as_tensor(np.asarray(hint)), task_id=1,
                  task_feat=feat)
    np.testing.assert_array_equal(y_ctrl, y_base)
    np.testing.assert_array_equal(_run(port_c, batch), y_base)
    assert _rel(y_base, base.apply(bp, **batch)) <= FORWARD_RTOL
    assert _rel(y_ctrl, controlled.apply(cp, **batch, hint=hint, task_id=1,
                                         task_feat=feat)) <= FORWARD_RTOL


def test_live_controlled_model_matches_jax(models, batch, hint):
    """Every control zero conv off zero (the state after training): the port
    against JAX on the same tree, for two tasks, and the control path is
    live (the output moved from the base's)."""
    controlled, _, cp, _, feat, _, port_b = models
    params = _live(cp["params"])
    port = from_flax(ControlledLegacyUNet(CH, **KW, device="cpu"), _np(params))
    for task_id in (1, 5):
        ref = controlled.apply({"params": params}, **batch, hint=hint, task_id=task_id,
                               task_feat=feat)
        got = _run(port, batch, hint=torch.as_tensor(np.asarray(hint)), task_id=task_id,
                   task_feat=feat)
        assert _rel(got, ref) <= FORWARD_RTOL
    assert not np.allclose(got, _run(port_b, batch))


def test_control_path_live(models, batch, hint):
    _, _, cp, _, feat, port_c, _ = models
    h = torch.as_tensor(np.asarray(hint))
    y0 = _run(port_c, batch, hint=h, task_id=1, task_feat=feat)
    nudged = from_flax(ControlledLegacyUNet(CH, **KW, device="cpu"),
                       _np(_live(cp["params"], ("zero4",))))
    assert not np.allclose(y0, _run(nudged, batch, hint=h, task_id=1, task_feat=feat))


def test_only_mid_control(models, batch, hint):
    """With a skip-level zero conv off zero, only_mid_control ignores it."""
    _, _, cp, _, feat, _, _ = models
    params = _np(_live(cp["params"], ("zero0",)))
    h = torch.as_tensor(np.asarray(hint))
    mid_only = from_flax(ControlledLegacyUNet(CH, **KW, only_mid_control=True, device="cpu"),
                         params)
    full = from_flax(ControlledLegacyUNet(CH, **KW, device="cpu"), params)
    y_mid = _run(mid_only, batch, hint=h, task_id=1, task_feat=feat)
    y_full = _run(full, batch, hint=h, task_id=1, task_feat=feat)
    assert not np.allclose(y_mid, y_full)


def test_inject_and_init_control_from_base(models):
    """inject_base_params loads the base's weights into the base modules
    only; init_control_from_base copies conv2, down1-3, middle1 and the
    embedding MLPs into the control branch, the zero convs staying zero:
    the same tree as JAX's init_control_from_base, name for name."""
    _, _, cp, _, _, port_c, port_b = models
    fresh = inject_base_params(ControlledLegacyUNet(CH, **KW, device="cpu", seed=9), port_b)
    for name, v in port_b.state_dict().items():
        assert torch.equal(fresh.state_dict()[name], v), name
    seeded = ControlledLegacyUNet(CH, **KW, device="cpu", seed=9).state_dict()
    for name, v in fresh.state_dict().items():
        if name.split(".")[0] in ("control", "task_hypernet"):
            assert torch.equal(v, seeded[name]), name
    model = from_flax(ControlledLegacyUNet(CH, **KW, device="cpu"), _np(cp["params"]))
    init_control_from_base(model)
    want = from_flax(ControlledLegacyUNet(CH, **KW, device="cpu"),
                     _np(jcn.init_control_from_base(cp["params"]))).state_dict()
    for name, v in model.state_dict().items():
        assert torch.equal(v, want[name]), name
    for key in ("conv2", "down1", "down2", "down3", "middle1"):
        for name, v in getattr(model, key).state_dict().items():
            assert torch.equal(getattr(model.control, key).state_dict()[name], v)
    assert float(model.control.zero4.weight.detach().abs().max()) == 0.0


def test_gradient_split(models, batch, hint):
    """Base encoder and middle, and the task hypernetwork: no gradient (the
    reference's no_grad; the detached style); the control zero convs and the
    decoder: nonzero."""
    _, _, _, _, feat, port_c, _ = models
    y = port_c(**_t(batch), hint=torch.as_tensor(np.asarray(hint)), task_id=1, task_feat=feat)
    names, params = zip(*port_c.named_parameters())
    grads = dict(zip(names, torch.autograd.grad(torch.mean(y ** 2), params,
                                                allow_unused=True)))

    def max_abs(prefix):
        gs = [g for n, g in grads.items() if n.startswith(prefix + ".")]
        assert gs, prefix
        return max(0.0 if g is None else float(g.abs().max()) for g in gs)

    for key in ("conv1", "conv2", "down1", "down1_1", "middle1", "embed", "embed2"):
        assert max_abs(key) == 0.0, key
    assert max_abs("control.zero4") > 0.0
    assert max_abs("up1") > 0.0
    assert max_abs("task_hypernet") == 0.0


@pytest.mark.parametrize("sd_locked", [True, False])
def test_trainable_labels_equal_jax(models, sd_locked):
    """The port's labels equal JAX's label tree, name for name."""
    _, _, cp, _, _, port_c, _ = models
    want = {torch_key(path)[0]: label for path, label in
            _flatten(jcn.trainable_labels(cp["params"], sd_locked=sd_locked))}
    got = trainable_labels(port_c, sd_locked=sd_locked)
    assert got == want
    assert {got[n] for n in got if n.startswith("up1.")} == {"freeze" if sd_locked else "train"}
    assert {got[n] for n in got if n.startswith("control.")} == {"train"}
    assert {got[n] for n in got if n.startswith("conv1.")} == {"freeze"}


def test_task_moe_checkpoint_is_task_independent(models, batch, hint):
    """One weight set serves every task; different experts give different
    outputs once the hint path is live."""
    _, _, cp, _, feat, _, _ = models
    model = from_flax(ControlledLegacyUNet(CH, **KW, device="cpu"),
                      _np(_live(cp["params"], ("hint.zeroconv0", "hint.zeroconv1", "zero0"))))
    h = torch.as_tensor(np.asarray(hint))
    outs = [_run(model, batch, hint=h, task_id=tid, task_feat=feat) for tid in (0, 1)]
    assert not np.allclose(outs[0], outs[1])
    assert model.control.hint.stem0_kernel.shape == (ALL_TASKS_NUM, 1, 3, 3, 3, 16)


def _adam_steps(model, batch, hint, feat, target, n, labels=None):
    """n Adam steps (lr 1e-2) on mean((y - target)^2), on the "train"
    parameters of `labels` (every parameter without); the losses."""
    params = (list(model.parameters()) if labels is None
              else trainable_parameters(model, labels))
    opt = torch.optim.Adam(params, lr=1e-2)
    h, tgt = torch.as_tensor(np.asarray(hint)), torch.as_tensor(np.asarray(target))
    losses = []
    for _ in range(n):
        opt.zero_grad()
        y = model(**_t(batch), hint=h, task_id=1, task_feat=feat)
        loss = torch.mean((y - tgt) ** 2)
        loss.backward()
        opt.step()
        losses.append(loss.item())
    return losses


def test_hint_path_bootstraps(models, batch, hint):
    """Four Adam steps on every parameter wake both chained hint zero convs
    (the torch-style trunk biases), and the hint then steers the output."""
    _, _, cp, _, feat, _, _ = models
    model = init_control_from_base(from_flax(ControlledLegacyUNet(CH, **KW, device="cpu"),
                                             _np(cp["params"])))
    target = jax.random.normal(jax.random.PRNGKey(5), (B, D, H, W))
    _adam_steps(model, batch, hint, feat, target, 4)
    assert float(model.control.hint.zeroconv1.weight.abs().max()) > 0.0
    assert float(model.control.hint.zeroconv0.weight.abs().max()) > 0.0
    h = torch.as_tensor(np.asarray(hint))
    assert np.abs(_run(model, batch, hint=h, task_id=1, task_feat=feat)
                  - _run(model, batch, hint=-h, task_id=1, task_feat=feat)).max() > 0.0


def test_composes_with_sampler(models, batch, hint):
    """The controlled model as ddim_sample's denoiser (3 steps): the sample's
    shape, finite values, and the hint steers it once the path is live."""
    _, _, cp, _, feat, _, _ = models
    model = from_flax(ControlledLegacyUNet(CH, **KW, device="cpu"),
                      _np(_live(cp["params"], ("hint.zeroconv0", "hint.zeroconv1", "zero4"))))
    ns = NoiseSchedule.create("cosine", 12)
    tb = _t(batch)

    def sample(h):
        def denoise(x, t, pan, ms):
            return model(x, t, pan, ms, tb["prompt_emb"], hint=h, task_id=1, task_feat=feat)
        with torch.no_grad():
            return gaussian.ddim_sample(denoise, ns, torch.Generator().manual_seed(0),
                                        tb["pan"], tb["ms"], (B, D, H, W), steps=3)

    h = torch.as_tensor(np.asarray(hint))
    y_pos, y_neg = sample(h), sample(-h)
    assert y_pos.shape == (B, D, H, W) and torch.isfinite(y_pos).all()
    assert not torch.allclose(y_pos, y_neg)


# -- fine-tuning against optax and data-parallel ------------------------------------


@pytest.fixture(scope="module")
def finetune(models, batch, hint):
    """The JAX sharded test's setting: the init recipe applied, batch 8 (the
    fixture's 2 rows tiled), sd_locked labels, two steps. Returns the
    port's start state, the inputs and JAX's losses."""
    controlled, _, cp, _, feat, _, _ = models
    params = jcn.init_control_from_base(cp["params"])
    tx = optax.multi_transform({"train": optax.adam(1e-2), "freeze": optax.set_to_zero()},
                               jcn.trainable_labels(params, sd_locked=True))
    target = jax.random.normal(jax.random.PRNGKey(5), (8, D, H, W))
    big = {k: jnp.concatenate([v] * 4) if v.ndim and v.shape[0] == B else v
           for k, v in batch.items()}
    big_hint = jnp.concatenate([hint] * 4)

    def loss(q):
        y = controlled.apply({"params": q}, **big, hint=big_hint, task_id=1, task_feat=feat)
        return jnp.mean((y - target) ** 2)

    @jax.jit
    def step(p, s):
        value, g = jax.value_and_grad(loss)(p)
        upd, s = tx.update(g, s, p)
        return optax.apply_updates(p, upd), s, value

    state, losses = tx.init(params), []
    for _ in range(2):
        params, state, value = step(params, state)
        losses.append(float(value))
    losses.append(float(jax.jit(loss)(params)))
    port = init_control_from_base(from_flax(ControlledLegacyUNet(CH, **KW, device="cpu"),
                                            _np(cp["params"])))
    return port, big, big_hint, np.asarray(target), feat, losses


def test_finetune_steps_match_optax(finetune):
    """Two Adam steps on the "train" parameters against optax.multi_transform
    (adam / set_to_zero): each step's loss and the loss after them at
    LOSS_RTOL; the frozen parameters unchanged bit for bit."""
    port, big, big_hint, target, feat, jax_losses = finetune
    model = ControlledLegacyUNet(CH, **KW, device="cpu")
    model.load_state_dict(port.state_dict())
    labels = trainable_labels(model, sd_locked=True)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    losses = _adam_steps(model, big, big_hint, feat, target, 2, labels)
    with torch.no_grad():
        y = model(**_t(big), hint=torch.as_tensor(np.asarray(big_hint)), task_id=1,
                  task_feat=feat)
        losses.append(float(torch.mean((y - torch.as_tensor(target)) ** 2)))
    np.testing.assert_allclose(losses, jax_losses, rtol=LOSS_RTOL)
    assert losses[2] < losses[0]
    for n, p in model.named_parameters():
        if labels[n] == "freeze":
            assert torch.equal(p, before[n]), n


def test_data_parallel_finetune_matches_one_process(finetune):
    """The same two steps on a gloo (2, 1) world, each rank a half of the
    batch and the gradients summed over the world: the losses against one
    process's at LOSS_RTOL, the trained parameters equal across the ranks."""
    port, big, big_hint, target, feat, _ = finetune
    state = {k: v.numpy() for k, v in port.state_dict().items()}
    args = (state, CH, {k: np.asarray(v) for k, v in big.items()}, np.asarray(big_hint),
            target, np.asarray(feat))
    ranks = run_world("torch_mesh_workers:controlnet_finetune", 2, ((2, 1), *args),
                      sys_path=[TESTS], threads=1, timeout=180)
    import torch_mesh_workers

    single = torch_mesh_workers.controlnet_finetune(None, *args)
    for r in ranks:
        np.testing.assert_allclose(r["losses"], single["losses"], rtol=LOSS_RTOL)
    for name, v in ranks[0]["params"].items():
        np.testing.assert_array_equal(v, ranks[1]["params"][name])
