"""The legacy UNet and the ControlNet adapter in bf16 on the CPU against the
JAX package's bf16 models: `LegacyUNet`, a live `ControlledLegacyUNet` and
its `only_mid_control` variant with `dtype=torch.bfloat16` on `from_flax`
weights against the JAX models with `dtype=jnp.bfloat16` (MODEL BAR of
tests/test_torch_bf16.py), the three library convs in bf16 against XLA's
bf16 conv (ROUNDING BAR), one sd_locked fine-tune step's gradients against
jax.grad of the JAX bf16 model (the MODEL BAR of tests/
test_torch_bf16_train.py), and the refusal of float16. The JAX side takes
its banded lowering (Pallas K1 in interpret mode where eligible: the 32x32
level's convs at Cout 32 over 8 bands). Inputs and weights are made with
numpy from a seed: kernels lecun-scaled, every zero conv drawn off zero (a
trained adapter's state).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from test_torch_bf16 import assert_model_bar, assert_within_roundings
from test_torch_bf16_train import assert_gradients_model_bar
from tmdiff_tpu.models import controlnet as jcn
from tmdiff_tpu.models.legacy_unet import LegacyUNet as JaxLegacyUNet
from tmdiff_tpu.ops import modconv as jax_modconv
from tmdiff_tpu.ops.modconv import DIMENSION_NUMBERS_3D
from tmdiff_tpu.ops.pallas import banded_conv3d as pallas_conv
from tmdiff_tpu_torch.models.controlnet import (TASKS_TO_ID, ControlledLegacyUNet,
                                                trainable_labels)
from tmdiff_tpu_torch.models.legacy_unet import LegacyUNet
from tmdiff_tpu_torch.ops import library_conv
from tmdiff_tpu_torch.utils.weights import from_flax

torch.set_num_threads(2)

CH = (32, 32, 64, 64)
B, D, SIZE = 2, 8, 32
KW = dict(embed_dim=16, inter_dim=8)
TASK = "control_canny"


def _fill(tree, seed):
    """Seeded numpy values for a flax tree: lecun-scaled kernels (the task
    stems' fan-in per expert), small random biases, style projections near
    1."""
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        names = [str(p.key) for p in path]
        if names[-1].endswith("kernel"):
            shape = leaf.shape[1:] if names[-1].startswith("stem") else leaf.shape
            fan_in = int(np.prod(shape[:-1]))
            return (rng.standard_normal(leaf.shape) / np.sqrt(fan_in)).astype(np.float32)
        base = 1.0 if "style" in names else 0.0
        return (base + 0.1 * rng.standard_normal(leaf.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, tree)


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(0)
    ms = rng.uniform(size=(B, D, SIZE, SIZE)).astype(np.float32)
    batch = dict(x_t=rng.standard_normal((B, D, SIZE, SIZE)).astype(np.float32),
                 t=np.array([3.0, 700.0], np.float32),
                 pan=(ms.mean(1, keepdims=True)
                      + 0.05 * rng.standard_normal((B, 1, SIZE, SIZE))).astype(np.float32),
                 ms=ms, prompt_emb=rng.standard_normal(768).astype(np.float32))
    hint = rng.uniform(size=(B, SIZE, SIZE, 3)).astype(np.float32)
    return batch, hint, np.asarray(jcn.task_feature(TASK))


@pytest.fixture(scope="module")
def params(inputs):
    """A live controlled tree (every leaf seeded) and the base tree within
    it."""
    batch, hint, feat = inputs
    model = jcn.ControlledLegacyUNet(channels=CH, **KW)
    tree = jax.eval_shape(lambda: model.init(jax.random.key(0), **batch, hint=hint,
                                             task_id=TASKS_TO_ID[TASK], task_feat=feat))
    controlled = _fill(tree["params"], 3)
    base = {k: v for k, v in controlled.items() if k not in ("control", "task_hypernet")}
    return controlled, base


@pytest.fixture
def jax_banded(monkeypatch):
    """The JAX package's banded lowering, its Pallas K1 calls counted by
    dtype."""
    monkeypatch.setattr(jax_modconv, "CONV3D_IMPL", "banded")
    calls = []
    original = pallas_conv.banded_conv3d
    monkeypatch.setattr(pallas_conv, "banded_conv3d",
                        lambda x, kernel, *a: calls.append(x.dtype) or original(x, kernel, *a))
    return calls


VARIANTS = {"LegacyUNet": None, "controlled": False, "only_mid_control": True}


def _models(variant, dtype, jdtype):
    """(JAX model, port model class kwargs) of a variant in one dtype."""
    if VARIANTS[variant] is None:
        return (JaxLegacyUNet(channels=CH, **KW, dtype=jdtype),
                LegacyUNet(CH, **KW, device="cpu", dtype=dtype))
    mid = VARIANTS[variant]
    return (jcn.ControlledLegacyUNet(channels=CH, **KW, only_mid_control=mid, dtype=jdtype),
            ControlledLegacyUNet(CH, **KW, only_mid_control=mid, device="cpu", dtype=dtype))


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_bf16_legacy_models_match_jax(inputs, params, jax_banded, variant):
    """Each variant in bf16 (8 bands, batch 2, 32x32, channels 32-64) on
    from_flax weights against the JAX model in bf16 and in fp32 on the same
    tree: MODEL BAR. The port's output is float32 and its parameters stay
    float32; JAX's Pallas K1 ran in bf16."""
    batch, hint, feat = inputs
    controlled, base = params
    tree = base if VARIANTS[variant] is None else controlled
    control = {} if VARIANTS[variant] is None else dict(task_id=TASKS_TO_ID[TASK],
                                                        task_feat=feat)
    outs = {}
    for jdtype in (jnp.float32, jnp.bfloat16):
        jax_banded.clear()
        jmodel, _ = _models(variant, torch.float32, jdtype)
        jhint = {} if not control else {"hint": hint}
        outs[jdtype] = np.asarray(jax.jit(lambda p: jmodel.apply(
            {"params": p}, **batch, **jhint, **control))(tree))
        assert outs[jdtype].dtype == np.float32
        assert jax_banded and set(jax_banded) == {jnp.dtype(jdtype)}
    _, port = _models(variant, torch.bfloat16, None)
    port = from_flax(port, jax.tree.map(np.asarray, tree))
    assert all(p.dtype == torch.float32 for p in port.parameters())
    with torch.no_grad():
        y = port(**{k: torch.as_tensor(v) for k, v in batch.items()},
                 **({} if not control else {"hint": torch.as_tensor(hint)}), **control)
    assert y.dtype == torch.float32 and y.shape == (B, D, SIZE, SIZE)
    assert_model_bar(y.numpy(), outs[jnp.bfloat16], outs[jnp.float32])


def _xla(kind, x, k, b):
    """The JAX package's conv of each kind in x's dtype, its bias added
    after the conv in that dtype (legacy_blocks.py, flax's Conv)."""
    k = k.astype(x.dtype)
    if kind == "strided":
        y = lax.conv_general_dilated(x, k, (1, 2, 2), ((1, 1), (0, 0), (0, 0)),
                                     dimension_numbers=DIMENSION_NUMBERS_3D)
    elif kind == "transposed":
        y = lax.conv_transpose(x, k.swapaxes(-1, -2), (1, 2, 2), ((1, 1), (2, 3), (2, 3)),
                               dimension_numbers=DIMENSION_NUMBERS_3D, transpose_kernel=True)
    else:
        y = lax.conv_general_dilated(x, k, (1, 1, 1), ((0, 0), (1, 1), (1, 1)),
                                     dimension_numbers=DIMENSION_NUMBERS_3D)
    return y, y + b.astype(y.dtype)


@pytest.mark.parametrize("kind,x_shape,k_shape", [
    ("strided", (2, 8, 31, 33, 32), (3, 3, 3, 32, 32)),
    ("transposed", (2, 8, 15, 7, 64), (3, 3, 3, 64, 32)),
    ("hint", (2, 1, 16, 12, 3), (1, 3, 3, 3, 16)),
])
def test_bf16_library_convs_match_xla(kind, x_shape, k_shape):
    """Each library conv in bf16 (bf16 operands, fp32 sums, the bias added
    after the conv in bf16) against XLA's bf16 conv with JAX's bias add, and
    its x and weight gradients against jax.vjp in bf16: ROUNDING BAR (the
    forward rounds twice a side, the conv and the bias add). The bias
    gradient is an fp32 sum of the bf16 output gradient, rounded once,
    against the fp32 sum (XLA:CPU accumulates JAX's in bf16)."""
    rng = np.random.default_rng(1)
    bf = lambda a: jnp.asarray(a, jnp.float32).astype(jnp.bfloat16)
    f64 = lambda a: np.asarray(jnp.asarray(a).astype(jnp.float32), np.float64)
    x = bf(rng.standard_normal(x_shape))
    k = jnp.asarray(rng.standard_normal(k_shape) / np.sqrt(np.prod(k_shape[:-1])), jnp.float32)
    b = bf(rng.standard_normal(k_shape[-1]))
    conv, ref = _xla(kind, x, k, b)
    g = bf(rng.standard_normal(ref.shape))
    xt = torch.tensor(np.asarray(x.astype(jnp.float32))).bfloat16().requires_grad_()
    kt = torch.tensor(np.asarray(k)).requires_grad_()
    bt = torch.tensor(np.asarray(b.astype(jnp.float32))).bfloat16().requires_grad_()
    y = library_conv.library_conv3d(xt, kt, bt, kind=kind)
    assert y.dtype == torch.bfloat16 and y.shape == ref.shape and y.is_contiguous()
    got = y.detach().float().numpy()
    assert_within_roundings(got, f64(ref), [f64(conv), f64(ref), got, got])
    y.backward(torch.tensor(np.asarray(g.astype(jnp.float32))).bfloat16())
    _, vjp = jax.vjp(lambda x, k: _xla(kind, x, k, b)[0], x, k)
    dx, dk = (f64(a) for a in vjp(g))
    assert xt.grad.dtype == torch.bfloat16 and kt.grad.dtype == torch.float32
    for got, want in ((xt.grad.float().numpy(), dx), (kt.grad.numpy(), dk)):
        assert_within_roundings(got, want, [got, want])
    db = f64(bf(f64(g).sum((0, 1, 2, 3))))
    gb = bt.grad.float().numpy()
    assert_within_roundings(gb, db, [gb, db])


def test_bf16_finetune_gradients_match_jax(inputs, params, jax_banded):
    """One sd_locked fine-tune step's gradients: the live bf16
    ControlledLegacyUNet's L2 loss to a seeded target against jax.grad of
    the JAX bf16 model's (and the fp32 model's, for JAX's own gap) on the
    same tree: MODEL BAR on every gradient that JAX's fp32 model gives; the
    base encoder, middle and task hypernetwork take none (JAX's zeros). The
    parameters and gradients are float32."""
    batch, hint, feat = inputs
    controlled, _ = params
    control = dict(task_id=TASKS_TO_ID[TASK], task_feat=feat)
    target = np.random.default_rng(2).standard_normal((B, D, SIZE, SIZE)).astype(np.float32)
    grads = {}
    for jdtype in (jnp.float32, jnp.bfloat16):
        jmodel = jcn.ControlledLegacyUNet(channels=CH, **KW, dtype=jdtype)
        loss = lambda p: jnp.mean((jmodel.apply({"params": p}, **batch, hint=hint, **control)
                                   - target) ** 2)
        grads[jdtype] = from_flax(ControlledLegacyUNet(CH, **KW, device="cpu"), jax.tree.map(
            np.asarray, jax.jit(jax.grad(loss))(controlled))).state_dict()
    port = from_flax(ControlledLegacyUNet(CH, **KW, device="cpu", dtype=torch.bfloat16),
                     jax.tree.map(np.asarray, controlled))
    names, ps = zip(*port.named_parameters())
    y = port(**{k: torch.as_tensor(v) for k, v in batch.items()}, hint=torch.as_tensor(hint),
             **control)
    got = dict(zip(names, torch.autograd.grad(torch.mean((y - torch.as_tensor(target)) ** 2),
                                              ps, allow_unused=True)))
    live = {n for n in names if np.abs(grads[jnp.float32][n].numpy()).max() > 0}
    for n in names:
        if n not in live:
            assert got[n] is None or not got[n].any(), n
    labels = trainable_labels(port, sd_locked=True)
    assert {n for n in live if labels[n] == "train"} and all(
        n.split(".")[0] not in ("conv1", "conv2", "down1", "middle1", "task_hypernet")
        for n in live)
    assert_gradients_model_bar({n: got[n] for n in live}, grads[jnp.float32],
                               grads[jnp.bfloat16])


def test_legacy_models_refuse_float16():
    for cls in (LegacyUNet, ControlledLegacyUNet):
        with pytest.raises(ValueError, match="float32 or bfloat16"):
            cls((8, 8, 8, 8), device="cpu", dtype=torch.float16)
