"""The port's attention library (tmdiff_tpu_torch/ops/attention.py) and the
plain version of its flash-attention kernel (K4) on the CPU: against the JAX
package's Pallas kernel (interpret mode), every module against its JAX module
on the same numpy-made weights through `from_flax`, and the reference
goldens attention.npz / attnpp.npz at the JAX tests' tolerances."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tmdiff_tpu.ops import attention as jax_attention
from tmdiff_tpu.ops.pallas.flash_attention import attention_reference as jax_attention_reference
from tmdiff_tpu.ops.pallas.flash_attention import flash_attention as jax_flash_attention
from tmdiff_tpu_torch.ops import attention
from tmdiff_tpu_torch.ops.cuda import flash_attention as K4
from tmdiff_tpu_torch.utils.weights import from_flax

torch.set_num_threads(2)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")


def _t(a):
    return torch.as_tensor(np.asarray(a, np.float32))


def _lin(w):
    return np.transpose(w, (1, 0))


@pytest.mark.parametrize("q_shape,kv_len", [
    ((2, 4, 64, 32), 64), ((1, 2, 100, 40), 100), ((1, 1, 256, 64), 256),
    ((1, 2, 48, 32), 130),  # cross lengths: Sq 48, Skv 130
])
def test_reference_matches_pallas(rng, q_shape, kv_len):
    """attention_reference (and the wrapper on a CPU tensor) against the JAX
    Pallas kernel in interpret mode at tests/test_library_ops.py's cases;
    atol 2e-5, that test's bar."""
    b, h, sq, d = q_shape
    q = rng.standard_normal(q_shape).astype(np.float32)
    k, v = (rng.standard_normal((b, h, kv_len, d)).astype(np.float32) for _ in range(2))
    ref = np.asarray(jax_flash_attention(*(jnp.asarray(a) for a in (q, k, v)),
                                         block_q=64, block_k=64))
    np.testing.assert_allclose(K4.attention_reference(_t(q), _t(k), _t(v)).numpy(), ref, atol=2e-5)
    np.testing.assert_allclose(K4.flash_attention(_t(q), _t(k), _t(v)).numpy(), ref, atol=2e-5)
    ref_scaled = np.asarray(jax_attention_reference(*(jnp.asarray(a) for a in (q, k, v)), scale=0.3))
    np.testing.assert_allclose(K4.flash_attention(_t(q), _t(k), _t(v), scale=0.3).numpy(),
                               ref_scaled, atol=2e-5)


def test_wrapper_checks_and_no_fallback(rng):
    q = _t(rng.standard_normal((1, 2, 8, 16)))
    k = _t(rng.standard_normal((1, 2, 5, 16)))
    K4._check(q, k, k)
    with pytest.raises(ValueError, match="contiguous"):
        K4._check(q.transpose(2, 3), k, k)
    with pytest.raises(TypeError, match="float32"):
        K4._check(q, k.double(), k)
    with pytest.raises(ValueError, match="must be"):
        K4._check(q, k, k[:, :1].contiguous())
    with pytest.raises(ValueError, match="head dim"):
        K4._check(*(_t(np.zeros((1, 1, 4, 300))),) * 3)
    with pytest.raises(ValueError, match="unsupported"):
        K4._check(q, k[:, :, :0], k[:, :, :0])
    with pytest.raises(RuntimeError, match="no backward"):
        K4._check(q.clone().requires_grad_(), k, k)
    with pytest.raises(ValueError, match="no flash_attention kernel"):
        K4.flash_attention(q.to("meta"), k.to("meta"), k.to("meta"))
    before = K4.launches
    K4.flash_attention(q, k, k)
    assert K4.launches == before  # the CPU path launches nothing


def _random_params(module, *args):
    """The JAX module's param tree, filled with seeded numpy values: kernels
    scaled by fan-in, biases and norm offsets small, norm scales near 1."""
    tree = jax.eval_shape(module.init, jax.random.key(0), *args)["params"]
    rng = np.random.default_rng(len(jax.tree_util.tree_leaves(tree)))

    def fill(path, leaf):
        name = str(path[-1].key)
        if name == "kernel":
            fan_in = int(np.prod(leaf.shape[:-1]))
            return (rng.standard_normal(leaf.shape) / np.sqrt(fan_in)).astype(np.float32)
        base = 1.0 if name == "scale" else 0.0
        return (base + 0.1 * rng.standard_normal(leaf.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, tree)


def _check_module(jax_module, port_module, inputs, atol):
    params = _random_params(jax_module, *(jnp.asarray(a) for a in inputs))
    ref = jax_module.apply({"params": params}, *(jnp.asarray(a) for a in inputs))
    port = from_flax(port_module, {"params": params}).eval()
    with torch.no_grad():
        got = port(*(_t(a) for a in inputs))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=atol)


CTX = np.random.default_rng(0).standard_normal((2, 5, 40)).astype(np.float32)
TOKENS = np.random.default_rng(1).standard_normal((2, 37, 32)).astype(np.float32)
IMAGE = np.random.default_rng(2).standard_normal((2, 8, 6, 32)).astype(np.float32)


@pytest.mark.parametrize("use_flash", [True, False])
@pytest.mark.parametrize("cross", [True, False])
def test_cross_attention_matches_jax(use_flash, cross):
    """Self- and cross-attention, flash and plain routes; atol 2e-5 (the
    JAX attention tests' bar)."""
    inputs = (TOKENS, CTX) if cross else (TOKENS,)
    _check_module(jax_attention.CrossAttention(heads=4, dim_head=8, use_flash=use_flash),
                  attention.CrossAttention(32, 40 if cross else None, heads=4, dim_head=8,
                                           use_flash=use_flash),
                  inputs, atol=2e-5)


@pytest.mark.parametrize("glu", [True, False])
def test_feed_forward_matches_jax(glu):
    """FeedForward with the GEGLU (tanh gelu, jax.nn.gelu's default) or a
    plain gelu input layer; atol 2e-5."""
    _check_module(jax_attention.FeedForward(mult=2, glu=glu),
                  attention.FeedForward(32, mult=2, glu=glu), (TOKENS,), atol=2e-5)
    if glu:
        _check_module(jax_attention.GEGLU(24), attention.GEGLU(32, 24), (TOKENS,), atol=2e-5)


@pytest.mark.parametrize("disable_self_attn", [False, True])
def test_transformer_block_matches_jax(disable_self_attn):
    """Pre-LayerNorm self-attn, cross-attn and FF residuals; atol 3e-5
    (LayerNorm variance computed another way than flax's)."""
    _check_module(jax_attention.BasicTransformerBlock(4, 8, disable_self_attn=disable_self_attn),
                  attention.BasicTransformerBlock(32, 4, 8, context_dim=40,
                                                  disable_self_attn=disable_self_attn),
                  (TOKENS, CTX), atol=3e-5)


@pytest.mark.parametrize("use_checkpoint", [True, False])
def test_spatial_transformer_matches_jax(use_checkpoint):
    """GroupNorm, 1x1 projections and two blocks over 8x6 tokens with a
    5-token context; atol 3e-5. The port's use_checkpoint changes nothing
    without a gradient. The JAX module runs with use_checkpoint=False: its
    remat path does not trace (nn.remat makes `train` a tracer, which
    nn.Dropout's `deterministic=not train` cannot take)."""
    _check_module(jax_attention.SpatialTransformer(4, 16, depth=2, use_checkpoint=False),
                  attention.SpatialTransformer(32, 4, 16, depth=2, context_dim=40,
                                               use_checkpoint=use_checkpoint),
                  (IMAGE, CTX), atol=3e-5)


def test_spatial_transformer_checkpoint_gradient():
    """With a gradient, use_checkpoint recomputes the blocks and gives the
    same gradient as without it (CPU: the plain attention)."""
    grads = []
    for flag in (True, False):
        torch.manual_seed(0)
        m = attention.SpatialTransformer(32, 4, 8, depth=1, use_checkpoint=flag)
        torch.nn.init.normal_(m.proj_out.weight, std=0.1)
        x = _t(IMAGE).requires_grad_()
        m(x).square().sum().backward()
        grads.append(x.grad)
    torch.testing.assert_close(grads[0], grads[1])


@pytest.mark.parametrize("use_flash", [True, False])
def test_spatial_self_attention_matches_jax(use_flash):
    """Single head, head dim = C = 32, over 48 positions; atol 3e-5."""
    _check_module(jax_attention.SpatialSelfAttention(use_flash=use_flash),
                  attention.SpatialSelfAttention(32, use_flash=use_flash), (IMAGE,), atol=3e-5)


@pytest.mark.parametrize("skip_rescale", [True, False])
def test_channel_self_attention_matches_jax(skip_rescale):
    """The NCSN++ block (plain einsum softmax, as in JAX); atol 3e-5."""
    _check_module(jax_attention.ChannelSelfAttention(skip_rescale=skip_rescale),
                  attention.ChannelSelfAttention(32, skip_rescale=skip_rescale), (IMAGE,),
                  atol=3e-5)


def test_fresh_modules_start_near_identity():
    """The JAX package's inits that shape behaviour carry over: a
    SpatialTransformer's zero proj_out makes it the identity, and the
    ChannelSelfAttention's near-zero NIN_3 makes it x / sqrt(2)."""
    x = _t(IMAGE)
    with torch.no_grad():
        np.testing.assert_allclose(attention.SpatialTransformer(32, 4, 8)(x, _t(CTX[:, :, :32])).numpy(),
                                   IMAGE, atol=1e-6)
        np.testing.assert_allclose(attention.ChannelSelfAttention(32)(x).numpy(),
                                   IMAGE / 2 ** 0.5, atol=1e-4)


@pytest.fixture(scope="module")
def att():
    return np.load(os.path.join(GOLDEN, "attention.npz"))


def _cross_params(sd, prefix):
    return {"params": {
        "to_q": {"kernel": _lin(sd[f"{prefix}to_q.weight"])},
        "to_k": {"kernel": _lin(sd[f"{prefix}to_k.weight"])},
        "to_v": {"kernel": _lin(sd[f"{prefix}to_v.weight"])},
        "to_out": {"kernel": _lin(sd[f"{prefix}to_out.0.weight"]),
                   "bias": sd[f"{prefix}to_out.0.bias"]},
    }}


@pytest.mark.parametrize("use_flash", [True, False])
def test_cross_attention_golden(att, use_flash):
    """Reference weights reproduce `y_cross` and `y_self`; atol 2e-5, the
    bar of tests/test_attention_goldens.py."""
    x, ctx = _t(att["x"]), _t(att["ctx"])
    m = from_flax(attention.CrossAttention(x.shape[-1], ctx.shape[-1], heads=4, dim_head=8,
                                           use_flash=use_flash), _cross_params(att, "ca."))
    m_self = from_flax(attention.CrossAttention(x.shape[-1], heads=4, dim_head=8,
                                                use_flash=use_flash), _cross_params(att, "sa."))
    with torch.no_grad():
        np.testing.assert_allclose(m(x, ctx).numpy(), att["y_cross"], atol=2e-5)
        np.testing.assert_allclose(m_self(x).numpy(), att["y_self"], atol=2e-5)


def test_spatial_self_attention_golden(att):
    """`y_ssa` from the reference weights (1x1 conv kernels); atol 3e-5."""
    img = _t(np.moveaxis(att["img"], 1, -1))
    conv = lambda w: np.transpose(w, (2, 3, 1, 0))  # torch (O, I, 1, 1) -> (1, 1, I, O)
    params = {"params": {
        "norm": {"scale": att["ssa.norm.weight"], "bias": att["ssa.norm.bias"]},
        **{name: {"kernel": conv(att[f"ssa.{name}.weight"]), "bias": att[f"ssa.{name}.bias"]}
           for name in ("q", "k", "v", "proj_out")},
    }}
    m = from_flax(attention.SpatialSelfAttention(img.shape[-1]), params)
    with torch.no_grad():
        y = m(img)
    np.testing.assert_allclose(y.numpy(), np.moveaxis(att["y_ssa"], 1, -1), atol=3e-5)


def test_channel_attention_golden():
    """attnpp.npz: the reference folds (C, N) bands into channels; atol 3e-5."""
    g = np.load(os.path.join(GOLDEN, "attnpp.npz"))
    sd = {k[3:]: g[k] for k in g.files if k.startswith("sd.")}
    b, c_, n, h, w = g["x"].shape
    x = _t(np.moveaxis(g["x"].reshape(b, c_ * n, h, w), 1, -1))
    params = {"params": {
        "GroupNorm_0": {"scale": sd["GroupNorm_0.weight"], "bias": sd["GroupNorm_0.bias"]},
        # NIN.W is (in, units), the flax Dense kernel layout
        **{f"NIN_{i}": {"kernel": sd[f"NIN_{i}.W"], "bias": sd[f"NIN_{i}.b"]} for i in range(4)},
    }}
    m = from_flax(attention.ChannelSelfAttention(c_ * n, skip_rescale=True), params)
    with torch.no_grad():
        y = m(x)
    np.testing.assert_allclose(y.numpy(), np.moveaxis(g["y"].reshape(b, c_ * n, h, w), 1, -1),
                               atol=3e-5)


# --- bf16: K4's plain version and the library in bf16 ------------------------

BF16_SCALE_RTOL = 1e-4  # fp32 sums taken in another order
MODEL_CAP = 2e-2  # tests/test_torch_bf16.py's model bar


def _half_step(a):
    """Half the spacing of bf16 values at |a|: one rounding's largest error."""
    a = np.abs(np.asarray(a, np.float64))
    e = np.floor(np.log2(np.where(a > 0, a, 1.0)))
    return np.where(a > 0, 2.0 ** (e - 8), 0.0)


def _bf16_values(rng, shape):
    """Unit-normal values rounded to bf16, as float32 numpy (exact in both
    packages' bf16)."""
    x = rng.standard_normal(shape).astype(np.float32)
    return np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))


@pytest.mark.parametrize("q_shape,kv_len", [
    ((2, 4, 64, 32), 64), ((1, 2, 100, 40), 100), ((1, 2, 48, 32), 130), ((1, 1, 70, 42), 33),
])
def test_bf16_plain_matches_pallas(rng, q_shape, kv_len):
    """flash_attention_plain in bf16 (what the wrapper computes on a CPU
    tensor) against the JAX Pallas kernel on bf16 inputs in interpret mode:
    within one bf16 step, each element within half a step of each side's
    value plus 1e-4 of the output's scale. Both cast the tiles to fp32 and
    round the output once."""
    b, h, sq, d = q_shape
    q = _bf16_values(rng, q_shape)
    k, v = (_bf16_values(rng, (b, h, kv_len, d)) for _ in range(2))
    ref = np.asarray(jax_flash_attention(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)),
                                         block_q=64, block_k=64).astype(jnp.float32))
    got = K4.flash_attention(*(_t(a).bfloat16() for a in (q, k, v)))
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    bar = _half_step(got) + _half_step(ref) + BF16_SCALE_RTOL * np.abs(ref).max()
    assert np.all(np.abs(got - ref) <= bar), np.abs(got - ref).max()
    # in float32 the plain version is the reference's function
    f32 = K4.flash_attention_plain(*(_t(a) for a in (q, k, v)))
    assert torch.equal(f32, K4.attention_reference(*(_t(a) for a in (q, k, v))))


def test_bf16_wrapper_checks(rng):
    q = _t(rng.standard_normal((1, 2, 8, 16))).bfloat16()
    k = _t(rng.standard_normal((1, 2, 5, 16))).bfloat16()
    K4._check(q, k, k)
    with pytest.raises(TypeError, match="one launch takes one dtype"):
        K4._check(q, k.float(), k)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        K4._check(q.half(), k.half(), k.half())


BF16_MODULES = {
    "cross_attention_flash": (
        lambda dt: jax_attention.CrossAttention(heads=4, dim_head=8, dtype=dt),
        lambda dt: attention.CrossAttention(32, 40, heads=4, dim_head=8, dtype=dt), (TOKENS, CTX)),
    "self_attention_plain": (
        lambda dt: jax_attention.CrossAttention(heads=4, dim_head=8, use_flash=False, dtype=dt),
        lambda dt: attention.CrossAttention(32, heads=4, dim_head=8, use_flash=False, dtype=dt),
        (TOKENS,)),
    "geglu": (lambda dt: jax_attention.GEGLU(24, dtype=dt),
              lambda dt: attention.GEGLU(32, 24, dtype=dt), (TOKENS,)),
    "feed_forward_gelu": (lambda dt: jax_attention.FeedForward(mult=2, glu=False, dtype=dt),
                          lambda dt: attention.FeedForward(32, mult=2, glu=False, dtype=dt),
                          (TOKENS,)),
    "transformer_block": (
        lambda dt: jax_attention.BasicTransformerBlock(4, 8, dtype=dt),
        lambda dt: attention.BasicTransformerBlock(32, 4, 8, context_dim=40, dtype=dt),
        (TOKENS, CTX)),
    "spatial_transformer": (
        lambda dt: jax_attention.SpatialTransformer(4, 16, depth=2, use_checkpoint=False, dtype=dt),
        lambda dt: attention.SpatialTransformer(32, 4, 16, depth=2, context_dim=40, dtype=dt),
        (IMAGE, CTX)),
    "spatial_self_attention": (
        lambda dt: jax_attention.SpatialSelfAttention(dtype=dt),
        lambda dt: attention.SpatialSelfAttention(32, dtype=dt), (IMAGE,)),
    "channel_self_attention": (
        lambda dt: jax_attention.ChannelSelfAttention(dtype=dt),
        lambda dt: attention.ChannelSelfAttention(32, dtype=dt), (IMAGE,)),
}


@pytest.mark.parametrize("name", sorted(BF16_MODULES))
def test_bf16_module_matches_jax(name):
    """Each module with dtype=bfloat16 against the JAX module of
    dtype=jnp.bfloat16 on the same float32 weights and inputs: the port's
    output within twice JAX-bf16's own gap to JAX-fp32 of JAX-bf16 and
    under 2e-2 of the output's scale (tests/test_torch_bf16.py's model bar),
    in the output dtype flax gives (bf16, or float32 past a float32
    residual)."""
    jax_of, port_of, inputs = BF16_MODULES[name]
    args = [jnp.asarray(a) for a in inputs]
    params = _random_params(jax_of(jnp.float32), *args)
    ref32 = np.asarray(jax_of(jnp.float32).apply({"params": params}, *args), np.float32)
    ref16 = jax_of(jnp.bfloat16).apply({"params": params}, *args)
    port = from_flax(port_of(torch.bfloat16), {"params": params}).eval()
    with torch.no_grad():
        got = port(*(_t(a) for a in inputs))
    assert str(got.dtype).split(".")[-1] == str(ref16.dtype)
    got, ref16 = got.float().numpy(), np.asarray(ref16, np.float32)
    scale = np.abs(ref32).max()
    own = np.abs(ref16 - ref32).max() / scale
    gap = np.abs(got - ref16).max() / scale
    assert gap <= 2 * own and gap < MODEL_CAP, (gap, own)
