"""The port's library ops and orphan blocks on the CPU
(tmdiff_tpu_torch/ops/dynamic_conv.py, kernel_adaption.py, pgcu.py,
models/blocks.py::ChannelWiseAttention / AdaptiveGroupNorm): each against
its JAX module on the same numpy-made weights (carried over by
utils/weights.py::from_flax) and inputs, and against the reference goldens
dynamic_conv.npz, kernel_adaption.npz, pgcu.npz and orphan_blocks.npz at the
JAX tests' tolerances.

Bars against JAX: 1e-5 absolute for an op (a conv, a degradation, a block),
5e-4 for the PGCU forward (the repository's forward bar: two conv towers,
an attention and five convs). bf16 orphan blocks: within twice JAX-bf16's
own gap to JAX-fp32 and under 2e-2 of the output's scale
(tests/test_torch_bf16.py's model bar).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tmdiff_tpu.models import blocks as jax_blocks
from tmdiff_tpu.ops import dynamic_conv as jax_dynamic_conv
from tmdiff_tpu.ops import kernel_adaption as jax_kernel_adaption
from tmdiff_tpu.ops import pgcu as jax_pgcu
from tmdiff_tpu_torch.models import blocks
from tmdiff_tpu_torch.ops import dynamic_conv, kernel_adaption, library_conv, pgcu
from tmdiff_tpu_torch.utils.weights import from_flax

torch.set_num_threads(2)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
OP_ATOL = 1e-5
FORWARD_ATOL = 5e-4


def _t(a):
    return torch.as_tensor(np.array(a, np.float32))


def _randn(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _random_params(module, *args, **kw):
    """The JAX module's param tree filled with seeded numpy values: kernels
    scaled by fan-in, other parameters near their init (scales near 1)."""
    tree = jax.eval_shape(module.init, jax.random.key(0), *args, **kw)["params"]
    rng = np.random.default_rng(len(jax.tree_util.tree_leaves(tree)))

    def fill(path, leaf):
        name = str(path[-1].key)
        if name in ("kernel", "kernels"):
            fan_in = int(np.prod(leaf.shape[-4:-1] if name == "kernels" else leaf.shape[:-1]))
            return (rng.standard_normal(leaf.shape) / np.sqrt(fan_in)).astype(np.float32)
        base = 1.0 if "scale" in name else 0.0
        return (base + 0.1 * rng.standard_normal(leaf.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, tree)


def _check(jax_module, port_module, inputs, atol, **kw):
    """JAX module and port module on the same params and inputs; returns
    the port's output."""
    args = [jnp.asarray(a) for a in inputs]
    params = _random_params(jax_module, *args, **kw)
    ref = np.asarray(jax_module.apply({"params": params}, *args, **kw))
    port = from_flax(port_module, {"params": params}).eval()
    with torch.no_grad():
        got = port(*(_t(a) for a in inputs), **kw).numpy()
    np.testing.assert_allclose(got, ref, atol=atol)
    return got


# --- ops/dynamic_conv.py -----------------------------------------------------

DYNAMIC = {
    "1d": (dict(kernel_size=(3,)), (2, 12, 6)),
    "2d": (dict(kernel_size=(3, 3)), (3, 10, 10, 6)),
    "2d_stride2_groups2": (dict(kernel_size=(3, 3), stride=2, feature_group_count=2), (2, 9, 10, 6)),
    "2d_valid_no_bias": (dict(kernel_size=(2, 4), padding="VALID", use_bias=False), (2, 9, 10, 6)),
    "2d_rgb_gate": (dict(kernel_size=(3, 3)), (2, 8, 8, 3)),
    "3d": (dict(kernel_size=(3, 3, 3)), (2, 4, 8, 8, 6)),
    "3d_even_kernel_stride2": (dict(kernel_size=(2, 2, 2), stride=2), (1, 5, 7, 6, 4)),
}


@pytest.mark.parametrize("name", sorted(DYNAMIC))
def test_dynamic_conv_matches_jax(name):
    """1-D/2-D/3-D, XLA's SAME at stride 1 and 2 (odd pixel after), VALID,
    groups, no bias, the 3-channel gate width; temperature 2."""
    kw, shape = DYNAMIC[name]
    x = _randn(1, shape)
    _check(jax_dynamic_conv.DynamicConv(features=4, **kw),
           dynamic_conv.DynamicConv(shape[-1], 4, **kw), (x,), OP_ATOL, temperature=2.0)


def test_dynamic_conv3d_golden():
    """dynamic_conv.npz: the reference's attention 1x1x1 convs as the gate's
    Dense layers, its (K, out, in, kd, kh, kw) kernels; atol 2e-4 (the JAX
    golden test's)."""
    g = np.load(os.path.join(GOLDEN, "dynamic_conv.npz"))
    sd = {k[3:]: g[k] for k in g.files if k.startswith("sd.")}
    params = {"attention": {"fc1": {"kernel": sd["attention.fc1.weight"][:, :, 0, 0, 0].T},
                            "fc2": {"kernel": sd["attention.fc2.weight"][:, :, 0, 0, 0].T}},
              "kernels": np.transpose(sd["weight"], (0, 3, 4, 5, 2, 1)), "bias": sd["bias"]}
    m = from_flax(dynamic_conv.DynamicConv3d(6, 5, (3, 3, 3), num_kernels=4), {"params": params})
    with torch.no_grad():
        y = m(_t(np.moveaxis(g["x"], 1, -1)), temperature=float(g["temperature"]))
    np.testing.assert_allclose(y.numpy(), np.moveaxis(g["y"], 1, -1), atol=2e-4)


def test_dynamic_conv_mixing_identity():
    """sum_k a_k conv(x, W_k) equals one conv per sample with its mixed
    kernel and bias (tests/test_library_ops.py's identity)."""
    x = _t(_randn(2, (3, 10, 10, 6)))
    torch.manual_seed(0)
    m = dynamic_conv.DynamicConv(6, 5, (3, 3), num_kernels=4)
    torch.nn.init.normal_(m.bias)
    with torch.no_grad():
        out = m(x, temperature=2.0)
        gate = m.attention(x, 2.0)
        for b in range(3):
            w = torch.einsum("k,khwio->hwio", gate[b], m.kernels)
            ref = library_conv.conv_nd(x[b:b + 1], w) + gate[b] @ m.bias
            np.testing.assert_allclose(out[b:b + 1].numpy(), ref.numpy(), atol=1e-4)


def test_anneal_temperature():
    t = 34.0
    for _ in range(20):
        t = dynamic_conv.anneal_temperature(t)
    assert t == 1.0 == jax_dynamic_conv.anneal_temperature(2.0)


# --- ops/kernel_adaption.py --------------------------------------------------


@pytest.fixture(scope="module")
def ka():
    return np.load(os.path.join(GOLDEN, "kernel_adaption.npz"))


@pytest.mark.parametrize("shift", ["center", "left", "right"])
def test_gaussian_psf_matches_jax_and_golden(ka, shift):
    psf = kernel_adaption.gaussian_kernel_from_q(_t(ka["q"]), 5, 4, shift)
    ref = jax_kernel_adaption.gaussian_kernel_from_q(jnp.asarray(ka["q"]), 5, 4, shift)
    np.testing.assert_allclose(psf.numpy(), np.asarray(ref), atol=OP_ATOL)
    if shift == "center":
        np.testing.assert_allclose(psf.numpy(), ka["psf"], atol=1e-6)
        np.testing.assert_allclose(float(psf.sum()), 1.0, rtol=1e-6)


def test_degradations_golden(ka):
    """gk_out and ek_out from the reference parameters; atol 1e-4."""
    z = _t(np.moveaxis(ka["z"], 1, -1))
    g = from_flax(kernel_adaption.GaussianDegradation(5, 4), {"params": {"KernelParam": ka["gk_param"]}})
    f = from_flax(kernel_adaption.FreePSFDegradation(4), {"params": {"KernelAdaption": ka["ek_param"]}})
    with torch.no_grad():
        np.testing.assert_allclose(g(z).numpy(), np.moveaxis(ka["gk_out"], 1, -1), atol=1e-4)
        np.testing.assert_allclose(f(z).numpy(), np.moveaxis(ka["ek_out"], 1, -1), atol=1e-4)


@pytest.mark.parametrize("which", ["gaussian", "free"])
def test_degradations_match_jax(which):
    x = _randn(3, (2, 32, 32, 4))
    if which == "gaussian":
        out = _check(jax_kernel_adaption.GaussianDegradation(kernel_size=5, scale_factor=4),
                     kernel_adaption.GaussianDegradation(5, 4), (x,), OP_ATOL)
        assert out.shape == (2, 7, 7, 4)
    else:
        out = _check(jax_kernel_adaption.FreePSFDegradation(scale_factor=4),
                     kernel_adaption.FreePSFDegradation(4), (x,), OP_ATOL)
        assert out.shape == (2, 8, 8, 4)


def test_free_psf_averages():
    """A softmax PSF sums to one: a constant image stays constant."""
    with torch.no_grad():
        y = kernel_adaption.FreePSFDegradation(4)(torch.ones(1, 16, 16, 2))
    np.testing.assert_allclose(y.numpy(), 1.0, rtol=1e-5)


# --- ops/pgcu.py -------------------------------------------------------------


@pytest.mark.parametrize("size,out", [((4, 4), (16, 16)), ((5, 3), (12, 7)), ((8, 8), (8, 8))])
def test_resize_nearest_matches_jax(size, out):
    x = _randn(4, (2, *size, 3))
    ref = jax.image.resize(jnp.asarray(x), (2, *out, 3), "nearest")
    assert torch.equal(pgcu.resize_nearest(_t(x), *out), _t(ref))


def test_down_sampling_block_matches_jax():
    """The stride-2 conv's symmetric (1, 1) padding, then the max pool."""
    _check(jax_pgcu.DownSamplingBlock(4), pgcu.DownSamplingBlock(3, 4), (_randn(5, (2, 16, 12, 3)),),
           OP_ATOL)


def test_band_projection_matches_jax():
    _check(jax_pgcu._BandProjection(4, 8), pgcu._BandProjection(32, 4, 8),
           (_randn(6, (2, 5, 5, 32)),), OP_ATOL)


def test_pgcu_matches_jax():
    """pan 128x128, ms 32x32, 4 bands: a 2x2 coarse grid; batch 2."""
    pan, ms = _randn(7, (2, 128, 128, 1)), _randn(8, (2, 32, 32, 4))
    out = _check(jax_pgcu.PGCU(channels=4, vec_len=64), pgcu.PGCU(4, 64), (pan, ms), FORWARD_ATOL)
    assert out.shape == (2, 128, 128, 4)


def test_pgcu_golden():
    """pgcu.npz: the reference's per-band Linear + LayerNorm stacked into
    the band projections; atol 5e-4 (the JAX golden test's)."""
    g = np.load(os.path.join(GOLDEN, "pgcu.npz"))
    sd = {k[3:]: g[k] for k in g.files if k.startswith("sd.")}

    def conv(prefix):  # torch (O, I, kh, kw) -> flax (kh, kw, I, O)
        return {"kernel": np.transpose(sd[f"{prefix}.weight"], (2, 3, 1, 0)),
                "bias": sd[f"{prefix}.bias"]}

    params = {name: conv(name) for name in ("FPConv", "FMConv", "FConv", "GConv", "VConv",
                                            "FineAdjust")}
    for tower, tname, n in (("GPConv", "GP", 3), ("GMConv", "GM", 2), ("VPConv", "VP", 3),
                            ("VMConv", "VM", 2)):
        for i in range(n):
            params[f"{tname}DSBlock{i}"] = {"Conv": conv(f"{tower}.DSBlock{i}.Conv")}
    for proj in ("FLinear", "GLinear"):
        params[proj] = {
            "kernel": np.stack([sd[f"{proj}.{c}.0.weight"].T for c in range(4)]),
            "bias": np.stack([sd[f"{proj}.{c}.0.bias"] for c in range(4)]),
            "norm_scale": np.stack([sd[f"{proj}.{c}.1.weight"] for c in range(4)]),
            "norm_bias": np.stack([sd[f"{proj}.{c}.1.bias"] for c in range(4)])}
    m = from_flax(pgcu.PGCU(4, 128, 3), {"params": params})
    with torch.no_grad():
        y = m(_t(np.moveaxis(g["pan"], 1, -1)), _t(np.moveaxis(g["ms"], 1, -1)))
    np.testing.assert_allclose(y.numpy(), np.moveaxis(g["y"], 1, -1), atol=5e-4)


# --- models/blocks.py: the orphan blocks -------------------------------------


@pytest.fixture(scope="module")
def ob():
    return np.load(os.path.join(GOLDEN, "orphan_blocks.npz"))


def _cl(x):  # torch (B, C, D, H, W) -> (B, D, H, W, C)
    return np.transpose(x, (0, 2, 3, 4, 1))


def test_orphan_blocks_golden(ob):
    """orphan_blocks.npz at the JAX tests' tolerances (1e-5, 2e-5)."""
    x, style = _t(_cl(ob["x"])), _t(ob["style"])
    cwa = from_flax(blocks.ChannelWiseAttention(32, 16), {"params": {
        "fc1": {"kernel": ob["cwa.fc1.weight"].T, "bias": ob["cwa.fc1.bias"]},
        "fc2": {"kernel": ob["cwa.fc2.weight"].T, "bias": ob["cwa.fc2.bias"]}}})
    agn = from_flax(blocks.AdaptiveGroupNorm(32, 24, 4), {"params": {
        "style": {"kernel": ob["agn.style.weight"].T, "bias": ob["agn.style.bias"]}}})
    with torch.no_grad():
        np.testing.assert_allclose(cwa(x).numpy(), _cl(ob["y_cwa"]), atol=1e-5)
        np.testing.assert_allclose(agn(x, style).numpy(), _cl(ob["y_agn"]), atol=2e-5)


def _orphan(name, dtype):
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    if name == "channel_wise_attention":
        return (jax_blocks.ChannelWiseAttention(reduction_ratio=8, dtype=jdt),
                blocks.ChannelWiseAttention(32, 8, dtype=dtype), (_randn(9, (2, 4, 8, 8, 32)),))
    return (jax_blocks.AdaptiveGroupNorm(num_groups=4, dtype=jdt),
            blocks.AdaptiveGroupNorm(32, 24, 4, dtype=dtype),
            (_randn(9, (2, 4, 8, 8, 32)), _randn(10, (2, 24))))


@pytest.mark.parametrize("name", ["channel_wise_attention", "adaptive_group_norm"])
def test_orphan_block_matches_jax(name):
    jax_m, port_m, inputs = _orphan(name, torch.float32)
    _check(jax_m, port_m, inputs, OP_ATOL)


@pytest.mark.parametrize("name", ["channel_wise_attention", "adaptive_group_norm"])
def test_orphan_block_bf16_matches_jax(name):
    """dtype=bfloat16 (the Dense layers in bf16) against the JAX block of
    dtype=jnp.bfloat16 on the same float32 weights: the model bar."""
    jax32, _, inputs = _orphan(name, torch.float32)
    jax16, port16, _ = _orphan(name, torch.bfloat16)
    args = [jnp.asarray(a) for a in inputs]
    params = _random_params(jax32, *args)
    ref32 = np.asarray(jax32.apply({"params": params}, *args), np.float32)
    ref16 = np.asarray(jax16.apply({"params": params}, *args), np.float32)
    port = from_flax(port16, {"params": params})
    with torch.no_grad():
        got = port(*(_t(a) for a in inputs)).float().numpy()
    scale = np.abs(ref32).max()
    own, gap = np.abs(ref16 - ref32).max() / scale, np.abs(got - ref16).max() / scale
    assert gap <= 2 * own and gap < 2e-2, (gap, own)


def test_agn_identity_at_init():
    """gamma's bias starts at 1 and beta's at 0: with a zero style the block
    is a plain GroupNorm."""
    x = _t(_randn(11, (2, 3, 6, 6, 16)))
    with torch.no_grad():
        y = blocks.AdaptiveGroupNorm(16, 8, 4)(x, torch.zeros(2, 8))
    ref = torch.nn.functional.group_norm(x.movedim(-1, 1), 4, eps=1e-6).movedim(1, -1)
    np.testing.assert_allclose(y.numpy(), ref.numpy(), atol=1e-6)
