"""The port's band-into-lanes conv path (K3) on the CPU: the plain version of
the 3x3 NHWC kernel against the JAX package's Pallas kernel (interpret mode),
the port's `_conv3d_bandlanes` and `_bandlanes_wins` against the JAX
package's, and the "auto" WavBEST forward and dpm++ request against the JAX
model under TMDIFF_BANDLANES_CONV=pallas (monkeypatched, then traced)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import tmdiff_tpu.ops.modconv as jax_modconv
import tmdiff_tpu.ops.pallas.conv2d as jax_conv2d
from tmdiff_tpu.models import WavBEST as JaxWavBEST
from tmdiff_tpu.ops.pallas.conv2d import conv3x3_nhwc as jax_conv3x3_nhwc
from tmdiff_tpu.pipeline import Pansharpener as JaxPansharpener
from tmdiff_tpu_torch.models.wavbest import WavBEST
from tmdiff_tpu_torch.ops import modconv
from tmdiff_tpu_torch.ops.cuda import conv2d as K3
from tmdiff_tpu_torch.pipeline import Pansharpener
from tmdiff_tpu_torch.utils.weights import from_flax

torch.set_num_threads(2)

CHANNELS = (8, 16, 32, 64)


def _t(a):
    return torch.as_tensor(np.asarray(a, np.float32))


@pytest.fixture
def pallas_bandlanes(monkeypatch):
    """The JAX package's "auto" lowering with its Pallas 3x3 conv."""
    monkeypatch.setattr(jax_modconv, "CONV3D_IMPL", "auto")
    monkeypatch.setattr(jax_modconv, "BANDLANES_CONV", "pallas")


def _random_flax_params(model, seed):
    x = jnp.zeros((1, 4, 16, 16))
    tree = jax.eval_shape(model.init, jax.random.key(0), x, jnp.ones(1), x[:, :1], x,
                          jnp.zeros(768))
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        names = [str(p.key) for p in path]
        if names[-1] == "kernel":
            fan_in = int(np.prod(leaf.shape[:-1]))
            return (rng.standard_normal(leaf.shape) / np.sqrt(fan_in)).astype(np.float32)
        base = 1.0 if "style" in names else 0.0
        return (base + 0.1 * rng.standard_normal(leaf.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, tree)


@pytest.fixture(scope="module")
def carried():
    """JAX model + params and the port's "auto" model filled from them."""
    jmodel = JaxWavBEST(channels=CHANNELS)
    params = _random_flax_params(jmodel, seed=5)
    port = from_flax(WavBEST(CHANNELS, device="cpu"), jax.tree.map(np.asarray, params))
    return jmodel, params, port.use_conv_impl("auto")


@pytest.mark.parametrize("shape", [(2, 16, 12, 8, 16), (1, 32, 32, 16, 8)])
def test_plain_matches_pallas(rng, shape):
    """conv3x3_nhwc_plain (and the wrapper on a CPU tensor) against the JAX
    Pallas kernel in interpret mode, at tests/test_library_ops.py's cases;
    atol 1e-4, that test's bar."""
    b, h, w, c, co = shape
    x = rng.standard_normal((b, h, w, c)).astype(np.float32)
    k = rng.standard_normal((3, 3, c, co)).astype(np.float32)
    ref = np.asarray(jax_conv3x3_nhwc(jnp.asarray(x), jnp.asarray(k)))
    np.testing.assert_allclose(K3.conv3x3_nhwc_plain(_t(x), _t(k)).numpy(), ref, atol=1e-4)
    np.testing.assert_allclose(K3.conv3x3_nhwc(_t(x), _t(k)).numpy(), ref, atol=1e-4)


@pytest.mark.parametrize("shape", [(2, 13, 7, 24, 64), (1, 1, 2, 5, 3)])
def test_plain_style_bias_matches_f_conv2d(rng, shape):
    """Style and bias, at H % 8 != 0 and a window that overhangs the image,
    against F.conv2d in float64; atol 1e-4 (fp32 sums of 9 * 24 terms)."""
    b, h, w, c, co = shape
    x = _t(rng.standard_normal((b, h, w, c)))
    k = _t(rng.standard_normal((3, 3, c, co)) / np.sqrt(9 * c))
    s = _t(1 + 0.5 * rng.standard_normal((b, c)))
    bias = _t(rng.standard_normal(co))
    ref = F.conv2d((x * s[:, None, None, :]).double().permute(0, 3, 1, 2),
                   k.double().permute(3, 2, 0, 1), bias.double(), padding=1).permute(0, 2, 3, 1)
    np.testing.assert_allclose(K3.conv3x3_nhwc(x, k, s, bias).numpy(), ref.numpy(), atol=1e-4)


def test_wrapper_checks_and_no_fallback(rng):
    x = _t(rng.standard_normal((1, 8, 8, 4)))
    k = _t(rng.standard_normal((3, 3, 4, 8)))
    K3._check(x, k, None, None)
    with pytest.raises(ValueError, match="contiguous"):
        K3._check(x.transpose(1, 2), k, None, None)
    with pytest.raises(TypeError, match="float32"):
        K3._check(x.double(), k, None, None)
    with pytest.raises(ValueError, match="strides"):
        K3._check(x, k.transpose(0, 1).contiguous().transpose(0, 1), None, None)
    with pytest.raises(ValueError, match="w must be"):
        K3._check(x, _t(np.zeros((3, 3, 5, 8))), None, None)
    with pytest.raises(ValueError, match="bias"):
        K3._check(x, k, None, torch.ones(7))
    with pytest.raises(RuntimeError, match="no backward"):
        K3._check(x, k.clone().requires_grad_(), None, None)
    with pytest.raises(ValueError, match="no conv3x3_nhwc kernel"):
        K3.conv3x3_nhwc(x.to("meta"), k.to("meta"))
    before = K3.launches
    K3.conv3x3_nhwc(x, k)
    assert K3.launches == before  # the CPU path launches nothing


@pytest.mark.parametrize("shape", [
    (2, 4, 16, 16, 8, 8),    # H % 8 == 0: the JAX package's Pallas kernel
    (1, 8, 8, 16, 4, 32),
    (2, 4, 2, 2, 8, 8),      # the window overhangs the image: native conv / K1
    (1, 8, 12, 10, 5, 7),    # H % 8 != 0: XLA's 2-D conv there, K3 here
])
def test_bandlanes_matches_jax(rng, pallas_bandlanes, shape):
    """The port's `_conv3d_bandlanes`, with style, bias and accumulation
    folded around it as the port does, against the JAX function on x * s
    plus bias; atol 1e-4 (fp32 sums of up to 9 * D * Cin terms)."""
    b, d, h, w, cin, cout = shape
    x = rng.standard_normal((b, d, h, w, cin)).astype(np.float32)
    k = (rng.standard_normal((3, 3, 3, cin, cout)) / np.sqrt(27 * cin)).astype(np.float32)
    s = (1 + 0.5 * rng.standard_normal((b, cin))).astype(np.float32)
    bias = rng.standard_normal(cout).astype(np.float32)
    out0 = rng.standard_normal((b, d, h, w, cout)).astype(np.float32)
    ref = np.asarray(jax_modconv._conv3d_bandlanes(jnp.asarray(x), jnp.asarray(k)))
    np.testing.assert_allclose(modconv._conv3d_bandlanes(_t(x), _t(k)).numpy(), ref, atol=1e-4)
    ref_sb = np.asarray(jax_modconv._conv3d_bandlanes(
        jnp.asarray(x * s[:, None, None, None, :]), jnp.asarray(k))) + bias + out0
    got = modconv._conv3d_bandlanes(_t(x), _t(k), _t(s), _t(bias), out=_t(out0))
    np.testing.assert_allclose(got.numpy(), ref_sb, atol=1e-4)


def test_bandlanes_wins_matches_jax(monkeypatch):
    """The same routing as the JAX rule on a grid of (d, kd, cout, h), with
    and without its Cout overrides (module constants in both packages)."""
    grid = [(d, kd, cout, h) for d in (1, 3, 4, 8, 12) for kd in (1, 3) for cout in
            (1, 16, 32, 63, 64, 96, 128, 256) for h in (0, 2, 32, 128, 129, 256)]
    for native, bandlanes in ((frozenset(), frozenset()), (frozenset({32}), frozenset({64}))):
        for mod in (jax_modconv, modconv):
            monkeypatch.setattr(mod, "AUTO_NATIVE_COUTS", native)
            monkeypatch.setattr(mod, "AUTO_BANDLANES_COUTS", bandlanes)
        got = [modconv._bandlanes_wins(*g) for g in grid]
        assert got == [jax_modconv._bandlanes_wins(*g) for g in grid]
        assert any(got) and not all(got)


def test_conv_impl_checks():
    model = WavBEST(CHANNELS, device="cpu")
    with pytest.raises(ValueError, match="unknown conv lowering"):
        model.use_conv_impl("lax")
    with pytest.raises(ValueError, match="unknown conv lowering"):
        modconv.conv3d(torch.zeros(1, 2, 4, 4, 3), torch.zeros(3, 3, 3, 3, 2), impl="fold2d")
    assert model.use_conv_impl("auto") is model
    assert all(m.impl == "auto" for m in model.modules() if hasattr(m, "impl"))


@pytest.mark.parametrize("bands", [4, 8])
def test_auto_forward_matches_jax(carried, pallas_bandlanes, monkeypatch, bands):
    """The "auto" WavBEST forward against the JAX model traced under the
    patch, same weights and inputs; atol 5e-4, the forward bar. Also counts
    the convs the port sends to K3: of the 65 3x3x3 convs (one per concat
    part and group), the 12 at the 2x2 level overhang and go to K1; at 8
    bands the 6 Cout-64 convs at 4x4 (encode and denoise: down3's ResBlock
    pair and Conv_0) stay native, i.e. K1, by the deep-band rule."""
    jmodel, params, port = carried
    rng = np.random.default_rng(bands)
    x = rng.standard_normal((2, bands, 16, 16)).astype(np.float32)
    pan = rng.uniform(size=(2, 1, 16, 16)).astype(np.float32)
    ms = rng.uniform(size=(2, bands, 16, 16)).astype(np.float32)
    prompt = rng.standard_normal(768).astype(np.float32)
    t = np.array([3.0, 812.5], np.float32)
    traced = []
    monkeypatch.setattr(jax_conv2d, "conv3x3_nhwc",
                        lambda *a: traced.append(a[0].shape) or jax_conv3x3_nhwc(*a))
    ref = jax.jit(jmodel.apply)(params, x, t, pan, ms, prompt)
    assert {s[1] for s in traced} == {16, 8}  # the JAX Pallas kernel takes H % 8 == 0
    calls = []
    original = modconv.conv3x3_nhwc
    monkeypatch.setattr(modconv, "conv3x3_nhwc",
                        lambda *a: calls.append(a[0].shape) or original(*a))
    with torch.no_grad():
        y = port(*(_t(a) for a in (x, t, pan, ms, prompt)))
    assert y.shape == (2, bands, 16, 16)
    np.testing.assert_allclose(y.numpy(), np.asarray(ref), atol=5e-4)
    assert len(calls) == {4: 65 - 12, 8: 65 - 12 - 6}[bands]
    assert {s[1] for s in calls} == {16, 8, 4}


def test_auto_dpm_matches_jax(pallas_bandlanes):
    """A short dpm++ request (4 steps, numpy-made x_T) through the "auto"
    port and the JAX Pansharpener under the patch; atol 2e-3, the sampling
    bar."""
    jmodel = JaxWavBEST(channels=CHANNELS)
    params = _random_flax_params(jmodel, seed=9)
    port = from_flax(WavBEST(CHANNELS, device="cpu"), jax.tree.map(np.asarray, params))
    port.use_conv_impl("auto")
    rng = np.random.default_rng(13)
    ms = rng.uniform(0.1, 0.9, (2, 8, 16, 16)).astype(np.float32)
    batch = {"PAN": ms.mean(1, keepdims=True), "MS": ms}
    x_T = rng.standard_normal(ms.shape).astype(np.float32)
    ref = JaxPansharpener(jmodel, params).sample(batch, sensor="WV3", method="dpm++",
                                                 steps=4, x_init=x_T)
    out = Pansharpener(port, device="cpu").sample(batch, sensor="WV3", method="dpm++",
                                                  steps=4, x_init=x_T)
    assert out.shape == ms.shape and out.min() >= 0.0 and out.max() <= 1.0
    np.testing.assert_allclose(out, np.asarray(ref), atol=2e-3)
