"""The port's bf16 path on the CPU against the JAX package's bf16 path: the
plain versions of the bf16 K1/K2/K3 instances against the Pallas kernels in
bf16 (interpret mode), `WavBEST(dtype=torch.bfloat16)` against the JAX
`WavBEST(dtype=jnp.bfloat16)` on carried weights, bf16 requests against the
JAX facade with x_T injected, and a bf16 conv and model under a gradient
(tests/test_torch_bf16_train.py holds bf16 training against JAX). Inputs
are made with numpy and handed to both packages.

The bars:
  * ROUNDING BAR (convs): each element within half a bf16 step (half the
    spacing of bf16 values at that magnitude, an RN rounding's largest
    error) for every bf16 rounding either side makes, plus 1e-6 of the
    output's scale for fp32 sums taken in another order. The port rounds a
    conv once (sum + bias + out); JAX rounds the conv, then its bf16 bias add
    and its bf16 add of the concat part. So two single roundings may land a
    full step apart: they do on a few elements in 1e5 (a bar of 2^-8 |ref|,
    one rounding's error, fails on such an element).
  * MODEL BAR: the port's bf16 output within twice JAX-bf16's own gap to
    JAX-fp32 (measured in the test) of JAX-bf16, and under 2e-2 of the
    output's scale, gaps as max |difference| over max |JAX fp32|. On a CPU
    sweep of ten seeds and sizes (16-64 pixels, 4 and 8 bands) JAX's own gap
    ranged 0.009-0.021 and the port's gap to JAX-bf16 0.010-0.021: the 2e-2
    cap sits at the edge of bf16's noise at these widths.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flax_params import random_flax_params
from tmdiff_tpu.models import WavBEST as JaxWavBEST
from tmdiff_tpu.ops import modconv as jax_modconv
from tmdiff_tpu.ops.pallas import banded_conv3d as pallas_conv
from tmdiff_tpu.ops.pallas.conv2d import conv3x3_nhwc as jax_conv3x3_nhwc
from tmdiff_tpu.pipeline import Pansharpener as JaxPansharpener
from tmdiff_tpu_torch.models.wavbest import WavBEST
from tmdiff_tpu_torch.ops import modconv
from tmdiff_tpu_torch.ops.cuda import conv2d as K3
from tmdiff_tpu_torch.ops.cuda import conv3d as K
from tmdiff_tpu_torch.pipeline import Pansharpener
from tmdiff_tpu_torch.utils.weights import from_flax

torch.set_num_threads(2)

CHANNELS = (8, 16, 32, 64)
SIZE = 32  # the smallest size at which the JAX model's banded lowering takes Pallas K1
FP32_ORDER_RTOL = 1e-6
MODEL_CAP = 2e-2


def half_step(a) -> np.ndarray:
    """Half the spacing of bf16 values at |a| (2^(e - 8) for |a| in [2^e,
    2^(e+1))): the largest error of one round-to-nearest to bf16."""
    a = np.abs(np.asarray(a, np.float64))
    e = np.floor(np.log2(np.where(a > 0, a, 1.0)))
    return np.where(a > 0, 2.0 ** (e - 8), 0.0)


def assert_within_roundings(got, ref, rounded):
    """ROUNDING BAR: |got - ref| <= half a step of every value that was
    rounded to bf16 (`rounded`: the results of each rounding, both sides)
    + 1e-6 of ref's scale."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    scale = np.abs(ref).max()
    bar = sum(half_step(r) for r in rounded) + FP32_ORDER_RTOL * scale
    over = np.abs(got - ref) > bar
    assert not over.any(), (f"{over.sum()} of {over.size} elements beyond the rounding bar; "
                            f"worst {np.abs(got - ref).max()} at scale {scale}")


def _np(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _bf(a):
    """numpy -> a bf16 torch tensor."""
    return torch.as_tensor(np.asarray(a, np.float32)).bfloat16()


@pytest.mark.parametrize("variant", ["v1", "v2"])
@pytest.mark.parametrize("d,cin,cout", [(8, 4, 32), (6, 4, 32), (8, 3, 64), (5, 2, 64), (3, 4, 64)])
def test_bf16_plain_k1_matches_pallas(rng, d, cin, cout, variant):
    """The K1/K2 entries' bf16 plain version against the JAX package's
    Pallas kernels in bf16 (interpret mode), at the cases of
    tests/test_torch_ops.py: the bare conv, with the style (JAX's
    `x * style.astype(x.dtype)` in bf16), and with style, bias and an
    accumulated `out` (JAX: + bias, + out, each in bf16). ROUNDING BAR."""
    x = jnp.asarray(rng.standard_normal((2, d, 16, 8, cin)), jnp.float32).astype(jnp.bfloat16)
    k = jnp.asarray(rng.standard_normal((3, 3, 3, cin, cout)) * 0.1, jnp.float32)
    s = jnp.asarray(1 + 0.5 * rng.standard_normal((2, cin)), jnp.float32).astype(jnp.bfloat16)
    b = jnp.asarray(rng.standard_normal(cout), jnp.float32).astype(jnp.bfloat16)
    o = jnp.asarray(rng.standard_normal((2, d, 16, 8, cout)), jnp.float32).astype(jnp.bfloat16)
    jax_fn = pallas_conv.banded_conv3d if variant == "v1" else pallas_conv.banded_conv3d_v2
    port_fn = K.banded_conv3d if variant == "v1" else K.banded_conv3d_v2
    kb = k.astype(jnp.bfloat16)
    xt, kt, st, bt, ot = _bf(_np(x)), torch.as_tensor(np.asarray(k)), _bf(_np(s)), _bf(_np(b)), \
        _bf(_np(o))

    conv = jax_fn(x, kb)
    got = port_fn(xt, kt)
    assert got.dtype == torch.bfloat16
    assert_within_roundings(got.float(), _np(conv), [_np(conv), got.float()])

    conv_s = jax_fn(x * s[:, None, None, None, :], kb)
    got = port_fn(xt, kt, st)
    assert_within_roundings(got.float(), _np(conv_s), [_np(conv_s), got.float()])

    with_bias = conv_s + b
    ref = with_bias + o
    got = port_fn(xt, kt, st, bt, ot.clone())
    assert_within_roundings(got.float(), _np(ref),
                            [_np(conv_s), _np(with_bias), _np(ref), got.float()])


@pytest.mark.parametrize("shape", [(2, 16, 12, 8, 16), (1, 32, 32, 16, 8)])
def test_bf16_plain_k3_matches_pallas(rng, shape):
    """K3's bf16 plain version against the JAX package's Pallas 3x3 conv in
    bf16 (interpret mode) at tests/test_torch_conv2d.py's cases, and the
    wrapper on a CPU tensor; ROUNDING BAR (one rounding a side)."""
    b, h, w, c, co = shape
    x = jnp.asarray(rng.standard_normal((b, h, w, c)), jnp.float32).astype(jnp.bfloat16)
    k = jnp.asarray(rng.standard_normal((3, 3, c, co)), jnp.float32).astype(jnp.bfloat16)
    ref = _np(jax_conv3x3_nhwc(x, k))
    for fn in (K3.conv3x3_nhwc_plain, K3.conv3x3_nhwc):
        got = fn(_bf(_np(x)), _bf(_np(k)))
        assert got.dtype == torch.bfloat16
        assert_within_roundings(got.float(), ref, [ref, got.float()])


def test_bf16_operands_round_like_jax(rng):
    """The bf16 kernels' A operand is x * s rounded once to bf16, bit for
    bit JAX's `x * style.astype(x.dtype)`; the banded weight of the
    band-into-lanes form is built from the fp32 kernel and cast."""
    x = jnp.asarray(rng.standard_normal((2, 3, 4, 4, 8)), jnp.float32).astype(jnp.bfloat16)
    s = jnp.asarray(rng.standard_normal((2, 8)), jnp.float32)
    ref = _np(x * s.astype(x.dtype)[:, None, None, None, :])
    xs, _, _, _ = K.bf16_operands(_bf(_np(x)), torch.zeros(1), _bf(np.asarray(s)))
    np.testing.assert_array_equal(xs.numpy(), ref)
    k = torch.as_tensor(rng.standard_normal((3, 3, 3, 8, 4)), dtype=torch.float32)
    w2 = modconv.banded_weight(k, 3).to(torch.bfloat16)
    np.testing.assert_array_equal(w2.float().numpy(),
                                  modconv.banded_weight(k.to(torch.bfloat16), 3).float().numpy())


@pytest.fixture
def jax_banded(monkeypatch):
    """The JAX package's "banded" lowering (Pallas K1 where eligible), with
    its Pallas K1 calls counted."""
    monkeypatch.setattr(jax_modconv, "CONV3D_IMPL", "banded")
    calls = []
    original = pallas_conv.banded_conv3d
    monkeypatch.setattr(pallas_conv, "banded_conv3d",
                        lambda x, kernel, *a: calls.append(x.dtype) or original(x, kernel, *a))
    return calls


@pytest.fixture(scope="module")
def carried():
    params = random_flax_params(JaxWavBEST(channels=CHANNELS), seed=7)
    port = from_flax(WavBEST(CHANNELS, device="cpu", dtype=torch.bfloat16),
                     jax.tree.map(np.asarray, params))
    return params, port


def _inputs(bands):
    rng = np.random.default_rng(bands)
    x = rng.standard_normal((2, bands, SIZE, SIZE)).astype(np.float32)
    pan = rng.uniform(size=(2, 1, SIZE, SIZE)).astype(np.float32)
    ms = rng.uniform(size=(2, bands, SIZE, SIZE)).astype(np.float32)
    return x, pan, ms, rng.standard_normal(768).astype(np.float32)


def assert_model_bar(got, jax_bf16, jax_fp32):
    """MODEL BAR; returns (the port's gap, JAX's own gap)."""
    scale = np.abs(jax_fp32).max()
    own = np.abs(jax_bf16 - jax_fp32).max() / scale
    gap = np.abs(got - jax_bf16).max() / scale
    assert gap <= 2 * own and gap < MODEL_CAP, (gap, own)
    return gap, own


@pytest.mark.parametrize("bands", [4, 8])
def test_bf16_model_matches_jax_bf16(carried, jax_banded, bands):
    """The port's bf16 WavBEST forward (K1's bf16 plain version at every
    3x3x3 conv) against the JAX bf16 model under its banded lowering, same
    weights and inputs: MODEL BAR. Both outputs are float32, and the port's
    parameters stay float32."""
    params, port = carried
    x, pan, ms, prompt = _inputs(bands)
    t = np.array([3.0, 812.5], np.float32)
    outs = {}
    for dtype in (jnp.float32, jnp.bfloat16):
        jax_banded.clear()
        outs[dtype] = jax.jit(JaxWavBEST(channels=CHANNELS, dtype=dtype).apply)(
            params, x, t, pan, ms, prompt)
        assert outs[dtype].dtype == jnp.float32
        assert jax_banded and set(jax_banded) == {jnp.dtype(dtype)}  # Pallas K1 ran
    with torch.no_grad():
        y = port(*(torch.as_tensor(a) for a in (x, t, pan, ms, prompt)))
    assert y.dtype == torch.float32 and y.shape == (2, bands, SIZE, SIZE)
    assert all(p.dtype == torch.float32 for p in port.parameters())
    assert_model_bar(y.numpy(), np.asarray(outs[jnp.bfloat16]), np.asarray(outs[jnp.float32]))


@pytest.mark.parametrize("method,bands,kw", [
    ("ddim", 4, dict(steps=2)),
    ("ddim_cached", 8, dict(steps=4, refresh_every=2, cache_level=3)),
])
def test_bf16_requests_match_jax_bf16(carried, jax_banded, method, bands, kw):
    """A 2-step ddim and a block-cached ddim request on the bf16 model
    against the JAX facade's bf16 and fp32 models, x_T injected: MODEL BAR
    on the images. The cached trunk stays in bf16 between the steps."""
    params, port = carried
    x, pan, ms, _ = _inputs(bands)
    batch, sensor = {"PAN": pan, "MS": ms}, ("QB" if bands == 4 else "WV3")
    imgs = {dtype: np.asarray(JaxPansharpener(JaxWavBEST(channels=CHANNELS, dtype=dtype), params)
                              .sample(batch, sensor=sensor, method=method, x_init=x, **kw))
            for dtype in (jnp.float32, jnp.bfloat16)}
    deep = []
    original = port.denoise_deep
    port.denoise_deep = lambda *a, **k: (lambda r: deep.append(r[1]) or r)(original(*a, **k))
    try:
        out = Pansharpener(port, device="cpu").sample(batch, sensor=sensor, method=method,
                                                      x_init=x, **kw)
    finally:
        del port.denoise_deep
    assert out.dtype == np.float32 and out.shape == ms.shape
    assert len(deep) == {"ddim": 0, "ddim_cached": 2}[method]
    assert all(d.dtype == torch.bfloat16 for d in deep)
    assert_model_bar(out, imgs[jnp.bfloat16], imgs[jnp.float32])


def test_bf16_sample_takes_ema_params(carried):
    """Pansharpener.sample(params=) on the bf16 model: fp32 EMA-like weights
    swapped in for one call give what the model gives with those weights
    loaded, and the model's own weights come back untouched."""
    _, port = carried
    x, pan, ms, _ = _inputs(4)
    batch = {"PAN": pan[:1, :, :16, :16], "MS": ms[:1, :, :16, :16]}
    x_T = x[:1, :, :16, :16]
    gen = torch.Generator().manual_seed(0)
    ema = {n: p.detach() + 0.01 * torch.randn(p.shape, generator=gen)
           for n, p in port.named_parameters()}
    own = {n: p.detach().clone() for n, p in port.named_parameters()}
    sharp = Pansharpener(port, device="cpu")
    swapped = sharp.sample(batch, method="ddim", steps=2, x_init=x_T, params=ema)
    assert all(torch.equal(p, own[n]) for n, p in port.named_parameters())
    loaded = from_flax(WavBEST(CHANNELS, device="cpu", dtype=torch.bfloat16),
                       jax.tree.map(np.asarray, random_flax_params(JaxWavBEST(channels=CHANNELS),
                                                                   seed=7)))
    with torch.no_grad():
        for n, p in loaded.named_parameters():
            p.copy_(ema[n])
    direct = Pansharpener(loaded, device="cpu").sample(batch, method="ddim", steps=2, x_init=x_T)
    np.testing.assert_array_equal(swapped, direct)
    assert not np.array_equal(swapped, sharp.sample(batch, method="ddim", steps=2, x_init=x_T))


def test_bf16_conv_gradient_runs():
    """A bf16 conv under a gradient runs (Conv3dFunction in bf16, the input
    and weight gradients in bf16) through both entries; a bf16 WavBEST
    forward with a gradient returns float32 and reaches every parameter,
    as without one; float16 is refused."""
    x = torch.randn(1, 3, 8, 8, 8, dtype=torch.bfloat16, requires_grad=True)
    k = torch.randn(3, 3, 3, 8, 8, dtype=torch.bfloat16, requires_grad=True)
    for fn in (K.banded_conv3d, K.banded_conv3d_v2):
        x.grad = k.grad = None
        y = fn(x, k)
        assert y.dtype == torch.bfloat16 and y.grad_fn is not None
        y.float().sum().backward()
        assert x.grad.dtype == k.grad.dtype == torch.bfloat16
    model = WavBEST((8, 8, 8, 8), device="cpu", dtype=torch.bfloat16)
    pan, ms = torch.rand(1, 1, 16, 16), torch.rand(1, 4, 16, 16)
    y = model(torch.randn(1, 4, 16, 16), torch.ones(1), pan, ms, torch.zeros(768))
    assert y.dtype == torch.float32
    y.sum().backward()
    assert all(p.grad is not None and p.grad.dtype == torch.float32
               for p in model.parameters())
    with torch.no_grad():
        assert model(torch.randn(1, 4, 16, 16), torch.ones(1), pan, ms,
                     torch.zeros(768)).dtype == torch.float32
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        WavBEST((8, 8, 8, 8), device="cpu", dtype=torch.float16)
