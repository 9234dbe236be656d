"""The port's legacy UNet (tmdiff_tpu_torch/models/legacy_blocks.py,
legacy_unet.py) and its library convs (ops/library_conv.py) on the CPU:
the reference goldens of tests/test_unet_legacy.py through
`from_reference_state_dict` at that file's tolerance, each library conv
against the JAX package's XLA conv, and the assembled LegacyUNet against
the JAX model on the same flax weights (`from_flax`), at 16x16 and 32x32."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from tmdiff_tpu.models.legacy_unet import LegacyUNet as JaxLegacyUNet
from tmdiff_tpu.ops.modconv import DIMENSION_NUMBERS_3D
from tmdiff_tpu_torch.models.legacy_blocks import StridedDownStage, TransposedUpStage
from tmdiff_tpu_torch.models.legacy_unet import LegacyUNet
from tmdiff_tpu_torch.ops import library_conv
from tmdiff_tpu_torch.utils.weights import from_flax, from_reference_state_dict

torch.set_num_threads(2)

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
# tests/test_unet_legacy.py's tolerance for the golden stages
GOLDEN_ATOL = 2e-4
# a forward against the JAX model on the same weights, of the output's scale
FORWARD_RTOL = 1e-4
# a library conv against XLA's, of the output's scale (fp32 sums of up to
# 27 x 16 terms in another order)
CONV_RTOL = 1e-6
CHANNELS = (8, 16, 32, 64)


def _dhwc(x):
    return np.moveaxis(x, 1, -1)


@pytest.fixture(scope="module")
def golden():
    return np.load(os.path.join(GOLDEN, "unet_legacy.npz"))


def test_strided_down_golden(golden):
    m = from_reference_state_dict(StridedDownStage(4, 6, 8), dict(golden), prefix="down.")
    y = m(torch.as_tensor(_dhwc(golden["x"])), torch.as_tensor(golden["embed"]),
          torch.as_tensor(golden["ctx"]))
    np.testing.assert_allclose(y.detach().numpy(), _dhwc(golden["y_down"]), atol=GOLDEN_ATOL)


def test_transposed_up_golden(golden):
    m = from_reference_state_dict(TransposedUpStage(18, 6, 8), dict(golden), prefix="up.")
    xu = torch.as_tensor(_dhwc(golden["xu"]))
    y = m(xu, torch.as_tensor(golden["embed"]), torch.as_tensor(golden["ctx"]), xu, xu)
    np.testing.assert_allclose(y.detach().numpy(), _dhwc(golden["y_up"]), atol=GOLDEN_ATOL)


def _xla(kind, x, k):
    x, k = jnp.asarray(x), jnp.asarray(k)
    if kind == "strided":
        return lax.conv_general_dilated(x, k, (1, 2, 2), ((1, 1), (0, 0), (0, 0)),
                                        dimension_numbers=DIMENSION_NUMBERS_3D)
    if kind == "transposed":
        return lax.conv_transpose(x, k.swapaxes(-1, -2), (1, 2, 2), ((1, 1), (2, 3), (2, 3)),
                                  dimension_numbers=DIMENSION_NUMBERS_3D,
                                  transpose_kernel=True)
    return lax.conv_general_dilated(x, k, (1, 1, 1), ((0, 0), (1, 1), (1, 1)),
                                    dimension_numbers=DIMENSION_NUMBERS_3D)


@pytest.mark.parametrize("kind,x_shape,k_shape", [
    ("strided", (2, 4, 15, 17, 6), (3, 3, 3, 6, 5)),
    ("transposed", (2, 4, 7, 5, 6), (3, 3, 3, 6, 5)),
    ("hint", (2, 1, 16, 12, 3), (1, 3, 3, 3, 16)),
])
def test_library_conv_against_xla(kind, x_shape, k_shape):
    """Each library conv against the JAX package's XLA conv, with its bias
    and its gradients (through the autograd Function's backward) against
    jax.grad; one call counted."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal(x_shape).astype(np.float32)
    k = (rng.standard_normal(k_shape) / np.sqrt(np.prod(k_shape[:-1]))).astype(np.float32)
    b = rng.standard_normal(k_shape[-1]).astype(np.float32)
    ref = np.asarray(_xla(kind, x, k)) + b
    g = rng.standard_normal(ref.shape).astype(np.float32)
    xt, kt, bt = (torch.tensor(a, requires_grad=True) for a in (x, k, b))
    library_conv.reset_calls()
    y = library_conv.library_conv3d(xt, kt, bt, kind=kind)
    assert library_conv.calls == {**dict.fromkeys(library_conv.KINDS, 0), kind: 1}
    assert y.shape == ref.shape and y.is_contiguous()
    scale = np.abs(ref).max()
    assert np.abs(y.detach().numpy() - ref).max() <= CONV_RTOL * scale
    y.backward(torch.as_tensor(g))
    dx, dk = jax.grad(lambda x, k: jnp.sum(_xla(kind, x, k) * g), (0, 1))(x, k)
    for got, want in ((xt.grad, dx), (kt.grad, dk), (bt.grad, g.sum((0, 1, 2, 3)))):
        want = np.asarray(want)
        assert np.abs(got.numpy() - want).max() <= CONV_RTOL * 10 * np.abs(want).max()


def _inputs(b=2, bands=4, size=16, seed=0):
    rng = np.random.default_rng(seed)
    return dict(x_t=rng.standard_normal((b, bands, size, size)).astype(np.float32),
                t=np.array([3.0, 7.0][:b], np.float32),
                pan=rng.standard_normal((b, 1, size, size)).astype(np.float32),
                ms=rng.standard_normal((b, bands, size, size)).astype(np.float32),
                prompt_emb=rng.standard_normal(768).astype(np.float32))


@pytest.mark.parametrize("size", [16, 32])
def test_legacy_unet_matches_jax(size, monkeypatch):
    """LegacyUNet on from_flax weights against the JAX model's apply, to
    FORWARD_RTOL of scale; the convs of one forward: 34 SAME 3x3x3 convs
    through K1's entry (its plain version's calls on the CPU) and 6 strided
    + 3 transposed library convs."""
    from tmdiff_tpu_torch.ops.cuda import conv3d as K

    k1 = {"calls": 0}
    plain = K.conv3d_plain

    def counted(*args, **kw):
        k1["calls"] += 1
        return plain(*args, **kw)

    monkeypatch.setattr(K, "conv3d_plain", counted)
    batch = _inputs(size=size)
    jmodel = JaxLegacyUNet(channels=CHANNELS, embed_dim=16, inter_dim=8)
    params = jmodel.init(jax.random.key(1), **{k: jnp.asarray(v) for k, v in batch.items()})
    ref = np.asarray(jmodel.apply(params, **{k: jnp.asarray(v) for k, v in batch.items()}))
    port = from_flax(LegacyUNet(CHANNELS, 16, 8, device="cpu"),
                     jax.tree.map(np.asarray, params["params"]))
    library_conv.reset_calls()
    with torch.no_grad():
        out = port(**{k: torch.as_tensor(v) for k, v in batch.items()}).numpy()
    assert out.shape == ref.shape == batch["x_t"].shape
    assert np.abs(out - ref).max() <= FORWARD_RTOL * np.abs(ref).max()
    assert library_conv.calls == {"strided": 6, "transposed": 3, "hint": 0}
    assert k1["calls"] == 34


def test_legacy_unet_seeded_and_refuses_train_without_rng():
    """A seed gives the same weights; train=True without a generator raises."""
    a, b = (LegacyUNet(CHANNELS, 16, 8, device="cpu", seed=4) for _ in range(2))
    for (k, va), vb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(va, vb), k
    batch = {k: torch.as_tensor(v) for k, v in _inputs().items()}
    with pytest.raises(ValueError, match="rng"):
        a(**batch, train=True)
