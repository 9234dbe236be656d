"""The port's ops (tmdiff_tpu_torch/ops) against the goldens and the JAX
package: gamma embedding, Haar DWT, modulated conv, and the plain version of
the 3x3x3 conv kernel against the JAX package's Pallas kernels (interpret
mode) and F.conv3d. On the CPU the kernel wrappers compute the plain
version; the kernel itself is checked on the card (test_torch_cuda.py,
chip_smoke.py)."""
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from tmdiff_tpu.ops.modconv import _conv3d_fold2d
from tmdiff_tpu.ops.pallas import banded_conv3d as pallas_conv
from tmdiff_tpu_torch.ops import modconv, wavelet
from tmdiff_tpu_torch.ops.cuda import conv3d as K
from tmdiff_tpu_torch.ops.embedding import gamma_embedding

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "golden")


def _t(a):
    return torch.as_tensor(np.asarray(a, np.float32))


def _ref_conv(x, k, style=None, bias=None):
    """F.conv3d of NDHWC x, (3, 3, 3, Cin, Cout) k, in float64."""
    x = x.double()
    if style is not None:
        x = x * style.double()[:, None, None, None, :]
    y = F.conv3d(x.permute(0, 4, 1, 2, 3), k.double().permute(4, 3, 0, 1, 2),
                 None if bias is None else bias.double(), padding=k.shape[0] // 2)
    return y.permute(0, 2, 3, 4, 1).float()


def test_gamma_embedding_golden():
    """atol 1e-5, the JAX test's bar: fp32 cos/sin of arguments up to ~1e3."""
    g = np.load(os.path.join(GOLDEN, "gamma_embedding.npz"))
    t = _t(g["t"])
    np.testing.assert_allclose(gamma_embedding(t, 32).numpy(), g["dim32"], atol=1e-5)
    np.testing.assert_allclose(gamma_embedding(t, 31).numpy(), g["dim31"], atol=1e-5)


def test_haar_golden():
    """Haar DWT/IDWT against the reference's matrix form; atol 1e-5 (fp32
    butterflies of unit-scale data)."""
    g = np.load(os.path.join(GOLDEN, "dwt.npz"))
    hwc = lambda a: np.moveaxis(a, 1, -1)
    bands = wavelet.dwt2d(_t(hwc(g["haar_x"])))
    for name, mine in zip(("ll", "lh", "hl", "hh"), bands):
        np.testing.assert_allclose(mine.numpy(), hwc(g[f"haar_{name}"]), atol=1e-5, err_msg=name)
    np.testing.assert_allclose(wavelet.idwt2d(*bands).numpy(), hwc(g["haar_rec"]), atol=1e-5)
    np.testing.assert_array_equal(wavelet.dwt2d_ll(_t(hwc(g["haar_x"]))).numpy(), bands[0].numpy())


def test_modulated_conv_golden():
    """conv(x * s, W) reproduces the reference's batch-grouped modulated
    conv; atol 2e-4, the JAX test's bar."""
    g = np.load(os.path.join(GOLDEN, "modulated_conv.npz"))
    x = _t(np.moveaxis(g["x"], 1, -1))
    w = _t(np.transpose(g["w"], (2, 3, 4, 1, 0)))
    y = modconv.modulated_conv3d(x, w, _t(g["s"]))
    np.testing.assert_allclose(y.numpy(), np.moveaxis(g["y"], 1, -1), atol=2e-4)


@pytest.mark.parametrize("variant", ["v1", "v2"])
@pytest.mark.parametrize("d,cin,cout", [(8, 4, 32), (6, 4, 32), (8, 3, 64), (5, 2, 64), (3, 4, 64)])
def test_plain_matches_pallas(rng, d, cin, cout, variant):
    """The K1/K2 entries' plain version against the JAX package's Pallas
    kernels run in interpret mode, at the cases of tests/test_ops.py;
    atol 1e-4, that test's bar (fp32 sums of 27 * Cin terms)."""
    x = rng.standard_normal((2, d, 16, 8, cin)).astype(np.float32)
    k = (rng.standard_normal((3, 3, 3, cin, cout)) * 0.1).astype(np.float32)
    jax_fn = pallas_conv.banded_conv3d if variant == "v1" else pallas_conv.banded_conv3d_v2
    port_fn = K.banded_conv3d if variant == "v1" else K.banded_conv3d_v2
    ref = np.asarray(jax_fn(jnp.asarray(x), jnp.asarray(k)))
    np.testing.assert_allclose(port_fn(_t(x), _t(k)).numpy(), ref, atol=1e-4)
    np.testing.assert_allclose(K.conv3d_plain(_t(x), _t(k)).numpy(),
                               np.asarray(_conv3d_fold2d(jnp.asarray(x), jnp.asarray(k))), atol=1e-4)


@pytest.mark.parametrize("shape", [
    (2, 4, 8, 8, 16, 256),   # Cout = 256, D <= 128 / Cout
    (1, 8, 12, 10, 5, 7),    # H % 8 != 0, odd channels
    (2, 4, 2, 2, 24, 8),     # the window overhangs a 2x2 image
    (1, 8, 6, 6, 1, 32),     # Cin = 1
    (2, 3, 5, 9, 96, 32),    # a 3C decoder part width, tails everywhere
])
def test_plain_matches_f_conv3d(rng, shape):
    """Style, bias and accumulation at shapes the TPU kernel refuses, against
    F.conv3d in float64; atol 1e-4 (fp32 sums of up to 27 * 96 terms)."""
    b, d, h, w, cin, cout = shape
    x = _t(rng.standard_normal((b, d, h, w, cin)))
    k = _t(rng.standard_normal((3, 3, 3, cin, cout)) / np.sqrt(27 * cin))
    s = _t(1 + 0.5 * rng.standard_normal((b, cin)))
    bias = _t(rng.standard_normal(cout))
    out0 = _t(rng.standard_normal((b, d, h, w, cout)))
    ref = _ref_conv(x, k, s, bias)
    np.testing.assert_allclose(K.banded_conv3d(x, k, s, bias).numpy(), ref.numpy(), atol=1e-4)
    got = K.banded_conv3d_v2(x, k, s, bias, out=out0.clone())
    np.testing.assert_allclose(got.numpy(), (ref + out0).numpy(), atol=1e-4)


def test_conv3d_cat_and_grouped_slices(rng):
    """conv3d_cat equals the conv of the concat (one accumulate per part),
    and a kernel sliced along Cout (a group of GroupedSkipConv) or Cin (a
    concat part) is taken as a view; atol 1e-4."""
    parts = tuple(_t(rng.standard_normal((2, 4, 8, 8, c))) for c in (3, 5, 4))
    k = _t(rng.standard_normal((3, 3, 3, 12, 6)) * 0.2)
    bias = _t(rng.standard_normal(6))
    ref = _ref_conv(torch.cat(parts, -1), k, bias=bias)
    np.testing.assert_allclose(modconv.conv3d_cat(parts, k, bias=bias).numpy(), ref.numpy(), atol=1e-4)
    kg = _t(rng.standard_normal((3, 3, 3, 3, 18)) * 0.2)
    y = modconv.conv3d(parts[0], kg[..., 6:12], bias=bias)
    np.testing.assert_allclose(y.numpy(), _ref_conv(parts[0], kg[..., 6:12].contiguous(), bias=bias).numpy(),
                               atol=1e-4)
    k1 = _t(rng.standard_normal((1, 1, 1, 12, 6)))
    np.testing.assert_allclose(modconv.conv3d_cat(parts, k1, bias=bias).numpy(),
                               _ref_conv(torch.cat(parts, -1), k1, bias=bias).numpy(), atol=1e-4)
    with pytest.raises(ValueError, match="only 1x1x1 and 3x3x3"):
        modconv.conv3d(parts[0], _t(np.zeros((5, 5, 5, 3, 2))))


def test_wrapper_checks_and_no_fallback(rng):
    """The wrapper's input checks, and no quiet fallback: a device without a
    kernel raises instead of running the plain version."""
    x = _t(rng.standard_normal((1, 4, 8, 8, 4)))
    k = _t(rng.standard_normal((3, 3, 3, 4, 8)))
    K._check(x, k, None, None, None)
    with pytest.raises(ValueError, match="contiguous"):
        K._check(x.transpose(2, 3), k, None, None, None)
    with pytest.raises(TypeError, match="float32"):
        K._check(x.double(), k, None, None, None)
    with pytest.raises(ValueError, match="strides"):
        K._check(x, k.transpose(0, 2).contiguous().transpose(0, 2), None, None, None)
    with pytest.raises(ValueError, match="style"):
        K._check(x, k, torch.ones(2, 4), None, None)
    with pytest.raises(RuntimeError, match="no backward"):
        K._check(x, k.clone().requires_grad_(), None, None, None)
    with pytest.raises(ValueError, match="no conv3d kernel"):
        K.banded_conv3d(x.to("meta"), k.to("meta"))
    before = K.launches
    K.banded_conv3d(x, k)
    assert K.launches == before  # the CPU path launches nothing


def test_port_imports_no_jax():
    """The port and chip_smoke.py import neither jax/flax nor tmdiff_tpu."""
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO, "tmdiff_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    bad = re.compile(r"^\s*(import|from)\s+(jax|flax|tmdiff_tpu(?!_torch))\b")
    offenders = [f"{f}:{i}" for f in files
                 for i, line in enumerate(open(f, encoding="utf-8"), 1) if bad.match(line)]
    names = {os.path.relpath(f, REPO) for f in files}
    assert {"tmdiff_tpu_torch/ops/attention.py", "tmdiff_tpu_torch/ops/cuda/conv2d.py",
            "tmdiff_tpu_torch/ops/cuda/flash_attention.py"} <= names
    assert len(files) > 10 and not offenders, offenders
