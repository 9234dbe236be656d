"""The port's loss library on the CPU: utils/image_ops.py, train/losses.py
and train/loss_zoo.py against the JAX package's on the same numpy inputs,
the cases of tests/test_losses.py, and every value of the reference golden
loss_zoo.npz at tests/test_loss_zoo.py's tolerances.

Bars: a loss, filter or op within 1e-5 absolute of the JAX function's value
(1e-5 of its magnitude where that exceeds 1: the FLoss sums of squares run
to the hundreds and fp32 sums in another order differ in the last bits).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tmdiff_tpu.train import loss_zoo as jax_zoo
from tmdiff_tpu.train import losses as jax_losses
from tmdiff_tpu.utils import image_ops as jax_ops
from tmdiff_tpu_torch.train import loss_zoo as Z
from tmdiff_tpu_torch.train import losses
from tmdiff_tpu_torch.utils import image_ops as ops

torch.set_num_threads(2)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
ATOL = 1e-5


def _close(got, ref):
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got, np.float64)
    ref = np.asarray(ref, np.float64)
    bar = ATOL * np.maximum(1.0, np.abs(ref))
    assert got.shape == ref.shape and np.all(np.abs(got - ref) <= bar), np.abs(got - ref).max()


def _both(arrays):
    """The same float32 numpy arrays as torch tensors and as jnp arrays."""
    return ([torch.as_tensor(np.array(a, np.float32)) for a in arrays],
            [jnp.asarray(np.asarray(a, np.float32)) for a in arrays])


def _images(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.random(s).astype(np.float32) for s in shapes]


# --- utils/image_ops.py ------------------------------------------------------

ODD = np.arange(9, dtype=np.float32).reshape(3, 3) / 36.0
EVEN = np.arange(8, dtype=np.float32).reshape(2, 4) / 28.0

OPS = {
    "filter2d_same_odd": lambda m, x, y, k: m.filter2d(x, k[0]),
    "filter2d_same_even": lambda m, x, y, k: m.filter2d(x, k[1]),
    "filter2d_valid_even": lambda m, x, y, k: m.filter2d(x, k[1], "VALID"),
    "box_blur": lambda m, x, y, k: m.box_blur(x, 3),
    "gaussian_blur": lambda m, x, y, k: m.gaussian_blur(x, 5, 1.3),
    "get_lp": lambda m, x, y, k: m.get_lp(x),
    "get_hp": lambda m, x, y, k: m.get_hp(x),
    "get_edge": lambda m, x, y, k: m.get_edge(x),
    "sobel_x": lambda m, x, y, k: m.sobel_gradient(x)[0],
    "sobel_y": lambda m, x, y, k: m.sobel_gradient(x)[1],
    "laplacian": lambda m, x, y, k: m.laplacian(x),
    "psnr": lambda m, x, y, k: m.psnr(x, y),
    "ssim": lambda m, x, y, k: m.ssim(x, y),
    "sam_loss": lambda m, x, y, k: m.sam_loss(x, y),
    "gaussian_kernel2d": lambda m, x, y, k: m.gaussian_kernel2d(7, 2.0),
}


@pytest.mark.parametrize("name", sorted(OPS))
def test_image_op_matches_jax(name):
    """Each filter and op against the JAX function on a (2, 16, 16, 3)
    image: SAME padding with odd and even kernels (XLA puts the odd pixel
    after), VALID, and the kernels themselves."""
    (x, y), (jx, jy) = _both(_images(0, (2, 16, 16, 3), (2, 16, 16, 3)))
    (k0, k1), (jk0, jk1) = _both([ODD, EVEN])
    _close(OPS[name](ops, x, y, (k0, k1)), OPS[name](jax_ops, jx, jy, (jk0, jk1)))


def test_filters():
    """tests/test_losses.py::test_filters: shapes, a unit Gaussian, and
    high pass + low pass = x."""
    x = torch.as_tensor(_images(1, (2, 16, 16, 3))[0])
    assert ops.box_blur(x).shape == x.shape and ops.gaussian_blur(x).shape == x.shape
    np.testing.assert_allclose(float(ops.gaussian_kernel2d(5, 1.0).sum()), 1.0, rtol=1e-6)
    np.testing.assert_allclose((ops.get_hp(x) + ops.get_lp(x)).numpy(), x.numpy(), atol=1e-6)


def test_ssim_psnr_extremes():
    x = torch.as_tensor(_images(2, (1, 32, 32, 2))[0])
    assert float(ops.ssim(x, x)) > 0.9999
    assert float(ops.ssim(x, x + 0.2)) < float(ops.ssim(x, x))
    np.testing.assert_allclose(float(ops.psnr(x, x + 0.1)), 20.0, atol=0.2)


# --- train/losses.py ---------------------------------------------------------

LOSSES = {
    "l1": lambda m, p, t, pan, lr: m.l1(p, t),
    "l2": lambda m, p, t, pan, lr: m.l2(p, t),
    "smooth_l1": lambda m, p, t, pan, lr: m.smooth_l1(3 * p, t),
    "spectral_consistency": lambda m, p, t, pan, lr: m.spectral_consistency(p, lr),
    "gradient_sobel": lambda m, p, t, pan, lr: m.gradient_matching(p, pan),
    "gradient_laplacian": lambda m, p, t, pan, lr: m.gradient_matching(p, pan, "laplacian"),
    "highpass_matching": lambda m, p, t, pan, lr: m.highpass_matching(p, pan),
    "ssim_loss": lambda m, p, t, pan, lr: m.ssim_loss(p, t),
}


@pytest.mark.parametrize("name", sorted(LOSSES))
def test_loss_matches_jax(name):
    arrays = _images(3, (2, 16, 16, 4), (2, 16, 16, 4), (2, 16, 16, 1), (2, 4, 4, 4))
    port, ref = _both(arrays)
    _close(LOSSES[name](losses, *port), LOSSES[name](jax_losses, *ref))


def test_composite_loss_matches_jax():
    """CompositeLoss with (pred, target) terms and a keyword term, as
    tests/test_losses.py::test_composite_and_meter, against JAX's."""
    arrays = _images(4, (2, 16, 16, 4), (2, 16, 16, 4), (2, 4, 4, 4))

    def terms(m):
        return [("l1", 1.0, m.l1), ("l2", 0.5, m.l2),
                ("spec", 0.25, lambda pred, lr_ms, **_: m.spectral_consistency(pred, lr_ms))]

    (p, t, lr), (jp, jt, jlr) = _both(arrays)
    total, logs = losses.CompositeLoss(terms(losses))(pred=p, target=t, lr_ms=lr)
    jtotal, jlogs = jax_losses.CompositeLoss(terms(jax_losses))(pred=jp, target=jt, lr_ms=jlr)
    _close(total, jtotal)
    assert set(logs) == set(jlogs) == {"l1", "l2", "spec"}
    for k in logs:
        _close(logs[k], jlogs[k])
    assert losses._wants_kwargs(terms(losses)[2][2]) and not losses._wants_kwargs(losses.l1)


def test_composite_and_meter():
    comp = losses.CompositeLoss([("l1", 1.0, losses.l1), ("l2", 0.5, losses.l2)])
    total, logs = comp(pred=torch.ones(1, 4, 4, 2), target=torch.zeros(1, 4, 4, 2))
    np.testing.assert_allclose(float(total), 1.0 + 0.5)
    assert set(logs) == {"l1", "l2"}
    m = losses.AverageMeter()
    m.update(2.0, 2)
    m.update(4.0)
    np.testing.assert_allclose(m.avg, 8.0 / 3)


def test_loss_library_grads():
    """Every term differentiates to a finite gradient, as in
    tests/test_losses.py, and the gradient matches jax.grad's."""
    arrays = _images(5, (1, 16, 16, 4), (1, 16, 16, 4), (1, 16, 16, 1), (1, 4, 4, 4))
    (p, t, pan, lr), (jp, jt, jpan, jlr) = _both(arrays)

    def total(m, o, pred, target, pan, lr):
        return (m.l1(pred, target) + m.spectral_consistency(pred, lr)
                + m.gradient_matching(pred, pan) + m.gradient_matching(pred, pan, "laplacian")
                + m.highpass_matching(pred, pan) + m.ssim_loss(pred, target)
                + o.sam_loss(pred, target))

    p.requires_grad_()
    total(losses, ops, p, t, pan, lr).backward()
    ref = jax.grad(lambda q: total(jax_losses, jax_ops, q, jt, jpan, jlr))(jp)
    assert torch.isfinite(p.grad).all()
    _close(p.grad, ref)


# --- train/loss_zoo.py: golden loss_zoo.npz and JAX --------------------------


@pytest.fixture(scope="module")
def g():
    return np.load(os.path.join(GOLDEN, "loss_zoo.npz"))


def _hwc(x):
    return np.moveaxis(x, 1, -1)


def _fl(prefix, *parts):
    return [f"{prefix}_{s}" for s in parts or ("w1", "b1", "w2", "b2")]


# golden key -> (function name, argument spec, keyword args, golden rtol): an
# argument is a golden key (NCHW images go channels-last with "hwc:"), or a
# tuple of them (passed as one tuple argument).
QKV, QKV1, QKV2 = ("q", "k", "v"), ("q1", "k1", "v1"), ("q2", "k2", "v2")
IMG = ["hwc:ref", "hwc:pan", "hwc:ms", "hwc:out"]
LAT = lambda *names: [f"lat_{n}" for n in names]
ZOO = {
    "loss_func1": ("loss_func1", IMG, {}, 1e-5),
    "loss_func2": ("loss_func2", IMG, {}, 1e-5),
    "loss_func8": ("loss_func8", IMG[1:], {}, 1e-5),
    "loss_func22": ("loss_func22", ["hwc:ref", "hwc:out"], {}, 1e-5),
    "loss_func6": ("loss_func6", ["hwc:ref", "hwc:out", QKV, QKV1], {}, 1e-5),
    "sam_loss": ("sam_loss", ["hwc:ref", "hwc:out"], {}, 1e-5),
    "floss": ("floss", ["floss_f1", "floss_f2", *_fl("floss")], {"lambd": 0.005}, 1e-4),
    "loss_func4": ("loss_func4", [*IMG, QKV], {}, 1e-5),
    "loss_func5": ("loss_func5", ["hwc:ref", "hwc:out", QKV], {}, 1e-5),
    "loss_func7": ("loss_func7", ["hwc:ref", "hwc:out", QKV, QKV2, QKV1], {}, 1e-5),
    "loss_func10": ("loss_func10", ["hwc:ref", "hwc:out"], {}, 1e-5),
    "loss_func12": ("loss_func12", ["out_l", "out_h", "ms_l", "pan_h"], {}, 1e-5),
    "loss_func13": ("loss_func13", ["out_l", "out_h", "ms_l", "pan_h"], {}, 1e-5),
    "loss_func15": ("loss_func15", ["hwc:ref8", "hwc:out8", "pc2", "mc2", tuple(_fl("f15"))],
                    {}, 1e-4),
    "loss_func16": ("loss_func16", ["hwc:ref8", "hwc:out8", "pc2", "mc2", tuple(_fl("f16"))],
                    {}, 1e-4),
    "loss_func17": ("loss_func17", ["hwc:ref8", "hwc:out8", "pgc2", "mgc2", "pgc1", "mgc1",
                                    tuple(_fl("f17_h2")), tuple(_fl("f17_h1"))], {}, 1e-4),
    "loss_func18": ("loss_func18", ["hwc:ref8", "hwc:out8", "pc2", "mc2", "pgc2", "mgc2",
                                    "pgc1", "mgc1", tuple(_fl("f18_l")), tuple(_fl("f18_h2")),
                                    tuple(_fl("f18_h1"))], {}, 1e-4),
    "floss2": ("floss2", ["pc2", "pgc2", *_fl("floss2")], {"lambd": 0.5}, 1e-4),
    "floss3": ("floss3", ["floss3_f1", "floss3_f2", tuple(_fl("floss3_p1", "wa", "ba", "wb", "bb")),
                          tuple(_fl("floss3_p2", "wa", "ba", "wb", "bb"))], {"lambd": 0.5}, 1e-4),
    "floss4": ("floss4", LAT("la", "lb"), {}, 1e-5),
    "floss5": ("floss5", LAT("la", "lb"), {}, 1e-5),
    "loss_func20": ("loss_func20", ["hwc:ref", "hwc:out", "hwc:ms2", "hwc:o2"], {}, 1e-5),
    "loss_func21": ("loss_func21", ["hwc:ref", "hwc:out", "hwc:ms2", "hwc:o2", "hwc:ms1",
                                    "hwc:o1"], {}, 1e-5),
    "loss_func23": ("loss_func23", ["hwc:ref", "hwc:out", "hwc:ms2", "hwc:o2"], {}, 1e-5),
    "loss_func25": ("loss_func25", ["hwc:ref", "hwc:out", *LAT("la", "lb", "ha", "hb")], {}, 1e-5),
    "loss_func26": ("loss_func26", ["hwc:ref", "hwc:out", *LAT("la", "lb", "ha", "hb")], {}, 1e-5),
    "loss_func27": ("loss_func27", ["hwc:ref", "hwc:out", *LAT("la", "lb", "ha", "hb")], {}, 1e-5),
    "loss_func28": ("loss_func28", ["hwc:ref", "hwc:out", *LAT("la", "lb")], {}, 1e-5),
    "loss_func29": ("loss_func29", ["hwc:ref", "hwc:out", *LAT("la", "lb", "l1a", "l1b")], {},
                    1e-5),
    "loss_func29_h": ("loss_func29_h", ["hwc:ref", "hwc:out", *LAT("ha", "hb", "lha", "lhb")],
                      {}, 1e-5),
    "loss_func29_h_3": ("loss_func29_h_3", ["hwc:ref", "hwc:out",
                                            *LAT("ha", "hb", "lha", "lhb", "llha", "llhb")],
                        {}, 1e-5),
    "loss_func29_lh": ("loss_func29_lh", ["hwc:ref", "hwc:out", *LAT("l1a", "l1b", "la", "lb",
                                                                   "ha", "hb", "lha", "lhb")],
                       {}, 1e-5),
    "loss_func29_c": ("loss_func29_c", ["hwc:ref", "hwc:out", *LAT("la", "lb", "l1a", "l1b")],
                      {}, 1e-5),
    "loss_func29_3layer": ("loss_func29_3layer", ["hwc:ref", "hwc:out",
                                                  *LAT("la", "lb", "l1a", "l1b", "l3a", "l3b")],
                           {}, 1e-5),
    "loss_func29_a": ("loss_func29_a", ["hwc:ref", "hwc:out", *LAT("la", "lb", "l1a", "l1b")],
                      {}, 1e-5),
    "loss_func29_1": ("loss_func29_1", ["hwc:ref", "hwc:out", *LAT("la", "lb", "l1a", "l1b")],
                      {}, 1e-5),
    "loss_func30": ("loss_func30", ["hwc:ref", "hwc:out", *LAT("la", "lb", "l1a", "l1b")], {},
                    1e-5),
    "loss_func31": ("loss_func31", ["hwc:ref", "hwc:out", *LAT("la", "lb", "l1a", "l1b", "ha",
                                                               "hb", "lha", "lhb")], {}, 1e-5),
    "loss_func32": ("loss_func32", ["hwc:ref", "hwc:out", *LAT("ha", "hb", "lha", "lhb")], {},
                    1e-4),
}


def _arg(g, spec, to):
    if isinstance(spec, tuple):
        return tuple(_arg(g, s, to) for s in spec)
    a = _hwc(g[spec[4:]]) if spec.startswith("hwc:") else g[spec]
    return to(np.array(a, np.float32))


@pytest.mark.parametrize("key", sorted(ZOO))
def test_zoo_loss_matches_golden_and_jax(g, key):
    """Each named loss: the port against the torch original's golden value
    at tests/test_loss_zoo.py's rtol, and against the JAX function on the
    same inputs within the module bar."""
    fn, specs, kw, rtol = ZOO[key]
    got = getattr(Z, fn)(*(_arg(g, s, torch.as_tensor) for s in specs), **kw)
    np.testing.assert_allclose(float(got), g[key], rtol=rtol)
    _close(got, getattr(jax_zoo, fn)(*(_arg(g, s, jnp.asarray) for s in specs), **kw))


def test_loss_func3_and_9(g):
    """loss_func3 is loss_func2 upstream; loss_func9 (no runnable torch
    original) against JAX."""
    args = [_arg(g, s, torch.as_tensor) for s in IMG]
    jargs = [_arg(g, s, jnp.asarray) for s in IMG]
    _close(Z.loss_func3(*args), g["loss_func2"])
    val = Z.loss_func9(*args[1:])
    assert torch.isfinite(val) and float(val) > 0
    _close(val, jax_zoo.loss_func9(*jargs[1:]))


def test_dwt_mwcnn_golden(g):
    bands = Z.dwt_mwcnn(torch.as_tensor(_hwc(g["ref"]).copy()))
    for ours, name in zip(bands, ("dwt_ll", "dwt_lh", "dwt_hl", "dwt_hh")):
        np.testing.assert_allclose(ours.numpy(), np.moveaxis(g[name], 1, -1), atol=1e-5)


def test_zoo_helpers_match_jax(g):
    """The triplet helpers, the Gram matrix and the cv2 blur against JAX."""
    q, k, v = (_arg(g, s, torch.as_tensor) for s in QKV)
    jq, jk, jv = (_arg(g, s, jnp.asarray) for s in QKV)
    _close(Z.scaled_dot_product(q, k), jax_zoo.scaled_dot_product(jq, jk))
    _close(Z.similarity_triplet_loss(q, k, v, margin=3.0),
           jax_zoo.similarity_triplet_loss(jq, jk, jv, margin=3.0))
    out, jout = _arg(g, "hwc:out", torch.as_tensor), _arg(g, "hwc:out", jnp.asarray)
    _close(Z.gram_matrix(out), jax_zoo.gram_matrix(jout))
    _close(Z.gaussian_blur_cv(out), jax_zoo.gaussian_blur_cv(jout))
    _close(Z.l3_loss(out, out * 0.5), jax_zoo.l3_loss(jout, jout * 0.5))


def test_zoo_registry():
    """The same registry as the JAX package's."""
    assert set(Z.LOSS_ZOO) == set(jax_zoo.LOSS_ZOO)
    for name, fn in Z.LOSS_ZOO.items():
        assert fn.__name__ == jax_zoo.LOSS_ZOO[name].__name__
