"""The JAX conv API of ops/modconv.py in full on the CPU: the port's
`conv3d`, `conv3d_cat`, `modulated_conv3d` and `modulated_conv_transpose3d`
with JAX's `padding` and `stride` keywords against the JAX package's
functions (tmdiff_tpu/ops/modconv.py) on numpy inputs from a seed, at the
kernels (1, 3, 3), (3, 3, 3), (5, 5, 5) and (1, 1, 1), the strides
(1, 1, 1), (1, 2, 2) and (2, 2, 2), and the paddings "SAME", "VALID" and
explicit (lo, hi) pairs. SAME stride-1 3x3x3 and 1x1x1 convs take the
port's kernel routes (K1's plain version, the matrix product); every other
one goes to ops/library_conv.py.

Bars: fp32 within 1e-5 of the output's scale (fp32 sums in another order);
bf16 within one bf16 step (half a step of each side's rounding) plus 1e-4
of scale, the ROUNDING BAR of tests/test_torch_bf16.py with its fp32-order
term at 1e-4; the gradients of the library routes against jax.vjp in fp32
within 1e-4 of each gradient's scale.

On a space split: the library routes of the four entries at the kernels
(1, 3, 3), (3, 5, 5), (1, 5, 5), the strides (1, 1, 1), (1, 2, 2) and the
paddings SAME and explicit, fp32 and bf16, on a (1, 2) and a (2, 2) gloo
world (parallel/dryrun.py, tests/torch_mesh_workers.py::library_convs, both
worlds started together), the output and every gradient against one
process: fp32 within 1e-5 of each tensor's scale, bf16 within one bf16 step
at its scale (SPLIT_BARS). A shape whose split does not hold raises, naming
it."""
import itertools
import os
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_bf16 import half_step
from tmdiff_tpu.ops import modconv as jax_modconv
from tmdiff_tpu_torch.ops import library_conv, modconv
from tmdiff_tpu_torch.parallel.dryrun import run_world
from tmdiff_tpu_torch.parallel.mesh import Mesh
import torch_mesh_workers as workers

torch.set_num_threads(2)

KERNELS = [(1, 3, 3), (3, 3, 3), (5, 5, 5), (1, 1, 1)]
STRIDES = [(1, 1, 1), (1, 2, 2), (2, 2, 2)]
PADDINGS = ["SAME", "VALID", ((1, 0), (2, 1), (0, 2))]
GRID = list(itertools.product(KERNELS, STRIDES, range(len(PADDINGS))))
X_SHAPE = (2, 5, 9, 8, 8)  # odd sizes: SAME pads an odd pixel after
COUT = 6
FP32_RTOL = 1e-5
BF16_RTOL = 1e-4
GRAD_RTOL = 1e-4


def _inputs(kernel, seed=0, x_shape=X_SHAPE, cout=COUT):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(x_shape).astype(np.float32)
    k = (rng.standard_normal(kernel + (x_shape[-1], cout))
         / np.sqrt(np.prod(kernel) * x_shape[-1])).astype(np.float32)
    s = rng.uniform(0.5, 1.5, (x_shape[0], x_shape[-1])).astype(np.float32)
    return x, k, s


def _f64(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32), np.float64)


def _to(a, dtype):
    t = torch.as_tensor(np.asarray(a, np.float32))
    return t.bfloat16() if dtype == "bfloat16" else t


def _jx(a, dtype):
    return jnp.asarray(a).astype(jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)


def _assert_close(got, ref, dtype, rounded=()):
    """The dtype's bar; `rounded`: further bf16 roundings either side made
    (their results), each adding half a step."""
    got = got.float().numpy().astype(np.float64) if torch.is_tensor(got) else got
    ref = _f64(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    scale = np.abs(ref).max()
    if dtype == "float32":
        assert np.abs(got - ref).max() <= FP32_RTOL * scale, np.abs(got - ref).max() / scale
        return
    bar = half_step(got) + half_step(ref) + BF16_RTOL * scale
    bar = bar + sum(half_step(_f64(r)) for r in rounded)
    over = np.abs(got - ref) > bar
    assert not over.any(), f"{over.sum()} elements beyond one bf16 step"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kernel,stride,pad", GRID)
def test_conv3d_and_modulated_match_jax(kernel, stride, pad, dtype):
    """conv3d (no bias, as JAX's) and modulated_conv3d at every kernel,
    stride and padding against the JAX functions in the same dtype."""
    padding = PADDINGS[pad]
    x, k, s = _inputs(kernel)
    got = modconv.conv3d(_to(x, dtype), torch.as_tensor(k), padding=padding, stride=stride)
    ref = jax_modconv.conv3d(_jx(x, dtype), jnp.asarray(k), padding=padding, stride=stride)
    assert got.dtype == getattr(torch, dtype)
    _assert_close(got, ref, dtype)
    got = modconv.modulated_conv3d(_to(x, dtype), torch.as_tensor(k), _to(s, dtype),
                                   padding=padding, stride=stride)
    ref = jax_modconv.modulated_conv3d(_jx(x, dtype), jnp.asarray(k), _jx(s, dtype),
                                       padding=padding, stride=stride)
    _assert_close(got, ref, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kernel,stride,pad", [
    ((3, 3, 3), (1, 1, 1), 0), ((3, 3, 3), (1, 2, 2), 1), ((5, 5, 5), (2, 2, 2), 0),
    ((1, 3, 3), (1, 1, 1), 2), ((1, 1, 1), (2, 2, 2), 0),
])
def test_conv3d_cat_matches_jax(kernel, stride, pad, dtype):
    """conv3d_cat of two parts (8 + 4 channels) against JAX's: a library
    route sums the parts' convs, each rounded in bf16, as JAX does; K1's
    served forward adds the parts before its one rounding, so there JAX's
    two part roundings join the bar."""
    padding = PADDINGS[pad]
    rng = np.random.default_rng(1)
    a = rng.standard_normal(X_SHAPE).astype(np.float32)
    b = rng.standard_normal(X_SHAPE[:-1] + (4,)).astype(np.float32)
    k = (rng.standard_normal(kernel + (12, COUT)) / np.sqrt(12 * np.prod(kernel))).astype(
        np.float32)
    got = modconv.conv3d_cat((_to(a, dtype), _to(b, dtype)), torch.as_tensor(k),
                             padding=padding, stride=stride)
    ref = jax_modconv.conv3d_cat((_jx(a, dtype), _jx(b, dtype)), jnp.asarray(k),
                                 padding=padding, stride=stride)
    parts = ()
    if kernel == (3, 3, 3) and stride == (1, 1, 1) and padding == "SAME":
        parts = [jax_modconv.conv3d(_jx(p, dtype), jnp.asarray(kp), padding=padding)
                 for p, kp in ((a, k[..., :8, :]), (b, k[..., 8:, :]))]
    _assert_close(got, ref, dtype, parts)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kernel,stride,pad", GRID)
def test_modulated_conv_transpose3d_matches_jax(kernel, stride, pad, dtype):
    """modulated_conv_transpose3d against JAX's (lax.conv_transpose,
    transpose_kernel=False) at every kernel, stride and padding."""
    padding = PADDINGS[pad]
    x, k, s = _inputs(kernel, seed=2, x_shape=(2, 5, 6, 5, 8))
    got = modconv.modulated_conv_transpose3d(_to(x, dtype), torch.as_tensor(k), _to(s, dtype),
                                             stride=stride, padding=padding)
    ref = jax_modconv.modulated_conv_transpose3d(_jx(x, dtype), jnp.asarray(k), _jx(s, dtype),
                                                 stride=stride, padding=padding)
    assert got.dtype == getattr(torch, dtype)
    _assert_close(got, ref, dtype)


def test_library_route_bias_and_out():
    """A library conv's bias is added after the conv in x's dtype, and `out`
    takes the sum: against JAX's conv plus the bias (two roundings each
    side in bf16)."""
    x, k, _ = _inputs((5, 5, 5), seed=3)
    bias = np.random.default_rng(4).standard_normal(COUT).astype(np.float32)
    for dtype in ("float32", "bfloat16"):
        y = modconv.conv3d(_to(x, dtype), torch.as_tensor(k), bias=torch.as_tensor(bias),
                           padding="VALID", stride=(1, 2, 2))
        conv = jax_modconv.conv3d(_jx(x, dtype), jnp.asarray(k), padding="VALID",
                                  stride=(1, 2, 2))
        ref = conv + jnp.asarray(bias).astype(conv.dtype)
        _assert_close(y, ref, dtype)
        acc = torch.ones_like(y)
        got = modconv.conv3d(_to(x, dtype), torch.as_tensor(k), bias=torch.as_tensor(bias),
                             out=acc, padding="VALID", stride=(1, 2, 2))
        assert got is acc
        _assert_close(got, ref + jnp.ones_like(ref), dtype)


def _vjp_case(fn_port, fn_jax, arrays, seed):
    """The port's gradients of sum(y * dy) against jax.vjp's, each within
    GRAD_RTOL of its scale; the outputs too."""
    ts = [torch.as_tensor(a).requires_grad_() for a in arrays]
    y = fn_port(*ts)
    dy = np.random.default_rng(seed).standard_normal(tuple(y.shape)).astype(np.float32)
    (y * torch.as_tensor(dy)).sum().backward()
    ref, vjp = jax.vjp(fn_jax, *(jnp.asarray(a) for a in arrays))
    _assert_close(y.detach(), ref, "float32")
    for t, g in zip(ts, vjp(jnp.asarray(dy))):
        g = np.asarray(g, np.float64)
        assert np.abs(t.grad.numpy() - g).max() <= GRAD_RTOL * np.abs(g).max()


@pytest.mark.parametrize("kernel,stride,pad", [
    ((5, 5, 5), (1, 1, 1), 0), ((3, 3, 3), (1, 2, 2), 1), ((1, 3, 3), (2, 2, 2), 2),
    ((3, 3, 3), (2, 2, 2), 0),
])
def test_library_routes_gradients_match_jax_vjp(kernel, stride, pad):
    """modulated_conv3d and modulated_conv_transpose3d through the library
    routes: the gradients of x, the kernel and the style against jax.vjp in
    fp32."""
    padding = PADDINGS[pad]
    x, k, s = _inputs(kernel, seed=5)
    kw = dict(padding=padding, stride=stride)
    _vjp_case(lambda a, b, c: modconv.modulated_conv3d(a, b, c, **kw),
              lambda a, b, c: jax_modconv.modulated_conv3d(a, b, c, **kw), (x, k, s), 6)
    x, k, s = _inputs(kernel, seed=7, x_shape=(2, 5, 6, 5, 8))
    _vjp_case(lambda a, b, c: modconv.modulated_conv_transpose3d(a, b, c, **kw),
              lambda a, b, c: jax_modconv.modulated_conv_transpose3d(a, b, c, **kw),
              (x, k, s), 8)


def test_conv_nd_int_stride_unchanged():
    """conv_nd's int stride (its existing callers) is the per-axis stride
    repeated, bit for bit."""
    x, k, _ = _inputs((3, 3, 3), seed=9)
    x2, k2 = torch.as_tensor(x[:, 0]), torch.as_tensor(k[0])
    assert torch.equal(library_conv.conv_nd(x2, k2, 2), library_conv.conv_nd(x2, k2, (2, 2)))


def _space_split():
    """A placement that splits the height over two space ranks (no process
    group is needed to refuse)."""
    return Mesh(data=1, space=2, rank=0, backend="gloo", device=torch.device("cpu"),
                space_group=None, data_group=None, world_group=None)


def test_space_split_placement_refuses_library_routes():
    """On a space-split placement a library route whose split does not hold
    raises a ValueError naming the kernel, padding, stride and shape and the
    reason: an output height that is not the height over the stride, a
    stride that does not divide the shard's rows, a window that reaches
    past the next rank."""
    mesh = _space_split()
    assert mesh.halo
    x, k, s = (torch.as_tensor(a) for a in _inputs((5, 5, 5)))
    with pytest.raises(ValueError, match=r"\(5, 5, 5\) conv .* of x \(2, 5, 9, 8, 8\) .*"
                                         r"output height 14 is not the height 18"):
        modconv.conv3d(x, k, mesh=mesh, padding="VALID")
    k3 = torch.as_tensor(_inputs((3, 3, 3))[1])
    with pytest.raises(ValueError, match="stride \\(1, 2, 2\\).*does not divide the shard's 9"):
        modconv.modulated_conv3d(x, k3, s, mesh=mesh, stride=(1, 2, 2))
    with pytest.raises(ValueError, match="'VALID'"):
        modconv.conv3d_cat((x, x), torch.cat([k3, k3], 3), mesh=mesh, padding="VALID")
    with pytest.raises(ValueError, match="transposed conv with padding 'VALID'.*output height"):
        modconv.modulated_conv_transpose3d(x, k3, s, mesh=mesh, stride=(1, 2, 2),
                                           padding="VALID")
    tall = torch.as_tensor(_inputs((1, 21, 1))[1])
    with pytest.raises(ValueError, match="reaches 10 rows past a 9-row shard"):
        modconv.conv3d(x, tall, mesh=mesh)


# -- the library routes split over space shards, against one process ----------

TESTS = os.path.dirname(os.path.abspath(__file__))
SPLIT_CASES = [(entry, kernel, stride, pad, dtype)
               for entry in workers.LIBRARY_ENTRIES
               for kernel in ((1, 3, 3), (3, 5, 5), (1, 5, 5))
               for stride in ((1, 1, 1), (1, 2, 2))
               for pad in ("SAME", "explicit")
               for dtype in ("float32", "bfloat16")]
SPLIT_MESHES = ((1, 2), (2, 2))


@pytest.fixture(scope="module")
def split_worlds():
    """A 2-rank world on (1, 2) and a 4-rank one on (2, 2), started together,
    each running every case of SPLIT_CASES."""
    def world(mesh):
        return run_world("torch_mesh_workers:library_convs", mesh[0] * mesh[1],
                         ([mesh], SPLIT_CASES), sys_path=[TESTS], threads=1, timeout=300)

    with ThreadPoolExecutor(2) as pool:
        yield {m: pool.submit(world, m) for m in SPLIT_MESHES}


def _split_bar(dtype, scale):
    """fp32: 1e-5 of the scale; bf16: one bf16 step at the scale."""
    if dtype == "float32":
        return 1e-5 * scale
    return 2.0 ** (np.floor(np.log2(scale)) - 7)


def _case_id(case):
    entry, kernel, stride, pad, dtype = case
    return f"{entry}-{''.join(map(str, kernel))}-s{stride[1]}-{pad}-{dtype}"


@pytest.mark.parametrize("mesh", SPLIT_MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("case", SPLIT_CASES, ids=_case_id)
def test_library_routes_split_over_space_shards(split_worlds, mesh, case):
    """The output and the gradients of x, the kernel, the style and the bias
    gathered over the ranks (each rank's rows; the parameters' sums over
    the ranks) against one process, within the dtype's bar of each tensor's
    scale."""
    data, space = mesh
    i = SPLIT_CASES.index(case)
    ref = workers.library_grads(case, i)
    ranks = [r[0][i] for r in split_worlds[mesh].result()]
    b = workers.LIBRARY_X[0] // data
    got = {"y": np.zeros_like(ref["y"]), "x": [np.zeros_like(g) for g in ref["x"]]}
    for name in ("kernel", "style", "bias"):
        got[name] = None if ref[name] is None else np.zeros_like(ref[name], np.float64)
    for r in ranks:
        rows = lambda a: slice(r["s"] * a.shape[2], (r["s"] + 1) * a.shape[2])
        batch = slice(r["d"] * b, (r["d"] + 1) * b)
        got["y"][batch, :, rows(r["y"])] = r["y"]
        for g, part in zip(got["x"], r["x"]):
            g[batch, :, rows(part)] = part
        for name in ("kernel", "bias"):
            if got[name] is not None:
                got[name] += r[name]
        if got["style"] is not None:
            got["style"][batch] += r["style"]
    pairs = [("y", got["y"], ref["y"])] + [(f"x{j}", g, w) for j, (g, w) in
                                          enumerate(zip(got["x"], ref["x"]))]
    pairs += [(n, got[n], ref[n]) for n in ("kernel", "style", "bias") if ref[n] is not None]
    for name, g, w in pairs:
        scale = np.abs(w).max()
        gap = np.abs(np.asarray(g, np.float64) - w).max()
        assert gap <= _split_bar(case[-1], scale), (name, gap, scale)
