"""The SAME 3x3x3 conv's weight gradient on the CPU: its plain version
(`conv3d_weight_grad_plain`, 27 shifted-slice products) against the
library route (`aten.convolution_backward`, what `conv3d_weight_grad`
computes off the card) and against the JAX package's VJP rule of its banded
conv (`banded_conv3d`'s custom VJP, XLA's conv VJP), with and without the
style; the rule that sends a call to the weight-gradient kernel or to cuDNN;
and the backward's hand-off of the style. The kernel itself runs only on the
card (tests/test_torch_cuda.py)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tmdiff_tpu.ops.pallas import banded_conv3d as pallas_conv
from tmdiff_tpu_torch.ops.cuda import conv3d as K

# fp32 sums over up to 32k positions in three orders: measured at most
# 1.11e-6 of the gradient's largest magnitude
WGRAD_RTOL = 1e-5


def _rel_to_scale(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return np.abs(got - ref).max() / np.abs(ref).max()


def _operands(shape, seed):
    b, d, h, w, cin, cout = shape
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, d, h, w, cin)).astype(np.float32)
    dy = rng.standard_normal((b, d, h, w, cout)).astype(np.float32)
    s = (1.0 + 0.5 * rng.standard_normal((b, cin))).astype(np.float32)
    return x, dy, s


@pytest.mark.parametrize("style", [False, True], ids=["plain", "style"])
@pytest.mark.parametrize("shape", [
    (2, 4, 31, 31, 32, 32), (1, 8, 63, 63, 32, 64), (1, 4, 31, 9, 256, 256),
    (1, 8, 31, 63, 64, 128), (2, 4, 31, 31, 1, 32), (1, 8, 9, 31, 128, 4),
])
def test_weight_grad_plain_matches_library_and_jax(shape, style):
    """D 4 and 8, odd H and W, Cin and Cout from 1 to 256: the plain
    version, the library route and the JAX package's VJP of its banded conv
    (the style applied to x first, as the JAX model does) agree to
    WGRAD_RTOL of the gradient's scale."""
    x, dy, s = _operands(shape, seed=sum(shape) + style)
    xt, dyt = torch.from_numpy(x), torch.from_numpy(dy)
    st = torch.from_numpy(s) if style else None
    plain = K.conv3d_weight_grad_plain(xt, dyt, st)
    assert plain.shape == (3, 3, 3, shape[4], shape[5]) and plain.dtype == torch.float32
    library = K.conv3d_weight_grad(xt, dyt, st)
    assert K.weight_grad_launches == 0
    xs = x * s[:, None, None, None, :] if style else x
    kernel = jnp.zeros((3, 3, 3, shape[4], shape[5]), jnp.float32)
    _, jdk = pallas_conv._bwd(8, None, (jnp.asarray(xs), kernel), jnp.asarray(dy))
    assert _rel_to_scale(plain, library) <= WGRAD_RTOL
    assert _rel_to_scale(plain, jdk) <= WGRAD_RTOL


def test_weight_grad_plain_matches_jax_vjp_of_the_banded_conv():
    """At a shape the TPU kernel takes, the plain weight gradient against
    jax.vjp of the JAX package's banded conv itself (its Pallas forward in
    interpret mode, its custom VJP)."""
    x, dy, _ = _operands((2, 8, 8, 8, 16, 32), seed=7)
    k = jnp.zeros((3, 3, 3, 16, 32), jnp.float32)
    _, vjp = jax.vjp(pallas_conv.banded_conv3d, jnp.asarray(x), k)
    _, jdk = vjp(jnp.asarray(dy))
    plain = K.conv3d_weight_grad_plain(torch.from_numpy(x), torch.from_numpy(dy))
    assert _rel_to_scale(plain, jdk) <= WGRAD_RTOL


@pytest.mark.parametrize("case,want", [
    (("cuda", torch.float32, 32, 32, True), "kernel"),
    (("cuda", torch.float32, 4, 256, True), "kernel"),
    (("cuda", torch.float32, 1, 32, True), "cudnn"),
    (("cuda", torch.float32, 32, 6, True), "cudnn"),
    (("cuda", torch.float32, 32, 32, False), "cudnn"),
    (("cuda", torch.bfloat16, 32, 32, True), "cudnn"),
    (("cpu", torch.float32, 32, 32, True), "cudnn"),
], ids=["fp32", "fp32-cin4", "cin1", "cout6", "unaligned", "bf16", "cpu"])
def test_weight_grad_route(case, want):
    """The kernel takes fp32 on a CUDA device with Cin % 4 == 0,
    Cout % 4 == 0 and x and dy 16-byte aligned; cuDNN every other call."""
    assert K.weight_grad_route(*case) == want


def test_backward_hands_the_style_to_the_weight_gradient(monkeypatch):
    """Conv3dFunction's backward passes x and the style to the weight
    gradient (the kernel applies the style; x * s is not written for it),
    and the gradient equals the plain version's."""
    x, dy, s = _operands((2, 4, 6, 5, 8, 12), seed=5)
    xt, st = torch.from_numpy(x), torch.from_numpy(s)
    k = torch.randn(3, 3, 3, 8, 12, generator=torch.Generator().manual_seed(0)).requires_grad_()
    seen = []
    original = K.conv3d_weight_grad

    def spy(xs, g, style=None):
        seen.append((xs, style))
        return original(xs, g, style)

    monkeypatch.setattr(K, "conv3d_weight_grad", spy)
    K.banded_conv3d(xt, k, st).backward(torch.from_numpy(dy))
    (xs, style), = seen
    assert torch.equal(xs, xt) and torch.equal(style, st)
    plain = K.conv3d_weight_grad_plain(xt, torch.from_numpy(dy), st)
    assert _rel_to_scale(k.grad, plain) <= WGRAD_RTOL
