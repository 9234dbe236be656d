"""The port's CUDA kernel on the card: the 3x3x3 conv kernel (K1 and K2
entries) against its plain version at edge shapes, the wrapper's refusals,
and the model's kernel path against its plain path. Marked `cuda`; each test
skips where no GPU is present. This file imports neither jax nor the JAX
package, so it runs where only the port is installed:

    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""
import pytest
import torch

pytestmark = pytest.mark.cuda

torch.set_num_threads(2)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("shape", [
    (2, 8, 16, 16, 4, 32), (1, 3, 5, 7, 3, 5), (2, 4, 2, 2, 64, 256), (2, 8, 33, 40, 96, 32),
    (1, 8, 6, 6, 1, 64), (2, 4, 32, 32, 256, 128), (1, 1, 1, 1, 8, 8),
])
@pytest.mark.parametrize("entry", ["banded_conv3d", "banded_conv3d_v2"])
def test_kernel_matches_plain(cuda, shape, entry):
    """Style, bias and accumulation; to 1e-4 of the output's scale (fp32
    sums of up to 27 * 256 terms in another order)."""
    from tmdiff_tpu_torch.ops.cuda import conv3d as K

    b, d, h, w, cin, cout = shape
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(b, d, h, w, cin, device=cuda, generator=g)
    k = torch.randn(3, 3, 3, cin, cout, device=cuda, generator=g) / (27 * cin) ** 0.5
    s = torch.randn(b, cin, device=cuda, generator=g)
    bias = torch.randn(cout, device=cuda, generator=g)
    out = torch.randn(b, d, h, w, cout, device=cuda, generator=g)
    fn = getattr(K, entry)
    with torch.no_grad():
        for args in ((None, None, None), (s, bias, None), (s, None, out), (None, bias, out)):
            before = K.launches
            st, bi, o = args
            got = fn(x, k, st, bi, None if o is None else o.clone())
            assert K.launches == before + 1
            ref = K.conv3d_plain(x, k, st, bi, None if o is None else o.clone())
            torch.cuda.synchronize()
            assert (got - ref).abs().max().item() <= 1e-4 * ref.abs().max().item()


def test_kernel_takes_weight_slices(cuda):
    """A Cin slice (concat part) or a Cout slice (a group) of a kernel goes
    in as a view, without a copy."""
    from tmdiff_tpu_torch.ops.cuda import conv3d as K

    x = torch.randn(2, 4, 8, 8, 16, device=cuda)
    k = torch.randn(3, 3, 3, 48, 24, device=cuda)
    with torch.no_grad():
        for kk in (k[..., 16:32, :], k[..., :16, 8:16]):
            ref = K.conv3d_plain(x, kk)
            got = K.banded_conv3d(x, kk)
            assert (got - ref).abs().max().item() <= 1e-4 * ref.abs().max().item()


def test_wrapper_refuses(cuda):
    from tmdiff_tpu_torch.ops.cuda import conv3d as K

    x = torch.randn(1, 4, 8, 8, 4, device=cuda)
    k = torch.randn(3, 3, 3, 4, 8, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        K.banded_conv3d(x.transpose(2, 3), k)
    with pytest.raises(TypeError, match="float32"):
        K.banded_conv3d(x.double(), k.double())
    with pytest.raises(RuntimeError, match="no backward"):
        K.banded_conv3d(x.requires_grad_(), k)
    with pytest.raises(ValueError, match="is on"):
        K.banded_conv3d(x.detach(), k.cpu())


def test_model_kernel_path_matches_plain(cuda):
    """A small WavBEST on the card, every 3x3x3 conv through the kernel,
    against the plain convs; atol 5e-4, the forward parity bar."""
    from tmdiff_tpu_torch.models.wavbest import WavBEST
    from tmdiff_tpu_torch.ops.cuda import conv3d as K

    model = WavBEST((8, 16, 32, 64), seed=0)
    assert model.device.type == "cuda"
    g = torch.Generator(device=cuda).manual_seed(1)
    x = torch.randn(2, 8, 32, 32, device=cuda, generator=g)
    pan = torch.rand(2, 1, 32, 32, device=cuda, generator=g)
    ms = torch.rand(2, 8, 32, 32, device=cuda, generator=g)
    prompt = torch.randn(2, 768, device=cuda, generator=g)
    t = torch.tensor([3.0, 600.0], device=cuda)
    with torch.no_grad():
        K.reset_launches()
        y = model(x, t, pan, ms, prompt)
        assert K.launches == 13 + 52
        ref = model.use_plain_conv(True)(x, t, pan, ms, prompt)
    assert (y - ref).abs().max().item() <= 5e-4
