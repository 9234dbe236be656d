"""The port's CUDA kernels on the card: the 3x3x3 conv kernel (K1 and K2
entries), the 3x3 NHWC conv (K3) and flash attention (K4) against their plain
versions at edge shapes, the wrappers' refusals, and the model's kernel
paths ("banded" and "auto") and a SpatialTransformer against their plain
paths. Marked `cuda`; each test
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


@pytest.mark.parametrize("shape", [
    (2, 16, 16, 128, 128), (1, 13, 7, 24, 64), (2, 9, 40, 96, 32), (1, 1, 2, 5, 3),
    (2, 32, 32, 256, 256), (1, 8, 33, 512, 512),
])
def test_conv3x3_nhwc_matches_plain(cuda, shape):
    """K3 with and without style and bias, at H % 8 != 0, odd widths and a
    window that overhangs the image; to 1e-4 of the output's scale."""
    from tmdiff_tpu_torch.ops.cuda import conv2d as K3

    b, h, w, cin, cout = shape
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(b, h, w, cin, device=cuda, generator=g)
    k = torch.randn(3, 3, cin, cout, device=cuda, generator=g) / (9 * cin) ** 0.5
    s = torch.randn(b, cin, device=cuda, generator=g)
    bias = torch.randn(cout, device=cuda, generator=g)
    with torch.no_grad():
        for st, bi in ((None, None), (s, bias), (s, None)):
            before = K3.launches
            got = K3.conv3x3_nhwc(x, k, st, bi)
            assert K3.launches == before + 1
            ref = K3.conv3x3_nhwc_plain(x, k, st, bi)
            torch.cuda.synchronize()
            assert (got - ref).abs().max().item() <= 1e-4 * ref.abs().max().item()


def test_conv3x3_wrapper_refuses(cuda):
    from tmdiff_tpu_torch.ops.cuda import conv2d as K3

    x = torch.randn(1, 8, 8, 4, device=cuda)
    k = torch.randn(3, 3, 4, 8, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        K3.conv3x3_nhwc(x.transpose(1, 2), k)
    with pytest.raises(RuntimeError, match="no backward"):
        K3.conv3x3_nhwc(x.requires_grad_(), k)
    with pytest.raises(ValueError, match="is on"):
        K3.conv3x3_nhwc(x.detach(), k.cpu())


@pytest.mark.parametrize("q_shape,kv_len", [
    ((2, 8, 4096, 64), 4096), ((2, 8, 4096, 64), 1), ((2, 1, 1024, 256), 1024),
    ((1, 2, 48, 32), 130), ((1, 2, 100, 40), 100), ((3, 1, 1, 8), 77), ((1, 1, 70, 200), 33),
    ((1, 3, 129, 128), 65),
])
def test_flash_attention_matches_reference(cuda, q_shape, kv_len):
    """K4 against attention_reference at unit-normal inputs: masked key
    tails, a single key, ragged query tiles, D from 8 to 256; atol 2e-5."""
    from tmdiff_tpu_torch.ops.cuda import flash_attention as K4

    b, h, sq, d = q_shape
    g = torch.Generator(device=cuda).manual_seed(0)
    q = torch.randn(q_shape, device=cuda, generator=g)
    k = torch.randn(b, h, kv_len, d, device=cuda, generator=g)
    v = torch.randn(b, h, kv_len, d, device=cuda, generator=g)
    with torch.no_grad():
        before = K4.launches
        got = K4.flash_attention(q, k, v)
        assert K4.launches == before + 1
        ref = K4.attention_reference(q, k, v)
        torch.cuda.synchronize()
    assert (got - ref).abs().max().item() <= 2e-5


def test_flash_attention_wrapper_refuses(cuda):
    from tmdiff_tpu_torch.ops.cuda import flash_attention as K4

    q = torch.randn(1, 2, 8, 16, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        K4.flash_attention(q.transpose(2, 3), q, q)
    with pytest.raises(ValueError, match="head dim"):
        K4.flash_attention(*(torch.randn(1, 1, 4, 300, device=cuda),) * 3)
    with pytest.raises(RuntimeError, match="no backward"):
        K4.flash_attention(q.clone().requires_grad_(), q, q)


def test_model_auto_path_matches_banded(cuda):
    """The "auto" lowering on the card (K3 where the bands fold into lanes,
    K1 elsewhere) against the "banded" one; atol 5e-4, the forward bar."""
    from tmdiff_tpu_torch.models.wavbest import WavBEST
    from tmdiff_tpu_torch.ops.cuda import conv2d as K3
    from tmdiff_tpu_torch.ops.cuda import conv3d as K

    model = WavBEST((8, 16, 32, 64), seed=0)
    g = torch.Generator(device=cuda).manual_seed(1)
    x = torch.randn(2, 4, 32, 32, device=cuda, generator=g)
    pan = torch.rand(2, 1, 32, 32, device=cuda, generator=g)
    ms = torch.rand(2, 4, 32, 32, device=cuda, generator=g)
    prompt = torch.randn(768, device=cuda, generator=g)
    t = torch.tensor([3.0, 600.0], device=cuda)
    with torch.no_grad():
        ref = model(x, t, pan, ms, prompt)
        K.reset_launches()
        K3.reset_launches()
        y = model.use_conv_impl("auto")(x, t, pan, ms, prompt)
        model.use_conv_impl("banded")
    assert K3.launches > 0 and K.launches + K3.launches == 13 + 52
    assert (y - ref).abs().max().item() <= 5e-4


def test_spatial_transformer_kernel_matches_plain(cuda):
    """A SpatialTransformer through K4 against the same module on the plain
    attention; atol 1e-4 (two fp32 attentions and a feed-forward)."""
    from tmdiff_tpu_torch.ops import attention
    from tmdiff_tpu_torch.ops.cuda import flash_attention as K4

    torch.manual_seed(0)
    m = attention.SpatialTransformer(64, 4, 32, depth=1, context_dim=96).to(cuda).eval()
    torch.nn.init.normal_(m.proj_out.weight, std=0.05)
    x = torch.randn(2, 16, 16, 64, device=cuda)
    ctx = torch.randn(2, 3, 96, device=cuda)
    with torch.no_grad():
        K4.reset_launches()
        y = m(x, ctx)
        assert K4.launches == 2
        for mod in m.modules():
            if hasattr(mod, "use_flash"):
                mod.use_flash = False
        ref = m(x, ctx)
    assert (y - ref).abs().max().item() <= 1e-4
