"""The conv API's pre-activation on the CPU: `conv3d` and `conv3d_cat` of
ops/modconv.py (and K1's wrapper) given a shift (B, Cin) and act="silu"
compute conv(silu(x + shift) * s, W) + bias with the SAME padding applied
after the activation. On the CPU every route takes the pre-activation as
the PyTorch ops the blocks used before (`preact`), so each case holds the
call against that explicit route bit for bit, in fp32 and bf16, and counts
it in `preact_unfused`: K1's route, the "auto" lowering, the 1x1x1
product, a library conv, concat parts with their shift slices, style and
shift together, and the outputs and every gradient under autograd. The
padding is held against an independent float64 reference that pads the
activated tensor, with a shift large enough that padding before the
activation would be far off at every border. The bf16 kernel's fused pass
is held against the same ops on the card (tests/test_torch_cuda.py)."""
import pytest
import torch
import torch.nn.functional as F

from tmdiff_tpu_torch.models import blocks
from tmdiff_tpu_torch.models.wavbest import WavBEST
from tmdiff_tpu_torch.ops import modconv
from tmdiff_tpu_torch.ops.cuda import conv3d as K

torch.set_num_threads(2)

DTYPES = [torch.float32, torch.bfloat16]
IDS = ["fp32", "bf16"]


def _case(dtype, shape=(2, 3, 6, 5, 8), cout=6, kernel=(3, 3, 3), seed=0, shift_scale=1.0):
    b, *_, cin = shape
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(shape, generator=g).to(dtype)
    k = torch.randn(*kernel, cin, cout, generator=g) / (27 * cin) ** 0.5
    s = (1 + 0.5 * torch.randn(b, cin, generator=g)).to(dtype)
    shift = (shift_scale * torch.randn(b, cin, generator=g)).to(dtype)
    bias = torch.randn(cout, generator=g)
    return x, k, s, shift, bias


def _explicit(x, shift):
    """The blocks' ops before the pre-activation was an argument."""
    return F.silu(x + shift[:, None, None, None, :])


def _same(a, b):
    assert a.dtype == b.dtype and torch.equal(a, b), (a - b).abs().max().item()


@pytest.mark.parametrize("dtype", DTYPES, ids=IDS)
@pytest.mark.parametrize("impl", ["banded", "auto"])
def test_conv3d_preact_equals_the_explicit_route(dtype, impl):
    """conv3d with shift and act, with and without a style and a bias,
    equals conv3d on silu(x + shift) bit for bit; each call counts one
    unfused pre-activation and no fused one."""
    x, k, s, shift, bias = _case(dtype)
    for style, b in ((None, None), (s, None), (s, bias), (None, bias)):
        K.reset_launches()
        got = modconv.conv3d(x, k, style=style, bias=b, impl=impl, shift=shift, act="silu")
        assert (K.preact_unfused, K.preact_fused) == (1, 0)
        _same(got, modconv.conv3d(_explicit(x, shift), k, style=style, bias=b, impl=impl))


@pytest.mark.parametrize("dtype", DTYPES, ids=IDS)
def test_conv3d_act_or_shift_alone(dtype):
    """A SiLU without a shift equals the conv of F.silu(x); a shift without
    the SiLU is refused, by the conv API and by K1's entry."""
    x, k, s, shift, bias = _case(dtype, seed=1)
    K.reset_launches()
    _same(modconv.conv3d(x, k, style=s, act="silu"), modconv.conv3d(F.silu(x), k, style=s))
    assert K.preact_unfused == 1
    with pytest.raises(ValueError, match="only before act='silu'"):
        modconv.conv3d(x, k, bias=bias, shift=shift)
    with pytest.raises(ValueError, match="only before act='silu'"):
        K.banded_conv3d(x, k.to(dtype), shift=shift)


@pytest.mark.parametrize("dtype", DTYPES, ids=IDS)
def test_preact_pads_after_the_activation(dtype):
    """With a large positive shift silu(0 + shift) is far from 0: the
    output at every border (D, H and W, low and high) matches a float64
    conv of the activated tensor padded with zeros, and not one of the
    tensor padded before the activation."""
    x, k, s, shift, bias = _case(dtype, seed=2, shift_scale=0.0)
    shift = (4.0 + torch.rand(shift.shape, generator=torch.Generator().manual_seed(3))).to(dtype)
    got = modconv.conv3d(x, k, style=s, bias=bias, shift=shift, act="silu").double()

    def reference(pad_first: bool):
        a = _explicit(x, shift).double() * s.double()[:, None, None, None, :]
        if pad_first:  # the wrong order: silu(0 + shift) * s in the padding
            xp = F.pad(x.double(), (0, 0, 1, 1, 1, 1, 1, 1))
            a = _explicit(xp, shift.double()) * s.double()[:, None, None, None, :]
            pad = 0
        else:
            pad = 1
        y = F.conv3d(a.permute(0, 4, 1, 2, 3), k.to(dtype).double().permute(4, 3, 0, 1, 2),
                     padding=pad)
        return y.permute(0, 2, 3, 4, 1) + bias.to(dtype).double()

    right, wrong = reference(False), reference(True)
    scale = right.abs().max().item()
    bar = (2e-2 if dtype == torch.bfloat16 else 1e-5) * scale
    assert (got - right).abs().max().item() <= bar
    for axis in (1, 2, 3):
        for index in (0, -1):
            border = lambda t: t.select(axis, index)
            assert (border(got) - border(right)).abs().max().item() <= bar
            assert (border(got) - border(wrong)).abs().max().item() > 0.2 * scale


@pytest.mark.parametrize("dtype", DTYPES, ids=IDS)
def test_preact_on_a_cropped_view(dtype):
    """A view cropped in H and W (the legacy decoder's crop_to) with a
    pre-activation equals the same call on a contiguous copy bit for bit."""
    x, k, s, shift, bias = _case(dtype, shape=(2, 3, 8, 7, 8), seed=11)
    view = x[:, :, :6, :5]
    assert not view.is_contiguous()
    _same(modconv.conv3d(view, k, style=s, bias=bias, shift=shift, act="silu"),
          modconv.conv3d(view.contiguous(), k, style=s, bias=bias, shift=shift, act="silu"))


@pytest.mark.parametrize("dtype", DTYPES, ids=IDS)
def test_conv3d_cat_takes_each_part_shift_slice(dtype):
    """Concat parts of 8, 16 and 8 channels: each part takes its slice of
    the shift; the sum equals conv3d_cat of the explicit parts bit for bit,
    one unfused pre-activation a part."""
    g = torch.Generator().manual_seed(4)
    parts = tuple(torch.randn(2, 3, 6, 5, c, generator=g).to(dtype) for c in (8, 16, 8))
    k = torch.randn(3, 3, 3, 32, 6, generator=g) / (27 * 32) ** 0.5
    shift = torch.randn(2, 32, generator=g).to(dtype)
    bias = torch.randn(6, generator=g)
    K.reset_launches()
    got = modconv.conv3d_cat(parts, k, bias=bias, shift=shift, act="silu")
    assert K.preact_unfused == 3
    off, explicit = 0, []
    for p in parts:
        explicit.append(_explicit(p, shift[:, off:off + p.shape[-1]]))
        off += p.shape[-1]
    _same(got, modconv.conv3d_cat(tuple(explicit), k, bias=bias))


@pytest.mark.parametrize("dtype", DTYPES, ids=IDS)
@pytest.mark.parametrize("kernel,padding", [((1, 1, 1), "SAME"), ((3, 3, 3), "VALID"),
                                            ((5, 5, 5), "SAME")], ids=["1x1x1", "valid", "5x5x5"])
def test_other_routes_take_the_explicit_ops(dtype, kernel, padding):
    """The 1x1x1 product and the library route compute the pre-activation
    first, as the blocks did."""
    x, k, s, shift, bias = _case(dtype, kernel=kernel, seed=5)
    K.reset_launches()
    got = modconv.conv3d(x, k, style=s, bias=bias, padding=padding, shift=shift, act="silu")
    assert K.preact_unfused == 1
    _same(got, modconv.conv3d(_explicit(x, shift), k, style=s, bias=bias, padding=padding))


@pytest.mark.parametrize("dtype", DTYPES, ids=IDS)
@pytest.mark.parametrize("entry", ["banded_conv3d", "banded_conv3d_v2"])
def test_kernel_wrapper_preact_on_the_cpu(dtype, entry):
    """K1's entries take shift and act: on the CPU the plain version of the
    explicit ops (K1's own, the kernel's operands in bf16)."""
    x, k, s, shift, bias = _case(dtype, seed=6)
    k = k.to(dtype)
    K.reset_launches()
    got = getattr(K, entry)(x, k, s, bias.to(dtype), shift=shift, act="silu")
    assert (K.preact_unfused, K.preact_fused, K.launches) == (1, 0, 0)
    _same(got, K.conv3d_plain(_explicit(x, shift), k, s, bias.to(dtype)))


@pytest.mark.parametrize("dtype", DTYPES, ids=IDS)
def test_preact_gradients_equal_the_explicit_route(dtype):
    """Under autograd the output and the gradients of x, the kernel, the
    style, the shift and the bias equal the explicit route's bit for bit,
    for one conv and for concat parts."""
    x, k, s, shift, bias = _case(dtype, seed=7)
    g = torch.Generator().manual_seed(8)
    parts = tuple(torch.randn(2, 3, 6, 5, c, generator=g).to(dtype) for c in (8, 8))
    kc = torch.randn(3, 3, 3, 16, 6, generator=g) / (27 * 16) ** 0.5
    shift_c = torch.randn(2, 16, generator=g).to(dtype)
    dy = torch.randn(2, 3, 6, 5, 6, generator=g).to(dtype)

    def run(fused: bool):
        leaves = [t.clone().requires_grad_() for t in (x, k, s, shift, bias, *parts, kc, shift_c)]
        xx, kk, ss, sh, bb, p0, p1, kcc, shc = leaves
        if fused:
            y = modconv.conv3d(xx, kk, style=ss, bias=bb, shift=sh, act="silu")
            yc = modconv.conv3d_cat((p0, p1), kcc, bias=bb, shift=shc, act="silu")
        else:
            y = modconv.conv3d(_explicit(xx, sh), kk, style=ss, bias=bb)
            yc = modconv.conv3d_cat((_explicit(p0, shc[:, :8]), _explicit(p1, shc[:, 8:])), kcc,
                                    bias=bb)
        ((y.float() * dy.float()).sum() + (yc.float() * dy.float()).sum()).backward()
        return [y.detach(), yc.detach()] + [t.grad for t in leaves]

    K.reset_launches()
    got = run(True)
    assert K.preact_unfused == 3
    for a, b in zip(got, run(False)):
        _same(a, b)


def test_unknown_activation_raises():
    x, k, s, shift, bias = _case(torch.float32)
    with pytest.raises(ValueError, match="unknown activation"):
        modconv.conv3d(x, k, act="gelu")
    with pytest.raises(ValueError, match="unknown activation"):
        K.banded_conv3d(x, k, act="relu")


@pytest.mark.parametrize("dtype", DTYPES, ids=IDS)
def test_model_pre_activations_are_counted(dtype):
    """A WavBEST forward hands 56 pre-activations to its convs (13 in
    encode_condition, 43 in denoise), each taken unfused on the CPU; with
    dropout (train=True) the blocks compute those that dropout follows and
    hand on only the 11 it does not: the two heads' and the nine wavelet
    blocks' Conv_0."""
    model = WavBEST((8, 8, 16, 16), device="cpu", seed=0, dtype=dtype)
    g = torch.Generator().manual_seed(9)
    args = (torch.randn(2, 4, 16, 16, generator=g), torch.tensor([3.0, 600.0]),
            torch.rand(2, 1, 16, 16, generator=g), torch.rand(2, 4, 16, 16, generator=g),
            torch.randn(768, generator=g))
    with torch.no_grad():
        K.reset_launches()
        cache = model.encode_condition(*args[2:])
        assert K.preact_unfused == 13
        model.denoise(args[0], args[1], cache)
        assert K.preact_unfused == 13 + 43
        K.reset_launches()
        model(*args, train=True, rng=torch.Generator().manual_seed(1))
        assert (K.preact_unfused, K.preact_fused) == (11, 0)


@pytest.mark.parametrize("dtype", DTYPES, ids=IDS)
def test_act_conv_with_dropout_off_equals_without_rng(dtype, monkeypatch):
    """A block with dropout at rate 0 (the explicit ops, rng given) equals
    the block handing its pre-activation to the convs (rng None)."""
    monkeypatch.setattr(blocks, "DROPOUT", 0.0)
    block = blocks.ResBlockModulate(16, 8, 12, dtype=dtype)
    g = torch.Generator().manual_seed(10)
    parts = tuple(torch.randn(2, 3, 6, 5, 8, generator=g).to(dtype) for _ in range(2))
    temb = torch.randn(2, 12, generator=g).to(dtype)
    zemb = torch.randn(2, 12, generator=g).to(dtype)
    with torch.no_grad():
        _same(block(parts, temb, zemb), block(parts, temb, zemb, torch.Generator()))
