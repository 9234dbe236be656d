"""The port's CUDA kernels on the card: the 3x3x3 conv kernel (K1 and K2
entries, forward and, through its autograd Function, the input gradient;
the training step around it), the 3x3 NHWC conv (K3) and flash attention
(K4) against their plain versions at edge shapes, the conv kernel's variants (3xTF32 tensor cores,
with split-K, and the fp32 FMA kernel for Cin % 4 != 0) and its
determinism, K4's variants (3xTF32 with split-KV, fp32 FMA for D % 4 != 0,
the bf16 tensor-core kernel and the bf16 FMA instance against
flash_attention_plain within one bf16 step, the bf16 kernel's tile edges,
single launch and deepest sums against float64), plan, determinism and
error at its deepest sums, the wrappers' refusals,
and the model's kernel paths ("banded" and "auto") and a SpatialTransformer
against their plain paths; bf16 training (K1's bf16 instance as its own
input gradient and cuDNN's bf16 weight gradient at the training and legacy
shapes, a concat's parts, a bf16 training step); Trainer.compiled_step on
a (2, 1) NCCL world against train_step (two cards) and its refusal of a
gloo world on card 0; the card-only spans of utils/profiling.py
(compiled_step's capture and replays, K1's plan on a miss); K1 bf16's fused
pre-activation (silu(x + shift) applied as it stages its operand) against
the same launch after PyTorch's ops, at the serving shapes, split, ragged
and concat cases, and in the bf16 model's block-cached calls. Marked `cuda`;
each test
skips where no GPU is present. This file imports neither jax nor the JAX
package, so it runs where only the port is installed:

    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""
import contextlib
import math

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


def _random_conv(device, shape, seed=0):
    """x, kernel, style, bias and an `out` to accumulate into, for a 3x3x3
    conv of shape (B, D, H, W, Cin, Cout)."""
    b, d, h, w, cin, cout = shape
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(b, d, h, w, cin, device=device, generator=g)
    k = torch.randn(3, 3, 3, cin, cout, device=device, generator=g) / (27 * cin) ** 0.5
    s = torch.randn(b, cin, device=device, generator=g)
    bias = torch.randn(cout, device=device, generator=g)
    out = torch.randn(b, d, h, w, cout, device=device, generator=g)
    return x, k, s, bias, out


def _assert_close_to_plain(got, ref):
    torch.cuda.synchronize()
    assert (got - ref).abs().max().item() <= 1e-4 * ref.abs().max().item()


def test_kernel_split_k_with_all_options(cuda):
    """The 4-band deepest level, B2 D4 32x32 256->256: too few output tiles
    for the card, so the channel steps split over blocks and a second pass
    adds the partial sums, the bias and `out`."""
    from tmdiff_tpu_torch.ops.cuda import conv3d as K

    x, k, s, bias, out = _random_conv(cuda, (2, 4, 32, 32, 256, 256))
    with torch.no_grad():
        K.reset_launches()
        got = K.banded_conv3d(x, k, s, bias, out.clone())
        assert K.variant_launches == {"ffma": 0, "tf32x3": 0, "tf32x3_splitk": 1, "bf16": 0,
                                      "bf16_splitk": 0}
        _assert_close_to_plain(got, K.conv3d_plain(x, k, s, bias, out.clone()))


@pytest.mark.parametrize("shape", [(2, 4, 40, 40, 40, 48), (1, 3, 17, 9, 40, 48)])
def test_kernel_channels_off_the_tile(cuda, shape):
    """Cin 40 -> Cout 48: multiples of 4, not of the 16-channel step or the
    32/64-channel N tile; the tensor-core variant zero-pads both."""
    from tmdiff_tpu_torch.ops.cuda import conv3d as K

    x, k, s, bias, out = _random_conv(cuda, shape)
    with torch.no_grad():
        for st, bi, o in ((None, None, None), (s, bias, out)):
            K.reset_launches()
            got = K.banded_conv3d(x, k, st, bi, None if o is None else o.clone())
            assert K.variant_launches["ffma"] == 0
            _assert_close_to_plain(got, K.conv3d_plain(x, k, st, bi, None if o is None else o.clone()))


@pytest.mark.parametrize("cin_off,cout_off", [(4, 0), (5, 0), (0, 8), (0, 3), (5, 3)])
def test_kernel_weight_views_at_any_offset(cuda, cin_off, cout_off):
    """Weight views whose first element sits at a multiple of 4 floats and
    at one that is not (Cout 29 rows, odd channel offsets): the weight
    split pass reads them element by element, so they stay on the tensor
    cores without a copy."""
    from tmdiff_tpu_torch.ops.cuda import conv3d as K

    g = torch.Generator(device=cuda).manual_seed(3)
    x = torch.randn(2, 4, 20, 20, 32, device=cuda, generator=g)
    full = torch.randn(3, 3, 3, 48, 29, device=cuda, generator=g) / (27 * 32) ** 0.5
    kv = full[..., cin_off:cin_off + 32, cout_off:cout_off + 24]
    with torch.no_grad():
        K.reset_launches()
        got = K.banded_conv3d(x, kv)
        assert K.variant_launches["ffma"] == 0
        _assert_close_to_plain(got, K.conv3d_plain(x, kv))


@pytest.mark.parametrize("shape", [(2, 12, 20, 512, 512), (1, 30, 17, 512, 512)])
def test_conv3x3_nhwc_wide_at_ragged_height(cuda, shape):
    """K3 at the 8-band 64->64 fold, 512 -> 512 channels, with H % 8 != 0
    (the TPU kernel's 8-row strips do not divide it)."""
    from tmdiff_tpu_torch.ops.cuda import conv2d as K3

    b, h, w, cin, cout = shape
    g = torch.Generator(device=cuda).manual_seed(1)
    x = torch.randn(b, h, w, cin, device=cuda, generator=g)
    k = torch.randn(3, 3, cin, cout, device=cuda, generator=g) / (9 * cin) ** 0.5
    s = torch.randn(b, cin, device=cuda, generator=g)
    bias = torch.randn(cout, device=cuda, generator=g)
    with torch.no_grad():
        K3.reset_launches()
        got = K3.conv3x3_nhwc(x, k, s, bias)
        assert K3.variant_launches["ffma"] == 0
        _assert_close_to_plain(got, K3.conv3x3_nhwc_plain(x, k, s, bias))


# The largest error the 3xTF32 kernel may show at the main path's deepest
# sums: 5.54e-5 of the output's scale was the most chip_smoke.py measured
# over the main path's K1 shapes (8-band 64x64 256->256) on an H100 SXM at
# 700 W. Below CONV_RTOL, so that growth shows before the bar is crossed.
DEEP_SUM_RTOL = 8e-5


@pytest.mark.parametrize("shape", [(2, 8, 64, 64, 256, 256), (2, 128, 128, 512, 512)])
def test_kernel_error_at_the_deepest_sums(cuda, shape):
    """The main path's deepest sums without split-K: K1 at the 8-band 64x64
    256->256 level (K = 27 x 256) and K3 at 512->512 (K = 9 x 512). The
    tensor cores add each k8 step's products into the fp32 accumulator
    without IEEE rounding, so the error grows with K (the split itself
    keeps about 21 bits: tests/test_torch_tf32_split.py)."""
    from tmdiff_tpu_torch.ops.cuda import conv2d as K3
    from tmdiff_tpu_torch.ops.cuda import conv3d as K

    g = torch.Generator(device=cuda).manual_seed(4)
    if len(shape) == 6:
        x, k, s, bias, out = _random_conv(cuda, shape, seed=4)
        s = 1.0 + 0.5 * s
        module = K
        runs = [(lambda st, bi, o: K.banded_conv3d(x, k, st, bi, o),
                 lambda st, bi, o: K.conv3d_plain(x, k, st, bi, o), args)
                for args in ((None, None, None), (s, bias, out))]
    else:
        b, h, w, cin, cout = shape
        x = torch.randn(b, h, w, cin, device=cuda, generator=g)
        k = torch.randn(3, 3, cin, cout, device=cuda, generator=g) / (9 * cin) ** 0.5
        s = 1.0 + 0.5 * torch.randn(b, cin, device=cuda, generator=g)
        bias = torch.randn(cout, device=cuda, generator=g)
        module = K3
        runs = [(lambda st, bi, o: K3.conv3x3_nhwc(x, k, st, bi),
                 lambda st, bi, o: K3.conv3x3_nhwc_plain(x, k, st, bi), args)
                for args in ((None, None, None), (s, bias, None))]
    with torch.no_grad():
        for kernel_fn, plain_fn, (st, bi, o) in runs:
            module.reset_launches()
            got = kernel_fn(st, bi, None if o is None else o.clone())
            assert module.variant_launches == {"ffma": 0, "tf32x3": 1, "tf32x3_splitk": 0,
                                               "bf16": 0, "bf16_splitk": 0}
            ref = plain_fn(st, bi, None if o is None else o.clone())
            torch.cuda.synchronize()
            rel = (got - ref).abs().max().item() / ref.abs().max().item()
            print(f"{shape} style={st is not None} bias={bi is not None} "
                  f"out={o is not None}: max err / output scale {rel:.3g}")
            assert rel <= DEEP_SUM_RTOL


CHAIN_SPLITS = (1, 2, 4, 8, 16)
# K1 with an accumulation chain at every channel step: 3.04e-6 of the
# output's scale at K = 27 x 256 on N tiles of 64, 3.13e-6 on N tiles of 128
# split 16 ways (NVIDIA H100 80GB HBM3, 700 W)
ONE_STEP_CHAIN_RTOL = 1e-5


@contextlib.contextmanager
def forced_splits(K, splits):
    """Within the block every tensor-core launch of the conv3d module splits
    its channel steps (16 channels in fp32, 32 or 64 in bf16) over `splits`
    blocks (at most one a step), as the
    C plan gives that count with its workspace; each accumulation chain then
    spans fewer steps."""
    import ctypes

    planned = K.plan

    def plan(kd, x, d, cout, unsharded=None):
        b, h, w, cin = x.shape[0], x.shape[-3], x.shape[-2], x.shape[-1]
        nbytes, count = ctypes.c_longlong(0), ctypes.c_int(splits)
        variant = K.library().tmdiff_conv_plan(kd, K.DTYPES[x.dtype], b, d, h, w, cin, cout,
                                               x.data_ptr(), ctypes.byref(nbytes),
                                               ctypes.byref(count))
        workspace = torch.empty(nbytes.value, dtype=torch.uint8, device=x.device)
        return K.VARIANTS[variant], count.value, workspace

    K.plan = plan
    try:
        yield
    finally:
        K.plan = planned


@pytest.mark.parametrize("cout", [256, 64])
def test_kernel_error_against_chain_length(cuda, cout):
    """K = 27 x 256 at the 8-band 64x64 level (256 -> 256 on N tiles of
    128, 256 -> 64 on one of 64), the 16 channel steps forced over 1, 2, 4,
    8 and 16 splits, so that each accumulation chain of the N tiles of 128
    spans 16 down to 1 steps (the partial sums added in order in fp32 by the
    second pass). Prints the error against the plain version per split
    count. The tensor cores' accumulation makes it grow with the chain, so
    at 16 splits it falls to ONE_STEP_CHAIN_RTOL; the N tiles of 64 start a
    chain at every channel step and stay there at every split count."""
    from tmdiff_tpu_torch.ops.cuda import conv3d as K

    x, k, s, bias, _ = _random_conv(cuda, (2, 8, 64, 64, 256, cout), seed=4)
    errs = {}
    with torch.no_grad():
        ref = K.conv3d_plain(x, k)
        for splits in (None,) + CHAIN_SPLITS:
            with forced_splits(K, splits) if splits else contextlib.nullcontext():
                got = K.banded_conv3d(x, k)
            torch.cuda.synchronize()
            errs[splits or "planned"] = (got - ref).abs().max().item() / ref.abs().max().item()
    print(f"256 -> {cout}: max err / output scale by split count {errs}")
    assert errs["planned"] <= DEEP_SUM_RTOL and errs[16] <= ONE_STEP_CHAIN_RTOL
    if cout == 64:
        assert max(errs.values()) <= ONE_STEP_CHAIN_RTOL


class _Float64Torch:
    """The torch module with `float32` read as `float64`: the time
    embedding's own float32 arithmetic then runs in float64."""

    def __getattr__(self, name):
        return torch.float64 if name == "float32" else getattr(torch, name)


def _float64_model(model):
    """A float64 copy of the model: its parameters and its compute dtype
    (the `dtype` its blocks and Linear layers cast to) in float64."""
    import copy

    model64 = copy.deepcopy(model).double()
    for m in model64.modules():
        if hasattr(m, "dtype"):
            m.dtype = torch.float64
    return model64


def _preset_case(cuda, bands):
    """chip_smoke.py's gradient check: the full-width model with init
    "torch" (seed 0), synthetic scenes (WV3 8 bands or QB 4) at batch 8,
    64x64, fixed t and noise, dropout off."""
    import numpy as np

    from tmdiff_tpu_torch.data.h5 import PanDataset
    from tmdiff_tpu_torch.data.synthetic import make_arrays
    from tmdiff_tpu_torch.diffusion.schedules import NoiseSchedule
    from tmdiff_tpu_torch.models.clip_text import load_prompt_table
    from tmdiff_tpu_torch.models.init_styles import apply_init_style
    from tmdiff_tpu_torch.models.wavbest import WavBEST

    model = apply_init_style(WavBEST(seed=0), "torch", torch.Generator().manual_seed(0))
    ns = NoiseSchedule.create("cosine", 1000)
    sensor, seed = ("WV3", 3) if bands == 8 else ("QB", 1)
    batch = PanDataset(make_arrays(8, bands, 64, seed=seed)).batch(np.arange(8))
    batch = {k: torch.as_tensor(batch[k], device=cuda) for k in ("Res", "PAN", "MS")}
    table, index, _ = load_prompt_table()
    prompt = torch.as_tensor(table[index[sensor]], device=cuda)
    g = torch.Generator(device=cuda).manual_seed(0)
    t = torch.randint(1, 1001, (8,), generator=g, device=cuda)
    noise = torch.randn(batch["Res"].shape, generator=g, device=cuda)
    return model, ns, batch, prompt, t, noise


def _preset_prediction(case, dtype=torch.float32):
    """The model's x0 prediction on the case, and the target."""
    from tmdiff_tpu_torch.diffusion import gaussian
    from tmdiff_tpu_torch.ops import embedding

    model, ns, batch, prompt, t, noise = case
    gamma = ns.sqrt_alphas_cumprod_prev.to(device=noise.device, dtype=dtype)[t]
    res, pan, ms = (batch[k].to(dtype) for k in ("Res", "PAN", "MS"))
    x_t = gaussian.q_sample(res, gamma[:, None, None, None], noise.to(dtype))
    saved = embedding.torch
    if dtype == torch.float64:
        embedding.torch = _Float64Torch()
    try:
        return model(x_t, t, pan, ms, prompt.to(dtype)), res
    finally:
        embedding.torch = saved


def _errors(names, got, ref):
    return {n: ((a.double() - b.double()).abs().max() / b.double().abs().max()).item()
            for n, a, b in zip(names, got, ref)}


def _summary(errs):
    worst = max(errs, key=errs.get)
    return (f"up2.up1.convH_0.0.bias {errs['up2.up1.convH_0.0.bias']:.3g}, "
            f"worst {worst} {errs[worst]:.3g}")


@pytest.mark.parametrize("bands", [8, 4])
def test_preset_gradients_match_plain(cuda, bands):
    """chip_smoke.py's gradient check, with the float64 plain path beside.
    The L1 loss's gradient is sign(pred - target): an element whose
    prediction lies within the forward's rounding of its target can take
    another sign on each path (one of 262144 at 8 bands, at |pred - target|
    = 3.4e-8, moved up2.up1.convH_0.0.bias's gradient, a cancelling sum, by
    1.6e-3 of its scale; the same through the float64 path), so both paths
    take the plain path's signs there. Then each of the 216 gradients lies
    within 1e-3 of its scale of the plain path's and of the float64 path's;
    it prints the L1 gradients with each path's own signs, the count of
    elements whose sign differs, K1 with a chain at every channel step
    (16 splits), and the L2 loss's gradients."""
    from tmdiff_tpu_torch.ops.cuda import conv3d as K

    case = _preset_case(cuda, bands)
    model = case[0]
    names, params = zip(*model.named_parameters())
    kinds = ("l1_plain_signs", "l1", "l2")

    def all_grads(pred, target, ps, sign):
        out = {}
        for i, kind in enumerate(kinds):
            if kind == "l1":
                loss = (target - pred).abs().mean()
            elif kind == "l1_plain_signs":
                loss = ((pred - target) * sign.to(pred.dtype)).mean()
            else:
                loss = ((target - pred) ** 2).mean()
            out[kind] = torch.autograd.grad(loss, ps, retain_graph=i + 1 < len(kinds))
        return out

    model.use_plain_conv(True)
    pred, res = _preset_prediction(case)
    pred_plain = pred.detach()
    sign_plain = torch.sign(pred_plain - res)
    g_plain = all_grads(pred, res, params, sign_plain)
    model.use_plain_conv(False)
    pred, _ = _preset_prediction(case)
    forward_err = (pred.detach() - pred_plain).abs().max().item()
    flips = torch.sign(pred.detach() - res) != sign_plain
    margin = (pred_plain - res).abs()
    g_k1 = all_grads(pred, res, params, sign_plain)
    with forced_splits(K, 16):
        pred, _ = _preset_prediction(case)
        g_k1_16 = all_grads(pred, res, params, sign_plain)
    model64 = _float64_model(model).use_plain_conv(True)
    pred, res64 = _preset_prediction((model64,) + case[1:], torch.float64)
    flips64 = int((torch.sign(pred.detach() - res64).float() != sign_plain).sum())
    g_64 = all_grads(pred, res64, list(model64.parameters()), sign_plain)
    del pred, model64
    print(f"{bands} bands: forward K1 vs plain {forward_err:.3g}; {int(flips.sum())} of "
          f"{flips.numel()} elements take another L1 sign through K1 (|pred - target| there "
          f"{margin[flips].max().item() if flips.any() else 0:.3g} at most, "
          f"{margin.min().item():.3g} at the least of all); the float64 path flips {flips64}")
    errs = {}
    for kind in kinds:
        errs[kind] = (_errors(names, g_k1[kind], g_plain[kind]),
                      _errors(names, g_k1[kind], g_64[kind]))
        print(f"{bands} bands {kind}: K1 vs plain: {_summary(errs[kind][0])}; K1 with a chain a "
              f"channel step vs plain: {_summary(_errors(names, g_k1_16[kind], g_plain[kind]))}"
              f"; plain vs float64: {_summary(_errors(names, g_plain[kind], g_64[kind]))}; "
              f"K1 vs float64: {_summary(errs[kind][1])}")
    assert forward_err <= 5e-4 and bool((margin[flips] <= forward_err).all())
    vs_plain, vs_64 = errs["l1_plain_signs"]
    assert max(vs_plain.values()) <= 1e-3 and max(vs_64.values()) <= 1e-3


@pytest.mark.parametrize("shape,variant", [
    ((2, 4, 32, 32, 256, 256), "tf32x3_splitk"), ((2, 8, 128, 128, 32, 32), "tf32x3"),
    ((1, 3, 5, 7, 3, 5), "ffma"), ((2, 4, 32, 32, 256, 256), "bf16_splitk"),
    ((2, 8, 128, 128, 32, 32), "bf16"), ((2, 8, 64, 64, 128, 64), "bf16"),
])
def test_kernel_is_deterministic(cuda, shape, variant):
    """One input gives one output: two launches agree bit for bit (split-K
    adds its partial sums in a fixed order, without atomics); the bf16
    cases are what the served images' replay rests on."""
    from tmdiff_tpu_torch.ops.cuda import conv3d as K

    x, k, s, bias, out = _random_conv(cuda, shape)
    if variant.startswith("bf16"):
        x, k, s, bias, out = (t.bfloat16() for t in (x, k, s, bias, out))
    with torch.no_grad():
        K.reset_launches()
        first = K.banded_conv3d(x, k, s, bias, out.clone())
        second = K.banded_conv3d(x, k, s, bias, out.clone())
        torch.cuda.synchronize()
    assert K.variant_launches[variant] == 2
    assert torch.equal(first, second)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_shards_planned_unsharded_sum_as_the_batch(cuda, dtype):
    """A batch shard and a height shard (with its halo rows) of a deep conv
    whose own split-K rule differs from the whole call's: planned with
    `unsharded`, each takes the whole call's split count and gives its bits
    exactly, K1 and K3 alike."""
    from tmdiff_tpu_torch.ops.cuda import conv2d as K3
    from tmdiff_tpu_torch.ops.cuda import conv3d as K

    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(8, 8, 32, 32, 256, device=cuda, generator=g).to(dtype)
    k = (torch.randn(3, 3, 3, 256, 256, device=cuda, generator=g) / 83.0).to(dtype)
    with torch.no_grad():
        whole = K.banded_conv3d(x, k)
        own = K.plan(3, x[:2].contiguous(), 8, 256)[1]
        assert own != K.plan(3, x, 8, 256)[1]  # the case the hint is for
        part = K.banded_conv3d(x[:2].contiguous(), k, unsharded=(8, 32))
        assert torch.equal(part, whole[:2])
        rows = K.banded_conv3d(x[:, :, 7:25].contiguous(), k, unsharded=(8, 32))
        assert torch.equal(rows[:, :, 1:-1], whole[:, :, 8:24])
        x2 = x[:, 0].contiguous()
        w2 = k[1].contiguous()
        whole2 = K3.conv3x3_nhwc(x2, w2)
        assert torch.equal(K3.conv3x3_nhwc(x2[:2].contiguous(), w2, unsharded=(8, 32)),
                           whole2[:2])


@pytest.mark.parametrize("dtype,variant", [(torch.float32, "tf32x3_splitk"),
                                           (torch.bfloat16, "bf16_splitk")])
def test_conv3x3_nhwc_is_deterministic(cuda, dtype, variant):
    from tmdiff_tpu_torch.ops.cuda import conv2d as K3

    g = torch.Generator(device=cuda).manual_seed(2)
    x = torch.randn(2, 64, 64, 512, device=cuda, generator=g).to(dtype)
    k = (torch.randn(3, 3, 512, 256, device=cuda, generator=g) / (9 * 512) ** 0.5).to(dtype)
    s = (1 + 0.5 * torch.randn(2, 512, device=cuda, generator=g)).to(dtype)
    bias = torch.randn(256, device=cuda, generator=g).to(dtype)
    with torch.no_grad():
        K3.reset_launches()
        first, second = K3.conv3x3_nhwc(x, k, s, bias), K3.conv3x3_nhwc(x, k, s, bias)
        torch.cuda.synchronize()
    assert K3.variant_launches[variant] == 2
    assert torch.equal(first, second)


def test_model_path_runs_on_the_tensor_cores(cuda):
    """Every 3x3x3 conv of a WavBEST whose widths are multiples of 4 takes
    a tensor-core variant, under both lowerings."""
    from tmdiff_tpu_torch.models.wavbest import WavBEST
    from tmdiff_tpu_torch.ops.cuda import conv2d as K3
    from tmdiff_tpu_torch.ops.cuda import conv3d as K

    model = WavBEST((8, 16, 32, 64), seed=0)
    g = torch.Generator(device=cuda).manual_seed(1)
    x = torch.randn(2, 8, 32, 32, device=cuda, generator=g)
    pan = torch.rand(2, 1, 32, 32, device=cuda, generator=g)
    ms = torch.rand(2, 8, 32, 32, device=cuda, generator=g)
    prompt = torch.randn(768, device=cuda, generator=g)
    t = torch.tensor([3.0, 600.0], device=cuda)
    with torch.no_grad():
        for impl in ("banded", "auto"):
            K.reset_launches()
            K3.reset_launches()
            model.use_conv_impl(impl)(x, t, pan, ms, prompt)
            assert K.launches + K3.launches == 13 + 52
            assert K.variant_launches["ffma"] == 0 and K3.variant_launches["ffma"] == 0
        model.use_conv_impl("banded")


def test_wrapper_refuses(cuda):
    from tmdiff_tpu_torch.ops.cuda import conv3d as K

    x = torch.randn(1, 4, 8, 8, 4, device=cuda)
    k = torch.randn(3, 3, 3, 4, 8, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        K.banded_conv3d(x.transpose(2, 3), k)
    with pytest.raises(TypeError, match="float32"):
        K.banded_conv3d(x.double(), k.double())
    with pytest.raises(RuntimeError, match="no backward"):
        K._launch(x.requires_grad_(), k, None, None, None)
    with pytest.raises(ValueError, match="is on"):
        K.banded_conv3d(x.detach(), k.cpu())
    # the entries take a gradient through their autograd Function
    K.reset_launches()
    y = K.banded_conv3d(x, k)
    assert y.grad_fn is not None and K.launches == 1


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


def _random_attention(device, q_shape, kv_len, seed=0):
    b, h, sq, d = q_shape
    g = torch.Generator(device=device).manual_seed(seed)
    return (torch.randn(q_shape, device=device, generator=g),
            torch.randn(b, h, kv_len, d, device=device, generator=g),
            torch.randn(b, h, kv_len, d, device=device, generator=g))


@pytest.mark.parametrize("q_shape,kv_len", [
    ((2, 8, 4096, 64), 4096), ((2, 8, 4096, 64), 1), ((2, 1, 1024, 256), 1024),
    ((1, 2, 48, 32), 130), ((1, 2, 100, 40), 100), ((3, 1, 1, 8), 77), ((1, 1, 70, 200), 33),
    ((1, 3, 129, 128), 65),
    ((1, 2, 50, 64), 7), ((1, 2, 50, 64), 8), ((1, 2, 50, 64), 9), ((1, 2, 50, 64), 63),
    ((1, 2, 50, 64), 4097), ((2, 2, 77, 42), 50),
])
def test_flash_attention_matches_reference(cuda, q_shape, kv_len):
    """K4 against attention_reference at unit-normal inputs: masked key
    tails, a single key, key counts around the 8/16/64-key tiles, ragged
    query tiles, D from 8 to 256 on the tensor cores and D = 42 on the FMA
    variant; atol 2e-5."""
    from tmdiff_tpu_torch.ops.cuda import flash_attention as K4

    q, k, v = _random_attention(cuda, q_shape, kv_len)
    with torch.no_grad():
        K4.reset_launches()
        got = K4.flash_attention(q, k, v)
        assert K4.launches == 1
        assert K4.variant_launches["fma" if q_shape[3] % 4 else "tc"] == 1
        ref = K4.attention_reference(q, k, v)
        torch.cuda.synchronize()
    assert (got - ref).abs().max().item() <= 2e-5


@pytest.mark.parametrize("q_shape,kv_len,key_tile,splits", [
    ((2, 8, 4096, 64), 4096, 64, 1), ((2, 8, 4096, 64), 1, 8, 1), ((2, 1, 1024, 256), 1024, 16, 4),
])
def test_flash_attention_plan_at_the_chip_shapes(cuda, q_shape, kv_len, key_tile, splits):
    """chip_smoke.py's shapes take the tensor cores with these key tiles and
    split counts on a 132-SM H100 (SpatialSelfAttention splits its keys
    four ways: 32 blocks of 64 queries become 128)."""
    from tmdiff_tpu_torch.ops.cuda import flash_attention as K4

    if torch.cuda.get_device_properties(cuda).multi_processor_count != 132:
        pytest.skip("split counts are those of a 132-SM card")
    q, k, v = _random_attention(cuda, q_shape, kv_len)
    p = K4.device_plan(q, kv_len)
    assert (p.variant, p.key_tile, p.splits) == ("tc", key_tile, splits)
    with torch.no_grad():
        K4.reset_launches()
        K4.flash_attention(q, k, v)
    assert K4.variant_launches == {"fma": 0, "tc": 1, "bf16_fma": 0, "bf16": 0}


def test_flash_attention_split_kv_is_deterministic(cuda):
    """The split shape merges its partial sums in split order, without
    atomics: two launches on one input agree bit for bit."""
    from tmdiff_tpu_torch.ops.cuda import flash_attention as K4

    q, k, v = _random_attention(cuda, (2, 1, 1024, 256), 1024, seed=5)
    assert K4.device_plan(q, 1024).splits > 1
    with torch.no_grad():
        first, second = K4.flash_attention(q, k, v), K4.flash_attention(q, k, v)
        torch.cuda.synchronize()
    assert torch.equal(first, second)


# The largest error K4 may show at its deepest sums, half the 2e-5 bar, so
# that growth shows before the bar is crossed. Each key tile's P.V goes into
# a fresh accumulator folded into O in fp32, so the tensor cores' own
# accumulation spans one tile, not the key range.
DEEP_SUM_ATOL = 1e-5


@pytest.mark.parametrize("q_shape,kv_len", [((2, 8, 4096, 64), 4096), ((2, 4, 1024, 256), 1024)])
def test_flash_attention_error_at_the_deepest_sums(cuda, q_shape, kv_len):
    """Self-attention over 4096 keys at D = 64 and 1024 keys at D = 256,
    neither split over blocks (one block walks every key tile)."""
    from tmdiff_tpu_torch.ops.cuda import flash_attention as K4

    q, k, v = _random_attention(cuda, q_shape, kv_len, seed=6)
    assert K4.device_plan(q, kv_len).splits == 1
    with torch.no_grad():
        got = K4.flash_attention(q, k, v)
        ref = K4.attention_reference(q, k, v)
        torch.cuda.synchronize()
    err = (got - ref).abs().max().item()
    print(f"{q_shape} Skv {kv_len}: max abs err {err:.3g}")
    assert err <= DEEP_SUM_ATOL


def test_flash_attention_refuses_unaligned_rows(cuda):
    """The tensor-core variant reads 16-byte rows: a view that starts off a
    16-byte boundary is refused, not read misaligned."""
    from tmdiff_tpu_torch.ops.cuda import flash_attention as K4

    q = torch.randn(1 + 2 * 8 * 16, device=cuda)[1:].view(1, 2, 8, 16)
    k = torch.randn(1, 2, 8, 16, device=cuda)
    with pytest.raises(ValueError, match="16-byte aligned"):
        K4.flash_attention(q, k, k)


def test_flash_attention_wrapper_refuses(cuda):
    from tmdiff_tpu_torch.ops.cuda import flash_attention as K4

    q = torch.randn(1, 2, 8, 16, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        K4.flash_attention(q.transpose(2, 3), q, q)
    with pytest.raises(ValueError, match="head dim"):
        K4.flash_attention(*(torch.randn(1, 1, 4, 300, device=cuda),) * 3)
    with pytest.raises(RuntimeError, match="no backward"):
        K4.flash_attention(q.clone().requires_grad_(), q, q)


def _bf16_half_step(t):
    a = t.float().abs()
    e = torch.floor(torch.log2(torch.where(a > 0, a, torch.ones_like(a))))
    return torch.where(a > 0, torch.exp2(e - 8), torch.zeros_like(a))


@pytest.mark.parametrize("q_shape,kv_len", [
    ((2, 8, 4096, 64), 4096), ((2, 8, 4096, 64), 1), ((2, 1, 1024, 256), 1024),
    ((1, 2, 48, 32), 130), ((1, 2, 100, 40), 100), ((3, 1, 1, 8), 77), ((1, 1, 70, 200), 33),
    ((1, 3, 129, 128), 65), ((1, 2, 50, 64), 7), ((1, 2, 50, 64), 4097),
    ((2, 4, 1024, 256), 1024), ((2, 2, 77, 42), 50), ((1, 2, 33, 12), 20),
    # the key tile's edges (BK - 1, BK, BK + 1 at BK = 128 / 64 / 32 for head
    # tiles 64 / 128 / 256), split and, with 160 blocks, unsplit
    ((1, 2, 200, 64), 127), ((1, 2, 200, 64), 128), ((1, 2, 200, 64), 129),
    ((2, 40, 256, 64), 129),
    ((1, 2, 130, 128), 63), ((1, 2, 130, 128), 64), ((1, 2, 130, 128), 65),
    ((2, 40, 256, 128), 65),
    ((1, 2, 70, 256), 31), ((1, 2, 70, 256), 32), ((1, 2, 70, 256), 33),
    ((2, 40, 128, 256), 33),
    # head tile 256 with the columns past D = 136 zero-filled by the TMA
    ((1, 2, 100, 136), 77), ((2, 40, 128, 136), 300),
])
def test_flash_attention_bf16_matches_plain(cuda, q_shape, kv_len):
    """K4's bf16 instance against flash_attention_plain on the same bf16
    inputs: the output bf16, each element within one bf16 step (half a step
    of each side's value plus 1e-4 of the output's scale: two roundings of
    fp32 results that differ in their last bits); the tensor cores at D % 8
    == 0 (split and unsplit, masked tails, one key, the key tile's edges,
    columns past D), the FMA kernel over bf16 loads at D = 42 and 12; a
    second launch bit-identical."""
    from tmdiff_tpu_torch.ops.cuda import flash_attention as K4

    q, k, v = (t.bfloat16() for t in _random_attention(cuda, q_shape, kv_len, seed=7))
    with torch.no_grad():
        K4.reset_launches()
        got = K4.flash_attention(q, k, v)
        again = K4.flash_attention(q, k, v)
        assert K4.variant_launches["bf16_fma" if q_shape[3] % 8 else "bf16"] == 2
        ref = K4.flash_attention_plain(q, k, v)
        torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and torch.equal(got, again)
    diff = (got.float() - ref.float()).abs()
    bar = _bf16_half_step(got) + _bf16_half_step(ref) + 1e-4 * ref.float().abs().max()
    assert bool((diff <= bar).all()), diff.max().item()


# The bf16 instance at its deepest sums against float64 on the same bf16
# inputs: beyond the output's own rounding (half a bf16 step), at most a
# quarter of the bf16 bar's 1e-4 of the output's scale. P enters P.V as two
# bf16 parts (16 of p's 24 bits: 2^-18 of sum p |v|, about 26x inside 1e-4;
# tests/test_torch_flash_plan.py emulates it), and each key tile's P.V is
# folded into O in fp32.
DEEP_SUM_BF16_RTOL = 2.5e-5


@pytest.mark.parametrize("q_shape,kv_len", [((2, 8, 4096, 64), 4096), ((2, 4, 1024, 256), 1024)])
def test_flash_attention_bf16_error_at_the_deepest_sums(cuda, q_shape, kv_len):
    """Self-attention over 4096 keys at D = 64 and 1024 keys at D = 256 in
    bf16, neither split over blocks, against the function in float64."""
    from tmdiff_tpu_torch.ops.cuda import flash_attention as K4

    q, k, v = (t.bfloat16() for t in _random_attention(cuda, q_shape, kv_len, seed=8))
    assert K4.device_plan(q, kv_len).splits == 1
    with torch.no_grad():
        got = K4.flash_attention(q, k, v).double()
        s = torch.einsum("bhqd,bhkd->bhqk", q.double(), k.double()) * q_shape[3] ** -0.5
        ref = torch.einsum("bhqk,bhkd->bhqd", torch.softmax(s, -1), v.double())
        torch.cuda.synchronize()
    beyond = ((got - ref).abs() - _bf16_half_step(got).double()).clamp(min=0)
    rel = beyond.max().item() / ref.abs().max().item()
    print(f"{q_shape} Skv {kv_len}: beyond the bf16 rounding {rel:.3g} of scale")
    assert rel <= DEEP_SUM_BF16_RTOL


@pytest.mark.parametrize("q_shape,kv_len", [
    ((2, 8, 4096, 64), 4096), ((2, 8, 4096, 64), 1), ((2, 4, 1024, 256), 1024),
    ((2, 1, 1024, 256), 1024),
])
def test_flash_attention_bf16_launches_one_kernel_unsplit(cuda, q_shape, kv_len):
    """An unsplit bf16 call is one CUDA kernel, the bf16 tensor-core kernel
    (K and V read in place: no K/V pass); a split one adds the merge."""
    from tmdiff_tpu_torch.bench_attention import kernel_launches
    from tmdiff_tpu_torch.ops.cuda import flash_attention as K4

    q, k, v = (t.bfloat16() for t in _random_attention(cuda, q_shape, kv_len, seed=9))
    splits = K4.device_plan(q, kv_len).splits
    with torch.no_grad():
        kernels = kernel_launches(lambda: K4.flash_attention(q, k, v))
    names = sorted(kernels)
    assert all(n == 1 for n in kernels.values()), kernels
    assert len(names) == (1 if splits == 1 else 2), kernels
    assert any("flash_attention_bf16_kernel" in n for n in names), kernels
    assert not any("kv_split" in n for n in names), kernels


def test_flash_attention_bf16_refuses(cuda):
    """A bf16 tensor-core shape must start on a 16-byte boundary, and one
    launch takes one dtype."""
    from tmdiff_tpu_torch.ops.cuda import flash_attention as K4

    q = torch.randn(1 + 2 * 8 * 16, device=cuda).bfloat16()[1:].view(1, 2, 8, 16)
    k = torch.randn(1, 2, 8, 16, device=cuda).bfloat16()
    with pytest.raises(ValueError, match="16-byte aligned when D % 8 == 0"):
        K4.flash_attention(q, k, k)
    with pytest.raises(TypeError, match="one dtype"):
        K4.flash_attention(k, k.float(), k)


def test_spatial_transformer_bf16_kernel_matches_plain(cuda):
    """A bf16 SpatialTransformer through K4's bf16 instance (two launches)
    against the same module on the plain attention; within 2e-2 of the
    output's scale (bf16 activations through two attentions and a
    feed-forward: the model bar of tests/test_torch_bf16.py)."""
    from tmdiff_tpu_torch.ops import attention
    from tmdiff_tpu_torch.ops.cuda import flash_attention as K4

    torch.manual_seed(0)
    m = attention.SpatialTransformer(64, 4, 32, depth=1, context_dim=96,
                                     dtype=torch.bfloat16).to(cuda).eval()
    torch.nn.init.normal_(m.proj_out.weight, std=0.05)
    x = torch.randn(2, 16, 16, 64, device=cuda)
    ctx = torch.randn(2, 3, 96, device=cuda)
    with torch.no_grad():
        K4.reset_launches()
        y = m(x, ctx)
        assert K4.variant_launches["bf16"] == 2 and K4.launches == 2
        for mod in m.modules():
            if hasattr(mod, "use_flash"):
                mod.use_flash = False
        ref = m(x, ctx)
    assert (y - ref).abs().max().item() <= 2e-2 * ref.abs().max().item()


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


# -- training: K1 under autograd ----------------------------------------------


@pytest.mark.parametrize("shape,variant", [
    ((2, 8, 64, 64, 32, 64), "tf32x3"), ((1, 4, 8, 8, 3, 6), "ffma"),
    ((2, 4, 32, 32, 256, 256), "tf32x3_splitk"),
])
def test_conv_gradients_match_plain(cuda, shape, variant):
    """Every operand's gradient through Conv3dFunction (forward and input
    gradient on the kernel: tensor cores, FMA at Cin and Cout % 4 != 0, and
    split-K; weight gradient on its kernel, on cuDNN at Cin 3) against
    autograd through the plain
    version on the card, with style and bias, with concat parts whose kernel
    slices are views, and with Cout views of one weight; to 1e-4 of each
    gradient's largest magnitude."""
    from tmdiff_tpu_torch.ops import modconv
    from tmdiff_tpu_torch.ops.cuda import conv3d as K

    x, k, s, bias, _ = _random_conv(cuda, shape, seed=7)
    s = 1.0 + 0.5 * s
    gy = torch.randn(x.shape[:-1] + (k.shape[-1],), device=cuda)
    cin = x.shape[-1]
    cut = [0, cin // 3, cin // 3 + cin // 4 + 1, cin]

    def grads(plain, case):
        xs, ks, ss, bs = (t.clone().requires_grad_() for t in (x, k, s, bias))
        if case == "style_bias":
            y = modconv.conv3d(xs, ks, style=ss, bias=bs, plain=plain)
        elif case == "parts":
            y = modconv.conv3d_cat(tuple(xs[..., a:b].contiguous() for a, b in zip(cut, cut[1:])),
                                   ks, bias=bs, plain=plain)
        else:
            half = ks.shape[-1] // 2
            y = torch.cat([modconv.conv3d(xs, ks[..., :half], bias=bs[:half], plain=plain),
                           modconv.conv3d(xs, ks[..., half:], bias=bs[half:], plain=plain)], -1)
        (y * gy).sum().backward()
        return [t.grad for t in (xs, ks, ss, bs)]

    for case in ("style_bias", "parts", "views"):
        K.reset_launches()
        got = grads(False, case)
        if case == "style_bias":
            assert K.variant_launches[variant] >= 1 and K.input_grad_launches == 1
            assert K.weight_grad_calls == 1
        ref = grads(True, case)
        torch.cuda.synchronize()
        for name, g, r in zip(("x", "kernel", "style", "bias"), got, ref):
            if r is None:
                assert g is None, (case, name)
                continue
            err = (g - r).abs().max().item() / r.abs().max().item()
            assert err <= 1e-4, (case, name, err)


def test_full_width_model_gradients_match_plain(cuda):
    """The full-width WavBEST (32, 64, 128, 256), 8 bands, batch 2 at 32x32:
    the x0 loss and every parameter's gradient through K1 against the plain
    convs, dropout off; loss to 1e-4 relative, each gradient to 1e-3 of its
    largest magnitude (chip_smoke.py's bars)."""
    from tmdiff_tpu_torch.diffusion import gaussian
    from tmdiff_tpu_torch.diffusion.schedules import NoiseSchedule
    from tmdiff_tpu_torch.models.init_styles import apply_init_style
    from tmdiff_tpu_torch.models.wavbest import WavBEST
    from tmdiff_tpu_torch.ops.cuda import conv3d as K

    model = apply_init_style(WavBEST(seed=0), "torch", torch.Generator().manual_seed(0))
    ns = NoiseSchedule.create("cosine", 1000).to(cuda)
    g = torch.Generator(device=cuda).manual_seed(2)
    res = 0.1 * torch.randn(2, 8, 32, 32, device=cuda, generator=g)
    pan = torch.rand(2, 1, 32, 32, device=cuda, generator=g)
    ms = torch.rand(2, 8, 32, 32, device=cuda, generator=g)
    prompt = torch.randn(768, device=cuda, generator=g)
    t = torch.tensor([17, 640], device=cuda)
    noise = torch.randn(res.shape, device=cuda, generator=g)
    params = list(model.parameters())
    out = []
    for plain in (False, True):
        model.use_plain_conv(plain)
        K.reset_launches()
        loss = gaussian.diffusion_loss(lambda x, tt, p, m: model(x, tt, p, m, prompt), ns, None,
                                       res, pan, ms, t=t, noise=noise)
        out.append((loss.item(), torch.autograd.grad(loss, params), K.launches))
    model.use_plain_conv(False)
    (lk, gk, nk), (lp, gp, np_) = out
    assert nk == 2 * 65 and np_ == 0
    assert abs(lk - lp) <= 1e-4 * abs(lp)
    for a, b in zip(gk, gp):
        assert (a - b).abs().max().item() <= 1e-3 * b.abs().max().item()


def _card_trainer(cuda, **kw):
    from tmdiff_tpu_torch.diffusion.schedules import NoiseSchedule
    from tmdiff_tpu_torch.models.wavbest import WavBEST
    from tmdiff_tpu_torch.train.trainer import Trainer

    return Trainer(WavBEST((8, 16, 32, 64), seed=0), NoiseSchedule.create("cosine", 1000),
                   lr=1e-3, warmup_steps=2, **kw)


def _card_batch(cuda, bands=8):
    g = torch.Generator(device=cuda).manual_seed(3)
    return {"Res": 0.1 * torch.randn(2, bands, 32, 32, device=cuda, generator=g),
            "PAN": torch.rand(2, 1, 32, 32, device=cuda, generator=g),
            "MS": torch.rand(2, bands, 32, 32, device=cuda, generator=g)}


def test_remat_gives_the_same_gradients_on_the_card(cuda):
    """Dropout on: remat on and off give the same loss and gradients bit for
    bit (the recompute draws from a generator seeded as the first pass's;
    K1 and the weight gradient are deterministic)."""
    batch, prompt = _card_batch(cuda), torch.randn(768, device=cuda)
    got = []
    for remat in (True, False):
        trainer = _card_trainer(cuda, remat=remat)
        loss = trainer.loss(3, batch, prompt)
        got.append((loss.detach(), torch.autograd.grad(loss, list(trainer.model.parameters()))))
    assert torch.equal(got[0][0], got[1][0])
    assert all(torch.equal(a, b) for a, b in zip(got[0][1], got[1][1]))


def test_training_steps_repeat_bit_for_bit(cuda):
    """Two trainers from one seed take the same two steps: equal losses,
    parameters and EMA, bit for bit; every launch on the tensor cores."""
    from tmdiff_tpu_torch.ops.cuda import conv3d as K

    batch, prompt = _card_batch(cuda), torch.randn(768, device=cuda)
    runs = []
    for _ in range(2):
        trainer = _card_trainer(cuda)
        state = trainer.init_state()
        K.reset_launches()
        losses = [trainer.train_step(state, batch, prompt)[1]["l_pix"] for _ in range(2)]
        assert K.variant_launches["ffma"] == 0
        assert K.launches == 2 * (2 * 65 + 65) and K.input_grad_launches == 2 * 65
        runs.append((torch.stack(losses), list(trainer.model.parameters()), state.ema_params))
    assert torch.equal(runs[0][0], runs[1][0])
    assert all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))
    assert all(torch.equal(a, b) for a, b in zip(runs[0][2], runs[1][2]))


def _full_width_trainer(cuda, dtype, **kw):
    """The general_multi preset's training step at full width (channels 32,
    64, 128, 256), remat on, in `dtype`."""
    from tmdiff_tpu_torch.diffusion.schedules import NoiseSchedule
    from tmdiff_tpu_torch.models.wavbest import WavBEST
    from tmdiff_tpu_torch.train.trainer import Trainer

    model = WavBEST((32, 64, 128, 256), seed=0, dtype=dtype)
    return Trainer(model, NoiseSchedule.create("cosine", 1000), lr=1e-4, warmup_steps=2,
                   ema_start=1, p_uncond=0.1, seed=5, **kw)


def _full_width_batch(cuda, seed, bands=8):
    g = torch.Generator(device=cuda).manual_seed(seed)
    return {"Res": 0.1 * torch.randn(8, bands, 64, 64, device=cuda, generator=g),
            "PAN": torch.rand(8, 1, 64, 64, device=cuda, generator=g),
            "MS": torch.rand(8, bands, 64, 64, device=cuda, generator=g)}


def _train_state_tensors(state):
    out = [p.detach() for p in state.model.parameters()] + list(state.ema_params)
    for p in state.model.parameters():
        out += [v for _, v in sorted(state.optimizer.state[p].items())]
    return out + [g["lr"] for g in state.optimizer.param_groups]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_compiled_step_matches_train_step_at_full_width(cuda, dtype):
    """Trainer.compiled_step (a CUDA graph of the whole step, captured at its
    first call, replayed after) against train_step at full width, batch 8,
    64x64, 8 then 4 then 8 bands (two graphs of one pool), the lr warm-up
    and the EMA's copy phase ending inside: the losses, norms and every
    state tensor bit for bit after each step (the bar: one program of the
    same kernels on the same inputs, so no difference is expected)."""
    eager, compiled = _full_width_trainer(cuda, dtype), _full_width_trainer(cuda, dtype)
    s_e, s_c = eager.init_state(), compiled.init_state()
    step = compiled.compiled_step()
    prompt = torch.randn(768, device=cuda, generator=torch.Generator(cuda).manual_seed(1))
    for i, bands in enumerate((8, 4, 8, 4)):
        batch = _full_width_batch(cuda, i, bands)
        _, m_e = eager.train_step(s_e, batch, prompt)
        _, m_c = step(s_c, batch, prompt)
        assert torch.equal(m_e["l_pix"], m_c["l_pix"]), i
        assert torch.equal(m_e["grad_norm"], m_c["grad_norm"]), i
        a, b = _train_state_tensors(s_e), _train_state_tensors(s_c)
        assert all(torch.equal(x, y) for x, y in zip(a, b)), i
    assert len(compiled.capture_seconds()) == 2  # one graph a band count
    compiled.release_compiled()


def test_replay_draws_its_steps_numbers(cuda):
    """A replay at step k draws step k's t, noise, dropout masks and CFG
    coins: after the capture at step 0, both states jump to step 7 and the
    replay's step equals train_step's at 7, bit for bit; the next step on
    the same batch (a replay at 8) gives another loss."""
    eager, compiled = _full_width_trainer(cuda, torch.float32), _full_width_trainer(
        cuda, torch.float32)
    s_e, s_c = eager.init_state(), compiled.init_state()
    step = compiled.compiled_step()
    prompt = torch.randn(768, device=cuda)
    batch = _full_width_batch(cuda, 0)
    eager.train_step(s_e, batch, prompt)
    step(s_c, batch, prompt)
    s_e.step = s_c.step = 7
    _, m_e = eager.train_step(s_e, batch, prompt)
    _, m_c = step(s_c, batch, prompt)
    assert torch.equal(m_e["l_pix"], m_c["l_pix"]) and torch.equal(m_e["grad_norm"],
                                                                   m_c["grad_norm"])
    assert all(torch.equal(x, y) for x, y in zip(_train_state_tensors(s_e),
                                                 _train_state_tensors(s_c)))
    _, m_next = step(s_c, batch, prompt)
    assert not torch.equal(m_next["l_pix"], m_c["l_pix"])
    compiled.release_compiled()


def _mesh_train_case(bands=8):
    """A seeded full-width WavBEST's weights and three global batches (8,
    `bands`, 64x64) as numpy arrays, for the mesh workers."""
    from tmdiff_tpu_torch.models.wavbest import WavBEST

    state = {k: v.numpy() for k, v in WavBEST((32, 64, 128, 256), device="cpu",
                                               seed=0).state_dict().items()}
    rng = torch.Generator().manual_seed(5)
    batches = [{"Res": (0.1 * torch.randn(8, bands, 64, 64, generator=rng)).numpy(),
                "PAN": torch.rand(8, 1, 64, 64, generator=rng).numpy(),
                "MS": torch.rand(8, bands, 64, 64, generator=rng).numpy()} for _ in range(3)]
    return state, batches, torch.randn(768, generator=rng).numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_compiled_step_on_an_nccl_mesh_matches_train_step(cuda, dtype):
    """Trainer.compiled_step on a (2, 1) NCCL world, a card a rank (each
    rank's graph holds the gradient all-reduce), against train_step from
    the same start: three steps of the full-width model, batch 8, 64x64,
    the losses, the parameters, AdamW's moments, step counts and lr and the
    EMA bit for bit on both ranks, one capture a rank (not the step-0
    gradients: after the capturing call `.grad` holds the graph's buffers,
    which the capture did not compute). Skips where fewer than two cards
    are visible."""
    import os

    import numpy as np

    from tmdiff_tpu_torch.parallel.dryrun import run_world

    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    state, batches, prompt = _mesh_train_case()
    kw = {"dtype": dtype, "channels": (32, 64, 128, 256)}
    tasks = [("train", ((2, 1), state, batches, prompt), dict(kw, compiled=True)),
             ("train", ((2, 1), state, batches, prompt), kw)]
    ranks = run_world("torch_mesh_workers:run_all", 2, (tasks,), device="cuda",
                      sys_path=[os.path.dirname(os.path.abspath(__file__))], threads=2,
                      timeout=600)
    for compiled, eager in ranks:
        assert compiled["captures"] == 1 and compiled["fresh"] == [True, False, False]
        assert compiled["losses"] == eager["losses"]
        assert (compiled["lr"], compiled["adamw_steps"]) == (eager["lr"], eager["adamw_steps"])
        for name, v in eager["params"].items():
            np.testing.assert_array_equal(compiled["params"][name], v, err_msg=name)
        np.testing.assert_array_equal(compiled["ema"], eager["ema"])
        for a, b in zip(compiled["moments"], eager["moments"]):
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(ranks[0][0]["ema"], ranks[1][0]["ema"])


def test_cli_steps_through_compiled_step_on_an_nccl_world(cuda, tmp_path):
    """The CLI on a (2, 1) NCCL world, a card a rank (parallel/dryrun.py,
    as torchrun's ranks join): -p train, 2 steps of the full-width model at
    64x64, then -p distill from its checkpoint (one phase, N = 10, 2 steps
    and its ddim validation), on data built in memory
    (tests/torch_mesh_workers.py::cli_main). Each log says every step
    replays a captured step on every rank; the checkpoints are written.
    Skips where fewer than two cards are visible."""
    import json
    import os

    from tmdiff_tpu_torch.parallel.dryrun import run_world

    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    synthetic = {"QB": (4, 4, 64), "GF2": (4, 4, 64), "WV3": (8, 4, 64)}
    logs = {}
    for phase in ("train", "distill"):
        root = tmp_path / phase
        cfg = {"name": phase, "path": {"log": "logs", "results": "results",
                                       "checkpoint": "checkpoint", "experiments_root": str(root),
                                       "resume": str(tmp_path / "train" / "checkpoint")
                                       if phase == "distill" else None},
               "datasets": {name: {"dataroot": "in memory", "data_len": -1} for name in (
                   "train_qb", "train_gf2", "train_wv3", "val_QB", "val_GF2", "val_WV3")},
               "model": {"beta_schedule": {"train": {"schedule": "cosine", "n_timestep": 1000},
                                           "val": {"schedule": "cosine", "n_timestep": 1000}},
                         "unet": {"channel_multiplier": None},
                         "diffusion": {"loss_type": "l1"}},
               "train": {"max_iter": 2, "val_freq": 1000, "print_freq": 1,
                         "distill": {"phases": [10], "steps_per_phase": 2}},
               "val_max_images": 1, "val_batch_size": 1}
        path = tmp_path / f"{phase}.json"
        path.write_text(json.dumps(cfg))
        run_world("torch_mesh_workers:cli_main", 2,
                  (["-c", str(path), "-p", phase, "--sampler", "regression"], False, synthetic),
                  device="cuda", sys_path=[os.path.dirname(os.path.abspath(__file__))],
                  threads=2, timeout=600)
        logs[phase] = (root / "logs" / "train.log").read_text()
    for log in logs.values():
        assert ("mesh of 2 ranks: each step runs compiled_step (a captured step on every rank, "
                "its collectives inside the graph)") in log
    assert os.path.isdir(tmp_path / "train" / "checkpoint" / "I2")
    assert os.path.isdir(tmp_path / "distill" / "checkpoint" / "distill_N10")


def test_compiled_step_refuses_a_gloo_mesh_on_the_card(cuda):
    """A (1, 2) gloo world on card 0 (its collectives staged through host
    memory): compiled_step raises, naming NCCL and train_step, and the
    CLI's loop steps through train_step."""
    import os

    from tmdiff_tpu_torch.parallel.dryrun import run_world

    ranks = run_world("torch_mesh_workers:compiled_refusal", 2, ((1, 2),), device="cuda:0",
                      backend="gloo", sys_path=[os.path.dirname(os.path.abspath(__file__))],
                      threads=2, timeout=300)
    for message, loop_is_train_step in ranks:
        assert message is not None and "needs NCCL" in message and "train_step" in message
        assert loop_is_train_step


def test_device_feeder_on_a_side_stream(cuda):
    """Pinned host copies on the feeder's side stream: items arrive on the
    card, in order and whole, while the consumer's stream is busy, and the
    source's last item is not lost."""
    import numpy as np

    from tmdiff_tpu_torch.runtime.prefetch import DeviceFeeder

    items = [({"Res": np.full((256, 1024), i, np.float32)}, i) for i in range(6)]
    feeder = DeviceFeeder(iter(items), device=cuda, depth=2)
    assert feeder._stream is not None
    busy = torch.randn(4096, 4096, device=cuda)
    seen = []
    for batch, i in feeder:
        busy = (busy @ busy).tanh_()  # keep the consumer's stream busy
        assert batch["Res"].device.type == "cuda"
        seen.append((i, batch["Res"].sum().item()))
    feeder.close()
    assert seen == [(i, float(i) * 256 * 1024) for i in range(6)]


def test_auto_lowering_refuses_gradients_on_the_card(cuda):
    from tmdiff_tpu_torch.models.wavbest import WavBEST

    model = WavBEST((8, 16, 32, 64), seed=0).use_conv_impl("auto")
    b = _card_batch(cuda, bands=4)
    t = torch.tensor([3.0, 600.0], device=cuda)
    with pytest.raises(ValueError, match='"auto" conv lowering has no backward'):
        model(b["Res"], t, b["PAN"], b["MS"], torch.randn(768, device=cuda))
    with torch.no_grad():
        assert model(b["Res"], t, b["PAN"], b["MS"], torch.randn(768, device=cuda)).isfinite().all()


def test_checkpoint_round_trip_on_the_card(cuda, tmp_path):
    """A state on the card saved and restored into a fresh one: weights,
    AdamW's moments (and their step counts, on the card: AdamW is capturable), the lr,
    the schedule and the EMA bit for bit; one more step on each gives the
    same bits."""
    from tmdiff_tpu_torch.train import checkpoint as ckpt

    batch, prompt = _card_batch(cuda), torch.randn(768, device=cuda)
    trainer = _card_trainer(cuda)
    state = trainer.init_state()
    for _ in range(2):
        trainer.train_step(state, batch, prompt)
    ckpt.save_checkpoint(str(tmp_path), state, keep=1)
    other = _card_trainer(cuda)
    fresh = other.init_state()
    ckpt.restore_checkpoint(str(tmp_path), fresh)

    def parts(s):
        opt = s.optimizer.state_dict()
        tensors = [t for _, t in sorted(s.model.state_dict().items())] + list(s.ema_params)
        for i in sorted(opt["state"]):
            tensors += [opt["state"][i][k] for k in sorted(opt["state"][i])]
        return s.step, [g["lr"] for g in opt["param_groups"]], tensors

    for _ in range(2):
        (step_a, lr_a, a), (step_b, lr_b, b) = parts(state), parts(fresh)
        assert step_a == step_b and lr_a == lr_b and len(a) == len(b)
        assert all(x.device == y.device and torch.equal(x, y) for x, y in zip(a, b))
        trainer.train_step(state, batch, prompt)
        other.train_step(fresh, batch, prompt)


# -- the fp32 weight gradient's kernel -----------------------------------------

# every distinct (H = W, Cin, Cout) of a full-width training step (batch 8,
# 64x64; the concat parts' weight gradients are their own), at 8 and 4 bands
WGRAD_STEP_SHAPES = [(8, d, h, h, cin, cout) for d in (8, 4) for h, cin, cout in (
    (64, 32, 32), (64, 32, 64), (64, 64, 64), (32, 32, 32), (32, 64, 32), (32, 64, 64),
    (32, 64, 128), (32, 128, 128), (16, 64, 64), (16, 128, 64), (16, 128, 128), (16, 128, 256),
    (16, 256, 256), (8, 128, 128), (8, 256, 128), (8, 256, 256))]
# tile edges: Cin and Cout below and past a tile, odd and tiny H and W, one
# position, a partial channel group (Cin 20) and a partial N tile (36, 132)
WGRAD_EDGE_SHAPES = [(1, 3, 5, 7, 4, 4), (2, 8, 33, 40, 96, 32), (1, 1, 1, 1, 8, 8),
                     (2, 4, 2, 2, 64, 256), (1, 5, 17, 19, 20, 36), (3, 2, 3, 50, 132, 132),
                     (2, 4, 31, 31, 12, 8)]
WGRAD_SEEDS = (0, 1, 2)
# The kernel against cuDNN's fp32 weight gradient (TF32 off) at the step's
# shapes, of the gradient's scale: the largest gap over WGRAD_SEEDS at any
# shape was 1.73e-5 (cuDNN's own gap to float64 sums reached 1.47e-5, the
# kernel's 3.98e-6; NVIDIA H100 80GB HBM3, 700 W), times about 3.
WGRAD_RTOL = 5e-5


def _wgrad_operands(cuda, shape, seed):
    b, d, h, w, cin, cout = shape
    g = torch.Generator(device=cuda).manual_seed(seed)
    x = torch.randn(b, d, h, w, cin, device=cuda, generator=g)
    dy = torch.randn(b, d, h, w, cout, device=cuda, generator=g)
    s = 1.0 + 0.5 * torch.randn(b, cin, device=cuda, generator=g)
    return x, dy, s


def _rel(got, ref) -> float:
    return (got.double() - ref.double()).abs().max().item() / ref.double().abs().max().item()


@pytest.mark.parametrize("shape", WGRAD_STEP_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_wgrad_kernel_matches_cudnn(cuda, shape):
    """At every weight-gradient shape of a training step, with the style:
    the kernel (one launch, the style applied in it) within WGRAD_RTOL of
    the gradient's scale of cuDNN's fp32 weight gradient of x * s, over
    WGRAD_SEEDS; both against float64 sums printed beside."""
    from tmdiff_tpu_torch.ops.cuda import conv3d as K

    worst = 0.0
    for seed in WGRAD_SEEDS:
        x, dy, s = _wgrad_operands(cuda, shape, seed)
        K.reset_launches()
        got = K.conv3d_weight_grad(x, dy, s)
        assert K.weight_grad_launches == 1 and K.weight_grad_calls == 1
        ref = K.weight_grad_library(x, dy, s)
        f64 = K.conv3d_weight_grad_plain(x.double(), dy.double(), s.double())
        gap = _rel(got, ref)
        print(f"{shape} seed {seed}: kernel - cuDNN {gap:.3g}, kernel - fp64 "
              f"{_rel(got, f64):.3g}, cuDNN - fp64 {_rel(ref, f64):.3g} of scale")
        worst = max(worst, gap)
    assert worst <= WGRAD_RTOL


@pytest.mark.parametrize("shape", WGRAD_EDGE_SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("style", [False, True], ids=["plain", "style"])
def test_wgrad_kernel_at_tile_edges(cuda, shape, style):
    """At tile edges the kernel against float64 sums of its plain version,
    to 1e-4 of the gradient's scale (K1's bar against its plain version)."""
    from tmdiff_tpu_torch.ops.cuda import conv3d as K

    x, dy, s = _wgrad_operands(cuda, shape, seed=4)
    s = s if style else None
    K.reset_launches()
    got = K.conv3d_weight_grad(x, dy, s)
    assert K.weight_grad_launches == 1
    ref = K.conv3d_weight_grad_plain(x.double(), dy.double(), None if s is None else s.double())
    assert _rel(got, ref) <= 1e-4


def _wgrad_split(K, x, dy, s, splits):
    """dW through the kernel's C entry with `splits` asked of its plan."""
    import ctypes

    b, d, h, w, cin = x.shape
    cout = dy.shape[-1]
    lib = K.library()
    nbytes, count = ctypes.c_longlong(0), ctypes.c_int(splits)
    assert lib.tmdiff_wgrad_plan(b, d, h, w, cin, cout, x.data_ptr(), dy.data_ptr(),
                                 ctypes.byref(nbytes), ctypes.byref(count)) == 1
    ws = torch.empty(max(nbytes.value, 1), dtype=torch.uint8, device=x.device)
    dw = torch.empty(3, 3, 3, cin, cout, device=x.device)
    err = lib.tmdiff_wgrad_333(x.data_ptr(), s.data_ptr(), dy.data_ptr(), dw.data_ptr(), b, d, h,
                               w, cin, cout, count.value, ws.data_ptr(),
                               torch.cuda.current_stream().cuda_stream)
    assert err == 0
    return dw, count.value


def test_wgrad_kernel_split_counts(cuda):
    """One shape at split counts 1 to one a stage: each against float64
    sums, within WGRAD_RTOL of scale (printed: a split of many stages adds
    its accumulation chains in fp32); the plan's own count is the
    wrapper's."""
    from tmdiff_tpu_torch.ops.cuda import conv3d as K

    x, dy, s = _wgrad_operands(cuda, (2, 8, 32, 32, 64, 64), seed=6)
    ref = K.conv3d_weight_grad_plain(x.double(), dy.double(), s.double())
    errs = {}
    for want in (1, 2, 7, 64, 10**6):
        dw, got = _wgrad_split(K, x, dy, s, want)
        errs[got] = _rel(dw, ref)
    print(f"weight gradient error by split count {errs}")
    assert max(errs.values()) <= WGRAD_RTOL and 2 * 8 * 16 * 2 in errs
    planned, _ = K.wgrad_plan(x, dy)
    assert torch.equal(_wgrad_split(K, x, dy, s, planned)[0], K.conv3d_weight_grad(x, dy, s))


@pytest.mark.parametrize("shape", [(8, 8, 64, 64, 32, 32), (8, 4, 8, 8, 256, 256),
                                   (2, 8, 33, 40, 96, 32)], ids=lambda s: "x".join(map(str, s)))
def test_wgrad_kernel_is_deterministic_and_takes_the_style(cuda, shape):
    """Two launches on one input agree bit for bit (the splits' partial sums
    are added in split order, no atomics), and the style applied in the
    kernel equals the kernel on x * s bit for bit (the same fp32 product)."""
    from tmdiff_tpu_torch.ops.cuda import conv3d as K

    x, dy, s = _wgrad_operands(cuda, shape, seed=8)
    K.reset_launches()
    a, b = K.conv3d_weight_grad(x, dy, s), K.conv3d_weight_grad(x, dy, s)
    c = K.conv3d_weight_grad(x * s[:, None, None, None, :], dy)
    assert K.weight_grad_launches == 3
    assert torch.equal(a, b) and torch.equal(a, c)


@pytest.mark.parametrize("bands", [8, 4])
def test_fp32_step_takes_every_weight_gradient_on_the_kernel(cuda, bands):
    """A full-width fp32 training step at batch 8, 64x64 (the train-joint
    cell's): its 65 weight gradients all launch the kernel, none goes to
    cuDNN."""
    from tmdiff_tpu_torch.ops.cuda import conv3d as K

    trainer = _full_width_trainer(cuda, torch.float32)
    state = trainer.init_state()
    K.reset_launches()
    trainer.train_step(state, _full_width_batch(cuda, 1, bands), torch.zeros(768, device=cuda))
    torch.cuda.synchronize()
    assert K.weight_grad_launches == 65 and K.weight_grad_calls == 65


# -- the bf16 instances (K1/K2 with KD = 3, K3 with KD = 1) --------------------

# Held against their plain versions: every element within half a bf16 step
# of the kernel's value and of the plain value (two roundings to bf16 of
# fp32 sums taken in another order may land one step apart), plus 1e-4 of the
# output's scale, the fp32 kernel's bar, for the tensor cores' fp32
# accumulation (it cannot move a large element by a step, only a small one).
BF16_ACC_RTOL = 1e-4


def bf16_half_step(a):
    """Half the spacing of bf16 values at |a|: one rounding's largest error."""
    a = a.float().abs()
    e = torch.floor(torch.log2(torch.where(a > 0, a, torch.ones_like(a))))
    return torch.where(a > 0, torch.exp2(e - 8), torch.zeros_like(a))


def assert_bf16_close(got, ref, what=""):
    assert got.dtype == ref.dtype == torch.bfloat16, (got.dtype, ref.dtype)
    torch.cuda.synchronize()
    scale = ref.float().abs().max().item()
    bar = bf16_half_step(got) + bf16_half_step(ref) + BF16_ACC_RTOL * scale
    over = (got.float() - ref.float()).abs() > bar
    assert not over.any().item(), f"{what}: {int(over.sum())} elements beyond one bf16 step"


def _full_width_bf16_shapes(cuda, impl):
    """{(wrapper name, x shape + (Cout,), flags)} of every conv launch of one
    encode + one denoise of the full-width bf16 WavBEST at 256x256, batch 2,
    8 and 4 bands, under `impl`."""
    from tmdiff_tpu_torch.models.wavbest import WavBEST
    from tmdiff_tpu_torch.ops import modconv

    model = WavBEST((32, 64, 128, 256), seed=0, dtype=torch.bfloat16).use_conv_impl(impl)
    seen = set()
    originals = {n: getattr(modconv, n) for n in ("banded_conv3d", "conv3x3_nhwc")}

    def recorder(name):
        def rec(x, kernel, *rest, **kw):
            seen.add((name, tuple(x.shape) + (kernel.shape[-1],),
                      tuple(a is not None for a in rest)))
            return originals[name](x, kernel, *rest, **kw)
        return rec

    g = torch.Generator(device=cuda).manual_seed(3)
    try:
        for n in originals:
            setattr(modconv, n, recorder(n))
        with torch.no_grad():
            for bands in (8, 4):
                pan = torch.rand(2, 1, 256, 256, device=cuda, generator=g)
                ms = torch.rand(2, bands, 256, 256, device=cuda, generator=g)
                cache = model.encode_condition(pan, ms, torch.randn(768, device=cuda, generator=g))
                model.denoise(torch.randn(2, bands, 256, 256, device=cuda, generator=g),
                              torch.full((2,), 500.0, device=cuda), cache)
    finally:
        for n, fn in originals.items():
            setattr(modconv, n, fn)
    return seen


@pytest.mark.parametrize("impl", ["banded", "auto"])
def test_bf16_instances_match_plain_at_the_path_shapes(cuda, impl):
    """Every bf16 conv shape (with its options) of the full-width bf16 model
    under each lowering: the wrapper launches a bf16 instance (by variant
    and dtype counters) and agrees with the plain bf16 version within one
    bf16 step; with all options (style, bias, accumulation) too."""
    from tmdiff_tpu_torch.ops.cuda import conv2d as K3
    from tmdiff_tpu_torch.ops.cuda import conv3d as K

    shapes = _full_width_bf16_shapes(cuda, impl)
    assert {n for n, _, _ in shapes} == ({"banded_conv3d"} if impl == "banded"
                                         else {"banded_conv3d", "conv3x3_nhwc"})
    g = torch.Generator(device=cuda).manual_seed(0)
    for name, shape, flags in sorted(shapes):
        mod = K if name == "banded_conv3d" else K3
        *xs, cin, cout = shape
        x = torch.randn(*xs, cin, device=cuda, generator=g).bfloat16()
        taps = (3, 3, 3) if mod is K else (3, 3)
        k = (torch.randn(*taps, cin, cout, device=cuda, generator=g) / (27 * cin) ** 0.5).bfloat16()
        s = (1 + 0.5 * torch.randn(xs[0], cin, device=cuda, generator=g)).bfloat16()
        bias = torch.randn(cout, device=cuda, generator=g).bfloat16()
        out = torch.randn(*xs, cout, device=cuda, generator=g).bfloat16()
        everything = (True,) * len(flags)
        for given in (flags, everything):  # the path's options, then all of them
            opts = [t if f else None for t, f in zip((s, bias, out), given)]
            fresh = lambda: [t.clone() if t is out else t for t in opts]
            with torch.no_grad():
                mod.reset_launches()
                got = getattr(mod, name)(x, k, *fresh())
                plain = (K.conv3d_plain if mod is K else K3.conv3x3_nhwc_plain)(x, k, *fresh())
            variants = {v for v, n in mod.variant_launches.items() if n}
            assert variants <= {"bf16", "bf16_splitk"} and mod.dtype_launches == {
                "float32": 0, "bfloat16": 1}, (name, shape, variants)
            assert_bf16_close(got, plain, f"{name} {shape} {variants}")


@pytest.mark.parametrize("shape", [
    (2, 8, 16, 16, 8, 32), (1, 3, 5, 7, 24, 5), (2, 4, 2, 2, 64, 256), (2, 8, 33, 40, 96, 33),
    (1, 1, 1, 1, 8, 8), (2, 4, 32, 32, 256, 128), (2, 8, 20, 24, 40, 33),
    (1, 4, 9, 17, 72, 130), (2, 3, 18, 35, 72, 17), (1, 5, 12, 20, 24, 100),
    (2, 6, 11, 19, 200, 70),
])
@pytest.mark.parametrize("splits", [None, 1, 3])
def test_bf16_kernel_off_the_tile_and_split(cuda, shape, splits):
    """The bf16 K1 instance with style, bias and accumulation at ragged
    shapes (Cin not a multiple of the channel step of 32 or 64, odd Cout
    or Cout off the N tile, a window over a 2x2 or 1x1 image), on every
    (BN, channel step) instance, with the plan's split count and forced
    ones; within one bf16 step."""
    from tmdiff_tpu_torch.ops.cuda import conv3d as K

    x, k, s, bias, out = (t.bfloat16() for t in _random_conv(cuda, shape))
    with forced_splits(K, splits) if splits else contextlib.nullcontext(), torch.no_grad():
        got = K.banded_conv3d_v2(x, k, s, bias, out.clone())
    assert_bf16_close(got, K.conv3d_plain(x, k, s, bias, out.clone()), f"{shape} splits={splits}")


@pytest.mark.parametrize("shape", [
    (2, 256, 256, 256, 256), (1, 17, 30, 40, 33), (2, 9, 21, 72, 130), (1, 33, 18, 24, 17),
    (2, 64, 64, 512, 256), (1, 1, 1, 8, 8), (2, 40, 23, 96, 64),
])
@pytest.mark.parametrize("splits", [None, 1, 3])
def test_bf16_conv3x3_nhwc_off_the_tile_and_split(cuda, shape, splits):
    """The bf16 K3 instance (one depth tap) with style and bias at the
    path's widest shape and at ragged ones (H and W off the 16 x 16 tile,
    Cin not a multiple of the channel step, odd Cout or Cout off the N
    tile), with the plan's split count and forced ones; within one bf16
    step of its plain version."""
    from tmdiff_tpu_torch.ops.cuda import conv2d as K3
    from tmdiff_tpu_torch.ops.cuda import conv3d as K

    b, h, w, cin, cout = shape
    g = torch.Generator(device=cuda).manual_seed(4)
    x = torch.randn(b, h, w, cin, device=cuda, generator=g).bfloat16()
    k = (torch.randn(3, 3, cin, cout, device=cuda, generator=g) / (9 * cin) ** 0.5).bfloat16()
    s = (1 + 0.5 * torch.randn(b, cin, device=cuda, generator=g)).bfloat16()
    bias = torch.randn(cout, device=cuda, generator=g).bfloat16()
    for opts in ((s, bias), (None, None)):
        with forced_splits(K, splits) if splits else contextlib.nullcontext(), torch.no_grad():
            K3.reset_launches()
            got = K3.conv3x3_nhwc(x, k, *opts)
        assert K3.dtype_launches == {"float32": 0, "bfloat16": 1}
        assert_bf16_close(got, K3.conv3x3_nhwc_plain(x, k, *opts),
                          f"{shape} splits={splits} styled={opts[0] is not None}")


def test_bf16_refusals(cuda):
    """No bf16 instance for Cin % 8 != 0: the wrapper raises instead of
    taking an fp32 kernel or the plain version; one launch takes one dtype;
    under a gradient the input gradient of a conv whose Cout % 8 != 0 (its
    Cin) raises the same way, after a forward on the bf16 instance."""
    from tmdiff_tpu_torch.ops.cuda import conv2d as K3
    from tmdiff_tpu_torch.ops.cuda import conv3d as K

    x = torch.randn(1, 4, 8, 8, 4, device=cuda).bfloat16()
    k = torch.randn(3, 3, 3, 4, 8, device=cuda).bfloat16()
    K.reset_launches()
    with pytest.raises(ValueError, match="Cin % 8"):
        K.banded_conv3d(x, k)
    with pytest.raises(ValueError, match="Cin % 8"):
        K3.conv3x3_nhwc(x[:, 0], k[0])
    assert K.launches == 0
    x8 = torch.randn(1, 4, 8, 8, 8, device=cuda).bfloat16()
    with pytest.raises(TypeError, match="one dtype"):
        K.banded_conv3d(x8, torch.randn(3, 3, 3, 8, 8, device=cuda))
    y = K.banded_conv3d(x8.requires_grad_(), torch.randn(3, 3, 3, 8, 4, device=cuda).bfloat16())
    assert K.dtype_launches == {"float32": 0, "bfloat16": 1}
    with pytest.raises(ValueError, match="Cin % 8"):
        y.float().sum().backward()
    assert K.launches == 1


def test_bf16_model_runs_on_bf16_instances(cuda):
    """A bf16 WavBEST on the card: every 3x3x3 conv of a forward is a bf16
    launch under both lowerings, the output is float32, and it is within
    5e-2 of the output's scale of the fp32 model on the same weights."""
    from tmdiff_tpu_torch.models.wavbest import WavBEST
    from tmdiff_tpu_torch.ops.cuda import conv2d as K3
    from tmdiff_tpu_torch.ops.cuda import conv3d as K

    fp32 = WavBEST((16, 32, 64, 128), seed=0)
    bf16 = WavBEST((16, 32, 64, 128), seed=0, dtype=torch.bfloat16)
    g = torch.Generator(device=cuda).manual_seed(1)
    args = (torch.randn(2, 8, 64, 64, device=cuda, generator=g), torch.tensor([3.0, 600.0],
                                                                               device=cuda),
            torch.rand(2, 1, 64, 64, device=cuda, generator=g),
            torch.rand(2, 8, 64, 64, device=cuda, generator=g),
            torch.randn(768, device=cuda, generator=g))
    with torch.no_grad():
        ref = fp32(*args)
        for impl in ("banded", "auto"):
            K.reset_launches()
            K3.reset_launches()
            y = bf16.use_conv_impl(impl)(*args)
            assert y.dtype == torch.float32
            assert K.dtype_launches["bfloat16"] + K3.dtype_launches["bfloat16"] == 13 + 52
            assert K.dtype_launches["float32"] == K3.dtype_launches["float32"] == 0
            assert (y - ref).abs().max().item() <= 5e-2 * ref.abs().max().item()


# -- bf16 training: K1's bf16 instance as its own input gradient ---------------

# (B, D, H, W, Cin, Cout) of forward convs: the full-width WavBEST's training
# step (batch 8, 64x64, 8 and 4 bands; a decoder concat part takes Cin of
# one part) and the legacy UNet's ResBlocks at 256x256 (H = 256, 127, 63, 31
# after the VALID stride-2 convs; decoder parts of 256, 128 and 64 channels)
BF16_TRAIN_SHAPES = [
    (8, 8, 64, 64, 32, 32), (8, 4, 64, 64, 32, 64), (8, 8, 32, 32, 64, 128),
    (8, 8, 16, 16, 128, 256), (8, 8, 8, 8, 256, 256), (8, 8, 8, 8, 256, 128),
    (8, 4, 16, 16, 128, 64), (8, 8, 32, 32, 64, 32),
]
BF16_LEGACY_SHAPES = [
    (2, 8, 256, 256, 32, 32), (2, 8, 256, 256, 32, 64), (2, 8, 127, 127, 64, 128),
    (2, 8, 127, 127, 128, 128), (2, 8, 63, 63, 128, 256), (2, 8, 31, 31, 256, 256),
    (2, 8, 31, 31, 256, 128), (2, 8, 63, 63, 128, 64), (2, 8, 127, 127, 64, 32),
]


# cuDNN's bf16 weight gradient is not one rounding of the fp32 sum at every
# element: at (2, 8, 256, 256, 32, 64) 11 near-zero elements lay beyond one
# bf16 step + 1e-4 of scale of the fp32 sums (this test's first card run,
# NVIDIA H100 80GB HBM3, 700 W); the drift grows with the sum's length
# (chip_smoke.py's "[controlnet] bf16" line prints it at batch 8)
BF16_WEIGHT_GRAD_RTOL = 2e-4


@pytest.mark.parametrize("shape", BF16_TRAIN_SHAPES + BF16_LEGACY_SHAPES)
def test_bf16_gradients_match_plain(cuda, shape):
    """At each training and legacy shape, the bf16 conv's backward through
    Conv3dFunction (style and bias): d(x s) is K1's bf16 instance on dy with
    the flipped, transposed kernel, within one bf16 step of its plain
    version; dx is that times s, bit for bit; dW is the bf16 weight gradient
    of bf16(x s), within one bf16 step (plus BF16_WEIGHT_GRAD_RTOL of scale)
    of the fp32 sums of the same bf16 operands, and what the Function
    returns, bit for bit."""
    from tmdiff_tpu_torch.ops.cuda import conv3d as K

    x, k, s, bias, _ = (t.bfloat16() for t in _random_conv(cuda, shape, seed=5))
    s = (1 + 0.5 * s.float()).bfloat16()
    dy = torch.randn(x.shape[:-1] + (k.shape[-1],), device=cuda).bfloat16()
    xg, kg, sg = (t.clone().requires_grad_() for t in (x, k, s))
    K.reset_launches()
    K.banded_conv3d(xg, kg, sg, bias).backward(dy)
    assert K.dtype_launches == {"float32": 0, "bfloat16": 2} and K.input_grad_launches == 1
    assert K.weight_grad_calls == 1
    flipped = k.flip((0, 1, 2)).transpose(3, 4).contiguous()
    with torch.no_grad():
        dxs = K._launch(dy, flipped, None, None, None, True)
        assert_bf16_close(dxs, K.conv3d_plain(dy, flipped), f"input gradient {shape}")
        assert torch.equal(xg.grad, dxs * s[:, None, None, None, :])
        xs = x * s[:, None, None, None, :]
        dw = K.conv3d_weight_grad(xs, dy)
        ref = K.conv3d_weight_grad(xs.float(), dy.float())
    assert dw.dtype == torch.bfloat16 and torch.equal(kg.grad, dw)
    over = ((dw.float() - ref).abs()
            > 2 * bf16_half_step(ref) + BF16_WEIGHT_GRAD_RTOL * ref.abs().max())
    assert not over.any().item(), f"{shape}: {int(over.sum())} weight-gradient elements"


def test_bf16_concat_parts_gradients(cuda):
    """The legacy decoder's three-part conv (3 x 256 -> 128 at 31x31) under
    a gradient in bf16: each part's gradient is K1's bf16 input gradient
    with its slice of the kernel, each slice's gradient that part's bf16
    weight gradient, bit for bit; every launch a bf16 one."""
    from tmdiff_tpu_torch.ops import modconv
    from tmdiff_tpu_torch.ops.cuda import conv3d as K

    g = torch.Generator(device=cuda).manual_seed(6)
    parts = [torch.randn(2, 8, 31, 31, 256, device=cuda, generator=g).bfloat16().requires_grad_()
             for _ in range(3)]
    k = (torch.randn(3, 3, 3, 768, 128, device=cuda, generator=g) / 144.0).requires_grad_()
    bias = torch.randn(128, device=cuda, generator=g).requires_grad_()
    dy = torch.randn(2, 8, 31, 31, 128, device=cuda, generator=g).bfloat16()
    K.reset_launches()
    y = modconv.conv3d_cat(tuple(parts), k.bfloat16(), bias=bias.bfloat16())
    assert y.dtype == torch.bfloat16
    y.backward(dy)
    assert K.dtype_launches == {"float32": 0, "bfloat16": 6} and K.weight_grad_calls == 3
    with torch.no_grad():
        kb = k.bfloat16()
        for i, p in enumerate(parts):
            ki = kb[..., 256 * i:256 * (i + 1), :]
            dxi = K._launch(dy, ki.flip((0, 1, 2)).transpose(3, 4).contiguous(), None, None,
                            None, True)
            assert torch.equal(p.grad, dxi), i
            assert torch.equal(k.grad[..., 256 * i:256 * (i + 1), :],
                               K.conv3d_weight_grad(p.detach(), dy).float()), i


def test_bf16_training_step_launches_no_fp32_kernel(cuda):
    """Two steps of a bf16 WavBEST (8, 16, 32, 64) through Trainer.train_step
    (remat, dropout on), 8 bands, batch 2, 32x32: 130 bf16 K1 forward and 65
    input-gradient launches and 65 weight gradients a step, no fp32 launch,
    every launch on a bf16 variant; finite losses; parameters, AdamW moments
    and EMA float32."""
    from tmdiff_tpu_torch.diffusion.schedules import NoiseSchedule
    from tmdiff_tpu_torch.models.wavbest import WavBEST
    from tmdiff_tpu_torch.ops.cuda import conv3d as K
    from tmdiff_tpu_torch.train.trainer import Trainer

    trainer = Trainer(WavBEST((8, 16, 32, 64), seed=0, dtype=torch.bfloat16),
                      NoiseSchedule.create("cosine", 1000), lr=1e-3, warmup_steps=1)
    state = trainer.init_state()
    K.reset_launches()
    losses = [float(trainer.train_step(state, _card_batch(cuda), torch.zeros(768))[1]["l_pix"])
              for _ in range(2)]
    torch.cuda.synchronize()
    assert all(map(math.isfinite, losses))
    assert K.dtype_launches == {"float32": 0, "bfloat16": 2 * 195}
    assert K.input_grad_launches == 2 * 65 and K.weight_grad_calls == 2 * 65
    assert K.weight_grad_launches == 0  # bf16 weight gradients stay on cuDNN
    assert {v for v, n in K.variant_launches.items() if n} <= {"bf16", "bf16_splitk"}
    moments = [v for st in state.optimizer.state.values() for key, v in st.items()
               if key != "step"]
    assert all(t.dtype == torch.float32 for t in
               [*trainer.model.parameters(), *state.ema_params, *moments])


def test_bf16_input_gradient_at_the_mesh_shard_shapes(cuda):
    """Every distinct bf16 K1 input-gradient launch of a (2, 2) bf16
    training step of the full-width WavBEST (channels 32-256, 8 bands,
    batch 8, 64x64; four gloo ranks sharing card 0, recorded from the step
    by tests/torch_mesh_workers.py::bf16_step_shapes): each shard's dy has
    H_l + 2 rows (its halo), and K1 on it, launched as the step launches it
    (`input_grad`, the unsharded call's (B, H)), is within one bf16 step of
    its plain bf16 version, on a bf16 tensor-core variant, with the split
    count of the unsharded call's plan."""
    import os

    from tmdiff_tpu_torch.ops.cuda import conv3d as K
    from tmdiff_tpu_torch.parallel.dryrun import run_world

    tests = os.path.dirname(os.path.abspath(__file__))
    ranks = run_world("torch_mesh_workers:bf16_step_shapes", 4,
                      ((2, 2), (32, 64, 128, 256), 8, 8, 64), device="cuda:0", backend="gloo",
                      sys_path=[tests], threads=2, timeout=600)
    shapes = sorted({s for r in ranks for s in r}, key=repr)
    heights = sorted({shape[2] for shape, _, _ in shapes})
    assert heights == [6, 10, 18, 34], heights  # 64, 32, 16, 8 rows over two ranks, + 2
    g = torch.Generator(device=cuda).manual_seed(7)
    for shape, cout, unsharded in shapes:
        b, d, h, w, cin = shape
        assert unsharded == (8, 2 * (h - 2)) and b == 4, (shape, unsharded)
        dy = torch.randn(shape, device=cuda, generator=g).bfloat16()
        k = (torch.randn(3, 3, 3, cin, cout, device=cuda, generator=g) / (27 * cin) ** 0.5)
        k = k.bfloat16()
        K.reset_launches()
        with torch.no_grad():
            got = K._launch(dy, k, None, None, None, True, unsharded)
        assert K.dtype_launches == {"float32": 0, "bfloat16": 1} and K.input_grad_launches == 1
        assert {v for v, n in K.variant_launches.items() if n} <= {"bf16", "bf16_splitk"}
        assert_bf16_close(got, K.conv3d_plain(dy, k), f"input gradient {shape} -> {cout}")
        whole = torch.empty((unsharded[0], d, unsharded[1], w, cin), device=cuda,
                            dtype=torch.bfloat16)
        assert K.plan(3, dy, d, cout, unsharded=unsharded)[1] == K.plan(3, whole, d, cout)[1]


# -- bf16: K1's fused pre-activation ---------------------------------------


def _preact_path_launches(cuda):
    """{(x shape, Cout, (style, bias, out given), shift given, act)} of the
    K1 calls of one encode_condition + denoise_deep + denoise_reuse (level
    3, ddim_cached's) of the full-width bf16 WavBEST at 256x256, batch 2,
    8 bands (serve-quality's) and 4 bands (serve-lowlatency's)."""
    from tmdiff_tpu_torch.models.wavbest import WavBEST
    from tmdiff_tpu_torch.ops import modconv

    model = WavBEST((32, 64, 128, 256), seed=0, dtype=torch.bfloat16)
    seen, original = set(), modconv.banded_conv3d

    def rec(x, kernel, *rest, shift=None, act=None, **kw):
        seen.add((tuple(x.shape), kernel.shape[-1], tuple(a is not None for a in rest),
                  shift is not None, act))
        return original(x, kernel, *rest, shift=shift, act=act, **kw)

    g = torch.Generator(device=cuda).manual_seed(11)
    modconv.banded_conv3d = rec
    try:
        with torch.no_grad():
            for bands in (8, 4):
                shape = (2, bands, 256, 256)
                cache = model.encode_condition(
                    torch.rand(2, 1, 256, 256, device=cuda, generator=g),
                    torch.rand(shape, device=cuda, generator=g),
                    torch.randn(768, device=cuda, generator=g))
                x = torch.randn(shape, device=cuda, generator=g)
                t = torch.full((2,), 500.0, device=cuda)
                _, deep = model.denoise_deep(x, t, cache, cache_level=3)
                model.denoise_reuse(x, t - 25, cache, deep, cache_level=3)
    finally:
        modconv.banded_conv3d = original
    return seen


def assert_within_one_bf16_step(got, ref, what=""):
    """`got` within one bf16 step of the output (the spacing at the largest
    |ref|) of `ref`: the fused SiLU (the MUFU's ex2 and rcp) rounds a rare
    operand element one bf16 step from F.silu's (test_bf16_preact_operand),
    which moves an output by a weight times that step."""
    assert got.dtype == ref.dtype == torch.bfloat16, (got.dtype, ref.dtype)
    torch.cuda.synchronize()
    step = 2 * bf16_half_step(ref.float().abs().max())
    over = (got.float() - ref.float()).abs() > step
    assert not over.any().item(), f"{what}: {int(over.sum())} elements beyond one bf16 step"


@pytest.mark.parametrize("shape", [(2, 3, 9, 17, 40), (1, 8, 64, 64, 64)])
def test_bf16_preact_operand(cuda, shape):
    """The fused operand itself: K1 with a one-tap identity kernel (Cout =
    Cin, W[tap] = I) returns its staged operand a = bf16(bf16(silu(bf16(x +
    shift))) * s), shifted by the tap. At each of the 27 taps, every element
    within one bf16 step (the spacing at |a|) of the same ops in PyTorch,
    and exactly 0 where the tap reads the SAME padding (a large positive
    shift, so silu(0 + shift) would show there); over all taps at most one
    element in a thousand a step apart. With x spread over [-80, 80] the
    SiLU's whole range, its tails included, is read."""
    from tmdiff_tpu_torch.ops.cuda import conv3d as K

    b, d, h, w, c = shape
    g = torch.Generator(device=cuda).manual_seed(15)
    x = (torch.randn(shape, device=cuda, generator=g) * 3).bfloat16()
    x.view(-1)[: x.numel() // 8] = torch.linspace(-80, 80, x.numel() // 8, device=cuda)
    shift = (2 + torch.rand(b, c, device=cuda, generator=g)).bfloat16()
    s = (1 + 0.5 * torch.randn(b, c, device=cuda, generator=g)).bfloat16()
    a = K.preact(x, shift, "silu") * s[:, None, None, None, :]
    ap = torch.nn.functional.pad(a.float(), (0, 0, 1, 1, 1, 1, 1, 1))
    inside = torch.nn.functional.pad(torch.ones(shape, device=cuda), (0, 0, 1, 1, 1, 1, 1, 1))
    off = 0
    for tap in range(27):
        i, j, k = tap // 9, tap // 3 % 3, tap % 3
        kern = torch.zeros(3, 3, 3, c, c, device=cuda, dtype=torch.bfloat16)
        kern[i, j, k] = torch.eye(c, device=cuda)
        with torch.no_grad():
            got = K.banded_conv3d(x, kern, s, shift=shift, act="silu").float()
        ref = ap[:, i:i + d, j:j + h, k:k + w]
        pad = inside[:, i:i + d, j:j + h, k:k + w] == 0
        assert torch.equal(got[pad], torch.zeros_like(got[pad])), tap
        diff = (got - ref).abs()
        assert not (diff > 2 * bf16_half_step(ref)).any().item(), tap
        off += int((diff > 0).sum())
    assert off <= 1e-3 * 27 * x.numel(), off


def _preact_case(cuda, shape, seed, shift_loc=0.0):
    x, k, s, bias, out = (t.bfloat16() for t in _random_conv(cuda, shape, seed))
    g = torch.Generator(device=cuda).manual_seed(seed + 100)
    shift = (shift_loc + torch.randn(shape[0], shape[4], device=cuda, generator=g)).bfloat16()
    return x, k, (1 + 0.5 * s.float()).bfloat16(), bias, out, shift


def _fused_and_unfused(K, x, k, opts, shift, act):
    """K1 with the pre-activation in its launch, and K1 after PyTorch's
    ops (K.preact): the same launch on the same operand."""
    fresh = lambda: [t.clone() if i == 2 and t is not None else t for i, t in enumerate(opts)]
    with torch.no_grad():
        K.reset_launches()
        got = K.banded_conv3d(x, k, *fresh(), shift=shift, act=act)
        assert (K.preact_fused, K.preact_unfused, K.launches) == (1, 0, 1)
        ref = K.banded_conv3d(K.preact(x, shift, act), k, *fresh())
        assert (K.preact_fused, K.preact_unfused, K.launches) == (1, 1, 2)
    assert {v for v, n in K.variant_launches.items() if n} <= {"bf16", "bf16_splitk"}
    return got, ref


def test_bf16_preact_at_the_serving_shapes(cuda):
    """Every K1 call (shape, options, pre-activation) of a batch of either
    serve cell's block-cached calls, at batch 2 and 8: the fused launch
    within one bf16 step of the output of the same launch after PyTorch's
    add and SiLU, and the conv with every option besides (style, bias,
    accumulation)."""
    from tmdiff_tpu_torch.ops.cuda import conv3d as K

    launches = _preact_path_launches(cuda)
    fused = [c for c in launches if c[4]]
    heights = sorted({shape[2] for shape, *_ in fused})
    assert heights == [32, 64, 128, 256] and len(fused) < len(launches), heights
    for i, (shape, cout, given, has_shift, act) in enumerate(sorted(fused, key=repr)):
        for b in (2, 8):
            x, k, s, bias, out, shift = _preact_case(cuda, (b, *shape[1:], cout), i)
            for opts in ([t if f else None for t, f in zip((s, bias, out), given)],
                         [s, bias, out]):
                got, ref = _fused_and_unfused(K, x, k, opts, shift if has_shift else None, act)
                assert_within_one_bf16_step(got, ref, f"{(b, *shape[1:])} -> {cout} {given}")


@pytest.mark.parametrize("shape", [
    (2, 8, 16, 16, 8, 32), (1, 3, 5, 7, 24, 5), (2, 4, 2, 2, 64, 256), (2, 8, 33, 40, 96, 33),
    (1, 1, 1, 1, 8, 8), (2, 8, 20, 24, 40, 33), (1, 4, 9, 17, 72, 130), (2, 6, 11, 19, 200, 70),
])
@pytest.mark.parametrize("splits", [None, 3])
def test_bf16_preact_off_the_tile_and_split(cuda, shape, splits):
    """Ragged shapes (a window over a 1x1 or 2x2 image, H, W and D off the
    tile, Cin off the channel step) with a large positive shift, so that
    act(0 + shift) in the padding would show at every border, on every
    (BN, channel step) instance, with the plan's split count and a forced
    split: style-free, shift-free and all options, within one bf16 step of
    the output of the same launch after PyTorch's ops."""
    from tmdiff_tpu_torch.ops.cuda import conv3d as K

    x, k, s, bias, out, shift = _preact_case(cuda, shape, 5, shift_loc=4.0)
    cases = (((None, None, None), shift, "silu"), ((s, bias, out), shift, "silu"),
             ((s, None, None), None, "silu"))
    for opts, sh, act in cases:
        with forced_splits(K, splits) if splits else contextlib.nullcontext():
            got, ref = _fused_and_unfused(K, x, k, list(opts), sh, act)
        assert_within_one_bf16_step(got, ref, f"{shape} splits={splits} {sh is not None} {act}")


def test_bf16_preact_concat_parts_accumulate(cuda):
    """A decoder conv over three concat parts (serve-quality's final block,
    3 x 32 -> 32 at 256x256) through modconv.conv3d_cat: each part's launch
    applies its own slice of the shift and accumulates into the output;
    within one bf16 step of the output of the parts after PyTorch's ops."""
    from tmdiff_tpu_torch.ops import modconv
    from tmdiff_tpu_torch.ops.cuda import conv3d as K

    g = torch.Generator(device=cuda).manual_seed(12)
    parts = tuple(torch.randn(2, 8, 256, 256, 32, device=cuda, generator=g).bfloat16()
                  for _ in range(3))
    k = torch.randn(3, 3, 3, 96, 32, device=cuda, generator=g) / (27 * 96) ** 0.5
    bias = torch.randn(32, device=cuda, generator=g)
    shift = torch.randn(2, 96, device=cuda, generator=g).bfloat16()
    with torch.no_grad():
        K.reset_launches()
        got = modconv.conv3d_cat(parts, k, bias=bias, shift=shift, act="silu")
        assert (K.preact_fused, K.preact_unfused, K.launches) == (3, 0, 3)
        ref = modconv.conv3d_cat(tuple(K.preact(p, shift[:, 32 * i:32 * (i + 1)], "silu")
                                       for i, p in enumerate(parts)), k, bias=bias)
    assert_within_one_bf16_step(got, ref, "concat parts")


def test_bf16_preact_takes_a_strided_view(cuda):
    """A decoder input cropped to its skip's grid (the legacy models'
    crop_to: a view, not contiguous) given a pre-activation: the fused
    launch takes a contiguous copy and equals the launch on one."""
    from tmdiff_tpu_torch.ops import modconv
    from tmdiff_tpu_torch.ops.cuda import conv3d as K

    g = torch.Generator(device=cuda).manual_seed(16)
    x = torch.randn(2, 8, 66, 66, 64, device=cuda, generator=g).bfloat16()[:, :, :63, :63]
    k = (torch.randn(3, 3, 3, 64, 32, device=cuda, generator=g) / (27 * 64) ** 0.5).bfloat16()
    shift = torch.randn(2, 64, device=cuda, generator=g).bfloat16()
    assert not x.is_contiguous()
    with torch.no_grad():
        K.reset_launches()
        got = modconv.conv3d(x, k, shift=shift, act="silu")
        ref = modconv.conv3d(x.contiguous(), k, shift=shift, act="silu")
    assert (K.preact_fused, K.preact_unfused, K.launches) == (2, 0, 2)
    assert torch.equal(got, ref)


def test_bf16_model_preact_fused_against_unfused(cuda):
    """The full-width bf16 WavBEST at 8 bands, batch 2, 128x128 on the same
    draws: encode_condition, denoise_deep and denoise_reuse (level 3) with
    the pre-activations fused, against the same calls with every K1 call
    given silu(x + shift) by PyTorch's ops first. Fused launches a call: 13
    of encode's 13, 43 of denoise's 52, 21 of the level-3 reuse's 24; no
    unfused one. Each output within 1e-2 of its scale of the unfused one
    (a rare operand element a bf16 step apart, test_bf16_preact_operand,
    moves the rest of the network)."""
    from tmdiff_tpu_torch.models.wavbest import WavBEST
    from tmdiff_tpu_torch.ops import modconv
    from tmdiff_tpu_torch.ops.cuda import conv3d as K

    model = WavBEST((32, 64, 128, 256), seed=0, dtype=torch.bfloat16)
    g = torch.Generator(device=cuda).manual_seed(13)
    pan = torch.rand(2, 1, 128, 128, device=cuda, generator=g)
    ms = torch.rand(2, 8, 128, 128, device=cuda, generator=g)
    prompt = torch.randn(768, device=cuda, generator=g)
    x = torch.randn(2, 8, 128, 128, device=cuda, generator=g)
    t = torch.tensor([700.0, 240.0], device=cuda)

    def calls(counts):
        with torch.no_grad():
            K.reset_launches()
            cache = model.encode_condition(pan, ms, prompt)
            counts.append((K.preact_fused, K.preact_unfused, K.launches))
            K.reset_launches()
            y, deep = model.denoise_deep(x, t, cache, cache_level=3)
            counts.append((K.preact_fused, K.preact_unfused, K.launches))
            K.reset_launches()
            z = model.denoise_reuse(x, t - 50, cache, deep, cache_level=3)
            counts.append((K.preact_fused, K.preact_unfused, K.launches))
        return cache["feats"][-1], y, z

    fused_counts, unfused_counts = [], []
    got = calls(fused_counts)
    assert fused_counts == [(13, 0, 13), (43, 0, 52), (21, 0, 24)], fused_counts
    original = modconv.banded_conv3d

    def unfused(x, kernel, *rest, shift=None, act=None, **kw):
        return original(K.preact(x, shift, act), kernel, *rest, **kw)

    modconv.banded_conv3d = unfused
    try:
        ref = calls(unfused_counts)
    finally:
        modconv.banded_conv3d = original
    assert unfused_counts == [(0, 13, 13), (0, 43, 52), (0, 21, 24)], unfused_counts
    torch.cuda.synchronize()
    for name, a, b in zip(("encode", "deep", "reuse"), got, ref):
        scale = b.float().abs().max().item()
        assert (a.float() - b.float()).abs().max().item() <= 1e-2 * scale, name


def test_fp32_and_training_take_the_preact_unfused(cuda):
    """Where the fusion does not engage on the card: an fp32 model's
    forward and a bf16 conv under a gradient compute the pre-activation
    with PyTorch ops (preact_unfused) and launch K1 without it."""
    from tmdiff_tpu_torch.models.wavbest import WavBEST
    from tmdiff_tpu_torch.ops import modconv
    from tmdiff_tpu_torch.ops.cuda import conv3d as K

    model = WavBEST((8, 16, 32, 64), seed=0)
    g = torch.Generator(device=cuda).manual_seed(14)
    args = (torch.randn(2, 8, 32, 32, device=cuda, generator=g),
            torch.tensor([3.0, 600.0], device=cuda),
            torch.rand(2, 1, 32, 32, device=cuda, generator=g),
            torch.rand(2, 8, 32, 32, device=cuda, generator=g),
            torch.randn(768, device=cuda, generator=g))
    K.reset_launches()
    with torch.no_grad():
        model(*args)
    assert (K.preact_fused, K.preact_unfused, K.dtype_launches["float32"]) == (0, 56, 65)
    x = torch.randn(2, 4, 8, 8, 16, device=cuda, generator=g).bfloat16().requires_grad_()
    k = torch.randn(3, 3, 3, 16, 8, device=cuda, generator=g)
    K.reset_launches()
    y = modconv.conv3d(x, k.bfloat16(), shift=torch.ones(2, 16, device=cuda).bfloat16(),
                       act="silu")
    y.float().sum().backward()
    assert (K.preact_fused, K.preact_unfused, K.launches) == (0, 1, 2)


def test_compiled_step_spans_capture_once_then_replay(cuda):
    """utils/profiling.py's spans of compiled_step on the card: the first
    call of a shape is one `step.capture` (its key the batch shapes), each
    later call one `step.replay`, every call one `step.copy_in`,
    `step.begin` and `step.end`; K1's plans of the step's shapes are made
    inside the capture's eager step, none later."""
    from tmdiff_tpu_torch.ops.cuda import conv3d as K
    from tmdiff_tpu_torch.utils import profiling

    batch, prompt = _card_batch(cuda), torch.randn(768, device=cuda)
    trainer = _card_trainer(cuda)
    state, step = trainer.init_state(), trainer.compiled_step()
    K._plans.clear()
    profiling.drain()
    with profiling.recording():
        for _ in range(3):
            step(state, batch, prompt)
    spans = sorted(profiling.drain(), key=lambda s: s.start)
    trainer.release_compiled()
    call = lambda middle: ["step.copy_in", "step.begin", middle, "step.end"]
    steps = [s for s in spans if s.name.startswith("step.")]
    assert [s.name for s in steps] == (call("step.capture") + call("step.replay")
                                       + call("step.replay"))
    assert steps[2].attrs == {"key": tuple(tuple(batch[k].shape) for k in ("Res", "PAN", "MS"))}
    plans = [s for s in spans if s.name == "conv3d.plan"]
    assert plans and all(steps[2].start <= s.start <= s.end <= steps[2].end for s in plans)


def test_conv3d_plan_span_on_a_miss_only(cuda):
    """A shape's first launch records one `conv3d.plan` span (kd, shape,
    variant); its second launch finds the plan and records none."""
    from tmdiff_tpu_torch.ops.cuda import conv3d as K
    from tmdiff_tpu_torch.utils import profiling

    x = torch.randn(1, 4, 24, 40, 16, device=cuda)
    k = torch.randn(3, 3, 3, 16, 48, device=cuda)
    K._plans.clear()
    profiling.drain()
    with profiling.recording(), torch.no_grad():
        K.banded_conv3d(x, k)
        K.banded_conv3d(x, k)
    spans = profiling.drain()
    assert [s.name for s in spans] == ["conv3d.plan"]
    (plan,) = K._plans.values()
    assert spans[0].attrs == {"kd": 3, "shape": (1, 4, 24, 40, 16, 48), "variant": plan[0]}
