"""The flash-attention kernel's (K4, tmdiff_tpu_torch/csrc/flash_attention.cu)
host-side design on the CPU: its plan (variant, key tile, split-KV, in
float32 and bfloat16), the plain versions of its split and merge against
the JAX package, the 3xTF32 arithmetic the fp32 kernel pays on both
products, the bf16 kernel's arithmetic (bf16 products, p as two bf16
parts), and the build digest that covers the shared CUDA header."""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tmdiff_tpu.ops.pallas.flash_attention import attention_reference as jax_attention_reference
from tmdiff_tpu.ops.pallas.flash_attention import flash_attention as jax_flash_attention
from tmdiff_tpu_torch.ops.cuda import build
from tmdiff_tpu_torch.ops.cuda import flash_attention as K4

H100_SMS = 132
ATOL = 2e-5  # the JAX package's flash-attention bar


@pytest.fixture(autouse=True)
def _two_threads():
    torch.set_num_threads(2)


# --- (a) the plan ----------------------------------------------------------

def test_plan_self_attention_takes_no_split():
    """2 x 8 heads x 4096 x 64: 512 blocks of 128 queries fill the card."""
    p = K4.plan(2, 8, 4096, 4096, 64, H100_SMS)
    assert p == K4.Plan("tc", 128, 64, 1, 2 * 8 * 64 * 16 * 64 * 64)


def test_plan_spatial_self_attention_splits_to_a_wave():
    """2 x 1 x 1024 x 256: 32 blocks of 64 queries; the key tiles are shared
    out until the blocks come as close to one wave as they can."""
    p = K4.plan(2, 1, 1024, 1024, 256, H100_SMS)
    blocks = 2 * 1024 // p.rows
    assert (p.variant, p.rows, p.key_tile) == ("tc", 64, 16)
    assert p.splits > 1
    assert blocks * p.splits <= H100_SMS < blocks * (p.splits + 1)
    images = 2 * (1024 // 16) * 16 * 256 * 16
    assert p.workspace_bytes == images + 4 * p.splits * 2 * 1024 * (256 + 2)


def test_plan_cross_attention_to_one_key_takes_an_8_key_tile():
    p = K4.plan(2, 8, 4096, 1, 64, H100_SMS)
    assert (p.variant, p.key_tile, p.splits) == ("tc", 8, 1)


@pytest.mark.parametrize("d,variant", [(42, "fma"), (3, "fma"), (8, "tc"), (40, "tc"),
                                       (256, "tc")])
def test_plan_variant_is_a_function_of_the_head_dim(d, variant):
    for skv in (1, 100, 4096):
        p = K4.plan(1, 2, 300, skv, d, H100_SMS)
        assert p.variant == variant
        if variant == "fma":
            assert p == K4.Plan("fma", 64, 64, 1, 0)


@pytest.mark.parametrize("d,variant", [(42, "bf16_fma"), (12, "bf16_fma"), (4, "bf16_fma"),
                                       (8, "bf16"), (40, "bf16"), (136, "bf16"), (256, "bf16")])
def test_bf16_plan_takes_the_tensor_cores_at_16_byte_rows(d, variant):
    """In bf16 a 16-byte row is 8 elements: D % 8 == 0 takes the bf16
    tensor-core kernel with the fp32 plan's rows and split rule over its
    own key tiles, reading K and V in place: no workspace unsplit, only the
    fp32 partials (O and (m, l) of every split and query row) when split;
    other D take the FMA kernel over bf16 loads."""
    for b, h, skv in ((1, 2, 1), (1, 2, 100), (1, 2, 4096), (2, 40, 4096)):
        p = K4.plan(b, h, 300, skv, d, H100_SMS, torch.bfloat16)
        assert p.variant == variant
        if variant == "bf16_fma":
            assert p == K4.Plan("bf16_fma", 64, 64, 1, 0)
            continue
        fp32 = K4.plan(b, h, 300, skv, d, H100_SMS)
        assert p.rows == fp32.rows
        n_tiles = math.ceil(skv / p.key_tile)
        blocks = b * h * math.ceil(300 / p.rows)
        splits = max(1, min(n_tiles, H100_SMS // blocks))
        assert p.splits == math.ceil(n_tiles / math.ceil(n_tiles / splits))
        partials = 4 * p.splits * b * h * 300 * (d + 2)
        assert p.workspace_bytes == (partials if p.splits > 1 else 0)


@pytest.mark.parametrize("skv,d,tile", [
    (1, 64, 16), (16, 64, 16), (17, 64, 32), (65, 64, 128), (4096, 64, 128),
    (1, 128, 16), (33, 128, 64), (4096, 128, 64),
    (1, 256, 16), (17, 256, 32), (1024, 256, 32), (9, 136, 16),
])
def test_bf16_plan_key_tile(skv, d, tile):
    """bf16 key tiles: the smallest of 16, 32, 64, 128 that covers Skv, at
    most 128 / 64 / 32 keys at head tile 64 / 128 / 256 (the stages of K
    and V in shared memory, S and two tiles' P in registers)."""
    p = K4.plan(2, 8, 4096, skv, d, H100_SMS, torch.bfloat16)
    assert p.key_tile == tile
    assert p.key_tile == min(next((t for t in (16, 32, 64, 128) if t >= skv), 128),
                             K4.max_key_tile(K4.head_tile(d), torch.bfloat16))


@pytest.mark.parametrize("q_shape,skv,key_tile,splits", [
    ((2, 8, 4096, 64), 4096, 128, 1), ((2, 8, 4096, 64), 1, 16, 1),
    ((2, 1, 1024, 256), 1024, 32, 4),
])
def test_bf16_plan_at_the_chip_shapes(q_shape, skv, key_tile, splits):
    """chip_smoke.py's shapes on a 132-SM H100: self-attention and the
    one-key cross-attention unsplit (one launch, no workspace),
    SpatialSelfAttention split four ways (the partials only)."""
    b, h, sq, d = q_shape
    p = K4.plan(b, h, sq, skv, d, H100_SMS, torch.bfloat16)
    expected = 4 * splits * b * h * sq * (d + 2) if splits > 1 else 0
    assert p == K4.Plan("bf16", K4.head_tile(d) == 256 and 64 or 128, key_tile, splits, expected)


@pytest.mark.parametrize("skv,tile", [(1, 8), (7, 8), (8, 8), (9, 16), (65, 64)])
def test_plan_key_tile_covers_short_contexts(skv, tile):
    assert K4.plan(2, 8, 4096, skv, 64, H100_SMS).key_tile == tile


def test_plan_key_tile_is_capped_by_the_head_tile():
    assert K4.plan(2, 8, 4096, 4096, 128, H100_SMS).key_tile == 32
    assert K4.plan(2, 8, 4096, 4096, 256, H100_SMS).key_tile == 16
    assert K4.plan(2, 8, 4096, 9, 256, H100_SMS).key_tile == 16


@pytest.mark.parametrize("skv", [1, 64, 130, 4097])
def test_plan_gives_every_split_a_key_tile(skv):
    p = K4.plan(1, 1, 10, skv, 64, H100_SMS)
    n_tiles = math.ceil(skv / p.key_tile)
    per_split = math.ceil(n_tiles / p.splits)
    assert 1 <= p.splits <= n_tiles
    assert math.ceil(n_tiles / per_split) == p.splits


# --- (b) the plain split and merge against the JAX package ------------------

@pytest.fixture(scope="module")
def split_case():
    """Sq 48, Skv 130 over 64-key tiles: three tiles, the last with 2 keys;
    with four or more splits a split holds only keys past Skv."""
    rng = np.random.default_rng(7)
    q = rng.standard_normal((1, 2, 48, 32)).astype(np.float32)
    k = rng.standard_normal((1, 2, 130, 32)).astype(np.float32)
    v = rng.standard_normal((1, 2, 130, 32)).astype(np.float32)
    ref = np.asarray(jax_attention_reference(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))
    pallas = np.asarray(jax_flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                            block_q=64, block_k=64, interpret=True))
    return [torch.from_numpy(a) for a in (q, k, v)], ref, pallas


@pytest.mark.parametrize("splits", range(1, 9))
def test_split_and_merge_match_jax(split_case, splits):
    (q, k, v), ref, pallas = split_case
    o, m, l = K4.attention_partials(q, k, v, splits, key_tile=64)
    assert o.shape == (splits, 1, 2, 48, 32) and m.shape == l.shape == (splits, 1, 2, 48)
    if splits >= 4:  # past the last key: nothing, with a max of -inf
        assert torch.all(m[3:] == -math.inf) and torch.all(l[3:] == 0) and torch.all(o[3:] == 0)
    got = K4.merge_partials(o, m, l).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)
    np.testing.assert_allclose(got, pallas, rtol=0, atol=ATOL)


# --- (c) 3xTF32 on both products --------------------------------------------

def _rna_tf32(x: torch.Tensor) -> torch.Tensor:
    """fp32 -> TF32 rounded to nearest, ties away from zero (`cvt.rna`)."""
    return ((x.contiguous().view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)


def _product(a, b, three):
    if not three:
        return _rna_tf32(a) @ _rna_tf32(b)
    ah, bh = _rna_tf32(a), _rna_tf32(b)
    al, bl = _rna_tf32(a - ah), _rna_tf32(b - bh)
    return (ah @ bl + al @ bh) + ah @ bh


def _emulated_attention(q, k, v, three):
    s = _product(q, k.T, three) * q.shape[-1] ** -0.5
    p = torch.exp(s - s.amax(-1, keepdim=True))
    return _product(p, v, three) / p.sum(-1, keepdim=True)


@pytest.mark.parametrize("skv,d", [(4096, 64), (1024, 256)])
def test_three_tf32_products_meet_the_attention_bar_where_one_does_not(skv, d):
    """Unit-normal q, k, v, Sq 256, against float64. Plain TF32 on both
    products misses 2e-5; three products per multiply-add meet it by 10x or
    more. The emulation sums in IEEE fp32; it leaves out the tensor cores'
    own accumulation, which the kernel bounds by folding each key tile's
    P.V into O in fp32 (tests/test_torch_cuda.py holds it on the card)."""
    rng = np.random.default_rng(skv + d)
    q, k, v = (torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32))
               for n in (256, skv, skv))
    s = (q.double() @ k.double().T) * d ** -0.5
    ref = torch.softmax(s, -1) @ v.double()
    plain = (_emulated_attention(q, k, v, False).double() - ref).abs().max().item()
    three = (_emulated_attention(q, k, v, True).double() - ref).abs().max().item()
    assert plain > ATOL
    assert three <= ATOL / 10


# --- (d) the bf16 instance: bf16 products for S, p as two bf16 parts ------

def _rn_bf16(x: torch.Tensor) -> torch.Tensor:
    """fp32 -> bf16 -> fp32, round to nearest even (`cvt.rn.bf16x2.f32`)."""
    return x.to(torch.bfloat16).float()


def _emulated_bf16_attention(q, k, v, parts):
    """The bf16 kernel's arithmetic on bf16 q, k, v: S in fp32 from exact
    bf16 products, the softmax in fp32, P.V on p rounded to one bf16 part
    or split into two (p_hi = rn(p), p_lo = rn(p - p_hi)), summed in fp32."""
    s = (q.float() @ k.float().T) * q.shape[-1] ** -0.5
    p = torch.exp(s - s.amax(-1, keepdim=True))
    hi = _rn_bf16(p)
    pv = hi @ v.float() if parts == 1 else _rn_bf16(p - hi) @ v.float() + hi @ v.float()
    return pv / p.sum(-1, keepdim=True)


# The bf16 bar past the output's rounding is 1e-4 of its scale (one bf16 step
# on the card); the kernel's two parts must meet a quarter of it, where a
# third part would be taken (csrc/flash_attention.cu's header).
BF16_BAR, BF16_MARGIN = 1e-4, 4


@pytest.mark.parametrize("skv,d", [(4096, 64), (1024, 256)])
def test_two_bf16_parts_of_p_meet_the_bf16_bar_where_one_does_not(skv, d):
    """Unit-normal q, k, v rounded to bf16, Sq 256, against float64 on the
    same bf16 values. p rounded to one bf16 part (FlashAttention's P) misses
    1e-4 of the output's scale; two parts (16 of p's 24 bits, 2^-18 of
    sum p |v|) stay a quarter inside it. The emulation sums in IEEE fp32; the
    tensor cores' accumulation over one key tile is held on the card
    (tests/test_torch_cuda.py::test_flash_attention_bf16_error_at_the_deepest_sums)."""
    rng = np.random.default_rng(skv + d + 1)
    q, k, v = (torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32)).bfloat16()
               for n in (256, skv, skv))
    s = (q.double() @ k.double().T) * d ** -0.5
    ref = torch.softmax(s, -1) @ v.double()
    scale = ref.abs().max().item()
    one = (_emulated_bf16_attention(q, k, v, 1).double() - ref).abs().max().item() / scale
    two = (_emulated_bf16_attention(q, k, v, 2).double() - ref).abs().max().item() / scale
    assert one > BF16_BAR
    assert two <= BF16_BAR / BF16_MARGIN


# --- the build digest --------------------------------------------------------

def test_build_digest_covers_the_shared_headers(tmp_path, monkeypatch):
    """An edit to any csrc/*.cuh header, or a new one, renames the library,
    so a cached build of the old header is not loaded."""
    (tmp_path / "kern.cu").write_text('#include "shared.cuh"\n')
    header = tmp_path / "shared.cuh"
    header.write_text("// v1\n")
    monkeypatch.setattr(build, "CSRC", str(tmp_path))
    first = build.digest("kern")
    assert build.digest("kern") == first
    header.write_text("// v2\n")
    second = build.digest("kern")
    assert second != first
    (tmp_path / "other.cuh").write_text("// new\n")
    third = build.digest("kern")
    assert third != second
    (tmp_path / "notes.txt").write_text("not a source\n")
    assert build.digest("kern") == third
