"""The flash-attention kernel's (K4, tmdiff_tpu_torch/csrc/flash_attention.cu)
host-side design on the CPU: its plan (variant, key tile, split-KV), the
plain versions of its split and merge against the JAX package, the 3xTF32
arithmetic it pays on both products, and the build digest that covers the
shared CUDA header."""
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
                                       (8, "bf16"), (40, "bf16"), (256, "bf16")])
def test_bf16_plan_takes_the_tensor_cores_at_16_byte_rows(d, variant):
    """In bf16 a 16-byte row is 8 elements: D % 8 == 0 takes the bf16
    tensor-core instance with the fp32 plan's tiling and an image of one
    part a K / V element (8 bytes an element pair, half of fp32's 16); other
    D take the FMA kernel over bf16 loads."""
    for skv in (1, 100, 4096):
        p = K4.plan(1, 2, 300, skv, d, H100_SMS, torch.bfloat16)
        assert p.variant == variant
        if variant == "bf16_fma":
            assert p == K4.Plan("bf16_fma", 64, 64, 1, 0)
        else:
            fp32 = K4.plan(1, 2, 300, skv, d, H100_SMS)
            assert p[1:4] == fp32[1:4]
            images = 2 * math.ceil(skv / p.key_tile) * K4.head_tile(d) * p.key_tile
            assert p.workspace_bytes - 8 * images == fp32.workspace_bytes - 16 * images


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
