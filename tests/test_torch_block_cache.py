"""The port's cross-step block caching (WavBEST.denoise_deep/denoise_reuse,
gaussian.ddim_sample_blockcached, Pansharpener "ddim_cached") on the CPU:
the contracts of tests/test_block_cache.py (an exact factoring of denoise at
cache levels 1-3, the sampler's wiring equal to ddim, the forecast rule
against a numpy simulation, a refresh mask equal to its uniform schedule, a
static schedule equal to the runtime one), and the method against the JAX
Pansharpener on the same weights (from_flax) and x_T at each level."""
import jax
import numpy as np
import pytest
import torch

from tmdiff_tpu.models import WavBEST as JaxWavBEST
from tmdiff_tpu.pipeline import Pansharpener as JaxPansharpener
from tmdiff_tpu_torch.diffusion import gaussian
from tmdiff_tpu_torch.diffusion.schedules import NoiseSchedule
from tmdiff_tpu_torch.models.wavbest import WavBEST
from tmdiff_tpu_torch.pipeline import Pansharpener
from tmdiff_tpu_torch.utils.weights import from_flax
from flax_params import random_flax_params

torch.set_num_threads(2)

CHANNELS = (8, 16, 32, 64)
SAMPLE_ATOL = 2e-3  # end-to-end sampling, the bar of tests/test_pipeline_golden.py


@pytest.fixture(scope="module")
def carried():
    jmodel = JaxWavBEST(channels=CHANNELS)
    params = random_flax_params(jmodel, seed=3)
    port = from_flax(WavBEST(CHANNELS, device="cpu"), jax.tree.map(np.asarray, params))
    return jmodel, params, port


@pytest.fixture(scope="module")
def env(carried):
    """The port model, its condition cache and a noisy residual of a 4-band
    batch of 2 at 16x16; full / reuse / denoise callables."""
    port = carried[2]
    rng = np.random.default_rng(7)
    ms = torch.as_tensor(rng.uniform(0.1, 0.9, (2, 4, 16, 16)).astype(np.float32))
    pan = ms.mean(1, keepdim=True)
    x = torch.as_tensor(rng.standard_normal((2, 4, 16, 16)).astype(np.float32))
    with torch.no_grad():
        cache = port.encode_condition(pan, ms, torch.zeros(768))
    return port, cache, pan, ms, x


def _callables(port, cache, level=1):
    denoise = lambda x, t, *_: port.denoise(x, t, cache)
    full = lambda x, t: port.denoise_deep(x, t, cache, cache_level=level)
    reuse = lambda x, t, deep: port.denoise_reuse(x, t, cache, deep, cache_level=level)
    return denoise, full, reuse


@torch.no_grad()
@pytest.mark.parametrize("level", [1, 2, 3])
def test_deep_split_is_exact_factoring(env, level):
    """denoise_deep's output is denoise's bit for bit, and reusing its trunk
    at the same t gives denoise's output bit for bit; the trunk's form at
    each level."""
    port, cache, _, _, x = env
    t = torch.tensor([3, 7])
    full = port.denoise(x, t, cache)
    out, deep = port.denoise_deep(x, t, cache, cache_level=level)
    assert torch.equal(full, out)
    assert torch.equal(full, port.denoise_reuse(x, t, cache, deep, cache_level=level))
    if level == 1:
        x_h3, h_mid = deep
        assert x_h3.shape[1] == x.shape[1] and h_mid.shape == x_h3.shape
    else:
        assert isinstance(deep, torch.Tensor)
    if level == 3:
        assert deep.shape[2:4] == (x.shape[-2] // 2, x.shape[-1] // 2)
    with pytest.raises(ValueError, match="cache_level"):
        port.denoise_deep(x, t, cache, cache_level=4)


@torch.no_grad()
def test_blockcached_wiring_equals_ddim(env):
    """With a reuse that recomputes the whole network the block-cached
    sampler is ddim, stale or forecast; with refresh_every=1 it is ddim with
    the real reuse path; atol 1e-6."""
    port, cache, pan, ms, x = env
    denoise, full, reuse = _callables(port, cache)
    ns = NoiseSchedule.create("cosine", 10)
    shape = tuple(ms.shape)
    ref = gaussian.ddim_sample(denoise, ns, None, pan, ms, shape, steps=4, x_init=x)
    recompute = lambda x_, t, deep: denoise(x_, t)
    for forecast in (False, True):
        out = gaussian.ddim_sample_blockcached(full, recompute, ns, None, pan, ms, shape, steps=4,
                                               refresh_every=2, x_init=x, forecast=forecast)
        torch.testing.assert_close(out, ref, atol=1e-6, rtol=0)
    out1 = gaussian.ddim_sample_blockcached(full, reuse, ns, None, pan, ms, shape, steps=4,
                                            refresh_every=1, x_init=x)
    torch.testing.assert_close(out1, ref, atol=1e-6, rtol=0)
    with pytest.raises(ValueError, match="divisible by refresh_every"):
        gaussian.ddim_sample_blockcached(full, reuse, ns, None, pan, ms, shape, steps=5,
                                         refresh_every=2, x_init=x)


def test_forecast_linear_extrapolation_math():
    """A fake model whose trunk is a known function of the refresh time and
    whose x0 is the trunk's value: the trajectory shows which trunk every
    reuse step consumed. Chunk 0 reuses stale (slope 0); later chunks
    consume deep_k + (i / r) (deep_k - deep_{k-1}); atol 1e-6 against the
    numpy simulation of tests/test_block_cache.py."""
    ns = NoiseSchedule.create("cosine", 10)
    T, steps, r, shape = 10, 8, 4, (1, 2, 4, 4)

    def full_fn(x, t):
        d = t[0].to(torch.float32) / T
        return d * 1e-3 * torch.ones(shape), d

    reuse_fn = lambda x, t, deep: deep * 1e-3 * torch.ones(shape)
    kw = dict(steps=steps, refresh_every=r, x_init=torch.zeros(shape))
    out = gaussian.ddim_sample_blockcached(full_fn, reuse_fn, ns, None, None, None, shape,
                                           forecast=True, **kw)
    grid = np.round(np.linspace(T, 0, steps + 1)).astype(np.int64)
    acp = ns.sqrt_alphas_cumprod_prev.numpy().astype(np.float64)

    def jump(x, x0, t, s):
        sig = lambda a: np.sqrt(max(1.0 - a * a, 0.0))
        ratio = sig(acp[s]) / max(sig(acp[t]), 1e-12)
        return acp[s] * np.clip(x0, -1.0, 1.0) + ratio * (x - acp[t] * x0)

    x = np.zeros(shape)
    deep_prev, have_prev = 0.0, 0.0
    for k in range(steps // r):
        t0 = grid[k * r]
        deep = float(t0) / T
        x = jump(x, deep * 1e-3 * np.ones(shape), t0, grid[k * r + 1])
        slope = have_prev * (deep - deep_prev)
        for i in range(1, r):
            x = jump(x, (deep + (i / r) * slope) * 1e-3 * np.ones(shape), grid[k * r + i],
                     grid[k * r + i + 1])
        deep_prev, have_prev = deep, 1.0
    np.testing.assert_allclose(out.numpy(), x, atol=1e-6)
    stale = gaussian.ddim_sample_blockcached(full_fn, reuse_fn, ns, None, None, None, shape,
                                             forecast=False, **kw)
    assert (out - stale).abs().max() > 0


@torch.no_grad()
def test_refresh_masks(env):
    """A mask of the uniform r = 2 pattern is refresh_every=2, an all-True
    mask is ddim, a mask given as a sequence equals the same mask given as a
    bool tensor on an irregular schedule, and the checks raise for both
    forms; atol 1e-6."""
    port, cache, pan, ms, x = env
    denoise, full, reuse = _callables(port, cache)
    ns = NoiseSchedule.create("cosine", 10)
    common = (full, reuse, ns, None, pan, ms, tuple(ms.shape))

    def run(**kw):
        return gaussian.ddim_sample_blockcached(*common, x_init=x, **kw)

    ref = run(steps=4, refresh_every=2)
    torch.testing.assert_close(run(steps=4, refresh_mask=[True, False, True, False]), ref,
                               atol=1e-6, rtol=0)
    plain = gaussian.ddim_sample(denoise, ns, None, pan, ms, tuple(ms.shape), steps=4, x_init=x)
    torch.testing.assert_close(run(steps=4, refresh_mask=[True] * 4), plain, atol=1e-6, rtol=0)
    mask = [True, False, False, True, True, False]
    static = run(steps=6, refresh_mask=mask)
    runtime = run(steps=6, refresh_mask=torch.tensor(mask))
    torch.testing.assert_close(static, runtime, atol=1e-6, rtol=0)
    assert gaussian.refresh_chunks(mask, 6) == [3, 1, 2]
    with pytest.raises(ValueError, match=r"refresh_mask\[0\]"):
        run(steps=4, refresh_mask=[False, True, True, True])
    with pytest.raises(ValueError, match=r"refresh_mask\[0\]"):
        run(steps=4, refresh_mask=torch.tensor([False, True, True, True]))
    with pytest.raises(ValueError, match="length steps"):
        run(steps=4, refresh_mask=[True, False])
    with pytest.raises(ValueError, match="length steps"):
        run(steps=4, refresh_mask=torch.tensor([True, False]))
    with pytest.raises(ValueError, match="forecast"):
        run(steps=4, refresh_mask=[True] * 4, forecast=True)


CACHED_CASES = [
    dict(cache_level=1, refresh_every=2),
    dict(cache_level=2, refresh_every=2),
    dict(cache_level=3, refresh_every=2, forecast=True),
    dict(cache_level=1, refresh_mask=(True, False, False, True, True, False),
         refresh_mask_static=True),
    dict(cache_level=3, refresh_mask=(True, False, True, True, False, False)),
]


@pytest.mark.parametrize("kw", CACHED_CASES, ids=["level1", "level2", "level3_forecast",
                                                  "level1_static_mask", "level3_mask"])
def test_ddim_cached_matches_jax(carried, kw):
    """Pansharpener "ddim_cached" at 6 steps against the JAX facade on the
    same weights and x_T, at each cache level, with forecast and with a
    static and a runtime mask, 4 bands and mixed sensors; atol 2e-3, the
    sampling bar."""
    jmodel, params, port = carried
    rng = np.random.default_rng(11 + kw["cache_level"])
    ms = rng.uniform(0.1, 0.9, (2, 4, 16, 16)).astype(np.float32)
    batch = {"PAN": ms.mean(1, keepdims=True), "MS": ms}
    x_T = rng.standard_normal(ms.shape).astype(np.float32)
    args = dict(sensor=["QB", "GF2"], method="ddim_cached", steps=6, x_init=x_T, **kw)
    ref = JaxPansharpener(jmodel, params).sample(batch, **args)
    out = Pansharpener(port, device="cpu").sample(batch, **args)
    assert out.shape == ms.shape and np.isfinite(out).all()
    np.testing.assert_allclose(out, np.asarray(ref), atol=SAMPLE_ATOL)
