"""The port's WavBEST (tmdiff_tpu_torch/models) against the reference golden
and the JAX WavBEST on the same random weights, on the CPU (plain convs)."""
import os

import jax
import numpy as np
import pytest
import torch

from tmdiff_tpu.models import WavBEST as JaxWavBEST
from tmdiff_tpu_torch.models.wavbest import WavBEST
from tmdiff_tpu_torch.utils.weights import from_flax, from_reference_state_dict
from flax_params import random_flax_params

torch.set_num_threads(2)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
CHANNELS = (8, 16, 32, 64)


def _t(a):
    return torch.as_tensor(np.asarray(a, np.float32))


@pytest.fixture(scope="module")
def carried():
    """JAX model + params and the port's model filled from them."""
    jmodel = JaxWavBEST(channels=CHANNELS)
    params = random_flax_params(jmodel)
    port = from_flax(WavBEST(CHANNELS, device="cpu"), jax.tree.map(np.asarray, params))
    return jmodel, params, port


def test_forward_golden():
    """Reference torch weights and inputs reproduce the reference output;
    atol 5e-4, the bar of tests/test_wavbest.py."""
    g = np.load(os.path.join(GOLDEN, "wavbest.npz"))
    sd = {k[3:]: g[k] for k in g.files if k.startswith("sd.")}
    model = from_reference_state_dict(WavBEST(CHANNELS, device="cpu"), sd)
    with torch.no_grad():
        y = model(*(_t(g[k]) for k in ("x", "t", "pan", "ms", "prompt")))
    np.testing.assert_allclose(y.numpy(), g["y"], atol=5e-4)


@pytest.mark.parametrize("bands,mixed_prompt", [(4, False), (8, True)])
def test_matches_jax(carried, bands, mixed_prompt):
    """Same random weights (from_flax), same numpy inputs, 4 and 8 bands, a
    shared (768,) or a per-row (B, 768) prompt; atol 1e-4 (fp32, the convs
    sum in another order than XLA's)."""
    jmodel, params, port = carried
    rng = np.random.default_rng(bands)
    x = rng.standard_normal((2, bands, 16, 16)).astype(np.float32)
    pan = rng.uniform(size=(2, 1, 16, 16)).astype(np.float32)
    ms = rng.uniform(size=(2, bands, 16, 16)).astype(np.float32)
    prompt = rng.standard_normal((2, 768) if mixed_prompt else (768,)).astype(np.float32)
    t = np.array([3.0, 812.5], np.float32)
    ref = jax.jit(jmodel.apply)(params, x, t, pan, ms, prompt)
    with torch.no_grad():
        y = port(*(_t(a) for a in (x, t, pan, ms, prompt)))
    assert y.shape == (2, bands, 16, 16)
    np.testing.assert_allclose(y.numpy(), np.asarray(ref), atol=1e-4)


def test_encode_then_denoise_equals_forward(carried):
    _, _, port = carried
    rng = np.random.default_rng(1)
    x, ms = (_t(rng.standard_normal((2, 4, 16, 16))) for _ in range(2))
    pan, prompt, t = _t(rng.uniform(size=(2, 1, 16, 16))), _t(rng.standard_normal(768)), _t([5, 90])
    with torch.no_grad():
        fused = port(x, t, pan, ms, prompt)
        cache = port.encode_condition(pan, ms, prompt)
        split = port.denoise(x, t, cache)
    np.testing.assert_array_equal(split.numpy(), fused.numpy())
    assert port.use_plain_conv(True) is port
    assert all(m.plain for m in port.modules() if hasattr(m, "plain"))
    port.use_plain_conv(False)


def test_divisible_by_8(carried):
    _, _, port = carried
    bad = torch.ones(1, 4, 20, 20)
    with pytest.raises(ValueError, match="divisible by 8"):
        port.encode_condition(torch.ones(1, 1, 20, 20), bad, torch.zeros(768))


def test_device_rule(monkeypatch):
    """No device and no GPU: construction raises; device='cpu' works."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        WavBEST(CHANNELS)
    model = WavBEST(CHANNELS, device="cpu", seed=3)
    assert model.device.type == "cpu"
    same = WavBEST(CHANNELS, device="cpu", seed=3)
    assert all(torch.equal(a, b) for a, b in zip(model.parameters(), same.parameters()))
