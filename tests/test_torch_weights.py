"""Weight carry-over into the port's WavBEST (tmdiff_tpu_torch/utils/weights.py):
the key map against the JAX package's, strictness, and the dead reference
parameters that tests/test_wavbest.py lists."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tmdiff_tpu.models import WavBEST as JaxWavBEST
from tmdiff_tpu.utils.torch_import import _torch_key, export_state_dict
from tmdiff_tpu_torch.models.wavbest import WavBEST
from tmdiff_tpu_torch.utils.weights import (
    from_flax,
    from_reference_state_dict,
    is_dead_reference_param,
    torch_key,
)

torch.set_num_threads(2)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
CHANNELS = (8, 16, 32, 64)


@pytest.fixture(scope="module")
def jax_tree():
    """The JAX WavBEST param tree filled with seeded numpy values."""
    model = JaxWavBEST(channels=CHANNELS)
    x = jnp.zeros((1, 4, 16, 16))
    tree = jax.eval_shape(model.init, jax.random.key(0), x, jnp.ones(1), x[:, :1], x,
                          jnp.zeros(768))
    rng = np.random.default_rng(0)
    return jax.tree.map(lambda s: rng.standard_normal(s.shape).astype(np.float32), tree)


def _paths(tree):
    return [tuple(str(p.key) for p in path)
            for path, _ in jax.tree_util.tree_flatten_with_path(tree)[0]]


def _golden_sd():
    g = np.load(os.path.join(GOLDEN, "wavbest.npz"))
    return {k[3:]: g[k] for k in g.files if k.startswith("sd.")}


def test_key_map_matches_jax(jax_tree):
    """The port's key map is the JAX package's, and the port's module names
    give exactly the reference keys the JAX params map onto."""
    paths = _paths(jax_tree)
    assert [torch_key(p) for p in paths] == [_torch_key(p) for p in paths]
    port_keys = set(WavBEST(CHANNELS, device="cpu").state_dict())
    assert port_keys == {_torch_key(p)[0] for p in paths}


def test_dead_params_match_jax_test(jax_tree):
    """The reference keys the port leaves unconsumed are exactly those the
    JAX package leaves, each is a dead parameter of test_wavbest.py, and no
    key the port consumes is taken for a dead one."""
    sd = _golden_sd()
    jax_used = {_torch_key(p)[0] for p in _paths(jax_tree)}
    port_keys = set(WavBEST(CHANNELS, device="cpu").state_dict())
    leftovers = set(sd) - port_keys
    assert leftovers == set(sd) - jax_used and len(leftovers) > 0
    assert all(is_dead_reference_param(k, sd) for k in leftovers)
    assert not any(is_dead_reference_param(k, sd) for k in port_keys)


def test_from_flax_equals_reference_route(jax_tree):
    """from_flax and from_reference_state_dict (through the JAX package's
    export) fill identical weights."""
    a = from_flax(WavBEST(CHANNELS, device="cpu"), jax_tree)
    b = from_reference_state_dict(WavBEST(CHANNELS, device="cpu"), export_state_dict(jax_tree),
                                  prefix="denoise_fn.")
    sa, sb = a.state_dict(), b.state_dict()
    assert sa.keys() == sb.keys()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa["final.conv24.weight"], WavBEST(CHANNELS, device="cpu").state_dict()[
        "final.conv24.weight"])


def test_strict(jax_tree):
    """An unknown or a missing key raises, in both loaders."""
    sd = _golden_sd()
    model = WavBEST(CHANNELS, device="cpu")
    from_reference_state_dict(model, sd)
    with pytest.raises(KeyError, match="unknown"):
        from_reference_state_dict(model, {**sd, "up1.bogus.weight": np.zeros(3)})
    with pytest.raises(KeyError, match="middle1.conv20.weight"):
        from_reference_state_dict(model, {k: v for k, v in sd.items() if k != "middle1.conv20.weight"})
    with pytest.raises(ValueError, match="shape"):
        from_reference_state_dict(model, {**sd, "embed.0.bias": np.zeros(3)})
    bogus = {"params": {**jax_tree["params"], "bogus": {"kernel": np.zeros((2, 2))}}}
    with pytest.raises(KeyError, match="bogus"):
        from_flax(model, bogus)
    missing = {"params": {k: v for k, v in jax_tree["params"].items() if k != "middle1"}}
    with pytest.raises(KeyError, match="missing"):
        from_flax(model, missing)
