"""Seeded numpy weights for a JAX WavBEST param tree, shared by the port's
parity tests (tests/test_torch_*.py fill the port's modules from them with
`from_flax`)."""
import jax
import jax.numpy as jnp
import numpy as np


def random_flax_params(model, seed=0):
    """A JAX WavBEST param tree of seeded numpy values: lecun-scaled kernels,
    small random biases, style biases near 1 (eval_shape gives the tree
    without compiling init)."""
    x = jnp.zeros((1, 4, 16, 16))
    tree = jax.eval_shape(model.init, jax.random.key(0), x, jnp.ones(1), x[:, :1], x,
                          jnp.zeros(768))
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        names = [str(p.key) for p in path]
        if names[-1] == "kernel":
            fan_in = int(np.prod(leaf.shape[:-1]))
            return (rng.standard_normal(leaf.shape) / np.sqrt(fan_in)).astype(np.float32)
        base = 1.0 if "style" in names else 0.0
        return (base + 0.1 * rng.standard_normal(leaf.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, tree)
