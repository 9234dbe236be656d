"""The CPU sweep behind the gradient bars of tests/test_torch_bf16_train.py:
the bf16 WavBEST loss and every gradient through the port's `Trainer.loss`
against jax.value_and_grad of the JAX model in bf16 and in fp32, over 4 and
8 bands and three weight seeds at 32x32, widths (8, 16, 32, 64), dropout
off, JAX's t and noise handed to the port. Prints, a run a line: the loss's
gaps, the median of JAX-bf16's own gradient gaps to JAX-fp32, the largest
ratio of the port's gap to JAX-bf16 over the floored and the raw own gap,
and the largest gaps to JAX-fp32 (every gap of scale: max |difference| over
max |JAX-fp32|).

    JAX_PLATFORMS=cpu python tests/bf16_grad_sweep.py [--loss l1|l2]

About four minutes on the CPU.
"""
import argparse
import os
import sys

os.environ.setdefault("XLA_FLAGS", "--xla_backend_optimization_level=0")
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from flax_params import random_flax_params  # noqa: E402
from tmdiff_tpu.diffusion import gaussian as jax_gaussian  # noqa: E402
from tmdiff_tpu.diffusion.schedules import NoiseSchedule as JaxNoiseSchedule  # noqa: E402
from tmdiff_tpu.models import WavBEST as JaxWavBEST  # noqa: E402
from tmdiff_tpu.ops import modconv as jax_modconv  # noqa: E402
from tmdiff_tpu_torch.diffusion.schedules import NoiseSchedule  # noqa: E402
from tmdiff_tpu_torch.models import blocks  # noqa: E402
from tmdiff_tpu_torch.models.wavbest import WavBEST  # noqa: E402
from tmdiff_tpu_torch.train.trainer import Trainer  # noqa: E402
from tmdiff_tpu_torch.utils.weights import from_flax  # noqa: E402

CHANNELS, SIZE = (8, 16, 32, 64), 32


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--loss", default="l2", choices=("l1", "l2"))
    loss_type = parser.parse_args().loss
    jax_modconv.CONV3D_IMPL = "banded"
    blocks.DROPOUT = 0.0
    ns = JaxNoiseSchedule.create("cosine", 1000)
    as_port = lambda tree: from_flax(WavBEST(CHANNELS, device="cpu"),
                                     jax.tree.map(np.asarray, tree)).state_dict()
    for bands in (4, 8):
        fns = {}
        for dtype in (jnp.float32, jnp.bfloat16):
            model = JaxWavBEST(channels=CHANNELS, dtype=dtype)
            fns[dtype] = jax.jit(jax.value_and_grad(
                lambda p, key, res, pan, ms, prompt, model=model: jax_gaussian.diffusion_loss(
                    lambda x, t, a, b: model.apply(p, x, t, a, b, prompt), ns, key, res, pan, ms,
                    loss_type)))
        for seed in (7, 8, 9):
            params = random_flax_params(JaxWavBEST(channels=CHANNELS), seed=seed)
            rng = np.random.default_rng(bands + seed)
            ms = rng.uniform(0.05, 0.95, (2, bands, SIZE, SIZE)).astype(np.float32)
            pan = (ms.mean(1, keepdims=True)
                   + 0.05 * rng.standard_normal((2, 1, SIZE, SIZE))).astype(np.float32)
            res = (0.1 * rng.standard_normal((2, bands, SIZE, SIZE))).astype(np.float32)
            prompt = rng.standard_normal(768).astype(np.float32)
            key = jax.random.key(seed)
            out = {dt: fn(params, key, res, pan, ms, prompt) for dt, fn in fns.items()}
            rng_t, rng_noise = jax.random.split(key)
            t = jax.random.randint(rng_t, (2,), 1, 1001)
            noise = jax.random.normal(rng_noise, res.shape, jnp.float32)
            port = from_flax(WavBEST(CHANNELS, device="cpu", dtype=torch.bfloat16),
                             jax.tree.map(np.asarray, params))
            trainer = Trainer(port, NoiseSchedule.create("cosine", 1000), loss_type=loss_type)
            batch = {"Res": torch.tensor(res), "PAN": torch.tensor(pan), "MS": torch.tensor(ms)}
            loss = trainer.loss(0, batch, torch.tensor(prompt),
                                t=torch.as_tensor(np.asarray(t), dtype=torch.int64),
                                noise=torch.as_tensor(np.asarray(noise)))
            loss.backward()
            l32, l16 = float(out[jnp.float32][0]), float(out[jnp.bfloat16][0])
            ref32, ref16 = as_port(out[jnp.float32][1]), as_port(out[jnp.bfloat16][1])
            rows = []
            for name, p in port.named_parameters():
                got, a, b = (np.asarray(x, np.float64) for x in (p.grad, ref32[name], ref16[name]))
                scale = np.abs(a).max()
                rows.append((np.abs(got - b).max() / scale, np.abs(b - a).max() / scale,
                             np.abs(got - a).max() / scale))
            floor = np.median([own for _, own, _ in rows])
            print(f"bands {bands} seed {seed} {loss_type}: loss gap to JAX-bf16 "
                  f"{abs(loss.item() - l16) / l32:.3g}, to JAX-fp32 {abs(loss.item() - l32) / l32:.3g}, "
                  f"JAX's own {abs(l16 - l32) / l32:.3g}; median own gradient gap {floor:.4f}; "
                  f"largest gap / max(own, median) {max(g / max(o, floor) for g, o, _ in rows):.2f}, "
                  f"gap / own {max(g / o for g, o, _ in rows if o > 0):.2f}; largest gap to "
                  f"JAX-fp32 {max(f for _, _, f in rows):.4f}, JAX-bf16's own "
                  f"{max(o for _, o, _ in rows):.3f}", flush=True)


if __name__ == "__main__":
    main()
