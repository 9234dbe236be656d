"""bf16 training over the port's ("data", "space") mesh on the CPU: a bf16
WavBEST's Trainer.train_step on a (2, 2) gloo world (K1's bf16 plain
version forward and input gradient on the halo shards' H_l + 2 rows)
against one process's bf16 steps, and with JAX's draws against the JAX
Trainer's bf16 model on its (4, 2) mesh; a bf16 DistillTrainer step on
(1, 2); the bf16 ControlNet sd_locked fine-tune data-parallel on (2, 1);
and the bf16 halo exchange itself. Worlds are spawned by
parallel/dryrun.py and run tests/torch_mesh_workers.py (torch and the port
only). WavBEST widths (8, 16, 32, 64), 32x32, batch 8, 4 bands.

The bars:
  * losses against one process's bf16 steps: step 0 within 1e-4 relative
    (the meshed forward computes one process's bits; the loss is summed
    over the ranks in another order), later steps within 1e-3 (their
    weights moved by gradients that differ as below);
  * step-0 gradients: the MODEL BAR of tests/test_torch_bf16_train.py with
    one process's bf16 step in JAX-bf16's place and one process's fp32 step
    in JAX-fp32's: each gradient's gap to one process's bf16 within twice
    that one's own gap to fp32 (floored at the median over parameters), and
    within 5e-2 of its scale of the fp32 one. The meshed bf16 step rounds
    in three places where one process rounds once: each rank's weight
    gradient (summed in fp32 by the all-reduce), ds and db per shard, and
    the edge rows of each shard's input gradient (the halo backward adds
    the neighbour's pad gradient, itself rounded to bf16 by K1, into the
    rank's own rounded row: `test_halo_edge_rows_in_bf16` measures it).
    The losses are L2, as there (an L1 gradient is the sign of pred -
    target, which bf16's forward noise flips);
  * parameters after two steps: the fp32 mesh test's bars (atol 5e-3,
    rtol 2e-3): Adam's first steps move each weight by about the lr (2e-3
    here) whatever the gradient's size, so a sign flip of a near-zero
    gradient moves it by twice that;
  * parameters, AdamW moments and the EMA float32 and bit-identical across
    the ranks; one collective a step; every K1 launch, forward and input
    gradient, in bf16 (130 + 65 a step);
  * against the JAX bf16 Trainer (dropout off, JAX's t and noise handed to
    the port, L2 on both sides): the losses within 2e-2 of JAX-bf16's and
    of JAX-fp32's (the forward's MODEL cap of
    tests/test_torch_bf16_train.py), and step 0's all-reduced gradients at
    the MODEL BAR against the JAX bf16 and fp32 Trainers' gradients on
    their (4, 2) mesh;
  * the bf16 ControlNet fine-tune (Adam, lr 1e-2, two steps) against one
    process's: the losses within 2e-2, the first step's gradients at the
    MODEL BAR, and Adam's first moments after the last step within twice
    one process's own gap to its fp32 fine-tune (floored at the median):
    the MODEL BAR without its cap, since the fp32 run's second gradient is
    taken at its own weights. Each trained parameter within half an Adam
    step (atol lr / 2, rtol 2e-3), except where one process's first moment
    lies within the meshed moment's largest gap of zero: there the second
    step's direction is bf16 noise, and the element may be up to two
    steps off (2 lr). Such elements stay below 1e-4 of all.
"""
import os
from concurrent.futures import ThreadPoolExecutor

import flax.linen as flax_nn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from flax_params import random_flax_params
from test_torch_bf16_train import assert_gradients_model_bar, assert_loss_bar
from test_torch_mesh_train import PARAM_ATOL, PARAM_RTOL, _jax_draws, _NoDropout
from tmdiff_tpu.diffusion.schedules import NoiseSchedule as JaxNoiseSchedule
from tmdiff_tpu.models import WavBEST as JaxWavBEST
from tmdiff_tpu.parallel import make_mesh as jax_make_mesh
from tmdiff_tpu.train.trainer import Trainer as JaxTrainer
from tmdiff_tpu_torch.models.clip_text import load_prompt_table
from tmdiff_tpu_torch.models.controlnet import ControlledLegacyUNet, task_feature
from tmdiff_tpu_torch.models.wavbest import WavBEST
from tmdiff_tpu_torch.parallel.dryrun import run_world
from tmdiff_tpu_torch.utils.weights import from_flax

torch.set_num_threads(2)

TESTS = os.path.dirname(os.path.abspath(__file__))
CHANNELS = (8, 16, 32, 64)
SIZE, BATCH, BANDS = 32, 8, 4
FIRST_LOSS_RTOL, LATER_LOSS_RTOL = 1e-4, 1e-3
BF16 = dict(dtype="bfloat16", channels=CHANNELS)
STEP = dict(BF16, loss_type="l2")  # dropout and remat on (the worker's defaults)
DISTILL = dict(STEP, distill_n=5)
JAX_DRAWS = dict(BF16, dropout=False, loss_type="l2")
# the ControlNet fine-tune: tests/test_torch_controlnet.py's widths, batch 8,
# the worker's Adam lr; the parameter bars of the module doc
CN_CH, CN_D, CN_SIZE = (8, 12, 16, 20), 4, 16
CN_LR = 1e-2
CN_PARAM_ATOL = CN_LR / 2
CN_NOISY_SHARE = 1e-4


def _batches(n=2):
    rng = np.random.default_rng(1)
    out = []
    for _ in range(n):
        ms = rng.uniform(0.1, 0.9, (BATCH, BANDS, SIZE, SIZE)).astype(np.float32)
        pan = ms.mean(1, keepdims=True) + 0.05 * rng.standard_normal((BATCH, 1, SIZE, SIZE))
        res = 0.1 * rng.standard_normal((BATCH, BANDS, SIZE, SIZE))
        out.append({"Res": res.astype(np.float32), "PAN": pan.astype(np.float32), "MS": ms})
    return out


def _controlnet_case():
    """A live ControlledLegacyUNet's state (every zero conv drawn off zero,
    a trained adapter's state) and its fine-tune inputs, from a seed."""
    model = ControlledLegacyUNet(CN_CH, embed_dim=16, inter_dim=8, device="cpu", seed=3)
    rng = np.random.default_rng(4)
    state = {}
    for name, v in model.state_dict().items():
        v = v.numpy()
        if not v.any():
            v = (0.05 * rng.standard_normal(v.shape)).astype(np.float32)
        state[name] = v
    shape = (BATCH, CN_D, CN_SIZE, CN_SIZE)
    batch = {"x_t": rng.standard_normal(shape), "t": rng.uniform(1, 900, BATCH),
             "pan": rng.standard_normal(shape), "ms": rng.standard_normal(shape),
             "prompt_emb": rng.standard_normal(768)}
    batch = {k: np.asarray(v, np.float32) for k, v in batch.items()}
    hint = rng.standard_normal((BATCH, CN_SIZE, CN_SIZE, 3)).astype(np.float32)
    target = rng.standard_normal(shape).astype(np.float32)
    return (state, CN_CH, batch, hint, target, np.asarray(task_feature("control_canny")))


@pytest.fixture(scope="module")
def carried():
    jmodel = JaxWavBEST(channels=CHANNELS)
    params = random_flax_params(jmodel, seed=11)
    port = from_flax(WavBEST(CHANNELS, device="cpu"), jax.tree.map(np.asarray, params))
    state = {k: v.numpy() for k, v in port.state_dict().items()}
    table, index, _ = load_prompt_table()
    return params, state, _batches(), np.asarray(table[index["WV3"]], np.float32)


SINGLES = ("bf16", "fp32", "distill_bf16", "distill_fp32", "controlnet_bfloat16",
           "controlnet_float32")


@pytest.fixture(scope="module")
def worlds(carried):
    """The worlds, started together in the background: (2, 2) with two bf16
    steps (dropout on) and two with JAX's draws (dropout off); a 2-rank
    world with the bf16 halo, a (1, 2) bf16 distillation step and the
    (2, 1) bf16 ControlNet fine-tune; and one process (a world of one rank)
    with the references: bf16 and fp32 training (dropout on, L2), bf16 and
    fp32 distillation, the bf16 and fp32 ControlNet fine-tune."""
    _, state, batches, prompt = carried
    args = (state, batches, prompt)
    fp32 = lambda kw: dict(kw, dtype="float32")
    case = _controlnet_case()
    tasks = {
        4: [("train", ((2, 2), *args), STEP),
            ("train", ((2, 2), *args), dict(JAX_DRAWS, draws=_jax_draws(batches)))],
        2: [("halo_bf16", (2,), {}),
            ("train", ((1, 2), state, batches[:1], prompt), DISTILL),
            ("controlnet_finetune", ((2, 1), *case), {"dtype": "bfloat16"})],
        1: [("train", (None, *args), STEP), ("train", (None, *args), fp32(STEP)),
            ("train", (None, state, batches[:1], prompt), DISTILL),
            ("train", (None, state, batches[:1], prompt), fp32(DISTILL)),
            ("controlnet_finetune", (None, *case), {"dtype": "bfloat16"}),
            ("controlnet_finetune", (None, *case), {"dtype": "float32"})]}
    with ThreadPoolExecutor(3) as pool:
        yield {n: pool.submit(run_world, "torch_mesh_workers:run_all", n, (t,),
                              sys_path=[TESTS], threads=1 if n > 1 else 2, timeout=400)
               for n, t in tasks.items()}


@pytest.fixture(scope="module")
def singles(worlds):
    """One process's steps (the world of one rank), by name."""
    return dict(zip(SINGLES, worlds[1].result()[0]))


@pytest.fixture(scope="module")
def jax_losses(carried):
    """The JAX Trainer's two L2 losses on its (4, 2) mesh with the bf16 and
    the fp32 model, dropout off, the same weights and hyperparameters as the
    port's (remat off there: recomputing changes no value), and step 0's
    gradients under the port's names. The step reports
    `optax.global_norm(grads)` in its metrics; with that function patched to
    the identity for the fixture, the jitted step returns the gradient tree
    itself, with no second compile."""
    params, _, batches, prompt = carried
    out = {}
    with pytest.MonkeyPatch.context() as m:
        m.setattr(flax_nn, "Dropout", _NoDropout)
        m.setattr(optax, "global_norm", lambda tree: tree)
        for dtype in (jnp.bfloat16, jnp.float32):
            trainer = JaxTrainer(model=JaxWavBEST(channels=CHANNELS, dtype=dtype),
                                 schedule=JaxNoiseSchedule.create("cosine", 1000), lr=2e-3,
                                 warmup_steps=2, max_iter=1000, loss_type="l2",
                                 mesh=jax_make_mesh(data=4, space=2), remat=False)
            state, losses, grads = trainer.state_from_params(params), [], None
            for batch in batches:
                state, metrics = trainer.train_step(state, batch, prompt)
                losses.append(float(metrics["l_pix"]))
                if grads is None:
                    grads = from_flax(WavBEST(CHANNELS, device="cpu"),
                                      jax.tree.map(np.asarray, metrics["grad_norm"]))
            out[dtype] = {"losses": losses,
                          "grads": {k: v.numpy() for k, v in grads.state_dict().items()}}
    return out


# JAX's trainers run while the worlds do
@pytest.fixture(scope="module")
def world4(worlds, jax_losses):
    return worlds[4].result()


@pytest.fixture(scope="module")
def world2(worlds, jax_losses):
    return worlds[2].result()


def _grads(res):
    return {n: torch.as_tensor(g) for n, g in res["grads"].items()}


def test_meshed_bf16_steps_match_one_process(world4, singles):
    """Two bf16 steps on (2, 2), remat and dropout on: the loss, gradient
    and parameter bars of the module doc against one process's bf16 steps;
    fp32 state bit-identical on every rank; one collective and 130 + 65
    bf16 K1 launches (plain versions on the CPU) a step, none in fp32."""
    res = [r[0] for r in world4]
    one, fp32 = singles["bf16"], singles["fp32"]
    got = res[0]["losses"]
    assert abs(got[0] - one["losses"][0]) <= FIRST_LOSS_RTOL * abs(one["losses"][0]), got
    assert abs(got[1] - one["losses"][1]) <= LATER_LOSS_RTOL * abs(one["losses"][1]), got
    assert_gradients_model_bar(_grads(res[0]), fp32["grads"], one["grads"])
    for name, p in one["params"].items():
        assert p.dtype == np.float32
        np.testing.assert_allclose(res[0]["params"][name], p, atol=PARAM_ATOL, rtol=PARAM_RTOL,
                                   err_msg=name)
    assert res[0]["ema"].dtype == np.float32
    assert all(m.dtype == np.float32 for m in res[0]["moments"])
    assert len(res[0]["moments"]) == 2 * len(one["params"])
    for r in res[1:]:
        assert r["losses"] == got
        for name, p in res[0]["params"].items():
            np.testing.assert_array_equal(r["params"][name], p, err_msg=name)
        np.testing.assert_array_equal(r["ema"], res[0]["ema"])
        for a, b in zip(r["moments"], res[0]["moments"]):
            np.testing.assert_array_equal(a, b)
    for r in res:
        assert r["stats"]["collectives"] == 1
        assert r["launches"] == {("bfloat16", False): 130, ("bfloat16", True): 65}
    assert one["launches"] == {("bfloat16", False): 130, ("bfloat16", True): 65}


def test_meshed_bf16_steps_match_the_jax_bf16_mesh(world4, jax_losses):
    """The port's bf16 model on (2, 2) with the JAX trainer's t and noise,
    against the JAX Trainer's bf16 model on its (4, 2) mesh, dropout off and
    L2 on both sides: each loss within LOSS_CAP of JAX-bf16's and
    JAX-fp32's, and every all-reduced step-0 gradient at the MODEL BAR
    against the JAX bf16 and fp32 Trainers' (equal on every rank)."""
    j16, j32 = jax_losses[jnp.bfloat16], jax_losses[jnp.float32]
    for r in world4:
        for got, l16, l32 in zip(r[1]["losses"], j16["losses"], j32["losses"]):
            assert_loss_bar(got, l16, l32)
        assert_gradients_model_bar(_grads(r[1]), j32["grads"], j16["grads"])


def test_halo_edge_rows_in_bf16(world2):
    """The bf16 halo on (1, 2): the rows cross gloo as bf16 (half the fp32
    exchange's bytes, received in bf16), and a bf16 conv's input gradient
    on the shards equals the unsharded one bit for bit except on the edge
    rows, where the neighbour's pad gradient (rounded to bf16 by its K1)
    is added to the rank's own rounded row and the sum rounded: three
    roundings of two parts that may cancel, against one rounding of the
    whole. Each edge element stays within one bf16 step at the gradient's
    scale (the gap is printed)."""
    for r in (ranks[0] for ranks in world2):
        bf, fp = r["torch.bfloat16"], r["torch.float32"]
        assert bf["dtype"] == "torch.bfloat16" and fp["dtype"] == "torch.float32"
        assert 2 * bf["halo_bytes"] == fp["halo_bytes"] > 0
        got, want = r["sharded"], r["unsharded"]
        edge = 0 if r["s"] == 1 else got.shape[2] - 1
        inner = [i for i in range(got.shape[2]) if i != edge]
        np.testing.assert_array_equal(got[:, :, inner], want[:, :, inner])
        gap = np.abs(got[:, :, edge] - want[:, :, edge])
        step = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
        print(f"rank s={r['s']}: edge-row gap {gap.max():.3g} = {gap.max() / step:.3g} bf16 "
              f"steps at the gradient's scale {np.abs(want).max():.3g}; "
              f"{np.mean(gap > 0):.3f} of the edge elements differ")
        assert gap.max() <= step


def test_bf16_distill_step_on_space_mesh(world2, singles):
    """One bf16 DistillTrainer step (N = 5) on (1, 2): the teacher's two
    calls and the student on halo shards; the loss within 1e-4 of one
    process's bf16 step and every gradient at the MODEL BAR (one process's
    fp32 step as the reference)."""
    one = singles["distill_bf16"]
    for r in (ranks[1] for ranks in world2):
        assert abs(r["losses"][0] - one["losses"][0]) <= FIRST_LOSS_RTOL * abs(one["losses"][0])
        assert_gradients_model_bar(_grads(r), singles["distill_fp32"]["grads"], one["grads"])
        # per student step: 2 teacher calls, the student and remat's recompute
        assert r["launches"] == {("bfloat16", False): 4 * 65, ("bfloat16", True): 65}


def test_bf16_controlnet_finetune_data_parallel(world2, singles):
    """The sd_locked ControlNet fine-tune in bf16 on (2, 1), each rank half
    the batch, against one process's bf16 and fp32 fine-tunes at the bars
    of the module doc: the losses, the first step's gradients, Adam's first
    moments after the last step, and the trained parameters (equal on both
    ranks)."""
    one, fp32 = singles["controlnet_bfloat16"], singles["controlnet_float32"]
    ranks = [r[2] for r in world2]
    for got, l16, l32 in zip(ranks[0]["losses"], one["losses"], fp32["losses"]):
        assert_loss_bar(got, l16, l32)
    assert_gradients_model_bar(_grads(ranks[0]), fp32["grads"], one["grads"])
    moment_gap = _assert_moments_bar(ranks[0]["exp_avg"], fp32["exp_avg"], one["exp_avg"])
    noisy = total = 0
    for name, p in one["params"].items():
        got = ranks[0]["params"][name]
        gap = np.abs(got - p)
        over = gap > CN_PARAM_ATOL + PARAM_RTOL * np.abs(p)
        total += p.size
        if over.any():
            near_zero = np.abs(one["exp_avg"][name][over]) <= moment_gap[name]
            assert near_zero.all() and (gap[over] <= 2 * CN_LR).all(), (name, gap[over])
            noisy += int(over.sum())
        np.testing.assert_array_equal(ranks[1]["params"][name], got)
    print(f"{noisy} of {total} trained elements beyond lr / 2, each where the first moment "
          "lies within the meshed moment's gap of zero")
    assert noisy <= CN_NOISY_SHARE * total, (noisy, total)


def _assert_moments_bar(got, ref32, ref16):
    """Each first moment of `got` within twice `ref16`'s own gap to
    `ref32` (floored at the median over parameters), of `ref32`'s scale;
    returns each parameter's largest |got - ref16|."""
    rows = {}
    for name, m in got.items():
        a, b, g = (np.asarray(t, np.float64) for t in (ref32[name], ref16[name], m))
        scale = np.abs(a).max()
        if scale > 0:
            rows[name] = (np.abs(g - b).max() / scale, np.abs(b - a).max() / scale)
    floor = np.median([own for _, own in rows.values()])
    for name, (gap, own) in rows.items():
        assert gap <= 2 * max(own, floor), (name, gap, own, floor)
    return {name: np.abs(np.asarray(m, np.float64) - ref16[name]).max()
            for name, m in got.items()}
