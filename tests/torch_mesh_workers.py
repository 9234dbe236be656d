"""Worker functions of the port's mesh tests (tests/test_torch_mesh.py,
tests/test_torch_mesh_train.py, tests/test_torch_serve_mesh.py,
tests/test_torch_controlnet.py), run on every rank of a world spawned by
tmdiff_tpu_torch/parallel/dryrun.py. They import torch, numpy and the port
only, so the ranks never load JAX; the tests compare what they return with
the single-process port and the JAX package."""
import numpy as np
import torch

from tmdiff_tpu_torch.models import blocks
from tmdiff_tpu_torch.models.wavbest import WavBEST
from tmdiff_tpu_torch.ops import modconv
from tmdiff_tpu_torch.parallel import halo
from tmdiff_tpu_torch.parallel import mesh as mesh_lib
from tmdiff_tpu_torch.parallel.mesh import make_mesh

CHANNELS = (4, 8, 8, 16)


def _t(a):
    return torch.as_tensor(np.asarray(a, np.float32))


def _model(state_dict, channels=CHANNELS, dtype=torch.float32):
    model = WavBEST(channels, device="cpu", dtype=dtype)
    model.load_state_dict({k: _t(v) for k, v in state_dict.items()})
    return model


def exchange(meshes, seed: int = 0):
    """exchange_rows forward and backward on each (data, space) mesh, for a
    global (B, D, H, W, C) tensor and an upstream gradient made from `seed`:
    per mesh, this rank's (d, s), padded output and input gradient."""
    out = []
    for data, space in meshes:
        mesh = make_mesh(data, space)
        rng = np.random.default_rng(seed)
        x = _t(rng.standard_normal((4, 3, 8 * space, 5, 2)))
        placed = mesh.place(tuple(x.shape))
        xs = placed.shard(x).clone().requires_grad_(True)
        mesh_lib.reset_stats()
        y = halo.exchange_rows(xs, placed)
        h = y.shape[2]  # H + 2 rows each where the height is split
        g = _t(rng.standard_normal((4, 3, placed.space * h, 5, 2)))
        g = g[placed.batch_slice(4)][:, :, placed.s * h:(placed.s + 1) * h]
        y.backward(g)
        out.append({"d": placed.d, "s": placed.s, "y": y.detach().numpy(),
                    "grad": xs.grad.numpy(), "g": g.numpy(), "stats": dict(mesh_lib.stats)})
    return out


CONV_CASES = ("style_bias", "accumulate", "cat2", "grouped_skip")


def convs(meshes, seed: int = 0):
    """Each conv entry in both lowerings on a space-sharded input against the
    same call unsharded: per mesh, lowering and case, the gathered output's
    largest difference relative to the unsharded output's scale."""
    errs = {}
    for data, space in meshes:
        mesh = make_mesh(data, space)
        for impl in modconv.IMPLS:
            for case in CONV_CASES:
                rng = np.random.default_rng(seed)
                x = _t(rng.standard_normal((4, 3, 8 * space, 6, 8)))
                x2 = _t(rng.standard_normal((4, 3, 8 * space, 6, 4)))
                k = _t(rng.standard_normal((3, 3, 3, 8, 8)) * 0.1)
                k12 = _t(rng.standard_normal((3, 3, 3, 12, 8)) * 0.1)
                style = _t(rng.uniform(0.5, 1.5, (4, 8)))
                bias = _t(rng.standard_normal(8))
                acc = _t(rng.standard_normal((4, 3, 8 * space, 6, 8)))
                gw = _t(rng.standard_normal((3, 3, 3, 8, 12)) * 0.1)
                gb = _t(rng.standard_normal(12))
                placed = mesh.place(tuple(x.shape))

                def run(m, sh):
                    if case == "style_bias":
                        return modconv.conv3d(sh(x), k, style=sh(style), bias=bias, impl=impl,
                                              mesh=m)
                    if case == "accumulate":
                        return modconv.conv3d(sh(x), k, bias=bias, out=sh(acc).clone(),
                                              impl=impl, mesh=m)
                    if case == "cat2":
                        return modconv.conv3d_cat((sh(x), sh(x2)), k12, bias=bias, impl=impl,
                                                  mesh=m)
                    conv = blocks.GroupedSkipConv(8, 4)
                    with torch.no_grad():
                        conv.weight.copy_(gw)
                        conv.bias.copy_(gb)
                    conv.impl, conv.mesh = impl, m
                    parts = conv((sh(x), sh(x) * 0.5, sh(x) ** 2))
                    return torch.cat(parts, dim=-1)

                with torch.no_grad():
                    got = placed.gather(run(placed, placed.shard))
                    ref = run(None, lambda a: a)
                errs[(data, space, impl, case)] = float((got - ref).abs().max()
                                                        / ref.abs().max())
    return errs


def thresholding(meshes, seed: int = 0):
    """dynamic_thresholding at a small max_val (so that it clamps) on each
    mesh's shard against the unsharded call: the gathered result's largest
    difference."""
    from tmdiff_tpu_torch.diffusion.dpm_solver import dynamic_thresholding

    out = {}
    for data, space in meshes:
        placed = make_mesh(data, space).place((4, 3, 8 * space, 8))
        x = _t(np.random.default_rng(seed).standard_normal((4, 3, 8 * space, 8)))
        got = placed.gather(dynamic_thresholding(placed.shard(x), 0.9, 0.3, placed))
        out[(data, space)] = float((got - dynamic_thresholding(x, 0.9, 0.3)).abs().max())
    return out


def run_all(tasks):
    """[(name of a function of this module, args, kwargs), ...] run in
    order: one world serves a test module's cases."""
    return [globals()[name](*args, **kwargs) for name, args, kwargs in tasks]


def sample(mesh_shape, state_dict, batch, cases, n_timestep: int = 10):
    """Pansharpener.sample on the mesh for each (name, kwargs) case: every
    case's (gathered) image, the halo and collective counts of each, and
    the mesh's repr."""
    from tmdiff_tpu_torch.pipeline import Pansharpener

    mesh = make_mesh(*mesh_shape)
    sharp = Pansharpener(_model(state_dict), n_timestep=n_timestep, device="cpu", mesh=mesh)
    out, stats = {}, {}
    for name, kw in cases:
        mesh_lib.reset_stats()
        kw = dict(kw)
        run = sharp.sample_tiled if kw.pop("tiled", False) else sharp.sample
        out[name] = run(kw.pop("batch", batch), **kw)
        stats[name] = dict(mesh_lib.stats)
    return out, stats, repr(mesh)


def adaptive(mesh_shape, state_dict, batch, x_T, n_timestep: int = 10):
    """DPMSolver.sample_adaptive (order 3) with the WavBEST denoiser on this
    rank's shard; (the gathered result, its stats), or unsharded with
    mesh_shape None (in a process of its own)."""
    from tmdiff_tpu_torch.diffusion.dpm_solver import DPMSolver, NoiseScheduleVP, WrappedModel
    from tmdiff_tpu_torch.diffusion.schedules import make_beta_schedule
    from tmdiff_tpu_torch.models.clip_text import load_prompt_table

    model = _model(state_dict)
    mesh = None if mesh_shape is None else make_mesh(*mesh_shape).place(np.shape(batch["MS"]))
    shard = (lambda a: a) if mesh is None else mesh.shard
    model.use_mesh(mesh)
    table, index, _ = load_prompt_table()
    with torch.inference_mode():
        cache = model.encode_condition(shard(_t(batch["PAN"])), shard(_t(batch["MS"])),
                                       _t(table[index["WV3"]]))
        solver = DPMSolver(WrappedModel(lambda x, t: model.denoise(x, t, cache)),
                           NoiseScheduleVP("discrete",
                                           betas=make_beta_schedule("cosine", n_timestep)),
                           mesh=mesh)
        x, stats = solver.sample_adaptive(shard(_t(x_T)), order=3, return_stats=True)
    return (x if mesh is None else mesh.gather(x)).numpy(), stats


def train(mesh_shape, state_dict, batches, prompt, *, draws=None, remat=True, dropout=True,
          lr=2e-3, warmup=2, distill_n=None):
    """Steps of Trainer.train_step (DistillTrainer with `distill_n`, the
    teacher the initial weights) on the mesh (None: one process), one per
    global batch: the losses, every gradient of step 0 after the
    all-reduce, the parameters after the last step, the EMA, and the
    collective counts of the last step. `draws` gives each step's t and
    noise (the global batch's); `dropout=False` sets the blocks' rate to 0."""
    rate = blocks.DROPOUT
    blocks.DROPOUT = rate if dropout else 0.0
    try:
        return _train(mesh_shape, state_dict, batches, prompt, draws, remat, lr, warmup,
                      distill_n)
    finally:
        blocks.DROPOUT = rate


def _train(mesh_shape, state_dict, batches, prompt, draws, remat, lr, warmup, distill_n):
    from tmdiff_tpu_torch.diffusion.schedules import NoiseSchedule
    from tmdiff_tpu_torch.train.distill import DistillTrainer
    from tmdiff_tpu_torch.train.trainer import Trainer

    model = _model(state_dict)
    mesh = None if mesh_shape is None else make_mesh(*mesh_shape)
    kw = dict(lr=lr, warmup_steps=warmup, max_iter=1000, remat=remat, mesh=mesh)
    if distill_n:
        trainer = DistillTrainer(model, NoiseSchedule.create("cosine", 1000),
                                 n_student_steps=distill_n, **kw)
        extra = ({n: p.detach().clone() for n, p in model.named_parameters()},)
    else:
        trainer = Trainer(model, NoiseSchedule.create("cosine", 1000), **kw)
        extra = ()
    state = trainer.init_state()
    losses, grads = [], None
    for k, batch in enumerate(batches):
        mesh_lib.reset_stats()
        step_draws = {} if draws is None else {n: torch.as_tensor(v[k]) for n, v in
                                                draws.items()}
        state, metrics = trainer.train_step(state, batch, _t(prompt), *extra, **step_draws)
        losses.append(float(metrics["l_pix"]))
        if k == 0:
            grads = {n: p.grad.numpy().copy() for n, p in model.named_parameters()}
    params = {n: p.detach().numpy().copy() for n, p in model.named_parameters()}
    ema = np.concatenate([e.numpy().ravel() for e in state.ema_params])
    return {"losses": losses, "grads": grads, "params": params, "ema": ema,
            "stats": dict(mesh_lib.stats)}


def serve(mesh_shape, state_dict, channels, dtype, waves, engine_kw, n_timestep: int = 10):
    """The serving engine on a MeshLeader (rank 0) and `follow` (every other
    rank) over a `mesh_shape` mesh of a model in `dtype`: rank 0 submits
    each wave of (pan, ms, sensor) requests at once and waits for it before
    the next. Rank 0 returns every image and placement, the leader's and
    the engine's stats; every rank returns its own stats."""
    from tmdiff_tpu_torch.pipeline import Pansharpener
    from tmdiff_tpu_torch.serve.engine import InferenceEngine
    from tmdiff_tpu_torch.serve.mesh import MeshLeader, follow

    mesh = make_mesh(*mesh_shape)
    sharp = Pansharpener(_model(state_dict, channels, getattr(torch, dtype)),
                         n_timestep=n_timestep, device="cpu", mesh=mesh)
    if mesh.rank != 0:
        return {"stats": follow(sharp)}
    leader = MeshLeader(sharp)
    engine = InferenceEngine(leader, **engine_kw)
    images, placements, errors = [], [], []
    try:
        for wave in waves:
            futs = [engine.submit(pan, ms, sensor) for pan, ms, sensor in wave]
            for f in futs:
                try:
                    images.append(f.result(timeout=240))
                    errors.append(None)
                except ValueError as err:
                    images.append(None)
                    errors.append(str(err))
                placements.append(getattr(f, "placement", None))
    finally:
        engine.shutdown()
        leader.stop()
    return {"stats": leader.stats, "images": images, "placements": placements,
            "errors": errors, "engine": dict(engine.stats), "mesh": repr(mesh)}


def controlnet_finetune(mesh_shape, state_dict, channels, batch, hint, target, task_feat,
                        steps: int = 2):
    """Adam steps (lr 1e-2) of a ControlledLegacyUNet (embed 16, inter 8) on
    its "train" parameters (sd_locked) with the loss mean((y - target)^2),
    data-parallel on a `mesh_shape` (data, 1) mesh (each rank its rows of
    the global batch, the gradients and the loss summed over the world) or
    in one process with mesh_shape None: the losses and the trained
    parameters."""
    from tmdiff_tpu_torch.models.controlnet import (ControlledLegacyUNet, trainable_labels,
                                                    trainable_parameters)

    mesh = None if mesh_shape is None else make_mesh(*mesh_shape)
    placed = None if mesh is None else mesh.place(np.shape(batch["x_t"]))
    shard = (lambda a: a) if mesh is None else placed.shard
    model = ControlledLegacyUNet(channels, embed_dim=16, inter_dim=8, device="cpu")
    model.load_state_dict({k: _t(v) for k, v in state_dict.items()})
    labels = trainable_labels(model, sd_locked=True)
    params = trainable_parameters(model, labels)
    opt = torch.optim.Adam(params, lr=1e-2)
    inputs = {k: _t(v) if k == "prompt_emb" else shard(_t(v)) for k, v in batch.items()}
    hint, target = shard(_t(hint)), shard(_t(target))
    losses = []
    for _ in range(steps):
        opt.zero_grad()
        y = model(**inputs, hint=hint, task_id=1, task_feat=task_feat)
        loss = torch.mean((y - target) ** 2) / (1 if mesh is None else mesh.data)
        loss.backward()
        if mesh is not None:
            for p in params:
                if p.grad is not None:
                    mesh_lib.all_reduce_(p.grad, mesh)
            loss = mesh_lib.all_reduce_(loss.detach(), mesh)
        opt.step()
        losses.append(loss.item())
    return {"losses": losses,
            "params": {n: p.detach().numpy() for n, p in model.named_parameters()
                       if labels[n] == "train"}}
