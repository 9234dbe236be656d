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
from tmdiff_tpu_torch.ops.cuda import conv3d as K
from tmdiff_tpu_torch.parallel import halo
from tmdiff_tpu_torch.parallel import mesh as mesh_lib
from tmdiff_tpu_torch.parallel.mesh import make_mesh

CHANNELS = (4, 8, 8, 16)


def _t(a):
    return torch.as_tensor(np.asarray(a, np.float32))


def _model(state_dict, channels=CHANNELS, dtype=torch.float32, device="cpu"):
    model = WavBEST(channels, device=device, dtype=dtype)
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


def halo_bf16(space: int, seed: int = 0):
    """On a (1, space) mesh: exchange_rows of one bf16 tensor and of its
    fp32 values (the halo bytes each sends and the dtype it receives), then
    a bf16 3x3x3 conv's input gradient on the height shards against the
    unsharded one. Returns this rank's stats and its rows of both input
    gradients."""
    mesh = make_mesh(1, space)
    rng = np.random.default_rng(seed)
    h = 8 * space
    x = _t(rng.standard_normal((2, 4, h, 6, 8))).bfloat16()
    k = _t(rng.standard_normal((3, 3, 3, 8, 8)) / np.sqrt(27 * 8)).bfloat16()
    dy = _t(rng.standard_normal((2, 4, h, 6, 8))).bfloat16()
    placed = mesh.place(tuple(x.shape))
    out = {"s": placed.s}
    for dtype in (torch.bfloat16, torch.float32):
        mesh_lib.reset_stats()
        y = halo.exchange_rows(placed.shard(x).to(dtype), placed)
        out[str(dtype)] = {"halo_bytes": mesh_lib.stats["halo_bytes"], "dtype": str(y.dtype)}
    grads = []
    for m, sh in ((placed, placed.shard), (None, lambda a: a)):
        xs = sh(x).clone().requires_grad_(True)
        modconv.conv3d(xs, k, mesh=m).backward(sh(dy))
        grads.append(xs.grad)
    out["sharded"] = grads[0].float().numpy()
    out["unsharded"] = placed.shard(grads[1]).float().numpy()
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


# the library routes of the conv API on a space split: entry, kernel, stride,
# padding ("SAME" or the explicit pairs of `library_padding`), dtype
LIBRARY_ENTRIES = ("conv3d", "modulated_conv3d", "conv3d_cat", "modulated_conv_transpose3d")
LIBRARY_X = (2, 3, 16, 6, 8)  # (B, D, H, W, C): 16 rows split over two space ranks


def library_padding(entry, kernel, stride):
    """Explicit (lo, hi) pairs whose output height is the height over the
    stride (so the split holds) and that differ from SAME: one-sided along
    the height. For the transposed conv, pairs of the dilated input."""
    kd, kh, kw = kernel
    _, sh, sw = stride
    if entry == "modulated_conv_transpose3d":
        return ((kd - 1, kd - 1), (kh - 1, sh - 1), (kw - 1, sw - 1))
    return (((kd - 1) // 2, kd - 1 - (kd - 1) // 2), (kh - sh, sh - 1), (kw - 1, 0))


def library_inputs(case, seed):
    """The global numpy inputs of a library case: x (two parts for
    conv3d_cat), the kernel, the style (B, Cin) and the bias (Cout)."""
    entry, kernel, _, _, _ = case
    rng = np.random.default_rng(seed)
    cin = LIBRARY_X[-1] + (4 if entry == "conv3d_cat" else 0)
    xs = [rng.standard_normal(LIBRARY_X).astype(np.float32)]
    if entry == "conv3d_cat":
        xs.append(rng.standard_normal(LIBRARY_X[:-1] + (4,)).astype(np.float32))
    k = (rng.standard_normal(tuple(kernel) + (cin, 6)) / np.sqrt(np.prod(kernel) * cin))
    style = rng.uniform(0.5, 1.5, (LIBRARY_X[0], LIBRARY_X[-1]))
    bias = 0.1 * rng.standard_normal(6)
    return xs, k.astype(np.float32), style.astype(np.float32), bias.astype(np.float32)


def library_call(case, xs, k, style, bias, mesh):
    """The entry of `case` on tensors (the x parts, kernel, style, bias;
    the ones it takes) on the placement `mesh` or None."""
    entry, kernel, stride, pad, _ = case
    padding = "SAME" if pad == "SAME" else library_padding(entry, kernel, stride)
    kw = dict(mesh=mesh, padding=padding, stride=stride)
    if entry == "conv3d":
        return modconv.conv3d(xs[0], k, bias=bias, **kw)
    if entry == "modulated_conv3d":
        return modconv.modulated_conv3d(xs[0], k, style, **kw)
    if entry == "conv3d_cat":
        return modconv.conv3d_cat(tuple(xs), k, bias=bias, **kw)
    return modconv.modulated_conv_transpose3d(xs[0], k, style, **kw)


def library_grads(case, seed, mesh=None):
    """The case's output and the gradients of sum(y * dy), dy made from
    `seed` at the global output shape: on `mesh` for this rank's shard
    (its rows of the output and of each x's gradient, its part of the
    kernel's, style's and bias's sums), else for the whole. As float32
    numpy arrays, with the rank's (d, s)."""
    dtype = getattr(torch, case[-1])
    xs, k, style, bias = library_inputs(case, seed)
    placed = None if mesh is None else mesh.place((LIBRARY_X[0],) + LIBRARY_X[1:])
    shard = (lambda a: a) if placed is None else placed.shard
    xs = [shard(_t(x).to(dtype)).clone().requires_grad_(True) for x in xs]
    style_t = shard(_t(style).to(dtype)).clone().requires_grad_(True)
    k_t, bias_t = _t(k).requires_grad_(True), _t(bias).requires_grad_(True)
    with torch.no_grad():
        full = library_call(case, [_t(x).to(dtype) for x in library_inputs(case, seed)[0]], k_t,
                            _t(style).to(dtype), bias_t, None).shape
    dy = _t(np.random.default_rng(seed + 1).standard_normal(tuple(full))).to(dtype)
    y = library_call(case, xs, k_t, style_t, bias_t, placed)
    (y.float() * shard(dy).float()).sum().backward()
    f = lambda t: None if t is None else t.detach().float().numpy()
    return {"d": 0 if placed is None else placed.d, "s": 0 if placed is None else placed.s,
            "y": f(y), "x": [f(x.grad) for x in xs], "kernel": f(k_t.grad),
            "style": f(style_t.grad), "bias": f(bias_t.grad)}


def library_convs(meshes, cases, seed: int = 0):
    """library_grads of every case on each (data, space) mesh: per mesh, a
    list in the cases' order."""
    out = []
    for data, space in meshes:
        mesh = make_mesh(data, space)
        out.append([library_grads(case, seed + i, mesh) for i, case in enumerate(cases)])
    return out


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
          lr=2e-3, warmup=2, distill_n=None, dtype="float32", channels=CHANNELS,
          loss_type="l1", compiled=False, stub_fingerprint=None):
    """Steps of Trainer.train_step (DistillTrainer with `distill_n`, the
    teacher the initial weights), or of its compiled_step with `compiled`,
    of a WavBEST of `channels` computing in `dtype` on the mesh (None: one
    process) on the mesh's device, one per global batch: the losses, every
    gradient of step 0 after the all-reduce, the parameters after the last
    step, the EMA, AdamW's moments, step counts and lr, the collective
    counts of the last step and the conv launches of the last step by
    (dtype, input gradient). `draws` gives each step's t and noise (the
    global batch's); `dropout=False` sets the blocks' rate to 0;
    `loss_type` is the trainer's. `stub_fingerprint` = (rank, call): on
    that rank, from that compiled call on (0 the first), the trainer sees
    its state as new (another fingerprint). With `compiled`, "fresh" says of each call
    whether it made a new entry of its batch shape (on a card: captured).
    """
    rate, launch = blocks.DROPOUT, K._launch
    blocks.DROPOUT = rate if dropout else 0.0
    launches = {}

    def record(x, kernel, style, bias, out, input_grad=False, unsharded=None):
        key = (str(x.dtype).replace("torch.", ""), bool(input_grad))
        launches[key] = launches.get(key, 0) + 1
        return launch(x, kernel, style, bias, out, input_grad, unsharded)

    K._launch = record
    try:
        return _train(mesh_shape, state_dict, batches, prompt, draws, remat, lr, warmup,
                      distill_n, getattr(torch, dtype), channels, loss_type, launches, compiled,
                      stub_fingerprint)
    finally:
        blocks.DROPOUT, K._launch = rate, launch


def _train(mesh_shape, state_dict, batches, prompt, draws, remat, lr, warmup, distill_n,
           dtype, channels, loss_type, launches, compiled, stub_fingerprint):
    from tmdiff_tpu_torch.diffusion.schedules import NoiseSchedule
    from tmdiff_tpu_torch.train.distill import DistillTrainer
    from tmdiff_tpu_torch.train.trainer import Trainer

    mesh = None if mesh_shape is None else make_mesh(*mesh_shape)
    device = "cpu" if mesh is None else mesh.device
    model = _model(state_dict, channels, dtype, device)
    kw = dict(lr=lr, warmup_steps=warmup, max_iter=1000, remat=remat, mesh=mesh,
              loss_type=loss_type)
    if distill_n:
        trainer = DistillTrainer(model, NoiseSchedule.create("cosine", 1000),
                                 n_student_steps=distill_n, **kw)
        extra = ({n: p.detach().clone() for n, p in model.named_parameters()},)
    else:
        trainer = Trainer(model, NoiseSchedule.create("cosine", 1000), **kw)
        extra = ()
    state = trainer.init_state()
    step_draws = lambda k: ({} if draws is None else
                            {n: torch.as_tensor(v[k]).to(device) for n, v in draws.items()})
    if compiled:
        # the compiled step takes no draws: the loss reads them by the step
        if draws is not None:
            loss = trainer.loss
            trainer.loss = lambda step, *a, **kw: loss(step, *a, **kw, **step_draws(step))
        fingerprint = trainer._fingerprint
        calls = []
        if stub_fingerprint is not None and stub_fingerprint[0] == mesh.rank:
            trainer._fingerprint = lambda st: (fingerprint(st) if len(calls) <= stub_fingerprint[1]
                                               else ("stub", len(calls)))
        step_fn = trainer.compiled_step()
    losses, grads, entries = [], None, []
    for k, batch in enumerate(batches):
        mesh_lib.reset_stats()
        launches.clear()
        batch = {n: _t(v).to(device) for n, v in batch.items()}
        if compiled:
            calls.append(k)
            state, metrics = step_fn(state, batch, _t(prompt).to(device), *extra)
            entries.append(trainer._captured[next(iter(trainer._captured))])
        else:
            state, metrics = trainer.train_step(state, batch, _t(prompt).to(device), *extra,
                                                **step_draws(k))
        losses.append(float(metrics["l_pix"]))
        if k == 0:
            grads = {n: p.grad.cpu().numpy().copy() for n, p in model.named_parameters()}
    params = {n: p.detach().cpu().numpy().copy() for n, p in model.named_parameters()}
    ema = np.concatenate([e.cpu().numpy().ravel() for e in state.ema_params])
    moments = [v.cpu().numpy().copy() for st in state.optimizer.state.values()
               for name, v in sorted(st.items()) if name != "step"]
    adamw_steps = [float(st["step"]) for st in state.optimizer.state.values()]
    lrs = [float(g["lr"]) for g in state.optimizer.param_groups]
    captures = trainer.capture_seconds()
    trainer.release_compiled()
    return {"losses": losses, "grads": grads, "params": params, "ema": ema,
            "moments": moments, "adamw_steps": adamw_steps, "lr": lrs, "step": state.step,
            "stats": dict(mesh_lib.stats), "launches": dict(launches),
            "fresh": [k == 0 or e is not entries[k - 1] for k, e in enumerate(entries)],
            "captures": len(captures)}


def bf16_step_shapes(mesh_shape, channels, batch_size, bands, size, seed: int = 0):
    """One bf16 Trainer step of a seeded WavBEST of `channels` on the mesh
    (on the world's device), on a random global batch: this rank's distinct
    K1 input-gradient launches as (dy shape, the launch's Cout, the
    unsharded call's (B, H)), in a fixed order."""
    from tmdiff_tpu_torch.diffusion.schedules import NoiseSchedule
    from tmdiff_tpu_torch.train.trainer import Trainer

    mesh = make_mesh(*mesh_shape)
    model = WavBEST(channels, device=mesh.device, seed=seed, dtype=torch.bfloat16)
    trainer = Trainer(model, NoiseSchedule.create("cosine", 1000), mesh=mesh)
    rng = np.random.default_rng(seed)
    shape = (batch_size, bands, size, size)
    batch = {"Res": 0.1 * rng.standard_normal(shape), "MS": rng.uniform(size=shape),
             "PAN": rng.uniform(size=(batch_size, 1, size, size))}
    seen, launch = set(), K._launch

    def record(x, kernel, style, bias, out, input_grad=False, unsharded=None):
        if input_grad:
            seen.add((tuple(x.shape), int(kernel.shape[-1]), unsharded))
        return launch(x, kernel, style, bias, out, input_grad, unsharded)

    K._launch = record
    try:
        trainer.train_step(trainer.init_state(), batch, np.zeros(768, np.float32))
    finally:
        K._launch = launch
    return sorted(seen, key=repr)


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
                        steps: int = 2, dtype="float32"):
    """Adam steps (lr 1e-2) of a ControlledLegacyUNet (embed 16, inter 8)
    computing in `dtype` on its "train" parameters (sd_locked) with the loss
    mean((y - target)^2), data-parallel on a `mesh_shape` (data, 1) mesh
    (each rank its rows of the global batch, the gradients and the loss
    summed over the world) or in one process with mesh_shape None: the
    losses, the trained parameters, the first step's gradients of them and
    Adam's first moments after the last step."""
    from tmdiff_tpu_torch.models.controlnet import (ControlledLegacyUNet, trainable_labels,
                                                    trainable_parameters)

    mesh = None if mesh_shape is None else make_mesh(*mesh_shape)
    placed = None if mesh is None else mesh.place(np.shape(batch["x_t"]))
    shard = (lambda a: a) if mesh is None else placed.shard
    model = ControlledLegacyUNet(channels, embed_dim=16, inter_dim=8, device="cpu",
                                 dtype=getattr(torch, dtype))
    model.load_state_dict({k: _t(v) for k, v in state_dict.items()})
    labels = trainable_labels(model, sd_locked=True)
    params = trainable_parameters(model, labels)
    opt = torch.optim.Adam(params, lr=1e-2)
    inputs = {k: _t(v) if k == "prompt_emb" else shard(_t(v)) for k, v in batch.items()}
    hint, target = shard(_t(hint)), shard(_t(target))
    losses, grads = [], None
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
        if grads is None:
            grads = {n: p.grad.numpy().copy() for n, p in model.named_parameters()
                     if labels[n] == "train" and p.grad is not None}
        opt.step()
        losses.append(loss.item())
    trained = [(n, p) for n, p in model.named_parameters() if labels[n] == "train"]
    return {"losses": losses, "grads": grads,
            "params": {n: p.detach().numpy() for n, p in trained},
            "exp_avg": {n: opt.state[p]["exp_avg"].numpy().copy() for n, p in trained
                        if p in opt.state}}


def cli_main(argv, eager=False, synthetic=None):
    """tmdiff_tpu_torch.cli.main(argv) on this rank of a joined world; with
    `eager` the train loop's step is train_step (said in the log), where
    the CLI steps through compiled_step. `synthetic` = {sensor: (bands,
    scenes, size)}: the datasets are built in memory (data/synthetic.py,
    batch 2) in place of the config's h5 files, for a machine without
    h5py."""
    from tmdiff_tpu_torch import cli

    if eager:
        def training_step(trainer, logger, say=True):
            logger.info("each step runs train_step")
            return trainer.train_step

        cli.training_step = training_step
    if synthetic is not None:
        from tmdiff_tpu_torch.data.h5 import PanDataset
        from tmdiff_tpu_torch.data.pipeline import BatchIterator, SensorMixer
        from tmdiff_tpu_torch.data.synthetic import make_arrays

        def build_datasets(opt, phase):
            seed = cli.train_seed(opt)
            sets = {s: PanDataset(make_arrays(n, bands, size, seed=i))
                    for i, (s, (bands, n, size)) in enumerate(synthetic.items())}
            mixer = SensorMixer({s: BatchIterator(ds, batch_size=2, seed=seed)
                                 for s, ds in sets.items()}, seed=seed)
            return (mixer if phase == "train" else None), sets

        cli.build_datasets = build_datasets
    cli.main(argv)


def compiled_refusal(mesh_shape):
    """Trainer.compiled_step of a seeded WavBEST on the mesh (on the world's
    device): (the ValueError's message, or None where it gives the
    callable; whether the CLI's loop steps through train_step there)."""
    import logging

    from tmdiff_tpu_torch import cli
    from tmdiff_tpu_torch.diffusion.schedules import NoiseSchedule
    from tmdiff_tpu_torch.train.trainer import Trainer

    mesh = make_mesh(*mesh_shape)
    trainer = Trainer(WavBEST(CHANNELS, device=mesh.device, seed=0),
                      NoiseSchedule.create("cosine", 1000), mesh=mesh)
    loop_step = cli.training_step(trainer, logging.getLogger("compiled_refusal"))
    try:
        trainer.compiled_step()
    except ValueError as err:
        return str(err), loop_step == trainer.train_step
    return None, loop_step == trainer.train_step
