"""Config-driven train / val / distill entry point (port of tmdiff_tpu/cli.py):

    python -m tmdiff_tpu_torch.cli -c config.json -p train|val|distill [-debug]
        [--sampler dpm++|dpm++_noise|ancestral|regression|ddim] [--device cpu]

Builds per-sensor train iterators (the train_qb / train_gf2 / train_wv3
dataset entries) mixed 4:4:8 by length-weighted probability, validates every
`train.val_freq` steps on val_QB / val_GF2 / val_WV3 with .mat artifacts and
metric logs, and checkpoints after each validation and at the end of the run
(`train/checkpoint.py`). A SIGTERM or SIGINT ends training after the current
step with a checkpoint, and `path.resume: "auto"` continues from the newest
one. `path.resume` may also name a checkpoint root, one `I{step}` directory
or a reference `.pth`. Validation samples with `--sampler`.

`-p distill` runs progressive distillation (train/distill.py) from the
teacher checkpoint `path.resume` names, over `train.distill.phases` (N = 10
then 5 by default) of `steps_per_phase` steps at `lr`; the teacher is the
checkpoint's EMA weights when `train.use_ema_eval`, else its online weights
(`train.distill.teacher` overrides). Each phase's student is saved in both
weight slots under `checkpoint/distill_N{N}` and validated with ddim at N
steps; a SIGTERM mid-phase saves `distill_N{N}_partial` and skips its
validation.

Runs on CUDA unless `--device` says otherwise, and raises without a card.
`-gpu` is accepted for the reference's command line and ignored. The train
and distill loops run `Trainer.compiled_step()`, as the JAX CLI runs its
jitted step: on a card each step is one replay of a CUDA graph of the whole
step (train/trainer.py), on every rank of a mesh; each distillation phase's
trainer captures its own, released when the phase ends.

Over several processes, one per rank, under torchrun:

    python -m torch.distributed.run --nproc-per-node N -m tmdiff_tpu_torch.cli \
        -c config.json -p train|val|distill [--device cpu]

the run takes the ("data", "space") mesh of the config's `parallel: {data,
space}` block (parallel/mesh.py), or every rank on "data" without one, as
the JAX CLI does. The mesh shards training, distillation and validation
sampling; the backend follows parallel/mesh.py's rule (gloo with `--device
cpu`, NCCL with a card per rank). Under NCCL each rank's captured step
holds its halo exchanges and the gradient all-reduce; on the CPU the step
runs uncaptured; a gloo world on cards (a caller's, not torchrun's) runs
`train_step`. The log says which, once. Between steps the stop poll and the
checkpoints' barrier run eagerly, in the same order on every rank. Rank 0
alone writes the logs, the .mat results, provenance.json and the
checkpoints, and scores the validation images; every rank samples its
shard and restores the checkpoints. A stop signal on any rank stops every
rank after the same step.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import logging
import os
import shutil
import signal
import subprocess
import sys
import threading
import time

import torch

from tmdiff_tpu_torch.config import dict2str, parse_config

PHASES = ("train", "val", "distill")
SAMPLERS = ("dpm++", "dpm++_noise", "ancestral", "regression", "ddim")


def setup_logger(name, root, filename, screen=False, write=True):
    """The run's logger `name`, writing `{filename}.log` under `root` (and to
    the screen with `screen`); with write=False (a rank other than 0) it
    writes nowhere."""
    logger = logging.getLogger(name)
    logger.setLevel(logging.INFO)
    # drop the handlers of an earlier run in this process, which would
    # otherwise keep writing into that run's files
    for h in list(logger.handlers):
        logger.removeHandler(h)
        h.close()
    if not write:
        logger.addHandler(logging.NullHandler())
        return logger
    fmt = logging.Formatter("%(asctime)s.%(msecs)03d - %(levelname)s: %(message)s",
                            "%y-%m-%d %H:%M:%S")
    fh = logging.FileHandler(os.path.join(root, f"{filename}.log"), mode="w")
    fh.setFormatter(fmt)
    logger.addHandler(fh)
    if screen:
        sh = logging.StreamHandler()
        sh.setFormatter(fmt)
        logger.addHandler(sh)
    return logger


def snapshot_provenance(opt, config_path: str):
    """Copies the package's source (without builds and caches) and the config
    into the experiments directory, and records the git revision, the
    resolved config and the command line in provenance.json."""
    root = opt["path"]["experiments_root"]
    code_dir = os.path.join(root, "code")
    pkg_dir = os.path.dirname(os.path.abspath(__file__))
    if not os.path.exists(code_dir):
        shutil.copytree(pkg_dir, os.path.join(code_dir, "tmdiff_tpu_torch"),
                        ignore=shutil.ignore_patterns("build", "__pycache__", "*.pyc", "*.so"))
    shutil.copyfile(config_path, os.path.join(root, os.path.basename(config_path)))
    try:
        rev = subprocess.run(["git", "rev-parse", "HEAD"], cwd=pkg_dir, capture_output=True,
                             text=True, timeout=10).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        rev = ""
    with open(os.path.join(root, "provenance.json"), "w") as f:
        json.dump({"git_rev": rev, "config": dict(opt), "argv": sys.argv}, f, indent=2,
                  default=str)


SENSOR_OF_PHASE = {
    "train_qb": "QB", "train_gf2": "GF2", "train_wv3": "WV3",
    "val_QB": "QB", "val_GF2": "GF2", "val_WV3": "WV3",
}


def train_seed(opt) -> int:
    # a None check: seed 0 is a valid seed of its own
    seed = (opt["train"] or {}).get("seed")
    return 3407 if seed is None else int(seed)


def build_datasets(opt, phase):
    """(SensorMixer over the train sets or None, {sensor: val PanDataset})
    from the config's dataset entries (h5 files)."""
    from tmdiff_tpu_torch.data.h5 import PanDataset
    from tmdiff_tpu_torch.data.pipeline import BatchIterator, SensorMixer

    seed = train_seed(opt)
    train_iters, val_sets = {}, {}
    for name, ds_opt in (opt["datasets"] or {}).items():
        sensor = SENSOR_OF_PHASE.get(name)
        if sensor is None:
            continue
        if name.startswith("train") and phase == "train":
            ds = PanDataset(ds_opt["dataroot"], data_len=ds_opt["data_len"] or -1)
            train_iters[sensor] = BatchIterator(ds, batch_size=ds_opt["batch_size"] or 8,
                                                shuffle=bool(ds_opt["use_shuffle"]), seed=seed)
        elif name.startswith("val"):
            val_sets[sensor] = PanDataset(ds_opt["dataroot"], data_len=ds_opt["data_len"] or -1)
    mixer = SensorMixer(train_iters, seed=seed) if train_iters else None
    return mixer, val_sets


def make_feeder(mixer, sharp, train_opt):
    """The train loop's input: host batches assembled on a worker thread,
    sent to the card one step ahead (runtime/prefetch.py::DeviceFeeder;
    `train.prefetch = 0` runs it serially), each with its sensor's prompt
    row, which the sampler's table holds on the card already. Yields
    (batch {Res, PAN, MS}, prompt (768,), batch size); closing the
    generator stops the worker."""
    from tmdiff_tpu_torch.runtime.prefetch import DeviceFeeder

    depth = train_opt.get("prefetch")
    source = (({k: batch[k] for k in ("Res", "PAN", "MS")}, sensor) for batch, sensor in mixer)
    feeder = DeviceFeeder(source, device=sharp.device, depth=2 if depth is None else int(depth))
    try:
        for batch, sensor in feeder:
            yield batch, sharp.prompt_embedding(sensor), len(batch["Res"])
    finally:
        feeder.close()


def parse_args(argv=None):
    parser = argparse.ArgumentParser(prog="python -m tmdiff_tpu_torch.cli")
    parser.add_argument("-c", "--config", type=str, required=True)
    parser.add_argument("-p", "--phase", type=str, default="val", choices=PHASES)
    parser.add_argument("-gpu", "--gpu_ids", type=str, default=None)  # accepted, unused
    parser.add_argument("-debug", "-d", action="store_true", dest="debug")
    parser.add_argument("-log_eval", action="store_true")
    parser.add_argument("--sampler", type=str, default="dpm++", choices=SAMPLERS)
    parser.add_argument("--device", type=str, default=None,
                        help="torch device; CUDA when not given")
    return parser.parse_args(argv)


@contextlib.contextmanager
def stop_on_signals(active: bool = True):
    """Yields a {"flag": False} that SIGTERM or SIGINT sets, so the train
    loop ends after its current step with a checkpoint; a second SIGINT
    raises KeyboardInterrupt. The previous handlers come back on exit.
    Signals can be caught only in the main thread; elsewhere (or with
    active=False) nothing is installed."""
    stop = {"flag": False}
    previous = {}

    def request_stop(signum, frame):
        if stop["flag"] and signum == signal.SIGINT:
            raise KeyboardInterrupt
        stop["flag"] = True

    if active and threading.current_thread() is threading.main_thread():
        for s in (signal.SIGTERM, signal.SIGINT):
            previous[s] = signal.signal(s, request_stop)
    try:
        yield stop
    finally:
        for s, h in previous.items():
            signal.signal(s, h)


def main(argv=None):
    import torch.distributed as dist

    from tmdiff_tpu_torch.parallel.mesh import init_distributed

    args = parse_args(argv)
    # a world of ranks under torchrun (nothing for one process)
    joined = init_distributed(args.device)
    try:
        if dist.is_initialized():
            # rank 0 names the experiments directory; every rank uses its name
            root = [None]
            if dist.get_rank() == 0:
                root[0] = parse_config(args.config, phase=args.phase,
                                       debug=args.debug)["path"]["experiments_root"]
            dist.broadcast_object_list(root, src=0)
            opt = parse_config(args.config, phase=args.phase, debug=args.debug,
                               experiments_root=root[0], make_dirs=dist.get_rank() == 0)
        else:
            opt = parse_config(args.config, phase=args.phase, debug=args.debug)
        opt["log_eval"] = args.log_eval
        # the handlers go in before the model is built, so that a SIGTERM at
        # any point after start-up asks for a clean checkpoint-and-exit
        with stop_on_signals(args.phase in ("train", "distill")) as stop:
            _run(args, opt, stop)
    finally:
        if joined:
            dist.destroy_process_group()


def build_mesh(opt, device):
    """The run's mesh: the config's `parallel: {data, space}` block, or every
    rank of a torchrun world on "data"; None for one process without a
    block."""
    import torch.distributed as dist

    from tmdiff_tpu_torch.parallel.mesh import make_mesh

    par = opt["parallel"] or {}
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world == 1 and not (par.get("data") or par.get("space")):
        return None
    space = int(par.get("space") or 1)
    data = int(par.get("data") or world // space)
    return make_mesh(data, space, device=device)


def _run(args, opt, stop, datasets=None):
    """The run of a parsed config. `datasets` = (mixer, val_sets) as
    build_datasets returns them, to run on data built in memory; None reads
    the config's h5 files. Returns (trainer, state) at the end."""
    from tmdiff_tpu_torch.diffusion.schedules import NoiseSchedule
    from tmdiff_tpu_torch.eval.harness import validate
    from tmdiff_tpu_torch.models.init_styles import apply_init_style
    from tmdiff_tpu_torch.models.wavbest import WavBEST
    from tmdiff_tpu_torch.pipeline import Pansharpener
    from tmdiff_tpu_torch.train import checkpoint as ckpt_lib
    from tmdiff_tpu_torch.train.trainer import Trainer
    from tmdiff_tpu_torch.utils.device import resolve_device

    mesh = build_mesh(opt, args.device)
    rank0 = mesh is None or mesh.rank == 0
    logger = setup_logger("base", opt["path"]["log"], "train", screen=True, write=rank0)
    val_logger = setup_logger("val", opt["path"]["log"], "val", write=rank0)
    logger.info(opt.get("info", opt["name"]))
    logger.info(dict2str(opt))
    if rank0:
        snapshot_provenance(opt, args.config)
    if mesh is not None:
        logger.info(f"mesh: {mesh}")

    device = resolve_device(args.device) if mesh is None else mesh.device
    train_phase = args.phase in ("train", "distill")
    mixer, val_sets = (datasets if datasets is not None
                       else build_datasets(opt, "train" if train_phase else args.phase))
    if train_phase:
        # the JAX CLI draws the mixer's first batch to shape its state; drawing
        # it here too trains on the same sequence of batches
        next(mixer)
    logger.info("Initial Dataset Finished")

    sched_opt = opt["model"]["beta_schedule"]["val" if args.phase == "val" else "train"]
    channels = tuple(opt["model"]["unet"]["channel_multiplier"] or (32, 64, 128, 256))
    seed = train_seed(opt)
    model = WavBEST(channels, device=device, seed=seed)
    init_type = opt["model"]["init_type"]
    if args.phase == "train" and init_type:
        # the JAX CLI's init key: 7 with no train.seed, else the seed + 7
        seed_opt = (opt["train"] or {}).get("seed")
        init_seed = 7 if seed_opt is None else int(seed_opt) + 7
        apply_init_style(model, init_type, torch.Generator().manual_seed(init_seed))
        logger.info(f"Applied init_type [{init_type}]")

    train_opt = opt["train"] or {}
    trainer = Trainer(
        model, NoiseSchedule.create(sched_opt["schedule"], sched_opt["n_timestep"]),
        lr=(train_opt.get("optimizer") or {}).get("lr", 1e-4),
        max_iter=train_opt.get("max_iter", 300_000),
        loss_type=(opt["model"]["diffusion"] or {}).get("loss_type", "l1"),
        p_uncond=train_opt.get("p_uncond", 0.0), seed=seed, mesh=mesh)
    state = trainer.init_state()
    # one sampler for the run: its prompt table serves the train loop too;
    # `params` picks the online or the EMA weights per validation
    sharp = Pansharpener(model, schedule_name=sched_opt["schedule"],
                         n_timestep=sched_opt["n_timestep"], device=device, mesh=mesh)

    def stopping():
        # every rank stops after the same step
        if mesh is not None and mesh.any(stop["flag"]):
            stop["flag"] = True
        return stop["flag"]

    resume = opt["path"]["resume"]
    ckpt_dir = opt["path"]["checkpoint"]
    if resume == "auto":
        if ckpt_lib.latest_step(ckpt_dir) is not None:
            ckpt_lib.restore_checkpoint(ckpt_dir, state)
            logger.info(f"Auto-resumed from {ckpt_dir} at step {state.step}")
        else:
            logger.info(f"Auto-resume: no checkpoint in {ckpt_dir}, fresh start")
    elif resume:
        _, pth = ckpt_lib.restore_path(resume, state)
        logger.info(f"Imported reference torch checkpoint {pth}" if pth
                    else f"Restored checkpoint from {resume} at step {state.step}")
    current_step = state.step
    logger.info("Initial Model Finished")

    def run_validation(state, method=None, steps=None, use_ema=None):
        if use_ema is None:
            use_ema = bool(train_opt.get("use_ema_eval"))
        params = (dict(zip((n for n, _ in model.named_parameters()), state.ema_params))
                  if use_ema else None)
        for sensor, ds in val_sets.items():
            # every rank samples its shard; rank 0 scores and writes
            scores = validate(
                sharp, ds, sensor,
                result_dir=os.path.join(opt["path"]["results"], sensor) if rank0 else None,
                method=method or args.sampler, steps=steps,
                batch_size=int(opt.get("val_batch_size") or 4),
                max_images=int(opt.get("val_max_images") or -1), params=params,
                log_file=(os.path.join(opt["path"]["results"], "eval_metrics.jsonl")
                          if opt["log_eval"] and rank0 else None), score=rank0)
            if rank0:
                logger.info(f"step {state.step} {sensor} {scores}")
                val_logger.info(f"step {state.step} {sensor} {scores}")
                print(state.step, sensor, scores)

    if args.phase == "train":
        max_iter = train_opt.get("max_iter", 300_000)
        print_freq = train_opt.get("print_freq", 50)
        val_freq = train_opt.get("val_freq", 5000)
        keep = train_opt.get("ckpt_keep")  # None keeps every checkpoint, as the reference
        last_print = (time.monotonic(), current_step)
        last_saved = current_step  # the resume point (or step 0) is on disk already
        feeder = make_feeder(mixer, sharp, train_opt)
        step_fn = training_step(trainer, logger)
        try:
            while current_step < max_iter and not stopping():
                batch, emb, bsz = next(feeder)
                state, metrics = step_fn(state, batch, emb)
                current_step += 1
                if current_step % print_freq == 0:
                    now = time.monotonic()
                    dt, dsteps = now - last_print[0], current_step - last_print[1]
                    last_print = (now, current_step)
                    logger.info(f"step {current_step} "
                                + " ".join(f"{k}: {float(v):.3e}" for k, v in metrics.items())
                                + f" img/s: {dsteps * bsz / dt if dt > 0 else 0.0:.1f}")
                if current_step % val_freq == 0:
                    run_validation(state)
                    ckpt_lib.save_checkpoint(ckpt_dir, state, keep=keep, mesh=mesh)
                    last_saved = current_step
        finally:
            feeder.close()
            trainer.release_compiled()
        if current_step != last_saved:
            # the end of the run (or a stop) between validations: the state
            # still goes to disk
            path = ckpt_lib.save_checkpoint(ckpt_dir, state, keep=keep, mesh=mesh)
            if stop["flag"]:
                logger.info(f"Preemption signal: checkpointed step {current_step} to {path}; "
                            "resume with path.resume='auto'")
            else:
                logger.info(f"Final checkpoint: step {current_step} to {path}")
    elif args.phase == "distill":
        state = _distill(opt, train_opt, model, trainer, state, sharp, mixer, stopping, logger,
                         run_validation)
    else:
        logger.info("Begin Model Evaluation.")
        run_validation(state)
    return trainer, state


def training_step(trainer, logger, say: bool = True):
    """The loop's step: `trainer.compiled_step()`, as the JAX CLI runs its
    jitted step, in one process, on an NCCL mesh (each rank replays its
    captured step) and on a CPU mesh (uncaptured); `trainer.train_step` on
    a gloo mesh on CUDA, whose host-staged collectives no graph can hold,
    logged when `say`."""
    mesh = trainer.mesh
    if trainer.device.type != "cuda" or mesh is None or mesh.size == 1 or mesh.capturable:
        if say and mesh is not None and mesh.size > 1:
            logger.info(f"mesh of {mesh.size} ranks: each step runs compiled_step ("
                        + ("a captured step on every rank, its collectives inside the graph)"
                           if trainer.device.type == "cuda" else "uncaptured on the CPU)"))
        return trainer.compiled_step()
    if say:
        logger.info(f"mesh of {mesh.size} ranks on {mesh.transport}: each step runs "
                    "train_step, not compiled_step (a CUDA graph cannot hold gloo's "
                    "collectives)")
    return trainer.train_step


def _distill(opt, train_opt, model, trainer, state, sharp, mixer, stopping, logger,
             run_validation):
    """The distill phase's chain of students (see the module docstring);
    returns the last phase's state. `stopping()` says whether a stop signal
    came (on any rank)."""
    from tmdiff_tpu_torch.train import checkpoint as ckpt_lib
    from tmdiff_tpu_torch.train.distill import DistillTrainer

    if not opt["path"]["resume"]:
        raise ValueError("distill phase requires path.resume = the teacher checkpoint")
    d_opt = train_opt.get("distill") or {}
    phases = [int(n) for n in (d_opt.get("phases") or [10, 5])]
    steps_per_phase = int(d_opt.get("steps_per_phase") or 600)
    print_freq = train_opt.get("print_freq", 50)
    teacher_kind = d_opt.get("teacher") or ("ema" if train_opt.get("use_ema_eval") else "online")
    if teacher_kind not in ("ema", "online"):
        raise ValueError(f"train.distill.teacher must be 'ema' or 'online', got {teacher_kind!r}")
    names = [n for n, _ in model.named_parameters()]
    weights = state.ema_params if teacher_kind == "ema" else [p for _, p in
                                                             model.named_parameters()]
    # copies: the student's steps update the model's tensors in place
    teacher = {n: w.detach().clone() for n, w in zip(names, weights)}
    logger.info(f"Begin progressive distillation: phases={phases} "
                f"steps_per_phase={steps_per_phase} from step {state.step} "
                f"{teacher_kind} teacher")
    p_state = state
    feeder = make_feeder(mixer, sharp, train_opt)
    try:
        for n in phases:
            if stopping():
                break
            done_steps = 0
            d_trainer = DistillTrainer(model, trainer.schedule, n_student_steps=n,
                                       lr=float(d_opt.get("lr") or 1e-4), warmup_steps=20,
                                       max_iter=steps_per_phase, loss_type=trainer.loss_type,
                                       mesh=trainer.mesh)
            p_state = d_trainer.state_from_params(teacher)
            step_fn = training_step(d_trainer, logger, say=n == phases[0])
            try:
                for k in range(steps_per_phase):
                    if stopping():
                        break
                    batch, emb, _ = next(feeder)
                    p_state, m = step_fn(p_state, batch, emb, teacher)
                    done_steps = k + 1
                    if (k + 1) % print_freq == 0:
                        logger.info(f"distill N={n} step {k + 1} "
                                    f"l_distill: {float(m['l_pix']):.3e}")
            finally:
                d_trainer.release_compiled()
            # the student in both weight slots: the phase's EMA starts at the
            # teacher and barely moves in a short phase, and a few-step
            # sampler must not deploy the teacher through it
            with torch.no_grad():
                for e, p in zip(p_state.ema_params, model.parameters()):
                    e.copy_(p)
            if stopping() and done_steps < steps_per_phase:
                # no validation inside the preemption window; the partial
                # student is a record, not a resume point
                path = ckpt_lib.save_checkpoint(
                    os.path.join(opt["path"]["checkpoint"], f"distill_N{n}_partial"), p_state,
                    mesh=trainer.mesh)
                logger.info(f"Preemption signal: phase N={n} stopped at step "
                            f"{done_steps}/{steps_per_phase}; PARTIAL student "
                            f"checkpointed to {path}, validation skipped")
                break
            teacher = {k: v.detach().clone() for k, v in zip(names, model.parameters())}
            path = ckpt_lib.save_checkpoint(
                os.path.join(opt["path"]["checkpoint"], f"distill_N{n}"), p_state,
                mesh=trainer.mesh)
            logger.info(f"distill N={n} done -> {path}")
            run_validation(p_state, method="ddim", steps=n, use_ema=False)
    finally:
        feeder.close()
    return p_state


if __name__ == "__main__":
    main()
