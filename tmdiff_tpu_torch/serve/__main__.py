"""Serve a trained checkpoint over HTTP (port of tmdiff_tpu/serve/__main__.py):

  python -m tmdiff_tpu_torch.serve -c config.json \
      --ckpt <I{step} dir | checkpoint root | I*_gen.pth> \
      [--port 8000] [--sampler dpm++] [--steps 30] [--max-batch 8] \
      [--warmup 8,256,256] [--bf16] [--use-ema] [--device cuda]

  python -m torch.distributed.run --nproc-per-node N -m tmdiff_tpu_torch.serve \
      -c config.json --ckpt <ckpt> [--mesh-space S] ...

Builds the model from the config (`model.unet.channel_multiplier`,
`model.beta_schedule.val`; with a `model.controlnet` block, as
config/presets/serve_controlnet.json has, the UniControl ControlNet over
the legacy UNet, models/controlnet.py::ControlledLegacyUNet, whose requests
carry a hint and a task), loads the weights through train/checkpoint.py
(the port's own checkpoints or a reference `.pth`; the JAX package's orbax
checkpoints are refused), runs the warm-up batches, then binds the port and
blocks. A config's "serve" block (config/presets/serve_*.json) sets the
flags' defaults; a flag given on the command line wins. `--device` is CUDA
unless given, and with no GPU the server refuses to start rather than run
on the CPU.

Under torchrun (a world of N ranks, one per card) the server spans every
rank, as the JAX server spans every device: the ranks form a ("data",
"space") mesh with S = `--mesh-space` ranks on "space" (the image height)
and N / S on "data" (the batch; every rank by default). Rank 0 builds the
engine on a `serve/mesh.py::MeshLeader`, runs the warm-up and binds HTTP;
every other rank builds the same model and weights and runs
`serve/mesh.py::follow`. A `--mesh-space` that does not divide the world,
or above 1 in one process, is refused.

On exit (SIGINT) the server prints one JSON line, the kernel wrappers'
launch counts over its life ({"kernel_launches": ...}), which shows what
the served requests ran on; on a mesh every rank prints its own, with its
"rank". A second SIGINT during the stop is ignored.
"""
from __future__ import annotations

import argparse
import json
import os
import signal
import sys
import threading

# The deployed default CFG scale (the JAX package's SERVE_GUIDANCE_DEFAULT).
SERVE_GUIDANCE_DEFAULT = 3.0


def apply_serve_defaults(args, opt, parser, argv) -> None:
    """Overlay the config's "serve" block onto argparse defaults: a preset
    (e.g. config/presets/serve_lowlatency.json) is the deployment recipe:
    sampler, steps, bf16 and warm-up ride the config, while any flag the
    operator passes on the command line still wins (found by its option
    string in argv, so an explicit flag set to its default sticks too).
    Preset values go through the same type and choices validation as
    command-line tokens."""
    given = {a.split("=", 1)[0] for a in (argv or []) if a.startswith("-")}
    explicit = set()
    for action in parser._actions:
        # argparse takes unambiguous prefixes of long options (--step
        # parses as --steps), so a prefix counts as the option
        if any(g == s or (g.startswith("--") and len(g) > 2 and s.startswith(g))
               for s in action.option_strings for g in given):
            explicit.add(action.dest)
    by_dest = {a.dest: a for a in parser._actions}
    for key, val in (opt.get("serve") or {}).items():
        dest = str(key).replace("-", "_")
        if not hasattr(args, dest):
            continue
        if dest in explicit:
            continue
        action = by_dest.get(dest)
        if action is not None and action.type is not None and val is not None:
            if isinstance(val, bool):
                parser.error(f"config serve.{key}: expected "
                             f"{getattr(action.type, '__name__', action.type)}, got a bool")
            try:
                val = action.type(val)
            except (TypeError, ValueError) as e:
                parser.error(f"config serve.{key}: {e}")
        if action is not None and action.choices is not None and val not in action.choices:
            parser.error(f"config serve.{key}: invalid choice {val!r} "
                         f"(choose from {list(action.choices)})")
        setattr(args, dest, val)


def build_sampler_kw(args, parser, argv):
    """The method-specific sampler settings as the engine's `sampler_kw`.

    ddim_cached takes refresh_every, cache_level and forecast, and an
    optional --refresh-mask 0/1 string (a searched schedule). A deployment
    serves one schedule, so the mask goes in with refresh_mask_static=True.
    A caching flag on another sampler is an error, not a silent no-op, as
    per-request guidance on a non-CFG engine is."""
    if args.sampler == "ddim_cached":
        kw = {"refresh_every": args.refresh_every,
              "cache_level": args.cache_level,
              "forecast": args.forecast}
        if args.refresh_mask is not None:
            digits = args.refresh_mask.replace(",", "")
            if not digits or set(digits) - {"0", "1"}:
                parser.error(f"--refresh-mask must be a 0/1 string, got {args.refresh_mask!r}")
            mask = tuple(c == "1" for c in digits)
            n_steps = args.steps or 20
            if len(mask) != n_steps or not mask[0]:
                parser.error(f"--refresh-mask needs length {n_steps} (= steps) with a "
                             f"leading 1, got {len(mask)} chars")
            if args.forecast:
                parser.error("--refresh-mask and --forecast are mutually exclusive")
            kw["refresh_mask"] = mask
            kw["refresh_mask_static"] = True
        return kw
    if any(a.startswith(("--refresh-every", "--cache-level", "--forecast", "--no-forecast",
                         "--refresh-mask")) for a in (argv or [])):
        parser.error(f"--refresh-every/--cache-level/--forecast/--refresh-mask only apply to "
                     f"--sampler ddim_cached (got {args.sampler!r})")
    return None


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m tmdiff_tpu_torch.serve")
    p.add_argument("-c", "--config", required=True)
    p.add_argument("--ckpt", required=True)
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--sampler", default="dpm++",
                   choices=["dpm++", "dpm++_noise", "ancestral", "regression", "ddim",
                            "ddim_cached", "dpm++_cfg"])
    p.add_argument("--steps", type=int, default=None,
                   help="sampler step count (e.g. a distilled few-NFE ddim deployment: "
                        "--sampler ddim --steps 1)")
    p.add_argument("--refresh-every", type=int, default=4,
                   help="ddim_cached only: refresh the deep trunk every r-th NFE (must "
                        "divide --steps)")
    p.add_argument("--cache-level", type=int, default=2,
                   help="ddim_cached only: trunk depth to cache (1-3)")
    p.add_argument("--forecast", action=argparse.BooleanOptionalAction, default=False,
                   help="ddim_cached only: extrapolate the cached trunk linearly instead of "
                        "reusing it stale")
    p.add_argument("--refresh-mask", default=None,
                   help="ddim_cached only: per-step refresh schedule as a 0/1 string of "
                        "length --steps (first char 1); overrides --refresh-every")
    p.add_argument("--guidance", type=float, default=SERVE_GUIDANCE_DEFAULT,
                   help="default CFG scale for --sampler dpm++_cfg; requests may override "
                        "it per call through the 'guidance' field")
    p.add_argument("--max-batch", type=int, default=8)
    p.add_argument("--max-delay-ms", type=float, default=15.0)
    p.add_argument("--max-queue", type=int, default=64,
                   help="pending-request bound; excess requests get 503")
    p.add_argument("--use-ema", action=argparse.BooleanOptionalAction, default=False,
                   help="serve the EMA weights instead of the online weights (--no-use-ema "
                        "overrides a preset that enables it)")
    p.add_argument("--bf16", action=argparse.BooleanOptionalAction, default=False,
                   help="run the denoiser in bfloat16 (--no-bf16 overrides a preset that "
                        "enables it)")
    p.add_argument("--warmup", default=None,
                   help="bands,H,W to run every batch bucket at before binding the port")
    p.add_argument("--mesh-space", type=int, default=1,
                   help="shard image height over this many ranks of a torchrun world; the "
                        "rest go to the 'data' axis (default: every rank on data)")
    p.add_argument("--device", default=None, help="torch device; CUDA when not given")
    return p


def prepare(argv=None):
    """Parses argv and the config, overlays the config's "serve" block and
    checks the sampler settings, before any model is built. Returns
    (args, opt, sampler_kw)."""
    from tmdiff_tpu_torch.config import parse_config

    parser = build_parser()
    argv = sys.argv[1:] if argv is None else list(argv)
    args = parser.parse_args(argv)
    opt = parse_config(args.config, phase="val", make_dirs=False)
    apply_serve_defaults(args, opt, parser, argv)
    sampler_kw = build_sampler_kw(args, parser, argv)
    world = int(os.environ.get("WORLD_SIZE") or 1)
    if args.mesh_space > 1 and world == 1:
        parser.error(f"--mesh-space {args.mesh_space} shards the height over that many ranks, "
                     "and this is one process: start the server under torchrun (python -m "
                     "torch.distributed.run --nproc-per-node N -m tmdiff_tpu_torch.serve ...)")
    if args.mesh_space < 1 or world % args.mesh_space:
        parser.error(f"--mesh-space {args.mesh_space} does not divide the world of {world} "
                     "ranks")
    return args, opt, sampler_kw


def build_sharp(args, opt, mesh=None):
    """The model and its weights in a Pansharpener, on `mesh`'s device and
    sharded over it where a mesh is given."""
    import torch

    from tmdiff_tpu_torch.diffusion.schedules import NoiseSchedule
    from tmdiff_tpu_torch.models.controlnet import ControlledLegacyUNet
    from tmdiff_tpu_torch.models.wavbest import WavBEST
    from tmdiff_tpu_torch.pipeline import Pansharpener
    from tmdiff_tpu_torch.train import checkpoint as ckpt_lib
    from tmdiff_tpu_torch.train.trainer import Trainer
    from tmdiff_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device) if mesh is None else mesh.device
    # The served model's bf16 matrix products (its Linear layers and 1x1x1
    # convs) accumulate in fp32 without reduced-precision partial sums, as
    # XLA's bf16 dots do in the JAX package.
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    sched_opt = opt["model"]["beta_schedule"]["val"]
    channels = tuple(opt["model"]["unet"]["channel_multiplier"] or (32, 64, 128, 256))
    dtype = torch.bfloat16 if args.bf16 else torch.float32
    control = opt["model"]["controlnet"]
    if control is None:
        model = WavBEST(channels, device=device, dtype=dtype)
    else:
        model = ControlledLegacyUNet(
            channels, hint_channels=control["hint_channels"],
            only_mid_control=control["only_mid_control"],
            control_scales=tuple(control["control_scales"]), device=device, dtype=dtype)
    trainer = Trainer(model, NoiseSchedule.create(sched_opt["schedule"], sched_opt["n_timestep"]),
                      lr=1e-4)
    state, _ = ckpt_lib.restore_path(args.ckpt, trainer.init_state())
    if args.use_ema:
        with torch.no_grad():
            for p, e in zip(model.parameters(), state.ema_params):
                p.copy_(e)
    return Pansharpener(model, schedule_name=sched_opt["schedule"],
                        n_timestep=sched_opt["n_timestep"], device=device, mesh=mesh)


def make_engine(sharp, args, sampler_kw):
    """The engine (not started serving) on `sharp`, a Pansharpener or a
    MeshLeader."""
    from tmdiff_tpu_torch.serve.engine import InferenceEngine

    return InferenceEngine(sharp, method=args.sampler, steps=args.steps, guidance=args.guidance,
                           max_batch=args.max_batch, max_delay_ms=args.max_delay_ms,
                           max_queue=args.max_queue, sampler_kw=sampler_kw)


def build_engine(args, opt, sampler_kw):
    """The model, its weights and the engine of one process (not started
    serving)."""
    return make_engine(build_sharp(args, opt), args, sampler_kw)


def launch_counts() -> dict:
    """The conv and attention wrappers' launch counters (in all, by
    variant, by dtype) of this process."""
    from tmdiff_tpu_torch.ops.cuda import conv2d, conv3d, flash_attention

    counts = {name: {"launches": m.launches, "variants": dict(m.variant_launches),
                     "dtypes": dict(m.dtype_launches)}
              for name, m in (("conv3d", conv3d), ("conv3x3_nhwc", conv2d))}
    counts["flash_attention"] = {"launches": flash_attention.launches}
    return counts


def _interrupt_once(signum, frame):
    """SIGINT: stop serving, and ignore any further SIGINT (torchrun forwards
    a terminal's to every rank again) while the stop runs."""
    signal.signal(signal.SIGINT, signal.SIG_IGN)
    raise KeyboardInterrupt


def serve(engine, args, leader=None) -> None:
    """Warm-up, bind, serve until SIGINT; then close the server, shut the
    engine down and stop the mesh's followers."""
    from tmdiff_tpu_torch.serve.server import make_server

    try:
        if args.warmup:
            shape = tuple(int(x) for x in args.warmup.split(","))
            print(f"warming up {shape} x buckets {engine.buckets} ...", flush=True)
            engine.warmup([shape])
        server = make_server(engine, args.host, args.port)
        print(f"serving on {args.host}:{args.port} (sampler={args.sampler}, max_batch="
              f"{args.max_batch}, bf16={args.bf16}, device={engine.sharp.device})", flush=True)
        try:
            server.serve_forever()
        except KeyboardInterrupt:
            pass
        finally:
            server.server_close()
    finally:
        engine.shutdown()
        if leader is not None:
            leader.stop()


def main(argv=None):
    """Serves until SIGINT; on a mesh returns this rank's serve/mesh.py
    stats."""
    import torch.distributed as dist

    from tmdiff_tpu_torch.parallel.mesh import init_distributed, make_mesh
    from tmdiff_tpu_torch.serve.mesh import MeshLeader, follow

    args, opt, sampler_kw = prepare(argv)
    # a world of ranks under torchrun (nothing for one process)
    joined = init_distributed(args.device)
    rank = dist.get_rank() if dist.is_initialized() else 0
    previous = None
    if threading.current_thread() is threading.main_thread():
        previous = signal.signal(signal.SIGINT, _interrupt_once if rank == 0 else signal.SIG_IGN)
    try:
        if not dist.is_initialized() or dist.get_world_size() == 1:
            serve(build_engine(args, opt, sampler_kw), args)
            print(json.dumps({"kernel_launches": launch_counts()}), flush=True)
            return
        mesh = make_mesh(space=args.mesh_space)
        sharp = build_sharp(args, opt, mesh)
        if rank == 0:
            print(f"serving over SPMD mesh {{'data': {mesh.data}, 'space': {mesh.space}}} "
                  f"({mesh.transport})", flush=True)
            leader = MeshLeader(sharp)
            serve(make_engine(leader, args, sampler_kw), args, leader)
            stats = leader.stats
        else:
            stats = follow(sharp)
        print(json.dumps({"kernel_launches": launch_counts(), "rank": rank, "mesh": stats}),
              flush=True)
        return stats
    finally:
        if previous is not None:
            signal.signal(signal.SIGINT, previous)
        if joined:
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
