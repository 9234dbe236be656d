"""End-to-end learning check: trains a small but real configuration through
the CLI's train path and shows that the sampled outputs beat the untrained
model and the trivial `lms` identity on SAM/ERGAS/SSIM (the port's twin of
tools/train_convergence.py).

Three sensors' synthetic scenes (data/synthetic.py: QB and GF2 with 4
bands, WV3 with 8) are built in memory, so no h5 file is read or written;
the run goes through `cli._run(args, opt, stop, datasets=(mixer, val_sets))`
with the tool's config (channels (16, 32, 64, 128), batch 8 a sensor, lr
2e-4, the cosine schedule of `--timesteps`, L1, EMA, a validation and a
checkpoint at the last step), then scores `dpm++` samples of every
validation scene with the trained (online) weights, beside the `lms`
baseline and the untrained model at the same init style and seed. The
result has the JAX tool's keys and is printed as a `RESULT {...}` line (and
written to `--out`); the exit code is 0 when every sensor's trained SAM is
below both baselines and its ERGAS below `lms`'s.

    python -m tmdiff_tpu_torch.train_convergence [--steps 3000] [--init torch]
        [--channels 16,32,64,128] [--size 64] [--scenes 64] [--val-scenes 8]
        [--timesteps 500] [--noise 0.002] [--out result.json] [--root DIR] [--device cpu]

On the card it trains in fp32 (the JAX CLI's dtype) through K1.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

import numpy as np
import torch

SENSORS = (("QB", 4), ("GF2", 4), ("WV3", 8))  # sensor, bands
BATCH = 8


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="python -m tmdiff_tpu_torch.train_convergence")
    p.add_argument("--out", default=None, help="also write the result JSON here")
    p.add_argument("--root", default=None,
                   help="the run's directory (config, experiments); a temporary one if unset")
    p.add_argument("--steps", type=int, default=3000)
    p.add_argument("--size", type=int, default=64)
    p.add_argument("--scenes", type=int, default=64, help="train scenes a sensor")
    p.add_argument("--val-scenes", type=int, default=8, help="validation scenes a sensor")
    p.add_argument("--timesteps", type=int, default=500)
    p.add_argument("--noise", type=float, default=0.002,
                   help="synthetic pixel-noise std (data/synthetic.py)")
    p.add_argument("--seed", type=int, default=None,
                   help="train.seed; unset keeps the CLI's defaults (3407, init key 7)")
    p.add_argument("--init", default="kaiming",
                   choices=["normal", "kaiming", "orthogonal", "torch"])
    p.add_argument("--channels", default="16,32,64,128")
    p.add_argument("--skip-baselines", action="store_true",
                   help="score the lms baseline only, not the untrained model")
    p.add_argument("--device", default=None, help="torch device; CUDA when not given")
    return p.parse_args(argv)


def make_config(args, root: str) -> dict:
    """The JAX tool's config, with the run's experiments under `root`."""
    train = {f"train_{s.lower()}": {"dataroot": None, "batch_size": BATCH, "use_shuffle": True,
                                    "data_len": -1} for s, _ in SENSORS}
    val = {f"val_{s}": {"dataroot": None, "data_len": -1} for s, _ in SENSORS}
    return {
        "name": "convergence",
        "phase": "train",
        "path": {"log": "logs", "results": "results", "checkpoint": "checkpoint",
                 "resume": None, "experiments_root": os.path.join(root, "experiments")},
        "datasets": {**train, **val},
        "model": {
            "beta_schedule": {"train": {"schedule": "cosine", "n_timestep": args.timesteps},
                              "val": {"schedule": "cosine", "n_timestep": args.timesteps}},
            "init_type": args.init,
            "unet": {"channel_multiplier": [int(c) for c in args.channels.split(",")]},
            "diffusion": {"loss_type": "l1"},
        },
        "train": {"val_freq": args.steps, "print_freq": 200, "max_iter": args.steps,
                  "optimizer": {"lr": 2e-4},
                  **({} if args.seed is None else {"seed": args.seed})},
        "val_batch_size": BATCH,
        "val_max_images": args.val_scenes,
    }


def build_data(args, seed: int):
    """(SensorMixer over the train scenes, {sensor: validation PanDataset}),
    as the CLI builds them from the tool's h5 files: the train sets from
    seeds 0-2, the validation sets from 100-102."""
    from tmdiff_tpu_torch.data.h5 import PanDataset
    from tmdiff_tpu_torch.data.pipeline import BatchIterator, SensorMixer
    from tmdiff_tpu_torch.data.synthetic import make_arrays

    iters, val_sets = {}, {}
    for i, (sensor, bands) in enumerate(SENSORS):
        train = PanDataset(make_arrays(args.scenes, bands, args.size, seed=i, noise=args.noise))
        iters[sensor] = BatchIterator(train, batch_size=BATCH, shuffle=True, seed=seed)
        val_sets[sensor] = PanDataset(make_arrays(args.val_scenes, bands, args.size,
                                                  seed=100 + i, noise=args.noise))
    return SensorMixer(iters, seed=seed), val_sets


def score(sharp, ds, sensor, params=None) -> dict:
    """Mean SAM/ERGAS/SSIM of `dpm++` samples of every scene of `ds`
    (batches of 8, seed = the batch's first index) against its ground
    truth."""
    from tmdiff_tpu_torch.eval import metrics as M

    preds = []
    for s in range(0, len(ds), BATCH):
        idx = np.arange(s, min(s + BATCH, len(ds)))
        preds.extend(np.asarray(sharp.sample(ds.batch(idx), sensor=sensor, method="dpm++",
                                             seed=s, params=params)))
    return M.mean_scores([ds[i]["HR"] for i in range(len(preds))], preds)


def main(argv=None) -> int:
    args = parse_args(argv)
    from tmdiff_tpu_torch import cli
    from tmdiff_tpu_torch.config import parse_config
    from tmdiff_tpu_torch.eval import metrics as M
    from tmdiff_tpu_torch.models.clip_text import clip_mode
    from tmdiff_tpu_torch.models.init_styles import apply_init_style
    from tmdiff_tpu_torch.models.wavbest import WavBEST
    from tmdiff_tpu_torch.pipeline import Pansharpener
    from tmdiff_tpu_torch.utils.device import resolve_device

    root = args.root or tempfile.mkdtemp(prefix="tmdiff_convergence_")
    os.makedirs(root, exist_ok=True)
    cfg = make_config(args, root)
    cfg_path = os.path.join(root, "convergence.json")
    with open(cfg_path, "w") as f:
        json.dump(cfg, f)
    seed = cli.train_seed(cfg)
    mixer, val_sets = build_data(args, seed)
    device = resolve_device(args.device)
    channels = tuple(cfg["model"]["unet"]["channel_multiplier"])
    results = {"config": {"channels": channels, "steps": args.steps, "size": args.size,
                          "timesteps": args.timesteps, "init": args.init, "seed": args.seed,
                          "device": str(device)},
               "clip_mode": clip_mode()}

    # the baselines: the lms identity (Res := 0) and the untrained model at
    # the init the CLI's run starts from (its model seed and init key)
    untrained = WavBEST(channels, device=device, seed=seed)
    init_seed = 7 if args.seed is None else args.seed + 7
    apply_init_style(untrained, args.init, torch.Generator().manual_seed(init_seed))
    sharp = Pansharpener(untrained, schedule_name="cosine", n_timestep=args.timesteps,
                         device=device)
    for sensor, ds in val_sets.items():
        results[f"lms_{sensor}"] = M.mean_scores([ds[i]["HR"] for i in range(len(ds))],
                                                 [ds[i]["MS"] for i in range(len(ds))])
        if not args.skip_baselines:
            results[f"untrained_{sensor}"] = score(sharp, ds, sensor)
        print(sensor, "lms:", results[f"lms_{sensor}"], "untrained:",
              results.get(f"untrained_{sensor}"), flush=True)

    cli_args = cli.parse_args(["-c", cfg_path, "-p", "train", "--sampler", "dpm++"]
                              + ([] if args.device is None else ["--device", args.device]))
    opt = parse_config(cfg_path, phase="train")
    opt["log_eval"] = False
    with cli.stop_on_signals() as stop:
        _, state = cli._run(cli_args, opt, stop, datasets=(mixer, val_sets))
    results["trained_step"] = int(state.step)
    trained = Pansharpener(state.model, schedule_name="cosine", n_timestep=args.timesteps,
                           device=device)
    for sensor, ds in val_sets.items():
        results[f"trained_{sensor}"] = score(trained, ds, sensor)
        print(sensor, "trained:", results[f"trained_{sensor}"], flush=True)

    ok = all((args.skip_baselines
              or results[f"trained_{s}"]["sam"] < results[f"untrained_{s}"]["sam"])
             and results[f"trained_{s}"]["sam"] < results[f"lms_{s}"]["sam"]
             and results[f"trained_{s}"]["ergas"] < results[f"lms_{s}"]["ergas"]
             for s in val_sets)
    results["beats_lms_and_untrained"] = ok
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=2)
    print("RESULT", json.dumps(results), flush=True)
    print("PASS" if ok else "FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
