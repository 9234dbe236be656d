"""Config system (port of tmdiff_tpu/config/config.py): commented JSON ->
NoneDict tree + the experiments directory layout.

  * JSON configs may carry `//` comments, stripped per line;
  * missing keys read as None at any depth (NoneDict);
  * a timestamped `experiments/{name}_{ts}` tree (or `path.experiments_root`
    / the `experiments_root` argument, stable across re-runs, which
    `path.resume: "auto"` needs) is created with the `path` entries (log,
    results, checkpoint, tb_logger) rebased into it, except resume-like keys;
  * `-debug` prefixes the name with `debug_` and shrinks frequencies,
    timesteps and data lengths for smoke runs.

The presets of the JAX package are copied beside this file, under
`presets/`. Device selection is the CLI's `--device`, not the config's.
"""
from __future__ import annotations

import json
import os
from datetime import datetime
from typing import Optional

PRESETS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "presets")


class NoneDict(dict):
    """dict returning None for missing keys (arbitrary nesting)."""

    def __missing__(self, key):
        return None


def to_nonedict(obj):
    if isinstance(obj, dict):
        return NoneDict({k: to_nonedict(v) for k, v in obj.items()})
    if isinstance(obj, list):
        return [to_nonedict(v) for v in obj]
    return obj


def load_commented_json(path: str) -> dict:
    with open(path, "r", encoding="utf-8") as f:
        return json.loads("\n".join(line.split("//")[0] for line in f))


def timestamp() -> str:
    return datetime.now().strftime("%y%m%d_%H%M%S")


def parse_config(config_path: str, phase: str = "train", debug: bool = False,
                 experiments_root: Optional[str] = None, make_dirs: bool = True) -> NoneDict:
    opt = load_commented_json(config_path)
    opt["phase"] = phase
    if debug:
        opt["name"] = f"debug_{opt['name']}"

    opt.setdefault("path", {})
    root = (experiments_root or opt["path"].get("experiments_root")
            or os.path.join("experiments", f"{opt['name']}_{timestamp()}"))
    opt["path"]["experiments_root"] = root
    for key, sub in list(opt["path"].items()):
        if "resume" in key or "experiments" in key:
            continue
        opt["path"][key] = os.path.join(root, sub)
        if make_dirs:
            os.makedirs(opt["path"][key], exist_ok=True)

    if debug or "debug" in opt["name"]:
        train = opt.setdefault("train", {})
        train["val_freq"] = 2
        train["print_freq"] = 2
        train["save_checkpoint_freq"] = 3
        for ds in opt.get("datasets", {}).values():
            ds["data_len"] = 6
            if "batch_size" in ds:
                ds["batch_size"] = 2
        for sched in opt.get("model", {}).get("beta_schedule", {}).values():
            sched["n_timestep"] = 10
        # the JAX package's distillation settings at the shrunk T = 10 (its
        # DistillTrainer needs T % 2N == 0); kept so that both packages read
        # a debug config alike, though the port has no distill phase yet
        distill = train.get("distill")
        if not isinstance(distill, dict):
            distill = train["distill"] = {}
        distill["phases"] = [5, 1]
        distill["steps_per_phase"] = 2

    return to_nonedict(opt)


def dict2str(opt, indent: int = 1) -> str:
    msg = []
    for k, v in opt.items():
        if isinstance(v, dict):
            msg.append("  " * indent + f"{k}:[")
            msg.append(dict2str(v, indent + 1).rstrip("\n"))
            msg.append("  " * indent + "]")
        else:
            msg.append("  " * indent + f"{k}: {v}")
    return "\n".join(msg) + "\n"
