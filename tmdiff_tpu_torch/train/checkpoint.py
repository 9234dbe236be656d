"""Checkpoint and resume (port of tmdiff_tpu/train/checkpoint.py: orbax ->
torch.save / torch.load).

A checkpoint is a directory `I{step}` under the checkpoint root holding
`state.pt`, the TrainState's `state_dict()` (step, weights, AdamW moments,
the schedule's position, EMA). It is written into a temporary directory
beside it and renamed into place, so a reader (or a run cut off mid-save)
never sees half a checkpoint. Loading uses `torch.load(weights_only=True)`:
tensors and plain containers only, no code.

The reference saves `I{step}_gen.pth` (the weights) beside an optimizer file
and, on resume, restores the weights and the step only; `weights_only=True`
does the same here. `import_reference_checkpoint` and
`export_reference_checkpoint` read and write the reference's `_gen.pth`
layout (keys under `denoise_fn.`, conv weights (O, I, kd, kh, kw)).

On a mesh (parallel/mesh.py) the state is replicated: rank 0 writes, then
every rank waits at a barrier, so that each may restore the file after it.
"""
from __future__ import annotations

import os
import re
import shutil
from typing import Optional

import torch
import torch.distributed as dist

from tmdiff_tpu_torch.train.trainer import TrainState
from tmdiff_tpu_torch.utils.weights import from_reference_state_dict

STATE_FILE = "state.pt"
REFERENCE_PREFIX = "denoise_fn."


def checkpoint_path(root: str, step: int) -> str:
    return os.path.join(os.path.abspath(root), f"I{step}")


def _steps(root: str) -> list[int]:
    if not os.path.isdir(root):
        return []
    return sorted(int(m.group(1)) for name in os.listdir(root)
                  if (m := re.fullmatch(r"I(\d+)", name))
                  and os.path.exists(os.path.join(root, name, STATE_FILE)))


def save_checkpoint(root: str, state: TrainState, keep: Optional[int] = None,
                    mesh=None) -> str:
    """Writes `I{step}` atomically; `keep` prunes to the newest `keep`
    checkpoints (None keeps all, as the reference). Returns the path. On a
    `mesh` of more than one rank, rank 0 writes and every rank returns after
    a barrier."""
    path = checkpoint_path(root, state.step)
    if mesh is not None and mesh.size > 1:
        if mesh.rank == 0:
            _write(root, state, keep)
        dist.barrier(group=mesh.world_group)
        return path
    return _write(root, state, keep)


def _write(root: str, state: TrainState, keep: Optional[int]) -> str:
    os.makedirs(root, exist_ok=True)
    path = checkpoint_path(root, state.step)
    tmp = f"{path}.tmp-{os.getpid()}"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    torch.save(state.state_dict(), os.path.join(tmp, STATE_FILE))
    if os.path.exists(path):
        shutil.rmtree(path)
    os.rename(tmp, path)
    if keep is not None:
        for old in _steps(root)[:-keep]:
            shutil.rmtree(checkpoint_path(root, old), ignore_errors=True)
    return path


def latest_step(root: str) -> Optional[int]:
    steps = _steps(root)
    return steps[-1] if steps else None


def restore_checkpoint(root: str, state: TrainState, step: Optional[int] = None,
                       weights_only: bool = False) -> TrainState:
    """Loads checkpoint `step` (the newest when None) of `root` into `state`
    in place and returns it. `weights_only` is the reference's resume: the
    step and the weights, with a fresh optimiser and schedule and the EMA
    set to the weights."""
    if step is None:
        step = latest_step(root)
        if step is None:
            raise FileNotFoundError(f"no I<step> checkpoints under {root}")
    # read to the host: loading then puts each tensor where the state keeps
    # it (AdamW's step counts stay on the host, as a fresh optimiser has them)
    sd = torch.load(os.path.join(checkpoint_path(root, step), STATE_FILE), map_location="cpu",
                    weights_only=True)
    if not weights_only:
        return state.load_state_dict(sd)
    state.model.load_state_dict(sd["model"], strict=True)
    return _fresh_from_weights(state, int(sd["step"]))


def _fresh_from_weights(state: TrainState, step: int) -> TrainState:
    """The state at `step` with the model's current weights, a fresh
    optimiser and schedule of the same settings, and the EMA at the
    weights."""
    state.optimizer.state.clear()  # AdamW's moments and step counts
    state.scheduler = torch.optim.lr_scheduler.LambdaLR(state.optimizer,
                                                        state.scheduler.lr_lambdas)
    with torch.no_grad():
        for e, p in zip(state.ema_params, state.model.parameters()):
            e.copy_(p)
    state.step = step
    return state


def restore_path(path: str, state: TrainState) -> tuple[TrainState, Optional[str]]:
    """Loads the checkpoint that `path` names into `state`, as the CLI's
    `path.resume` and the server's `--ckpt` name one: a reference `.pth`
    (or the `I{step}` prefix of an `I{step}_gen.pth`), one `I{step}`
    directory, or a checkpoint root (its newest). Returns (state, the
    `.pth` read, or None). A directory without the port's `state.pt` files,
    such as the JAX package's orbax checkpoints, raises: the port does not
    read orbax."""
    if path.endswith(".pth") or os.path.exists(path + "_gen.pth"):
        pth = path if path.endswith(".pth") else path + "_gen.pth"
        return import_reference_checkpoint(pth, state), pth
    root, name = os.path.split(os.path.normpath(path))
    if re.fullmatch(r"I\d+", name) and os.path.exists(os.path.join(path, STATE_FILE)):
        return restore_checkpoint(root, state, step=int(name[1:])), None
    if _steps(path):
        return restore_checkpoint(path, state), None
    if os.path.isdir(path):
        raise ValueError(f"{path} holds no checkpoint of the port (I<step>/{STATE_FILE}): the "
                         "port reads its own checkpoints and reference .pth files, not the JAX "
                         "package's orbax checkpoints")
    raise FileNotFoundError(f"no checkpoint at {path}")


def _reference_state_dict(path: str) -> dict:
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return {k: v.numpy() for k, v in sd.items() if "clip_text" not in k}


def import_reference_checkpoint(gen_pth: str, state: TrainState) -> TrainState:
    """Loads a reference `I{step}_gen.pth` into `state` as the reference
    resumes: the weights and the step from the file name, a fresh optimiser,
    the EMA at the weights. A trained reference checkpoint reproduces the
    reference only under the true CLIP prompt vectors it was trained with,
    so this refuses the placeholder table (require_real_clip)."""
    from tmdiff_tpu_torch.models.clip_text import require_real_clip

    require_real_clip(f"importing reference checkpoint {gen_pth!r}")
    sd = _reference_state_dict(gen_pth)
    prefix = REFERENCE_PREFIX if any(k.startswith(REFERENCE_PREFIX) for k in sd) else ""
    from_reference_state_dict(state.model, sd, prefix=prefix)
    m = re.search(r"I(\d+)_gen", os.path.basename(gen_pth))
    return _fresh_from_weights(state, int(m.group(1)) if m else 0)


def export_reference_checkpoint(state: TrainState, path: str) -> str:
    """Writes the model's weights as a reference `I{step}_gen.pth`: keys
    under `denoise_fn.`, conv weights back to torch's (O, I, kd, kh, kw)."""
    sd = {}
    for k, v in state.model.state_dict().items():
        v = v.detach().cpu()
        sd[REFERENCE_PREFIX + k] = (v.permute(4, 3, 0, 1, 2) if v.dim() == 5 else v).contiguous()
    torch.save(sd, path)
    return path
