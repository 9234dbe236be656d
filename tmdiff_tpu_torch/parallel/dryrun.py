"""A world of processes on one host, each running one worker function
(counterpart of tools/multihost_dryrun.py, for the port's mesh).

    from tmdiff_tpu_torch.parallel.dryrun import run_world
    results = run_world("my_workers:fn", world=4, args=(...), device="cpu")

Each rank is a fresh interpreter (`python -m tmdiff_tpu_torch.parallel.dryrun
<dir> <rank>`) with torchrun's environment (RANK, WORLD_SIZE, LOCAL_RANK,
LOCAL_WORLD_SIZE). It joins the world through a FileStore in `<dir>`
(parallel/mesh.py::init_distributed, the backend by its rule: `backend`
"gloo" must be named for CUDA ranks that share a card), imports the
worker's module (from `sys_path` and the package's root) and calls
`fn(*args, **kwargs)`; the result is pickled back. A worker imports torch,
numpy and the port, so the world never loads anything else it does not ask
for.

`run_world` returns the results in rank order. If any rank exits with an
error, or the world outlives `timeout`, every rank still running is killed
and RuntimeError carries each failed rank's standard error. No process
outlives the call.
"""
from __future__ import annotations

import os
import pickle
import shutil
import subprocess
import sys
import tempfile
import time
from typing import Optional, Sequence

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def run_world(target: str, world: int, args: Sequence = (), kwargs: Optional[dict] = None, *,
              device="cpu", backend: Optional[str] = None, sys_path: Sequence[str] = (),
              threads: int = 1, timeout: float = 600.0) -> list:
    """Runs `target` ("module:function") on `world` ranks (module doc).
    `device` is every rank's device ("cpu", "cuda": card LOCAL_RANK, or
    "cuda:0": one shared card), `threads` each rank's torch threads."""
    io = tempfile.mkdtemp(prefix="mesh_world_")
    procs = []
    try:
        with open(os.path.join(io, "spec.pkl"), "wb") as f:
            pickle.dump({"target": target, "args": tuple(args), "kwargs": kwargs or {},
                         "device": device, "backend": backend, "world": world,
                         "sys_path": [os.path.abspath(p) for p in sys_path],
                         "threads": threads}, f)
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            [ROOT] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
        env.update(OMP_NUM_THREADS=str(threads), WORLD_SIZE=str(world),
                   LOCAL_WORLD_SIZE=str(world))
        for rank in range(world):
            out = open(os.path.join(io, f"rank{rank}.out"), "w")
            err = open(os.path.join(io, f"rank{rank}.err"), "w")
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "tmdiff_tpu_torch.parallel.dryrun", io, str(rank)],
                env={**env, "RANK": str(rank), "LOCAL_RANK": str(rank)}, stdout=out,
                stderr=err, cwd=ROOT))
            out.close()
            err.close()
        deadline = time.monotonic() + timeout
        while any(p.poll() is None for p in procs):
            if any(p.poll() not in (None, 0) for p in procs):
                break
            if time.monotonic() > deadline:
                break
            time.sleep(0.05)
        timed_out = any(p.poll() is None for p in procs) and time.monotonic() > deadline
        _stop(procs)
        failed = [r for r, p in enumerate(procs) if p.returncode != 0]
        if failed or timed_out:
            shown = [r for r in failed if procs[r].returncode > 0] or failed
            detail = "\n".join(f"--- rank {r} (exit {procs[r].returncode}) ---\n"
                               + _read(io, f"rank{r}.err")[-3000:] for r in shown)
            raise RuntimeError(f"{target} on {world} ranks "
                               f"{'timed out' if timed_out else 'failed'}:\n{detail}")
        results = []
        for rank in range(world):
            with open(os.path.join(io, f"rank{rank}.pkl"), "rb") as f:
                results.append(pickle.load(f))
        return results
    finally:
        _stop(procs)
        shutil.rmtree(io, ignore_errors=True)


def _read(io: str, name: str) -> str:
    try:
        with open(os.path.join(io, name)) as f:
            return f.read()
    except OSError:
        return ""


def _stop(procs) -> None:
    for p in procs:
        if p.poll() is None:
            p.kill()
    for p in procs:
        p.wait()


def _child(io: str, rank: int) -> None:
    import importlib

    import torch
    import torch.distributed as dist

    from tmdiff_tpu_torch.parallel.mesh import init_distributed

    with open(os.path.join(io, "spec.pkl"), "rb") as f:
        spec = pickle.load(f)
    sys.path[:0] = spec["sys_path"]
    torch.set_num_threads(spec["threads"])
    init_distributed(spec["device"], spec["backend"], store_path=os.path.join(io, "store"),
                     rank=rank, world_size=spec["world"])
    module, name = spec["target"].split(":")
    result = getattr(importlib.import_module(module), name)(*spec["args"], **spec["kwargs"])
    with open(os.path.join(io, f"rank{rank}.pkl.tmp"), "wb") as f:
        pickle.dump(result, f)
    os.replace(os.path.join(io, f"rank{rank}.pkl.tmp"), os.path.join(io, f"rank{rank}.pkl"))
    if dist.is_initialized():
        dist.destroy_process_group()


if __name__ == "__main__":
    _child(sys.argv[1], int(sys.argv[2]))
