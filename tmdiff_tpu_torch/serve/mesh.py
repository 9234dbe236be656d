"""Serving over a ("data", "space") mesh: one server over every rank of a
torchrun world, as the JAX server spans every device of its host with one
SPMD program (tmdiff_tpu/serve/__main__.py builds `make_mesh` whenever it
sees more than one device).

    python -m torch.distributed.run --nproc-per-node N -m tmdiff_tpu_torch.serve \\
        -c <config> --ckpt <ckpt> [--mesh-space S]

Rank 0 runs the HTTP server and the engine (serve/engine.py, unchanged) on a
`MeshLeader`, which has `Pansharpener.sample`'s signature. For each batch the
leader broadcasts one message to every rank: pan and ms as numpy, the
sensors, method, steps, seed and the other keyword arguments (the
deployment's `sampler_kw` and a dpm++_cfg batch's guidance vector). Then
every rank calls the same meshed `Pansharpener.sample` (pipeline.py), which
shards the batch over "data" and the height over "space" and gathers the
images on every rank; rank 0's engine resolves the futures with them. Every
other rank runs `follow`, a loop that waits for the next message.

Hazards, and what this module does about each:
  * An idle server. Followers wait between requests for as long as no
    traffic comes. The messages go over a gloo group of their own
    (`control_group`) whose timeout, IDLE_TIMEOUT, is 30 days, so an idle
    world is not stopped by its own wait. They never go over NCCL, whose
    watchdog would end an idle world.
  * Stop. `MeshLeader.stop()` broadcasts a stop message (the entry point
    calls it after `engine.shutdown()`, on SIGINT); every follower leaves
    its loop. The entry point makes a follower ignore SIGINT, which
    torchrun forwards to every rank: it waits for rank 0's stop rather than
    dying inside a collective.
  * Errors. A request that `submit()` refuses never reaches the followers.
    After every batch the ranks agree on its outcome (`_settle`: a gloo
    all-reduce of a failure flag, waited for at most SETTLE_TIMEOUT). A
    batch that failed on every rank (a bad input fails alike everywhere)
    resolves its group's futures with the error, as the JAX engine does,
    and serving goes on. A batch that failed on some ranks only, or a
    settle that does not complete in time, means the ranks may be out of
    step: that rank exits with status 1 at once (no collective is waited
    for), and torchrun ends the world.
  * Warm-up goes through the leader like any batch, so every rank warms
    every bucket.

`stats` (the leader's, and the dict `follow` returns) counts the
broadcasts, the batches run and the batches that failed on every rank.
"""
from __future__ import annotations

import datetime
import os
import sys
import threading
import traceback

import numpy as np
import torch
import torch.distributed as dist

IDLE_TIMEOUT = datetime.timedelta(days=30)
SETTLE_TIMEOUT = datetime.timedelta(seconds=300)


def control_group():
    """The gloo group of the control messages. Every rank makes it, in the
    same order as its other groups (MeshLeader and follow make it first)."""
    return dist.new_group(backend="gloo", timeout=IDLE_TIMEOUT)


def _new_stats() -> dict:
    return {"broadcasts": 0, "batches": 0, "failed_batches": 0}


def _broadcast(msg, group):
    box = [msg]
    dist.broadcast_object_list(box, src=0, group=group)
    return box[0]


def _out_of_step(reason: str) -> None:
    print(f"mesh serving: rank {dist.get_rank()} stops the world: {reason}", file=sys.stderr,
          flush=True)
    sys.stdout.flush()
    os._exit(1)


def _settle(failed: bool, group) -> None:
    """Every rank's outcome of the batch: returns where all ranks succeeded
    or all failed; exits (module doc) where only some failed or the ranks do
    not settle within SETTLE_TIMEOUT."""
    flag = torch.tensor([int(failed)], dtype=torch.int32)
    try:
        dist.all_reduce(flag, group=group, async_op=True).wait(timeout=SETTLE_TIMEOUT)
    except RuntimeError as err:
        _out_of_step(f"the ranks did not settle a batch within {SETTLE_TIMEOUT}: {err}")
    n, world = int(flag.item()), dist.get_world_size(group)
    if 0 < n < world:
        _out_of_step(f"a batch failed on {n} of {world} ranks")


def _run(sharp, call: dict, group, stats: dict):
    """One batch on this rank: the meshed sample, then the settle."""
    try:
        out = sharp.sample(call["batch"], sensor=call["sensor"], method=call["method"],
                           seed=call["seed"], steps=call["steps"], **call["kw"])
    except Exception:
        _settle(True, group)
        stats["failed_batches"] += 1
        raise
    _settle(False, group)
    stats["batches"] += 1
    return out


class MeshLeader:
    """Rank 0's front of a meshed Pansharpener (`sharp.mesh` set): `sample`
    broadcasts the call to every rank and runs it here, one batch at a
    time; `stop` ends the followers' loops. Makes the control group, so
    every other rank calls `follow` at the same point."""

    def __init__(self, sharp):
        self.sharp = sharp
        self.group = control_group()
        self.stats = _new_stats()
        self._lock = threading.Lock()
        self._stopped = False

    @property
    def device(self):
        return self.sharp.device

    def _send(self, msg) -> None:
        _broadcast(msg, self.group)
        self.stats["broadcasts"] += 1

    def sample(self, batch: dict, sensor="QB", method: str = "dpm++", seed: int = 0,
               steps=None, **kw):
        call = {"batch": {k: np.asarray(v, np.float32) for k, v in batch.items()},
                "sensor": sensor, "method": method, "seed": int(seed), "steps": steps,
                "kw": kw}
        with self._lock:
            if self._stopped:
                raise RuntimeError("the mesh has stopped serving")
            self._send({"op": "sample", **call})
            return _run(self.sharp, call, self.group, self.stats)

    def stop(self) -> None:
        """Broadcasts the stop message once; waits for a batch in flight."""
        with self._lock:
            if not self._stopped:
                self._send({"op": "stop"})
                self._stopped = True


def follow(sharp) -> dict:
    """The loop of every rank but 0: each broadcast batch through the same
    meshed `sharp.sample`, until the stop message. A batch that failed on
    every rank is reported here and skipped (the leader's clients get the
    error). Returns this rank's stats."""
    group = control_group()
    stats = _new_stats()
    while True:
        msg = _broadcast(None, group)
        stats["broadcasts"] += 1
        if msg["op"] == "stop":
            return stats
        try:
            _run(sharp, msg, group, stats)
        except Exception:  # failed on every rank: the leader reports it, serving goes on
            traceback.print_exc()
