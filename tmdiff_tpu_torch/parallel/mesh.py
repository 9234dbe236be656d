"""The ("data", "space") device mesh on torch.distributed (port of
tmdiff_tpu/parallel/mesh.py).

One process per rank. The ranks are laid out row-major over ("data",
"space"), as the JAX package reshapes its devices: rank = d * space + s.

  * "data" shards the batch. Parameters are replicated; the trainer sums the
    gradients over the world in one flat all-reduce.
  * "space" shards the image height. Every SAME 3x3x3 conv first swaps one
    row with each neighbouring rank (parallel/halo.py), where XLA's SPMD
    partitioner inserts that exchange itself in the JAX package.

An axis that does not divide the array's size is not split: the array is
replicated along it, as `batch_sharding` falls back. The space axis also
needs H % (8 * space) == 0, so that each shard survives WavBEST's three Haar
halvings (a deliberate divergence: JAX splits wherever H % space == 0).

Backend rule, with no silent choice (`choose_backend`):
  * a CPU device uses gloo;
  * a CUDA device uses NCCL when every local rank has a card of its own
    (LOCAL_WORLD_SIZE <= torch.cuda.device_count()), rank r on
    cuda:LOCAL_RANK; host tensors (a stop flag) go through gloo beside it;
  * CUDA ranks that share a card raise, unless the caller asks for gloo by
    name; every collective then copies through host memory in this module,
    explicitly, and back.

`stats` counts the halo exchanges and the collectives with their bytes, for
the smoke run's report.
"""
from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Any, Optional

import torch
import torch.distributed as dist

from tmdiff_tpu_torch.utils.device import resolve_device

# Halo exchanges (calls and bytes sent) and collectives (calls and bytes
# contributed by this rank) since the last reset_stats().
stats = {"exchanges": 0, "halo_bytes": 0, "collectives": 0, "collective_bytes": 0}

TIMEOUT = datetime.timedelta(seconds=600)

# The backend and device this process joined its world with.
_joined: dict = {}


def reset_stats() -> None:
    stats.update(dict.fromkeys(stats, 0))


def _env_int(name: str, default: int) -> int:
    v = os.environ.get(name)
    return default if v in (None, "") else int(v)


def choose_backend(device=None, backend: Optional[str] = None) -> tuple[str, torch.device]:
    """(backend, this rank's device) by the rule of the module doc. `device`
    None means CUDA (and raises without a card), as the port's entry points
    resolve it."""
    device = resolve_device(device)
    if device.type == "cpu":
        if backend not in (None, "gloo"):
            raise ValueError(f"a CPU mesh runs on gloo, not {backend!r}")
        return "gloo", device
    if device.type != "cuda":
        raise ValueError(f"a mesh runs on CPU or CUDA devices, not {device}")
    local_rank = _env_int("LOCAL_RANK", 0)
    local_world = _env_int("LOCAL_WORLD_SIZE", _env_int("WORLD_SIZE", 1))
    cards = torch.cuda.device_count()
    if backend == "gloo":
        index = device.index if device.index is not None else local_rank % cards
        return "gloo", torch.device("cuda", index)
    if backend not in (None, "nccl"):
        raise ValueError(f"unknown backend {backend!r}; expected 'nccl' or 'gloo'")
    if local_world > cards:
        raise ValueError(
            f"{local_world} local ranks share {cards} CUDA device(s): NCCL needs a card per "
            "rank; pass backend='gloo' to run them on shared cards through host memory")
    return "nccl", torch.device("cuda", local_rank)


def init_distributed(device=None, backend: Optional[str] = None, *, init_method=None,
                     store_path: Optional[str] = None, rank: Optional[int] = None,
                     world_size: Optional[int] = None) -> bool:
    """Joins this process to its world (the counterpart of
    `initialize_multihost`): from torchrun's environment (RANK, WORLD_SIZE,
    LOCAL_RANK, LOCAL_WORLD_SIZE, MASTER_ADDR/PORT), or from an explicit
    `init_method` URL or a FileStore at `store_path` with `rank` and
    `world_size`. The backend follows `choose_backend`. Returns False (and
    does nothing) for a world of one process or one already joined."""
    if dist.is_initialized():
        return False
    world = world_size if world_size is not None else _env_int("WORLD_SIZE", 1)
    if world <= 1:
        return False
    rank = rank if rank is not None else _env_int("RANK", 0)
    backend, device = choose_backend(device, backend)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    pg_backend = "cpu:gloo,cuda:nccl" if backend == "nccl" else "gloo"
    kw: dict[str, Any] = {"backend": pg_backend, "timeout": TIMEOUT}
    if store_path is not None:
        kw.update(store=dist.FileStore(store_path, world), rank=rank, world_size=world)
    else:
        kw.update(init_method=init_method or "env://", rank=rank, world_size=world)
    dist.init_process_group(**kw)
    _joined.update(backend=backend, device=device)
    return True


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """A ("data", "space") mesh of `data` x `space` ranks. `place(shape)`
    gives the mesh as it applies to one array: `split_batch` and
    `split_rows` say whether the batch and the height of that array are
    split, or replicated along the axis (the fallback)."""

    data: int
    space: int
    rank: int
    backend: str
    device: torch.device
    space_group: Any  # the ranks with this rank's d: the "space" axis
    data_group: Any  # the ranks with this rank's s: the "data" axis
    world_group: Any
    split_batch: bool = True
    split_rows: bool = True

    @property
    def size(self) -> int:
        return self.data * self.space

    @property
    def d(self) -> int:
        return self.rank // self.space

    @property
    def s(self) -> int:
        return self.rank % self.space

    @property
    def transport(self) -> str:
        if self.backend == "nccl":
            return "NCCL between cards"
        return "gloo through host memory" if self.device.type == "cuda" else "gloo"

    @property
    def capturable(self) -> bool:
        """Whether a CUDA graph can hold this mesh's collectives and halo
        exchanges (Trainer.compiled_step on a card): under NCCL each is
        stream-ordered work on the card; under gloo each goes through host
        memory (`_staged`, parallel/halo.py), which no graph can hold. A
        CPU mesh captures nothing: compiled_step runs its step uncaptured."""
        return self.backend == "nccl"

    @property
    def halo(self) -> bool:
        """Whether the convs of this placement exchange rows."""
        return self.split_rows and self.space > 1

    def __repr__(self) -> str:
        return (f"Mesh(data={self.data}, space={self.space}, rank={self.rank} (d={self.d}, "
                f"s={self.s}), backend={self.backend}, transport={self.transport}, "
                f"device={self.device})")

    def place(self, shape) -> "Mesh":
        """This mesh as it applies to a global (B, ...) array of `shape`
        with its height at axis 2 (NCHW, or (B, D, H, W, C)): the batch is
        split where data divides B, the height where the array has one and
        8 * space divides it."""
        split_batch = self.data > 1 and shape[0] % self.data == 0
        split_rows = (self.space > 1 and len(shape) >= 3
                      and shape[2] % (8 * self.space) == 0)
        return dataclasses.replace(self, split_batch=split_batch, split_rows=split_rows)

    def batch_slice(self, b: int) -> slice:
        if not self.split_batch:
            return slice(None)
        n = b // self.data
        return slice(self.d * n, (self.d + 1) * n)

    def row_slice(self, h: int) -> slice:
        if not self.split_rows:
            return slice(None)
        n = h // self.space
        return slice(self.s * n, (self.s + 1) * n)

    def global_shape(self, shape, lead: int = 0) -> tuple:
        """The global shape of a local shard of `shape` (batch at `lead`,
        height at lead + 2 where the shard has one)."""
        shape = list(shape)
        if self.split_batch:
            shape[lead] *= self.data
        if self.split_rows and len(shape) >= lead + 3:
            shape[lead + 2] *= self.space
        return tuple(shape)

    def shard(self, x, lead: int = 0):
        """This rank's shard of a global array or tensor (batch at `lead`,
        height at lead + 2 where it has one)."""
        if x is None:
            return None
        idx = [slice(None)] * lead + [self.batch_slice(x.shape[lead])]
        if len(x.shape) >= lead + 3:
            idx += [slice(None), self.row_slice(x.shape[lead + 2])]
        return x[tuple(idx)]

    def gather(self, x, lead: int = 0):
        """The global tensor of this rank's shard `x`, on every rank: an
        all-gather over space along the height, then over data along the
        batch."""
        if self.halo and x.dim() >= lead + 3:
            x = torch.cat(all_gather(x, self, self.space_group), dim=lead + 2)
        if self.split_batch:
            x = torch.cat(all_gather(x, self, self.data_group), dim=lead)
        return x

    def any(self, flag: bool) -> bool:
        """Whether `flag` is set on any rank (a host all-reduce)."""
        if self.size == 1:
            return bool(flag)
        t = torch.tensor([int(bool(flag))], dtype=torch.int32)
        _count(t)
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.world_group)
        return bool(t.item())


def make_mesh(data: Optional[int] = None, space: int = 1, backend: Optional[str] = None,
              device=None) -> Mesh:
    """A ("data", "space") mesh over every rank of this process's world,
    joining the world first from torchrun's environment where it has not
    been joined. `data` defaults to world // space. Every rank must call
    this, in the same order as its other meshes (it makes process groups).
    In a world already joined, `backend` and `device` default to those it
    was joined with."""
    if dist.is_initialized() and _joined and backend is None and device is None:
        backend, device = _joined["backend"], _joined["device"]
    backend, device = choose_backend(device, backend)
    init_distributed(device, backend)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if data is None:
        data = world // space
    if data * space != world:
        raise ValueError(f"mesh {data}x{space} != {world} ranks")
    if world == 1:
        return Mesh(1, 1, 0, backend, device, None, None, None)
    running = dist.get_backend()
    if (backend == "nccl") != ("nccl" in running):
        raise ValueError(f"the world runs {running}, the mesh wants {backend}")
    rank = dist.get_rank()
    space_group = data_group = None
    for d in range(data):  # every rank makes every group, in one order
        g = dist.new_group([d * space + s for s in range(space)])
        if d == rank // space:
            space_group = g
    for s in range(space):
        g = dist.new_group([d * space + s for d in range(data)])
        if s == rank % space:
            data_group = g
    return Mesh(data, space, rank, backend, device, space_group, data_group, dist.group.WORLD)


def shard_slices(mesh: Mesh, shape) -> tuple[slice, slice]:
    """(batch slice, height slice) of this rank in a global NCHW or
    (B, D, H, W, C) array of `shape`, with the fallbacks of `Mesh.place`."""
    placed = mesh.place(shape)
    rows = placed.row_slice(shape[2]) if len(shape) >= 3 else slice(None)
    return placed.batch_slice(shape[0]), rows


def shard_batch(mesh: Mesh, batch: dict) -> dict:
    """This rank's shard of every array of a host batch dict, placed by the
    shape of its "MS" entry (or its first entry): every entry is split
    alike."""
    ref = batch["MS"] if "MS" in batch else next(iter(batch.values()))
    placed = mesh.place(tuple(ref.shape))
    return {k: placed.shard(v) for k, v in batch.items()}


def gather(x, mesh: Mesh):
    """The global tensor of shard `x` on every rank (`Mesh.gather`)."""
    return mesh.gather(x)


def _count(t) -> None:
    stats["collectives"] += 1
    stats["collective_bytes"] += t.numel() * t.element_size()


def _staged(mesh: Mesh, t):
    """The tensor a collective takes: `t` itself under NCCL or on the CPU,
    a host copy of a CUDA tensor under gloo."""
    if mesh.backend == "gloo" and t.is_cuda:
        return t.detach().cpu()
    return t


def all_gather(x, mesh: Mesh, group) -> list:
    """The shards of `x` of every rank of `group`, in rank order, on x's
    device."""
    _count(x)
    src = _staged(mesh, x.contiguous())
    parts = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, src, group=group)
    return [p.to(x.device) for p in parts]


def all_reduce_(x, mesh: Mesh, op=dist.ReduceOp.SUM, group=None):
    """Reduces `x` over `group` (the world by default) in place and returns
    it; under gloo a CUDA tensor goes through a host copy and back."""
    _count(x)
    src = _staged(mesh, x)
    dist.all_reduce(src, op=op, group=mesh.world_group if group is None else group)
    if src is not x:
        x.copy_(src)
    return x


def broadcast_(x, mesh: Mesh, src: int = 0):
    """Overwrites `x` with rank `src`'s value, in place."""
    _count(x)
    staged = _staged(mesh, x)
    dist.broadcast(staged, src, group=mesh.world_group)
    if staged is not x:
        x.copy_(staged)
    return x
