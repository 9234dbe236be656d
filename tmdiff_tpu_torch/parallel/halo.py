"""Halo exchange along the height of a space-sharded tensor.

`exchange_rows(x, mesh, axis, lo, hi)` returns x with `lo` rows added
before it along `axis` and `hi` rows after: the previous space rank's last
`lo` rows and the next rank's first `hi` rows, and zeros at the image's
edges (what the conv pads there). One row each side (the default) is the
halo of a SAME 3x3x3 conv, whose middle rows are then the rows of the
unsharded conv; a library conv of another window or stride
(ops/modconv.py) takes the rows its window reaches past the shard. Its
backward sends the pads' gradients back to the ranks the rows came from,
which add them to those rows. Rows cross in x's dtype (bf16 as bf16).

Transport: `dist.batch_isend_irecv` under NCCL; under gloo each row goes
through a host copy with `isend`/`irecv` (a CUDA tensor is copied out and
back explicitly). With one space rank, or a placement whose height is not
split, x is returned untouched and nothing is sent.

Under NCCL the exchange is legal inside a CUDA graph (Trainer.compiled_step
on a mesh): the sends and receives are NCCL kernels ordered after the
current stream's work, `wait()` makes the current stream wait for them
without a host sync, and the staged rows and zero buffers are allocations
of the current stream (the graph's pool while capturing). `mesh_lib.stats`
is host work: it counts an exchange when the step runs eagerly or is
captured, not at a replay.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from tmdiff_tpu_torch.parallel import mesh as mesh_lib


def _swap(to_prev, to_next, mesh, wire=None):
    """Sends `to_prev` to the previous space rank and `to_next` to the next;
    returns (what the previous rank sent as its `to_next`, what the next
    rank sent as its `to_prev`), zeros at the edges. Every rank passes the
    same shapes, so the first has `to_next`'s shape and the second
    `to_prev`'s; an empty tensor is not sent. `wire`: the dtype the rows
    cross in (their values must be exact in it), by default their own."""
    s, space = mesh.s, mesh.space
    prev = mesh.rank - 1 if s > 0 else None
    nxt = mesh.rank + 1 if s < space - 1 else None
    mesh_lib.stats["exchanges"] += 1
    staged = mesh.backend == "gloo" and to_prev.is_cuda
    wire = wire or to_prev.dtype
    stage = ((lambda t: t.detach().to(wire).cpu()) if staged
             else (lambda t: t.detach().to(wire).contiguous()))
    zeros = lambda t: torch.zeros_like(t, dtype=wire, memory_format=torch.contiguous_format)
    from_prev, from_next = zeros(to_next), zeros(to_prev)
    recv_prev, recv_next = (from_prev.cpu(), from_next.cpu()) if staged else (from_prev, from_next)
    sends, recvs = [], []
    if prev is not None:
        sends.append((stage(to_prev), prev))
        recvs.append((recv_prev, prev))
    if nxt is not None:
        sends.append((stage(to_next), nxt))
        recvs.append((recv_next, nxt))
    sends = [(t, peer) for t, peer in sends if t.numel()]
    recvs = [(t, peer) for t, peer in recvs if t.numel()]
    mesh_lib.stats["halo_bytes"] += sum(t.numel() * t.element_size() for t, _ in sends)
    if mesh.backend == "nccl":
        ops = [dist.P2POp(dist.isend, t, peer) for t, peer in sends]
        ops += [dist.P2POp(dist.irecv, t, peer) for t, peer in recvs]
        works = dist.batch_isend_irecv(ops) if ops else []
    else:
        works = [dist.isend(t, peer) for t, peer in sends]
        works += [dist.irecv(t, peer) for t, peer in recvs]
    for w in works:
        w.wait()
    if staged:
        from_prev.copy_(recv_prev)
        from_next.copy_(recv_next)
    return from_prev.to(to_next.dtype), from_next.to(to_prev.dtype)


class ExchangeRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, lo, hi, wire):
        ctx.mesh, ctx.axis, ctx.lo, ctx.hi = mesh, axis, lo, hi
        n = x.shape[axis]
        # the previous rank's bottom pad is my first hi rows, the next
        # rank's top pad my last lo rows
        top, bottom = _swap(x.narrow(axis, 0, hi), x.narrow(axis, n - lo, lo), mesh, wire)
        return torch.cat([top, x, bottom], dim=axis)

    @staticmethod
    def backward(ctx, g):
        mesh, axis, lo, hi = ctx.mesh, ctx.axis, ctx.lo, ctx.hi
        n = g.shape[axis] - lo - hi
        # the top pad's gradient belongs to the previous rank's last lo
        # rows, the bottom pad's to the next rank's first hi rows
        to_first, to_last = _swap(g.narrow(axis, 0, lo), g.narrow(axis, lo + n, hi), mesh)
        gx = g.narrow(axis, lo, n).clone()
        gx.narrow(axis, 0, hi).add_(to_first)
        gx.narrow(axis, n - lo, lo).add_(to_last)
        return gx, None, None, None, None, None


def exchange_rows(x, mesh, axis: int = 2, lo: int = 1, hi: int = 1, wire=None):
    """x with `lo` halo rows before it and `hi` after along `axis` (module
    doc); x itself where the placement `mesh` does not split the height.
    Both must lie within one shard: a window that reaches past the next
    rank raises. `wire`: the dtype x's rows cross in (bf16 values held in
    float32 cross as bf16); the gradients cross in their own."""
    if mesh is None or not mesh.halo:
        return x
    n = x.shape[axis]
    if not (0 <= lo <= n and 0 <= hi <= n):
        raise ValueError(f"a halo of {lo} rows before and {hi} after reaches past the "
                         f"neighbouring ranks' {n}-row shards")
    return ExchangeRows.apply(x, mesh, axis, lo, hi, wire)
