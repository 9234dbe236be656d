"""Halo exchange along the height of a space-sharded tensor.

`exchange_rows(x, mesh, axis)` returns x with one row added on each side of
`axis`: the top row is the previous space rank's last row, the bottom row the
next rank's first row, and zeros at the image's edges (what a SAME conv pads
there). A 3x3x3 conv of the result keeps its middle rows, which are then the
rows of the unsharded conv. Its backward sends the pads' gradients back to
the ranks the rows came from, which add them to those rows.

Transport: `dist.batch_isend_irecv` under NCCL; under gloo each row goes
through a host copy with `isend`/`irecv` (a CUDA tensor is copied out and
back explicitly). With one space rank, or a placement whose height is not
split, x is returned untouched and nothing is sent.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from tmdiff_tpu_torch.parallel import mesh as mesh_lib


def _swap(to_prev, to_next, mesh):
    """Sends `to_prev` to the previous space rank and `to_next` to the next;
    returns (from the previous rank, from the next), zeros at the edges."""
    s, space = mesh.s, mesh.space
    prev = mesh.rank - 1 if s > 0 else None
    nxt = mesh.rank + 1 if s < space - 1 else None
    mesh_lib.stats["exchanges"] += 1
    staged = mesh.backend == "gloo" and to_prev.is_cuda
    stage = (lambda t: t.detach().cpu()) if staged else (lambda t: t.detach().contiguous())
    from_prev, from_next = torch.zeros_like(to_prev), torch.zeros_like(to_next)
    recv_prev, recv_next = (from_prev.cpu(), from_next.cpu()) if staged else (from_prev, from_next)
    sends, recvs = [], []
    if prev is not None:
        sends.append((stage(to_prev), prev))
        recvs.append((recv_prev, prev))
    if nxt is not None:
        sends.append((stage(to_next), nxt))
        recvs.append((recv_next, nxt))
    mesh_lib.stats["halo_bytes"] += sum(t.numel() * t.element_size() for t, _ in sends)
    if mesh.backend == "nccl":
        ops = [dist.P2POp(dist.isend, t, peer) for t, peer in sends]
        ops += [dist.P2POp(dist.irecv, t, peer) for t, peer in recvs]
        works = dist.batch_isend_irecv(ops)
    else:
        works = [dist.isend(t, peer) for t, peer in sends]
        works += [dist.irecv(t, peer) for t, peer in recvs]
    for w in works:
        w.wait()
    if staged:
        from_prev.copy_(recv_prev)
        from_next.copy_(recv_next)
    return from_prev, from_next


class ExchangeRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        n = x.shape[axis]
        top, bottom = _swap(x.narrow(axis, 0, 1), x.narrow(axis, n - 1, 1), mesh)
        return torch.cat([top, x, bottom], dim=axis)

    @staticmethod
    def backward(ctx, g):
        mesh, axis = ctx.mesh, ctx.axis
        n = g.shape[axis] - 2
        # the top pad's gradient belongs to the previous rank's last row, the
        # bottom pad's to the next rank's first row
        to_first, to_last = _swap(g.narrow(axis, 0, 1), g.narrow(axis, n + 1, 1), mesh)
        gx = g.narrow(axis, 1, n).clone()
        gx.narrow(axis, 0, 1).add_(to_first)
        gx.narrow(axis, n - 1, 1).add_(to_last)
        return gx, None, None


def exchange_rows(x, mesh, axis: int = 2):
    """x with its halo rows along `axis` (module doc); x itself where the
    placement `mesh` does not split the height."""
    if mesh is None or not mesh.halo:
        return x
    return ExchangeRows.apply(x, mesh, axis)
