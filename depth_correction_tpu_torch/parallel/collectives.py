"""The collectives of the sharded step, as autograd Functions over
``torch.distributed`` (counterparts of the ``all_gather`` and ``psum`` of
the JAX package's shard_map bodies, parallel/sharding.py).

One rule keeps the gradients exact: every rank back-propagates only its
own share of the loss. A loss that is a sum over rows is split into the
ranks' partial sums; each rank's backward sees its partial sum, the global
value is a detached all-reduce (:func:`all_reduce_sum`) and the parameters'
gradients are all-reduced once (:func:`all_reduce_grads`). Back-propagating
the replicated global loss on every rank instead would count every
gather's backward once per rank, a gradient D times too large.

- :func:`all_gather_rows`: the ranks' equal slices concatenated along a
  dimension. Its backward all-reduces the full cotangent (each rank's
  partial gradient of every row) and returns the rank's own slice, the
  JAX package's zeros-elsewhere-plus-psum (cellwin_shard.py:341-350).
- :func:`sum_over_ranks`: a differentiable all-reduce whose backward is an
  all-reduce too, for a loss that is replicated after the sum (plane
  mode's moment sums): each rank then back-propagates the replicated loss
  over D, and the backward all-reduce adds up the ranks' cotangents, as
  the JAX package's psum transposes under shard_map.

``torch.distributed.nn.functional`` is not used: its gather's backward
runs an all_to_all on gloo and leaves the share of the loss to the caller.
Every rank must run the same collectives in the same order; the sharded
loss keeps one gather per sequence (positions and any other per-point
table side by side), so each backward is one chain of collectives.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.distributed as dist

__all__ = ["all_gather_rows", "all_reduce_grads", "all_reduce_sum", "broadcast_object",
           "gather_detached",
           "gather_query_slices", "query_slice", "sum_over_ranks", "with_global_value"]


def _gather(x: torch.Tensor, dim: int, mesh) -> torch.Tensor:
    parts = [torch.empty_like(x) for _ in range(mesh.size)]
    dist.all_gather(parts, x.contiguous(), group=mesh.group)
    return torch.cat(parts, dim)


class _AllGatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim: int, mesh):
        ctx.dim, ctx.mesh, ctx.n = dim, mesh, x.shape[dim]
        return _gather(x, dim, mesh)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.mesh.group)
        return g.narrow(ctx.dim, ctx.mesh.rank * ctx.n, ctx.n), None, None


def all_gather_rows(x: torch.Tensor, mesh, dim: int = 0) -> torch.Tensor:
    """Concatenate every rank's ``x`` (equal shapes) along ``dim``, rank
    order; differentiable (see the module docstring)."""
    return _AllGatherRows.apply(x, dim, mesh)


def gather_detached(x: torch.Tensor, mesh, dim: int = 0) -> torch.Tensor:
    """:func:`all_gather_rows` without a gradient."""
    return _gather(x.detach(), dim, mesh)


def query_slice(nq: int, mesh) -> Tuple[int, int, int]:
    """The rank's rows ``[lo, hi)`` of ``nq`` queries split into equal
    slices of ``per`` rows (the last ones short or empty)."""
    per = -(-nq // mesh.size)
    return min(mesh.rank * per, nq), min((mesh.rank + 1) * per, nq), per


def gather_query_slices(tables, nq: int, per: int, mesh, fills):
    """Every rank's (rows, k) tables of its :func:`query_slice`, padded to
    ``per`` rows with ``fills`` and gathered back in query order."""
    out = []
    for t, fill in zip(tables, fills):
        if t.shape[0] < per:
            t = torch.cat([t, t.new_full((per - t.shape[0],) + tuple(t.shape[1:]), fill)])
        out.append(gather_detached(t, mesh)[:nq])
    return tuple(out)


def broadcast_object(obj, mesh):
    """Rank 0's picklable ``obj`` on every rank (the others pass None)."""
    box = [obj]
    dist.broadcast_object_list(box, src=0, group=mesh.group, device=mesh.device)
    return box[0]


def all_reduce_sum(x: torch.Tensor, mesh) -> torch.Tensor:
    """The sum over ranks of ``x``, detached (a new tensor)."""
    y = x.detach().clone()
    dist.all_reduce(y, group=mesh.group)
    return y


class _SumOverRanks(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        y = x.detach().clone()
        dist.all_reduce(y, group=mesh.group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.mesh.group)
        return g, None


def sum_over_ranks(x: torch.Tensor, mesh) -> torch.Tensor:
    """The sum over ranks of ``x``; its backward all-reduces the cotangent
    (for a replicated loss back-propagated as loss / D on every rank)."""
    return _SumOverRanks.apply(x, mesh)


class _GlobalValue(torch.autograd.Function):
    @staticmethod
    def forward(ctx, share, value):
        return value.detach().clone()

    @staticmethod
    def backward(ctx, g):
        return g, None


def with_global_value(share: torch.Tensor, value: torch.Tensor) -> torch.Tensor:
    """A tensor that holds ``value`` (the global loss, the same bits on
    every rank) and back-propagates into ``share`` (this rank's part)."""
    return _GlobalValue.apply(share, value)


def all_reduce_grads(tensors, mesh, grads=None):
    """Sum the gradients over ranks in one flat all-reduce.

    :param tensors: the trained tensors; their ``.grad`` is replaced by the
        sum (tensors without a gradient keep None, on every rank alike).
    :param grads: a list of gradients to reduce instead of ``.grad``;
        then the reduced list is returned.
    """
    own = grads is None
    gs = [t.grad for t in tensors] if own else list(grads)
    live = [g for g in gs if g is not None]
    if not live:
        return None if own else gs
    flat = torch.cat([g.reshape(-1) for g in live])
    dist.all_reduce(flat, group=mesh.group)
    out, at = [], 0
    for g in gs:
        if g is None:
            out.append(None)
            continue
        out.append(flat[at:at + g.numel()].view_as(g).clone())
        at += g.numel()
    if own:
        for t, g in zip(tensors, out):
            t.grad = g
        return None
    return out
