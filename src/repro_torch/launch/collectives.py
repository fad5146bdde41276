"""Collectives that autograd passes through, each recording its bytes in
the active count (``launch/roofline.py``).

The adjoint of a collective depends on what the ranks of its group do
with the result:

* :func:`all_gather` with ``partial_grads=True``: the ranks then compute
  different rows (the FSDP weight gather over a batch axis, the expert
  slab over the MoE's token split), so each rank's gradient of the whole
  tensor is a partial sum; the adjoint is a reduce-scatter.
* :func:`all_gather` with ``partial_grads=False``: the ranks then compute
  the same thing (a weight's gather over the TP axis while every rank
  computes every head, the MoE's token split gathered back, the logits'
  rows gathered), so each rank holds the whole gradient; the adjoint is
  the rank's own slice (a reduce-scatter there would multiply it by the
  group's size).
* :func:`all_reduce`, the MoE's sum of its ranks' partial outputs
  (Megatron's g): the ranks then compute the same thing, and the gradient
  passes through unchanged.
* :func:`reduce_grad`, the entry of a tensor that is the same on every
  rank into a computation that differs by rank (Megatron's f: x into the
  rank's experts or heads, a replicated weight used on the rank's rows or
  heads): the identity forward, and its backward all-reduces the
  gradient.
* :func:`all_reduce_max` and :func:`all_reduce_min`, the vocab-parallel
  loss's max and the argmax's lowest index over the vocab shards: no
  gradient passes (the max is a constant of the log-sum-exp, as the
  reference's ``stop_gradient`` makes it).

Each takes ``group=None`` for an axis of size 1: no collective runs, and
the op is the identity both ways. Without a gradient to take the
collectives run as plain calls (no ``autograd.Function``); the results
are the same either way.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from . import roofline

__all__ = ["all_gather", "all_reduce", "reduce_grad", "all_reduce_max",
           "all_reduce_min"]


def _record(kind: str, t: torch.Tensor, group) -> None:
    """``t``'s bytes in the active count (``launch/roofline.py``)."""
    if roofline.active() is not None:
        roofline.record_collective(kind, t.numel() * t.element_size(),
                                   dist.get_process_group_ranks(group))


def _gather0(x: torch.Tensor, group) -> torch.Tensor:
    """Every rank's ``x`` stacked along dim 0."""
    n = dist.get_world_size(group)
    out = x.new_empty((n * x.shape[0], *x.shape[1:]))
    fn = getattr(dist, "all_gather_single", None) or \
        dist.all_gather_into_tensor
    fn(out, x.contiguous(), group=group)
    _record("all-gather", out, group)
    return out


def _scatter0(x: torch.Tensor, group) -> torch.Tensor:
    """The rank's block of dim 0 of the sum of every rank's ``x``."""
    n = dist.get_world_size(group)
    x = x.contiguous()
    out = x.new_empty((x.shape[0] // n, *x.shape[1:]))
    fn = getattr(dist, "reduce_scatter_single", None) or \
        dist.reduce_scatter_tensor
    fn(out, x, group=group)
    _record("reduce-scatter", x, group)
    return out


def _gather(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    out = _gather0(t.movedim(dim, 0), group)
    return out if dim == 0 else out.movedim(0, dim).contiguous()


def _reduce_scatter(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    out = _scatter0(t.movedim(dim, 0), group)
    return out if dim == 0 else out.movedim(0, dim).contiguous()


def _slice(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    n, r = dist.get_world_size(group), dist.get_rank(group)
    size = t.shape[dim] // n
    return t.narrow(dim, r * size, size).contiguous()


def _sum(t: torch.Tensor, group) -> torch.Tensor:
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    _record("all-reduce", t, group)
    return t


def _needs_grad(t: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and t.requires_grad


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, dim, group, partial_grads):
        ctx.dim, ctx.group, ctx.partial = dim, group, partial_grads
        return _gather(t, dim, group)

    @staticmethod
    def backward(ctx, g):
        adj = _reduce_scatter if ctx.partial else _slice
        return adj(g, ctx.dim, ctx.group), None, None, None


def all_gather(t: torch.Tensor, dim: int, group, *,
               partial_grads: bool) -> torch.Tensor:
    """Every rank's block of dim ``dim``, in rank order; the adjoint as the
    module says by ``partial_grads``."""
    if group is None:
        return t
    if _needs_grad(t):
        return _AllGather.apply(t, dim, group, partial_grads)
    return _gather(t, dim, group)


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        return _sum(t.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    """The sum of every rank's ``t``; the gradient passes through. Without
    a gradient to take, ``t`` itself is summed in place."""
    if group is None:
        return t
    if _needs_grad(t):
        return _AllReduce.apply(t, group)
    return _sum(t, group)


class _ReduceGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return _sum(g.clone(), ctx.group), None


def reduce_grad(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` itself; its gradient summed over ``group`` in the backward."""
    if group is None or not _needs_grad(t):
        return t
    return _ReduceGrad.apply(t, group)


def _reduce_op(t: torch.Tensor, group, op) -> torch.Tensor:
    if group is None:
        return t
    out = t.detach().clone()
    dist.all_reduce(out, op=op, group=group)
    _record("all-reduce", out, group)
    return out


def all_reduce_max(t: torch.Tensor, group) -> torch.Tensor:
    """The elementwise max of every rank's ``t`` (a new tensor, no
    gradient); ``t`` itself for ``group=None``."""
    return _reduce_op(t, group, dist.ReduceOp.MAX)


def all_reduce_min(t: torch.Tensor, group) -> torch.Tensor:
    """The elementwise min of every rank's ``t`` (a new tensor, no
    gradient); ``t`` itself for ``group=None``."""
    return _reduce_op(t, group, dist.ReduceOp.MIN)
