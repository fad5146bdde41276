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
* :func:`reduce_scatter`, Megatron sequence parallelism's ḡ: the sum of
  every rank's partial (B, S, d) that keeps the rank's block of the
  sequence; the ranks then compute different rows, so the adjoint
  all-gathers the gradient's blocks. Its f̄ is :func:`all_gather` with
  ``partial_grads=True`` (each rank's heads or columns read the whole
  sequence).
* :func:`split`, the rank's block of a tensor that is the same on every
  rank (a block computed whole on every rank, the embeddings of every
  token): the ranks then compute different rows, so the adjoint
  all-gathers the gradient's blocks.
* :func:`all_reduce_max` and :func:`all_reduce_min`, the vocab-parallel
  loss's max and the argmax's lowest index over the vocab shards: no
  gradient passes (the max is a constant of the log-sum-exp, as the
  reference's ``stop_gradient`` makes it).

A sequence of length S that the group's n ranks do not divide is laid
out as XLA lays out an uneven sharding: ``seq_block(S, n)`` rows a rank,
the padding at the end (on the last ranks). :func:`reduce_scatter` and
:func:`split` pad with zeros, and :func:`all_gather`'s ``length`` cuts the
padding off again.

Each takes ``group=None`` for an axis of size 1: no collective runs, and
the op is the identity both ways. Without a gradient to take the
collectives run as plain calls (no ``autograd.Function``); the results
are the same either way.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from . import roofline

__all__ = ["all_gather", "all_reduce", "reduce_grad", "reduce_scatter",
           "split", "seq_block", "all_reduce_max", "all_reduce_min"]


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


def seq_block(length: int, n: int) -> int:
    """The rows a rank holds of a sequence of ``length`` split over ``n``
    ranks (the last ranks' blocks padded)."""
    return -(-length // n)


def _padded(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """``t`` with zero rows appended along ``dim`` to a multiple of the
    group's size."""
    n = dist.get_world_size(group)
    pad = seq_block(t.shape[dim], n) * n - t.shape[dim]
    if pad == 0:
        return t
    shape = list(t.shape)
    shape[dim] = pad
    return torch.cat([t, t.new_zeros(shape)], dim)


def _cut(t: torch.Tensor, dim: int, length) -> torch.Tensor:
    """The first ``length`` rows of ``dim`` (``t`` itself for None or a
    whole length), contiguous."""
    if length is None or length == t.shape[dim]:
        return t
    return t.narrow(dim, 0, length).contiguous()


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


def all_gather(t: torch.Tensor, dim: int, group, *, partial_grads: bool,
               length=None) -> torch.Tensor:
    """Every rank's block of dim ``dim``, in rank order, its first
    ``length`` rows (a padded sequence cut back); the adjoint as the
    module says by ``partial_grads``."""
    if group is None:
        return t
    if _needs_grad(t):
        return _cut(_AllGather.apply(t, dim, group, partial_grads), dim,
                    length)
    return _cut(_gather(t, dim, group), dim, length)


def _blocks_joined(ctx, g):
    """The adjoint of a rank's block: every rank's block of the gradient
    gathered, the padding cut."""
    return _cut(_gather(g, ctx.dim, ctx.group), ctx.dim, ctx.length)


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, dim, group):
        ctx.dim, ctx.group, ctx.length = dim, group, t.shape[dim]
        return _reduce_scatter(_padded(t, dim, group), dim, group)

    @staticmethod
    def backward(ctx, g):
        return _blocks_joined(ctx, g), None, None


def reduce_scatter(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The rank's block of dim ``dim`` (``seq_block`` rows, zero-padded at
    the end) of the sum of every rank's ``t``; the adjoint all-gathers."""
    if group is None:
        return t
    if _needs_grad(t):
        return _ReduceScatter.apply(t, dim, group)
    return _reduce_scatter(_padded(t, dim, group), dim, group)


def _block(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    return _slice(_padded(t, dim, group), dim, group)


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, dim, group):
        ctx.dim, ctx.group, ctx.length = dim, group, t.shape[dim]
        return _block(t, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _blocks_joined(ctx, g), None, None


def split(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The rank's block of dim ``dim`` (``seq_block`` rows, zero-padded at
    the end) of ``t``, the same on every rank; the adjoint all-gathers."""
    if group is None:
        return t
    if _needs_grad(t):
        return _Split.apply(t, dim, group)
    return _block(t, dim, group)


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
