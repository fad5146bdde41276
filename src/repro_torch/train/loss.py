"""Cross-entropy loss of the training path (the JAX package's
``train/loss.py``).

On a vocab-sharded head (``models/tp.py``) the logits a rank holds are its
vocab columns, and the loss is vocab-parallel, as the reference's is
"SPMD-safe over a vocab-sharded logits axis": each rank reduces its
columns (:func:`vocab_pieces`, :func:`shard_sums`,
:func:`shard_argmax`), and small all-reduces over the TP group join them,
so no rank holds the (B, S, Vp) logits.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..launch import collectives
from ..models.layers import wide

__all__ = ["softmax_xent", "vocab_pieces", "shard_sums", "shard_argmax",
           "finish", "widened", "Pieces"]

# the padded columns' logit, and an index past any vocab
_MASKED = -1e30
_NO_INDEX = 2 ** 62


def widened(logits):
    """The logits in the loss's float type (``models.layers.wide``)."""
    return logits.to(wide(logits.dtype))


def _means(nll, correct, valid, dtype, groups):
    """(mean loss, metrics) of the rank's summed loss and correct count
    over its valid labels, totalled over ``groups`` (the module's
    ``softmax_xent`` says how)."""
    groups = [g for g in groups if g is not None]
    if not groups:
        denom = torch.clamp(valid.sum(), min=1)
        loss = torch.sum(nll) / denom
        acc = correct / denom
        return loss, {"loss": loss, "accuracy": acc, "tokens": denom}
    tot = torch.stack([torch.sum(nll), correct.to(dtype),
                       valid.sum().to(dtype)])
    for g in groups:
        tot = collectives.all_reduce(tot, g)
    denom = torch.clamp(tot[2], min=1)
    loss = tot[0] / denom
    return loss, {"loss": loss, "accuracy": tot[1] / denom, "tokens": denom}


def softmax_xent(logits, labels, vocab_size: int, groups=(), vocab=None):
    """logits: (B, S, Vp) (padded vocab); labels: (B, S) int, -1 = masked.

    Returns ``(mean_loss, {"loss", "accuracy", "tokens"})``. The padded
    vocab columns are masked at -1e30, the max taken out of the
    log-sum-exp carries no gradient, and the label logit is picked by a
    gather (the reference contracts a one-hot, which picks the same value
    and sends back the same gradient).

    ``groups``: the process groups of the batch axes whose ranks hold
    other rows (a sharded train step: logits and labels are this rank's
    rows). The rank's summed loss, correct count and token count then go
    into one ``all_reduce`` a group (the gradient passes through it), and
    the means are taken of the totals; without any group the arithmetic
    is the one-device loss's.

    ``vocab`` ``(start, group)``: the logits are this rank's vocab columns
    from ``start`` of every rank's in ``group``: the max is all-reduced
    (MAX, no gradient), the sums of exponentials and the picked logits
    (the label's column on the rank that holds it, 0 elsewhere) in one
    ``all_reduce``, and the argmax is the lowest index holding the global
    max (MIN over the ranks), as ``argmax`` breaks ties."""
    if vocab is not None and vocab[1] is not None:
        start, group = vocab
        pc = vocab_pieces(widened(logits), start, vocab_size)
        lmax = collectives.all_reduce_max(pc.lmax, group)
        sumexp, picked = collectives.all_reduce(
            torch.stack(shard_sums(pc, lmax, labels)), group).unbind(0)
        arg = collectives.all_reduce_min(shard_argmax(pc, lmax), group)
        return finish(lmax, sumexp, picked, arg, labels, groups)
    Vp = logits.shape[-1]
    lf = widened(logits)
    pad_mask = torch.arange(Vp, device=logits.device) >= vocab_size
    lf = torch.where(pad_mask, _MASKED, lf)
    lmax = torch.amax(lf, dim=-1, keepdim=True).detach()
    lse = torch.log(torch.sum(torch.exp(lf - lmax), dim=-1)) + lmax[..., 0]
    valid = labels >= 0
    safe = torch.where(valid, labels, 0).long()
    picked = torch.gather(lf, -1, safe[..., None])[..., 0]
    nll = (lse - picked) * valid.to(lf.dtype)
    correct = torch.sum((torch.argmax(lf, -1) == safe) & valid)
    return _means(nll, correct, valid, lf.dtype, groups)


# --------------------------------------------------------- vocab-parallel
class Pieces(NamedTuple):
    """A rank's vocab shard of the logits: ``lf`` (..., V_loc) widened,
    its padded columns masked; ``start`` its first column; ``lmax``
    (..., 1) its own max (no gradient)."""
    lf: torch.Tensor
    start: int
    lmax: torch.Tensor


def vocab_pieces(lf, start: int, vocab_size: int) -> Pieces:
    """:class:`Pieces` of the widened logit shard ``lf`` from ``start``."""
    cols = torch.arange(start, start + lf.shape[-1], device=lf.device)
    lf = torch.where(cols >= vocab_size, _MASKED, lf)
    return Pieces(lf, start, torch.amax(lf, dim=-1, keepdim=True).detach())


def _labels(labels):
    valid = labels >= 0
    return valid, torch.where(valid, labels, 0).long()


def shard_sums(pc: Pieces, lmax, labels):
    """(the shard's sum of exp(logit - lmax), the label's logit where the
    shard holds it, else 0), each (...,), given the global max ``lmax``."""
    sumexp = torch.sum(torch.exp(pc.lf - lmax), dim=-1)
    _, safe = _labels(labels)
    n = pc.lf.shape[-1]
    loc = safe - pc.start
    inside = (loc >= 0) & (loc < n)
    picked = torch.gather(pc.lf, -1, torch.where(inside, loc, 0)[..., None])
    return sumexp, torch.where(inside, picked[..., 0],
                               torch.zeros((), dtype=pc.lf.dtype,
                                           device=pc.lf.device))


def shard_argmax(pc: Pieces, lmax):
    """The global index of the shard's first column at the global max
    ``lmax``, or an index past any vocab where the shard has none."""
    loc = torch.argmax(pc.lf, dim=-1)
    return torch.where(pc.lmax[..., 0] == lmax[..., 0], loc + pc.start,
                       torch.full_like(loc, _NO_INDEX))


def finish(lmax, sumexp, picked, arg, labels, groups=()):
    """The loss of the joined pieces: the log-sum-exp, the mean over the
    valid labels (totalled over ``groups`` as :func:`softmax_xent`)."""
    lse = torch.log(sumexp) + lmax[..., 0]
    valid, safe = _labels(labels)
    nll = (lse - picked) * valid.to(sumexp.dtype)
    correct = torch.sum((arg == safe) & valid)
    return _means(nll, correct, valid, sumexp.dtype, groups)
