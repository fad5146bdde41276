"""Cross-entropy loss of the training path (the JAX package's
``train/loss.py``)."""
from __future__ import annotations

import torch

from ..launch import collectives
from ..models.layers import wide

__all__ = ["softmax_xent"]


def softmax_xent(logits, labels, vocab_size: int, groups=()):
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
    is the one-device loss's."""
    Vp = logits.shape[-1]
    lf = logits.to(wide(logits.dtype))
    pad_mask = torch.arange(Vp, device=logits.device) >= vocab_size
    lf = torch.where(pad_mask, -1e30, lf)
    lmax = torch.amax(lf, dim=-1, keepdim=True).detach()
    lse = torch.log(torch.sum(torch.exp(lf - lmax), dim=-1)) + lmax[..., 0]
    valid = labels >= 0
    safe = torch.where(valid, labels, 0).long()
    picked = torch.gather(lf, -1, safe[..., None])[..., 0]
    nll = (lse - picked) * valid.to(lf.dtype)
    correct = torch.sum((torch.argmax(lf, -1) == safe) & valid)
    groups = [g for g in groups if g is not None]
    if not groups:
        denom = torch.clamp(valid.sum(), min=1)
        loss = torch.sum(nll) / denom
        acc = correct / denom
        return loss, {"loss": loss, "accuracy": acc, "tokens": denom}
    tot = torch.stack([torch.sum(nll), correct.to(lf.dtype),
                       valid.sum().to(lf.dtype)])
    for g in groups:
        tot = collectives.all_reduce(tot, g)
    denom = torch.clamp(tot[2], min=1)
    loss = tot[0] / denom
    return loss, {"loss": loss, "accuracy": tot[1] / denom, "tokens": denom}
