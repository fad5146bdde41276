"""Cross-entropy loss of the training path (the JAX package's
``train/loss.py``)."""
from __future__ import annotations

import torch

from ..models.layers import wide

__all__ = ["softmax_xent"]


def softmax_xent(logits, labels, vocab_size: int):
    """logits: (B, S, Vp) (padded vocab); labels: (B, S) int, -1 = masked.

    Returns ``(mean_loss, {"loss", "accuracy", "tokens"})``. The padded
    vocab columns are masked at -1e30, the max taken out of the
    log-sum-exp carries no gradient, and the label logit is picked by a
    gather (the reference contracts a one-hot, which picks the same value
    and sends back the same gradient)."""
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
    denom = torch.clamp(valid.sum(), min=1)
    loss = torch.sum(nll) / denom
    acc = torch.sum((torch.argmax(lf, -1) == safe) & valid) / denom
    return loss, {"loss": loss, "accuracy": acc, "tokens": denom}
