"""InternVL2-style VLM wrapper: the LM backbone behind a stub ViT frontend.

The caller passes precomputed patch embeddings (B, num_patches, d_model),
as in the JAX package; they are prepended to the tokens' embeddings and
the backbone is the causal :class:`LM`, under the LM's sharding context:
each rank takes its rows of the patches, and they join its heads' and
columns' computation as the tokens' embeddings do (under sequence
parallelism the patches are prepended, then the joint sequence split).
Decode is the LM's:
the patches take part only through the prefilled cache.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..configs.base import ModelConfig
from .transformer import LM

__all__ = ["VLM"]


class VLM(nn.Module):
    """The backbone is ``self.lm`` (state-dict names ``lm.*``)."""

    def __init__(self, cfg: ModelConfig, device="cuda", seed: int = 0,
                 ctx=None):
        super().__init__()
        if cfg.num_patches <= 0:
            raise ValueError(f"{cfg.name} has no patches: serve it as an LM")
        self.cfg = cfg
        self.lm = LM(cfg, device=device, seed=seed, ctx=ctx)

    @property
    def device(self) -> torch.device:
        return self.lm.device

    def forward(self, tokens, patch_embeds, rows=None):
        return self.apply(tokens, patch_embeds, rows=rows)

    def apply(self, tokens, patch_embeds, *, rows=None):
        """tokens: (B, S - num_patches); patch_embeds: (B, num_patches, d);
        ``rows`` as in ``LM.apply``."""
        return self.lm.apply(tokens, extra_embeds=patch_embeds, rows=rows)

    def rows(self, t):
        """This rank's rows of a global batch (``LM.rows``)."""
        return self.lm.rows(t)

    def logits_shard(self):
        """The rank's vocab columns of a differentiated forward's logits
        (``LM.logits_shard``)."""
        return self.lm.logits_shard()

    def prefill(self, tokens, patch_embeds, cache_len: Optional[int] = None):
        return self.lm.prefill(tokens, cache_len=cache_len,
                               extra_embeds=patch_embeds)

    def decode_step(self, cache: dict, tokens):
        return self.lm.decode_step(cache, tokens)

    def cache_init(self, batch: int, cache_len: int, dtype=None) -> dict:
        return self.lm.cache_init(batch, cache_len, dtype)
