"""InternVL2-style VLM wrapper: the LM backbone behind a stub ViT frontend.

The caller passes precomputed patch embeddings (B, num_patches, d_model),
as in the JAX package; they are prepended to the tokens' embeddings and
the backbone is the causal :class:`LM`. Decode is the LM's: the patches
take part only through the prefilled cache.
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

    def __init__(self, cfg: ModelConfig, device="cuda", seed: int = 0):
        super().__init__()
        if cfg.num_patches <= 0:
            raise ValueError(f"{cfg.name} has no patches: serve it as an LM")
        self.cfg = cfg
        self.lm = LM(cfg, device=device, seed=seed)

    @property
    def device(self) -> torch.device:
        return self.lm.device

    def forward(self, tokens, patch_embeds):
        return self.apply(tokens, patch_embeds)

    def apply(self, tokens, patch_embeds):
        """tokens: (B, S - num_patches); patch_embeds: (B, num_patches, d)."""
        return self.lm.apply(tokens, extra_embeds=patch_embeds)

    def prefill(self, tokens, patch_embeds, cache_len: Optional[int] = None):
        return self.lm.prefill(tokens, cache_len=cache_len,
                               extra_embeds=patch_embeds)

    def decode_step(self, cache: dict, tokens):
        return self.lm.decode_step(cache, tokens)

    def cache_init(self, batch: int, cache_len: int, dtype=None) -> dict:
        return self.lm.cache_init(batch, cache_len, dtype)
