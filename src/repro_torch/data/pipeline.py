"""Deterministic synthetic data pipeline (the port's copy of the JAX
package's ``data/pipeline.py``: the same numpy draws, so every batch is
bitwise the reference's, patches and frames included).

Stateless-by-construction: the batch for global step ``t`` is a pure function
of (seed, t), so checkpoint resume and elastic re-sharding need only the step
counter — no cursor files, no skew between restarted workers. Each host slices
its shard of the global batch by (host_id, num_hosts).

The token stream is a mixture of Zipf-distributed ids with short repeated
motifs so tiny models have learnable structure (loss visibly decreases in
examples/train_partitioned.py).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from ..configs.base import ModelConfig

__all__ = ["SyntheticStream", "Batch"]


@dataclass(frozen=True)
class Batch:
    tokens: np.ndarray                 # (B, S) int32 inputs
    labels: np.ndarray                 # (B, S) int32 targets (-1 = masked)
    extra_embeds: Optional[np.ndarray] = None  # (B, Np/F, d) modality stub


class SyntheticStream:
    def __init__(self, cfg: ModelConfig, seq_len: int, global_batch: int,
                 seed: int = 0, host_id: int = 0, num_hosts: int = 1):
        assert global_batch % num_hosts == 0
        self.cfg = cfg
        self.seq = seq_len
        self.gb = global_batch
        self.lb = global_batch // num_hosts
        self.seed = seed
        self.host_id = host_id

    def _rng(self, step: int) -> np.random.Generator:
        return np.random.default_rng(
            np.random.SeedSequence([self.seed, step, self.host_id]))

    def batch_at(self, step: int) -> Batch:
        cfg = self.cfg
        rng = self._rng(step)
        V = cfg.vocab_size
        S = self.seq + 1
        # zipf-ish marginal + motif repetition for learnable structure
        base = rng.zipf(1.3, size=(self.lb, S)).astype(np.int64) % V
        motif_len = 8
        motif = rng.integers(0, V, size=(self.lb, motif_len))
        reps = S // (2 * motif_len)
        for r in range(reps):
            start = 2 * motif_len * r + motif_len
            base[:, start:start + motif_len] = motif
        tokens = base[:, :-1].astype(np.int32)
        labels = base[:, 1:].astype(np.int32)

        extra = None
        if cfg.num_patches:
            extra = rng.standard_normal(
                (self.lb, cfg.num_patches, cfg.d_model)).astype(np.float32)
            pad = np.full((self.lb, cfg.num_patches), -1, np.int32)
            labels = np.concatenate([pad, labels], axis=1)  # no loss on patches
        elif cfg.is_encoder_decoder:
            extra = rng.standard_normal(
                (self.lb, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
        return Batch(tokens=tokens, labels=labels, extra_embeds=extra)
