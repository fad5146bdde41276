"""Serving engine: prefill + greedy decode with KV caches, and the
partitioned batcher (the paper's file-transfer scenario mapped to request
routing).

A batch of R requests is the workload; replica groups are the channels;
the batch completes when the slowest group returns (the join). The
batcher's :class:`UncertaintyAwareBalancer` learns each group's per-request
service rate online and re-partitions every batch, as in the JAX package's
``serve/engine.py``. Its continuous-batching ``WorkflowEngine`` and
``row_pgd_step`` wait for the workflow slice.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..device import resolve_device
from ..sched.balancer import UncertaintyAwareBalancer, integerize
from ..sim.cluster import ClusterSim

__all__ = ["ServeEngine", "ReplicaGroup", "PartitionedBatcher"]


class ServeEngine:
    """Single-replica engine: batched prefill then greedy decode.

    ``model`` is an :class:`LM` holding its weights on ``device`` (the card
    by default; asking for it without one raises).
    """

    def __init__(self, model, cfg: ModelConfig, device="cuda"):
        self.device = resolve_device(device)
        if model.device.type != self.device.type:
            raise ValueError(f"the model lies on {model.device}, the engine "
                             f"serves on {self.device}")
        self.model = model
        self.cfg = cfg

    def generate(self, prompts, max_new: int) -> torch.Tensor:
        """prompts: (B, S) integer tokens (array or tensor). Greedy
        continuation of ``max_new`` tokens, (B, max_new) int64 on the
        engine's device; argmax over the unpadded vocabulary."""
        tokens = torch.as_tensor(prompts, device=self.device).long()
        B, S = tokens.shape
        V = self.cfg.vocab_size
        with torch.inference_mode():
            logits, cache = self.model.prefill(tokens, cache_len=S + max_new)
            tok = torch.argmax(logits[:, -1:, :V], dim=-1)
            outs = [tok]
            for _ in range(max_new - 1):
                logits, cache = self.model.decode_step(cache, tok)
                tok = torch.argmax(logits[:, :, :V], dim=-1)
                outs.append(tok)
        return torch.cat(outs, dim=1)


@dataclass
class ReplicaGroup:
    """A serving channel: a model replica set with its own speed
    distribution. The engine's model holds the weights (the reference keeps
    them beside it in ``params``); groups may share one model."""
    name: str
    engine: Optional[ServeEngine] = None


class PartitionedBatcher:
    """Split request batches across replica groups by the paper's frontier.

    The batch of R requests is the workflow D; replica groups are channels;
    the response is complete when the *slowest* group returns (the join).
    The balancer learns per-group (mu, sigma) per-request service rates
    online and re-partitions every batch. ``device`` is where the balancer
    solves (the card by default).
    """

    def __init__(self, groups: List[ReplicaGroup], lam: float = 0.05,
                 policy: str = "frontier", sim: Optional[ClusterSim] = None,
                 seed: int = 0, device="cuda", num_t: int = 1024,
                 refresh_every: int = 1, family="normal",
                 risk_lam: float = 0.0, adaptive_refresh: bool = False):
        self.groups = groups
        self.balancer = UncertaintyAwareBalancer(
            len(groups), lam=lam, policy=policy, device=device, num_t=num_t,
            refresh_every=refresh_every, family=family, risk_lam=risk_lam,
            adaptive_refresh=adaptive_refresh)
        self.sim = sim or ClusterSim.heterogeneous(len(groups), seed=seed)
        self.last_tick: Optional[dict] = None

    def split(self, num_requests: int) -> np.ndarray:
        return integerize(self.balancer.weights(), num_requests)

    @property
    def selected_family(self) -> str:
        """dist_id of the family the balancer currently solves under."""
        return self.balancer.selected_family.dist_id

    def run_batch(self, prompts: np.ndarray, max_new: int = 8,
                  execute: bool = False) -> Tuple[float, np.ndarray, list]:
        """Route one batch. Returns (join_latency, counts, responses).

        execute=True runs each group's model on its share of the prompts
        (responses are (count, max_new) token arrays, None for an empty
        group); the latency comes from the simulator's channels, as in the
        reference. Per-tick telemetry lands in ``self.last_tick``.
        """
        R = prompts.shape[0]
        counts = self.split(R)
        fam = self.selected_family
        responses = [None] * len(self.groups)
        if execute:
            off = 0
            for gi, c in enumerate(counts):
                if c == 0:
                    continue
                g = self.groups[gi]
                responses[gi] = g.engine.generate(
                    prompts[off:off + c], max_new).cpu().numpy()
                off += c
        join_t, durs = self.sim.run_step(counts.astype(np.float64) / max(R, 1))
        self.balancer.observe(durs, counts.astype(np.float64) / max(R, 1))
        self.last_tick = {
            "family": fam,
            "join_latency": float(join_t),
            "counts": counts,
            "effective_refresh": self.balancer.effective_refresh,
        }
        return join_t, counts, responses

    # ------------------------------------------------------------ persistence
    def state_dict(self) -> dict:
        """Balancer and sim-world snapshot (the reference's keys); replica
        groups are code-side configuration."""
        return {"balancer": self.balancer.state_dict(),
                "sim": self.sim.state_dict()}

    def load_state_dict(self, d: dict, device="cuda"):
        self.balancer = UncertaintyAwareBalancer.from_state_dict(
            d["balancer"], device=device)
        self.sim = ClusterSim.from_state_dict(d["sim"])
        return self

    @classmethod
    def from_state_dict(cls, d: dict, groups: List[ReplicaGroup],
                        device="cuda") -> "PartitionedBatcher":
        return cls(groups, device=device).load_state_dict(d, device=device)
