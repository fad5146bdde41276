"""Top-k mixture of experts on one device: route, dispatch, expert FFNs,
combine.

This is the JAX package's one-shard body (``_local_moe`` with ``tp=1``):
its expert-parallel ``shard_map`` and the FSDP gather of the expert banks
wait for ``torch.distributed`` (ROADMAP §1 item 12b). Every decision matches
the reference's:

* the router stays float32 and the logits are ``x.float() @ router``;
  softmax, top-k, then the k weights renormalized to sum to 1;
* top-k breaks ties toward the lower expert index, as ``jax.lax.top_k``
  does: it takes the first k of a stable descending sort; the k weights'
  sum runs in expert-rank order, as XLA sums a short axis;
* the (token, expert) copies, token-major, are sorted stably by expert;
  each expert keeps its first ``cap = max(int(T k capacity_factor / E),
  1)`` copies and sends the rest to a trash slot;
* dispatch is one gather into the ``(E, cap, d)`` buffer, the experts are
  batched matmuls, and the combine gathers each token's k slots and takes
  their weighted sum. No scatter-add: on the card ``index_add_`` adds with
  atomics in no fixed order, and serving must repeat its bits
  (ROADMAP, Determinism).

The shared experts (DeepSeek) run densely on every token and are added
last.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from ..configs.base import ModelConfig
from .layers import dense_init, dtype_of, param, wide

__all__ = ["moe_init", "moe_apply", "route", "Routing"]


def moe_init(cfg: ModelConfig, generator: torch.Generator,
             device) -> nn.ParameterDict:
    d, e, ff = cfg.d_model, cfg.num_experts, cfg.moe_d_ff or cfg.d_ff
    dt = dtype_of(cfg.param_dtype)
    p = {
        "router": dense_init((d, e), wide(dt), generator, device),
        "moe_up": dense_init((e, d, ff), dt, generator, device),
        "moe_gate": dense_init((e, d, ff), dt, generator, device),
        "moe_down": dense_init((e, ff, d), dt, generator, device),
    }
    if cfg.num_shared_experts:
        sf = ff * cfg.num_shared_experts
        p["shared_up"] = dense_init((d, sf), dt, generator, device)
        p["shared_gate"] = dense_init((d, sf), dt, generator, device)
        p["shared_down"] = dense_init((sf, d), dt, generator, device)
    return nn.ParameterDict({k: param(v) for k, v in p.items()})


class Routing(NamedTuple):
    """One layer's routing decisions over T tokens and E experts.

    ``top_e`` (T, k) experts and ``top_w`` (T, k) renormalized weights,
    token-major; ``order`` (T k,) the stable sort of the copies by expert;
    ``keep`` and ``slot`` (T k,) in that sorted order: a kept copy's slot
    is ``expert * cap + rank within its expert``, a dropped copy's is the
    trash slot ``E * cap``."""
    top_e: torch.Tensor
    top_w: torch.Tensor
    order: torch.Tensor
    keep: torch.Tensor
    slot: torch.Tensor


def capacity(cfg: ModelConfig, T: int) -> int:
    """Copies each expert keeps out of T tokens (the reference's rule)."""
    return max(int(T * cfg.top_k * cfg.capacity_factor / cfg.num_experts), 1)


def route(probs, k: int, cap: int) -> Routing:
    """The decisions of ``probs`` (T, E) float32 router probabilities."""
    T, E = probs.shape
    w_sorted, e_sorted = torch.sort(probs, dim=-1, descending=True,
                                    stable=True)
    top_w, top_e = w_sorted[:, :k], e_sorted[:, :k]
    # the k weights summed in order, as XLA sums a short axis
    top_w = top_w / functools.reduce(torch.add, top_w.unbind(-1))[:, None]
    flat_e = top_e.reshape(-1)
    order = torch.sort(flat_e, stable=True).indices
    se = flat_e[order]
    # rank of each copy within its expert: its place in the sorted list
    # less the place of its expert's first copy
    pos_in_e = (torch.arange(T * k, device=probs.device)
                - torch.searchsorted(se, se))
    keep = pos_in_e < cap
    slot = torch.where(keep, se * cap + pos_in_e, E * cap)
    return Routing(top_e, top_w, order, keep, slot)


def _expert_ffn(x, up, gate, down):
    """x: (E, C, d); weights (E, d, ff) / (E, ff, d) -> (E, C, d)."""
    h = F.silu(torch.bmm(x, gate)) * torch.bmm(x, up)
    return torch.bmm(h, down)


def _local_moe(p, x, cfg: ModelConfig):
    """x: (T, d) -> (T, d) through the routed experts."""
    T, d = x.shape
    E, k = cfg.num_experts, cfg.top_k
    cap = capacity(cfg, T)
    probs = torch.softmax(x.to(p["router"].dtype) @ p["router"], dim=-1)
    r = route(probs, k, cap)
    nslots = E * cap
    flat_t = torch.arange(T, device=x.device).repeat_interleave(k)
    # dispatch: the token of each slot (the trash slot's is never read)
    slot_token = torch.zeros(nslots + 1, dtype=torch.long, device=x.device)
    slot_token[r.slot] = flat_t[r.order]
    slot_valid = torch.zeros(nslots + 1, dtype=torch.bool, device=x.device)
    slot_valid[r.slot] = r.keep
    xbuf = x[slot_token[:-1]] * slot_valid[:-1, None].to(x.dtype)
    h = _expert_ffn(xbuf.reshape(E, cap, d), p["moe_up"], p["moe_gate"],
                    p["moe_down"])
    h_ext = torch.cat([h.reshape(nslots, d), h.new_zeros((1, d))], 0)
    # combine: each token's k slots (dropped copies read the zero row)
    # and their weights, back in token-major order
    slot_of_copy = torch.empty_like(r.slot)
    slot_of_copy[r.order] = r.slot
    w_of_copy = torch.empty_like(r.top_w.reshape(-1))
    w_of_copy[r.order] = torch.where(r.keep, r.top_w.reshape(-1)[r.order],
                                     0.0)
    hk = h_ext[slot_of_copy.reshape(T, k)]                    # (T, k, d)
    y = torch.einsum("tkd,tk->td", hk, w_of_copy.reshape(T, k).to(h.dtype))
    return y.to(x.dtype)


def moe_apply(p, x, cfg: ModelConfig):
    """x: (B, S, d) -> (B, S, d)."""
    B, S, d = x.shape
    xt = x.reshape(B * S, d)
    y = _local_moe(p, xt, cfg)
    if cfg.num_shared_experts:
        u = xt @ p["shared_up"]
        g = xt @ p["shared_gate"]
        y = y + (F.silu(g) * u) @ p["shared_down"]
    return y.reshape(B, S, d)
