"""Top-k mixture of experts: route, dispatch, expert FFNs, combine, with
expert parallelism folded into the tensor-parallel axis (the JAX
package's ``models/moe.py``).

:func:`moe_body` is the reference's per-rank body (``_local_moe``): rank r
of ``tp`` owns experts ``[r E / tp, (r + 1) E / tp)``, routes all its
tokens, sends the copies bound for other ranks' experts to a trash bin and
returns its partial. :func:`moe_apply` is the thin collective wrapper
(the reference's ``shard_map``): it gathers the rank's expert slab over
the FSDP axis, splits the tokens over the batch and FSDP axes where they
divide them (otherwise every rank routes all tokens), sums the partials
over the TP group with one ``all_reduce`` and gathers the token split
back. Capacity is counted over the rank's own tokens, as in the
reference, so a split over "data" changes which copies are dropped.
:func:`moe_ranks` runs every rank's body in one process and sums the
partials in rank order. With ``tp = 1`` and no split the body is the
one-device MoE. Every decision matches the reference's:

* the router stays float32 and the logits are ``x.float() @ router``;
  softmax, top-k, then the k weights renormalized to sum to 1;
* top-k breaks ties toward the lower expert index, as ``jax.lax.top_k``
  does: it takes the first k of a stable descending sort; the k weights'
  sum runs in expert-rank order, as XLA sums a short axis;
* the (token, expert) copies, token-major, are sorted stably by the
  rank's local expert (other ranks' experts are the trash bin ``E /
  tp``); each expert keeps its first ``cap = max(int(T k capacity_factor
  / E), 1)`` copies and sends the rest to a trash slot;
* dispatch is one gather into the ``(E / tp, cap, d)`` buffer, the experts
  are batched matmuls, and the combine gathers each token's k slots and
  takes their weighted sum. No scatter-add: on the card ``index_add_``
  adds with atomics in no fixed order, and serving must repeat its bits
  (ROADMAP, Determinism).

The shared experts (DeepSeek) run densely on every token and are added
last, after the partials are summed. Where the layer hands them over at
their TP shards (``models/tp.py``: the hidden columns divide the TP
size), each rank computes its columns, and an ``all_reduce`` of its
partial joins them (Megatron's f and g).

Under a gradient the collectives are Megatron's pair
(``launch/collectives.py``): the partials' ``all_reduce`` passes the
gradient through, and x and the router enter the rank's experts through
``reduce_grad`` over the TP axis (and over the token split's axis, whose
``narrow`` gives each rank a part of x's gradient), which sums their
gradients there. The expert slab's gather over a token split or a batch
axis reduce-scatters its gradient; the token split gathered back takes the
rank's slice.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from ..configs.base import ModelConfig
from ..launch import collectives, shardings
from .layers import dense_init, dtype_of, param, wide

__all__ = ["moe_init", "moe_apply", "moe_body", "moe_ranks", "route",
           "Routing", "capacity", "shared_width", "shared_ranks"]


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
    token-major; ``order`` (T k,) the stable sort of the copies by the
    rank's local expert; ``keep`` and ``slot`` (T k,) in that sorted
    order: a kept copy's slot is ``local expert * cap + rank within its
    expert``, a dropped copy's is the trash slot ``(E / tp) * cap``."""
    top_e: torch.Tensor
    top_w: torch.Tensor
    order: torch.Tensor
    keep: torch.Tensor
    slot: torch.Tensor


def capacity(cfg: ModelConfig, T: int) -> int:
    """Copies each expert keeps out of T tokens (the reference's rule)."""
    return max(int(T * cfg.top_k * cfg.capacity_factor / cfg.num_experts), 1)


def route(probs, k: int, cap: int, tp: int = 1, rank: int = 0) -> Routing:
    """The decisions of ``probs`` (T, E) float32 router probabilities for
    rank ``rank`` of ``tp``: its experts are ``[rank E / tp, (rank + 1) E
    / tp)``, numbered from 0 in ``slot``; the copies bound elsewhere are
    never kept."""
    T, E = probs.shape
    e_loc = E // tp
    w_sorted, e_sorted = torch.sort(probs, dim=-1, descending=True,
                                    stable=True)
    top_w, top_e = w_sorted[:, :k], e_sorted[:, :k]
    # the k weights summed in order, as XLA sums a short axis
    top_w = top_w / functools.reduce(torch.add, top_w.unbind(-1))[:, None]
    flat_e = top_e.reshape(-1)
    if tp > 1:   # other ranks' experts go to the trash bin e_loc
        flat_e = torch.where(flat_e // e_loc == rank, flat_e - rank * e_loc,
                             e_loc)
    order = torch.sort(flat_e, stable=True).indices
    se = flat_e[order]
    # rank of each copy within its expert: its place in the sorted list
    # less the place of its expert's first copy
    pos_in_e = (torch.arange(T * k, device=probs.device)
                - torch.searchsorted(se, se))
    keep = pos_in_e < cap
    if tp > 1:
        keep &= se < e_loc
    slot = torch.where(keep, se * cap + pos_in_e, e_loc * cap)
    return Routing(top_e, top_w, order, keep, slot)


def _expert_ffn(x, up, gate, down):
    """x: (E, C, d); weights (E, d, ff) / (E, ff, d) -> (E, C, d)."""
    h = F.silu(torch.bmm(x, gate)) * torch.bmm(x, up)
    return torch.bmm(h, down)


def moe_body(x, router, up, gate, down, cfg: ModelConfig, tp: int = 1,
             rank: int = 0):
    """Rank ``rank``'s partial: x (T, d), its local tokens; ``up``,
    ``gate`` (E / tp, d, ff) and ``down`` (E / tp, ff, d), its whole
    expert slab -> (T, d) in x's dtype, the sum over its experts only."""
    T, d = x.shape
    E, k = cfg.num_experts, cfg.top_k
    e_loc = E // tp
    cap = capacity(cfg, T)
    probs = torch.softmax(x.to(router.dtype) @ router, dim=-1)
    r = route(probs, k, cap, tp, rank)
    nslots = e_loc * cap
    flat_t = torch.arange(T, device=x.device).repeat_interleave(k)
    # dispatch: the token of each slot (the trash slot's is never read)
    slot_token = torch.zeros(nslots + 1, dtype=torch.long, device=x.device)
    slot_token[r.slot] = flat_t[r.order]
    slot_valid = torch.zeros(nslots + 1, dtype=torch.bool, device=x.device)
    slot_valid[r.slot] = r.keep
    xbuf = x[slot_token[:-1]] * slot_valid[:-1, None].to(x.dtype)
    h = _expert_ffn(xbuf.reshape(e_loc, cap, d), up, gate, down)
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


def _local_moe(p, x, cfg: ModelConfig):
    """x: (T, d) -> (T, d) through all the routed experts (one rank)."""
    return moe_body(x, p["router"], p["moe_up"], p["moe_gate"],
                    p["moe_down"], cfg)


def shared_width(cfg: ModelConfig) -> int:
    """The shared experts' hidden width (0 without them)."""
    return (cfg.moe_d_ff or cfg.d_ff) * cfg.num_shared_experts


def _shared_part(p, xt):
    """The shared experts on ``p``'s hidden columns (all, or a rank's)."""
    u = xt @ p["shared_up"]
    g = xt @ p["shared_gate"]
    return (F.silu(g) * u) @ p["shared_down"]


def _shared(p, xt, y, cfg: ModelConfig, group=None):
    """y plus the shared experts of xt; ``group``: the TP group when ``p``
    holds a rank's hidden columns of them."""
    if not cfg.num_shared_experts:
        return y
    xs = collectives.reduce_grad(xt, group)
    return y + collectives.all_reduce(_shared_part(p, xs), group)


def shared_ranks(p, xt, cfg: ModelConfig, tp: int):
    """Every TP rank's shared-expert partial of xt in one process, p's
    weights whole: rank r's hidden columns, the partials summed in rank
    order (as an ``all_reduce`` of two ranks sums them)."""
    sf = shared_width(cfg)
    n = sf // tp
    y = None
    for r in range(tp):
        part = _shared_part({"shared_up": p["shared_up"][:, r * n:(r + 1) * n],
                             "shared_gate":
                                 p["shared_gate"][:, r * n:(r + 1) * n],
                             "shared_down":
                                 p["shared_down"][r * n:(r + 1) * n]}, xt)
        y = part if y is None else y + part
    return y


def _token_split(ctx, T: int):
    """(axis, count, rank) of the split of T local tokens over the FSDP
    axis on top of the batch axes (the reference's ``xspec``), or None
    when that axis has size 1, is a batch axis already, or does not
    divide T (every rank then routes all of them)."""
    fa = ctx.fsdp_axis
    n = ctx.size(fa)
    if n == 1 or fa in ctx.batch_axes or T % n:
        return None
    return fa, n, ctx.rank(fa)


def moe_apply(p, x, cfg: ModelConfig, ctx=None, seq=None, length: int = 0):
    """x: (B, S, d) -> (B, S, d). ``p``'s expert banks may be DTensors at
    ``launch.shardings`` placements (the rest are plain tensors); ``ctx``
    (a ``ShardCtx``, None = one device) names the TP and FSDP axes. x
    holds this rank's rows of the batch (its shard over the batch axes).

    Under sequence parallelism ``seq`` is the TP group over which x holds
    this rank's block of a sequence of ``length`` positions (``LM``): the
    layer gathers the whole sequence first, as the reference's
    ``shard_map`` (whose x spec has no TP axis) makes XLA gather it, so
    every rank routes the tokens it routes without ``seq`` and capacity
    counts the same tokens; the partials are reduce-scattered back to the
    rank's block (Megatron-SP's ḡ) in place of the ``all_reduce``, the
    shared experts' apart, as their ``all_reduce`` is apart."""
    whole = x
    if seq is not None:
        x = collectives.all_gather(x, 1, seq, partial_grads=True,
                                   length=length)
    B, S, d = x.shape
    xt = x.reshape(B * S, d)
    tp_axis = ctx.tp_axis if ctx is not None else None
    tp = ctx.size(tp_axis) if ctx is not None else 1
    if cfg.num_experts % tp:
        raise ValueError(f"{cfg.num_experts} experts do not split over "
                         f"{tp} ranks of {tp_axis!r}")
    rank = ctx.rank(tp_axis) if tp > 1 else 0
    split = _token_split(ctx, B * S) if ctx is not None else None
    rows = (*ctx.row_axes, *((split[0],) if split else ())) if ctx else ()
    # the rank's expert slab, gathered over FSDP (dims 1, 1 and 2)
    ep = ((tp_axis,), None, None)
    slab = [shardings.gather(p[k], ep, rows=rows)
            for k in ("moe_up", "moe_gate", "moe_down")]
    tp_group = ctx.group(tp_axis) if tp > 1 else None
    xs, router = xt, p["router"]
    if split is not None:
        axis, n, r = split
        group = ctx.group(axis)
        xs = collectives.reduce_grad(xs, group).narrow(
            0, r * (B * S // n), B * S // n)
        router = collectives.reduce_grad(router, group)
    if seq is None:   # else the gather's adjoint sums x's gradient
        xs = collectives.reduce_grad(xs, tp_group)
    router = collectives.reduce_grad(router, tp_group)
    y = moe_body(xs, router, *slab, cfg, tp, rank)
    if seq is None:
        y = collectives.all_reduce(y, tp_group)
    if split is not None:
        y = shardings.gather_dim(y, 0, ctx.mesh, axis)
    local = (cfg.num_shared_experts
             and p["shared_up"].shape[-1] < shared_width(cfg))
    if seq is None:
        return _shared(p, xt, y, cfg, tp_group if local else None).reshape(
            B, S, d)
    y = collectives.reduce_scatter(y.reshape(B, S, d), 1, seq)
    if not cfg.num_shared_experts:
        return y
    if local:   # each rank's columns of them: their partial's block
        return y + collectives.reduce_scatter(
            _shared_part(p, xt).reshape(B, S, d), 1, seq)
    # computed whole on every rank, from a gather whose adjoint is the
    # rank's block: the rank's block of their output
    xw = collectives.all_gather(whole, 1, seq, partial_grads=False,
                                length=length)
    return y + collectives.split(_shared_part(p, xw.reshape(B * S, d))
                                 .reshape(B, S, d), 1, seq)


def moe_ranks(p, x, cfg: ModelConfig, *, tp: int, data: int = 1,
              shared_tp: bool = False):
    """Every rank's body of a (data, tp) mesh in one process: x (B, S, d)
    with the batch replicated over "data" (``ShardCtx(batch_axes=())``),
    p's expert banks whole. The tokens split over "data" where it divides
    them (as :func:`moe_apply` splits them over FSDP); each split's tp
    partials are summed in rank order, in x's dtype, as an ``all_reduce``
    of two ranks sums them. With ``shared_tp`` the shared experts run by
    rank too (:func:`shared_ranks`), as :func:`moe_apply` runs them when
    the layer hands them over at their TP shards."""
    B, S, d = x.shape
    xt = x.reshape(B * S, d)
    T = B * S
    n = data if T % data == 0 else 1
    E = cfg.num_experts
    e_loc = E // tp
    ys = []
    for dr in range(n):
        xs = xt.narrow(0, dr * (T // n), T // n)
        y = None
        for r in range(tp):
            part = moe_body(xs, p["router"],
                            *(p[k][r * e_loc:(r + 1) * e_loc]
                              for k in ("moe_up", "moe_gate", "moe_down")),
                            cfg, tp, r)
            y = part if y is None else y + part
        ys.append(y)
    y = torch.cat(ys, 0)
    if shared_tp and cfg.num_shared_experts:
        return (y + shared_ranks(p, xt, cfg, tp)).reshape(B, S, d)
    return _shared(p, xt, y, cfg).reshape(B, S, d)
