"""GQA attention: init, full-sequence apply (prefill), decode step.

Full-sequence attention goes through ``kernels.ops.attention`` (the CUDA
flash-attention kernel on the card, its plain version on the CPU) and the
decode step through ``ops.decode_attention`` (the flash-decode kernel):
the probabilities stay float32 before P.V on both devices, as in the JAX
package's Pallas decode kernel. (The JAX model's XLA decode path rounds
them to the cache dtype first; in float32 the two agree.)

The sequence-sharded decode (the reference's ``sharded_lse_decode``):
each rank holds a shard of the cache's slots, computes its float32
partial (m, l, acc) on the flash-decode kernel's partial mode
(``ops.decode_attention_partial``), and the shards combine with an
``all_reduce`` MAX of m and one SUM of l and acc scaled to that max, with
the reference's guards: a shard with no valid slot counts m = 0 in the
max (the reference's m_safe of its -inf; the kernel's -1e30 is mapped to
it), a shard with l = 0 weighs 0, and o = acc / max(l, 1e-30). So where
every valid logit is far below 0 and some shard is empty, the output is
the reference's, not the unsharded decode's. :func:`lse_combine` merges
partials in one process, in rank order, bit for bit what an
``all_reduce`` of two ranks gives.

Head counts come from the weights' shapes, not from the config: under
tensor parallelism a rank holds its query heads' columns of ``wq`` and the
rows of ``wo`` (``models/tp.py``), and the output is the rank's partial
of the layer's output, which the caller sums over the ranks. Where the
rank's query heads read fewer KV heads than ``wk`` gives (``kv_heads``:
the TP size a multiple of the KV heads), K and V are computed for every
head (the cache holds them all) and the rank attends over its slice.

Cross-attention (Whisper's decoder) passes the encoder's K/V as
``kv_override``: the queries keep their rope and the K/V get none, as in
the reference. Where the K/V are wider than the queries (float32 frames
in a bf16 model, which the reference promotes to float32), the queries are
promoted to their dtype and the output cast back to the queries', which is
the reference's arithmetic: it attends in float32 and returns q's dtype.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from ..configs.base import ModelConfig
from ..kernels import ops, ref
from .layers import dense_init, dtype_of, param, rms_norm, rmsnorm_init, rope

__all__ = ["attn_init", "attn_apply", "attn_decode", "attn_decode_step",
           "heads",
           "sharded_lse_decode", "lse_combine", "lse_ranks", "seq_shards"]



def attn_init(cfg: ModelConfig, generator: torch.Generator,
              device) -> nn.ParameterDict:
    d, hq, hkv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    dt = dtype_of(cfg.param_dtype)
    p = {
        "wq": dense_init((d, hq * hd), dt, generator, device),
        "wk": dense_init((d, hkv * hd), dt, generator, device),
        "wv": dense_init((d, hkv * hd), dt, generator, device),
        "wo": dense_init((hq * hd, d), dt, generator, device),
    }
    if cfg.qk_norm:
        p["q_norm"] = rmsnorm_init(hd, dt, device)
        p["k_norm"] = rmsnorm_init(hd, dt, device)
    return nn.ParameterDict({k: param(v) for k, v in p.items()})


def _promoted(q, k, v):
    """q, k and v in their promoted dtype."""
    if q.dtype == k.dtype:
        return q, k, v
    dt = torch.promote_types(q.dtype, k.dtype)
    return q.to(dt), k.to(dt), v.to(dt)


def heads(w, cfg: ModelConfig) -> int:
    """The heads of a projection's columns (a rank's share of them)."""
    return w.shape[-1] // cfg.head_dim


def _queries(p, x, cfg: ModelConfig, positions):
    """(B, S, Hq, hd) queries: projected, normed with qk_norm, roped."""
    B, S, _ = x.shape
    q = (x @ p["wq"]).reshape(B, S, heads(p["wq"], cfg), cfg.head_dim)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
    return rope(q, positions, cfg.rope_theta)


def _keys_values(p, x, cfg: ModelConfig, positions):
    """(B, S, Hkv, hd) keys (normed with qk_norm, roped) and values."""
    B, S, _ = x.shape
    hkv, hd = heads(p["wk"], cfg), cfg.head_dim
    k = (x @ p["wk"]).reshape(B, S, hkv, hd)
    v = (x @ p["wv"]).reshape(B, S, hkv, hd)
    if cfg.qk_norm:
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    return rope(k, positions, cfg.rope_theta), v


def attn_apply(p, x, cfg: ModelConfig, positions, *, causal: bool = True,
               kv_override: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
               return_kv: bool = False, kv_heads: Optional[slice] = None):
    """Full-sequence attention. x: (B, S, d). ``kv_override`` supplies
    cross-attention K/V, already headed, (B, Skv, Hkv, hd); return_kv also
    returns the (B, S, Hkv, hd) K/V for the cache; ``kv_heads``: the KV
    heads the queries read, of those K/V (None: all)."""
    B, S, _ = x.shape
    q = _queries(p, x, cfg, positions)
    k, v = (_keys_values(p, x, cfg, positions) if kv_override is None
            else kv_override)
    ka, va = (k, v) if kv_heads is None else (k[:, :, kv_heads],
                                              v[:, :, kv_heads])
    # the kernel takes (B, H, S, D) views through their strides
    out = ops.attention(
        *_promoted(q.transpose(1, 2), ka.transpose(1, 2),
                   va.transpose(1, 2)),
        causal=causal, window=cfg.window,
    ).transpose(1, 2).reshape(B, S, q.shape[2] * cfg.head_dim)
    y = out.to(q.dtype) @ p["wo"]
    if return_kv:
        return y, (k, v)
    return y


def _m_safe(m):
    """The reference's m_safe: a shard without a valid slot (the kernel's
    -1e30) counts 0."""
    return torch.where(m <= ref.NEG_INF / 2, torch.zeros_like(m), m)


def _scaled(m_safe, l, acc, g):
    """(l, acc) of a shard scaled to the global max g, in one buffer
    (..., 1 + D): weight 0 for a shard with l = 0."""
    scale = torch.where(l > 0, torch.exp(m_safe - g), torch.zeros_like(l))
    return torch.cat([l * scale, acc * scale], dim=-1)


def _normalized(buf, dtype):
    return (buf[..., 1:] / torch.clamp(buf[..., :1], min=1e-30)).to(dtype)


def lse_combine(parts, dtype):
    """The decode output (B, Hkv, G, D) in ``dtype`` of every shard's
    partial ``(m, l, acc)``, in rank order: the max over the shards, then
    the scaled sums, each term added in rank order."""
    ms = [_m_safe(m) for m, _, _ in parts]
    g = ms[0]
    for m in ms[1:]:
        g = torch.maximum(g, m)
    buf = None
    for m, (_, l, acc) in zip(ms, parts):
        term = _scaled(m, l, acc, g)
        buf = term if buf is None else buf + term
    return _normalized(buf, dtype)


def sharded_lse_decode(q, k_cache, v_cache, valid, group_size: int, *,
                       group=None):
    """The decode over a sequence-sharded cache. q: (B, Hq, hd); caches:
    this rank's shard (B, Hkv, S_loc, hd); valid: its (S_loc,) mask;
    ``group``: the process group of the shards (None: one shard) ->
    (B, Hq, hd) in q's dtype. The rank's partial runs on the flash-decode
    kernel; two ``all_reduce`` calls combine the shards."""
    B, Hq, hd = q.shape
    Hkv = k_cache.shape[1]
    m, l, acc = ops.decode_attention_partial(
        q.reshape(B, Hkv, group_size, hd), k_cache, v_cache, valid)
    m_safe = _m_safe(m)
    g = m_safe
    if group is not None:
        import torch.distributed as dist
        g = m_safe.clone()
        dist.all_reduce(g, op=dist.ReduceOp.MAX, group=group)
    buf = _scaled(m_safe, l, acc, g)
    if group is not None:
        dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
    return _normalized(buf, q.dtype).reshape(B, Hq, hd)


def seq_shards(k_cache, v_cache, valid, shards: int):
    """The whole cache (B, Hkv, S, D) and its (S,) mask cut into
    ``shards`` equal blocks of slots, each a contiguous (k, v, valid):
    what each rank of a sequence-sharded decode holds."""
    S = k_cache.shape[2]
    if S % shards:
        raise ValueError(f"{S} slots do not split into {shards} shards")
    n = S // shards
    return [(k_cache[:, :, r * n:(r + 1) * n].contiguous(),
             v_cache[:, :, r * n:(r + 1) * n].contiguous(),
             valid[r * n:(r + 1) * n].contiguous()) for r in range(shards)]


def lse_ranks(q, shards):
    """Every rank's body of the sequence-sharded decode in one process:
    q (B, Hkv, G, D); ``shards`` each rank's (k, v, valid)
    (:func:`seq_shards`), in rank order. Each shard's partial runs on the
    kernel, and :func:`lse_combine` merges them in rank order."""
    return lse_combine([ops.decode_attention_partial(q, k, v, valid)
                        for k, v, valid in shards], q.dtype)


def attn_decode(p, x, cfg: ModelConfig, k_cache, v_cache, slot_pos,
                pos: int, *, seq_sharded: bool = False, seq_group=None,
                kv_heads: Optional[slice] = None):
    """One-token decode. x: (B, 1, d); caches: (B, Hkv, S, hd) with the new
    token already inserted; slot_pos: (S,) absolute position per slot (< 0 =
    empty); pos: the current position. Returns (B, 1, d). With
    ``seq_sharded`` the caches and slot_pos are this rank's sequence shard
    and :func:`sharded_lse_decode` combines the shards over
    ``seq_group``; ``kv_heads``: the cache's heads the queries read (None:
    all)."""
    B = x.shape[0]
    q = _queries(p, x, cfg, torch.full((B, 1), pos, device=x.device))
    if kv_heads is not None:   # the kernel takes contiguous caches
        k_cache = k_cache[:, kv_heads].contiguous()
        v_cache = v_cache[:, kv_heads].contiguous()
    hq, hkv, hd = q.shape[2], k_cache.shape[1], cfg.head_dim

    valid = (slot_pos >= 0) & (slot_pos <= pos)
    if cfg.window is not None:
        valid &= slot_pos > pos - cfg.window
    qg, kc, vc = _promoted(q.reshape(B, hkv, hq // hkv, hd), k_cache,
                           v_cache)
    if seq_sharded:
        y = sharded_lse_decode(qg.reshape(B, hq, hd), kc, vc, valid,
                               hq // hkv, group=seq_group)
    else:
        y = ops.decode_attention(qg, kc, vc, valid)
    return y.reshape(B, 1, hq * hd).to(q.dtype) @ p["wo"]


def attn_decode_step(p, x, cfg: ModelConfig, c: dict, slot_pos, pos: int,
                     slot: Optional[int], *, seq_sharded: bool = False,
                     seq_group=None, kv_heads: Optional[slice] = None):
    """Write the token's K/V (rope at ``pos``) into the cache ``c``
    (``{"k", "v"}``, (B, Hkv, S, hd)) at ``slot`` (None: another sequence
    shard holds it), then attend over it (:func:`attn_decode`, with
    ``kv_heads``). x: (B, 1, d) -> (B, 1, d)."""
    k_new, v_new = _keys_values(
        p, x, cfg, torch.full((x.shape[0], 1), pos, device=x.device))
    if slot is not None:
        c["k"][:, :, slot] = k_new[:, 0].to(c["k"].dtype)
        c["v"][:, :, slot] = v_new[:, 0].to(c["v"].dtype)
    return attn_decode(p, x, cfg, c["k"], c["v"], slot_pos, pos,
                       seq_sharded=seq_sharded, seq_group=seq_group,
                       kv_heads=kv_heads)
