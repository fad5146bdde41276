"""GQA attention: init, full-sequence apply (prefill), decode step.

Full-sequence attention goes through ``kernels.ops.attention`` (the CUDA
flash-attention kernel on the card, its plain version on the CPU) and the
decode step through ``ops.decode_attention`` (the flash-decode kernel):
the probabilities stay float32 before P.V on both devices, as in the JAX
package's Pallas decode kernel. (The JAX model's XLA decode path rounds
them to the cache dtype first; in float32 the two agree.) The
sequence-sharded decode of the reference waits for ``torch.distributed``.

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
from ..kernels import ops
from .layers import dense_init, dtype_of, param, rms_norm, rmsnorm_init, rope

__all__ = ["attn_init", "attn_apply", "attn_decode", "attn_decode_step"]


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


def _queries(p, x, cfg: ModelConfig, positions):
    """(B, S, Hq, hd) queries: projected, normed with qk_norm, roped."""
    B, S, _ = x.shape
    q = (x @ p["wq"]).reshape(B, S, cfg.num_heads, cfg.head_dim)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
    return rope(q, positions, cfg.rope_theta)


def _keys_values(p, x, cfg: ModelConfig, positions):
    """(B, S, Hkv, hd) keys (normed with qk_norm, roped) and values."""
    B, S, _ = x.shape
    hkv, hd = cfg.num_kv_heads, cfg.head_dim
    k = (x @ p["wk"]).reshape(B, S, hkv, hd)
    v = (x @ p["wv"]).reshape(B, S, hkv, hd)
    if cfg.qk_norm:
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    return rope(k, positions, cfg.rope_theta), v


def attn_apply(p, x, cfg: ModelConfig, positions, *, causal: bool = True,
               kv_override: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
               return_kv: bool = False):
    """Full-sequence attention. x: (B, S, d). ``kv_override`` supplies
    cross-attention K/V, already headed, (B, Skv, Hkv, hd); return_kv also
    returns the (B, S, Hkv, hd) K/V for the cache."""
    B, S, _ = x.shape
    q = _queries(p, x, cfg, positions)
    k, v = (_keys_values(p, x, cfg, positions) if kv_override is None
            else kv_override)
    # the kernel takes (B, H, S, D) views through their strides
    out = ops.attention(
        *_promoted(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)),
        causal=causal, window=cfg.window,
    ).transpose(1, 2).reshape(B, S, cfg.num_heads * cfg.head_dim)
    y = out.to(q.dtype) @ p["wo"]
    if return_kv:
        return y, (k, v)
    return y


def attn_decode(p, x, cfg: ModelConfig, k_cache, v_cache, slot_pos,
                pos: int):
    """One-token decode. x: (B, 1, d); caches: (B, Hkv, S, hd) with the new
    token already inserted; slot_pos: (S,) absolute position per slot (< 0 =
    empty); pos: the current position. Returns (B, 1, d)."""
    B = x.shape[0]
    hq, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = _queries(p, x, cfg, torch.full((B, 1), pos, device=x.device))

    valid = (slot_pos >= 0) & (slot_pos <= pos)
    if cfg.window is not None:
        valid &= slot_pos > pos - cfg.window
    y = ops.decode_attention(
        *_promoted(q.reshape(B, hkv, hq // hkv, hd), k_cache, v_cache), valid)
    return y.reshape(B, 1, hq * hd).to(q.dtype) @ p["wo"]


def attn_decode_step(p, x, cfg: ModelConfig, c: dict, slot_pos, pos: int,
                     slot: int):
    """Write the token's K/V (rope at ``pos``) into the cache ``c``
    (``{"k", "v"}``, (B, Hkv, S, hd)) at ``slot``, then attend over it.
    x: (B, 1, d) -> (B, 1, d)."""
    k_new, v_new = _keys_values(
        p, x, cfg, torch.full((x.shape[0], 1), pos, device=x.device))
    c["k"][:, :, slot] = k_new[:, 0].to(c["k"].dtype)
    c["v"][:, :, slot] = v_new[:, 0].to(c["v"].dtype)
    return attn_decode(p, x, cfg, c["k"], c["v"], slot_pos, pos)
