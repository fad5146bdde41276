"""GQA attention: init, full-sequence apply (prefill), decode step.

Full-sequence attention goes through ``kernels.ops.attention`` (the CUDA
flash-attention kernel on the card, its plain version on the CPU) and the
decode step through ``ops.decode_attention`` (the flash-decode kernel):
the probabilities stay float32 before P.V on both devices, as in the JAX
package's Pallas decode kernel. (The JAX model's XLA decode path rounds
them to the cache dtype first; in float32 the two agree.) The
sequence-sharded decode of the reference waits for ``torch.distributed``.
"""
from __future__ import annotations

import torch
from torch import nn

from ..configs.base import ModelConfig
from ..kernels import ops
from .layers import dense_init, dtype_of, param, rms_norm, rmsnorm_init, rope

__all__ = ["attn_init", "attn_apply", "attn_decode"]


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


def _project_qkv(p, x, cfg: ModelConfig, positions):
    B, S, _ = x.shape
    hq, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = (x @ p["wq"]).reshape(B, S, hq, hd)
    k = (x @ p["wk"]).reshape(B, S, hkv, hd)
    v = (x @ p["wv"]).reshape(B, S, hkv, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    return q, k, v


def attn_apply(p, x, cfg: ModelConfig, positions, *, causal: bool = True,
               return_kv: bool = False):
    """Full-sequence attention. x: (B, S, d); return_kv also returns the
    (B, S, Hkv, hd) K/V for the cache."""
    B, S, _ = x.shape
    q, k, v = _project_qkv(p, x, cfg, positions)
    # the kernel takes (B, H, S, D) views through their strides
    out = ops.attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        causal=causal, window=cfg.window,
    ).transpose(1, 2).reshape(B, S, cfg.num_heads * cfg.head_dim)
    y = out @ p["wo"]
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
    q = (x @ p["wq"]).reshape(B, 1, hq, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
    q = rope(q, torch.full((B, 1), pos, device=x.device),
             cfg.rope_theta)[:, 0]  # (B, Hq, hd)

    valid = (slot_pos >= 0) & (slot_pos <= pos)
    if cfg.window is not None:
        valid &= slot_pos > pos - cfg.window
    y = ops.decode_attention(q.reshape(B, hkv, hq // hkv, hd), k_cache,
                             v_cache, valid).reshape(B, hq, hd)
    return y.reshape(B, 1, hq * hd) @ p["wo"]
