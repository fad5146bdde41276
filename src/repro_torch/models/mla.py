"""Multi-head Latent Attention (DeepSeek-V2): compressed-KV attention.

Prefill: the normalized latent ``c`` (``kv_lora_rank`` per token) is
up-projected to per-head K (nope part) and V, a rope key of
``qk_rope_head_dim`` is shared by the heads, and attention runs through
``ops.attention`` with q and k of ``nope + rope`` (192 in DeepSeek-V2-Lite)
and v of ``v_head_dim`` (128): on the card the bf16 kernel's (192, 128)
instance. The scale ``(nope + rope) ** -0.5`` is passed explicitly.

Decode caches the latent and the rope key only and scores with the
absorbed matmuls in float32, q_nope taken through ``W_uk`` so the cache is
read directly: plain matrix products, as in the JAX package, where no
Pallas kernel computes them either.

Head counts come from the weights' shapes: under tensor parallelism a rank
holds its heads' columns of ``wq``, ``w_uk`` and ``w_uv`` and the rows of
``wo`` (``models/tp.py``), the latent's ``w_dkv`` and ``kv_norm`` whole,
and returns its partial of the layer's output.
"""
from __future__ import annotations

import torch
from torch import nn

from ..configs.base import ModelConfig
from ..kernels import ops
from .layers import dense_init, dtype_of, param, rms_norm, rmsnorm_init, rope

__all__ = ["mla_init", "mla_apply", "mla_decode", "latent", "heads"]


def mla_init(cfg: ModelConfig, generator: torch.Generator,
             device) -> nn.ParameterDict:
    d, h = cfg.d_model, cfg.num_heads
    nope, rd, vd, lora = (cfg.qk_nope_head_dim, cfg.qk_rope_head_dim,
                          cfg.v_head_dim, cfg.kv_lora_rank)
    dt = dtype_of(cfg.param_dtype)
    p = {
        "wq": dense_init((d, h * (nope + rd)), dt, generator, device),
        # down-projection to the latent and the shared rope key
        "w_dkv": dense_init((d, lora + rd), dt, generator, device),
        "kv_norm": rmsnorm_init(lora, dt, device),
        "w_uk": dense_init((lora, h * nope), dt, generator, device),
        "w_uv": dense_init((lora, h * vd), dt, generator, device),
        "wo": dense_init((h * vd, d), dt, generator, device),
    }
    return nn.ParameterDict({k: param(v) for k, v in p.items()})


def latent(p, x, cfg: ModelConfig, positions):
    """(c (B, S, lora) normalized, k_rope (B, S, 1, rd) shared by the
    heads). The latent is a strided slice of one projection; the norm's
    kernel takes it contiguous."""
    lora = cfg.kv_lora_rank
    ckv = x @ p["w_dkv"]
    c = rms_norm(ckv[..., :lora].contiguous(), p["kv_norm"], cfg.norm_eps)
    k_rope = rope(ckv[..., None, lora:], positions, cfg.rope_theta)
    return c, k_rope


def heads(p, cfg: ModelConfig) -> int:
    """The heads of ``p``'s query columns (a rank's share of them)."""
    return p["wq"].shape[-1] // (cfg.qk_nope_head_dim + cfg.qk_rope_head_dim)


def _queries(p, x, cfg: ModelConfig, positions):
    B, S, _ = x.shape
    h, nope, rd = heads(p, cfg), cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    q = (x @ p["wq"]).reshape(B, S, h, nope + rd)
    return q[..., :nope], rope(q[..., nope:], positions, cfg.rope_theta)


def mla_apply(p, x, cfg: ModelConfig, positions):
    """Full-sequence MLA. x: (B, S, d) -> ((B, S, d), (c (B, S, lora),
    k_rope (B, S, rd)) for the cache)."""
    B, S, _ = x.shape
    h, nope, rd, vd = (heads(p, cfg), cfg.qk_nope_head_dim,
                       cfg.qk_rope_head_dim, cfg.v_head_dim)
    q_nope, q_rope = _queries(p, x, cfg, positions)
    c, k_rope = latent(p, x, cfg, positions)
    k_nope = (c @ p["w_uk"]).reshape(B, S, h, nope)
    v = (c @ p["w_uv"]).reshape(B, S, h, vd)
    q = torch.cat([q_nope, q_rope], -1)
    k = torch.cat([k_nope, k_rope.expand(B, S, h, rd)], -1)
    out = ops.attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        causal=True, sm_scale=(nope + rd) ** -0.5,
    ).transpose(1, 2).reshape(B, S, h * vd)
    return out @ p["wo"], (c, k_rope[:, :, 0, :])


def mla_decode(p, x, cfg: ModelConfig, c_cache, rope_cache, slot_pos,
               pos: int):
    """One-token decode against the latent cache, absorbed, in float32.

    x: (B, 1, d); c_cache: (B, S, lora); rope_cache: (B, S, rd); slot_pos:
    (S,). score_s = (q_nope W_uk^T) . c_s + q_rope . k_rope_s."""
    B = x.shape[0]
    h, nope, rd, vd = (heads(p, cfg), cfg.qk_nope_head_dim,
                       cfg.qk_rope_head_dim, cfg.v_head_dim)
    lora = cfg.kv_lora_rank
    f32 = torch.float32
    q_nope, q_rope = _queries(p, x, cfg,
                              torch.full((B, 1), pos, device=x.device))
    q_nope, q_rope = q_nope[:, 0], q_rope[:, 0]               # (B, h, *)
    w_uk = p["w_uk"].reshape(lora, h, nope).to(f32)
    q_abs = torch.einsum("bhn,lhn->bhl", q_nope.to(f32), w_uk)
    s = (torch.einsum("bhl,bsl->bhs", q_abs, c_cache.to(f32))
         + torch.einsum("bhr,bsr->bhs", q_rope.to(f32), rope_cache.to(f32))
         ) * ((nope + rd) ** -0.5)
    valid = (slot_pos >= 0) & (slot_pos <= pos)
    s = s.masked_fill(~valid[None, None, :], float("-inf"))
    probs = torch.softmax(s, dim=-1)
    ctx = torch.einsum("bhs,bsl->bhl", probs, c_cache.to(f32))
    w_uv = p["w_uv"].reshape(lora, h, vd).to(f32)
    o = torch.einsum("bhl,lhv->bhv", ctx, w_uv)
    return o.reshape(B, 1, h * vd).to(x.dtype) @ p["wo"]
