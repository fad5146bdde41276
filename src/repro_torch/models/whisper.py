"""Whisper-style encoder-decoder backbone (the conv/mel frontend is a stub).

The caller passes precomputed frame embeddings (B, encoder_seq, d_model),
as in the JAX package. A bidirectional encoder, then a causal decoder with
cross-attention in every layer; sinusoidal positions in both stacks (the
reference's simplification of Whisper's learned decoder table).

The encoder runs in the promoted dtype of the frames and the weights, as
the reference's ``frames.astype(act) + sinusoid(F, d, frames.dtype)`` does:
float32 frames in a bf16 model make a float32 encoder, its weights
promoted to float32, and float32 cross-attention K/V that the bf16
decoder's queries are promoted to (``models/attention.py``).

Serving state is a dict: per-layer ``{"k", "v", "xk", "xv"}`` (self-
attention caches (B, Hkv, S, hd) and the cross-attention K/V over the
frames, built once at prefill), ``slot_pos`` (S,) int32 and ``pos`` a
Python int; :meth:`EncDec.decode_step` updates the cache in place.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..configs.base import ModelConfig
from ..device import resolve_device
from . import attention as attn
from .layers import (dtype_of, embed_init, embed_lookup, lm_head, mlp_apply,
                     mlp_init, param, rms_norm, rmsnorm_init)
from .transformer import _place_seq, _prefill_slot_pos

__all__ = ["EncDec", "sinusoid"]


def sinusoid(S: int, d: int, dtype, device=None, start: int = 0):
    """Rows ``start .. start + S - 1`` of the (positions, d) sinusoid
    table: sin of the first d / 2 angles, then cos, cast to ``dtype``."""
    f32 = torch.float32
    pos = torch.arange(start, start + S, device=device).to(f32)[:, None]
    dim = torch.arange(d // 2, device=device).to(f32)[None, :]
    ang = pos / torch.pow(10000.0, 2 * dim / d)
    return torch.cat([torch.sin(ang), torch.cos(ang)], -1).to(dtype)


class EncBlock(nn.Module):
    """An encoder layer: pre-norm bidirectional attention and MLP."""

    def __init__(self, cfg: ModelConfig, generator, device):
        super().__init__()
        dt = dtype_of(cfg.param_dtype)
        self.ln1 = param(rmsnorm_init(cfg.d_model, dt, device))
        self.mixer = attn.attn_init(cfg, generator, device)
        self.ln2 = param(rmsnorm_init(cfg.d_model, dt, device))
        self.mlp = mlp_init(cfg, generator, device)


class DecBlock(nn.Module):
    """A decoder layer: pre-norm causal self-attention (``self``, the
    reference's leaf name), cross-attention over the frames and MLP."""

    def __init__(self, cfg: ModelConfig, generator, device):
        super().__init__()
        dt = dtype_of(cfg.param_dtype)
        self.ln1 = param(rmsnorm_init(cfg.d_model, dt, device))
        self.self = attn.attn_init(cfg, generator, device)
        self.ln_x = param(rmsnorm_init(cfg.d_model, dt, device))
        self.cross = attn.attn_init(cfg, generator, device)
        self.ln2 = param(rmsnorm_init(cfg.d_model, dt, device))
        self.mlp = mlp_init(cfg, generator, device)


def _promote(p, dtype):
    """The parameters of ``p`` in ``dtype`` where narrower (as jnp
    promotes a matmul's operands); ``p`` itself when none is."""
    if all(v.dtype == dtype for v in p.values()):
        return p
    return {k: v.to(dtype) for k, v in p.items()}


class EncDec(nn.Module):
    """Encoder-decoder LM (the whisper-large-v3 backbone), weights drawn
    from a ``torch.Generator`` seeded with ``seed`` on ``device``."""

    def __init__(self, cfg: ModelConfig, device="cuda", seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        dt = dtype_of(cfg.param_dtype)
        self.cfg = cfg
        self.embed = embed_init(cfg, gen, dev)
        self.enc_blocks = nn.ModuleList(
            EncBlock(cfg, gen, dev) for _ in range(cfg.num_encoder_layers))
        self.dec_blocks = nn.ModuleList(
            DecBlock(cfg, gen, dev) for _ in range(cfg.num_layers))
        self.enc_norm = param(rmsnorm_init(cfg.d_model, dt, dev))
        self.final_norm = param(rmsnorm_init(cfg.d_model, dt, dev))

    @property
    def device(self) -> torch.device:
        return self.final_norm.device

    def _positions(self, B: int, S: int):
        return torch.arange(S, device=self.device).expand(B, S)

    # ------------------------------------------------------------- encode
    def encode(self, frames):
        """frames: (B, F, d) precomputed embeddings -> (B, F, d)."""
        cfg = self.cfg
        B, F, d = frames.shape
        x = (frames.to(dtype_of(cfg.activation_dtype))
             + sinusoid(F, d, frames.dtype, frames.device))
        dt = torch.promote_types(x.dtype, dtype_of(cfg.param_dtype))
        x = x.to(dt)
        positions = self._positions(B, F)
        for blk in self.enc_blocks:
            mixer, mlp = _promote(blk.mixer, dt), _promote(blk.mlp, dt)
            h = rms_norm(x, blk.ln1.to(dt), cfg.norm_eps)
            x = x + attn.attn_apply(mixer, h, cfg, positions, causal=False)
            h = rms_norm(x, blk.ln2.to(dt), cfg.norm_eps)
            x = x + mlp_apply(mlp, h, cfg.mlp_act)
        return rms_norm(x, self.enc_norm.to(dt), cfg.norm_eps)

    def _cross_kv(self, p_cross, enc_out):
        """The cross-attention K/V of the frames, (B, F, Hkv, hd) each."""
        cfg = self.cfg
        B, F, _ = enc_out.shape
        hkv, hd = cfg.num_kv_heads, cfg.head_dim
        k = (enc_out @ p_cross["wk"].to(enc_out.dtype)).reshape(B, F, hkv, hd)
        v = (enc_out @ p_cross["wv"].to(enc_out.dtype)).reshape(B, F, hkv, hd)
        return k, v

    def _dec_block(self, blk: DecBlock, x, positions, cross_kv,
                   collect: bool = False):
        cfg = self.cfg
        h = rms_norm(x, blk.ln1, cfg.norm_eps)
        entry = None
        if collect:
            m, (k, v) = attn.attn_apply(blk.self, h, cfg, positions,
                                        return_kv=True)
            entry = {"k": k.transpose(1, 2), "v": v.transpose(1, 2)}
        else:
            m = attn.attn_apply(blk.self, h, cfg, positions)
        x = x + m
        h = rms_norm(x, blk.ln_x, cfg.norm_eps)
        # bidirectional over the frames, no rope on the cross K/V
        x = x + attn.attn_apply(blk.cross, h, cfg, positions, causal=False,
                                kv_override=cross_kv)
        h = rms_norm(x, blk.ln2, cfg.norm_eps)
        return x + mlp_apply(blk.mlp, h, cfg.mlp_act), entry

    def _decoder_input(self, tokens):
        x = embed_lookup(self.embed, tokens, self.cfg)
        return x + sinusoid(tokens.shape[1], self.cfg.d_model, x.dtype,
                            x.device)

    def forward(self, tokens, frames):
        return self.apply(tokens, frames)

    def apply(self, tokens, frames):
        """Teacher-forced decode over the whole target: tokens (B, S),
        frames (B, F, d) -> logits (B, S, padded_vocab)."""
        cfg = self.cfg
        enc_out = self.encode(frames)
        x = self._decoder_input(tokens)
        positions = self._positions(*tokens.shape)
        for blk in self.dec_blocks:
            x, _ = self._dec_block(blk, x, positions,
                                   self._cross_kv(blk.cross, enc_out))
        x = rms_norm(x, self.final_norm, cfg.norm_eps)
        return lm_head(self.embed, x, cfg)

    # ------------------------------------------------------------- serving
    def cache_init(self, batch: int, cache_len: int, enc_frames: int,
                   dtype=None) -> dict:
        cfg = self.cfg
        dt = dtype or dtype_of(cfg.activation_dtype)
        kv = (batch, cfg.num_kv_heads, cache_len, cfg.head_dim)
        xkv = (batch, cfg.num_kv_heads, enc_frames, cfg.head_dim)

        def zeros(shape):
            return torch.zeros(shape, dtype=dt, device=self.device)

        return {"layers": [{"k": zeros(kv), "v": zeros(kv), "xk": zeros(xkv),
                            "xv": zeros(xkv)} for _ in self.dec_blocks],
                "slot_pos": torch.full((cache_len,), -1, dtype=torch.int32,
                                       device=self.device),
                "pos": 0}

    def prefill(self, tokens, frames, cache_len: Optional[int] = None):
        """Encode, then a teacher-forced pass that builds the self- and
        cross-attention caches."""
        cfg = self.cfg
        enc_out = self.encode(frames)
        B, S = tokens.shape
        cache_len = cache_len or S
        x = self._decoder_input(tokens)
        positions = self._positions(B, S)
        layers = []
        for blk in self.dec_blocks:
            ck, cv = self._cross_kv(blk.cross, enc_out)
            x, entry = self._dec_block(blk, x, positions, (ck, cv),
                                       collect=True)
            layers.append({
                **{k: _place_seq(v, cache_len, 2) for k, v in entry.items()},
                "xk": ck.transpose(1, 2).contiguous(),
                "xv": cv.transpose(1, 2).contiguous()})
        x = rms_norm(x, self.final_norm, cfg.norm_eps)
        cache = {"layers": layers,
                 "slot_pos": _prefill_slot_pos(S, cache_len, self.device),
                 "pos": S}
        return lm_head(self.embed, x, cfg), cache

    def decode_step(self, cache: dict, tokens):
        """tokens: (B, 1). The cross K/V come from the cache. Returns
        (logits (B, 1, V), cache), the cache updated in place."""
        cfg = self.cfg
        pos = cache["pos"]
        cache_len = cache["slot_pos"].shape[0]
        slot = min(pos, cache_len - 1)
        slot_pos = cache["slot_pos"]
        slot_pos[slot] = pos
        x = embed_lookup(self.embed, tokens, cfg)
        # the position's sinusoid row, clamped to the cache as in the
        # reference
        x = x + sinusoid(1, cfg.d_model, x.dtype, x.device, start=slot)
        # every frame is valid: slot position 0 is <= any pos
        frames = cache["layers"][0]["xk"].shape[2]
        xvalid = torch.zeros(frames, dtype=torch.int32, device=x.device)
        for blk, c in zip(self.dec_blocks, cache["layers"]):
            h = rms_norm(x, blk.ln1, cfg.norm_eps)
            x = x + attn.attn_decode_step(blk.self, h, cfg, c, slot_pos, pos,
                                          slot)
            h = rms_norm(x, blk.ln_x, cfg.norm_eps)
            x = x + attn.attn_decode(blk.cross, h, cfg, c["xk"], c["xv"],
                                     xvalid, pos)
            h = rms_norm(x, blk.ln2, cfg.norm_eps)
            x = x + mlp_apply(blk.mlp, h, cfg.mlp_act)
        x = rms_norm(x, self.final_norm, cfg.norm_eps)
        cache["pos"] = pos + 1
        return lm_head(self.embed, x, cfg), cache
