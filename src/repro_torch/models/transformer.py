"""Config-driven decoder LM: dense attention and Mamba2 (SSD) stacks.

The layer stack is ``num_repeats`` copies of ``cfg.pattern``. The JAX
package stacks each pattern position's weights over the repeats and runs
``lax.scan``; here each layer is its own submodule (``layers[r * P + i]``
holds repeat r of pattern position i) and the stack is a Python loop.

This slice carries ``LayerSpec("attn", "dense")``, ``LayerSpec("mamba",
"none")`` and ``"none"`` MLPs. The mla mixer and the moe MLP raise
``NotImplementedError`` naming the ROADMAP item that ports them; the
reference's ``ShardCtx`` sharding waits for ``torch.distributed``.

Serving state is a dict: per-layer ``{"k", "v"}`` caches (B, Hkv, S, hd)
for attention layers and ``{"ssm", "conv"}`` states ((B, H, P, N) float32,
(B, width - 1, ssm_inner)) for mamba layers, ``slot_pos`` (S,) int32 on
the device and ``pos`` a Python int. Unlike the reference,
:meth:`LM.decode_step` writes the new token's K/V and slot into the cache
and advances the mamba states in place (no copy of the cache per step) and
returns the same dict.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..configs.base import LayerSpec, ModelConfig
from ..device import resolve_device
from . import attention as attn
from . import ssm
from .layers import (dtype_of, embed_init, embed_lookup, lm_head, mlp_apply,
                     mlp_init, param, rms_norm, rmsnorm_init, rope)

__all__ = ["LM", "Block"]

_WAITS = {
    "mla": "the MLA mixer waits for its slice (ROADMAP §1 item 11)",
    "moe": "the MoE MLP waits for its slice (ROADMAP §1 item 11)",
}


def _place_seq(entry, cache_len: int, seq_axis: int):
    """Place a length-S prefill tensor into a cache_len ring buffer along
    ``seq_axis`` (keeps the last cache_len positions, ring-rotated so that
    position p sits at slot p % cache_len); the result is contiguous."""
    S = entry.shape[seq_axis]
    if S == cache_len:
        return entry.contiguous()
    if S < cache_len:
        pad_shape = list(entry.shape)
        pad_shape[seq_axis] = cache_len - S
        return torch.cat([entry, entry.new_zeros(pad_shape)], seq_axis)
    tail = entry.narrow(seq_axis, S - cache_len, cache_len)
    return torch.roll(tail, shifts=(S - cache_len) % cache_len,
                      dims=seq_axis).contiguous()


def _prefill_slot_pos(S: int, cache_len: int, device):
    if S >= cache_len:
        idx = torch.arange(S - cache_len, S, device=device)
        slot_pos = torch.zeros((cache_len,), dtype=torch.int32, device=device)
        slot_pos[idx % cache_len] = idx.to(torch.int32)
        return slot_pos
    ar = torch.arange(cache_len, device=device)
    return torch.where(ar < S, ar, -1).to(torch.int32)


class Block(nn.Module):
    """One layer: a pre-norm mixer (attention or Mamba2) and, for a dense
    MLP, a pre-norm MLP."""

    def __init__(self, cfg: ModelConfig, spec: LayerSpec,
                 generator: torch.Generator, device):
        super().__init__()
        for kind in (spec.mixer, spec.mlp):
            if kind in _WAITS:
                raise NotImplementedError(_WAITS[kind])
        if (spec.mixer not in ("attn", "mamba")
                or spec.mlp not in ("dense", "none")):
            raise ValueError(f"unknown layer {spec}")
        self.spec = spec
        dt = dtype_of(cfg.param_dtype)
        self.ln1 = param(rmsnorm_init(cfg.d_model, dt, device))
        if spec.mixer == "attn":
            self.mixer = attn.attn_init(cfg, generator, device)
        else:
            self.mixer = ssm.mamba_init(cfg, generator, device)
        if spec.mlp == "dense":
            self.ln2 = param(rmsnorm_init(cfg.d_model, dt, device))
            self.mlp = mlp_init(cfg, generator, device)


class LM(nn.Module):
    """Decoder-only LM with its weights, on one device.

    ``seed`` seeds the ``torch.Generator`` (on ``device``) that draws the
    weights; ``device`` defaults to the card and raises without one.
    """

    def __init__(self, cfg: ModelConfig, device="cuda", seed: int = 0):
        super().__init__()
        if cfg.first_layer_dense:
            raise NotImplementedError(_WAITS["mla"])
        dev = resolve_device(device)
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        self.cfg = cfg
        self.embed = embed_init(cfg, gen, dev)
        self.final_norm = param(rmsnorm_init(cfg.d_model,
                                             dtype_of(cfg.param_dtype), dev))
        self.layers = nn.ModuleList(
            Block(cfg, cfg.pattern[i % cfg.pattern_len], gen, dev)
            for i in range(cfg.num_repeats * cfg.pattern_len))

    @property
    def device(self) -> torch.device:
        return self.final_norm.device

    # ------------------------------------------------------------- forward
    def _mlp_part(self, blk: Block, x):
        if blk.spec.mlp == "none":
            return x
        h2 = rms_norm(x, blk.ln2, self.cfg.norm_eps)
        return x + mlp_apply(blk.mlp, h2, self.cfg.mlp_act)

    def _block_apply(self, blk: Block, x, positions, collect: bool = False):
        cfg = self.cfg
        h = rms_norm(x, blk.ln1, cfg.norm_eps)
        entry = None
        if blk.spec.mixer == "mamba":
            if collect:
                m, (ssm_s, conv_s) = ssm.mamba_apply(blk.mixer, h, cfg,
                                                     return_state=True)
                entry = {"ssm": ssm_s, "conv": conv_s}
            else:
                m = ssm.mamba_apply(blk.mixer, h, cfg)
        elif collect:
            m, (k, v) = attn.attn_apply(blk.mixer, h, cfg, positions,
                                        return_kv=True)
            entry = {"k": k.transpose(1, 2), "v": v.transpose(1, 2)}
        else:
            m = attn.attn_apply(blk.mixer, h, cfg, positions)
        x = self._mlp_part(blk, x + m)
        return x, entry

    def _positions(self, B: int, S: int):
        return torch.arange(S, device=self.device).expand(B, S)

    def apply(self, tokens):
        """tokens: (B, S) -> logits (B, S, padded_vocab)."""
        x = embed_lookup(self.embed, tokens, self.cfg)
        positions = self._positions(*tokens.shape)
        for blk in self.layers:
            x, _ = self._block_apply(blk, x, positions)
        x = rms_norm(x, self.final_norm, self.cfg.norm_eps)
        return lm_head(self.embed, x, self.cfg)

    # ------------------------------------------------------------- serving
    def cache_init(self, batch: int, cache_len: int, dtype=None) -> dict:
        """Empty cache sized for ``cache_len`` slots (SWA archs: pass window)."""
        cfg = self.cfg
        dt = dtype or dtype_of(cfg.activation_dtype)
        kv = (batch, cfg.num_kv_heads, cache_len, cfg.head_dim)

        def one(blk: Block) -> dict:
            if blk.spec.mixer == "mamba":
                s, c = ssm.mamba_state_init(cfg, batch, dt, self.device)
                return {"ssm": s, "conv": c}
            return {"k": torch.zeros(kv, dtype=dt, device=self.device),
                    "v": torch.zeros(kv, dtype=dt, device=self.device)}

        return {"layers": [one(blk) for blk in self.layers],
                "slot_pos": torch.full((cache_len,), -1, dtype=torch.int32,
                                       device=self.device),
                "pos": 0}

    def _block_decode(self, blk: Block, c: dict, x, slot_pos, pos: int,
                      slot: int):
        cfg = self.cfg
        h = rms_norm(x, blk.ln1, cfg.norm_eps)
        if blk.spec.mixer == "mamba":
            m, _ = ssm.mamba_decode(blk.mixer, h, cfg, c["ssm"], c["conv"])
            return self._mlp_part(blk, x + m)
        B = x.shape[0]
        hkv, hd = cfg.num_kv_heads, cfg.head_dim
        k_new = (h @ blk.mixer["wk"]).reshape(B, 1, hkv, hd)
        v_new = (h @ blk.mixer["wv"]).reshape(B, 1, hkv, hd)
        if cfg.qk_norm:
            k_new = rms_norm(k_new, blk.mixer["k_norm"], cfg.norm_eps)
        k_new = rope(k_new, torch.full((B, 1), pos, device=x.device),
                     cfg.rope_theta)
        c["k"][:, :, slot] = k_new[:, 0].to(c["k"].dtype)
        c["v"][:, :, slot] = v_new[:, 0].to(c["v"].dtype)
        m = attn.attn_decode(blk.mixer, h, cfg, c["k"], c["v"], slot_pos, pos)
        return self._mlp_part(blk, x + m)

    def decode_step(self, cache: dict, tokens):
        """One decode step. tokens: (B, 1). Returns (logits (B, 1, V),
        cache), the cache updated in place."""
        cfg = self.cfg
        pos = cache["pos"]
        cache_len = cache["slot_pos"].shape[0]
        if cfg.window is not None:
            slot = pos % cache_len                # SWA ring buffer
        else:
            # full attention: append (caller sizes the cache; clamp is a guard)
            slot = min(pos, cache_len - 1)
        slot_pos = cache["slot_pos"]
        slot_pos[slot] = pos
        x = embed_lookup(self.embed, tokens, cfg)
        for blk, c in zip(self.layers, cache["layers"]):
            x = self._block_decode(blk, c, x, slot_pos, pos, slot)
        x = rms_norm(x, self.final_norm, cfg.norm_eps)
        logits = lm_head(self.embed, x, cfg)
        cache["pos"] = pos + 1
        return logits, cache

    def prefill(self, tokens, cache_len: Optional[int] = None):
        """Forward pass that also builds a decode-ready cache in one pass."""
        B, S = tokens.shape
        cache_len = cache_len or S
        x = embed_lookup(self.embed, tokens, self.cfg)
        positions = self._positions(B, S)
        layers = []
        for blk in self.layers:
            x, entry = self._block_apply(blk, x, positions, collect=True)
            if blk.spec.mixer == "attn":
                entry = {k: _place_seq(v, cache_len, 2)
                         for k, v in entry.items()}
            layers.append(entry)   # mamba states need no seq placement
        x = rms_norm(x, self.final_norm, self.cfg.norm_eps)
        logits = lm_head(self.embed, x, self.cfg)
        cache = {"layers": layers,
                 "slot_pos": _prefill_slot_pos(S, cache_len, self.device),
                 "pos": S}
        return logits, cache
