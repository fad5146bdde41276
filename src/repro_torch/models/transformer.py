"""Config-driven decoder LM: dense attention, MLA, Mamba2 (SSD) and hybrid
stacks with dense or MoE MLPs.

The layer stack is ``num_repeats`` copies of ``cfg.pattern``. The JAX
package stacks each pattern position's weights over the repeats and runs
``lax.scan``; here each layer is its own submodule and the stack is a
Python loop. With ``cfg.first_layer_dense`` (DeepSeek) ``layers[0]`` is
the reference's ``params["first"]``: the pattern's mixer with a dense MLP.
The repeats follow it: ``layers[off + r * P + i]`` holds repeat r of
pattern position i, ``off`` being 1 with a first dense layer and 0
without. :class:`ShardCtx` carries the reference's sharding context (the
mesh and the batch axes); on a world of size 1 it changes no computation,
and a model that would shard over it waits for ROADMAP §1 item 12b.

Serving state is a dict: per-layer ``{"k", "v"}`` caches (B, Hkv, S, hd)
for attention layers, ``{"c", "rope"}`` latent caches ((B, S, lora),
(B, S, rd)) for MLA layers and ``{"ssm", "conv"}`` states ((B, H, P, N)
float32, (B, width - 1, ssm_inner)) for mamba layers, ``slot_pos`` (S,)
int32 on the device and ``pos`` a Python int. Unlike the reference,
:meth:`LM.decode_step` writes the new token's K/V, latent and slot into
the cache and advances the mamba states in place (no copy of the cache per
step) and returns the same dict.

``apply`` and ``prefill`` take ``extra_embeds`` (B, Np, d), embeddings
prepended to the tokens' (the VLM's patches).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional, Tuple

import torch
from torch import nn

from ..configs.base import LayerSpec, ModelConfig
from ..device import resolve_device
from . import attention as attn
from . import mla
from . import moe
from . import ssm
from .layers import (dtype_of, embed_init, embed_lookup, lm_head, mlp_apply,
                     mlp_init, param, rms_norm, rmsnorm_init)

__all__ = ["LM", "Block", "ShardCtx"]


@dataclass(frozen=True)
class ShardCtx:
    """The sharding context of the JAX package's models (None = local):
    a mesh (``launch.mesh``) and its batch axes. The port runs the model
    on one device: the batch axes and the reference's model-parallel axes
    (``"model"`` for TP, ``"data"`` for FSDP) must have size 1, so the
    context changes no computation; a larger one raises (ROADMAP §1 item
    12b). The pod axis belongs to the partitioned train step, not the
    model."""

    mesh: Any = None
    batch_axes: Tuple[str, ...] = ()

    def check_local(self) -> None:
        if self.mesh is None:
            return
        names = tuple(self.mesh.mesh_dim_names)
        for axis in (*self.batch_axes, "model", "data"):
            if axis in names and self.mesh.shape[names.index(axis)] > 1:
                raise ValueError(
                    f"mesh axis {axis!r} has size "
                    f"{self.mesh.shape[names.index(axis)]}: the port's model "
                    f"runs on one device per pod; sharded placements wait "
                    f"for ROADMAP.md section 1, item 12b")


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


_MIXERS = {"attn": attn.attn_init, "mla": mla.mla_init,
           "mamba": ssm.mamba_init}
_MLPS = {"dense": mlp_init, "moe": moe.moe_init}


class Block(nn.Module):
    """One layer: a pre-norm mixer (attention, MLA or Mamba2) and, for a
    dense or MoE MLP, a pre-norm MLP."""

    def __init__(self, cfg: ModelConfig, spec: LayerSpec,
                 generator: torch.Generator, device):
        super().__init__()
        if spec.mixer not in _MIXERS or spec.mlp not in (*_MLPS, "none"):
            raise ValueError(f"unknown layer {spec}")
        self.spec = spec
        dt = dtype_of(cfg.param_dtype)
        self.ln1 = param(rmsnorm_init(cfg.d_model, dt, device))
        self.mixer = _MIXERS[spec.mixer](cfg, generator, device)
        if spec.mlp != "none":
            self.ln2 = param(rmsnorm_init(cfg.d_model, dt, device))
            self.mlp = _MLPS[spec.mlp](cfg, generator, device)


class LM(nn.Module):
    """Decoder-only LM with its weights, on one device.

    ``seed`` seeds the ``torch.Generator`` (on ``device``) that draws the
    weights; ``device`` defaults to the card and raises without one.
    """

    def __init__(self, cfg: ModelConfig, device="cuda", seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        self.cfg = cfg
        self.embed = embed_init(cfg, gen, dev)
        self.final_norm = param(rmsnorm_init(cfg.d_model,
                                             dtype_of(cfg.param_dtype), dev))
        specs = [cfg.pattern[i % cfg.pattern_len]
                 for i in range(cfg.num_repeats * cfg.pattern_len)]
        if cfg.first_layer_dense:
            specs.insert(0, LayerSpec(cfg.pattern[0].mixer, "dense"))
        self.layers = nn.ModuleList(Block(cfg, spec, gen, dev)
                                    for spec in specs)

    @property
    def device(self) -> torch.device:
        return self.final_norm.device

    # ------------------------------------------------------------- forward
    def _mlp_part(self, blk: Block, x):
        if blk.spec.mlp == "none":
            return x
        h2 = rms_norm(x, blk.ln2, self.cfg.norm_eps)
        if blk.spec.mlp == "moe":
            return x + moe.moe_apply(blk.mlp, h2, self.cfg)
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
        elif blk.spec.mixer == "mla":
            m, (c, kr) = mla.mla_apply(blk.mixer, h, cfg, positions)
            entry = {"c": c, "rope": kr} if collect else None
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

    def _embed(self, tokens, extra_embeds):
        x = embed_lookup(self.embed, tokens, self.cfg)
        if extra_embeds is not None:
            x = torch.cat([extra_embeds.to(x.dtype), x], dim=1)
        return x

    def forward(self, tokens, extra_embeds=None):
        """:meth:`apply` (the call ``torch.func.functional_call`` makes)."""
        return self.apply(tokens, extra_embeds=extra_embeds)

    def apply(self, tokens, *, extra_embeds=None):
        """tokens: (B, S_text) -> logits (B, S, padded_vocab); S counts the
        ``extra_embeds`` (B, Np, d) prepended to the tokens' embeddings."""
        x = self._embed(tokens, extra_embeds)
        positions = self._positions(*x.shape[:2])
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

        def zeros(*shape):
            return torch.zeros(shape, dtype=dt, device=self.device)

        def one(blk: Block) -> dict:
            if blk.spec.mixer == "mamba":
                s, c = ssm.mamba_state_init(cfg, batch, dt, self.device)
                return {"ssm": s, "conv": c}
            if blk.spec.mixer == "mla":
                return {"c": zeros(batch, cache_len, cfg.kv_lora_rank),
                        "rope": zeros(batch, cache_len, cfg.qk_rope_head_dim)}
            return {"k": zeros(*kv), "v": zeros(*kv)}

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
        elif blk.spec.mixer == "mla":
            cl, kr = mla.latent(blk.mixer, h, cfg,
                                torch.full((x.shape[0], 1), pos,
                                           device=x.device))
            c["c"][:, slot] = cl[:, 0].to(c["c"].dtype)
            c["rope"][:, slot] = kr[:, 0, 0].to(c["rope"].dtype)
            m = mla.mla_decode(blk.mixer, h, cfg, c["c"], c["rope"],
                               slot_pos, pos)
        else:
            m = attn.attn_decode_step(blk.mixer, h, cfg, c, slot_pos, pos,
                                      slot)
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

    def prefill(self, tokens, cache_len: Optional[int] = None, *,
                extra_embeds=None):
        """Forward pass that also builds a decode-ready cache in one pass;
        ``extra_embeds`` as in :meth:`apply`."""
        x = self._embed(tokens, extra_embeds)
        B, S = x.shape[:2]
        cache_len = cache_len or S
        positions = self._positions(B, S)
        layers = []
        # the sequence axis of each cache entry (mamba states have none)
        seq_axis = {"attn": 2, "mla": 1}
        for blk in self.layers:
            x, entry = self._block_apply(blk, x, positions, collect=True)
            axis = seq_axis.get(blk.spec.mixer)
            if axis is not None:
                entry = {k: _place_seq(v, cache_len, axis)
                         for k, v in entry.items()}
            layers.append(entry)
        x = rms_norm(x, self.final_norm, self.cfg.norm_eps)
        logits = lm_head(self.embed, x, self.cfg)
        cache = {"layers": layers,
                 "slot_pos": _prefill_slot_pos(S, cache_len, self.device),
                 "pos": S}
        return logits, cache
