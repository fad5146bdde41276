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

With ``cfg.remat`` a differentiated forward recomputes each encoder and
each decoder layer in its backward (``models/remat.py``), as the
reference's ``jax.checkpoint`` around both scan bodies does. The
reference gives those checkpoints no policy, so "dots" is "full" here as
there.

Serving state is a dict: per-layer ``{"k", "v", "xk", "xv"}`` (self-
attention caches (B, Hkv, S, hd) and the cross-attention K/V over the
frames, built once at prefill), ``slot_pos`` (S,) int32 and ``pos`` a
Python int; :meth:`EncDec.decode_step` updates the cache in place.

Under a sharding context on a ``DeviceMesh`` (``ShardCtx``, as the LM's:
``models/transformer.py``) the weights sit at ``param_specs``' placements,
each rank computes its rows of the batch (frames and tokens), and on the
TP axis (``models/tp.py``) the encoder's attention, the decoder's self-
and cross-attention (the cross K/V of the encoder output at the rank's
heads where they divide the TP size), the MLPs' hidden columns and the
vocab run on their rank, each joined by an ``all_reduce``. Under
sequence parallelism (``ShardCtx.seq_axis``) the encoder's and the
decoder's streams hold the rank's block of their sequences, as the LM's
does; the encoder's output is gathered once, before the cross K/V. The
cache entries sit at ``cache_specs``' placements, the heads on their TP
rank, and the logits come back as the LM's do. A sequence-sharded decode
(``decode_seq_axes``) is the LM's alone.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..configs.base import LayerSpec, ModelConfig
from ..device import model_device, seeded_generator
from ..launch import collectives, shardings
from . import attention as attn
from . import remat
from .layers import dtype_of, embed_init, mlp_init, param, rms_norm, \
    rmsnorm_init
from .transformer import (Sharded, ShardCtx, _local, _place_seq,
                          _prefill_slot_pos)

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


def _policy(cfg: ModelConfig):
    """The checkpoint policy of each layer: "full" with ``cfg.remat``
    whatever ``remat_policy`` says (the reference's Whisper units take
    ``jax.checkpoint`` with no policy), else None."""
    return "full" if cfg.remat else None


def _promote(p, dtype):
    """The parameters of ``p`` in ``dtype`` where narrower (as jnp
    promotes a matmul's operands); ``p`` itself when none is."""
    if all(v.dtype == dtype for v in p.values()):
        return p
    return {k: v.to(dtype) for k, v in p.items()}


# every block of the encoder-decoder is attention with a dense MLP
_SPEC = LayerSpec("attn", "dense")


class EncDec(Sharded):
    """Encoder-decoder LM (the whisper-large-v3 backbone), weights drawn
    from a ``torch.Generator`` seeded with ``seed`` on ``device``; ``ctx``
    the sharding context (``build_model`` puts the weights at its
    placements)."""

    def __init__(self, cfg: ModelConfig, device="cuda", seed: int = 0,
                 ctx: Optional[ShardCtx] = None):
        super().__init__()
        dev = model_device(device)
        gen = seeded_generator(dev, seed)
        dt = dtype_of(cfg.param_dtype)
        self.cfg = cfg
        self.ctx = ctx or ShardCtx()
        if self.ctx.decode_seq_axes:
            raise ValueError("the encoder-decoder decodes with its cache's "
                             "sequence whole: decode_seq_axes is the LM's")
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

    @property
    def _mode(self):
        """How every attention block runs on the TP axis (tp.plan)."""
        return self._plan(_SPEC).mixer

    def _group(self):
        """The TP group the attention blocks' partials join over."""
        return self._tp_group() if self._mode else None

    def _attend(self, p, h, positions, **kw):
        """An attention block on the stream h: Megatron's f and g around
        it where it runs by rank; under sequence parallelism the gathered
        sequence in and the rank's block out (``Sharded._enter``,
        ``_leave``)."""
        g, length = self._group(), positions.shape[1]
        sg = self._seq_group(length)
        out = attn.attn_apply(p, self._enter(h, g, sg, length), self.cfg,
                              positions, **kw)
        if kw.get("return_kv"):
            return self._leave(out[0], g, sg), out[1]
        return self._leave(out, g, sg)

    # ------------------------------------------------------------- encode
    def encode(self, frames):
        """frames: (B, F, d) precomputed embeddings (this rank's rows) ->
        (B, F, d). Under sequence parallelism the encoder's stream is the
        rank's block of the frames, gathered once after the final norm
        (each decoder layer's cross heads then enter it through
        Megatron's f)."""
        cfg = self.cfg
        F = frames.shape[1]
        sg = self._seq_group(F)
        x = collectives.split(self._encoder_input(frames), 1, sg)
        positions = self._positions(frames.shape[0], F)
        policy = _policy(cfg)
        for blk in self.enc_blocks:
            x = remat.checkpointed(self._enc_layer, x,
                                   remat.unit_params(blk), positions,
                                   policy=policy)
        x = rms_norm(x, self._gathered(self.enc_norm, sg is not None).to(
            x.dtype), cfg.norm_eps)
        return collectives.all_gather(x, 1, sg, partial_grads=False,
                                      length=F)

    def _encoder_input(self, frames):
        """The frames plus their sinusoid, in the promoted dtype of frames
        and weights (the encoder's)."""
        cfg = self.cfg
        _, F, d = frames.shape
        x = (frames.to(dtype_of(cfg.activation_dtype))
             + sinusoid(F, d, frames.dtype, frames.device))
        return x.to(torch.promote_types(x.dtype, dtype_of(cfg.param_dtype)))

    def _enc_layer(self, x, p, positions):
        """One encoder layer on its parameters ``p`` (gathered here, inside
        the checkpoint), promoted to x's dtype."""
        cfg, dt = self.cfg, x.dtype
        length = positions.shape[1]
        sg = self._seq_group(length)
        p = self._compute(p, _SPEC, sg is not None)
        mixer, _ = self._kv_slice(_promote(p["mixer"], dt), self._mode,
                                  False)
        mlp = _promote(p["mlp"], dt)
        h = rms_norm(x, p["ln1"].to(dt), cfg.norm_eps)
        x = x + self._attend(mixer, h, positions, causal=False)
        h = rms_norm(x, p["ln2"].to(dt), cfg.norm_eps)
        return x + self._ffn(mlp, h, _SPEC, sg, length)

    def _cross_kv(self, p_cross, enc_out):
        """The cross-attention K/V of the frames, (B, F, Hkv, hd) each, at
        the heads of ``p_cross``'s columns."""
        cfg = self.cfg
        B, F, _ = enc_out.shape
        hkv, hd = attn.heads(p_cross["wk"], cfg), cfg.head_dim
        k = (enc_out @ p_cross["wk"].to(enc_out.dtype)).reshape(B, F, hkv, hd)
        v = (enc_out @ p_cross["wv"].to(enc_out.dtype)).reshape(B, F, hkv, hd)
        return k, v

    def _dec_block(self, p, x, positions, cross_kv, collect: bool = False):
        """One decoder layer on its parameters ``p`` (to compute with:
        ``_compute``); ``cross_kv`` of the cross weights ``_kv_slice``
        gives with ``collect``. Under sequence parallelism x is the rank's
        block of the stream and the entry the whole sequence's."""
        cfg = self.cfg
        length = positions.shape[1]
        h = rms_norm(x, p["ln1"], cfg.norm_eps)
        entry = None
        mixer, kvh = self._kv_slice(p["self"], self._mode, collect)
        if collect:
            m, (k, v) = self._attend(mixer, h, positions, return_kv=True,
                                     kv_heads=kvh)
            entry = {"k": k.transpose(1, 2), "v": v.transpose(1, 2)}
        else:
            m = self._attend(mixer, h, positions)
        x = x + m
        h = rms_norm(x, p["ln_x"], cfg.norm_eps)
        # bidirectional over the frames, no rope on the cross K/V
        x = x + self._attend(p["cross"], h, positions, causal=False,
                             kv_override=cross_kv, kv_heads=kvh)
        h = rms_norm(x, p["ln2"], cfg.norm_eps)
        return x + self._ffn(p["mlp"], h, _SPEC, self._seq_group(length),
                             length), entry

    def _dec_layer(self, x, p, positions, enc_out):
        """The reference's decoder unit: the layer's cross K/V of the
        frames, then the layer (its parameters gathered here, inside the
        checkpoint)."""
        p = self._compute(p, _SPEC,
                          self._seq_group(positions.shape[1]) is not None)
        cross, _ = self._kv_slice(p["cross"], self._mode, False)
        # the frames enter the rank's cross heads: Megatron's f
        enc_out = collectives.reduce_grad(enc_out, self._group())
        return self._dec_block(p, x, positions,
                               self._cross_kv(cross, enc_out))[0]

    def _decoder_input(self, tokens, emb=None, sg=None):
        """The tokens' embeddings (``emb``: the table to compute with,
        else the module's) plus their sinusoid; the rank's block of their
        sequence under sequence parallelism (``sg``)."""
        x = self._lookup(self.embed if emb is None else emb, tokens)
        return collectives.split(x + sinusoid(
            tokens.shape[1], self.cfg.d_model, x.dtype, x.device), 1, sg)

    def forward(self, tokens, frames, rows=None):
        return self.apply(tokens, frames, rows=rows)

    def apply(self, tokens, frames, *, rows=None):
        """Teacher-forced decode over the whole target: tokens (B, S),
        frames (B, F, d) -> logits (B, S, padded_vocab); ``rows`` as in
        ``LM.apply``."""
        cfg = self.cfg
        if rows is None:
            rows = self._differentiated(frames)
        tokens = self.rows(tokens)
        S = tokens.shape[1]
        sg = self._seq_group(S)
        emb, final_norm = self._top(sg is not None)
        enc_out = self.encode(self.rows(frames))
        x = self._decoder_input(tokens, emb, sg)
        positions = self._positions(*tokens.shape)
        policy = _policy(cfg)
        for blk in self.dec_blocks:
            x = remat.checkpointed(self._dec_layer, x,
                                   remat.unit_params(blk), positions,
                                   enc_out, policy=policy)
        return self._logits(self._out(emb, final_norm, x, sg, S), rows)

    # ------------------------------------------------------------- serving
    def cache_init(self, batch: int, cache_len: int, enc_frames: int,
                   dtype=None) -> dict:
        """Empty caches, at ``cache_specs``' placements on a
        ``DeviceMesh`` (``batch`` is the global batch)."""
        cfg = self.cfg
        dt = dtype or dtype_of(cfg.activation_dtype)
        kv = (batch, cfg.num_kv_heads, cache_len, cfg.head_dim)
        xkv = (batch, cfg.num_kv_heads, enc_frames, cfg.head_dim)

        def zeros(shape):
            return torch.zeros(shape, dtype=dt, device=self.device)

        cache = {"layers": [{"k": zeros(kv), "v": zeros(kv),
                             "xk": zeros(xkv), "xv": zeros(xkv)}
                            for _ in self.dec_blocks],
                 "slot_pos": torch.full((cache_len,), -1, dtype=torch.int32,
                                        device=self.device),
                 "pos": 0}
        if not self._placed:
            return cache
        ctx = self.ctx
        return shardings.place_cache(cache, ctx.mesh, shardings.cache_specs(
            cache, ctx.mesh, cfg, tp=ctx.tp_axis))

    def prefill(self, tokens, frames, cache_len: Optional[int] = None):
        """Encode, then a teacher-forced pass that builds the self- and
        cross-attention caches."""
        tokens = self.rows(tokens)
        B, S = tokens.shape
        sg = self._seq_group(S)
        emb, final_norm = self._top(sg is not None)
        enc_out = self.encode(self.rows(frames))
        cache_len = cache_len or S
        x = self._decoder_input(tokens, emb, sg)
        positions = self._positions(B, S)
        heads = self._mode == "heads"
        layers = []
        for blk in self.dec_blocks:
            p = self._params(blk, _SPEC, sg is not None)
            ck, cv = self._cross_kv(p["cross"], enc_out)
            x, entry = self._dec_block(p, x, positions, (ck, cv),
                                       collect=True)
            layers.append(self._store({
                **{k: _place_seq(v, cache_len, 2) for k, v in entry.items()},
                "xk": ck.transpose(1, 2).contiguous(),
                "xv": cv.transpose(1, 2).contiguous()}, False, heads))
        slot_pos = _prefill_slot_pos(S, cache_len, self.device)
        cache = {"layers": layers,
                 "slot_pos": self._store({"slot_pos": slot_pos},
                                         False)["slot_pos"],
                 "pos": S}
        return self._logits(self._out(emb, final_norm, x, sg, S),
                            False), cache

    def decode_step(self, cache: dict, tokens):
        """tokens: (B, 1). The cross K/V come from the cache. Returns
        (logits (B, 1, V), as :meth:`apply`'s global logits, cache), the
        cache updated in place."""
        cfg = self.cfg
        pos = cache["pos"]
        cache_len = cache["slot_pos"].shape[0]
        slot = min(pos, cache_len - 1)
        slot_pos = _local(cache["slot_pos"])
        slot_pos[slot] = pos
        emb, final_norm = self._top()
        x = self._lookup(emb, self.rows(tokens))
        # the position's sinusoid row, clamped to the cache as in the
        # reference
        x = x + sinusoid(1, cfg.d_model, x.dtype, x.device, start=slot)
        # every frame is valid: slot position 0 is <= any pos
        frames = cache["layers"][0]["xk"].shape[2]
        xvalid = torch.zeros(frames, dtype=torch.int32, device=x.device)
        g = self._group()
        for blk, c in zip(self.dec_blocks, cache["layers"]):
            if self._placed:
                p = self._params(blk, _SPEC)
                keep = {k: self._layout(k, True, self._mode == "heads")
                        for k in c}
                ce = {k: shardings.gather(v, keep[k]) for k, v in c.items()}
            else:   # the block's own modules: no per-step gathering
                p, keep, ce = remat.unit_params(blk), None, c
            mixer, kvh = self._kv_slice(p["self"], self._mode, True)
            h = rms_norm(x, p["ln1"], cfg.norm_eps)
            x = x + collectives.all_reduce(attn.attn_decode_step(
                mixer, h, cfg, ce, slot_pos, pos, slot, kv_heads=kvh), g)
            h = rms_norm(x, p["ln_x"], cfg.norm_eps)
            x = x + collectives.all_reduce(attn.attn_decode(
                p["cross"], h, cfg, ce["xk"], ce["xv"], xvalid, pos,
                kv_heads=kvh), g)
            h = rms_norm(x, p["ln2"], cfg.norm_eps)
            x = x + self._ffn(p["mlp"], h, _SPEC)
            if keep:
                for k in ("k", "v"):
                    shardings.write_back(c[k], ce[k], keep[k])
        x = rms_norm(x, final_norm, cfg.norm_eps)
        cache["pos"] = pos + 1
        return self._logits(self._head(emb, x), False), cache
