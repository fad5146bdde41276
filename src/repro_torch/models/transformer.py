"""Config-driven decoder LM: dense attention, MLA, Mamba2 (SSD) and hybrid
stacks with dense or MoE MLPs.

The layer stack is ``num_repeats`` copies of ``cfg.pattern``. The JAX
package stacks each pattern position's weights over the repeats and runs
``lax.scan``; here each layer is its own submodule and the stack is a
Python loop over the same units. With ``cfg.first_layer_dense``
(DeepSeek) ``layers[0]`` is the reference's ``params["first"]``: the
pattern's mixer with a dense MLP, run alone and outside remat. The
repeats follow it: ``layers[off + r * P + i]`` holds repeat r of pattern
position i, ``off`` being 1 with a first dense layer and 0 without. Each
repeat's P layers are one unit, and with ``cfg.remat`` a differentiated
:meth:`LM.apply` recomputes each unit in its backward
(``models/remat.py``), as the reference's ``jax.checkpoint`` around its
scan body does.

:class:`ShardCtx` carries the reference's sharding context. With a
``DeviceMesh`` ``build_model`` puts the parameters at
``launch.shardings.param_specs``' DTensor placements, and the model serves
as the reference's partitioned program does (``prefill``, ``apply``
without a gradient, ``decode_step``): each rank computes its rows of the
batch (its shard over ``batch_axes``), and on the TP axis its heads and
columns (``models/tp.py``): each layer's attention, MLA or Mamba2 heads,
its dense MLP's or shared experts' hidden columns where they divide the
TP size, and the vocab rows of the embedding and columns of the head.
Such a block takes its weights gathered over FSDP only
(``shardings.gather_local``), its input through Megatron's f and its
partial output through an ``all_reduce`` over TP (g); a block whose heads
do not divide the TP size gathers its weights to full and runs on every
rank, as the reference's rule replicates it. The MoE's experts are
expert-parallel over the TP axis (``models/moe.py``), and a cache whose
sequence is sharded (``decode_seq_axes``) decodes through each shard's
partial and a log-sum-exp combine (``models/attention.py``). Cache
entries sit at ``cache_specs``' placements: a layer gathers its entry to
the layout it computes in before the step (its heads stay on their TP
rank, so a decode step gathers no entry over TP) and keeps its own shard
of the update. The entry points take global tokens and return the logits
as a DTensor at the reference's layout, the batch over ``batch_axes`` and
the vocab over the TP axis where it runs there (``full_tensor()`` gives
the plain tensor). At a world of 1 every axis has size 1, no collective
runs, and the model computes exactly what it computes without a
context.

A differentiated forward on a mesh (training) runs the same program
through ``launch/collectives.py``: a weight's gather over a batch axis
reduce-scatters its gradient (each rank computed its own rows), a weight
replicated over one all-reduces it, a gather over any other axis takes
the rank's slice, and the MoE's collectives are Megatron's pair
(``models/moe.py``). Such a forward returns the rank's rows of the logits
(``rows=True``, the default when differentiated), and its vocab columns
where the vocab runs by rank (:meth:`LM.logits_shard`): the loss is
vocab-parallel and reduced over the batch axes (``train/loss.py``), and
no rank holds the global logits. Under remat each unit's gathers run
inside its checkpoint, so the backward gathers the weights again and none
is kept across the unit.

With ``ctx.seq_axis`` (Megatron sequence parallelism, the reference's
``ctx.hidden`` constraint) the residual stream between blocks is the
rank's block of its (B, S, d) sequence over the TP axis, ``seq_block(S,
tp)`` rows, the last ranks' padded where tp does not divide S (XLA's
layout of an uneven sharding): the embeddings enter as the rank's block
(the vocab-parallel lookup's partials reduce-scattered), every norm runs
on the block (its scale's gradient summed over TP), each block gathers
the sequence (Megatron-SP's f̄: an all-gather whose adjoint reduce-
scatters) and hands back its block of the summed partials (ḡ: a
reduce-scatter); a block run replicated gathers the sequence with the
slice adjoint, computes it whole and keeps its rank's block
(``collectives.split``, whose adjoint all-gathers), so its weights'
gradients are whole on every rank. The MoE gathers the sequence and
routes what it routes without it (``models/moe.py``). The final norm's
blocks are gathered before the head, and a prefill's cache entries come
from the gathered sequence, so the logits and the cache are as without
``seq_axis``. A stream shorter than the TP size (a decode step's token)
stays whole on every rank (ROADMAP §3 item 34). The batch may split over
"pod" and "data" together (``batch_axes=("pod", "data")``): each rank
takes the block of rows at its pod-major index, and a weight's gradient
is summed over "pod" and reduce-scattered over "data" by the same
gathers.

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
from ..device import model_device, seeded_generator
from ..launch import collectives
from ..launch import mesh as mesh_lib
from ..launch import shardings
from . import attention as attn
from . import mla
from . import moe
from . import remat
from . import ssm
from . import tp as tp_lib
from .layers import (dtype_of, embed_init, embed_lookup, lm_head, mlp_apply,
                     mlp_init, param, rms_norm, rmsnorm_init)

__all__ = ["LM", "Block", "ShardCtx"]


# the axes each field of a ShardCtx may shard over when they have more
# than one device: the batch over "pod" and "data" (pod-major, as
# ``P(("pod", "data"))`` lays it out), the rest as the reference's dry run
# sets them
_WIDE_AXES = {"batch_axes": ("pod", "data"), "decode_seq_axes": ("data",),
              "tp_axis": ("model",), "fsdp_axis": ("data",)}


@dataclass(frozen=True)
class ShardCtx:
    """The sharding context of the JAX package's models (``mesh=None``:
    local): a ``launch.mesh`` mesh, the axes that shard the batch (one or
    both of "pod" and "data"), the TP (``"model"``: experts) and FSDP
    (``"data"``: weights, expert banks) axes, ``decode_seq_axes``, the
    axes that shard a long cache's sequence in decode, and ``seq_axis``,
    Megatron sequence parallelism on the residual stream: between blocks
    each rank holds its block of the (B, S, d) stream's sequence, as the
    reference's ``ctx.hidden`` constraint makes XLA hold it (``LM``
    says how the blocks gather and reduce-scatter it). The port takes it
    over the TP axis only, as the reference's dry run sets it. The
    reference's ``manual_extra`` only steers XLA's partitioner and has no
    counterpart here.

    The reference's dry run shards the cache's sequence only when the
    batch is too small to shard (``batch_axes=()``), and the batch over
    "data" otherwise; a context that shards both over one axis raises
    (ROADMAP §3 item 32)."""

    mesh: Any = None
    batch_axes: Tuple[str, ...] = ()
    tp_axis: Optional[str] = "model"
    fsdp_axis: Optional[str] = "data"
    decode_seq_axes: Optional[Tuple[str, ...]] = None
    seq_axis: Optional[str] = None

    def size(self, axis) -> int:
        return 1 if self.mesh is None else mesh_lib.axis_size(self.mesh, axis)

    def rank(self, axis) -> int:
        return 0 if self.size(axis) == 1 else mesh_lib.axis_rank(self.mesh,
                                                                 axis)

    def group(self, axis):
        """The process group of ``axis``; None at size 1 (no collective)."""
        return None if self.size(axis) == 1 else mesh_lib.axis_group(
            self.mesh, axis)

    def wide(self, axes) -> Optional[str]:
        """The one axis of ``axes`` with more than one device, or None
        (read of ``decode_seq_axes``, which :meth:`check_local` keeps to
        one axis)."""
        wide = [a for a in (axes or ()) if self.size(a) > 1]
        return wide[0] if wide else None

    @property
    def row_axes(self) -> Tuple[str, ...]:
        """The axes whose ranks compute different rows of the batch."""
        return tuple(a for a in self.batch_axes if self.size(a) > 1)

    @property
    def sharded(self) -> bool:
        """Whether a mesh axis the model reads has more than one device."""
        return any(self.size(a) > 1 for a in (
            *self.batch_axes, *(self.decode_seq_axes or ()), self.tp_axis,
            self.fsdp_axis, self.seq_axis))

    def check_local(self) -> None:
        """Raises on a context the port does not run (see the class)."""
        if self.mesh is None:
            return
        if self.seq_axis is not None and self.seq_axis != self.tp_axis:
            raise ValueError(
                f"seq_axis {self.seq_axis!r}: the port splits the residual "
                f"stream's sequence over the TP axis {self.tp_axis!r} only, "
                f"as the reference's dry run does")
        fields = {"batch_axes": self.batch_axes,
                  "decode_seq_axes": self.decode_seq_axes or (),
                  "tp_axis": (self.tp_axis,) if self.tp_axis else (),
                  "fsdp_axis": (self.fsdp_axis,) if self.fsdp_axis else ()}
        for field, axes in fields.items():
            for axis in axes:
                if self.size(axis) > 1 and axis not in _WIDE_AXES[field]:
                    raise ValueError(
                        f"{field} {axes}: axis {axis!r} has size "
                        f"{self.size(axis)}; the model shards {field} over "
                        f"{_WIDE_AXES[field]} only")
        names = tuple(self.mesh.mesh_dim_names)
        order = [names.index(a) for a in self.batch_axes if a in names]
        if order != sorted(order):
            raise ValueError(f"batch_axes {self.batch_axes}: the axes of one "
                             f"dim take the mesh's order {names}")
        shared = set(self.batch_axes) & set(self.decode_seq_axes or ())
        if shared:
            raise ValueError(
                f"batch_axes and decode_seq_axes share {sorted(shared)}: the "
                f"port shards a cache's sequence only with batch_axes=() (a "
                f"batch too small to shard), as the reference's dry run "
                f"does; ROADMAP.md section 3, item 32")


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


# the MoE's expert banks: handed to moe_apply at their placements, which
# gathers them over FSDP only (the rank keeps its experts)
_BANKS = ("moe_up", "moe_gate", "moe_down")


def _gathered_block(p: dict, mode, axis, rows) -> dict:
    """A mixer's or MLP's parameters to compute with: each DTensor
    gathered to full where the block runs replicated (``mode`` None) and
    for a MoE's router, else ("heads", "mlp") over every axis but the TP
    axis ``axis``, with "kv_slice"'s ``wk`` and ``wv`` gathered whole for
    the rank to slice; a MoE's expert banks as they are."""
    out = {}
    for k, v in p.items():
        if k in _BANKS:
            out[k] = v
        elif mode is None or k == "router":
            out[k] = shardings.gather(v, rows=rows)
        elif mode == "kv_slice" and k in ("wk", "wv"):
            out[k] = shardings.gather(v, rows=(*rows, axis))
        else:
            out[k] = shardings.gather_local(v, axis, rows)
    return out


class Sharded(nn.Module):
    """What the models (:class:`LM`, ``whisper.EncDec``) share on a
    sharding context: the rows of the batch a rank computes, the weights
    to compute with (gathered, or kept on their TP rank by
    ``models/tp.py``'s plan), the vocab-parallel embedding, head and
    logits, and the layout of each cache entry. A subclass holds ``cfg``,
    ``ctx``, ``embed`` and ``final_norm``."""

    @property
    def _placed(self) -> bool:
        """Whether the weights and caches sit at DTensor placements."""
        return shardings.is_device_mesh(self.ctx.mesh)

    # ------------------------------------------------------ sharding helpers
    @property
    def _tp(self) -> int:
        """The TP size the blocks run by rank over (1 off a
        ``DeviceMesh``: nothing runs by rank)."""
        return self.ctx.size(self.ctx.tp_axis) if (
            self._placed and self.ctx.tp_axis) else 1

    def _tp_group(self):
        return self.ctx.group(self.ctx.tp_axis) if self._tp > 1 else None

    def _plan(self, spec: LayerSpec) -> tp_lib.Plan:
        """What of a layer ``spec`` runs on its TP rank."""
        return tp_lib.plan(self.cfg, spec, self._tp)

    def _norm_rows(self, seq: bool) -> Tuple[str, ...]:
        """The axes whose ranks normalize different rows: the batch axes,
        and with ``seq`` (the stream's sequence in blocks) the TP axis, so
        a norm scale's gradient is summed there too."""
        rows = self.ctx.row_axes
        return (*rows, self.ctx.tp_axis) if seq else rows

    def _compute(self, p: dict, spec: LayerSpec, seq: bool = False) -> dict:
        """A layer's parameters (``remat.unit_params``) to compute with on
        a ``DeviceMesh``: its norms gathered to full (``seq``: they
        normalize the rank's block of the sequence), its mixer and MLP by
        :meth:`_plan` (:func:`_gathered_block`)."""
        if not self._placed:
            return p
        rows, axis, pl = self.ctx.row_axes, self.ctx.tp_axis, \
            self._plan(spec)
        # the mixers (an encoder-decoder's self- and cross-attention) and
        # the MLP
        modes = {"mixer": pl.mixer, "self": pl.mixer, "cross": pl.mixer,
                 "mlp": "mlp" if pl.mlp else None}
        return {k: (_gathered_block(v, modes[k], axis, rows) if k in modes
                    else shardings.gather(v, rows=self._norm_rows(seq)))
                for k, v in p.items()}

    def _params(self, blk: nn.Module, spec: Optional[LayerSpec] = None,
                seq: bool = False) -> dict:
        """``blk``'s parameters to compute with (``spec``: its layer's,
        by default ``blk.spec``; ``seq`` as in :meth:`_compute`)."""
        return self._compute(remat.unit_params(blk), spec or blk.spec, seq)

    # ---------------------------------------------- sequence parallelism
    def _seq_group(self, length: int):
        """The TP group over which a residual stream of ``length``
        positions holds its sequence in blocks (``ctx.seq_axis``), or
        None: no ``seq_axis``, nothing run by rank, or a stream shorter
        than the TP size (a decode step's token), which stays whole on
        every rank."""
        if self.ctx.seq_axis is None or self._tp == 1 or length < self._tp:
            return None
        return self._tp_group()

    def _enter(self, h, g, sg, length: int):
        """A block's input from the stream h: Megatron's f over ``g`` (the
        TP group where the block runs by rank, else None) where the stream
        is whole (``sg`` None); else the gathered sequence, whose adjoint
        reduce-scatters where the block runs by rank (Megatron-SP's f̄)
        and is the rank's block where every rank computes it whole."""
        if sg is None:
            return collectives.reduce_grad(h, g)
        return collectives.all_gather(h, 1, sg, partial_grads=g is not None,
                                      length=length)

    def _leave(self, m, g, sg):
        """A block's output into the stream: the ranks' partials summed
        over ``g`` (Megatron's g) where the stream is whole; else the
        rank's block of their sum (ḡ, a reduce-scatter), or of an output
        every rank computed whole."""
        if sg is None:
            return collectives.all_reduce(m, g)
        if g is not None:
            return collectives.reduce_scatter(m, 1, sg)
        return collectives.split(m, 1, sg)

    def _ffn(self, mlp, h, spec: LayerSpec, sg=None, length: int = 0):
        """A dense MLP on the stream h, on its hidden columns' TP rank
        where the plan runs it there (:meth:`_enter`, :meth:`_leave`)."""
        g = self._tp_group() if self._plan(spec).mlp else None
        return self._leave(mlp_apply(mlp, self._enter(h, g, sg, length),
                                     self.cfg.mlp_act), g, sg)

    @property
    def _vocab_local(self) -> bool:
        return tp_lib.vocab_local(self.cfg, self._tp)

    def logits_shard(self):
        """``(start, group)`` where the vocab runs by rank: the logits of a
        differentiated forward are this rank's vocab columns from
        ``start`` of the TP ``group``'s (``train/loss.py``); else None."""
        if not self._vocab_local:
            return None
        return (tp_lib.vocab_start(self.cfg, self.ctx.rank(self.ctx.tp_axis),
                                   self._tp), self._tp_group())

    def _gathered(self, t, seq: bool = False):
        """A norm's scale outside the layers (a final norm) to compute
        with (``seq`` as in :meth:`_compute`)."""
        return shardings.gather(t, rows=self._norm_rows(seq)) if (
            self._placed) else t

    def _top(self, seq: bool = False):
        """The embedding table, the head and the final norm to compute
        with: gathered, the vocab kept on its TP rank where it runs there
        (the module's own off a ``DeviceMesh``); ``seq`` as in
        :meth:`_compute`."""
        if not self._placed:
            return self.embed, self.final_norm
        rows = self.ctx.row_axes
        if self._vocab_local:
            emb = {k: shardings.gather_local(self.embed[k], self.ctx.tp_axis,
                                             rows)
                   for k in ("embedding", "head")}
        else:
            emb = {k: shardings.gather(self.embed[k], rows=rows)
                   for k in ("embedding", "head")}
        return emb, self._gathered(self.final_norm, seq)

    def _lookup(self, emb, tokens):
        """Token embeddings from the table ``emb`` (:meth:`_top`), vocab-
        parallel where the vocab runs by rank."""
        shard = self.logits_shard()
        return embed_lookup(emb, tokens, self.cfg,
                            shard and (shard[0], shard[1]))

    def _head(self, emb, x):
        """The logits of x: this rank's vocab columns where the vocab runs
        by rank."""
        return lm_head(emb, x, self.cfg,
                       self._tp_group() if self._vocab_local else None)

    def _out(self, emb, final_norm, x, sg, length: int):
        """The logits of the stream x (:meth:`_head`) after the final
        norm; under sequence parallelism (``sg``) the normed blocks are
        gathered first, so the logits keep their layout."""
        x = rms_norm(x, final_norm, self.cfg.norm_eps)
        if sg is None:
            return self._head(emb, x)
        g = self._tp_group() if self._vocab_local else None
        return lm_head(emb, self._enter(x, g, sg, length), self.cfg)

    def _logits(self, t, rows: bool):
        """What an entry point returns of the rank's logits ``t``: ``t``
        itself with ``rows``; else on a ``DeviceMesh`` a DTensor at the
        reference's layout (batch over ``batch_axes``, vocab over TP where
        it runs by rank), and off one the global batch."""
        if rows:
            return t
        if not self._placed:
            return self._unrows(t)
        ctx = self.ctx
        spec = (tuple(ctx.batch_axes) or None, None,
                ctx.tp_axis if self._vocab_local else None)
        return shardings.distribute(t, ctx.mesh, spec, have=spec)

    def _differentiated(self, *inputs) -> bool:
        return torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (*inputs, *self.parameters()))

    def rows(self, t):
        """This rank's rows of a global batch (its block over the batch
        axes): also the labels of the logits ``apply(..., rows=True)``
        returns; off a ``DeviceMesh`` every row."""
        if t is None or not self.ctx.batch_axes or not self._placed:
            return t
        return shardings.local_shard(t, self.ctx.mesh,
                                     (tuple(self.ctx.batch_axes),))

    def _unrows(self, t):
        """The global batch of every rank's rows ``t`` (the same on every
        rank after it: the gradient's adjoint is the rank's slice)."""
        if not self.ctx.batch_axes or not self._placed:
            return t
        return shardings.gather_dim(t, 0, self.ctx.mesh,
                                    tuple(self.ctx.batch_axes))

    def _layout(self, name: str, seq_kept: bool, heads: bool = False):
        """The spec of the layout a layer computes a cache entry in: its
        rows of the batch, its heads (``heads``: the mixer runs by rank,
        its heads and a Mamba2 conv state's channels on their TP rank;
        else every head), and in decode its own sequence shard of an
        attention cache (an MLA latent is gathered whole)."""
        b = tuple(self.ctx.batch_axes) or None
        seq = (tuple(self.ctx.decode_seq_axes)
               if self.ctx.decode_seq_axes and seq_kept else None)
        h = self.ctx.tp_axis if heads else None
        return {"k": (b, h, seq, None), "v": (b, h, seq, None),
                "xk": (b, h, None, None), "xv": (b, h, None, None),
                "c": (b, None, None), "rope": (b, None, None),
                "ssm": (b, h, None, None), "conv": (b, None, h),
                "slot_pos": (seq,)}[name]

    def _store(self, entry: dict, seq_kept: bool,
               heads: bool = False) -> dict:
        """A cache entry computed in :meth:`_layout` at its ``cache_specs``
        placements (unchanged off a ``DeviceMesh``)."""
        if not self._placed:
            return entry
        ctx, out = self.ctx, {}
        for name, t in entry.items():
            have = self._layout(name, seq_kept, heads)
            shape = list(t.shape)
            for d, axes in enumerate(have):
                for a in shardings.spec_axes(axes):
                    shape[d] *= ctx.size(a)
            # the global entry's shape alone (a broadcast of one element:
            # no storage, which a count would take for a live tensor)
            spec = shardings.cache_specs(
                {name: torch.empty((), device="meta").expand(shape)},
                ctx.mesh, self.cfg, seq_axes=ctx.decode_seq_axes,
                tp=ctx.tp_axis)[name]
            out[name] = shardings.distribute(t, ctx.mesh, spec, have)
        return out

    def _kv_slice(self, mixer: dict, mode, full_kv: bool):
        """(the attention weights, the KV heads its queries read) of a
        mixer run as ``mode``: under "kv_slice" the rank's KV head, its
        columns of ``wk`` and ``wv`` sliced, or with ``full_kv`` every
        head's K/V computed (the cache's) and the slice attended over."""
        if mode != "kv_slice":
            return mixer, None
        cfg = self.cfg
        r = self.ctx.rank(self.ctx.tp_axis)
        if full_kv:
            return mixer, tp_lib.kv_heads(r, self._tp, cfg.num_heads,
                                          cfg.num_kv_heads)
        cols = tp_lib.kv_cols(r, self._tp, cfg.num_heads, cfg.num_kv_heads,
                              cfg.head_dim)
        return {**mixer, "wk": mixer["wk"][:, cols],
                "wv": mixer["wv"][:, cols]}, None

class LM(Sharded):
    """Decoder-only LM with its weights.

    ``seed`` seeds the ``torch.Generator`` (on ``device``) that draws the
    weights; ``device`` defaults to the card and raises without one
    (``"meta"`` gives the shapes alone). ``ctx`` is the sharding context
    (:class:`ShardCtx`); ``build_model`` puts the weights at its
    placements.
    """

    def __init__(self, cfg: ModelConfig, device="cuda", seed: int = 0,
                 ctx: Optional[ShardCtx] = None):
        super().__init__()
        dev = model_device(device)
        gen = seeded_generator(dev, seed)
        self.cfg = cfg
        self.ctx = ctx or ShardCtx()
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
    def _mlp_part(self, spec: LayerSpec, ln2, mlp, x, sg=None,
                  length: int = 0):
        if spec.mlp == "none":
            return x
        h2 = rms_norm(x, ln2, self.cfg.norm_eps)
        if spec.mlp == "moe":
            return x + moe.moe_apply(mlp, h2, self.cfg, self.ctx, seq=sg,
                                     length=length)
        return x + self._ffn(mlp, h2, spec, sg, length)

    def _layer_apply(self, spec: LayerSpec, p, x, positions,
                     collect: bool = False):
        """One layer on its parameters ``p`` (``remat.unit_params`` of its
        Block, to compute with: :meth:`_compute`): (x, its cache entry
        with ``collect``, else None). Under sequence parallelism x is the
        rank's block of the stream: the norms run on it, and each block
        gathers the sequence (:meth:`_enter`) and hands back its block
        (:meth:`_leave`); the cache entry is the whole sequence's."""
        cfg = self.cfg
        length = positions.shape[1]
        sg = self._seq_group(length)
        mode = self._plan(spec).mixer
        g = self._tp_group() if mode else None
        h = self._enter(rms_norm(x, p["ln1"], cfg.norm_eps), g, sg, length)
        entry = None
        if spec.mixer == "mamba":
            if collect:
                m, (ssm_s, conv_s) = ssm.mamba_apply(
                    p["mixer"], h, cfg, return_state=True, norm_group=g)
                entry = {"ssm": ssm_s, "conv": conv_s}
            else:
                m = ssm.mamba_apply(p["mixer"], h, cfg, norm_group=g)
        elif spec.mixer == "mla":
            m, (c, kr) = mla.mla_apply(p["mixer"], h, cfg, positions)
            entry = {"c": c, "rope": kr} if collect else None
        else:
            mixer, kvh = self._kv_slice(p["mixer"], mode, collect)
            if collect:
                m, (k, v) = attn.attn_apply(mixer, h, cfg, positions,
                                            return_kv=True, kv_heads=kvh)
                entry = {"k": k.transpose(1, 2), "v": v.transpose(1, 2)}
            else:
                m = attn.attn_apply(mixer, h, cfg, positions, kv_heads=kvh)
        m = self._leave(m, g, sg)
        x = self._mlp_part(spec, p.get("ln2"), p.get("mlp"), x + m, sg,
                           length)
        return x, entry

    def _block_apply(self, blk: Block, x, positions, collect: bool = False):
        """One layer on the weights ``blk`` holds now."""
        seq = self._seq_group(positions.shape[1]) is not None
        return self._layer_apply(blk.spec, self._params(blk, seq=seq), x,
                                 positions, collect)

    def _unit(self, x, params, positions):
        """One repeat of the pattern (the reference's scan body) on its
        layers' parameters ``params`` (``remat.unit_params``), gathered
        here: inside the checkpoint, so the backward gathers again."""
        seq = self._seq_group(positions.shape[1]) is not None
        for spec, p in zip(self.cfg.pattern, params):
            x, _ = self._layer_apply(spec, self._compute(p, spec, seq), x,
                                     positions)
        return x

    def _positions(self, B: int, S: int):
        return torch.arange(S, device=self.device).expand(B, S)

    def _embed(self, tokens, extra_embeds, emb=None, sg=None):
        """Token embeddings (``emb``: the table to compute with, else the
        module's) with ``extra_embeds`` prepended; under sequence
        parallelism (``sg``) the rank's block of their sequence: the
        vocab-parallel lookup's partials reduce-scattered, else the whole
        embeddings split."""
        table = self.embed if emb is None else emb
        if sg is not None and extra_embeds is None and self._vocab_local:
            start = self.logits_shard()[0]
            return collectives.reduce_scatter(
                embed_lookup(table, tokens, self.cfg, (start, None)), 1, sg)
        x = self._lookup(table, tokens)
        if extra_embeds is not None:
            x = torch.cat([extra_embeds.to(x.dtype), x], dim=1)
        return collectives.split(x, 1, sg)

    def _stream(self, tokens, extra_embeds):
        """(this rank's rows of the tokens and ``extra_embeds``, the
        stream's length, its sequence group: :meth:`_seq_group`)."""
        tokens, extra_embeds = self.rows(tokens), self.rows(extra_embeds)
        length = tokens.shape[1] + (0 if extra_embeds is None
                                    else extra_embeds.shape[1])
        return tokens, extra_embeds, length, self._seq_group(length)

    def forward(self, tokens, extra_embeds=None, rows=None):
        """:meth:`apply` (the call ``torch.func.functional_call`` makes)."""
        return self.apply(tokens, extra_embeds=extra_embeds, rows=rows)

    def apply(self, tokens, *, extra_embeds=None, rows=None):
        """tokens: (B, S_text) -> logits (B, S, padded_vocab); S counts the
        ``extra_embeds`` (B, Np, d) prepended to the tokens' embeddings.
        Each unit runs under ``remat.checkpointed`` (``cfg.remat``). With
        ``rows`` (by default: when the forward is differentiated) the
        logits are this rank's rows of the batch (:meth:`rows`) and its
        vocab columns where the vocab runs by rank (:meth:`logits_shard`),
        else the global logits (:meth:`_logits`)."""
        cfg = self.cfg
        if rows is None:
            rows = self._differentiated(extra_embeds)
        tokens, extra_embeds, length, sg = self._stream(tokens, extra_embeds)
        emb, final_norm = self._top(sg is not None)
        x = self._embed(tokens, extra_embeds, emb, sg)
        positions = self._positions(tokens.shape[0], length)
        layers = list(self.layers)
        if cfg.first_layer_dense:
            x, _ = self._block_apply(layers.pop(0), x, positions)
        P, policy = cfg.pattern_len, cfg.remat_policy if cfg.remat else None
        for i in range(0, len(layers), P):
            # read here, inside functional_call: the state's tensors
            params = [remat.unit_params(blk) for blk in layers[i:i + P]]
            x = remat.checkpointed(self._unit, x, params, positions,
                                   policy=policy)
        return self._logits(self._out(emb, final_norm, x, sg, length), rows)

    # ------------------------------------------------------------- serving
    def cache_init(self, batch: int, cache_len: int, dtype=None) -> dict:
        """Empty cache sized for ``cache_len`` slots (SWA archs: pass
        window), at ``cache_specs``' placements under a context on a
        ``DeviceMesh`` (``batch`` is the global batch)."""
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

        cache = {"layers": [one(blk) for blk in self.layers],
                 "slot_pos": torch.full((cache_len,), -1, dtype=torch.int32,
                                        device=self.device),
                 "pos": 0}
        if not self._placed:
            return cache
        ctx = self.ctx
        return shardings.place_cache(cache, ctx.mesh, shardings.cache_specs(
            cache, ctx.mesh, cfg, seq_axes=ctx.decode_seq_axes,
            tp=ctx.tp_axis))

    def _seq_route(self):
        """(sharded, group) of the sequence-sharded decode: whether
        attention decodes through each shard's partial, and the group
        that combines them (None at size 1)."""
        ctx = self.ctx
        if not ctx.decode_seq_axes or ctx.mesh is None:
            return False, None
        return True, ctx.group(ctx.wide(ctx.decode_seq_axes))

    def _block_decode(self, blk: Block, c: dict, x, slot_pos, local_sp,
                      pos: int, slot: int, lslot: Optional[int], route):
        """One layer's decode step. ``slot_pos`` is the cache's stored
        slot table and ``local_sp`` this rank's shard of it (the table
        itself unless ``decode_seq_axes`` shards it), ``slot`` the token's
        slot, ``lslot`` its index in this rank's sequence shard (None where
        another shard holds it) and ``route`` :meth:`_seq_route`'s."""
        cfg = self.cfg
        mode = self._plan(blk.spec).mixer
        g = self._tp_group() if mode else None
        if self._placed:
            p = self._params(blk)
            ln1, mixer, ln2, mlp = p["ln1"], p["mixer"], p.get("ln2"), \
                p.get("mlp")
            keep = {k: self._layout(k, True, mode == "heads") for k in c}
            ce = {k: shardings.gather(v, keep[k]) for k, v in c.items()}
        else:   # the block's own modules: no per-step gathering
            ln1, mixer = blk.ln1, blk.mixer
            ln2, mlp = getattr(blk, "ln2", None), getattr(blk, "mlp", None)
            keep, ce = None, c
        h = rms_norm(x, ln1, cfg.norm_eps)
        if blk.spec.mixer == "mamba":
            m, _ = ssm.mamba_decode(mixer, h, cfg, ce["ssm"], ce["conv"],
                                    norm_group=g)
        elif blk.spec.mixer == "mla":
            cl, kr = mla.latent(mixer, h, cfg,
                                torch.full((x.shape[0], 1), pos,
                                           device=x.device))
            # the latent is gathered over the sequence: the global slot
            ce["c"][:, slot] = cl[:, 0].to(ce["c"].dtype)
            ce["rope"][:, slot] = kr[:, 0, 0].to(ce["rope"].dtype)
            m = mla.mla_decode(mixer, h, cfg, ce["c"], ce["rope"],
                               shardings.gather(slot_pos), pos)
        else:
            mixer, kvh = self._kv_slice(mixer, mode, True)
            m = attn.attn_decode_step(mixer, h, cfg, ce, local_sp, pos, lslot,
                                      seq_sharded=route[0],
                                      seq_group=route[1], kv_heads=kvh)
        m = collectives.all_reduce(m, g)
        if keep:
            for k in c:
                shardings.write_back(c[k], ce[k], keep[k])
        return self._mlp_part(blk.spec, ln2, mlp, x + m)

    def decode_step(self, cache: dict, tokens):
        """One decode step. tokens: (B, 1). Returns (logits (B, 1, V),
        a DTensor on a ``DeviceMesh`` (:meth:`_logits`), cache), the cache
        updated in place."""
        cfg = self.cfg
        pos = cache["pos"]
        cache_len = cache["slot_pos"].shape[0]
        if cfg.window is not None:
            slot = pos % cache_len                # SWA ring buffer
        else:
            # full attention: append (caller sizes the cache; clamp is a guard)
            slot = min(pos, cache_len - 1)
        slot_pos = cache["slot_pos"]
        local_sp = _local(slot_pos)
        # the token's index in this rank's sequence shard of the cache
        n = local_sp.shape[0]
        first = self.ctx.rank(self.ctx.wide(self.ctx.decode_seq_axes)) * n
        lslot = slot - first if first <= slot < first + n else None
        if lslot is not None:
            local_sp[lslot] = pos
        emb, final_norm = self._top()
        x = self._lookup(emb, self.rows(tokens))
        route = self._seq_route()
        for blk, c in zip(self.layers, cache["layers"]):
            x = self._block_decode(blk, c, x, slot_pos, local_sp, pos, slot,
                                   lslot, route)
        x = rms_norm(x, final_norm, cfg.norm_eps)
        logits = self._logits(self._head(emb, x), False)
        cache["pos"] = pos + 1
        return logits, cache

    def prefill(self, tokens, cache_len: Optional[int] = None, *,
                extra_embeds=None):
        """Forward pass that also builds a decode-ready cache in one pass;
        ``extra_embeds`` as in :meth:`apply`."""
        tokens, extra_embeds, S, sg = self._stream(tokens, extra_embeds)
        emb, final_norm = self._top(sg is not None)
        x = self._embed(tokens, extra_embeds, emb, sg)
        B = tokens.shape[0]
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
            layers.append(self._store(
                entry, False, self._plan(blk.spec).mixer == "heads"))
        logits = self._logits(self._out(emb, final_norm, x, sg, S), False)
        slot_pos = _prefill_slot_pos(S, cache_len, self.device)
        cache = {"layers": layers,
                 "slot_pos": self._store({"slot_pos": slot_pos},
                                         False)["slot_pos"],
                 "pos": S}
        return logits, cache


def _local(t):
    """The tensor a DTensor holds on this rank (a plain tensor as it is)."""
    return t.to_local() if hasattr(t, "to_local") else t
