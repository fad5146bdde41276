"""Head-parallel compute on the TP axis: which blocks of a layer run on
their rank, and every rank's body in one process.

The JAX package partitions its compute over the "model" axis
(``launch/shardings.py``): attention heads, FFN hidden columns, the vocab
and the SSD heads are sharded there, the output projections by rows, and
XLA runs each block's shard on its TP rank and joins the partial outputs
with a psum. The port does the same by hand (Megatron's pair,
``launch/collectives.py``): a block's input, the same on every TP rank,
enters through ``reduce_grad`` (f: its gradient summed over the ranks),
the rank computes its heads or columns on its weight shards, and an
``all_reduce`` (g) sums the partial outputs.

Whether a block runs on its rank is decided by shape alone, as the
reference's ``_div`` decides a spec:

* attention: its query heads divide the TP size, and either its KV heads
  do too (each rank its KV heads: ``"heads"``) or the TP size is a
  multiple of them (``"kv_slice"``: each rank the one KV head its query
  heads read; ``wk`` and ``wv`` are gathered over TP and the rank's
  columns sliced, as Megatron does, and the cache keeps every KV head
  replicated, as ``cache_specs`` places it);
* MLA: its heads divide the TP size (``"heads"``; the latent and its cache
  stay whole);
* Mamba2: its SSD heads divide the TP size and it has one group
  (``"heads"``; ``w_bc`` stays whole, the gated norm's rows are split);
* a dense MLP, or the MoE's shared experts: the hidden width divides the
  TP size;
* the vocab: the padded vocab divides the TP size (embedding rows, head
  columns, the logits' last dim, the vocab-parallel loss).

Anything else runs replicated, every rank computing the whole block on
gathered weights (the reference's docstring: "15 or 20 attention heads vs
tp=16 -> attention replicated"). At a TP size of 1 nothing runs by rank.

:func:`layer_ranks`, :func:`head_ranks` and :func:`xent_ranks` run every
TP rank's body of a layer, of the vocab-parallel head and of the loss in
one process, on whole weights cut as the placements cut them, and sum the
partials (and the gated norm's row totals) in rank order: what an
``all_reduce`` of two ranks gives bit for bit, since a sum of two terms
does not depend on their order. ``layer_ranks(..., seq=True)`` is the
layer under sequence parallelism (``ShardCtx.seq_axis``): each rank's
block of the sequence through the norms, the blocks joined (the gather),
the partials summed in rank order and cut into the ranks' blocks (the
reduce-scatter).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..configs.base import LayerSpec, ModelConfig
from ..kernels import rmsnorm as _rn
from ..launch import collectives, shardings
from ..launch.mesh import MeshShape
from . import attention as attn
from . import mla, moe, ssm
from .layers import lm_head, mlp_apply, rms_norm

__all__ = ["Plan", "attn_mode", "mixer_mode", "ffn_local", "vocab_local",
           "plan", "kv_heads", "kv_cols", "vocab_start", "rank_block",
           "seq_blocks", "layer_ranks", "head_ranks", "xent_ranks",
           "replicated_blocks"]


class Plan(NamedTuple):
    """What of one layer runs on its TP rank: ``mixer`` is "heads",
    "kv_slice" or None (replicated), ``mlp`` whether the dense MLP's (or
    the MoE's shared experts') hidden columns do."""
    mixer: Optional[str]
    mlp: bool


def attn_mode(hq: int, hkv: int, tp: int) -> Optional[str]:
    """The attention rule of the module docstring."""
    if tp <= 1 or hq % tp:
        return None
    if hkv % tp == 0:
        return "heads"
    return "kv_slice" if tp % hkv == 0 else None


def mixer_mode(cfg: ModelConfig, mixer: str, tp: int) -> Optional[str]:
    """How the mixer ``mixer`` ("attn", "mla", "mamba") runs at TP size
    ``tp``."""
    if tp <= 1:
        return None
    if mixer == "attn":
        return attn_mode(cfg.num_heads, cfg.num_kv_heads, tp)
    if mixer == "mla":
        return "heads" if cfg.num_heads % tp == 0 else None
    if mixer == "mamba":
        return ("heads" if cfg.ssm_heads % tp == 0 and cfg.ssm_groups == 1
                else None)
    raise ValueError(f"unknown mixer {mixer!r}")


def ffn_local(width: int, tp: int) -> bool:
    """Whether hidden columns of ``width`` run on their rank."""
    return tp > 1 and width > 0 and width % tp == 0


def vocab_local(cfg: ModelConfig, tp: int) -> bool:
    """Whether the vocab runs on its rank."""
    return tp > 1 and cfg.padded_vocab % tp == 0


def plan(cfg: ModelConfig, spec: LayerSpec, tp: int) -> Plan:
    """The :class:`Plan` of a layer ``spec`` at TP size ``tp``."""
    width = (cfg.d_ff if spec.mlp == "dense"
             else moe.shared_width(cfg) if spec.mlp == "moe" else 0)
    return Plan(mixer_mode(cfg, spec.mixer, tp), ffn_local(width, tp))


def replicated_blocks(cfg: ModelConfig, tp: int) -> list:
    """The kinds of block that run replicated at TP size ``tp`` (the dry
    run's record): "attn", "mla", "mamba", "mlp", "shared", "vocab"."""
    if tp <= 1:
        return []
    specs = list(cfg.pattern)
    if cfg.first_layer_dense:
        specs.append(LayerSpec(cfg.pattern[0].mixer, "dense"))
    out = set()
    for spec in specs:
        pl = plan(cfg, spec, tp)
        if pl.mixer is None:
            out.add(spec.mixer)
        if spec.mlp == "dense" and not pl.mlp:
            out.add("mlp")
        if spec.mlp == "moe" and cfg.num_shared_experts and not pl.mlp:
            out.add("shared")
    if cfg.is_encoder_decoder and plan(cfg, LayerSpec("attn", "dense"),
                                       tp).mixer is None:
        out.add("attn")
    if not vocab_local(cfg, tp):
        out.add("vocab")
    return sorted(out)


def kv_heads(rank: int, tp: int, hq: int, hkv: int) -> slice:
    """The KV heads that rank ``rank``'s query heads read under
    ``"kv_slice"`` (one: the TP size is a multiple of ``hkv``)."""
    group = hq // hkv
    first = rank * (hq // tp) // group
    return slice(first, first + 1)


def kv_cols(rank: int, tp: int, hq: int, hkv: int, hd: int) -> slice:
    """The columns of ``wk`` and ``wv`` of :func:`kv_heads`."""
    h = kv_heads(rank, tp, hq, hkv)
    return slice(h.start * hd, h.stop * hd)


def vocab_start(cfg: ModelConfig, rank: int, tp: int) -> int:
    """The first vocab row of rank ``rank``'s shard."""
    return rank * (cfg.padded_vocab // tp)


# ------------------------------------------------------- ranks in one process
def _tp_dim(name: str, shape, tp: int) -> Optional[int]:
    """The dim that the TP axis shards the leaf ``name`` over at TP size
    ``tp`` (``shardings.leaf_spec``'s rule), or None."""
    spec = shardings.leaf_spec(name, shape, MeshShape(("model",), (tp,)))
    return spec.index("model") if "model" in spec else None


def _cut(t: torch.Tensor, dim: int, rank: int, tp: int) -> torch.Tensor:
    """Rank ``rank``'s block of dim ``dim``, contiguous as a placed shard
    is (a product then reads the same memory layout)."""
    n = t.shape[dim] // tp
    return t.narrow(dim, rank * n, n).contiguous()


def rank_block(p: dict, mode: str, rank: int, tp: int, cfg: ModelConfig,
               *, full_kv: bool = False) -> dict:
    """Rank ``rank``'s weights of a block run by rank (``mode`` "heads",
    "kv_slice" or "mlp"), cut from the whole ``p`` as the placements cut
    them; a leaf without a TP dim stays whole. Under "kv_slice", ``wk``
    and ``wv`` are the rank's KV head's columns, or whole with
    ``full_kv`` (the cache's K and V)."""
    out = {}
    for k, v in p.items():
        dim = _tp_dim(k, v.shape, tp)
        if mode == "kv_slice" and k in ("wk", "wv"):
            out[k] = v if full_kv else v[:, kv_cols(
                rank, tp, cfg.num_heads, cfg.num_kv_heads,
                cfg.head_dim)].contiguous()
        elif dim is not None:
            out[k] = _cut(v, dim, rank, tp)
        else:
            out[k] = v
    return out


def _sum(parts):
    total = None
    for part in parts:
        total = part if total is None else total + part
    return total


class _SplitRanks(torch.autograd.Function):
    """Every rank's split-row norm in one process: the ranks' columns x_r
    and scales w_r as (x_0, w_0, x_1, w_1, ...), their row totals summed
    in rank order between the two launches of each pass, as
    ``rmsnorm.rmsnorm_split``'s ``all_reduce`` sums them."""

    @staticmethod
    def forward(ctx, n, eps, *xw):
        ss = _sum(_rn.row_stat(x) for x in xw[0::2])
        ctx.save_for_backward(ss, *xw)
        ctx.n, ctx.eps = n, eps
        return tuple(_rn.rmsnorm_rows(x, w, ss, n, eps=eps)
                     for x, w in zip(xw[0::2], xw[1::2]))

    @staticmethod
    def backward(ctx, *dys):
        ss, *xw = ctx.saved_tensors
        dys = [dy.contiguous() for dy in dys]
        pairs = list(zip(xw[0::2], xw[1::2], dys))
        dot = _sum(_rn.row_stat(x, w, dy) for x, w, dy in pairs)
        grads = []
        for x, w, dy in pairs:
            grads.extend(_rn.rmsnorm_rows_bwd(x, w, dy, ss, dot, ctx.n,
                                              eps=ctx.eps))
        return (None, None, *grads)


def _mixer_ranks(spec: LayerSpec, p: dict, h, cfg: ModelConfig, positions,
                 tp: int, mode: str):
    """Every rank's partial of the mixer on h, summed in rank order."""
    blocks = [rank_block(p, mode, r, tp, cfg) for r in range(tp)]
    if spec.mixer == "attn":
        return _sum(attn.attn_apply(b, h, cfg, positions) for b in blocks)
    if spec.mixer == "mla":
        return _sum(mla.mla_apply(b, h, cfg, positions)[0] for b in blocks)
    gs = [ssm.gated(b, h, cfg)[0] for b in blocks]
    normed = _SplitRanks.apply(cfg.ssm_inner, cfg.norm_eps,
                               *(t for g, b in zip(gs, blocks)
                                 for t in (g, b["ssm_norm"])))
    return _sum(y @ b["w_out"] for y, b in zip(normed, blocks))


def seq_blocks(t, tp: int) -> list:
    """The TP ranks' blocks of t's sequence (dim 1) under sequence
    parallelism: ``collectives.seq_block`` rows each, the last zero-padded,
    contiguous as a reduce-scatter's output is."""
    S = t.shape[1]
    c = collectives.seq_block(S, tp)
    if c * tp > S:
        t = torch.cat([t, t.new_zeros((t.shape[0], c * tp - S,
                                       *t.shape[2:]))], 1)
    return [b.contiguous() for b in t.split(c, 1)]


def _joined(blocks: list, length: int):
    """The sequence of the ranks' ``blocks`` (the gather), cut to
    ``length``."""
    return torch.cat(blocks, 1)[:, :length]


def layer_ranks(spec: LayerSpec, p: dict, x, cfg: ModelConfig, positions,
                tp: int, *, data: int = 1, seq: bool = False):
    """One layer (``spec``, its whole parameters ``p`` as
    ``remat.unit_params`` gives them) on x (B, S, d) with every TP rank's
    body in one process: the norms on every rank, each block that
    :func:`plan` runs by rank as each rank's partial, the partials summed
    in rank order; a replicated block as one rank computes it. ``data``:
    the MoE's token split (``moe.moe_ranks``). With ``seq`` (sequence
    parallelism, ``tp`` > 1) each norm runs on each rank's block of the
    sequence (:func:`seq_blocks`) and the blocks are joined: the residual
    adds are elementwise, so the rest is the same arithmetic."""
    S = x.shape[1]

    def normed(t, w):
        if not seq or tp == 1:
            return rms_norm(t, w, cfg.norm_eps)
        return _joined([rms_norm(b, w, cfg.norm_eps)
                        for b in seq_blocks(t, tp)], S)
    pl = plan(cfg, spec, tp)
    h = normed(x, p["ln1"])
    if pl.mixer is not None:
        m = _mixer_ranks(spec, p["mixer"], h, cfg, positions, tp, pl.mixer)
    elif spec.mixer == "attn":
        m = attn.attn_apply(p["mixer"], h, cfg, positions)
    elif spec.mixer == "mla":
        m = mla.mla_apply(p["mixer"], h, cfg, positions)[0]
    else:
        m = ssm.mamba_apply(p["mixer"], h, cfg)
    x = x + m
    if spec.mlp == "none":
        return x
    h2 = normed(x, p["ln2"])
    if spec.mlp == "moe":
        return x + moe.moe_ranks(p["mlp"], h2, cfg, tp=tp, data=data,
                                 shared_tp=pl.mlp)
    if pl.mlp:
        return x + _sum(mlp_apply(rank_block(p["mlp"], "mlp", r, tp, cfg),
                                  h2, cfg.mlp_act) for r in range(tp))
    return x + mlp_apply(p["mlp"], h2, cfg.mlp_act)


def head_ranks(emb: dict, x, cfg: ModelConfig, tp: int) -> list:
    """Every TP rank's vocab shard of the logits of x (..., d), the head's
    columns cut as the placements cut them (in rank order)."""
    return [lm_head({"head": _cut(emb["head"], 1, r, tp)}, x, cfg)
            for r in range(tp)]


def xent_ranks(parts: list, labels, cfg: ModelConfig):
    """The vocab-parallel loss (``train.loss.softmax_xent``) of every
    rank's logit shard ``parts`` in one process: (mean loss, metrics), the
    max over the shards, the sums of exponentials and the picked logits
    added in rank order."""
    from ..train import loss as loss_mod
    n = parts[0].shape[-1]
    pieces = [loss_mod.vocab_pieces(lf, r * n, cfg.vocab_size)
              for r, lf in enumerate(loss_mod.widened(p) for p in parts)]
    lmax = pieces[0].lmax
    for pc in pieces[1:]:
        lmax = torch.maximum(lmax, pc.lmax)
    sums = [loss_mod.shard_sums(pc, lmax, labels) for pc in pieces]
    sumexp = _sum(s[0] for s in sums)
    picked = _sum(s[1] for s in sums)
    arg = None
    for pc in pieces:
        a = loss_mod.shard_argmax(pc, lmax)
        arg = a if arg is None else torch.minimum(arg, a)
    return loss_mod.finish(lmax, sumexp, picked, arg, labels)
