"""The H100 roofline and the count of a step's work (the JAX package's
``launch/roofline.py``).

The reference parses the compiled HLO text (``analyze_hlo``) to count a
step's FLOPs, HBM bytes and collective bytes. That function reads XLA text
and has no torch twin: the port counts its own step as it runs, on
``meta`` tensors (no storage), under :func:`counting`:

* FLOPs: the matrix products of the aten ops (the registry of
  ``torch.utils.flop_counter``, as the reference counts only dots), plus
  each hand-written kernel's own count, which its wrapper's meta branch
  records (:func:`record_kernel`) from the formulas below;
* HBM bytes: every aten op reads its tensor inputs and writes its outputs
  once, since eager PyTorch materialises every op; views, metadata ops and
  ``empty`` allocations count 0; a kernel counts its own bytes;
* collective bytes per chip: the reference's ring model by op type and
  group size (:func:`wire_bytes`), recorded by ``launch/collectives.py``
  where the port issues each collective;
* the peak of live tensors: the storages that ops allocate and the ones
  the caller registers (the state), freed when their last reference goes.

The per-chip terms then go through :func:`roofline_terms` at the rates of
:data:`HW`, an NVIDIA H100 80GB HBM3 at 700 W. Every rate there is a
datasheet figure, not a measurement, and every term is a bound.

Each kernel's FLOP and byte formulas live here once (:func:`rmsnorm_work`,
:func:`attention_work`, ...): the meta branches record them and
``chip_smoke.py`` computes its bounds from them.

:func:`count_params` and :func:`model_flops` are the reference's, line by
line: plain Python over the config.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import torch

__all__ = ["HW", "HBM_BYTES_PER_S", "BF16_OPS_PER_S", "TF32_OPS_PER_S",
           "FP32_OPS_PER_S", "F32_SPLIT_OPS_PER_S", "SFU_OPS_PER_S",
           "NODE_SIZE", "Count",
           "counting", "active", "record_kernel", "record_collective",
           "track", "wire_bytes", "crosses_nodes", "roofline_terms",
           "count_params", "model_flops", "bound", "tensor_peak",
           "rmsnorm_work", "rmsnorm_bwd_work", "rmsnorm_stat_work",
           "rmsnorm_split_work", "rmsnorm_split_bwd_work", "attention_pairs",
           "attention_work", "attention_bwd_work", "decode_work",
           "decode_partial_work", "ssd_work", "ssd_bwd_work"]

# NVIDIA H100 SXM5 80GB HBM3 data sheet, at its 700 W maximum power and
# 1.98 GHz boost clock: dense tensor-core bf16 and TF32, FP32 outside the
# tensor cores, device memory; NVLink 4 gives 900 GB/s a card both ways
# (450 GB/s one way, the reference's "one link direction"), and a DGX H100
# node gives each of its 8 cards one ConnectX-7 port of 400 Gb/s (50 GB/s)
# to the network between nodes
HBM_BYTES_PER_S = 3.35e12
BF16_OPS_PER_S = 989e12
TF32_OPS_PER_S = 494.7e12
FP32_OPS_PER_S = 67e12
# the special function units: 16 results a clock an SM on compute
# capability 9.0, 132 SMs
SFU_OPS_PER_S = 132 * 16 * 1.98e9
# float32 products on the tensor cores as three products of split operands
# (the float32 attention and SSD kernels): a third of the bf16 rate
F32_SPLIT_OPS_PER_S = BF16_OPS_PER_S / 3
NODE_SIZE = 8

HW = {
    "name": "NVIDIA H100 80GB HBM3",
    "power_limit_w": 700.0,
    "source": "NVIDIA H100 Tensor Core GPU data sheet (SXM5), datasheet "
              "rates, not measurements",
    "peak_flops": BF16_OPS_PER_S,      # dense bf16 per card
    "hbm_bw": HBM_BYTES_PER_S,         # bytes/s per card
    "ici_bw": 450e9,                   # NVLink within a node, one way
    "dcn_bw": 50e9,                    # network between nodes, per card
    "node_size": NODE_SIZE,
    "tf32_flops": TF32_OPS_PER_S,
    "fp32_flops": FP32_OPS_PER_S,
}


# ------------------------------------------------------------- the count
@dataclass
class Count:
    """A step's work on one chip (the reference's ``HloStats`` keys, plus
    the kernels' share and the peak of live tensors)."""

    flops: float = 0.0
    hbm_bytes: float = 0.0
    ici_bytes: float = 0.0
    dcn_bytes: float = 0.0
    collective_counts: Dict[str, int] = field(default_factory=dict)
    collective_bytes_by_type: Dict[str, float] = field(default_factory=dict)
    kernels: Dict[str, dict] = field(default_factory=dict)
    notes: List[str] = field(default_factory=list)
    peak_bytes: float = 0.0
    # every collective in order: (kind, size, the group's global ranks);
    # not in the record (to_dict), read by tests of what crosses an axis
    log: List[Tuple[str, float, Tuple[int, ...]]] = field(
        default_factory=list)

    def to_dict(self) -> dict:
        return {k: getattr(self, k) for k in
                ("flops", "hbm_bytes", "ici_bytes", "dcn_bytes",
                 "collective_counts", "collective_bytes_by_type", "kernels",
                 "notes")}


_ACTIVE: List["_Counter"] = []


def active() -> Optional["_Counter"]:
    """The innermost :func:`counting` in progress, or None."""
    return _ACTIVE[-1] if _ACTIVE else None


def record_kernel(name: str, flops: float, nbytes: float) -> None:
    """Add one launch of the kernel ``name`` to the active count (a no-op
    without one)."""
    c = active()
    if c is None:
        return
    c.count.flops += flops
    c.count.hbm_bytes += nbytes
    k = c.count.kernels.setdefault(name, {"calls": 0, "flops": 0.0,
                                          "bytes": 0.0})
    k["calls"] += 1
    k["flops"] += flops
    k["bytes"] += nbytes


def wire_bytes(kind: str, size: float, g: int) -> float:
    """Bytes one chip sends for a collective over a group of ``g`` (the
    reference's ring model; ``size`` the output's bytes, for a reduce-
    scatter its input's)."""
    if g <= 1:
        return 0.0
    if kind == "all-reduce":
        return 2.0 * (g - 1) / g * size
    if kind in ("all-gather", "all-to-all", "reduce-scatter"):
        return (g - 1) / g * size
    return float(size)   # collective-permute


def crosses_nodes(ranks) -> bool:
    """A group crosses nodes when its global ranks span ``NODE_SIZE`` or
    more (the reference's rule spans 256 ids: a TPU pod)."""
    ranks = list(ranks)
    return bool(ranks) and max(ranks) - min(ranks) >= NODE_SIZE


def record_collective(kind: str, size: float, ranks) -> None:
    """Add one collective of ``kind`` over the group of global ``ranks``
    to the active count; ``size`` as in :func:`wire_bytes`."""
    c = active()
    if c is None:
        return
    ranks = list(ranks)
    wire = wire_bytes(kind, size, len(ranks))
    cnt = c.count
    cnt.log.append((kind, float(size), tuple(ranks)))
    cnt.collective_counts[kind] = cnt.collective_counts.get(kind, 0) + 1
    cnt.collective_bytes_by_type[kind] = (
        cnt.collective_bytes_by_type.get(kind, 0.0) + wire)
    if crosses_nodes(ranks):
        cnt.dcn_bytes += wire
    else:
        cnt.ici_bytes += wire


def _local(t):
    return t._local_tensor if hasattr(t, "_local_tensor") else t


def _nbytes(t) -> int:
    t = _local(t)
    return t.numel() * t.element_size()


# allocations that write nothing, and ops that only rename storage
_NO_TRAFFIC = {"empty", "empty_like", "empty_strided", "new_empty",
               "new_empty_strided", "_unsafe_view", "_reshape_alias",
               "lift_fresh", "detach", "alias", "set_", "resize_",
               "_local_scalar_dense", "sym_size", "sym_stride", "sym_numel",
               "sym_storage_offset"}


def _tensors(x, out: list) -> list:
    """The tensors of an op's arguments or results (lists, tuples, dicts)."""
    if isinstance(x, torch.Tensor):
        out.append(x)
    elif isinstance(x, (list, tuple)):
        for v in x:
            _tensors(v, out)
    elif isinstance(x, dict):
        for v in x.values():
            _tensors(v, out)
    return out


class _Counter:
    """The dispatch mode behind :func:`counting` (built lazily: the
    module imports no dispatch machinery until a count starts)."""

    def __init__(self):
        from torch.utils._python_dispatch import TorchDispatchMode
        from torch.utils._pytree import tree_map
        from torch.utils.flop_counter import flop_registry
        self.count = Count()
        # live storages: a weak reference's handle (``_weak_ref``) -> bytes
        self._live: dict = {}
        self._live_bytes = 0
        counter = self

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                kwargs = kwargs or {}
                out = func(*args, **kwargs)
                counter._op(func, args, kwargs, out, tree_map, flop_registry)
                return out

        self.mode = Mode()

    def _op(self, func, args, kwargs, out, tree_map, registry):
        packet = func.overloadpacket
        if packet in registry:
            loc = tree_map(_local, (args, kwargs, out))
            self.count.flops += registry[packet](*loc[0], **loc[1],
                                                 out_val=loc[2])
        outs = _tensors(out, [])
        for t in outs:
            self.track(t)
        if func.is_view or packet.__name__ in _NO_TRAFFIC:
            return
        ins = _tensors(kwargs, _tensors(args, []))
        self.count.hbm_bytes += sum(_nbytes(t) for t in (*ins, *outs))

    def track(self, t) -> None:
        """Count ``t``'s storage as live until its last reference goes."""
        st = _local(t).untyped_storage()
        ref = st._weak_ref()
        if ref in self._live:
            torch.UntypedStorage._free_weak_ref(ref)
            return
        n = st.nbytes()
        self._live[ref] = n
        self._live_bytes += n
        if self._live_bytes > self.count.peak_bytes:
            # the sum counts storages freed since the last sweep: a new
            # peak is only one once they are taken out
            self._sweep()
            self.count.peak_bytes = max(self.count.peak_bytes,
                                        self._live_bytes)

    def _sweep(self, everything: bool = False) -> None:
        expired = torch.UntypedStorage._expired
        gone = list(self._live) if everything else [
            k for k in self._live if expired(k)]
        for k in gone:
            self._live_bytes -= self._live.pop(k)
            torch.UntypedStorage._free_weak_ref(k)


@contextlib.contextmanager
def counting():
    """Count the aten ops, kernels and collectives run inside: yields the
    :class:`Count`, filled when the block ends (its ``peak_bytes`` counts
    from the tensors :func:`track` registers and those made inside)."""
    c = _Counter()
    _ACTIVE.append(c)
    try:
        with c.mode:
            yield c.count
    finally:
        _ACTIVE.remove(c)
        c._sweep(everything=True)


def track(tree) -> None:
    """Register the tensors of ``tree`` (dicts, lists, tuples) as live in
    the active count: the state a step starts from."""
    c = active()
    if c is None:
        return
    from torch.utils._pytree import tree_flatten
    for t in tree_flatten(tree)[0]:
        if isinstance(t, torch.Tensor):
            c.track(t)


# ----------------------------------------------------------------- terms
def roofline_terms(stats, chips: int) -> dict:
    """The reference's terms of a count (``Count`` or any object with its
    four totals), in seconds per chip at :data:`HW`'s rates; ``ici_s`` is
    NVLink within a node, ``dcn_s`` the network between nodes."""
    compute_s = stats.flops / HW["peak_flops"]
    memory_s = stats.hbm_bytes / HW["hbm_bw"]
    ici_s = stats.ici_bytes / HW["ici_bw"]
    dcn_s = stats.dcn_bytes / HW["dcn_bw"]
    coll_s = ici_s + dcn_s
    terms = {"compute_s": compute_s, "memory_s": memory_s,
             "collective_s": coll_s, "ici_s": ici_s, "dcn_s": dcn_s}
    dom = max(("compute_s", "memory_s", "collective_s"), key=lambda k: terms[k])
    bound_s = max(terms["compute_s"], terms["memory_s"], terms["collective_s"])
    terms["dominant"] = dom
    terms["step_lower_bound_s"] = bound_s
    terms["roofline_fraction"] = compute_s / bound_s if bound_s > 0 else 0.0
    terms["chips"] = chips
    return terms


# ----------------------------------------------------------- model flops
def count_params(cfg) -> Tuple[float, float]:
    """(total, active) parameter counts from the config (analytic)."""
    d = cfg.d_model
    emb = cfg.padded_vocab * d * 2
    per_attn = (d * cfg.num_heads * cfg.head_dim
                + 2 * d * cfg.num_kv_heads * cfg.head_dim
                + cfg.num_heads * cfg.head_dim * d)
    if cfg.kv_lora_rank:
        nope, rd, vd, lora = (cfg.qk_nope_head_dim, cfg.qk_rope_head_dim,
                              cfg.v_head_dim, cfg.kv_lora_rank)
        per_attn = (d * cfg.num_heads * (nope + rd) + d * (lora + rd)
                    + lora * cfg.num_heads * (nope + vd)
                    + cfg.num_heads * vd * d)
    per_mamba = (3 * d * cfg.ssm_inner + d * 2 * cfg.ssm_groups * cfg.ssm_state
                 + d * cfg.ssm_heads) if cfg.ssm_state else 0.0
    mlp_mult = 3 if cfg.mlp_act == "swiglu" else 2
    n_attn = n_mamba = n_moe = n_dense = 0
    for _ in range(cfg.num_repeats):
        for s in cfg.pattern:
            n_attn += s.mixer in ("attn", "mla")
            n_mamba += s.mixer == "mamba"
            n_moe += s.mlp == "moe"
            n_dense += s.mlp == "dense"
    n_dense += 1 if cfg.first_layer_dense else 0
    n_attn += 1 if cfg.first_layer_dense else 0
    moe_ff = cfg.moe_d_ff or cfg.d_ff
    dense_mlp = n_dense * mlp_mult * d * cfg.d_ff
    moe_total = n_moe * (cfg.num_experts + cfg.num_shared_experts) * 3 * d * moe_ff
    moe_active = n_moe * (cfg.top_k + cfg.num_shared_experts) * 3 * d * moe_ff
    total = emb + n_attn * per_attn + n_mamba * per_mamba + dense_mlp + moe_total
    active = emb + n_attn * per_attn + n_mamba * per_mamba + dense_mlp + moe_active
    if cfg.is_encoder_decoder:
        enc = cfg.num_encoder_layers * (per_attn + mlp_mult * d * cfg.d_ff)
        cross = cfg.num_layers * per_attn
        total += enc + cross
        active += enc + cross
    return float(total), float(active)


def model_flops(cfg, shape) -> float:
    """Global useful FLOPs per step.

    Parameter term: 6*N_active*D (train) / 2*N_active*D (prefill) /
    2*N_active*B (decode). Mixer state term (not captured by N): attention
    score+value FLOPs (window/causal-aware), SSD chunk+state FLOPs — these
    are real useful work that grows with context, so they belong in the
    "useful" numerator when judging the counted step.
    """
    _, active = count_params(cfg)
    B, S = shape.global_batch, shape.seq_len
    D = B * S
    n_attn = n_mamba = 0
    for _ in range(cfg.num_repeats):
        for sp in cfg.pattern:
            n_attn += sp.mixer in ("attn", "mla")
            n_mamba += sp.mixer == "mamba"
    n_attn += 1 if cfg.first_layer_dense else 0
    hqhd = cfg.num_heads * (cfg.head_dim if not cfg.kv_lora_rank
                            else cfg.qk_nope_head_dim + cfg.qk_rope_head_dim)
    kv_span_full = min(S, cfg.window) if cfg.window else S

    if shape.kind == "decode":
        span = kv_span_full
        attn = n_attn * 4.0 * B * span * hqhd
        ssd = n_mamba * B * (4.0 * cfg.ssm_inner * cfg.ssm_state
                             + 2.0 * cfg.ssm_inner * cfg.ssm_state)
        param_term = 2.0 * active * B
        return param_term + attn + ssd

    # causal full attention averages S/2 keys per query; SWA averages window
    avg_span = kv_span_full / (1.0 if cfg.window else 2.0)
    attn_fwd = n_attn * 4.0 * D * avg_span * hqhd
    # SSD per token (per layer): chunk matmuls 2L(N+P) + state in/out 4PN,
    # times H heads => d_inner * (2L(N/P + 1) + 4N)
    L, N, Pd = cfg.ssd_chunk, cfg.ssm_state, cfg.ssm_head_dim
    ssd_fwd = (n_mamba * D * cfg.ssm_inner * (2.0 * L * (N / Pd + 1) + 4.0 * N)
               if cfg.ssm_state else 0.0)
    if cfg.is_encoder_decoder:
        F = cfg.encoder_seq
        attn_fwd += cfg.num_encoder_layers * 4.0 * B * F * F * hqhd  # enc self
        attn_fwd += cfg.num_layers * 4.0 * D * F * hqhd             # cross
    if shape.kind == "train":
        return 6.0 * active * D + 3.0 * (attn_fwd + ssd_fwd)
    return 2.0 * active * D + attn_fwd + ssd_fwd


# ------------------------------------------------------ kernel formulas
def bound(nbytes: float, ops: float, peak: float) -> Tuple[float, str]:
    """(seconds, bound_by): the larger of the bytes over the memory rate
    and the operations over ``peak``."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / peak
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def tensor_peak(esize: int) -> float:
    """The tensor-core rate of a kernel's products by storage size: bf16,
    or float32 as split planes."""
    return BF16_OPS_PER_S if esize == 2 else F32_SPLIT_OPS_PER_S


def rmsnorm_work(rows: int, D: int, esize: int) -> Tuple[float, float]:
    """(operations, bytes) of one RMSNorm: x read, y written, w read once;
    4 float32 operations an element, on the CUDA cores (FP32_OPS_PER_S)."""
    return 4.0 * rows * D, float(esize * (2 * rows * D + D))


def rmsnorm_bwd_work(rows: int, D: int, esize: int) -> Tuple[float, float]:
    """(operations, bytes) of the RMSNorm backward: x and dy read, dx
    written, w read and dw written; 10 float32 operations an element."""
    return 10.0 * rows * D, float(esize * (3 * rows * D + 2 * D))


def rmsnorm_stat_work(rows: int, D: int, esize: int,
                      dot: bool) -> Tuple[float, float]:
    """(operations, bytes) of a split row's partial sum over a rank's D
    columns: x read (and w and dy with ``dot``), one float32 a row
    written; 2 (3) float32 operations an element."""
    n_in = 2 if dot else 1
    return (3.0 if dot else 2.0) * rows * D, float(
        esize * (n_in * rows * D + (D if dot else 0)) + 4 * rows)


def rmsnorm_split_work(rows: int, D: int, esize: int) -> Tuple[float, float]:
    """(operations, bytes) of the split-row forward given the row totals:
    :func:`rmsnorm_work`'s, with the (rows,) float32 totals read."""
    ops, nbytes = rmsnorm_work(rows, D, esize)
    return ops - 2.0 * rows * D, nbytes + 4.0 * rows


def rmsnorm_split_bwd_work(rows: int, D: int,
                           esize: int) -> Tuple[float, float]:
    """(operations, bytes) of the split-row backward given both row
    totals: :func:`rmsnorm_bwd_work`'s, with two (rows,) float32 totals
    read."""
    ops, nbytes = rmsnorm_bwd_work(rows, D, esize)
    return ops - 4.0 * rows * D, nbytes + 8.0 * rows


def attention_pairs(Sq: int, Sk: int, causal: bool,
                    window: Optional[int]) -> int:
    """Live (query, key) pairs of one head under the masks."""
    if not causal:
        return Sq * Sk
    w = min(window if window is not None else Sk, Sq)
    # sum over q of min(q + 1, w)
    return w * (w + 1) // 2 + (Sq - w) * w


def attention_work(B, Hq, Hkv, Sq, Sk, D, Dv, causal, window,
                   esize) -> Tuple[float, float]:
    """(FLOPs, bytes) of one attention forward: q, k, v read and the
    output written once; S = QK^T over D and PV over Dv on the live
    pairs."""
    pairs = B * Hq * attention_pairs(Sq, Sk, causal, window)
    nbytes = esize * (B * Hq * Sq * (D + Dv) + B * Hkv * Sk * (D + Dv))
    return 2.0 * pairs * (D + Dv), float(nbytes)


def attention_bwd_work(B, Hq, Hkv, Sq, Sk, D, Dv, causal, window,
                       esize) -> Tuple[float, float]:
    """(FLOPs, bytes) of the attention backward: q, dO, o, k, v and the
    LSE read, dq, dk, dv written; five products (S and dK, dQ over D; dP
    and dV over Dv) on the live pairs."""
    pairs = B * Hq * attention_pairs(Sq, Sk, causal, window)
    nbytes = (esize * (B * Hq * Sq * (D + 2 * Dv) + B * Hkv * Sk * (D + Dv)
                       + B * Hq * Sq * D + B * Hkv * Sk * (D + Dv))
              + 4 * B * Hq * Sq)
    return 2.0 * pairs * (3 * D + 2 * Dv), float(nbytes)


def decode_work(B, Hkv, G, S, D, esize) -> Tuple[float, float]:
    """(FLOPs, bytes) of one decode: q read, the cache's k and v and the
    mask read once, the output written."""
    nbytes = esize * (2 * B * Hkv * G * D + 2 * B * Hkv * S * D) + S
    return 4.0 * B * Hkv * G * S * D, float(nbytes)


def decode_partial_work(B, Hkv, G, S, D, esize) -> Tuple[float, float]:
    """(FLOPs, bytes) of the partial mode on one shard of S slots: q, the
    shard's k, v and mask read, the float32 (m, l, acc) written."""
    nbytes = (esize * (B * Hkv * G * D + 2 * B * Hkv * S * D) + S
              + 4 * B * Hkv * G * (D + 2))
    return 4.0 * B * Hkv * G * S * D, float(nbytes)


def ssd_work(B, S, H, P, G, N, chunk, esize=2) -> Tuple[float, float]:
    """(FLOPs, bytes) of one SSD scan with its final state: x, B, C read
    and y written in the storage type, dt, A, D read and the state written
    in float32; per chunk of l rows and head, l (l + 1) / 2 (N + P) + 2 l
    N P multiply-adds over the causal half."""
    nbytes = (esize * (B * S * H * P + 2 * B * S * G * N + B * S * H * P)
              + 4 * B * S * H + 4 * 2 * H + 4 * B * H * P * N)
    L = min(chunk, S)
    full, tail = divmod(S, L)
    mads = sum(n * l * (l + 1) // 2 * (N + P) + n * 2 * l * N * P
               for n, l in ((full, L), (1 if tail else 0, tail)))
    return 2.0 * B * H * mads, float(nbytes)


def ssd_bwd_work(B, S, H, P, G, N, L, esize) -> Tuple[float, float]:
    """(FLOPs, bytes) of one SSD backward in chunks of L rows: x, B, C, dy
    read in the storage type, dt, A, D in float32, each gradient written
    once; per chunk and head, over the causal half of the L x L products,
    L^2 (3 N / 2 + P) multiply-adds and 5 L P N (the recomputed state,
    dx's and dB's terms from dS, C's from S, the dS update)."""
    nbytes = (esize * (3 * B * S * H * P + 4 * B * S * G * N)
              + 2 * 4 * B * S * H + 4 * 4 * H)
    full, tail = divmod(S, L)
    mads = sum(n * (l * l * (3 * N + 2 * P) // 2 + 5 * l * P * N)
               for n, l in ((full, L), (1 if tail else 0, tail)))
    return 2.0 * B * H * mads, float(nbytes)
