"""Wrapper of the CUDA kernel of the composed makespan and its reverse pass
(``csrc/compose.cu``).

:func:`compose_grads` returns, for each row of the stage moments ``smu``,
``svar`` (R, S), the loss ``mk_mu + lam mk_var`` of the makespan composed
over a ``StageDAG.structure`` and its cotangents in ``smu`` and ``svar``:
one launch where the eager composition and its autograd take ~1700 torch
operations a call at S = 32. The JAX package differentiates the same
composition inside its jitted solve; it has no Pallas kernel for it.

The dispatch is ``workflow/solve.py::_compose_grads``: a CUDA tensor comes
here and launches the kernel or raises; a CPU tensor runs the plain version
beside it, ``_compose_grads_plain`` (``compose_structure`` and
``torch.autograd.grad``). :func:`encode_arrays` turns a structure into the
kernel's plan on the host: the topological levels whose nodes the lanes
take at once, the fold edges, and each node's cotangent sources in the
order autograd adds them (:func:`_cotangent_sources`); :func:`encode`
uploads the plan once, as one int32 buffer, with its header and its shared
memory size (:func:`layout`); the solve does that once, beside its stage
stacks (``workflow/solve.py::_Stacks``). The library is built with
``nvcc`` at the first launch (``kernels/_cuda.py``; importing this module
needs neither ``nvcc`` nor a card). ``LAUNCHES`` counts the kernel's
launches.
"""
from __future__ import annotations

import ctypes
from typing import List, NamedTuple

import numpy as np
import torch

from . import _cuda

__all__ = ["compose_grads", "encode", "encode_arrays", "layout", "build",
           "LAUNCHES", "reset_launches", "HEADER", "SMEM_MAX", "REC_FLOATS"]

# --fmad=false: every float32 operation rounds as the plain version's
# tensor operations do
NVCC_FLAGS = _cuda.ARCH_FLAGS + ("--fmad=false",)

# kernel launches since the last reset_launches()
LAUNCHES = {"compose_grads": 0}

# the plan's header, in csrc/compose.cu's order (its enum)
HEADER = ("S", "levels", "sinks", "sink_base", "folds", "ints",
          "lvl_off", "nodes", "pred_off", "pred_idx", "fbase", "sinks_at",
          "mref_off", "mref", "vref_off", "vref", "lst_off", "lst",
          "floats", "mu", "var", "cm", "cv", "U", "rec", "smem")
# the dynamic shared memory a block may opt into on the H100, and the
# floats of one fold step's record (csrc/compose.cu kSmemMax, Rec)
SMEM_MAX = 232448
REC_FLOATS = 28


def reset_launches() -> None:
    LAUNCHES["compose_grads"] = 0


def _bind(lib: ctypes.CDLL) -> None:
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.compose_grads_launch.argtypes = [ci, ctypes.POINTER(ci), vp, vp, vp,
                                         cf, vp, vp, vp]
    lib.compose_grads_launch.restype = ci


def build() -> ctypes.CDLL:
    """The library of ``csrc/compose.cu``, built on first use."""
    return _cuda.build("compose", flags=NVCC_FLAGS, bind=_bind)


class Arrays(NamedTuple):
    """A structure's plan for the kernel, as int32 numpy arrays.

    ``topo``, ``pred_off``/``pred_idx`` (predecessor lists in the order
    ``_fold_max`` folds them), ``sinks``; ``n_steps`` Clark fold steps a
    row. ``lvl_off``/``lvl_nodes``: the nodes by topological level (a
    source is level 0, a node one past its deepest predecessor), in index
    order within a level. Fold edges: join ``i``'s predecessor ``j`` is
    edge ``fbase[i] + j`` (``fbase`` is -1 off the joins), the sinks' fold
    (several sinks) edges ``sink_base + j``; ``n_folds`` of them.
    ``mref_off``/``mref`` and ``vref_off``/``vref``: each node's cotangent
    sources, offsets into the kernel's cotangent array U (:func:`layout`),
    in the order autograd adds them into the node's buffer.
    ``lst_off``/``lst``: the fold steps by group (each level's joins, then
    the sinks' fold), three ints a step: its fold edge, its item, and 1 for
    a fold's first step (whose reverse also feeds item 0); the lanes take a
    group's steps at once."""

    topo: np.ndarray
    pred_off: np.ndarray
    pred_idx: np.ndarray
    sinks: np.ndarray
    n_steps: int
    lvl_off: np.ndarray
    lvl_nodes: np.ndarray
    fbase: np.ndarray
    sink_base: int
    n_folds: int
    mref_off: np.ndarray
    mref: np.ndarray
    vref_off: np.ndarray
    vref: np.ndarray
    lst_off: np.ndarray
    lst: np.ndarray


def _levels(topo, preds) -> np.ndarray:
    level = np.zeros(len(preds), np.int64)
    for i in topo:
        if preds[i]:
            level[i] = 1 + max(level[u] for u in preds[i])
    return level


def _cotangent_sources(topo, preds, sinks, fbase, sink_base):
    """Each node's cotangent sources, in the order the plain version's
    autograd adds them into its buffer (reverse creation order): the sinks'
    fold (or the loss, source ``("node", S)``, for one sink) first, then the
    nodes in reverse topological order; a single-predecessor node passes
    its own cotangent (``("node", i)``), a fold step its item's fold edge,
    last step first, and the first step item 0's as well (``("fold", e)``).
    """
    S = len(preds)
    src: List[list] = [[] for _ in range(S)]

    def fold(items, fb):
        for j in range(len(items) - 1, 0, -1):
            src[items[j]].append(("fold", fb + j))
            if j == 1:
                src[items[0]].append(("fold", fb))

    if len(sinks) == 1:
        src[sinks[0]].append(("node", S))
    else:
        fold(sinks, sink_base)
    for i in reversed(topo):
        ps = preds[i]
        if len(ps) == 1:
            src[ps[0]].append(("node", i))
        elif len(ps) > 1:
            fold(ps, int(fbase[i]))
    return src


def _csr(lists) -> tuple:
    off = np.zeros(len(lists) + 1, np.int32)
    off[1:] = np.cumsum([len(x) for x in lists])
    flat = np.asarray([v for x in lists for v in x], np.int32)
    return off, flat


def encode_arrays(structure) -> Arrays:
    """The kernel's plan of a ``StageDAG.structure`` (:class:`Arrays`).
    The cotangent array U holds gm (S + 1: the nodes' mu cotangents and
    the loss's 1), gv (S + 1: the var ones and lam), the fold edges' mu
    cotangents (five edges each) and their var cotangents."""
    topo, preds, sinks = structure
    S = len(preds)
    pred_off, pred_idx = _csr(preds)
    steps = sum(len(p) - 1 for p in preds if len(p) > 1)
    if len(sinks) > 1:
        steps += len(sinks) - 1
    level = _levels(topo, preds)
    n_levels = int(level.max()) + 1 if S else 0
    lvl_nodes = np.argsort(level, kind="stable").astype(np.int32)
    lvl_off = np.searchsorted(level[lvl_nodes],
                              np.arange(n_levels + 1)).astype(np.int32)
    fbase = np.full(S, -1, np.int32)
    nf = 0
    for i, p in enumerate(preds):
        if len(p) > 1:
            fbase[i] = nf
            nf += len(p)
    sink_base = nf
    if len(sinks) > 1:
        nf += len(sinks)
    gv0, emu0 = S + 1, 2 * (S + 1)
    ev0 = emu0 + 5 * nf
    mu_refs, var_refs = [], []
    for srcs in _cotangent_sources(topo, preds, sinks, fbase, sink_base):
        m, v = [], []
        for kind, x in srcs:
            if kind == "node":
                m.append(x)
                v.append(gv0 + x)
            else:
                m.extend(emu0 + 5 * x + k for k in range(5))
                v.append(ev0 + x)
        mu_refs.append(m)
        var_refs.append(v)
    mref_off, mref = _csr(mu_refs)
    vref_off, vref = _csr(var_refs)
    groups = []
    for L in range(n_levels):
        g = []
        for i in lvl_nodes[lvl_off[L]:lvl_off[L + 1]]:
            ps = preds[i]
            if len(ps) > 1:
                g += [(int(fbase[i]) + j, ps[j], int(j == 1))
                      for j in range(1, len(ps))]
        groups.append(g)
    groups.append([(sink_base + j, sinks[j], int(j == 1))
                   for j in range(1, len(sinks))] if len(sinks) > 1 else [])
    lst_off = np.zeros(len(groups) + 1, np.int32)
    lst_off[1:] = np.cumsum([len(g) for g in groups])
    lst = np.asarray([v for g in groups for step in g for v in step],
                     np.int32)
    return Arrays(np.asarray(topo, np.int32), pred_off, pred_idx,
                  np.asarray(sinks, np.int32), int(steps), lvl_off,
                  lvl_nodes, fbase, sink_base, nf, mref_off, mref, vref_off,
                  vref, lst_off, lst)


def _pad4(n: int) -> int:
    return -(-n // 4) * 4


def layout(a: Arrays):
    """``(ints, header)``: the plan's int32 sections as one buffer (its
    length a multiple of 4, for 16-byte copies) and the header the kernel
    reads (``HEADER``, int32). A row's state is ``header["floats"]`` floats:
    the moments, the completions, U and the fold records (16-byte aligned);
    it lives in shared memory beside the ints when both fit ``SMEM_MAX``
    (``smem`` their bytes), else in a per-row workspace in device memory
    (``smem`` 0)."""
    S = len(a.topo)
    sections = [a.lvl_off, a.lvl_nodes, a.pred_off, a.pred_idx, a.fbase,
                a.sinks, a.mref_off, a.mref, a.vref_off, a.vref, a.lst_off,
                a.lst]
    offs, n = [], 0
    for sec in sections:
        offs.append(n)
        n += len(sec)
    ints = np.zeros(_pad4(n), np.int32)
    for o, sec in zip(offs, sections):
        ints[o:o + len(sec)] = sec
    f_mu = 0
    f_var = f_mu + _pad4(S)
    f_cm = f_var + _pad4(S)
    f_cv = f_cm + _pad4(S)
    f_u = f_cv + _pad4(S)
    f_rec = f_u + _pad4(2 * (S + 1) + 6 * a.n_folds)
    floats = f_rec + REC_FLOATS * a.n_folds
    smem = 4 * (len(ints) + floats)
    hdr = [S, len(a.lvl_off) - 1, len(a.sinks), a.sink_base, a.n_folds,
           len(ints), *offs, floats, f_mu, f_var, f_cm, f_cv, f_u, f_rec,
           smem if smem <= SMEM_MAX else 0]
    assert len(hdr) == len(HEADER)
    return ints, np.asarray(hdr, np.int32)


class Encoded(NamedTuple):
    """A structure's plan as the kernel reads it: the int32 buffer on one
    device, the header on the host."""

    ints: torch.Tensor       # layout()'s int32 sections, on the device
    header: object           # ctypes int array (HEADER)
    S: int
    n_steps: int
    floats: int              # a row's state
    smem: int                # a block's shared memory; 0: device memory


def encode(structure, device) -> Encoded:
    """The structure's plan, uploaded to ``device``."""
    a = encode_arrays(structure)
    ints, hdr = layout(a)
    h = dict(zip(HEADER, hdr.tolist()))
    return Encoded(torch.as_tensor(ints, device=torch.device(device)),
                   (ctypes.c_int * len(HEADER))(*hdr.tolist()), h["S"],
                   a.n_steps, h["floats"], h["smem"])


def compose_grads(enc: Encoded, smu: torch.Tensor, svar: torch.Tensor,
                  lam32: float):
    """``(losses (R,), d/dsmu, d/dsvar)`` of ``mk_mu + lam32 mk_var`` over
    the structure ``enc`` (:func:`encode`, on the moments' device) for
    float32 CUDA tensors ``smu``, ``svar`` (R, S): one kernel launch and one
    allocation (the three results are views of it, with the state's
    workspace behind them when the plan does not fit shared memory), four
    dispatched torch operations in all."""
    if not (smu.is_cuda and svar.is_cuda):
        raise ValueError("compose_grads launches the CUDA kernel and takes "
                         "CUDA tensors; the plain version is "
                         "workflow.solve._compose_grads_plain")
    if (smu.dtype != torch.float32 or svar.dtype != torch.float32
            or smu.ndim != 2 or svar.shape != smu.shape
            or svar.device != smu.device):
        raise ValueError(f"compose_grads takes float32 smu and svar (R, S) "
                         f"on one device, got {smu.dtype} {tuple(smu.shape)} "
                         f"and {svar.dtype} {tuple(svar.shape)}")
    R, S = smu.shape
    if enc.S != S or enc.ints.device != smu.device:
        raise ValueError(f"the structure has {enc.S} stages on "
                         f"{enc.ints.device}, the moments {S} on "
                         f"{smu.device}")
    smu = smu.contiguous()
    svar = svar.contiguous()
    n = R + 2 * R * S
    ws = 0 if enc.smem else R * enc.floats
    buf = torch.empty((_pad4(n) + ws,), dtype=torch.float32,
                      device=smu.device)
    ptr = buf.data_ptr()
    err = build().compose_grads_launch(
        R, enc.header, enc.ints.data_ptr(), smu.data_ptr(), svar.data_ptr(),
        float(lam32), ptr, ptr + 4 * _pad4(n) if ws else None,
        torch._C._cuda_getCurrentRawStream(smu.get_device()))
    _cuda.check(err, "compose_grads")
    LAUNCHES["compose_grads"] += 1
    return (buf.as_strided((R,), (1,)),
            buf.as_strided((R, S), (S, 1), R),
            buf.as_strided((R, S), (S, 1), R + R * S))
