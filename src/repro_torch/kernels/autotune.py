"""Launch shapes of the frontier kernels on Hopper.

Two backends, one key scheme:

* ``cuda``: threads per block of pass 1 of the CUDA kernels. The
  launch-shape model (:func:`pick_threads`) takes 256 threads at every T
  (the split's tiles cover the grid), and :func:`check_launch` holds a
  shape to the card's limits: a multiple of 32 up to 512 threads, the
  dynamic shared memory of :func:`smem_bytes` within the 227 KB a block
  may use, and at most ``MAX_NUM_T`` grid points.
* ``cuda`` split (:func:`pick_split`): how one call spreads its rows over
  the card. The forward moments (``fwd``) are two launches: pass 1 in tiles
  of ``points`` grid points, then an epilogue of one warp per row. The
  fused adjoint (``grad``, ``pgrad``) is three: pass 1 alike, pass 2 in
  chunks of ``t_chunk`` grid points by ``k_chunk`` channels, the epilogue
  in chunks of ``ep_chunk`` channels. Each size is the widest power of two
  that still gives ``TARGET_BLOCKS`` (132, the H100's SMs) blocks per
  launch: a balancer refresh (F = 1 or 3, K = 1024, T = 1024 or 2048) gets
  192-256 blocks in each, the fleet tick (F = 4096) one tile and one chunk
  per row. Pass 2's chunk is capped where its staged grid would pass the
  shared memory a block may use (the one-chunk-per-row split at long T).
  The target is a constant, never the SM count read from the card, so the
  split, and with it the order of every float sum, is a function of
  (F, K, T, mode, family) alone. :func:`fwd_scratch_elems` and
  :func:`grad_scratch_elems` size the float64 scratch it needs, and
  :func:`check_launch` holds it to the card's limits too.
* ``plain``: candidate rows per chunk of the plain PyTorch path, sized so
  the (rows, T, K) intermediates stay within a memory budget.
* The SSD scan's group split (:func:`ssd_groups`): how many groups of
  consecutive chunks each (batch, head) sequence is cut into, so that the
  chunk walk spreads over at least ``SSD_MIN_BLOCKS`` blocks; like the
  frontier split, a function of the shape alone.

Keys carry the mode — ``fwd`` (forward moments), ``grad`` (W-adjoints, the
PGD step) or ``pgrad`` (full-parameter adjoints) — and the family, since the
shared-memory tile and the accumulator count differ by family: the normal,
lognormal, drift and defective families keep 5 floats of per-channel
constants, the empirical mixture 17; the fused adjoint keeps 2 to 6
accumulators per channel (drift 4 in grad mode, defective 6 in pgrad mode).

A launch shape is found in order: the in-process cache (or a restored
snapshot), then the cache file (:func:`default_cache_path`, or the
``cache_path`` a caller names), then the model. :func:`lookup` never
times anything. :func:`sweep` times the real kernels at one shape (on the
card the model's threads and split and their neighbours, on the CPU the
plain path's rows per chunk), holds every candidate against the plain
version first, and writes the winner to the in-process cache and the
file; a sweep entry outranks a model entry wherever the two meet. The
file keeps one section per card (``torch.cuda.get_device_name()``, or
``"cpu"`` for the plain path), so a time taken on one card never sizes a
launch on another. :func:`cache_state` snapshots the in-process cache,
splits included, so a restored process launches the same shapes: a split
fixes the order of the float sums, so a swept split gives other bits than
the model's, within the kernels' tolerances.
"""
from __future__ import annotations

import json
import os
import threading
import time
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.distributions import (EMP_COMPONENTS, Defective, Drift,
                                  Empirical, extra_rows, family_features)

__all__ = ["ROW_BUCKETS", "MODES", "MAX_THREADS", "MAX_NUM_T",
           "SMEM_LIMIT_BYTES", "TARGET_BLOCKS", "GradSplit", "bucket_rows",
           "accumulators", "smem_bytes", "pick_threads", "pick_split",
           "split_blocks", "fwd_scratch_elems", "grad_scratch_elems",
           "pick_block_rows", "check_launch", "lookup", "lookup_split",
           "launch_plan", "plan_outcome", "last_outcome", "sweep",
           "sweep_candidates", "default_cache_path", "SsdSplit",
           "ssd_groups", "SSD_MIN_BLOCKS", "clear_cache", "cache_state",
           "load_cache_state"]

# serving row-count buckets: a stacked launch pads its row axis up to one
ROW_BUCKETS: Tuple[int, ...] = (8, 16, 32, 64, 128, 256, 512, 1024, 2048,
                                4096)
MODES = ("fwd", "grad", "pgrad")

MAX_THREADS = 512            # the kernels' __launch_bounds__
# grid points on the card: the kernels form t_j = tmax * (j / (T - 1)) with
# j in float32, exact up to 2^24
MAX_NUM_T = 1 << 24
DEFAULT_THREADS = 256
SMEM_LIMIT_BYTES = 232448    # per block on an H100 (227 KB)
# pass 2 stages 20 bytes per grid point of its chunk: the widest power of
# two of them that fits a block
_T_CHUNK_CAP = 1 << ((SMEM_LIMIT_BYTES // 20).bit_length() - 1)

# the fused adjoint's split: blocks per launch to aim for (the H100's SMs,
# a constant so the split never depends on the card it runs on), and the
# narrowest or widest tile or chunk it may take
TARGET_BLOCKS = 132
MIN_POINTS = 4               # pass 1: grid points per block
MIN_T_CHUNK = 8              # pass 2: grid points per block
CHUNK_THREADS = 256          # pass 2 and epilogue: threads per block, at most

# the SSD scan's group split: blocks to aim for, four waves of
# TARGET_BLOCKS (one block of its long-chunk kernel fits an SM), so the
# last wave's tail is at most a quarter of the walk
SSD_MIN_BLOCKS = 4 * TARGET_BLOCKS

# per-channel constants staged in shared memory, in floats
_CHAN_FLOATS = 5
_EMP_CHAN_FLOATS = 2 + 5 * EMP_COMPONENTS

# peak bytes of one plain-path chunk's (rows, T, K) intermediates
PLAIN_CHUNK_BYTES = 1 << 30

_KEY_VERSION = "v4"
_CACHE: Dict[str, dict] = {}
# checked launch plans (launch_plan), derived from _CACHE and dropped
# whenever it is cleared or restored; beside each, how it was resolved
_PLANS: Dict[tuple, tuple] = {}
_PLAN_SOURCE: Dict[tuple, str] = {}
# (cache file, section) pairs already read into _CACHE
_JSON_LOADED: set = set()
# the card's name, the cache file's section for the cuda backend
_CARD: Dict[str, Optional[str]] = {}
# how this thread's latest lookup resolved (last_outcome)
_LOCAL = threading.local()

_DEFAULT_CACHE_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))), "experiments", "torch",
    "autotune_cache.json")

# the kernels' tolerances against their plain versions (chip_smoke.py):
# mu (rtol, atol), var (rtol, atol), each adjoint's relative L2
SWEEP_TOL = {"mu": (1e-4, 1e-4), "var": (1e-2, 1e-3), "adj": 1e-4}


def _check_mode(mode: str) -> None:
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")


def _key(F: int, K: int, num_t: int, backend: str, mode: str,
         dist_id: str) -> str:
    # the threads model reads (T, mode, family); the chunk and split models
    # F and K too
    rows = f":F{F}:K{K}" if backend in ("plain", "split") else ""
    return f"{_KEY_VERSION}:{backend}{rows}:T{num_t}:mode{mode}:fam{dist_id}"


class SsdSplit(NamedTuple):
    """The SSD scan's chunks (``csrc/ssd_scan.cu``): ``chunk`` rows each
    (the last one ragged), ``chunks`` of them per sequence, cut into
    ``groups`` groups of ``per_group`` consecutive chunks (the last group
    may hold fewer)."""
    chunk: int
    chunks: int
    per_group: int
    groups: int


def ssd_groups(B: int, H: int, S: int, chunk: int) -> SsdSplit:
    """The group split of an SSD scan of B x H sequences of S rows in
    chunks of ``min(chunk, S)``: the smallest power of two of groups that
    gives B * H * groups >= SSD_MIN_BLOCKS, at most one group per chunk.
    The serving path (many sequences, one chunk) gets one group."""
    L = min(int(chunk), int(S))
    nc = _cdiv(S, L)
    want = _pow2_ceil(_cdiv(SSD_MIN_BLOCKS, max(B * H, 1)))
    per = _cdiv(nc, min(nc, want))
    return SsdSplit(L, nc, per, _cdiv(nc, per))


def bucket_rows(F: int, buckets: Sequence[int] = ROW_BUCKETS) -> int:
    """Round a stacked row count up to the next bucket (counts past the
    last bucket pass through)."""
    F = int(F)
    for b in buckets:
        if F <= b:
            return int(b)
    return F


def accumulators(dist_id: str, params: bool) -> int:
    """Per-channel accumulators of the fused adjoint (P and Pv per live
    feature of the family's basis)."""
    return 2 * sum(family_features(dist_id, params=params))


class GradSplit(NamedTuple):
    """How one split call spreads its rows (``csrc/frontier_grid.cu``
    ``Split``): pass 1 blocks of ``points`` grid points (a power of two
    dividing the block; block / points channel slices each); for the fused
    adjoint also pass 2 blocks of ``t_chunk`` grid points by ``k_chunk``
    channels, and epilogue blocks of ``ep_chunk`` channels; in both, one
    thread per channel up to ``CHUNK_THREADS``, each walking several
    beyond. A forward split reads ``points`` alone; its other fields are
    0."""
    points: int
    t_chunk: int
    k_chunk: int
    ep_chunk: int


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _pow2_ceil(n: int) -> int:
    return 1 << max(int(n) - 1, 0).bit_length()


def _widest(n: int, units: int, top: int, bottom: int) -> int:
    """The largest power of two c in [bottom, top] with units * ceil(n / c)
    >= TARGET_BLOCKS, else ``bottom`` (``top`` where top < bottom)."""
    c = top
    while c > bottom and units * _cdiv(n, c) < TARGET_BLOCKS:
        c //= 2
    return c


def smem_bytes(threads: int, num_t: int, mode: str, dist_id: str,
               split: Optional[GradSplit] = None) -> int:
    """Dynamic shared memory of one block: pass 1's tile of per-channel
    constants and one float64 per thread; for the fused adjoint the larger
    of that and pass 2's (t - mu in float64, w F(t), t and log t in float32
    per grid point of its chunk; without a split, of the widest chunk the
    model gives, an upper bound)."""
    _check_mode(mode)
    chan = 4 * (_EMP_CHAN_FLOATS if dist_id == "empirical"
                else _CHAN_FLOATS)
    pass1 = _cdiv(threads * chan, 16) * 16 + 8 * threads
    if mode == "fwd":
        return pass1
    points = (min(num_t, _T_CHUNK_CAP) if split is None
              else min(split.t_chunk, num_t))
    return max(pass1, 20 * points)


def check_launch(threads: int, num_t: int, mode: str, dist_id: str,
                 split: Optional[GradSplit] = None) -> None:
    """Raise unless ``threads`` (and ``split``) is a launch the kernels
    accept for ``num_t`` grid points."""
    if threads % 32 or not 32 <= threads <= MAX_THREADS:
        raise ValueError(f"threads per block must be a multiple of 32 in "
                         f"[32, {MAX_THREADS}], got {threads}")
    if not 2 <= num_t <= MAX_NUM_T:
        raise ValueError(f"the card takes num_t in [2, {MAX_NUM_T}] (grid "
                         f"indices exact in float32), got {num_t}")
    if split is not None:
        p, tc, kc, ec = split
        if p < 1 or p & (p - 1) or threads % p:
            raise ValueError(f"split points={p} must be a power of two "
                             f"dividing {threads} threads")
        if mode != "fwd" and min(tc, kc, ec) < 1:
            raise ValueError(f"split chunks must be >= 1, got t_chunk={tc}, "
                             f"k_chunk={kc}, ep_chunk={ec}")
    need = smem_bytes(threads, num_t, mode, dist_id, split)
    if need > SMEM_LIMIT_BYTES:
        raise ValueError(f"launch needs {need} bytes of shared memory, over "
                         f"the {SMEM_LIMIT_BYTES} a block may use")


def pick_threads(num_t: int, mode: str, dist_id: str) -> int:
    """The launch-shape model: ``DEFAULT_THREADS`` per pass-1 block at any
    num_t (the split's tiles, not the threads, cover the grid)."""
    check_launch(DEFAULT_THREADS, num_t, mode, dist_id)
    return DEFAULT_THREADS


def pick_split(F: int, K: int, num_t: int, mode: str,
               dist_id: str) -> GradSplit:
    """The split model: each tile or chunk the widest power of two that
    still gives TARGET_BLOCKS blocks per launch (pass 1: F * T / points;
    adjoint pass 2: F * T / t_chunk * K / k_chunk; adjoint epilogue:
    F * K / ep_chunk). Pass 1's tile is no wider than the largest power of
    two dividing its block; pass 2 splits the grid before it gives a thread
    fewer channels than one, so its blocks stay CHUNK_THREADS wide where K
    allows, and its chunk stays within the shared memory a block may use.
    Where F alone fills the card, each launch is one block per row (pass 2:
    one chunk per row up to that cap). A forward split sets ``points``
    alone."""
    _check_mode(mode)
    threads = pick_threads(num_t, mode, dist_id)
    points = _widest(num_t, F, min(256, _pow2_ceil(num_t),
                                   threads & -threads), MIN_POINTS)
    if mode == "fwd":
        split = GradSplit(points, 0, 0, 0)
        check_launch(threads, num_t, mode, dist_id, split)
        return split
    kt = min(CHUNK_THREADS, _cdiv(K, 32) * 32)  # pass 2's threads
    t_chunk = _widest(num_t, F * _cdiv(K, kt),
                      min(_pow2_ceil(num_t), _T_CHUNK_CAP), MIN_T_CHUNK)
    per_thread = _widest(_cdiv(K, kt), F * _cdiv(num_t, t_chunk),
                         _pow2_ceil(_cdiv(K, kt)), 1)
    split = GradSplit(
        points=points, t_chunk=t_chunk, k_chunk=kt * per_thread,
        ep_chunk=_widest(K, F, _pow2_ceil(K), 1))
    check_launch(threads, num_t, mode, dist_id, split)
    return split


def split_blocks(F: int, K: int, num_t: int,
                 split: GradSplit) -> Tuple[int, ...]:
    """Blocks of each launch of one split call: (pass 1, pass 2, epilogue)
    of the fused adjoint, (pass 1, epilogue) of a forward split."""
    if split.t_chunk == 0:
        return F * _cdiv(num_t, split.points), F
    return (F * _cdiv(num_t, split.points),
            F * _cdiv(num_t, split.t_chunk) * _cdiv(K, split.k_chunk),
            F * _cdiv(K, split.ep_chunk))


def fwd_scratch_elems(F: int, num_t: int, split: GradSplit) -> int:
    """Accumulators of the forward call's scratch (``csrc/frontier_grid.cu``
    ``FwdLayout``): per row the reach maximum and pass 1's two sums per
    tile."""
    return F * (1 + 2 * _cdiv(num_t, split.points))


def grad_scratch_elems(F: int, K: int, num_t: int, dist_id: str,
                       params: bool, split: GradSplit) -> int:
    """Accumulators of the fused adjoint's scratch (``csrc/frontier_grid.cu``
    ``Layout``): per row 4 scalars, pass 1's two sums per tile, w F(t) per
    grid point, pass 2's two sums per (t_chunk, k_chunk) block and its
    accumulators per t_chunk and channel."""
    n_tt = _cdiv(num_t, split.points)
    n_tc = _cdiv(num_t, split.t_chunk)
    n_kc = _cdiv(K, split.k_chunk)
    n_acc = accumulators(dist_id, params)
    return F * (4 + 2 * n_tt + num_t + 2 * n_tc * n_kc + n_tc * n_acc * K)


def pick_block_rows(F: int, K: int, num_t: int, mode: str,
                    dist_id: str) -> int:
    """Rows per chunk of the plain path: live (rows, T, K) float32 tensors
    within ``PLAIN_CHUNK_BYTES``."""
    _check_mode(mode)
    # float32 (rows, T, K) tensors alive at once, float64 ones counted twice
    live = {"fwd": 6, "grad": 20, "pgrad": 26}[mode]
    if dist_id == "empirical":
        live += 2 * EMP_COMPONENTS
    per_row = 4 * num_t * K * (live + extra_rows(dist_id))
    return max(1, min(F, PLAIN_CHUNK_BYTES // max(per_row, 1)))


def default_cache_path() -> str:
    """The cache file: ``experiments/torch/autotune_cache.json`` in the
    checkout (ignored by git: its times belong to one machine)."""
    return _DEFAULT_CACHE_PATH


def _section(backend: str) -> Optional[str]:
    """The cache file's section for ``backend``: the card's name (None
    without a card), or ``"cpu"`` for the plain path."""
    if backend == "plain":
        return "cpu"
    if "name" not in _CARD:
        _CARD["name"] = (torch.cuda.get_device_name()
                         if torch.cuda.is_available() else None)
    return _CARD["name"]


def _merge(k: str, v: dict) -> bool:
    """Put entry ``v`` under ``k`` unless a sweep entry holds it already;
    True when it went in."""
    held = _CACHE.get(k)
    if held is not None and held.get("source") == "sweep":
        return False
    _CACHE[k] = dict(v)
    return True


def _load_json(cache_path: Optional[str], backend: str) -> None:
    """Read the file's section for ``backend`` into the cache, once per
    (file, section)."""
    path = cache_path or _DEFAULT_CACHE_PATH
    section = _section(backend)
    if section is None or (path, section) in _JSON_LOADED:
        return
    _JSON_LOADED.add((path, section))
    try:
        with open(path) as fh:
            disk = json.load(fh)
    except (OSError, ValueError):
        return
    if any([_merge(k, v) for k, v in disk.get(section, {}).items()]):
        _PLANS.clear()
        _PLAN_SOURCE.clear()


def last_outcome() -> str:
    """How this thread's latest :func:`lookup`, :func:`lookup_split` or
    :func:`plan_outcome` resolved: ``"sweep"`` (a timed sweep's entry),
    ``"hit"`` (a cached model entry) or ``"model"`` (the model, just
    now); ``"none"`` before any."""
    return getattr(_LOCAL, "outcome", "none")


def _resolved(entry: dict) -> None:
    _LOCAL.outcome = "sweep" if entry.get("source") == "sweep" else "hit"


def lookup(F: int, K: int, num_t: int, backend: str = "cuda",
           mode: str = "fwd", dist_id: str = "normal",
           cache_path: Optional[str] = None) -> int:
    """Threads per block (``cuda``) or rows per chunk (``plain``) for a
    launch: the in-process cache, else the cache file, else the model."""
    _check_mode(mode)
    if backend not in ("cuda", "plain"):
        raise ValueError(f"backend must be 'cuda' or 'plain', got {backend!r}")
    _load_json(cache_path, backend)
    key = _key(F, K, num_t, backend, mode, dist_id)
    hit = _CACHE.get(key)
    if hit is not None:
        _resolved(hit)
        return int(hit["value"])
    if backend == "cuda":
        value = pick_threads(num_t, mode, dist_id)
    else:
        value = pick_block_rows(F, K, num_t, mode, dist_id)
    _CACHE[key] = {"value": value, "source": "model"}
    _LOCAL.outcome = "model"
    return value


def _split_entry(F: int, K: int, num_t: int, mode: str, dist_id: str,
                 cache_path: Optional[str] = None) -> dict:
    """The cache entry of a launch's split (a sweep's also names its
    pass-1 threads): the in-process cache, else the file, else the
    model."""
    _load_json(cache_path, "cuda")
    key = _key(F, K, num_t, "split", mode, dist_id)
    hit = _CACHE.get(key)
    if hit is not None:
        _resolved(hit)
        return hit
    hit = _CACHE[key] = {"value": list(pick_split(F, K, num_t, mode,
                                                  dist_id)),
                         "source": "model"}
    _LOCAL.outcome = "model"
    return hit


def lookup_split(F: int, K: int, num_t: int, mode: str = "grad",
                 dist_id: str = "normal",
                 cache_path: Optional[str] = None) -> GradSplit:
    """The split of a launch: the in-process cache, else the cache file,
    else :func:`pick_split`."""
    return GradSplit(*_split_entry(F, K, num_t, mode, dist_id,
                                   cache_path)["value"])


def launch_plan(F: int, K: int, num_t: int, mode: str,
                dist_id: str) -> Tuple[int, GradSplit, int]:
    """``(threads, split, scratch accumulators)`` of one split call from
    the split's entry (a sweep's carries its threads) and :func:`lookup`,
    held to the card's limits by :func:`check_launch`; kept until the
    cache is cleared or restored, so a PGD step pays a dictionary lookup
    for it."""
    key = (F, K, num_t, mode, dist_id)
    plan = _PLANS.get(key)
    if plan is None:
        entry = _split_entry(F, K, num_t, mode, dist_id)
        source = last_outcome()
        split = GradSplit(*entry["value"])
        threads = entry.get("threads")
        if threads is None:
            threads = lookup(F, K, num_t, mode=mode, dist_id=dist_id)
            if last_outcome() == "model" and source != "sweep":
                source = "model"
        check_launch(threads, num_t, mode, dist_id, split)
        n = (fwd_scratch_elems(F, num_t, split) if mode == "fwd" else
             grad_scratch_elems(F, K, num_t, dist_id, mode == "pgrad",
                                split))
        plan = _PLANS[key] = (int(threads), split, n)
        _PLAN_SOURCE[key] = source
    return plan


def plan_outcome(F: int, K: int, num_t: int, mode: str,
                 dist_id: str) -> Tuple[int, GradSplit, str]:
    """``(threads, split, outcome)`` of a call's launch plan, for its
    trace span: ``"sweep"`` for a swept plan, ``"model"`` when the model
    made it just now, else ``"hit"``."""
    key = (F, K, num_t, mode, dist_id)
    fresh = key not in _PLANS
    threads, split, _ = launch_plan(F, K, num_t, mode, dist_id)
    source = _PLAN_SOURCE[key]
    _LOCAL.outcome = source if fresh or source == "sweep" else "hit"
    return threads, split, _LOCAL.outcome


# ----------------------------------------------------------------- sweep
def _sweep_inputs(F: int, K: int, seed: int, dist_id: str):
    """The JAX package's sweep inputs: exponential rows normalized, mus
    U(10, 40), sigmas mus U(0.02, 0.3), the family's parameters drawn
    after them."""
    rng = np.random.default_rng(seed)
    e = rng.exponential(size=(F, K))
    W = (e / e.sum(1, keepdims=True)).astype(np.float32)
    mus = rng.uniform(10, 40, K).astype(np.float32)
    sgs = (mus * rng.uniform(0.02, 0.3, K)).astype(np.float32)
    if dist_id == "drift":
        family = Drift(rng.uniform(0.0, 0.5, K).astype(np.float32))
    elif dist_id == "empirical":
        family = Empirical.from_samples(
            rng.normal(mus[None, :], sgs[None, :], size=(256, K)))
    elif dist_id == "defective":
        family = Defective(rng.uniform(0.0, 0.3, K).astype(np.float32))
    else:
        family = dist_id
    return W, mus, sgs, family


def sweep_candidates(F: int, K: int, num_t: int, mode: str, dist_id: str,
                     backend: str = "cuda") -> List[tuple]:
    """The model's launch shape and its neighbours, the model's first.

    ``cuda``: ``(threads, split)`` pairs varying one field at a time:
    each of the split's fields (``points`` alone for ``fwd``) halved and
    doubled, and threads 128, 256 or 512; only shapes that
    :func:`check_launch` accepts. ``plain``: ``(rows,)``, the model's rows
    per chunk halved and doubled within [1, F]."""
    if backend == "plain":
        r = pick_block_rows(F, K, num_t, mode, dist_id)
        out = [(r,)] + [(v,) for v in (max(1, r // 2), min(F, 2 * r))]
    else:
        th = pick_threads(num_t, mode, dist_id)
        s0 = pick_split(F, K, num_t, mode, dist_id)
        fields = ("points",) if mode == "fwd" else GradSplit._fields
        out = [(th, s0)]
        for f in fields:
            for v in (getattr(s0, f) // 2, getattr(s0, f) * 2):
                out.append((th, s0._replace(**{f: v})))
        out += [(t, s0) for t in (128, 256, 512) if t != th]

        def ok(c):
            try:
                check_launch(c[0], num_t, mode, dist_id, c[1])
            except ValueError:
                return False
            return True
        out = [c for c in out if ok(c)]
    seen, uniq = set(), []
    for c in out:
        if c not in seen:
            seen.add(c)
            uniq.append(c)
    return uniq


def _label(c: tuple) -> str:
    if len(c) == 1:
        return str(c[0])
    return f"{c[0]}/" + ",".join(str(v) for v in c[1])


def _rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    den = float(torch.linalg.norm(b.double()))
    num = float(torch.linalg.norm((a - b).double()))
    return num / den if den > 0 else num


def _agrees(got, want) -> Tuple[bool, str]:
    """Kernel against plain at SWEEP_TOL; (ok, what missed)."""
    (mr, ma), (vr, va) = SWEEP_TOL["mu"], SWEEP_TOL["var"]
    if not all(bool(torch.isfinite(g).all()) for g in got):
        return False, "non-finite output"
    if not torch.allclose(got[0], want[0], rtol=mr, atol=ma):
        return False, f"mu max |err| {float((got[0] - want[0]).abs().max())}"
    if not torch.allclose(got[1], want[1], rtol=vr, atol=va):
        return False, f"var max |err| {float((got[1] - want[1]).abs().max())}"
    rel = [_rel_l2(g, w) for g, w in zip(got[2:], want[2:])]
    if rel and max(rel) > SWEEP_TOL["adj"]:
        return False, f"adjoint relative L2 {max(rel):.2e}"
    return True, ""


def _time_us(fn, on_card: bool, repeats: int, warm: int = 2) -> float:
    """Median microseconds of one call of ``fn`` after ``warm`` calls:
    CUDA event pairs on the card, the host clock on the CPU."""
    for _ in range(warm):
        fn()
    samples = []
    for _ in range(max(repeats, 1)):
        if on_card:
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            samples.append(1e3 * a.elapsed_time(b))
        else:
            t0 = time.perf_counter()
            fn()
            samples.append(1e6 * (time.perf_counter() - t0))
    samples.sort()
    return samples[len(samples) // 2]


def sweep(F: int, K: int, num_t: int, mode: str = "grad",
          dist_id: str = "normal", repeats: int = 5, seed: int = 0,
          candidates: Optional[Sequence[tuple]] = None,
          cache_path: Optional[str] = None, device="cuda") -> dict:
    """Time the frontier call at (F, K, num_t, mode, family) across launch
    shapes; cache and file the fastest.

    ``device="cuda"`` times the kernels at each of ``candidates``
    (default :func:`sweep_candidates`: ``(threads, split)`` pairs) by CUDA
    event pairs; ``device="cpu"`` times the plain path at each rows per
    chunk (``(rows,)``) on the host clock. Each candidate runs twice (the
    bits must repeat) and is held against the plain version at SWEEP_TOL
    before its time counts; one that misses raises (a kernel fault, never
    skipped). The winner's entry ``{"value", "source": "sweep", "us",
    "timings", "model"}`` (``value`` the split, ``threads`` beside it, or
    the rows) goes into the in-process cache and the file's section for
    this card, and is returned; the launch plans the sweep touched are
    dropped. The calls go through ``ops`` (counted in
    ``frontier_grid.LAUNCHES`` on the card) with the inputs of
    :func:`_sweep_inputs`."""
    from . import ops  # lazy: ops imports this module

    _check_mode(mode)
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    backend = "cuda" if on_card else "plain"
    Wn, mus_n, sgs_n, family = _sweep_inputs(F, K, seed, dist_id)
    W, mus, sgs = (torch.tensor(a, device=dev) for a in (Wn, mus_n, sgs_n))
    fam_id, extra = ops._resolve_family(family, K, dev)
    cands = list(candidates if candidates is not None else
                 sweep_candidates(F, K, num_t, mode, dist_id, backend))
    split_key = _key(F, K, num_t, "split", mode, dist_id)
    rows_key = _key(F, K, num_t, "plain", mode, dist_id)
    plan_key = (F, K, num_t, mode, dist_id)
    held = {k: _CACHE.get(k) for k in (split_key, rows_key)}

    def install(c):
        _PLANS.pop(plan_key, None)
        _PLAN_SOURCE.pop(plan_key, None)
        if on_card:
            _CACHE[split_key] = {"value": list(c[1]), "threads": int(c[0]),
                                 "source": "candidate"}

    def run(c):
        rows = None if on_card else int(c[0])
        if mode == "fwd":
            return ops.frontier_moments(W, mus, sgs, num_t=num_t, device=dev,
                                        block_rows=rows, family=family,
                                        _check=False)
        return ops.frontier_moments_with_grads(
            W, mus, sgs, num_t=num_t, device=dev, block_rows=rows,
            family=family, param_grads=(mode == "pgrad"), _check=False)

    want = ops.plain_moments(W, mus, sgs, extra, num_t=num_t,
                             dist_id=fam_id, mode=mode)
    timings = {}
    try:
        for c in cands:
            install(c)
            got, again = run(c), run(c)
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                raise RuntimeError(
                    f"sweep candidate {_label(c)} at F={F} K={K} "
                    f"T={num_t} {mode} {dist_id}: the bits did not repeat")
            ok, why = _agrees(got, want)
            if not ok:
                raise RuntimeError(
                    f"sweep candidate {_label(c)} at F={F} K={K} "
                    f"T={num_t} {mode} {dist_id} misses its plain "
                    f"version: {why}")
            timings[_label(c)] = _time_us(lambda c=c: run(c), on_card,
                                          repeats)
    finally:
        for k, v in held.items():
            if v is None:
                _CACHE.pop(k, None)
            else:
                _CACHE[k] = v
        _PLANS.pop(plan_key, None)
        _PLAN_SOURCE.pop(plan_key, None)
    best = min(cands, key=lambda c: timings[_label(c)])
    entry = {"value": list(best[1]) if on_card else int(best[0]),
             "source": "sweep", "us": float(timings[_label(best)]),
             "timings": timings, "model": _label(cands[0])}
    if on_card:
        entry["threads"] = int(best[0])
    key = split_key if on_card else rows_key
    _CACHE[key] = dict(entry)
    path = cache_path or _DEFAULT_CACHE_PATH
    section = _section(backend)
    disk = {}
    try:
        with open(path) as fh:
            disk = json.load(fh)
    except (OSError, ValueError):
        pass
    disk.setdefault(section, {})[key] = entry
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as fh:
        json.dump(disk, fh, indent=1, sort_keys=True)
    return entry


def clear_cache() -> None:
    """Drop the in-process cache (the file is read again at the next
    lookup)."""
    _CACHE.clear()
    _PLANS.clear()
    _PLAN_SOURCE.clear()
    _JSON_LOADED.clear()


def cache_state() -> dict:
    """Snapshot of the in-process cache, sweep entries included, for a
    checkpoint."""
    return {k: dict(v) for k, v in _CACHE.items()}


def load_cache_state(state: dict) -> None:
    """Restore a :func:`cache_state` snapshot; a sweep entry held in this
    process outranks the snapshot's model entry."""
    for k, v in state.items():
        _merge(k, v)
    _PLANS.clear()
    _PLAN_SOURCE.clear()
