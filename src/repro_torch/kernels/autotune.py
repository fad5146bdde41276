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

The in-process cache is filled by the model and keyed on what the model
reads; :func:`cache_state` snapshots it, splits included, so a restored
process launches the same shapes (the launch shape fixes the float
reduction order). A timed sweep, and a cache file for its results, are
later work.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Sequence, Tuple

from ..core.distributions import EMP_COMPONENTS, extra_rows, family_features

__all__ = ["ROW_BUCKETS", "MODES", "MAX_THREADS", "MAX_NUM_T",
           "SMEM_LIMIT_BYTES", "TARGET_BLOCKS", "GradSplit", "bucket_rows",
           "accumulators", "smem_bytes", "pick_threads", "pick_split",
           "split_blocks", "fwd_scratch_elems", "grad_scratch_elems",
           "pick_block_rows", "check_launch", "lookup", "lookup_split",
           "launch_plan", "SsdSplit", "ssd_groups", "SSD_MIN_BLOCKS",
           "clear_cache", "cache_state", "load_cache_state"]

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
# whenever it is cleared or restored
_PLANS: Dict[tuple, tuple] = {}


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


def lookup(F: int, K: int, num_t: int, backend: str = "cuda",
           mode: str = "fwd", dist_id: str = "normal") -> int:
    """Threads per block (``cuda``) or rows per chunk (``plain``) for a
    launch: the in-process cache (or a restored snapshot), else the
    model."""
    _check_mode(mode)
    if backend not in ("cuda", "plain"):
        raise ValueError(f"backend must be 'cuda' or 'plain', got {backend!r}")
    key = _key(F, K, num_t, backend, mode, dist_id)
    hit = _CACHE.get(key)
    if hit is not None:
        return int(hit["value"])
    if backend == "cuda":
        value = pick_threads(num_t, mode, dist_id)
    else:
        value = pick_block_rows(F, K, num_t, mode, dist_id)
    _CACHE[key] = {"value": value, "source": "model"}
    return value


def lookup_split(F: int, K: int, num_t: int, mode: str = "grad",
                 dist_id: str = "normal") -> GradSplit:
    """The split of a launch: the in-process cache (or a restored
    snapshot), else :func:`pick_split`."""
    key = _key(F, K, num_t, "split", mode, dist_id)
    hit = _CACHE.get(key)
    if hit is not None:
        return GradSplit(*hit["value"])
    split = pick_split(F, K, num_t, mode, dist_id)
    _CACHE[key] = {"value": list(split), "source": "model"}
    return split


def launch_plan(F: int, K: int, num_t: int, mode: str,
                dist_id: str) -> Tuple[int, GradSplit, int]:
    """``(threads, split, scratch accumulators)`` of one split call from
    :func:`lookup` and :func:`lookup_split`, held to the card's limits by
    :func:`check_launch`; kept until the cache is cleared or restored, so a
    PGD step pays a dictionary lookup for it."""
    key = (F, K, num_t, mode, dist_id)
    plan = _PLANS.get(key)
    if plan is None:
        threads = lookup(F, K, num_t, mode=mode, dist_id=dist_id)
        split = lookup_split(F, K, num_t, mode=mode, dist_id=dist_id)
        check_launch(threads, num_t, mode, dist_id, split)
        n = (fwd_scratch_elems(F, num_t, split) if mode == "fwd" else
             grad_scratch_elems(F, K, num_t, dist_id, mode == "pgrad",
                                split))
        plan = _PLANS[key] = (threads, split, n)
    return plan


def clear_cache() -> None:
    """Drop the in-process cache."""
    _CACHE.clear()
    _PLANS.clear()


def cache_state() -> dict:
    """Snapshot of the in-process cache, for a checkpoint."""
    return {k: dict(v) for k, v in _CACHE.items()}


def load_cache_state(state: dict) -> None:
    """Restore a :func:`cache_state` snapshot."""
    for k, v in state.items():
        _CACHE[k] = dict(v)
    _PLANS.clear()
