"""Launch shapes of the frontier kernels on Hopper.

Two backends, one key scheme:

* ``cuda``: threads per block of the CUDA kernels. The launch-shape model
  (:func:`pick_threads`) takes 256 threads, or more where the grid needs
  them (each thread of the forward kernel owns at most
  ``MAX_POINTS_PER_THREAD`` grid points), and :func:`check_launch` holds a
  shape to the card's limits: a multiple of 32 up to 512 threads, and the
  dynamic shared memory of :func:`smem_bytes` within the 227 KB a block
  may use.
* ``cuda`` split of the fused adjoint (``grad``, ``pgrad``;
  :func:`pick_split`): how one call spreads its rows over the card in
  three launches -- pass 1 in tiles of ``points`` grid points, pass 2 in
  chunks of ``t_chunk`` grid points by ``k_chunk`` channels, the epilogue
  in chunks of ``ep_chunk`` channels. Each size is the widest power of two
  that still gives ``TARGET_BLOCKS`` (132, the H100's SMs) blocks per
  launch: a balancer refresh (F = 1 or 3, K = 1024, T = 1024) gets 192-256
  blocks in each, the fleet tick (F = 4096) one tile and one chunk per row.
  The target is a constant, never the SM count read from the card, so the
  split, and with it the order of every float sum, is a function of
  (F, K, T, mode, family) alone. :func:`grad_scratch_elems` sizes the
  float64 scratch it needs, and :func:`check_launch` holds it to the
  card's limits too.
* ``plain``: candidate rows per chunk of the plain PyTorch path, sized so
  the (rows, T, K) intermediates stay within a memory budget.

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

__all__ = ["ROW_BUCKETS", "MODES", "MAX_THREADS", "MAX_POINTS_PER_THREAD",
           "MAX_NUM_T", "SMEM_LIMIT_BYTES", "TARGET_BLOCKS", "GradSplit",
           "bucket_rows", "accumulators", "smem_bytes", "pick_threads",
           "pick_split", "split_blocks", "grad_scratch_elems",
           "pick_block_rows", "check_launch", "lookup", "lookup_split",
           "grad_plan", "clear_cache", "cache_state", "load_cache_state"]

# serving row-count buckets: a stacked launch pads its row axis up to one
ROW_BUCKETS: Tuple[int, ...] = (8, 16, 32, 64, 128, 256, 512, 1024, 2048,
                                4096)
MODES = ("fwd", "grad", "pgrad")

MAX_THREADS = 512            # the kernels' __launch_bounds__
MAX_POINTS_PER_THREAD = 8    # register-resident grid points per thread
MAX_NUM_T = MAX_THREADS * MAX_POINTS_PER_THREAD
DEFAULT_THREADS = 256
SMEM_LIMIT_BYTES = 232448    # per block on an H100 (227 KB)

# the fused adjoint's split: blocks per launch to aim for (the H100's SMs,
# a constant so the split never depends on the card it runs on), and the
# narrowest or widest tile or chunk it may take
TARGET_BLOCKS = 132
MIN_POINTS = 4               # pass 1: grid points per block
MIN_T_CHUNK = 8              # pass 2: grid points per block
CHUNK_THREADS = 256          # pass 2 and epilogue: threads per block, at most

# per-channel constants staged in shared memory, in floats
_CHAN_FLOATS = 5
_EMP_CHAN_FLOATS = 2 + 5 * EMP_COMPONENTS

# peak bytes of one plain-path chunk's (rows, T, K) intermediates
PLAIN_CHUNK_BYTES = 1 << 30

_KEY_VERSION = "v3"
_CACHE: Dict[str, dict] = {}
# checked launch plans of the fused adjoint (grad_plan), derived from
# _CACHE and dropped whenever it is cleared or restored
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
    """How one fused-adjoint call spreads its rows (``csrc/frontier_grid.cu``
    ``Split``): pass 1 blocks of ``points`` grid points (a power of two
    dividing the block; block / points channel slices each), pass 2 blocks
    of ``t_chunk`` grid points by ``k_chunk`` channels, and epilogue blocks
    of ``ep_chunk`` channels; in both, one thread per channel up to
    ``CHUNK_THREADS``, each walking several beyond."""
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
    """Dynamic shared memory of one block: the forward kernel's tile of
    per-channel constants; for the fused adjoint the larger of pass 1's
    (the tile and one float64 per thread) and pass 2's (t - mu in float64,
    w F(t), t and log t in float32 per grid point of its chunk; without a
    split, of all ``num_t`` points, an upper bound)."""
    _check_mode(mode)
    chan = 4 * (_EMP_CHAN_FLOATS if dist_id == "empirical"
                else _CHAN_FLOATS)
    tile = threads * chan
    if mode == "fwd":
        return tile
    pass1 = _cdiv(tile, 16) * 16 + 8 * threads
    points = num_t if split is None else min(split.t_chunk, num_t)
    return max(pass1, 20 * points)


def check_launch(threads: int, num_t: int, mode: str, dist_id: str,
                 split: Optional[GradSplit] = None) -> None:
    """Raise unless ``threads`` (and, for the fused adjoint, ``split``) is a
    launch the kernels accept for ``num_t`` grid points."""
    if threads % 32 or not 32 <= threads <= MAX_THREADS:
        raise ValueError(f"threads per block must be a multiple of 32 in "
                         f"[32, {MAX_THREADS}], got {threads}")
    if split is None and threads * MAX_POINTS_PER_THREAD < num_t:
        # the forward kernel's threads own the grid points (a split tiles
        # them instead)
        raise ValueError(f"{threads} threads cover at most "
                         f"{threads * MAX_POINTS_PER_THREAD} grid points, "
                         f"num_t={num_t}")
    if split is not None:
        p, tc, kc, ec = split
        if p < 1 or p & (p - 1) or threads % p:
            raise ValueError(f"split points={p} must be a power of two "
                             f"dividing {threads} threads")
        if min(tc, kc, ec) < 1:
            raise ValueError(f"split chunks must be >= 1, got t_chunk={tc}, "
                             f"k_chunk={kc}, ep_chunk={ec}")
    need = smem_bytes(threads, num_t, mode, dist_id, split)
    if need > SMEM_LIMIT_BYTES:
        raise ValueError(f"launch needs {need} bytes of shared memory, over "
                         f"the {SMEM_LIMIT_BYTES} a block may use")


def pick_threads(num_t: int, mode: str, dist_id: str) -> int:
    """The launch-shape model: 256 threads, more where num_t needs them."""
    per = -(-num_t // MAX_POINTS_PER_THREAD)
    threads = max(DEFAULT_THREADS, -(-per // 32) * 32)
    check_launch(threads, num_t, mode, dist_id)
    return threads


def pick_split(F: int, K: int, num_t: int, mode: str,
               dist_id: str) -> GradSplit:
    """The split model of the fused adjoint: each tile or chunk the widest
    power of two that still gives TARGET_BLOCKS blocks per launch (pass 1:
    F * T / points; pass 2: F * T / t_chunk * K / k_chunk; epilogue:
    F * K / ep_chunk). Pass 1's tile is no wider than the largest power of
    two dividing its block; pass 2 splits the grid before it gives a thread
    fewer channels than one, so its blocks stay CHUNK_THREADS wide where K
    allows. Where F alone fills the card, each launch is one block per
    row."""
    _check_mode(mode)
    if mode == "fwd":
        raise ValueError("the forward kernel takes no split")
    threads = pick_threads(num_t, mode, dist_id)
    kt = min(CHUNK_THREADS, _cdiv(K, 32) * 32)  # pass 2's threads
    t_chunk = _widest(num_t, F * _cdiv(K, kt), _pow2_ceil(num_t),
                      MIN_T_CHUNK)
    per_thread = _widest(_cdiv(K, kt), F * _cdiv(num_t, t_chunk),
                         _pow2_ceil(_cdiv(K, kt)), 1)
    split = GradSplit(
        points=_widest(num_t, F, min(256, _pow2_ceil(num_t),
                                     threads & -threads), MIN_POINTS),
        t_chunk=t_chunk, k_chunk=kt * per_thread,
        ep_chunk=_widest(K, F, _pow2_ceil(K), 1))
    check_launch(threads, num_t, mode, dist_id, split)
    return split


def split_blocks(F: int, K: int, num_t: int,
                 split: GradSplit) -> Tuple[int, int, int]:
    """Blocks of the three launches of one fused-adjoint call: (pass 1,
    pass 2, epilogue)."""
    return (F * _cdiv(num_t, split.points),
            F * _cdiv(num_t, split.t_chunk) * _cdiv(K, split.k_chunk),
            F * _cdiv(K, split.ep_chunk))


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
    """The fused adjoint's split for a launch: the in-process cache (or a
    restored snapshot), else :func:`pick_split`."""
    key = _key(F, K, num_t, "split", mode, dist_id)
    hit = _CACHE.get(key)
    if hit is not None:
        return GradSplit(*hit["value"])
    split = pick_split(F, K, num_t, mode, dist_id)
    _CACHE[key] = {"value": list(split), "source": "model"}
    return split


def grad_plan(F: int, K: int, num_t: int, mode: str,
              dist_id: str) -> Tuple[int, GradSplit, int]:
    """``(threads, split, scratch accumulators)`` of one fused-adjoint call
    from :func:`lookup` and :func:`lookup_split`, held to the card's limits
    by :func:`check_launch`; kept until the cache is cleared or restored,
    so a PGD step pays a dictionary lookup for it."""
    key = (F, K, num_t, mode, dist_id)
    plan = _PLANS.get(key)
    if plan is None:
        threads = lookup(F, K, num_t, mode=mode, dist_id=dist_id)
        split = lookup_split(F, K, num_t, mode=mode, dist_id=dist_id)
        check_launch(threads, num_t, mode, dist_id, split)
        plan = _PLANS[key] = (threads, split, grad_scratch_elems(
            F, K, num_t, dist_id, mode == "pgrad", split))
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
