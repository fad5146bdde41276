"""Launch shapes of the frontier kernels on Hopper.

Two backends, one key scheme:

* ``cuda``: threads per block of the CUDA kernels. The launch-shape model
  (:func:`pick_threads`) takes 256 threads, or more where the grid needs
  them (each thread owns at most ``MAX_POINTS_PER_THREAD`` grid points),
  and :func:`check_launch` holds a shape to the card's limits: a multiple
  of 32 up to 512 threads, and the dynamic shared memory of
  :func:`smem_bytes` within the 227 KB a block may use.
* ``plain``: candidate rows per chunk of the plain PyTorch path, sized so
  the (rows, T, K) intermediates stay within a memory budget.

Keys carry the mode — ``fwd`` (forward moments), ``grad`` (W-adjoints, the
PGD step) or ``pgrad`` (full-parameter adjoints) — and the family, since the
shared-memory tile and the accumulator count differ by family: the normal,
lognormal, drift and defective families keep 5 floats of per-channel
constants, the empirical mixture 17; the fused adjoint keeps 2 to 6
accumulators per channel (drift 4 in grad mode, defective 6 in pgrad mode).

The in-process cache is filled by the model and keyed on what the model
reads; :func:`cache_state` snapshots it so a restored process launches the
same shapes (the launch shape fixes the float reduction order). A timed
sweep, and a cache file for its results, are later work.
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

from ..core.distributions import EMP_COMPONENTS, extra_rows, family_features

__all__ = ["ROW_BUCKETS", "MODES", "MAX_THREADS", "MAX_POINTS_PER_THREAD",
           "MAX_NUM_T", "SMEM_LIMIT_BYTES", "bucket_rows", "accumulators",
           "smem_bytes", "pick_threads", "pick_block_rows", "check_launch",
           "lookup", "clear_cache", "cache_state", "load_cache_state"]

# serving row-count buckets: a stacked launch pads its row axis up to one
ROW_BUCKETS: Tuple[int, ...] = (8, 16, 32, 64, 128, 256, 512, 1024, 2048,
                                4096)
MODES = ("fwd", "grad", "pgrad")

MAX_THREADS = 512            # the kernels' __launch_bounds__
MAX_POINTS_PER_THREAD = 8    # register-resident grid points per thread
MAX_NUM_T = MAX_THREADS * MAX_POINTS_PER_THREAD
DEFAULT_THREADS = 256
SMEM_LIMIT_BYTES = 232448    # per block on an H100 (227 KB)

# per-channel constants staged in shared memory, in floats
_CHAN_FLOATS = 5
_EMP_CHAN_FLOATS = 2 + 5 * EMP_COMPONENTS

# peak bytes of one plain-path chunk's (rows, T, K) intermediates
PLAIN_CHUNK_BYTES = 1 << 30

_KEY_VERSION = "v2"
_CACHE: Dict[str, dict] = {}


def _check_mode(mode: str) -> None:
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")


def _key(F: int, K: int, num_t: int, backend: str, mode: str,
         dist_id: str) -> str:
    # the threads model reads (T, mode, family); the chunk model F and K too
    rows = f":F{F}:K{K}" if backend == "plain" else ""
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


def smem_bytes(threads: int, num_t: int, mode: str, dist_id: str) -> int:
    """Dynamic shared memory of one block: a tile of per-channel constants
    (pass 1); the fused kernel reuses it for four arrays over the grid
    (pass 2)."""
    _check_mode(mode)
    chan = 4 * (_EMP_CHAN_FLOATS if dist_id == "empirical"
                else _CHAN_FLOATS)
    tile = threads * chan
    if mode == "fwd":
        return tile
    # t - mu (float64), w F(t), t and log t (float32) per grid point
    return max(tile, 20 * num_t)


def check_launch(threads: int, num_t: int, mode: str, dist_id: str) -> None:
    """Raise unless ``threads`` is a launch the kernels accept for
    ``num_t`` grid points."""
    if threads % 32 or not 32 <= threads <= MAX_THREADS:
        raise ValueError(f"threads per block must be a multiple of 32 in "
                         f"[32, {MAX_THREADS}], got {threads}")
    if threads * MAX_POINTS_PER_THREAD < num_t:
        raise ValueError(f"{threads} threads cover at most "
                         f"{threads * MAX_POINTS_PER_THREAD} grid points, "
                         f"num_t={num_t}")
    need = smem_bytes(threads, num_t, mode, dist_id)
    if need > SMEM_LIMIT_BYTES:
        raise ValueError(f"launch needs {need} bytes of shared memory, over "
                         f"the {SMEM_LIMIT_BYTES} a block may use")


def pick_threads(num_t: int, mode: str, dist_id: str) -> int:
    """The launch-shape model: 256 threads, more where num_t needs them."""
    per = -(-num_t // MAX_POINTS_PER_THREAD)
    threads = max(DEFAULT_THREADS, -(-per // 32) * 32)
    check_launch(threads, num_t, mode, dist_id)
    return threads


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


def clear_cache() -> None:
    """Drop the in-process cache."""
    _CACHE.clear()


def cache_state() -> dict:
    """Snapshot of the in-process cache, for a checkpoint."""
    return {k: dict(v) for k, v in _CACHE.items()}


def load_cache_state(state: dict) -> None:
    """Restore a :func:`cache_state` snapshot."""
    for k, v in state.items():
        _CACHE[k] = dict(v)
