"""Shared experiment utilities: timing and CSV emission.

The timers take the ``device`` the timed function runs on: on the card
each call is followed by ``torch.cuda.synchronize()`` inside the timed
region, so a time is the work's and not its enqueue's. ``save_table``
writes under ``experiments/torch/`` of the checkout this package lies in,
never beside the JAX package's tables in ``experiments/bench/``.
"""
from __future__ import annotations

import os
import time

import torch

RESULTS_DIR = os.path.normpath(os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "..", "..", "..",
    "experiments", "torch"))


def emit(name: str, us_per_call: float, derived: str = "") -> None:
    print(f"{name},{us_per_call:.2f},{derived}")


def synchronize(device) -> None:
    """Wait for the card when ``device`` is a CUDA device."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def timeit(fn, *args, repeats: int = 5, warmup: int = 2,
           device="cpu") -> float:
    """Median wall time per call in microseconds."""
    return timeit_stats(fn, *args, repeats=repeats, warmup=warmup,
                        device=device)[0]


def timeit_stats(fn, *args, repeats: int = 5, warmup: int = 2,
                 device="cpu"):
    """(median_us, p90_us) wall time per call on the host clock, each call
    synchronized on ``device``."""
    for _ in range(warmup):
        fn(*args)
        synchronize(device)
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn(*args)
        synchronize(device)
        times.append((time.perf_counter() - t0) * 1e6)
    times.sort()
    p90 = times[min(len(times) - 1, int(round(0.9 * (len(times) - 1))))]
    return times[len(times) // 2], p90


def save_table(fname: str, header: str, rows) -> str:
    os.makedirs(RESULTS_DIR, exist_ok=True)
    path = os.path.join(RESULTS_DIR, fname)
    with open(path, "w") as f:
        f.write(header + "\n")
        for r in rows:
            f.write(",".join(str(x) for x in r) + "\n")
    return path
