"""Paper Figures 3 and 4: partitioned convex optimization (the paper's
first laboratory experiment), on the port.

A least-squares-on-probabilities logistic objective over synthetic data D
(the JAX package's numpy draws) is split into unequal workloads
D_i = f|D| and D_j = (1-f)|D|. Each "machine" runs a real solve of its
share on ``device`` (300 steps of momentum gradient descent, torch
autograd), and the joined solution is theta = f theta_i + (1-f) theta_j
(the paper's equation). Per-trial completion times come from the
contended-channel simulator with the paper's two-VM setup (2000 trials per
f, numpy draws: the mu and var columns are the JAX package's bit for bit).

Asserted: both completion moments dip below the unpartitioned (f = 0 and
f = 1) workflow, and every joined solution stays near the full-data
optimum.

    PYTHONPATH=src python -m repro_torch.bench.fig34_convex_opt --device cpu
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from ..device import resolve_device
from ..sim import Channel, ClusterSim
from .common import emit, save_table, timeit

TRIALS = 2000     # contended trials per f


def _make_problem(n=2048, d=16, seed=0, device="cuda"):
    """(X, y, w_true): X (n, d) and y (n,) float32 on ``device``."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    w_true = rng.normal(size=(d,))
    X = rng.normal(size=(n, d))
    y = (1 / (1 + np.exp(-X @ w_true))
         > rng.uniform(size=n)).astype(np.float32)
    return (torch.tensor(X, dtype=torch.float32, device=dev),
            torch.tensor(y, device=dev), w_true)


def _mse(w, X, y):
    return torch.mean((torch.sigmoid(X @ w) - y) ** 2)


def _solve(X, y, steps=300, lr=0.5, reg=1e-3):
    """Least-squares-on-probabilities objective (the paper's choice)
    minimized by gradient descent with momentum, on X's device; returns
    (w, final loss)."""
    def loss(w):
        return _mse(w, X, y) + reg * torch.sum(w * w)

    w = torch.zeros(X.shape[1], device=X.device)
    v = torch.zeros_like(w)
    for _ in range(steps):
        wg = w.detach().requires_grad_(True)
        (g,) = torch.autograd.grad(loss(wg), wg)
        v = 0.9 * v - lr * g
        w = w + v
    with torch.no_grad():
        return w, float(loss(w))


def run(device="cuda") -> dict:
    """The experiment with its solves on ``device``; returns the table
    (f, mu, var, joined_mse) and the summary."""
    dev = resolve_device(device)
    X, y, _ = _make_problem(device=dev)
    n = X.shape[0]

    # the paper's two 2667 MHz VMs with induced contention
    def make_sim(seed):
        return ClusterSim([Channel(mu=30.0, sigma=2.0),
                           Channel(mu=20.0, sigma=6.0)], seed=seed)

    fs = np.round(np.arange(0.0, 1.01, 0.1), 2)
    rows = []
    quality = {}
    for f in fs:
        ni = int(round(f * n))
        # the real partitioned optimization (once per f: deterministic)
        if 0 < ni < n:
            wi, _ = _solve(X[:ni], y[:ni])
            wj, _ = _solve(X[ni:], y[ni:])
            w = float(f) * wi + float(1 - f) * wj
        else:
            w, _ = _solve(X, y)
        with torch.no_grad():
            quality[float(f)] = float(_mse(w, X, y))

        # the completion-time distribution over contended trials
        sim = make_sim(seed=int(f * 100) + 1)
        times = [sim.run_step([f, 1 - f])[0] for _ in range(TRIALS)]
        rows.append((f, np.mean(times), np.var(times), quality[float(f)]))

    save_table("fig34_convex_opt.csv", "f,mu,var,joined_mse", rows)
    mus = np.array([r[1] for r in rows])
    vrs = np.array([r[2] for r in rows])
    # the paper's claim: interior minima beat both unpartitioned endpoints
    assert mus.min() < min(mus[0], mus[-1])
    assert vrs.min() < min(vrs[0], vrs[-1])
    # joined solutions stay near the full-data optimum (convexity)
    full = quality[0.0]
    worst = max(quality.values())
    assert worst < full * 2.0 + 0.05

    us = timeit(lambda: _solve(X[: n // 2], y[: n // 2], steps=50),
                repeats=3, device=dev)
    emit("fig34_convex_opt_halfsolve", us,
         f"mu_min={mus.min():.2f}@f={fs[int(np.argmin(mus))]};"
         f"var_min={vrs.min():.3f}@f={fs[int(np.argmin(vrs))]}")
    return {"mu_min_f": float(fs[int(np.argmin(mus))]),
            "var_min_f": float(fs[int(np.argmin(vrs))]),
            "halfsolve_us": us, "rows": rows}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the solves on the card) or cpu")
    res = run(device=ap.parse_args(argv).device)
    print({k: v for k, v in res.items() if k != "rows"})
    return res


if __name__ == "__main__":
    main()
