"""Beyond the paper: the partitioner inside a training loop's join, on the
port (the repository's ``benchmarks/partitioned_training.py``).

Two heterogeneous pods (one fast and stable, one slow and noisy) take
microbatches for 150 simulated steps under three scheduling policies; the
join is the cross-pod gradient reduction. Compared: the realized join time
(mean, variance after 20 steps of burn-in) and throughput in microbatches
per simulated second. Asserted: frontier beats equal on both. Only the
balancer and ``ClusterSim`` run (no model); the balancer solves on
``device``.

    PYTHONPATH=src python -m repro_torch.bench.partitioned_training --device cpu
"""
from __future__ import annotations

import argparse

import numpy as np

from ..device import resolve_device
from ..sched import UncertaintyAwareBalancer
from ..sim import Channel, ClusterSim
from .common import emit, save_table

STEPS = 150
POLICIES = ("equal", "inverse_mu", "frontier")


def _run(policy: str, steps: int = STEPS, seed: int = 0, device="cuda"):
    # per-pod sec per *microbatch*: pod0 fast+stable, pod1 slow+noisy
    sim = ClusterSim([Channel(mu=0.9, sigma=0.05), Channel(mu=1.5, sigma=0.45)],
                     seed=seed)
    bal = UncertaintyAwareBalancer(2, lam=0.05, policy=policy, device=device)
    total_micro = 8
    join_times, done = [], 0
    for i in range(steps):
        k = bal.assign(total_micro)
        # run_step normalizes counts to batch fractions; channel rates are
        # sec per *microbatch*, so scale the realized times back to seconds
        t, durs = sim.run_step(k.astype(np.float64))
        t, durs = t * total_micro, durs * total_micro
        bal.observe(durs, k.astype(np.float64))
        if i >= 20:
            join_times.append(t)
            done += int(k.sum())
    jt = np.asarray(join_times)
    return jt.mean(), jt.var(), done / jt.sum()


def run(device="cuda") -> dict:
    """The three policies on ``device``; returns policy -> (join mean,
    join var, microbatches per second)."""
    dev = resolve_device(device)
    rows = []
    res = {}
    for policy in POLICIES:
        mu, var, thr = _run(policy, device=dev)
        rows.append((policy, mu, var, thr))
        res[policy] = (mu, var, thr)
        emit(f"parttrain_{policy}", mu * 1e6,
             f"join_var={var:.4f};microbatches_per_s={thr:.3f}")
    save_table("partitioned_training.csv",
               "policy,join_mu,join_var,micro_per_s", rows)
    assert res["frontier"][0] < res["equal"][0]
    assert res["frontier"][2] > res["equal"][2]  # higher throughput
    return res


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    args = ap.parse_args(argv)
    res = run(device=args.device)
    print(res)
    return res


if __name__ == "__main__":
    main()
