"""Quickstart on the port: the paper's partitioning procedure in five
minutes, the scenario of the repository's ``examples/quickstart.py``.

1. The theory curves mu(f), sigma^2(f) of two uncertain channels (the
   paper's Fig 1 parameters: N(30, 2^2) and N(20, 6^2)), their efficient
   frontier and the scalarized pick at lam = 0.1 (``frontier_2ch``,
   ``select_on_frontier``).
2. The direct optimizer (``optimize_2ch``).
3. The online Bayesian balancer discovering the split from noisy
   observations alone: 250 steps against ``ClusterSim`` (seed 0) under the
   "equal" and "frontier" policies, join statistics after a 50-step
   burn-in.

Every solve runs on ``device`` (the CUDA kernels by default, their plain
versions with ``--device cpu``); the simulator is the reference's numpy
world, draw for draw.

    PYTHONPATH=src python -m repro_torch.bench.quickstart --device cpu
"""
from __future__ import annotations

import argparse

import numpy as np

from ..core import frontier_2ch, optimize_2ch, select_on_frontier
from ..device import resolve_device
from ..sched import UncertaintyAwareBalancer
from ..sim import Channel, ClusterSim

MU_I, SG_I, MU_J, SG_J = 30.0, 2.0, 20.0, 6.0   # paper Fig 1
LAM = 0.1
STEPS, BURN_IN = 250, 50
POLICIES = ("equal", "frontier")


def run(device="cuda") -> dict:
    """The three parts on ``device``, printed as the example prints them;
    returns the frontier, the picks and each policy's join statistics."""
    dev = resolve_device(device)
    res = frontier_2ch(MU_I, SG_I, MU_J, SG_J, num_f=101, device=dev)
    i_mu, i_var = np.argmin(res.mu), np.argmin(res.var)
    print("=== Paper theory (Fig 1/2) ===")
    print(f"fastest single channel        : mu=20.00, var=36.00")
    print(f"min-mu split   f={res.f[i_mu]:.2f}      : mu={res.mu[i_mu]:.2f}, "
          f"var={res.var[i_mu]:.2f}")
    print(f"min-var split  f={res.f[i_var]:.2f}      : mu={res.mu[i_var]:.2f}"
          f", var={res.var[i_var]:.2f}")
    print(f"efficient frontier: {int(res.efficient.sum())} points between "
          f"f={res.f[res.efficient].min():.2f} and "
          f"f={res.f[res.efficient].max():.2f}")
    _, (f_star, mu_star, var_star) = select_on_frontier(res, lam=LAM)
    print(f"scalarized pick (lam={LAM})     : f={f_star:.2f} -> "
          f"mu={mu_star:.2f}, var={var_star:.2f}\n")

    dec = optimize_2ch(MU_I, SG_I, MU_J, SG_J, lam=LAM, device=dev)
    print(f"optimize_2ch -> weights={np.round(dec.weights, 3)}, "
          f"predicted mu={dec.mu:.2f} var={dec.var:.2f}\n")

    print("=== Online Bayesian scheduler vs equal split ===")
    policies = {}
    for policy in POLICIES:
        sim = ClusterSim([Channel(MU_I, SG_I), Channel(MU_J, SG_J)], seed=0)
        bal = UncertaintyAwareBalancer(2, lam=LAM, policy=policy, device=dev)
        times = []
        for i in range(STEPS):
            w = bal.weights()
            t, durs = sim.run_step(w)
            bal.observe(durs, w)
            if i >= BURN_IN:
                times.append(t)
        times = np.asarray(times)
        w = bal.weights()
        policies[policy] = {"weights": w, "mean": float(times.mean()),
                            "var": float(times.var()),
                            "p99": float(np.percentile(times, 99))}
        print(f"{policy:9s}: final split={np.round(w, 2)}  "
              f"join mean={times.mean():6.2f}  var={times.var():6.2f}  "
              f"p99={np.percentile(times, 99):6.2f}")
    return {"device": str(dev), "frontier": res,
            "min_mu": (float(res.f[i_mu]), float(res.mu[i_mu]),
                       float(res.var[i_mu])),
            "min_var": (float(res.f[i_var]), float(res.mu[i_var]),
                        float(res.var[i_var])),
            "efficient_points": int(res.efficient.sum()),
            "pick": (float(f_star), float(mu_star), float(var_star)),
            "optimize_2ch": dec, "policies": policies}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    args = ap.parse_args(argv)
    return run(device=args.device)


if __name__ == "__main__":
    main()
