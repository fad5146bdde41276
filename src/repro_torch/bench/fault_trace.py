"""Failure-aware against failure-blind partitioning, on the port.

The experiment of the repository's ``benchmarks/fault_trace.py``: a
heterogeneous, flaky fleet of 12 channels whose attempts fail with a
per-channel probability drawn from U(0.02, 0.15). Both solvers get the
same true base statistics, so the comparison isolates the pricing model:

* **blind**: the frontier under the normal family, which loads a flaky
  channel as if it were reliable;
* **aware**: the frontier under ``Defective(p, pricing="retry")``, whose
  survival integral prices the geometric retries into both moments.

Both splits replay the identical seeded trace (each tick a generator
seeded ``(seed, tick)``, shared by the two policies) through the
defective-regime ``ClusterSim``; the realized join time per tick is the
score. 300 ticks; ``--smoke`` runs 80.

    PYTHONPATH=src python -m repro_torch.bench.fault_trace --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.bench.fault_trace --json   # the card

``--json`` writes ``experiments/torch/fault_trace.json`` (``_smoke`` for
the smoke run), never a repository-root ``BENCH_*.json``.
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from ..core.distributions import Defective
from ..core.partitioner import optimize_weights
from ..device import resolve_device
from ..sim.cluster import ClusterSim
from .common import RESULTS_DIR

CHANNELS = 12
TICKS = 300
SMOKE_TICKS = 80
FAIL_RANGE = (0.02, 0.15)   # per-channel attempt-failure probabilities
LAM = 0.05                  # frontier risk weight (both policies)


def run(ticks: int = TICKS, channels: int = CHANNELS, seed: int = 0,
        smoke: bool = False, device="cuda") -> dict:
    dev = resolve_device(device)
    sim = ClusterSim.heterogeneous(channels, seed=seed, dist="defective",
                                   fail_range=FAIL_RANGE)
    mus, sigmas = sim.true_params
    p = np.array([c.fail_p for c in sim.channels])
    weights = {
        "blind": optimize_weights(mus, sigmas, lam=LAM, family="normal",
                                  device=dev).weights,
        "aware": optimize_weights(mus, sigmas, lam=LAM,
                                  family=Defective(p.astype(np.float32),
                                                   pricing="retry"),
                                  device=dev).weights,
    }
    joins = {"blind": [], "aware": []}
    for t in range(ticks):
        # one generator per (policy, tick), seeded identically: both
        # policies face the same rate and retry draws each tick
        for name, w in weights.items():
            joins[name].append(
                sim.run_step(w, rng=np.random.default_rng((seed, t)))[0])
    stats = {}
    for name, xs in joins.items():
        xs = np.asarray(xs)
        stats[name] = {"mean": float(xs.mean()), "var": float(xs.var()),
                       "p50": float(np.percentile(xs, 50)),
                       "p99": float(np.percentile(xs, 99))}
    improvement = 100.0 * (stats["blind"]["mean"] - stats["aware"]["mean"]) \
        / stats["blind"]["mean"]
    return {
        "bench": "fault_trace",
        "smoke": smoke,
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
        "ticks": ticks,
        "channels": channels,
        "mean_fail_p": float(p.mean()),
        "makespan": stats,
        "improvement_pct": float(improvement),
        "weights": {n: np.asarray(w).tolist() for n, w in weights.items()},
        "entries": [
            {"name": f"fault_trace_{name}", "policy": name, "ticks": ticks,
             "mean_s": stats[name]["mean"], "var_s2": stats[name]["var"],
             "p99_s": stats[name]["p99"]}
            for name in ("blind", "aware")
        ],
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true",
                    help="reduced scale (80 ticks)")
    ap.add_argument("--ticks", type=int, default=None)
    ap.add_argument("--channels", type=int, default=CHANNELS)
    ap.add_argument("--json", action="store_true",
                    help="write experiments/torch/fault_trace[_smoke].json")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    ap.add_argument("--out", default=None, help="JSON output path")
    args = ap.parse_args(argv)
    ticks = args.ticks or (SMOKE_TICKS if args.smoke else TICKS)
    res = run(ticks=ticks, channels=args.channels, smoke=args.smoke,
              device=args.device)
    if args.json:
        path = args.out or os.path.normpath(os.path.join(
            RESULTS_DIR, "fault_trace_smoke.json" if args.smoke
            else "fault_trace.json"))
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as fh:
            json.dump(res, fh, indent=1, sort_keys=True)
        print(f"wrote {path}")
    print(json.dumps({k: res[k] for k in ("makespan", "improvement_pct",
                                          "mean_fail_p")}))
    return res


if __name__ == "__main__":
    main()
