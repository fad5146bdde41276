"""Fault tolerance and elasticity at fleet scale, on the port: the scenario
of the repository's ``examples/elastic_fleet.py``.

A 16-channel fleet (``ClusterSim.heterogeneous(16, mu_range=(8, 16),
seed=5)``) processes partitioned work for 240 steps under a
``StragglerPolicy`` over an ``UncertaintyAwareBalancer(lam=0.03)`` solving
on ``device``, while the run injects

* a 4x slowdown on channel 3 at step 60 (the straggler: quarantined by
  z-score, or priced in as drift with ``--mitigation drift``),
* a hard failure of channel 7 at step 120 (heartbeat loss: elastic
  removal),
* two channels joining at step 160 (elastic scale-up with weak priors).

The partitioner re-solves the frontier over the surviving channels every
step. ``run`` returns the join statistics before and after the chaos, the
policy's decisions and the tick times.

    PYTHONPATH=src python -m repro_torch.bench.elastic_fleet --device cpu
    PYTHONPATH=src python -m repro_torch.bench.elastic_fleet --mitigation drift
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from ..device import resolve_device
from ..sched import StragglerPolicy, UncertaintyAwareBalancer
from ..sim import Channel, ClusterSim

N = 16
STEPS = 240
SLOW_AT, SLOW_IDX, SLOW_FACTOR = 60, 3, 4.0
FAIL_AT, FAIL_IDX = 120, 7
JOIN_AT, JOINS = 160, 2
REPORT_EVERY = 40


def _stats(x) -> dict:
    x = np.asarray(x)
    return {"mean": float(x.mean()), "var": float(x.var()),
            "p99": float(np.percentile(x, 99))}


def run(device="cuda", mitigation: str = "quarantine") -> dict:
    """The scenario on ``device``. Every split is checked to be a simplex
    over the live fleet as it is made."""
    dev = resolve_device(device)
    sim = ClusterSim.heterogeneous(N, mu_range=(8.0, 16.0), seed=5)
    bal = UncertaintyAwareBalancer(N, lam=0.03, device=dev)
    pol = StragglerPolicy(bal, z_threshold=3.0, quarantine_after=2,
                          probation_period=30, mitigation=mitigation)
    window, ticks_s, fleet = [], [], []
    flagged_after_slow, quarantined_ever, rho_max = set(), set(), {}
    for step in range(STEPS):
        t0 = time.perf_counter()
        w = pol.weights()         # host numpy: the solve has finished
        ticks_s.append(time.perf_counter() - t0)
        if not (w.shape == (bal.num_channels,) and np.all(np.isfinite(w))
                and w.min() >= 0.0 and abs(w.sum() - 1.0) < 1e-6):
            raise AssertionError(f"step {step}: split is not a simplex: {w}")
        t, durs = sim.run_step(w)
        flagged = pol.record(durs, w)
        window.append(t)
        fleet.append(bal.num_channels)
        if step >= SLOW_AT:
            flagged_after_slow.update(flagged)
        quarantined_ever.update(pol.quarantined)
        for i, r in pol.drift_rhos.items():
            rho_max[i] = max(rho_max.get(i, 0.0), r)

        if step == SLOW_AT:
            sim.inject_slowdown(SLOW_IDX, SLOW_FACTOR)
            print(f"step {step}: >>> channel {SLOW_IDX} degrades "
                  f"{SLOW_FACTOR:g}x (contention)")
        if step == FAIL_AT:
            sim.inject_failure(FAIL_IDX)
            pol.fail(FAIL_IDX)
            del sim.channels[FAIL_IDX]
            print(f"step {step}: >>> channel {FAIL_IDX} hard-fails; "
                  f"removed (fleet={bal.num_channels})")
        if step == JOIN_AT:
            for _ in range(JOINS):
                sim.channels.append(Channel(mu=9.0, sigma=0.8))
                pol.join(prior_mean=10.0)
            print(f"step {step}: >>> {JOINS} channels join "
                  f"(fleet={bal.num_channels})")
        if step % REPORT_EVERY == REPORT_EVERY - 1:
            s = _stats(window[-REPORT_EVERY:])
            rhos = {i: round(r, 3) for i, r in pol.drift_rhos.items()}
            print(f"step {step}: join mean={s['mean']:.2f} "
                  f"var={s['var']:.3f} p99={s['p99']:.2f} "
                  f"quarantined={sorted(pol.quarantined)} drift={rhos}")

    before, after = _stats(window[20:60]), _stats(window[-40:])
    for name, st in (("pre-chaos ", before), ("post-chaos", after)):
        print(f"{name} join: mean={st['mean']:.2f} var={st['var']:.3f}")
    ticks = np.asarray(ticks_s)
    return {"device": str(dev), "mitigation": mitigation,
            "before": before, "after": after,
            "flagged_after_slow": sorted(flagged_after_slow),
            "quarantined_ever": sorted(quarantined_ever),
            "drift_rho_max": {int(i): float(r) for i, r in rho_max.items()},
            "fleet_at": {"start": fleet[0], "after_fail": fleet[FAIL_AT + 1],
                         "after_join": fleet[JOIN_AT + 1], "end": fleet[-1]},
            "tick_ms": {"mean": 1e3 * float(ticks.mean()),
                        "p50": 1e3 * float(np.median(ticks)),
                        "max": 1e3 * float(ticks.max())}}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    ap.add_argument("--mitigation", default="quarantine",
                    choices=("quarantine", "drift"))
    args = ap.parse_args(argv)
    res = run(device=args.device, mitigation=args.mitigation)
    print("scheduler absorbed a straggler, a failure and two joins.")
    return res


if __name__ == "__main__":
    main()
