"""The paper's second scenario as a workflow DAG, on the port: the
repository's ``examples/file_transfer.py``.

A large file split over K parallel network paths (heavy-tailed lognormal
transfer times, the WAN regime), then reassembled and verified: the
two-stage ``StageDAG`` transfer -> assemble. ``solve_dag`` (150 steps, two
restarts, T = 1024, ``lam_var`` 0.05) optimizes the shard split for the
end-to-end makespan; the example compares it with all bytes down the
fastest path and with equal shards on the shared evaluator (asserted: the
split beats one channel and is no worse than equal shards), then checks
the composed prediction against ``WorkflowSim`` Monte-Carlo trials.

    PYTHONPATH=src python -m repro_torch.bench.file_transfer --device cpu --trials 4000
"""
from __future__ import annotations

import argparse

import numpy as np

from ..device import resolve_device
from ..sim import WorkflowSim
from ..workflow import Stage, StageDAG, evaluate_dag, solve_dag

STEPS, RESTARTS, NUM_T = 150, 2, 1024
TRIALS = 4000
CHANNELS = 4


def make_dag(channels: int = CHANNELS) -> StageDAG:
    """Per-file transfer stats (seconds): one fast but jittery path,
    progressively steadier overlay routes; one fast, steady assembly."""
    k = channels
    mus = np.linspace(16.0, 30.0, k)
    sigmas = np.asarray([7.0] + [2.2] * (k - 1))[:k]
    transfer = Stage("transfer", mus, sigmas, family="lognormal")
    assemble = Stage("assemble", np.asarray([3.0]), np.asarray([0.3]),
                     family="lognormal")
    return StageDAG([transfer, assemble], [("transfer", "assemble")])


def run(device="cuda", trials: int = TRIALS, channels: int = CHANNELS,
        steps: int = STEPS) -> dict:
    """The example on ``device``: the joint solve, its two baselines (with
    the reference's asserts) and the Monte-Carlo check."""
    dev = resolve_device(device)
    dag = make_dag(channels)
    k = channels
    mus = dag.stages[0].mus
    sigmas = dag.stages[0].sigmas
    dec = solve_dag(dag, lam_var=0.05, steps=steps, restarts=RESTARTS,
                    num_t=NUM_T, device=dev)
    w = dec.weights["transfer"]

    # baselines: all bytes down the single fastest path / equal shards
    single = np.zeros(k)
    single[int(np.argmin(mus))] = 1.0
    base = evaluate_dag(dag, {"transfer": single, "assemble": np.ones(1)},
                        device=dev)
    equal = evaluate_dag(dag, {"transfer": np.full(k, 1.0 / k),
                               "assemble": np.ones(1)}, device=dev)

    print(f"paths: mu={mus.round(1).tolist()} "
          f"sigma={sigmas.round(1).tolist()} (s per file, lognormal)")
    print(f"optimized shard split: {np.round(w, 3).tolist()}")
    rows = [("single fastest path", base), ("equal shards", equal),
            ("joint DAG solve", dec)]
    for name, d in rows:
        print(f"  {name:22s} E[T]={d.makespan_mu:7.3f}s  "
              f"Var[T]={d.makespan_var:7.3f}")
    assert dec.makespan_mu < base.makespan_mu, "split must beat one channel"
    assert dec.makespan_mu <= equal.makespan_mu + 1e-6

    # Monte-Carlo validation of the composed prediction (release = shard
    # max, assemble rides after: the discrete-event ground truth)
    sim = WorkflowSim.from_dag(dag, seed=7)
    rng = np.random.default_rng(11)
    ts = np.asarray([sim.run_dag_step(dag, dec.weights, rng=rng)[0]
                     for _ in range(trials)])
    rel = abs(ts.mean() - dec.makespan_mu) / dec.makespan_mu
    print(f"MC check ({trials} trials): empirical E[T]={ts.mean():.3f}s "
          f"Var={ts.var():.3f} (predicted {dec.makespan_mu:.3f}/"
          f"{dec.makespan_var:.3f}, rel mu err {rel:.1%})")
    speedup = base.makespan_mu / dec.makespan_mu
    print(f"speedup vs single channel: {speedup:.2f}x "
          f"(variance {base.makespan_var / max(dec.makespan_var, 1e-9):.1f}x"
          f" lower)" if dec.makespan_var < base.makespan_var else
          f"speedup vs single channel: {speedup:.2f}x")
    return {"device": str(dev), "weights": w, "decision": dec,
            "single": base, "equal": equal, "mc_mean": float(ts.mean()),
            "mc_var": float(ts.var()), "mc_rel_mu_err": float(rel),
            "speedup": float(speedup)}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trials", type=int, default=TRIALS,
                    help="Monte-Carlo trials validating the composed moments")
    ap.add_argument("--channels", type=int, default=CHANNELS)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    args = ap.parse_args(argv)
    return run(device=args.device, trials=args.trials,
               channels=args.channels)


if __name__ == "__main__":
    main()
