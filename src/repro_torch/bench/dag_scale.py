"""Workflow-DAG partitioning at scale: joint solve against stage-by-stage
greedy, on the port.

The experiment of the repository's ``benchmarks/dag_scale.py``: a 32-stage
fork-join DAG (a source, 10 parallel 3-stage branches, a sink), K = 256
channels per stage, T = 256 quadrature points, 60 PGD steps, one random
restart, solved two ways:

* ``greedy`` — each stage alone on its own expected join time
  (``solve_dag_greedy``: a Python loop of ``optimize_weights`` solves);
* ``joint``  — ``solve_dag``: every stage split descends the composed
  makespan together, each moment evaluation one stacked call per family
  group (one here: ``family_groups == 1``).

Reported: both decisions' predicted makespan moments on the shared
evaluator at ``eval_num_t``, their realized makespans over paired
``WorkflowSim`` trials (the same generator seed per trial for both), warm
wall times (median and p90), the joint solver's phase breakdown, its
launches per solve by mode and its host reads per PGD step, and a joint-only
scale point at 512 stages (170 branches). ``--smoke`` runs 8 stages at K =
32, T = 128, 30 steps, 50 trials, and keeps the 512-stage structure with K,
T and steps cut.

    PYTHONPATH=src python -m repro_torch.bench.dag_scale --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.bench.dag_scale --json   # the card

``--json`` writes ``experiments/torch/dag_scale.json`` (``_smoke`` for the
smoke run), never a repository-root ``BENCH_*.json``. At full scale
``main`` then asserts the reference's four gates (:func:`check_gates`).
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from ..device import resolve_device
from ..kernels import frontier_grid as fg
from ..sim.cluster import WorkflowSim
from ..workflow import Stage, StageDAG, solve_dag, solve_dag_greedy
from ..workflow import solve as wsolve
from .common import RESULTS_DIR, timeit_stats

STAGES_BRANCHES = 10   # parallel branches between source and sink
BRANCH_LEN = 3         # stages per branch: S = 2 + 10 * 3 = 32
TICK_K = 256           # channels per stage
TICK_T = 256           # quadrature points per candidate
PGD_STEPS = 60
MC_TRIALS = 200
FULL_REPEATS = 5       # timed warm solves per method
SMOKE_REPEATS = 3
SCALE_BRANCHES = 170   # the scale point: S = 2 + 170 * 3 = 512 stages
SCALE_REPEATS = 3


def make_dag(branches=STAGES_BRANCHES, branch_len=BRANCH_LEN, k=TICK_K,
             seed=0, family="normal") -> StageDAG:
    """source -> ``branches`` parallel ``branch_len``-stage chains -> sink;
    each stage's mus ~ U(10, 40) and sigmas = mus U(0.05, 0.5), drawn in
    the order of the repository's benchmark, so the DAG is its DAG."""
    rng = np.random.default_rng(seed)

    def mk(name):
        mus = rng.uniform(10.0, 40.0, k)
        sigmas = mus * rng.uniform(0.05, 0.5, k)
        return Stage(name, mus, sigmas, family=family)

    stages = [mk("src")]
    edges = []
    for b in range(branches):
        prev = "src"
        for j in range(branch_len):
            s = mk(f"b{b}_{j}")
            stages.append(s)
            edges.append((prev, s.name))
            prev = s.name
        edges.append((prev, "sink"))
    stages.append(mk("sink"))
    return StageDAG(stages, edges)


def mc_makespan(dag, weights, trials, seed=0):
    """Realized makespan (mean, var) over paired trials: trial t draws
    from generator seed 10000 + t, whatever the split."""
    sim = WorkflowSim.from_dag(dag, seed=seed)
    ts = [sim.run_dag_step(dag, weights, rng=10_000 + t)[0]
          for t in range(trials)]
    return float(np.mean(ts)), float(np.var(ts))


def counted(fn):
    """``(result, launches by mode, PGD steps, plateau reads)`` of one
    call: the CUDA kernel calls it made (``frontier_grid.LAUNCHES``; none on
    the CPU) and the solver's host reads (``workflow.solve.SYNCS``)."""
    launches = dict(fg.LAUNCHES)
    syncs = dict(wsolve.SYNCS)
    out = fn()
    return (out, {k: fg.LAUNCHES[k] - launches[k] for k in launches},
            wsolve.SYNCS["steps"] - syncs["steps"],
            wsolve.SYNCS["plateau"] - syncs["plateau"])


def _decision(dec):
    return {"makespan_mu": dec.makespan_mu, "makespan_var": dec.makespan_var,
            "method": dec.method}


def scale_point(smoke: bool, device, repeats: int = SCALE_REPEATS,
                warmup: int = 1) -> dict:
    """Joint-only solve at 512 stages (greedy there would be 512
    sequential stage solves); ``smoke`` keeps the structure and cuts K, T
    and steps."""
    if smoke:
        k, num_t, steps, repeats, warmup = 8, 64, 6, 1, 1
    else:
        k, num_t, steps = TICK_K, TICK_T, PGD_STEPS
    dag = make_dag(SCALE_BRANCHES, BRANCH_LEN, k, seed=1)
    result = {}

    def once():
        result["v"] = counted(lambda: solve_dag(
            dag, steps=steps, restarts=1, num_t=num_t, device=device))

    med, p90 = timeit_stats(once, repeats=repeats, warmup=warmup)
    dec, launches, n_steps, reads = result["v"]
    return {"stages": len(dag.stages), "channels": k, "num_t": num_t,
            "steps": steps, "median_us": med, "p90_us": p90,
            "repeats": repeats, "makespan_mu": dec.makespan_mu,
            "method": dec.method, "family_groups": dec.family_groups,
            "phase_us": dict(dec.profile["phase_us"]),
            "profile": {k2: v for k2, v in dec.profile.items()
                        if k2 != "phase_us"},
            "launches_per_solve": launches, "pgd_steps": n_steps,
            "plateau_reads": reads}


def run(smoke: bool = False, device="cuda", repeats=None,
        scale_repeats: int = SCALE_REPEATS, scale_warmup: int = 1) -> dict:
    """The whole experiment on ``device``; returns the result dict."""
    dev = resolve_device(device)
    if smoke:
        branches, blen, k, num_t, steps, n_trials = 2, 3, 32, 128, 30, 50
        n_rep = SMOKE_REPEATS
    else:
        branches, blen, k, num_t, steps, n_trials = (
            STAGES_BRANCHES, BRANCH_LEN, TICK_K, TICK_T, PGD_STEPS,
            MC_TRIALS)
        n_rep = FULL_REPEATS
    n_rep = repeats or n_rep
    dag = make_dag(branches, blen, k)
    S = len(dag.stages)

    def bench(fn):
        result = {}

        def once():
            result["v"] = counted(fn)

        med, p90 = timeit_stats(once, repeats=n_rep, warmup=1)
        return result["v"], med, p90

    (joint, j_launch, j_steps, j_reads), j_med, j_p90 = bench(
        lambda: solve_dag(dag, steps=steps, restarts=1, num_t=num_t,
                          device=dev))
    (greedy, g_launch, _, _), g_med, g_p90 = bench(
        lambda: solve_dag_greedy(dag, steps=steps, restarts=1, num_t=num_t,
                                 device=dev))
    imp = 100.0 * (1.0 - joint.makespan_mu / greedy.makespan_mu)
    mc_joint = mc_makespan(dag, joint.weights, n_trials)
    mc_greedy = mc_makespan(dag, greedy.weights, n_trials)
    mc_imp = 100.0 * (1.0 - mc_joint[0] / mc_greedy[0])
    scale = scale_point(smoke, dev, repeats=scale_repeats,
                        warmup=scale_warmup)
    return {
        "bench": "dag_scale", "smoke": smoke, "device": str(dev),
        "card": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                 else None),
        "stages": S, "channels": k, "num_t": num_t, "steps": steps,
        "trials": n_trials,
        "joint": {**_decision(joint), "mc_makespan_mu": mc_joint[0],
                  "mc_makespan_var": mc_joint[1],
                  "median_us": j_med, "p90_us": j_p90,
                  "phase_us": dict(joint.profile["phase_us"]),
                  "profile": {k2: v for k2, v in joint.profile.items()
                              if k2 != "phase_us"},
                  "launches_per_solve": j_launch, "pgd_steps": j_steps,
                  "plateau_reads": j_reads},
        "greedy": {**_decision(greedy), "mc_makespan_mu": mc_greedy[0],
                   "mc_makespan_var": mc_greedy[1],
                   "median_us": g_med, "p90_us": g_p90,
                   "phase_us": dict(greedy.profile["phase_us"]),
                   "launches_per_solve": g_launch},
        "weights": {"joint": joint.weights, "greedy": greedy.weights},
        "improvement_pct": imp,
        "realized_improvement_pct": mc_imp,
        "family_groups": joint.family_groups,
        "single_batched_path": joint.family_groups == 1,
        "joint_vs_greedy_wallclock_ratio": j_med / g_med,
        "repeats": n_rep,
        "scale_point": scale,
    }


def check_gates(res: dict) -> None:
    """The reference's acceptance gates, in its order: one batched stage
    path, joint beats greedy on the expected makespan by at least 0.088%
    and on wall clock, and the scale point has 512 stages. Raises
    AssertionError on the first that fails."""
    assert res["single_batched_path"], res["family_groups"]
    assert res["improvement_pct"] >= 0.088, res["improvement_pct"]
    assert res["joint_vs_greedy_wallclock_ratio"] <= 1.0, \
        res["joint_vs_greedy_wallclock_ratio"]
    assert res["scale_point"]["stages"] == 512, res["scale_point"]


def _jsonable(res: dict) -> dict:
    out = dict(res)
    out["weights"] = {m: {n: np.asarray(w).tolist() for n, w in ws.items()}
                      for m, ws in res["weights"].items()}
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true",
                    help="reduced scale (8 stages, K=32)")
    ap.add_argument("--json", action="store_true",
                    help="write experiments/torch/dag_scale[_smoke].json")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    ap.add_argument("--out", default=None, help="JSON output path")
    args = ap.parse_args(argv)
    res = run(smoke=args.smoke, device=args.device)
    if args.json:
        path = args.out or os.path.normpath(os.path.join(
            RESULTS_DIR, "dag_scale_smoke.json" if args.smoke
            else "dag_scale.json"))
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as fh:
            json.dump(_jsonable(res), fh, indent=1, sort_keys=True)
        print(f"wrote {path}")
    print(json.dumps({k: res[k] for k in (
        "improvement_pct", "realized_improvement_pct",
        "joint_vs_greedy_wallclock_ratio", "family_groups")}))
    if not args.smoke:
        # the gates last, after the JSON is on disk, at full scale only (the
        # smoke scale is solve-starved: its margins mean nothing)
        check_gates(res)
    return res


if __name__ == "__main__":
    main()
