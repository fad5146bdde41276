"""The serving path end to end on the port: the continuous-batching
:class:`~repro_torch.serve.WorkflowEngine` under a bursty request trace.

The experiment of the repository's ``benchmarks/serve_trace.py``, whole:
Poisson arrivals over three workflow templates in three completion-time
families (a normal ETL chain, a lognormal training diamond, a drifting
media pipeline); the arrival rate switches between a calm regime (24 a
tick) and a burst (96 a tick) on a seeded two-state Markov chain, and each
switch moves every template's congestion factor (1.6 while bursting). A
stage-addressed churn schedule throttles, fails and recovers channels
mid-trace. 120 ticks, up to 320 live instances, 400 requests queued before
the first tick, T = 128 quadrature points; half the requests carry an SLO
deadline.

``batched_vs_looped_ratio``: at 3 sampled ticks the engine's own row set
(``engine.last_rows``) is solved twice, the engine's way (one stacked call
per family group) and as the per-instance loop it replaced (one call per
live workflow), each warmed before it is timed. ``--smoke`` runs 24 ticks
with 48 live and a quarter of the traffic.

    PYTHONPATH=src python -m repro_torch.bench.serve_trace --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.bench.serve_trace --json   # the card

``--json`` writes ``experiments/torch/serve_trace.json`` (``_smoke`` for
the smoke run), never a repository-root ``BENCH_*.json``.

A traced run (``REPRO_TRACE=1``, or ``obs.set_enabled(True)`` in-process)
adds the trace section: the run's records, validated, are written to
``experiments/torch/TRACE_serve_trace[_smoke].jsonl`` and
``.perfetto.json``, and ``overhead_pct`` compares the engine's own stacked
solve of the last tick's rows traced against untraced (the median of
paired rounds); the JAX package bounds it below 5%.
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from ..core.distributions import Drift
from ..device import resolve_device
from ..obs import trace as obs
from ..serve.engine import WorkflowEngine, launch_group
from ..workflow import Stage, StageDAG, linear_edges
from ..workflow.solve import stack_rows
from .common import RESULTS_DIR, timeit

TICKS = 120
SMOKE_TICKS = 24
MAX_LIVE = 320          # live-set capacity (full scale: >= 256 held live)
SMOKE_MAX_LIVE = 48
PREFILL = 400           # requests queued before tick 1 fills the live set
SMOKE_PREFILL = 64
LAM_CALM = 24.0         # mean arrivals a tick, calm regime
LAM_BURST = 96.0        # mean arrivals a tick, burst regime
P_ENTER_BURST = 0.05    # per-tick calm -> burst probability
P_EXIT_BURST = 0.15     # per-tick burst -> calm probability
BURST_LOAD = 1.6        # fleet-wide congestion factor while bursting
RATIO_SAMPLES = 3       # ticks whose row set is re-timed batched vs looped
OVERHEAD_ROUNDS = 15    # traced/untraced timing rounds of overhead_pct
NUM_T = 128


def templates() -> dict:
    """Three workflow shapes across three completion-time families."""
    etl = StageDAG([
        Stage("extract", mus=[1.0, 1.3, 1.7, 2.2, 2.6, 3.0],
              sigmas=[0.20, 0.25, 0.30, 0.40, 0.45, 0.50]),
        Stage("transform", mus=[2.0, 2.4, 3.0, 3.5],
              sigmas=[0.30, 0.35, 0.50, 0.55]),
        Stage("load", mus=[1.1, 1.6, 2.1], sigmas=[0.20, 0.30, 0.35]),
    ], edges=linear_edges(["extract", "transform", "load"]))
    train = StageDAG([
        Stage("prep", mus=[1.5, 1.9, 2.3, 2.8],
              sigmas=[0.30, 0.35, 0.40, 0.50], family="lognormal"),
        Stage("fit_a", mus=[2.5, 3.0, 3.6, 4.2, 4.9],
              sigmas=[0.50, 0.60, 0.70, 0.80, 0.90], family="lognormal"),
        Stage("fit_b", mus=[2.2, 2.8, 3.3, 3.9, 4.5],
              sigmas=[0.45, 0.55, 0.65, 0.75, 0.85], family="lognormal"),
        Stage("merge", mus=[1.2, 1.7, 2.2], sigmas=[0.25, 0.30, 0.40],
              family="lognormal"),
    ], edges=[("prep", "fit_a"), ("prep", "fit_b"),
              ("fit_a", "merge"), ("fit_b", "merge")])
    media = StageDAG([
        Stage("render", mus=[1.8, 2.2, 2.7, 3.2, 3.8, 4.4],
              sigmas=[0.35, 0.40, 0.50, 0.60, 0.70, 0.80],
              family=Drift(0.35)),
        Stage("encode", mus=[1.4, 1.8, 2.3, 2.9],
              sigmas=[0.25, 0.30, 0.40, 0.50], family=Drift(0.20)),
    ], edges=linear_edges(["render", "encode"]))
    return {"etl": etl, "train": train, "media": media}


def _naive_makespan(dag) -> float:
    """Longest path of equal-split stage means: the deadline yardstick."""
    lp = {}
    for name in dag.topo_order:
        s = dag.stages[dag.names.index(name)]
        rel = max((lp[u] for u in dag.predecessors(name)), default=0.0)
        lp[name] = rel + float(np.mean(s.mus)) / s.k
    return max(lp.values())


def _launch_rows(rows, kmax: int, num_t: int, device) -> int:
    """Solve one row set the engine's way: stack, pad to the row bucket,
    one call per family group (``WorkflowEngine._solve_tick``'s work)."""
    groups, mask, km = stack_rows(
        [(r.mus, r.sigmas, r.family) for r in rows], kmax=kmax)
    for g in groups:
        launch_group(rows, g, mask, km, num_t=num_t, device=device)
    return len(groups)


def _solve_looped(rows, kmax: int, num_t: int, device) -> None:
    """The pre-engine baseline: one call per live workflow instance (the
    per-instance loop RPA080 bans under serve/, legal here as the
    documented baseline, outside the serving path)."""
    by_iid = {}
    for r in rows:
        by_iid.setdefault(r.iid, []).append(r)
    for inst_rows in by_iid.values():
        _launch_rows(inst_rows, kmax, num_t, device)


def _measure_ratio(rows, kmax: int, num_t: int, device):
    """(batched_us, looped_us) on one captured row set, each path warmed
    first."""
    return (timeit(_launch_rows, rows, kmax, num_t, device, repeats=3,
                   warmup=1),
            timeit(_solve_looped, rows, kmax, num_t, device, repeats=3,
                   warmup=1))


def _trace_overhead_pct(rows, kmax: int, num_t: int, device):
    """``(overhead_pct, untraced_us, traced_us)`` of the engine's stacked
    solve of ``rows`` (the work every tick pays). Each round times both
    sides back to back, in alternating order, each the median of three
    calls; the overhead is the median of the rounds' traced/untraced
    ratios, so neither host noise nor a drift of the host's speed passes
    for tracing cost. The two times are the medians of each side."""
    was = obs.enabled()
    times = {False: [], True: []}
    try:
        for r in range(OVERHEAD_ROUNDS):
            for flag in ((False, True) if r % 2 == 0 else (True, False)):
                obs.set_enabled(flag)
                times[flag].append(timeit(_launch_rows, rows, kmax, num_t,
                                          device, repeats=3, warmup=1))
    finally:
        obs.set_enabled(was)
    ratio = float(np.median(np.asarray(times[True])
                            / np.asarray(times[False])))
    return (100.0 * (ratio - 1.0), float(np.median(times[False])),
            float(np.median(times[True])))


def _trace_section(eng, since: int, smoke: bool, out_dir: str,
                   device) -> dict:
    """The run's records (after ``since``) validated and written as JSONL
    and Perfetto under ``out_dir``, with the overhead of tracing."""
    from ..obs import export as obs_export
    recs = obs.records(since)
    obs_export.validate_records(recs)
    suffix = "_smoke" if smoke else ""
    os.makedirs(out_dir, exist_ok=True)
    jsonl = os.path.join(out_dir, f"TRACE_serve_trace{suffix}.jsonl")
    perfetto = os.path.join(out_dir,
                            f"TRACE_serve_trace{suffix}.perfetto.json")
    obs_export.write_jsonl(recs, jsonl)
    obs_export.write_perfetto(recs, perfetto)
    pct, off_us, on_us = _trace_overhead_pct(eng.last_rows, eng.kmax,
                                             NUM_T, device)
    return {"records": len(recs), "dropped": obs.dropped(),
            "span_kinds": sorted(obs_export.span_kinds(recs)),
            "event_types": sorted(obs_export.event_types(recs)),
            "overhead_pct": float(round(pct, 3)), "solve_us": off_us,
            "solve_us_traced": on_us, "rows": len(eng.last_rows),
            "jsonl": jsonl, "perfetto": perfetto}


def run(ticks: int = TICKS, seed: int = 0, smoke: bool = False,
        device="cuda", on_tick=None, out_dir: str = RESULTS_DIR) -> dict:
    """The trace; ``on_tick(engine, t, out)``, when given, is called after
    every tick (before any ratio sample is timed). A traced run writes its
    trace files under ``out_dir``."""
    dev = resolve_device(device)
    since = obs.mark()
    tpls = templates()
    max_live = SMOKE_MAX_LIVE if smoke else MAX_LIVE
    prefill = SMOKE_PREFILL if smoke else PREFILL
    lam_calm = LAM_CALM / 4 if smoke else LAM_CALM
    lam_burst = LAM_BURST / 4 if smoke else LAM_BURST
    eng = WorkflowEngine(tpls, max_live=max_live, lam_var=0.02,
                         slo_gain=0.5, settle_steps=4, dirty_tol=0.08,
                         num_t=NUM_T, seed=seed, prior_obs=4, device=dev)

    # stage-addressed churn mid-trace: a throttled channel, a failure with
    # recovery, and a template-local load regime
    t1, t2, t3 = max(2, ticks // 4), max(3, ticks // 2), max(4, 3 * ticks // 4)
    eng.sims["etl"].schedule_churn(t1, "throttle", stage="extract", idx=1,
                                   value=2.0)
    eng.sims["etl"].schedule_churn(t3, "recover", stage="extract", idx=1)
    eng.sims["train"].schedule_churn(t2, "fail", stage="fit_a", idx=0)
    eng.sims["train"].schedule_churn(t3, "recover", stage="fit_a", idx=0)
    eng.sims["media"].schedule_churn(t2, "set_load", value=1.3)
    eng.sims["media"].schedule_churn(t3, "set_load", value=1.0)

    rng = np.random.default_rng(seed)
    names = list(tpls)
    est = {n: _naive_makespan(d) for n, d in tpls.items()}

    def _request():
        tpl = names[int(rng.integers(len(names)))]
        # half the traffic carries an SLO deadline scaled off the naive
        # makespan: tight ones miss under burst load, loose ones never do
        if rng.random() < 0.5:
            return (tpl, est[tpl] * float(rng.uniform(0.8, 2.5)))
        return tpl

    for _ in range(prefill):
        req = _request()
        if isinstance(req, tuple):
            eng.submit(req[0], req[1])
        else:
            eng.submit(req)

    burst = False
    reg_joins = {"calm": [], "burst": []}
    tpl_joins = {n: [] for n in names}
    trace_rows = []
    batched_us = looped_us = 0.0
    samples = 0
    sample_every = max(3, ticks // (RATIO_SAMPLES + 1))
    for t in range(ticks):
        if burst and rng.random() < P_EXIT_BURST:
            burst = False
            eng.set_load(1.0)
        elif not burst and rng.random() < P_ENTER_BURST:
            burst = True
            eng.set_load(BURST_LOAD)
        lam = lam_burst if burst else lam_calm
        arrivals = [_request() for _ in range(int(rng.poisson(lam)))]
        out = eng.tick(arrivals)
        if on_tick is not None:
            on_tick(eng, t, out)
        regime = "burst" if burst else "calm"
        for r in out["retired"]:
            reg_joins[regime].append(r["join_latency_s"])
            tpl_joins[r["template"]].append(r["join_latency_s"])
        trace_rows.append((t, regime, len(arrivals), out["admitted"],
                           out["live"], out["queue"], out["rows"],
                           out["launches"]))
        # re-time this tick's own row set, batched against looped
        if (samples < RATIO_SAMPLES and t >= 2 and eng.last_rows
                and (t + 1) % sample_every == 0
                and len({r.iid for r in eng.last_rows}) >= 4):
            b_us, l_us = _measure_ratio(eng.last_rows, eng.kmax, NUM_T, dev)
            batched_us += b_us
            looped_us += l_us
            samples += 1

    if samples == 0:
        raise RuntimeError("the trace never yielded a sampleable row set")
    ratio = looped_us / max(batched_us, 1e-9)
    tel = eng.telemetry.summary()
    counters = tel.pop("counters")
    reg = {name: {"ticks": int(sum(1 for r in trace_rows if r[1] == name)),
                  "latency_mean": (float(np.mean(js)) if js else None)}
           for name, js in reg_joins.items()}
    out = {
        "bench": "serve_trace",
        "smoke": smoke,
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
        "ticks": ticks,
        "templates": {n: {"stages": len(d.stages),
                          "family": d.stages[0].dist_id,
                          "retired": len(tpl_joins[n])}
                      for n, d in tpls.items()},
        "max_live": max_live,
        "latency": tel["join_latency_s"],
        "solver_tick_us": tel["solver_tick_us"],
        "rows_per_launch": tel["rows_per_launch"],
        "row_occupancy": tel["row_occupancy"],
        "live_instances": tel["live_instances"],
        "queue_wait_ticks": tel["queue_wait_ticks"],
        "batched_vs_looped_ratio": float(round(ratio, 3)),
        "slo": {
            "misses": counters["slo_misses"],
            "retired": counters["retired"],
            "miss_rate": (counters["slo_misses"] / counters["retired"]
                          if counters["retired"] else 0.0),
        },
        "regimes": reg,
        "counters": counters,
        "entries": [
            {"name": f"serve_join_{n}", "family": d.stages[0].dist_id,
             "ticks": ticks,
             "mean_s": (float(np.mean(tpl_joins[n]))
                        if tpl_joins[n] else 0.0),
             "var_s2": (float(np.var(tpl_joins[n]))
                        if tpl_joins[n] else 0.0),
             "p50_s": (float(np.percentile(tpl_joins[n], 50))
                       if tpl_joins[n] else 0.0),
             "p99_s": (float(np.percentile(tpl_joins[n], 99))
                       if tpl_joins[n] else 0.0)}
            for n, d in tpls.items()
        ],
    }
    if obs.enabled():
        out["trace"] = _trace_section(eng, since, smoke, out_dir, dev)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true",
                    help="reduced scale (24 ticks, 48 live)")
    ap.add_argument("--ticks", type=int, default=None)
    ap.add_argument("--json", action="store_true",
                    help="write experiments/torch/serve_trace[_smoke].json")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    ap.add_argument("--out", default=None, help="JSON output path")
    args = ap.parse_args(argv)
    ticks = args.ticks or (SMOKE_TICKS if args.smoke else TICKS)
    res = run(ticks=ticks, smoke=args.smoke, device=args.device)
    if args.json:
        path = args.out or os.path.normpath(os.path.join(
            RESULTS_DIR, "serve_trace_smoke.json" if args.smoke
            else "serve_trace.json"))
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as fh:
            json.dump(res, fh, indent=1, sort_keys=True)
        print(f"wrote {path}")
    print(json.dumps({k: res[k] for k in ("latency", "batched_vs_looped_ratio",
                                          "live_instances", "slo")}))
    return res


if __name__ == "__main__":
    main()
