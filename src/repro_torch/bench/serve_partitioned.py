"""Serving driver on the port: batched requests partitioned across two
replica groups by the paper's frontier (the repository's
``examples/serve_partitioned.py``).

The file-transfer experiment (Figs 5/6) as a serving system: each batch of
``--requests`` 12-token prompts splits between two ``ReplicaGroup``s behind
a ``PartitionedBatcher`` (lam 0.08) on the simulated channels
``Channel(24, 1.6)`` and ``Channel(18, 4.8)`` (seed 11), under the "equal"
and the "frontier" policies; with ``--execute`` both groups run greedy
generation on their shares (the first two frontier batches) with one
``ServeEngine`` over a model of ``smollm-360m``'s ``.tiny()`` config drawn
from seed 0. :func:`run_batcher` takes the config, so the same path serves
the full-width model.

``--engine`` demos the continuous-batching tier instead
(:func:`run_engine_demo`): concurrent workflow instances of two templates
(with SLO deadlines) admitted from a queue, every dirty instance's stages
priced by one stacked call per family a tick, the pipeline saved every
tick and killed and restored from the manifest at mid-trace.

Everything solves and generates on ``device`` (the CUDA kernels by
default, their plain versions with ``--device cpu``) and writes only
under ``RESULTS_DIR`` or the directory it is given.

    PYTHONPATH=src python -m repro_torch.bench.serve_partitioned --device cpu --batches 60 --execute
    PYTHONPATH=src python -m repro_torch.bench.serve_partitioned --device cpu --engine
"""
from __future__ import annotations

import argparse
import os
import shutil
import tempfile
import time
from typing import Optional

import numpy as np
import torch

from ..ckpt.store import restore_pipeline, save_pipeline
from ..configs import get_config
from ..device import resolve_device
from ..models import build_model
from ..serve import PartitionedBatcher, ReplicaGroup, ServeEngine, \
    WorkflowEngine
from ..sim import Channel, ClusterSim
from ..workflow.dag import Stage, StageDAG, linear_edges
from . import common

ARCH = "smollm-360m"
POLICIES = ("equal", "frontier")
EXECUTE_BATCHES = 2     # frontier batches that generate with --execute
BURN_IN = 10            # batches left out of the latency statistics


def engine_templates() -> dict:
    return {
        "etl": StageDAG([
            Stage("extract", mus=[1.0, 1.4, 1.9], sigmas=[0.2, 0.25, 0.35]),
            Stage("load", mus=[1.3, 1.8], sigmas=[0.25, 0.35]),
        ], edges=linear_edges(["extract", "load"])),
        "train": StageDAG([
            Stage("prep", mus=[1.5, 2.0, 2.6], sigmas=[0.3, 0.4, 0.5],
                  family="lognormal"),
            Stage("fit", mus=[2.4, 3.1, 3.9, 4.8],
                  sigmas=[0.5, 0.6, 0.7, 0.9], family="lognormal"),
        ], edges=linear_edges(["prep", "fit"])),
    }


def run_engine_demo(ticks: int = 30, device="cuda",
                    ckpt_dir: Optional[str] = None,
                    kill: bool = True) -> dict:
    """Continuous batching, SLO urgency and kill/restore, end to end: the
    engine's state is saved every tick into ``ckpt_dir`` (a fresh directory
    under ``RESULTS_DIR``, removed afterwards, when none is given) and, with
    ``kill``, dropped and restored from the manifest at tick ``ticks //
    2``. Returns every tick's dict and the telemetry summary."""
    dev = resolve_device(device)
    templates = engine_templates()
    eng = WorkflowEngine(templates, max_live=32, lam_var=0.02, prior_obs=4,
                         device=dev)
    rng = np.random.default_rng(7)
    names = list(templates)
    own = ckpt_dir is None
    if own:
        os.makedirs(common.RESULTS_DIR, exist_ok=True)
        ckpt_dir = tempfile.mkdtemp(prefix="serve_partitioned_ckpt_",
                                    dir=common.RESULTS_DIR)
    outs = []
    try:
        for t in range(ticks):
            arrivals = [(names[int(rng.integers(2))],
                         float(rng.uniform(1.5, 4.0)))
                        for _ in range(int(rng.poisson(4.0)))]
            out = eng.tick(arrivals)
            outs.append(out)
            save_pipeline(ckpt_dir, eng.tick_count, eng)
            if kill and t == ticks // 2:
                # the crash: drop the engine mid-flight, restore the
                # manifest (live instances, queue, heads, sims and all)
                print(f"-- kill/restore at tick {out['tick']} "
                      f"({out['live']} instances in flight) --")
                eng, _, _ = restore_pipeline(ckpt_dir, templates=templates,
                                             device=dev)
            if t % 5 == 0:
                print(f"tick {out['tick']:3d}: live={out['live']} "
                      f"queue={out['queue']} rows={out['rows']} "
                      f"launches={out['launches']}")
    finally:
        if own:
            shutil.rmtree(ckpt_dir, ignore_errors=True)
    s = eng.telemetry.summary()
    c = s["counters"]
    print(f"\nengine summary: {c['retired']} retired / {c['admitted']} "
          f"admitted, {c['slo_misses']} SLO misses")
    print(f"join latency p50 {s['join_latency_s']['p50']:.3f}s "
          f"p99 {s['join_latency_s']['p99']:.3f}s; "
          f"{c['launches']} stacked launches over {c['ticks']} ticks "
          f"(rows/launch p50 {s['rows_per_launch']['p50']:.0f})")
    return {"device": str(dev), "ticks": outs, "summary": s}


def run_batcher(cfg, batches: int = 60, requests: int = 64,
                max_new: int = 8, execute: bool = False,
                family: str = "normal", risk_lam: float = 0.0,
                adaptive_refresh: bool = False, refresh_every: int = 1,
                device="cuda") -> dict:
    """The batcher under both policies on ``device`` with the model of
    ``cfg`` (drawn once from seed 0 and shared by both groups) generating
    on the first EXECUTE_BATCHES frontier batches when ``execute``.
    Returns each policy's join latencies and the generated tokens."""
    dev = resolve_device(device)
    groups = [ReplicaGroup("overlay-path"), ReplicaGroup("direct-path")]
    if execute:
        model = build_model(cfg, device=dev)
        for g in groups:
            g.engine = ServeEngine(model, cfg, device=dev)
    results, generated = {}, []
    tokens, gen_s = 0, 0.0
    for policy in POLICIES:
        sim = ClusterSim([Channel(24.0, 1.6), Channel(18.0, 4.8)], seed=11)
        batcher = PartitionedBatcher(groups, lam=0.08, policy=policy,
                                     sim=sim, family=family,
                                     risk_lam=risk_lam,
                                     adaptive_refresh=adaptive_refresh,
                                     refresh_every=refresh_every, device=dev)
        rng = np.random.default_rng(0)
        lat = []
        for i in range(batches):
            prompts = rng.integers(0, cfg.vocab_size,
                                   (requests, 12)).astype(np.int32)
            run_it = execute and policy == "frontier" and i < EXECUTE_BATCHES
            t0 = time.perf_counter()
            t, counts, resp = batcher.run_batch(prompts, max_new=max_new,
                                                execute=run_it)
            if run_it:
                if dev.type == "cuda":
                    torch.cuda.synchronize()
                gen_s += time.perf_counter() - t0
                tokens += sum(r.size for r in resp if r is not None)
                generated.append({"prompts": prompts, "counts": counts,
                                  "responses": resp})
            lat.append(t)
            if i % 20 == 0:
                tick = batcher.last_tick
                print(f"[{policy}] batch {i:3d}: split={counts.tolist()} "
                      f"join={t:.2f}s family={tick['family']} "
                      f"refresh={tick['effective_refresh']}")
        lat = np.asarray(lat[BURN_IN:])
        results[policy] = lat
        print(f"[{policy}] mean={lat.mean():.3f}s var={lat.var():.4f} "
              f"p99={np.percentile(lat, 99):.3f}s\n")

    imp_mu = 1 - results["frontier"].mean() / results["equal"].mean()
    imp_var = 1 - results["frontier"].var() / results["equal"].var()
    print(f"frontier vs equal: mean latency -{imp_mu:.1%}, variance "
          f"-{imp_var:.1%}")
    if execute:
        print(f"generated {tokens} tokens in {gen_s:.2f} s on {dev.type}")
    return {"device": str(dev), "latencies": results, "imp_mu": imp_mu,
            "imp_var": imp_var, "generated": generated, "tokens": tokens,
            "generate_s": gen_s}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batches", type=int, default=60)
    ap.add_argument("--requests", type=int, default=64)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--execute", action="store_true",
                    help="actually run generation on the tiny model")
    ap.add_argument("--family", default="normal",
                    choices=("normal", "lognormal", "drift", "auto"),
                    help="completion-time family (auto = BIC-select online)")
    ap.add_argument("--risk-lam", type=float, default=0.0,
                    help="estimation-fragility weight in candidate scoring")
    ap.add_argument("--adaptive-refresh", action="store_true",
                    help="sensitivity-sized re-solve cadence")
    ap.add_argument("--refresh-every", type=int, default=1,
                    help="re-solve cadence (cap when adaptive)")
    ap.add_argument("--engine", action="store_true",
                    help="demo the continuous-batching WorkflowEngine "
                         "(admission queue, stacked launches, kill/restore)")
    ap.add_argument("--ticks", type=int, default=30,
                    help="engine mode: trace length")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    args = ap.parse_args(argv)
    if args.engine:
        return run_engine_demo(ticks=args.ticks, device=args.device)
    return run_batcher(get_config(ARCH).tiny(), batches=args.batches,
                       requests=args.requests, max_new=args.max_new,
                       execute=args.execute, family=args.family,
                       risk_lam=args.risk_lam,
                       adaptive_refresh=args.adaptive_refresh,
                       refresh_every=args.refresh_every, device=args.device)


if __name__ == "__main__":
    main()
