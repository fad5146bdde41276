"""Serving CLI: paper-partitioned request batching across replica groups.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-8b --execute
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-2.7b --execute
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch deepseek-v2-lite-16b --execute

Two replica groups ("fast", "slow") share one model whose weights are drawn
from seed 0 on ``--device`` (the card by default); a
:class:`PartitionedBatcher` splits each batch of ``--requests`` 16-token
prompts between them on the simulated channels ``Channel(20, 2)`` and
``Channel(14, 5)``, and with ``--execute`` each group runs greedy
generation on its share. Every decoder-only arch serves: dense
attention, MLA, MoE, Mamba2 and the hybrid (``models/transformer.py``).
Whisper and InternVL2 take frames or patches that a batch of token prompts
does not carry: with ``--execute`` they raise, as the JAX package's
``ServeEngine`` cannot serve them either. ``--tiny`` serves the arch's
reduced config; ``--tiny --device cpu`` runs it on the plain path without
a card.

``--engine`` serves workflow instances through the continuous-batching
:class:`WorkflowEngine` instead: every tick admits queued instances of two
templates (a normal prefill/decode chain and a lognormal diamond), prices
all their stage splits through one stacked call per family group on
``--device``, and runs them on the simulated fleets:

    PYTHONPATH=src python -m repro_torch.launch.serve --engine --batches 40 \
        --arrival-rate 8 --deadline 4.0

``--trace PREFIX`` records the run's trace (``obs``, as ``REPRO_TRACE=1``
does) and writes ``PREFIX.jsonl`` and ``PREFIX.perfetto.json`` (load the
latter in ui.perfetto.dev) after it, validated first.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..configs import ARCHS, get_config
from ..device import resolve_device
from ..models import build_model
from ..obs import trace as obs
from ..serve import (PartitionedBatcher, ReplicaGroup, ServeEngine,
                     WorkflowEngine)
from ..sim.cluster import Channel, ClusterSim
from ..workflow import Stage, StageDAG, linear_edges


def _engine_templates() -> dict:
    pipeline = StageDAG([
        Stage("prefill", mus=[1.0, 1.4, 1.9], sigmas=[0.2, 0.25, 0.35]),
        Stage("decode", mus=[2.0, 2.6, 3.3, 4.0],
              sigmas=[0.3, 0.4, 0.5, 0.6]),
    ], edges=linear_edges(["prefill", "decode"]))
    diamond = StageDAG([
        Stage("shard", mus=[1.2, 1.6, 2.1], sigmas=[0.25, 0.3, 0.4],
              family="lognormal"),
        Stage("rank_a", mus=[2.4, 3.0, 3.7], sigmas=[0.5, 0.6, 0.7],
              family="lognormal"),
        Stage("rank_b", mus=[2.1, 2.7, 3.4], sigmas=[0.45, 0.55, 0.65],
              family="lognormal"),
        Stage("blend", mus=[1.1, 1.5], sigmas=[0.2, 0.3],
              family="lognormal"),
    ], edges=[("shard", "rank_a"), ("shard", "rank_b"),
              ("rank_a", "blend"), ("rank_b", "blend")])
    return {"pipeline": pipeline, "diamond": diamond}


def _run_engine(args, dev) -> WorkflowEngine:
    templates = _engine_templates()
    eng = WorkflowEngine(templates, max_live=args.max_live, lam_var=0.02,
                         num_t=256, prior_obs=4, device=dev)
    rng = np.random.default_rng(0)
    names = list(templates)
    for t in range(args.batches):
        arrivals = []
        for _ in range(int(rng.poisson(args.arrival_rate))):
            tpl = names[int(rng.integers(len(names)))]
            arrivals.append((tpl, args.deadline) if args.deadline else tpl)
        out = eng.tick(arrivals)
        if t % 10 == 0:
            print(f"tick {t:3d} live={out['live']} queue={out['queue']} "
                  f"rows={out['rows']} launches={out['launches']} "
                  f"retired={len(out['retired'])}")
    s = eng.telemetry.summary()
    c = s["counters"]
    print(f"engine: {c['ticks']} ticks, {c['retired']}/{c['admitted']} "
          f"retired, {c['slo_misses']} SLO misses, "
          f"{c['launches']} launches "
          f"(rows/launch p50 {s['rows_per_launch']['p50']:.0f})")
    print(f"join latency p50 {s['join_latency_s']['p50']:.3f}s "
          f"p99 {s['join_latency_s']['p99']:.3f}s; "
          f"solver tick p50 {s['solver_tick_us']['p50']:.0f}us on "
          f"{dev.type}")
    return eng


def _export_trace(prefix: str) -> None:
    """Write the tracer's records as ``<prefix>.jsonl`` and
    ``<prefix>.perfetto.json`` (a message instead when there are none)."""
    from ..obs import export as obs_export
    recs = obs.records()
    if not recs:
        print("trace: no records captured — run with REPRO_TRACE=1")
        return
    jsonl = f"{prefix}.jsonl"
    perfetto = f"{prefix}.perfetto.json"
    obs_export.validate_records(recs)
    obs_export.write_jsonl(recs, jsonl)
    obs_export.write_perfetto(recs, perfetto)
    print(f"trace: {len(recs)} records "
          f"({len(obs_export.span_kinds(recs))} span kinds, "
          f"{len(obs_export.event_types(recs))} event types, "
          f"{obs.dropped()} dropped) -> {jsonl}, {perfetto}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", choices=ARCHS, default="smollm-360m")
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--batches", type=int, default=50)
    ap.add_argument("--requests", type=int, default=64)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--policy", default="frontier",
                    choices=("frontier", "equal", "inverse_mu"))
    ap.add_argument("--execute", action="store_true",
                    help="run real generation per group")
    ap.add_argument("--family", default="normal",
                    choices=("normal", "lognormal", "drift", "auto"),
                    help="completion-time family for the frontier solve "
                         "(auto = online BIC selection with hysteresis)")
    ap.add_argument("--risk-lam", type=float, default=0.0,
                    help="fragility weight: candidates scored mu + lam var "
                         "+ risk_lam * estimation-fragility")
    ap.add_argument("--adaptive-refresh", action="store_true",
                    help="size the re-solve cadence by posterior "
                         "sensitivity instead of a fixed refresh_every")
    ap.add_argument("--refresh-every", type=int, default=1,
                    help="re-solve cadence cap")
    ap.add_argument("--device", default="cuda",
                    help="where the models run and the balancer solves "
                         "(cuda, or cpu for the plain path)")
    ap.add_argument("--engine", action="store_true",
                    help="serve workflow instances through the "
                         "continuous-batching WorkflowEngine instead of "
                         "the per-batch PartitionedBatcher")
    ap.add_argument("--max-live", type=int, default=64,
                    help="engine mode: live-instance capacity")
    ap.add_argument("--arrival-rate", type=float, default=6.0,
                    help="engine mode: mean Poisson arrivals per tick")
    ap.add_argument("--deadline", type=float, default=None,
                    help="engine mode: SLO deadline (sim seconds) attached "
                         "to every request")
    ap.add_argument("--trace", default=None, metavar="PREFIX",
                    help="record the run's trace and write it to "
                         "PREFIX.jsonl and PREFIX.perfetto.json")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    was = obs.enabled()
    if args.trace:
        obs.set_enabled(True)
    try:
        out = _run(args, dev)
    finally:
        obs.set_enabled(was)
    if args.trace:
        _export_trace(args.trace)
    return out


def _run(args, dev):
    """The run main() asked for: the engine, or the batcher."""
    if args.engine:
        return _run_engine(args, dev)

    cfg = get_config(args.arch)
    if args.tiny:
        cfg = cfg.tiny()
    if args.execute and (cfg.is_encoder_decoder or cfg.num_patches):
        raise ValueError(f"{cfg.name} takes precomputed "
                         f"{'frames' if cfg.is_encoder_decoder else 'patches'}"
                         f" beside its tokens; the batcher serves token "
                         f"prompts to decoder-only archs")
    groups = [ReplicaGroup("fast"), ReplicaGroup("slow")]
    if args.execute:
        model = build_model(cfg, device=dev)
        for g in groups:
            g.engine = ServeEngine(model, cfg, device=dev)
    sim = ClusterSim([Channel(mu=20.0, sigma=2.0), Channel(mu=14.0, sigma=5.0)])
    b = PartitionedBatcher(groups, policy=args.policy, sim=sim, device=dev,
                           family=args.family, risk_lam=args.risk_lam,
                           adaptive_refresh=args.adaptive_refresh,
                           refresh_every=args.refresh_every)
    lat, tokens, wall = [], 0, 0.0
    rng = np.random.default_rng(0)
    for i in range(args.batches):
        prompts = rng.integers(0, cfg.vocab_size,
                               (args.requests, 16)).astype(np.int32)
        t0 = time.perf_counter()
        t, counts, resp = b.run_batch(prompts, max_new=args.max_new,
                                      execute=args.execute)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        wall += time.perf_counter() - t0
        tokens += sum(r.size for r in resp if r is not None)
        lat.append(t)
        if i % 10 == 0:
            tick = b.last_tick
            print(f"batch {i:3d} split={counts.tolist()} join={t:.2f}s "
                  f"family={tick['family']} "
                  f"refresh={tick['effective_refresh']}")
    lat = np.asarray(lat)
    print(f"policy={args.policy} family={args.family} "
          f"risk_lam={args.risk_lam}: mean join {lat.mean():.3f}s  "
          f"var {lat.var():.4f}  p99 {np.percentile(lat, 99):.3f}s")
    if args.execute:
        print(f"generated {tokens} tokens in {wall:.2f} s on {dev.type}: "
              f"{tokens / wall:.1f} tokens/s")


if __name__ == "__main__":
    main()
