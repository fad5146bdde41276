"""Serving CLI: paper-partitioned request batching across replica groups.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-8b --execute
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-2.7b --execute

Two replica groups ("fast", "slow") share one model whose weights are drawn
from seed 0 on ``--device`` (the card by default); a
:class:`PartitionedBatcher` splits each batch of ``--requests`` 16-token
prompts between them on the simulated channels ``Channel(20, 2)`` and
``Channel(14, 5)``, and with ``--execute`` each group runs greedy
generation on its share. Any dense attention or Mamba2 arch serves
(``models/transformer.py``). ``--tiny`` serves the arch's reduced config;
``--tiny --device cpu`` runs it on the plain path without a card.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..configs import ARCHS, get_config
from ..device import resolve_device
from ..models import build_model
from ..serve import PartitionedBatcher, ReplicaGroup, ServeEngine
from ..sim.cluster import Channel, ClusterSim


def main(argv=None) -> None:
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
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = get_config(args.arch)
    if args.tiny:
        cfg = cfg.tiny()
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
