"""End to end: train a language model for a few hundred steps with
the paper's uncertainty-aware partitioner scheduling per-pod microbatch
counts (the repository's ``examples/train_partitioned.py``, on the port).

The model is a reduced SmolLM config by default, so a few hundred steps
fit in CPU minutes; ``--full-360m`` trains the real smollm-360m config
(32 layers, d_model 960, bf16) through the same code path, on the card.
Two simulated heterogeneous pods supply the step-time physics; the
gradient math is real (per-pod variable-trip-count accumulation, the
cross-pod sum), the loss goes down, and the scheduler's split converges.
Asserted, as in the example: the mean loss of the last 10 steps is below
that of the first 10. The weights are drawn from seed 0 on ``--device``.

    PYTHONPATH=src python -m repro_torch.bench.train_partitioned --steps 300 \
        --device cpu
    PYTHONPATH=src python -m repro_torch.bench.train_partitioned --full-360m
"""
from __future__ import annotations

import argparse

import numpy as np

from ..configs import get_config
from ..device import resolve_device
from ..launch.mesh import make_local_mesh
from ..models import ShardCtx, build_model
from ..train import Trainer, TrainerConfig

__all__ = ["run", "main"]


def run(*, steps: int = 300, batch: int = 8, seq: int = 64,
        policy: str = "frontier", full_360m: bool = False,
        ckpt_dir=None, device="cuda") -> dict:
    """Train and return ``{"history", "losses", "joins", "k_last",
    "summary"}``; raises if the loss did not fall."""
    dev = resolve_device(device)
    cfg = get_config("smollm-360m")
    if not full_360m:
        cfg = cfg.tiny()
    mesh = make_local_mesh(("pod", "data", "model"))
    model = build_model(cfg, device=dev, seed=0,
                        ctx=ShardCtx(mesh=mesh, batch_axes=("data",)),
                        trainable=True)
    tcfg = TrainerConfig(
        steps=steps, batch=batch, seq=seq, lr=1e-3,
        ckpt_dir=ckpt_dir, ckpt_interval=100, log_every=25,
        partitioned=True, num_pods=2, microbatch=2, max_micro=6,
        policy=policy, sim_mus=(0.9, 1.5), sim_sigmas=(0.05, 0.45))
    _, hist = Trainer(model, cfg, tcfg, mesh=mesh).run()

    losses = [h["loss"] for h in hist]
    joins = np.asarray([h["sim_join_time"] for h in hist
                        if "sim_join_time" in h])
    k_last = hist[-1].get("k_pods")
    burn = joins[20:] if len(joins) > 20 else joins
    summary = {"policy": policy, "first10": float(np.mean(losses[:10])),
               "last10": float(np.mean(losses[-10:])),
               "join_mean": float(burn.mean()), "join_var": float(burn.var()),
               "join_p99": float(np.percentile(burn, 99)),
               "k_last": k_last}
    print("\n=== summary ===")
    print(f"policy={policy}")
    print(f"loss: first10={summary['first10']:.3f}  "
          f"last10={summary['last10']:.3f}")
    print(f"simulated join time: mean={summary['join_mean']:.3f}s  "
          f"var={summary['join_var']:.4f}  p99={summary['join_p99']:.3f}s")
    print(f"final per-pod microbatch split: {k_last}")
    assert summary["last10"] < summary["first10"], "loss must decrease"
    return {"history": hist, "losses": losses, "joins": joins,
            "k_last": k_last, "summary": summary}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--policy", default="frontier",
                    choices=("frontier", "equal", "inverse_mu"))
    ap.add_argument("--full-360m", action="store_true")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    args = ap.parse_args(argv)
    return run(steps=args.steps, batch=args.batch, seq=args.seq,
               policy=args.policy, full_360m=args.full_360m,
               ckpt_dir=args.ckpt_dir, device=args.device)


if __name__ == "__main__":
    main()
