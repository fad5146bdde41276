"""Training CLI (the JAX package's ``launch/train.py``, plus ``--device``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m
    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \
        --tiny --device cpu --steps 50 --batch 8 --seq 128 \
        [--partitioned --pods 2]

The model's weights are drawn from seed 0 on ``--device`` (the card by
default; ``--device cpu`` runs the plain PyTorch path), then ``Trainer``
runs ``--steps`` steps, printing the loss every 10.
``--layers N`` keeps the arch's first N layers at full width (DeepSeek-V2-
Lite's training state does not fit one card at full depth). A
checkpoint in ``--ckpt-dir`` resumes at its step (its weights, moments and
balancer replace the drawn ones). ``--partitioned`` runs the paper's
partitioned step on a one-device mesh with a "pod" axis: every step the
balancer splits the microsteps between ``--pods`` simulated pods and the
pod of this process takes the whole slab, as the JAX package's CLI does on
its one-device mesh. As there, no flag chooses rematerialization: the
arch's config carries it (``remat=True``, ``remat_policy="full"`` by
default), so both trainers recompute each layer unit in the backward.
"""
from __future__ import annotations

import argparse

from ..configs import ARCHS, get_config
from ..device import resolve_device
from ..models import ShardCtx, build_model
from ..train import Trainer, TrainerConfig
from .mesh import make_local_mesh


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", choices=ARCHS, default="smollm-360m")
    ap.add_argument("--tiny", action="store_true", help="reduced config")
    ap.add_argument("--layers", type=int, default=None,
                    help="the arch's first LAYERS layers at full width "
                         "(a depth cut to fit one card)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--partitioned", action="store_true",
                    help="paper-partitioned per-pod microbatching")
    ap.add_argument("--pods", type=int, default=2)
    ap.add_argument("--policy", default="frontier",
                    choices=("frontier", "equal", "inverse_mu"))
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.tiny:
        cfg = cfg.tiny()
    if args.layers is not None:
        cfg = cfg.replace(num_layers=args.layers)
    mesh = ctx = None
    if args.partitioned:
        mesh = make_local_mesh(("pod", "data", "model"))
        ctx = ShardCtx(mesh=mesh, batch_axes=("data",))
    model = build_model(cfg, device=device, seed=0, ctx=ctx, trainable=True)
    tcfg = TrainerConfig(steps=args.steps, batch=args.batch, seq=args.seq,
                         lr=args.lr, ckpt_dir=args.ckpt_dir,
                         partitioned=args.partitioned, num_pods=args.pods,
                         policy=args.policy)
    return Trainer(model, cfg, tcfg, mesh=mesh).run()


if __name__ == "__main__":
    main()
