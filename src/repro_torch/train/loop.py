"""Training loop: checkpoint and resume, the partitioner's feedback (the JAX
package's ``train/loop.py``).

On real pods the per-pod step durations come from the runtime; here they
come from ``sim.ClusterSim``, so the whole control loop (observe ->
re-partition -> assign) runs end to end. The loop stays simple on the
host: every device operation is inside the step. The trainer starts from
the weights its model holds (``build_model(..., trainable=True)`` or a
model converted from the reference's), where the reference draws them from
a JAX key; a checkpoint in ``ckpt_dir`` resumes at its step, the balancer's
state riding in its manifest. Both the standard and the partitioned step
train under the config's ``remat`` and ``remat_policy`` (each layer unit
recomputed in the backward by default, as in the reference).

A model placed on a ``DeviceMesh`` (``build_model(..., ctx=ShardCtx(mesh=
...), trainable=True)``) trains as it lies: its state is at the specs'
placements, each rank feeds the step the same global batch, and each rank
checkpoints its own shards in ``ckpt_dir/rank<global rank>`` (one
directory a rank where the world has more than one), so a restore is
bitwise (``docs/INVARIANTS.md``).
"""
from __future__ import annotations

import os
import time
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from ..ckpt.store import CheckpointManager, latest_step, restore
from ..configs.base import ModelConfig
from ..data.pipeline import SyntheticStream
from ..optim.adamw import cosine_schedule
from ..sched.balancer import UncertaintyAwareBalancer
from ..sim.cluster import Channel, ClusterSim
from .step import (TrainState, init_state, make_partitioned_train_step,
                   make_train_step, trainable)

__all__ = ["TrainerConfig", "Trainer"]


@dataclass
class TrainerConfig:
    steps: int = 100
    batch: int = 8
    seq: int = 128
    lr: float = 3e-4
    warmup: int = 20
    accum: int = 1
    ckpt_dir: Optional[str] = None
    ckpt_interval: int = 50
    seed: int = 0
    log_every: int = 10
    # partitioned mode (the paper feature)
    partitioned: bool = False
    num_pods: int = 2
    microbatch: int = 2
    max_micro: int = 8
    lam: float = 0.05
    policy: str = "frontier"
    sim_mus: tuple = (1.0, 1.6)     # simulated per-pod sec/microbatch means
    sim_sigmas: tuple = (0.05, 0.4)


def _rank_dir(ckpt_dir: str) -> str:
    """This rank's checkpoint directory: ``ckpt_dir`` itself in a world of
    one, else its ``rank<global rank>`` subdirectory."""
    import torch.distributed as dist
    if dist.is_initialized() and dist.get_world_size() > 1:
        return os.path.join(ckpt_dir, f"rank{dist.get_rank():05d}")
    return ckpt_dir


class Trainer:
    """Trains ``model`` (on its device) for ``tcfg.steps`` steps.

    ``run`` returns ``(state, history)``: the final :class:`TrainState`
    and one dict of float metrics per step (``loss``, ``wall_s``, ``step``
    and, partitioned, ``sim_join_time`` and ``k_pods``). The balancer
    solves on the model's device."""

    def __init__(self, model, cfg: ModelConfig, tcfg: TrainerConfig,
                 mesh=None):
        self.model, self.cfg, self.tcfg, self.mesh = model, cfg, tcfg, mesh
        self.device = model.device
        self.lr = cosine_schedule(tcfg.lr, tcfg.warmup, tcfg.steps)
        self.stream = SyntheticStream(cfg, tcfg.seq, tcfg.batch,
                                      seed=tcfg.seed)
        self.ckpt = (CheckpointManager(_rank_dir(tcfg.ckpt_dir),
                                       tcfg.ckpt_interval)
                     if tcfg.ckpt_dir else None)
        self.balancer = None
        self.sim = None
        if tcfg.partitioned:
            if mesh is None or "pod" not in mesh.mesh_dim_names:
                raise ValueError("the partitioned trainer needs a mesh with "
                                 "a 'pod' axis (launch.mesh)")
            self.balancer = UncertaintyAwareBalancer(
                tcfg.num_pods, lam=tcfg.lam, policy=tcfg.policy,
                device=self.device)
            self.sim = ClusterSim(
                channels=[Channel(mu=m, sigma=s)
                          for m, s in zip(tcfg.sim_mus, tcfg.sim_sigmas)],
                seed=tcfg.seed)
            self._step_fn = make_partitioned_train_step(
                model, cfg, mesh, self.lr, max_micro=tcfg.max_micro)
        else:
            self._step_fn = make_train_step(model, cfg, self.lr,
                                            accum=tcfg.accum)

    # ------------------------------------------------------------------
    def init_or_restore(self) -> tuple:
        state = init_state(self.model)
        start = 0
        if self.ckpt and latest_step(self.ckpt.dir) is not None:
            state, meta = restore(self.ckpt.dir, state)
            state = trainable(state)
            start = meta["step"]
            if self.balancer is not None and "balancer" in meta:
                self.balancer = UncertaintyAwareBalancer.from_state_dict(
                    meta["balancer"], device=self.device)
        return state, start

    def _tensor(self, x):
        return None if x is None else torch.as_tensor(x, device=self.device)

    def run(self, on_metrics: Optional[Callable] = None):
        state, start = self.init_or_restore()
        history = []
        for step in range(start, self.tcfg.steps):
            batch = self.stream.batch_at(step)
            t0 = time.perf_counter()
            if self.tcfg.partitioned:
                state, metrics = self._partitioned_step(state, step, batch)
            else:
                state, metrics = self._step_fn(
                    state, self._tensor(batch.tokens),
                    self._tensor(batch.labels),
                    self._tensor(batch.extra_embeds))
            # float() reads each metric back: the step has ended on the card
            metrics = {k: (float(v) if not isinstance(v, str) else v)
                       for k, v in metrics.items()}
            metrics["wall_s"] = time.perf_counter() - t0
            metrics["step"] = step
            history.append(metrics)
            if on_metrics:
                on_metrics(metrics)
            if self.ckpt:
                meta = ({"balancer": self.balancer.state_dict()}
                        if self.balancer else {})
                self.ckpt.maybe_save(step + 1, state, meta)
            if step % self.tcfg.log_every == 0:
                print(f"step {step:5d} loss "
                      f"{metrics.get('loss', float('nan')):.4f} "
                      f"wall {metrics['wall_s'] * 1e3:.0f}ms")
        if self.ckpt:
            self.ckpt.wait()
        return state, history

    # ------------------------------------------------------------------
    def _partitioned_step(self, state: TrainState, step: int, batch):
        t = self.tcfg
        k_pods = self.balancer.assign(t.max_micro * t.num_pods // 2)
        k_pods = np.clip(k_pods, 0, t.max_micro)
        tokens = np.asarray(batch.tokens)
        labels = np.asarray(batch.labels)
        # the host batch as (max_micro, num_pods * mb, S)
        need = t.max_micro * t.num_pods * t.microbatch
        reps = int(np.ceil(need / tokens.shape[0]))
        tokens = np.tile(tokens, (reps, 1))[:need]
        labels = np.tile(labels, (reps, 1))[:need]
        S = tokens.shape[1]
        tokens = tokens.reshape(t.max_micro, t.num_pods * t.microbatch, S)
        labels = labels.reshape(t.max_micro, t.num_pods * t.microbatch, S)
        state, metrics = self._step_fn(state, self._tensor(tokens),
                                       self._tensor(labels), k_pods)
        # simulated per-pod durations feed the posterior (real pods: the
        # runtime). run_step normalizes the counts to work fractions; pod
        # rates are sec per *microbatch*, so the realized times are scaled
        # back to seconds
        join_t, durs = self.sim.run_step(k_pods.astype(np.float64))
        total_work = float(k_pods.sum())
        join_t, durs = join_t * total_work, durs * total_work
        self.balancer.observe(durs, k_pods.astype(np.float64))
        metrics = dict(metrics)
        metrics["sim_join_time"] = join_t
        metrics["k_pods"] = str(k_pods.tolist())
        return state, metrics
