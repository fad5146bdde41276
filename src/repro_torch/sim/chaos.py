"""Chaos harness: drive a partitioning loop through churn and crash cycles.

The JAX package's ``sim/chaos.py`` on the port. Two fault axes, composable
in one trace:

* **Channel churn**: the simulator's churn schedule (fail, throttle,
  recover, load regimes) hits the fleet mid-trace; the balancer re-solves
  over the survivors (``resolve_inflight``), so dead channels get exactly
  zero share while their posteriors survive for re-admission.
* **Process crashes**: every ``kill_every`` ticks the live balancer and
  the simulated world are thrown away and rebuilt from the last
  ``ckpt.store.save_pipeline`` manifest, as a failover replica would. With
  ``verify_parity=True`` the harness computes the would-be survivor's next
  decision before the kill and asserts that the restored replica's is
  bitwise identical: the kill/restore tick-parity contract of
  ``ckpt/store.py``, held on every kill. The deciders solve on ``device``
  (the card by default), so on the card the contract covers the kernels'
  launches too.

Each kill and restore is one ``chaos.cycle`` span (``obs``), and the
restore's ``audit.ckpt_restore`` event lands inside it.
"""
from __future__ import annotations

import tempfile
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np

from ..ckpt.store import restore_pipeline, save_pipeline
from ..obs import names as obs_names
from ..obs import trace as obs
from ..sched.balancer import UncertaintyAwareBalancer, WorkflowBalancer
from .cluster import ClusterSim, WorkflowSim

__all__ = ["ChaosResult", "run_chaos_trace", "run_workflow_chaos_trace"]


@dataclass
class ChaosResult:
    """Outcome of one chaos trace (all fields JSON-serializable)."""

    ticks: int
    kills: int
    parity_checks: int          # kill/restore decisions compared bitwise
    joins: List[float]          # per-tick join latencies
    events: List[Tuple[int, str, str]]  # (tick, kind, detail)
    final_failed: List[int] = field(default_factory=list)

    def summary(self) -> dict:
        return {
            "ticks": self.ticks, "kills": self.kills,
            "parity_checks": self.parity_checks,
            "mean_join": float(np.mean(self.joins)) if self.joins else 0.0,
            "events": len(self.events),
            "final_failed": list(self.final_failed),
        }


def _decide(bal: UncertaintyAwareBalancer, sim: ClusterSim) -> np.ndarray:
    """One tick's split: the steady-state solve, re-solved over survivors
    when the sim shows dead channels (no sunk work: each tick is a fresh
    instance of the whole job)."""
    failed = [i for i, c in enumerate(sim.channels) if c.failed]
    if failed:
        return bal.resolve_inflight(np.zeros(bal.num_channels),
                                    failed=failed)
    return bal.weights()


def run_chaos_trace(num_channels: int = 6, ticks: int = 24,
                    kill_every: int = 8, churn=None, seed: int = 0,
                    dist: str = "normal", family="normal",
                    lam: float = 0.05, ckpt_dir: Optional[str] = None,
                    verify_parity: bool = True,
                    device="cuda") -> ChaosResult:
    """Run a partitioned trace under churn and kill/restore cycles.

    ``churn``: ``(step, action, idx, value)`` tuples for
    :meth:`ClusterSim.schedule_churn` (value may be None for fail and
    recover). ``kill_every=0`` disables crashes. Every tick is checkpointed
    (the balancer's state, the simulator's as in-flight progress), so a
    kill at tick t restores the tick-t boundary exactly.

    Raises AssertionError if ``verify_parity`` and a restored replica's
    next decision differs in any bit from the would-be survivor's.
    """
    own_dir = ckpt_dir is None
    if own_dir:
        tmp = tempfile.TemporaryDirectory(prefix="repro_torch_chaos_")
        ckpt_dir = tmp.name
    sim = ClusterSim.heterogeneous(num_channels, seed=seed, dist=dist)
    for ev in (churn or ()):
        step, action, idx, value = (tuple(ev) + (None, None))[:4]
        sim.schedule_churn(step, action, idx, value)
    bal = UncertaintyAwareBalancer(num_channels=num_channels, lam=lam,
                                   family=family, explore=0.0, device=device)
    joins: List[float] = []
    events: List[Tuple[int, str, str]] = []
    kills = parity = 0
    try:
        for t in range(1, ticks + 1):
            w = _decide(bal, sim)
            join_t, durs = sim.run_step(w)
            bal.observe(durs, w)
            joins.append(float(join_t))
            save_pipeline(ckpt_dir, t, bal,
                          inflight={"sim": sim.state_dict(), "tick": t})
            if kill_every and t % kill_every == 0 and t < ticks:
                with obs.span(obs_names.SPAN_CHAOS_CYCLE, step=t,
                              kind="balancer", parity=verify_parity):
                    if verify_parity:
                        # the survivor's next decision, on an isolated
                        # clone so the live balancer's caches stay
                        # untouched
                        survivor = UncertaintyAwareBalancer.from_state_dict(
                            bal.state_dict(), device=device)
                        sim_sv = ClusterSim.from_state_dict(
                            sim.state_dict())
                        w_expect = _decide(survivor, sim_sv)
                    # the crash: drop the live objects, restore the manifest
                    bal2, inflight, _ = restore_pipeline(ckpt_dir,
                                                         device=device)
                    sim2 = ClusterSim.from_state_dict(inflight["sim"])
                    if verify_parity:
                        w_got = _decide(
                            UncertaintyAwareBalancer.from_state_dict(
                                bal2.state_dict(), device=device),
                            ClusterSim.from_state_dict(sim2.state_dict()))
                        if not np.array_equal(np.asarray(w_expect),
                                              np.asarray(w_got)):
                            raise AssertionError(
                                f"kill/restore parity broken at tick {t}: "
                                f"survivor {w_expect} vs replica {w_got}")
                        parity += 1
                    bal, sim = bal2, sim2
                    kills += 1
                events.append((t, "kill_restore",
                               f"restored step {t} from {ckpt_dir}"))
    finally:
        if own_dir:
            tmp.cleanup()
    return ChaosResult(
        ticks=ticks, kills=kills, parity_checks=parity, joins=joins,
        events=events,
        final_failed=[i for i, c in enumerate(sim.channels) if c.failed])


def _sync_workflow_failures(bal, sim: WorkflowSim) -> None:
    """Propagate the sim's channel health into the workflow balancer, the
    heartbeat a real scheduler gets, stage-addressed."""
    failed = bal.failed_channels()
    for name, stage_sim in sim.stage_sims.items():
        known = set(failed.get(name, ()))
        for i, c in enumerate(stage_sim.channels):
            if c.failed and i not in known:
                bal.handle_failure(name, i)
            elif not c.failed and i in known:
                bal.handle_recovery(name, i)


def run_workflow_chaos_trace(dag, ticks: int = 12, kill_every: int = 4,
                             churn=None, seed: int = 0, family="normal",
                             lam_var: float = 0.0,
                             ckpt_dir: Optional[str] = None,
                             verify_parity: bool = True,
                             device="cuda") -> ChaosResult:
    """The DAG twin of :func:`run_chaos_trace`: a :class:`WorkflowBalancer`
    driving a :class:`WorkflowSim` through stage-addressed churn
    (``WorkflowSim.schedule_churn``) and kill/restore cycles through the
    workflow-kind manifest.

    ``churn``: ``(step, action, stage, idx, value)`` tuples (stage None
    broadcasts set_load). Joins are per-tick DAG makespans. Parity compares
    the restored replica's next weights, stage by stage, bitwise against
    the would-be survivor's.
    """
    own_dir = ckpt_dir is None
    if own_dir:
        tmp = tempfile.TemporaryDirectory(prefix="repro_torch_chaos_wf_")
        ckpt_dir = tmp.name
    sim = WorkflowSim.from_dag(dag, seed=seed)
    for ev in (churn or ()):
        step, action, stage, idx, value = (tuple(ev) + (None, None, None))[:5]
        sim.schedule_churn(step, action, stage=stage, idx=idx, value=value)
    bal = WorkflowBalancer(dag, lam_var=lam_var, family=family,
                           pgd_steps=12, restarts=0, num_t=128,
                           device=device)
    joins: List[float] = []
    events: List[Tuple[int, str, str]] = []
    kills = parity = 0

    def _decide_wf(b, s):
        _sync_workflow_failures(b, s)
        return b.weights()

    try:
        for t in range(1, ticks + 1):
            ws = _decide_wf(bal, sim)
            makespan, _, durs = sim.run_dag_step(dag, ws)
            bal.observe(durs, ws)
            joins.append(float(makespan))
            save_pipeline(ckpt_dir, t, bal,
                          inflight={"sim": sim.state_dict(), "tick": t})
            if kill_every and t % kill_every == 0 and t < ticks:
                with obs.span(obs_names.SPAN_CHAOS_CYCLE, step=t,
                              kind="workflow", parity=verify_parity):
                    if verify_parity:
                        survivor = WorkflowBalancer.from_state_dict(
                            bal.state_dict(), dag, device=device)
                        sim_sv = WorkflowSim.from_state_dict(
                            sim.state_dict())
                        w_expect = _decide_wf(survivor, sim_sv)
                    bal2, inflight, _ = restore_pipeline(ckpt_dir, dag=dag,
                                                         device=device)
                    sim2 = WorkflowSim.from_state_dict(inflight["sim"])
                    if verify_parity:
                        w_got = _decide_wf(
                            WorkflowBalancer.from_state_dict(
                                bal2.state_dict(), dag, device=device),
                            WorkflowSim.from_state_dict(sim2.state_dict()))
                        for name in dag.names:
                            if not np.array_equal(
                                    np.asarray(w_expect[name]),
                                    np.asarray(w_got[name])):
                                raise AssertionError(
                                    f"workflow kill/restore parity broken "
                                    f"at tick {t}, stage {name!r}: "
                                    f"survivor {w_expect[name]} vs replica "
                                    f"{w_got[name]}")
                        parity += 1
                    bal, sim = bal2, sim2
                    kills += 1
                events.append((t, "kill_restore",
                               f"restored step {t} from {ckpt_dir}"))
    finally:
        if own_dir:
            tmp.cleanup()
    final_failed = sorted({(name, i)
                           for name, s in sim.stage_sims.items()
                           for i, c in enumerate(s.channels) if c.failed})
    return ChaosResult(
        ticks=ticks, kills=kills, parity_checks=parity, joins=joins,
        events=events,
        final_failed=[f"{name}:{i}" for name, i in final_failed])
