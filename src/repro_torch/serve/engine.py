"""Serving engine: prefill + greedy decode with KV caches, the partitioned
batcher (the paper's file-transfer scenario mapped to request routing), and
the continuous-batching :class:`WorkflowEngine`.

A batch of R requests is the workload; replica groups are the channels;
the batch completes when the slowest group returns (the join). The
batcher's :class:`UncertaintyAwareBalancer` learns each group's per-request
service rate online and re-partitions every batch, as in the JAX package's
``serve/engine.py``.

:class:`WorkflowEngine` prices the splits of MANY concurrent workflow
instances at once: every live instance's remaining stages, each with its
own posterior ``(mus, sigmas, extra)``, become rows of ONE stacked
``ops.frontier_moments_with_grads`` call per completion-time family per
tick (``workflow.solve.stack_rows`` groups them), so the solver's cost is
paid per tick, not per workflow. A per-instance loop around that call is a
lint error under ``serve/`` (RPA080). Its estimation heads live on the host
(``sched.balancer.InstanceHeads``); the engine's ``device`` governs the
stacked call alone. The tick's returned dict and the telemetry are the
reference's, and so is its trace (``obs``): an ``engine.tick`` span with
its ``live``, ``queue``, ``rows`` and ``launches``, the four
``engine.stage`` spans (admission, stack_rows, launch, commit), a
``solver.pgd`` span around each family group's call, and ``audit.dirty``
(admit, drift, slo) and ``audit.slo_lam`` events, each from values the
host holds.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from time import perf_counter
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..device import resolve_device
from ..kernels import autotune, ops
from ..obs import events as obs_events
from ..obs import names as obs_names
from ..obs import trace as obs
from ..sched.balancer import (InstanceHeads, UncertaintyAwareBalancer,
                              integerize)
from ..sim.cluster import ClusterSim, WorkflowSim
from ..workflow.solve import _project_simplex_masked, stack_rows
from .telemetry import ServeTelemetry

__all__ = ["ServeEngine", "ReplicaGroup", "PartitionedBatcher",
           "WorkflowEngine", "row_pgd_step", "stack_group", "launch_group"]


class ServeEngine:
    """Single-replica engine: batched prefill then greedy decode.

    ``model`` is an :class:`LM` holding its weights on ``device`` (the card
    by default; asking for it without one raises).
    """

    def __init__(self, model, cfg: ModelConfig, device="cuda"):
        self.device = resolve_device(device)
        if model.device.type != self.device.type:
            raise ValueError(f"the model lies on {model.device}, the engine "
                             f"serves on {self.device}")
        self.model = model
        self.cfg = cfg

    def generate(self, prompts, max_new: int) -> torch.Tensor:
        """prompts: (B, S) integer tokens (array or tensor). Greedy
        continuation of ``max_new`` tokens, (B, max_new) int64 on the
        engine's device; argmax over the unpadded vocabulary."""
        tokens = torch.as_tensor(prompts, device=self.device).long()
        B, S = tokens.shape
        V = self.cfg.vocab_size
        with torch.inference_mode():
            logits, cache = self.model.prefill(tokens, cache_len=S + max_new)
            tok = torch.argmax(logits[:, -1:, :V], dim=-1)
            outs = [tok]
            for _ in range(max_new - 1):
                logits, cache = self.model.decode_step(cache, tok)
                tok = torch.argmax(logits[:, :, :V], dim=-1)
                outs.append(tok)
        return torch.cat(outs, dim=1)


@dataclass
class ReplicaGroup:
    """A serving channel: a model replica set with its own speed
    distribution. The engine's model holds the weights (the reference keeps
    them beside it in ``params``); groups may share one model."""
    name: str
    engine: Optional[ServeEngine] = None


class PartitionedBatcher:
    """Split request batches across replica groups by the paper's frontier.

    The batch of R requests is the workflow D; replica groups are channels;
    the response is complete when the *slowest* group returns (the join).
    The balancer learns per-group (mu, sigma) per-request service rates
    online and re-partitions every batch. ``device`` is where the balancer
    solves (the card by default).
    """

    def __init__(self, groups: List[ReplicaGroup], lam: float = 0.05,
                 policy: str = "frontier", sim: Optional[ClusterSim] = None,
                 seed: int = 0, device="cuda", num_t: int = 1024,
                 refresh_every: int = 1, family="normal",
                 risk_lam: float = 0.0, adaptive_refresh: bool = False):
        self.groups = groups
        self.balancer = UncertaintyAwareBalancer(
            len(groups), lam=lam, policy=policy, device=device, num_t=num_t,
            refresh_every=refresh_every, family=family, risk_lam=risk_lam,
            adaptive_refresh=adaptive_refresh)
        self.sim = sim or ClusterSim.heterogeneous(len(groups), seed=seed)
        self.last_tick: Optional[dict] = None

    def split(self, num_requests: int) -> np.ndarray:
        return integerize(self.balancer.weights(), num_requests)

    @property
    def selected_family(self) -> str:
        """dist_id of the family the balancer currently solves under."""
        return self.balancer.selected_family.dist_id

    def run_batch(self, prompts: np.ndarray, max_new: int = 8,
                  execute: bool = False) -> Tuple[float, np.ndarray, list]:
        """Route one batch. Returns (join_latency, counts, responses).

        execute=True runs each group's model on its share of the prompts
        (responses are (count, max_new) token arrays, None for an empty
        group); the latency comes from the simulator's channels, as in the
        reference. Per-tick telemetry lands in ``self.last_tick``.
        """
        R = prompts.shape[0]
        counts = self.split(R)
        fam = self.selected_family
        responses = [None] * len(self.groups)
        if execute:
            off = 0
            for gi, c in enumerate(counts):
                if c == 0:
                    continue
                g = self.groups[gi]
                responses[gi] = g.engine.generate(
                    prompts[off:off + c], max_new).cpu().numpy()
                off += c
        join_t, durs = self.sim.run_step(counts.astype(np.float64) / max(R, 1))
        self.balancer.observe(durs, counts.astype(np.float64) / max(R, 1))
        self.last_tick = {
            "family": fam,
            "join_latency": float(join_t),
            "counts": counts,
            "effective_refresh": self.balancer.effective_refresh,
        }
        return join_t, counts, responses

    # ------------------------------------------------------------ persistence
    def state_dict(self) -> dict:
        """Balancer and sim-world snapshot (the reference's keys); replica
        groups are code-side configuration."""
        return {"balancer": self.balancer.state_dict(),
                "sim": self.sim.state_dict()}

    def load_state_dict(self, d: dict, device="cuda"):
        self.balancer = UncertaintyAwareBalancer.from_state_dict(
            d["balancer"], device=device)
        self.sim = ClusterSim.from_state_dict(d["sim"])
        return self

    @classmethod
    def from_state_dict(cls, d: dict, groups: List[ReplicaGroup],
                        device="cuda") -> "PartitionedBatcher":
        return cls(groups, device=device).load_state_dict(d, device=device)


# --------------------------------------------------------------------------
# continuous-batching workflow engine
# --------------------------------------------------------------------------

def _row_step(W, dmu, dvar, lam, mask, lr: float):
    """One normalized-gradient PGD step on every row's masked simplex.

    The per-row objective is the stage-local ``mu + lam_row * var``
    (``lam_row`` carries the instance's SLO urgency); the gradient is
    L2-normalized per row so that one step size serves stages at very
    different time scales, as in the DAG solver.
    """
    G = dmu + lam[:, None] * dvar
    G = G / (torch.linalg.norm(G, dim=-1, keepdim=True) + 1e-12)
    return _project_simplex_masked(W - lr * G, mask)


def row_pgd_step(W, mus, sigmas, dist_id, extra, lam, mask, *, num_t,
                 device="cuda", lr: float = 0.02):
    """One fused moments-and-gradients call plus a PGD step over a stacked
    row set.

    ``W`` / ``mus`` / ``sigmas`` are ``(F, K)`` rows of ONE family
    (``dist_id``; ``extra`` its ``(E, F, K)`` per-row parameters), ``lam``
    the ``(F,)`` per-row risk weight and ``mask`` the ``(F, K)`` active
    channels, all host arrays. Returns ``(mu, var, W_next)`` as float64
    numpy: the moments price the INCOMING ``W``; ``W_next`` is priced next
    tick. The inputs reach ``device`` in one copy and the outputs return in
    one, the launch's two host synchronizations on the card; the kernels'
    split follows from the shape (``kernels.autotune``). It is also the
    per-instance unit of the looped baseline in ``bench/serve_trace.py``.
    """
    dev = resolve_device(device)
    parts = [np.asarray(a, np.float32)
             for a in (W, mus, sigmas, mask, extra, lam)]
    flat = torch.from_numpy(np.concatenate([p.ravel() for p in parts]))
    W_t, mus_t, sgs_t, mask_t, ex_t, lam_t = (
        x.view(p.shape) for x, p in zip(
            torch.split(flat.to(dev), [p.size for p in parts]), parts))
    m, v, dm, dv = ops.frontier_moments_with_grads(
        W_t, mus_t, sgs_t, num_t=num_t, device=dev, family=(dist_id, ex_t))
    W2 = _row_step(W_t, dm, dv, lam_t, mask_t, lr)
    out = torch.cat([m[:, None], v[:, None], W2], dim=1).cpu().numpy()
    out = out.astype(np.float64)
    return out[:, 0], out[:, 1], out[:, 2:]


def stack_group(rows, group, mask, kmax: int):
    """The host inputs of one family group's stacked call: ``(W, mus,
    sigmas, extra, mask, lam)`` with the row axis padded to
    ``autotune.bucket_rows`` (pad rows repeat row 0 and are sliced off
    after the launch), so the launch shapes stay few as the live count
    moves. ``rows`` are the stacked rows (``.w``, ``.lam``, ``.k``) and
    ``group``, ``mask``, ``kmax`` what :func:`stack_rows` made of them."""
    n = len(group.idx)
    F = autotune.bucket_rows(n)
    E = group.extra.shape[0]
    W = np.zeros((F, kmax), np.float32)
    mus = np.zeros((F, kmax), np.float32)
    sgs = np.zeros((F, kmax), np.float32)
    ex = np.zeros((E, F, kmax), np.float32)
    msk = np.zeros((F, kmax), np.float32)
    lam = np.zeros(F, np.float32)
    for j, ridx in enumerate(group.idx):
        r = rows[ridx]
        W[j, :r.k] = r.w
        msk[j] = mask[ridx]
        lam[j] = r.lam
    mus[:n], sgs[:n], ex[:, :n] = group.mus, group.sigmas, group.extra
    if F > n:
        W[n:], mus[n:], sgs[n:] = W[0], mus[0], sgs[0]
        ex[:, n:] = ex[:, :1]
        msk[n:], lam[n:] = msk[0], lam[0]
    return W, mus, sgs, ex, msk, lam


def launch_group(rows, group, mask, kmax: int, *, num_t, device="cuda",
                 lr: float = 0.02):
    """One family group through :func:`row_pgd_step` on the inputs of
    :func:`stack_group`, as one ``solver.pgd`` span. Returns ``(mu, var,
    W_next, F)``: the group's real rows and the padded row count."""
    W, mus, sgs, ex, msk, lam = stack_group(rows, group, mask, kmax)
    n = len(group.idx)
    with obs.span(obs_names.SPAN_SOLVER_PGD, family=group.dist_id, rows=n,
                  F=int(W.shape[0]), K=int(kmax), num_t=int(num_t)):
        m, v, W2 = row_pgd_step(W, mus, sgs, group.dist_id, ex, lam, msk,
                                num_t=num_t, device=device, lr=lr)
    return m[:n], v[:n], W2[:n], W.shape[0]


@dataclass
class _EngineRow:
    """One (instance, remaining stage) pair of the current solve tick."""

    iid: int
    stage: str
    key: str                      # heads key: "template/stage"
    k: int
    mus: np.ndarray               # (k,) posterior point estimates
    sigmas: np.ndarray            # (k,)
    family: object                # the head's selected ChannelFamily
    lam: float                    # instance risk weight (SLO urgency)
    w: np.ndarray                 # (k,) incoming split (priced this launch)
    mu: Optional[float] = None    # set by the launch
    var: Optional[float] = None


@dataclass
class _Instance:
    """One live workflow instance: its progress, splits and solve state."""

    iid: int
    template: str
    deadline: float               # SLO bound on the makespan (sim seconds)
    admitted_tick: int
    elapsed: float = 0.0          # makespan so far (max stage completion)
    completions: dict = field(default_factory=dict)   # stage -> finish time
    weights: dict = field(default_factory=dict)       # stage -> (K_s,)
    stage_mu: dict = field(default_factory=dict)      # last priced moments
    stage_var: dict = field(default_factory=dict)
    steps_left: int = 0           # pending PGD descents (dirty when > 0)
    lam: float = 0.0              # risk weight at the last solve
    stat_snap: dict = field(default_factory=dict)     # stats at last solve


class WorkflowEngine:
    """Admission-queue continuous-batching engine over workflow instances.

    ``templates`` maps a template name to the :class:`StageDAG` it serves;
    each template has one shared :class:`WorkflowSim` world (its instances
    contend for the same channels), seeded ``seed + 1000 * i``. A request
    enters by :meth:`submit` (a template and an optional SLO deadline),
    waits in the admission queue while the live set is full, and once
    admitted is a live instance with its own forked estimation heads.

    One :meth:`tick`:

    1. **admit**: pending requests fill free live slots.
    2. **solve**: every dirty instance's remaining stages become rows of
       one stacked call per completion-time family (:func:`launch_group`),
       each row one normalized PGD step on its stage simplex; the same
       call's moments feed the telemetry and the SLO prediction.
    3. **execute**: each instance runs its released stages on the
       template's fleets; the observations feed the instance's heads and
       the template's prototypes.
    4. **retire**: finished instances record their join latency and SLO
       verdict and free their slot.

    An instance is dirty while ``steps_left > 0``: admission starts it at
    ``settle_steps``, and a settled instance re-dirties only when a
    remaining stage's posterior drifts past ``dirty_tol`` (relative to the
    statistics its last solve priced) or its SLO urgency moves by more
    than ``dirty_tol`` relative. Clean instances contribute no rows. Each
    instance's row weight is ``lam_var + slo_gain * min(predicted_remaining
    / slack, slo_lam_cap)``: an instance burning its deadline pays more
    for variance.

    ``device`` is where the stacked calls run (the card by default); the
    heads, the simulators and the telemetry live on the host.
    ``state_dict`` has the JAX engine's keys, with ``"impl": "xla"`` in its
    config, so either package restores the other's state.
    """

    def __init__(self, templates: Dict[str, object], *, max_live: int = 256,
                 lam_var: float = 0.0, slo_gain: float = 0.5,
                 slo_lam_cap: float = 4.0, settle_steps: int = 6,
                 dirty_tol: float = 0.05, lr: float = 0.02,
                 num_t: int = 256, device="cuda", seed: int = 0,
                 prior_obs: int = 0, telemetry_capacity: int = 2048):
        if not templates:
            raise ValueError("WorkflowEngine needs at least one template")
        self.templates = dict(templates)
        self.max_live = int(max_live)
        self.lam_var = float(lam_var)
        self.slo_gain = float(slo_gain)
        self.slo_lam_cap = float(slo_lam_cap)
        self.settle_steps = int(settle_steps)
        self.dirty_tol = float(dirty_tol)
        self.lr = float(lr)
        self.num_t = int(num_t)
        self.device = resolve_device(device)
        self.seed = int(seed)
        self.sims: Dict[str, WorkflowSim] = {
            name: WorkflowSim.from_dag(dag, seed=seed + 1000 * i)
            for i, (name, dag) in enumerate(self.templates.items())}
        prototypes = {}
        for name, dag in self.templates.items():
            for s in dag.stages:
                proto = UncertaintyAwareBalancer(
                    num_channels=s.k, family=s.family,
                    prior_mean=float(np.mean(s.mus)), explore=0.0,
                    device="cpu")
                # an optional warm prior: the template's declared stats as
                # synthetic observations, so that first admissions price
                # heterogeneous channels instead of a flat prior
                w = np.full(s.k, 1.0 / s.k)
                for _ in range(prior_obs):
                    proto.observe(s.mus * w, w)
                prototypes[f"{name}/{s.name}"] = proto
        self.heads = InstanceHeads(prototypes)
        # every stacked launch pads to this K, so launch shapes vary only
        # by the row bucket, never by the live mix
        self.kmax = max(s.k for dag in self.templates.values()
                        for s in dag.stages)
        self.telemetry = ServeTelemetry(capacity=telemetry_capacity,
                                        seed=seed)
        self._queue: deque = deque()
        self._live: Dict[int, _Instance] = {}
        self._next_iid = 0
        self.tick_count = 0
        self.last_tick: Optional[dict] = None
        self.last_rows: List[_EngineRow] = []

    # ------------------------------------------------------------ admission
    def submit(self, template: str, deadline: Optional[float] = None) -> int:
        """Enqueue one workflow request; returns its instance id.
        ``deadline`` bounds the instance's makespan in simulated seconds
        (None: no SLO, the instance solves at ``lam_var``)."""
        if template not in self.templates:
            raise ValueError(f"unknown template {template!r} "
                             f"(templates: {sorted(self.templates)})")
        iid = self._next_iid
        self._next_iid += 1
        self._queue.append({"iid": iid, "template": template,
                            "deadline": (float("inf") if deadline is None
                                         else float(deadline)),
                            "queued_tick": self.tick_count})
        return iid

    @property
    def queue_depth(self) -> int:
        return len(self._queue)

    @property
    def live_count(self) -> int:
        return len(self._live)

    def set_load(self, factor: float, template: Optional[str] = None):
        """Regime switch on one template's sim world or all of them."""
        sims = ([self.sims[template]] if template is not None
                else self.sims.values())
        for sim in sims:
            sim.set_load(factor)

    def _admit(self) -> int:
        admitted = 0
        while self._queue and len(self._live) < self.max_live:
            req = self._queue.popleft()
            iid, tpl = req["iid"], req["template"]
            dag = self.templates[tpl]
            self.heads.admit(iid, [f"{tpl}/{s.name}" for s in dag.stages])
            inst = _Instance(iid=iid, template=tpl,
                             deadline=req["deadline"],
                             admitted_tick=self.tick_count,
                             steps_left=self.settle_steps)
            for s in dag.stages:
                inst.weights[s.name] = np.full(s.k, 1.0 / s.k)
            self._live[iid] = inst
            # dirty-set membership is auditable from birth: admission is
            # the first dirty interval (steps_left = settle_steps)
            obs_events.dirty("engine", str(iid), "admit")
            self.telemetry.bump("admitted")
            self.telemetry.add("queue_wait_ticks",
                               self.tick_count - req["queued_tick"])
            admitted += 1
        return admitted

    # ------------------------------------------------------------ solve
    def _predicted_remaining(self, inst: _Instance) -> float:
        """Longest-path predicted time over the instance's remaining
        stages: the last priced stage means where a solve has run, else
        the head's naive equal-split estimate."""
        dag = self.templates[inst.template]
        lp: Dict[str, float] = {}
        best = 0.0
        for name in dag.topo_order:
            if name in inst.completions:
                continue
            if name in inst.stage_mu:
                mu_s = inst.stage_mu[name]
            else:
                mus, _ = self.heads.estimates(inst.iid,
                                              f"{inst.template}/{name}")
                mu_s = float(np.mean(mus)) / max(len(mus), 1)
            rel = max((lp[u] for u in dag.predecessors(name) if u in lp),
                      default=0.0)
            lp[name] = rel + float(mu_s)
            best = max(best, lp[name])
        return best

    def _row_lam(self, inst: _Instance) -> float:
        if not np.isfinite(inst.deadline):
            return self.lam_var
        slack = max(inst.deadline - inst.elapsed, 1e-9)
        urgency = self._predicted_remaining(inst) / slack
        return self.lam_var + self.slo_gain * min(urgency, self.slo_lam_cap)

    def _stage_drifts(self, inst: _Instance):
        """``(stage, drift)`` of each remaining priced stage, in template
        order: the largest relative move of its posterior estimates since
        the solve that priced it."""
        tpl = inst.template
        for name in self.templates[tpl].names:
            if name in inst.completions or name not in inst.stat_snap:
                continue
            mus, sigmas = self.heads.estimates(inst.iid, f"{tpl}/{name}")
            mu0, sg0 = inst.stat_snap[name]
            yield name, max(float(np.max(np.abs(mus - mu0) / np.abs(mu0))),
                            float(np.max(np.abs(sigmas - sg0)
                                         / np.maximum(np.abs(mu0), 1e-12))))

    def _posterior_drift(self, inst: _Instance) -> float:
        """The largest relative move of a remaining stage's posterior
        estimates since the solve that priced it (0 with none priced)."""
        return max((d for _, d in self._stage_drifts(inst)), default=0.0)

    def _maybe_redirty(self, inst: _Instance) -> None:
        """Posterior or urgency drift check for a settled instance; the
        first stage past ``dirty_tol`` is the one audited."""
        for name, drift in self._stage_drifts(inst):
            if drift > self.dirty_tol:
                inst.steps_left = self.settle_steps
                obs_events.dirty("engine", f"{inst.iid}/{name}", "drift",
                                 drift)
                return
        lam_now = self._row_lam(inst)
        if abs(lam_now - inst.lam) > self.dirty_tol * max(abs(inst.lam),
                                                          1.0):
            inst.steps_left = self.settle_steps
            obs_events.dirty("engine", str(inst.iid), "slo",
                             abs(lam_now - inst.lam))

    def _gather_rows(self) -> List[_EngineRow]:
        rows: List[_EngineRow] = []
        for inst in self._live.values():
            if inst.steps_left <= 0:
                self._maybe_redirty(inst)
            if inst.steps_left <= 0:
                continue
            lam_i = self._row_lam(inst)
            if obs.enabled() and lam_i > self.lam_var:
                obs_events.slo_lam(inst.iid, lam_i, self.lam_var,
                                   headroom=inst.deadline - inst.elapsed)
            tpl = inst.template
            for s in self.templates[tpl].stages:
                if s.name in inst.completions:
                    continue  # sunk work: completed stages leave the solve
                key = f"{tpl}/{s.name}"
                mus, sigmas = self.heads.estimates(inst.iid, key)
                rows.append(_EngineRow(
                    iid=inst.iid, stage=s.name, key=key, k=s.k,
                    mus=np.asarray(mus, np.float64),
                    sigmas=np.asarray(sigmas, np.float64),
                    family=self.heads.family(inst.iid, key),
                    lam=lam_i, w=inst.weights[s.name]))
        return rows

    def _solve_tick(self, rows: List[_EngineRow]) -> int:
        """One batched solve: one stacked call per family group; write the
        stepped splits and the priced moments back."""
        t0 = perf_counter()
        groups, mask, kmax = stack_rows(
            [(r.mus, r.sigmas, r.family) for r in rows], kmax=self.kmax)
        for g in groups:
            m, v, W2, F = launch_group(rows, g, mask, kmax, num_t=self.num_t,
                                       device=self.device, lr=self.lr)
            n = len(g.idx)
            self.telemetry.bump("launches")
            self.telemetry.add("rows_per_launch", n)
            self.telemetry.add("row_occupancy", n / F)
            for j, ridx in enumerate(g.idx):
                r = rows[ridx]
                inst = self._live[r.iid]
                inst.weights[r.stage] = W2[j, :r.k]
                inst.stage_mu[r.stage] = float(m[j])
                inst.stage_var[r.stage] = float(v[j])
                inst.stat_snap[r.stage] = (r.mus.copy(), r.sigmas.copy())
                r.mu, r.var = float(m[j]), float(v[j])
        # one descent consumed; the urgency each row solved under is the
        # baseline of the next re-dirty check
        for r in rows:
            self._live[r.iid].lam = r.lam
        for iid in {r.iid for r in rows}:
            self._live[iid].steps_left -= 1
        self.telemetry.add("solver_tick_us", (perf_counter() - t0) * 1e6)
        return len(groups)

    # ------------------------------------------------------------ execute
    def _execute(self) -> List[dict]:
        retired: List[dict] = []
        for iid in list(self._live):
            inst = self._live[iid]
            dag = self.templates[inst.template]
            sim = self.sims[inst.template]
            ready = [s for s in dag.stages
                     if s.name not in inst.completions
                     and all(u in inst.completions
                             for u in dag.predecessors(s.name))]
            for s in ready:
                release = max((inst.completions[u]
                               for u in dag.predecessors(s.name)),
                              default=0.0)
                w = inst.weights[s.name]
                join_t, durs = sim.stage_sims[s.name].run_step(w)
                inst.completions[s.name] = release + join_t
                self.heads.observe(iid, f"{inst.template}/{s.name}",
                                   durs, w)
            if inst.completions:
                inst.elapsed = max(inst.completions.values())
            if len(inst.completions) == len(dag.stages):
                miss = inst.elapsed > inst.deadline
                self.telemetry.bump("retired")
                if miss:
                    self.telemetry.bump("slo_misses")
                self.telemetry.add("join_latency_s", inst.elapsed)
                retired.append({"iid": iid, "template": inst.template,
                                "join_latency_s": inst.elapsed,
                                "slo_miss": bool(miss),
                                "ticks_in_flight":
                                    self.tick_count - inst.admitted_tick})
                self.heads.retire(iid)
                del self._live[iid]
        return retired

    # ------------------------------------------------------------ tick
    def tick(self, arrivals=()) -> dict:
        """One engine tick: admit, batched solve, execute, retire.

        ``arrivals``: template names (or ``(template, deadline)`` pairs) to
        submit before admission.
        """
        self.tick_count += 1
        obs.set_tick(self.tick_count)
        with obs.span(obs_names.SPAN_ENGINE_TICK) as sp_tick:
            for sim in self.sims.values():
                sim.tick()  # scheduled churn fires before this tick's draws
            for a in arrivals:
                if isinstance(a, (tuple, list)):
                    self.submit(a[0], a[1])
                else:
                    self.submit(a)
            with obs.span(obs_names.SPAN_ENGINE_STAGE, stage="admission"):
                admitted = self._admit()
            with obs.span(obs_names.SPAN_ENGINE_STAGE, stage="stack_rows"):
                rows = self._gather_rows()
            with obs.span(obs_names.SPAN_ENGINE_STAGE, stage="launch"):
                launches = self._solve_tick(rows) if rows else 0
            self.last_rows = rows
            with obs.span(obs_names.SPAN_ENGINE_STAGE, stage="commit"):
                retired = self._execute()
            self.telemetry.bump("ticks")
            self.telemetry.add("live_instances", len(self._live))
            self.last_tick = {
                "tick": self.tick_count,
                "admitted": admitted,
                "retired": retired,
                "live": len(self._live),
                "queue": len(self._queue),
                "rows": len(rows),
                "launches": launches,
            }
            if obs.enabled():
                sp_tick.attrs.update(live=len(self._live),
                                     queue=len(self._queue),
                                     rows=len(rows), launches=launches)
        return self.last_tick

    # ------------------------------------------------------------ state
    def state_dict(self) -> dict:
        """Everything the kill/restore tick-parity contract needs: the
        admission queue, every live instance, all estimation heads, every
        template's sim world (generators included) and the telemetry, under
        the JAX engine's keys. ``config["impl"]`` is ``"xla"`` (the JAX
        package's plain path) and names no device, so the JAX engine
        restores the state; the port's restore ignores it. Templates stay
        code-side."""
        return {
            "kind": "engine",
            "config": {
                "max_live": self.max_live, "lam_var": self.lam_var,
                "slo_gain": self.slo_gain, "slo_lam_cap": self.slo_lam_cap,
                "settle_steps": self.settle_steps,
                "dirty_tol": self.dirty_tol, "lr": self.lr,
                "num_t": self.num_t, "impl": "xla", "seed": self.seed,
            },
            "tick_count": self.tick_count,
            "next_iid": self._next_iid,
            "queue": [dict(q) for q in self._queue],
            "instances": {str(iid): {
                "template": i.template,
                "deadline": (None if not np.isfinite(i.deadline)
                             else i.deadline),
                "admitted_tick": i.admitted_tick,
                "elapsed": i.elapsed,
                "completions": {k: float(v)
                                for k, v in i.completions.items()},
                "weights": {k: np.asarray(v).tolist()
                            for k, v in i.weights.items()},
                "stage_mu": dict(i.stage_mu),
                "stage_var": dict(i.stage_var),
                "steps_left": i.steps_left,
                "lam": i.lam,
                "stat_snap": {k: [np.asarray(m).tolist(),
                                  np.asarray(s).tolist()]
                              for k, (m, s) in i.stat_snap.items()},
            } for iid, i in self._live.items()},
            "heads": self.heads.state_dict(),
            "sims": {name: sim.state_dict()
                     for name, sim in self.sims.items()},
            "telemetry": self.telemetry.state_dict(),
        }

    def load_state_dict(self, d: dict) -> "WorkflowEngine":
        self.tick_count = int(d["tick_count"])
        self._next_iid = int(d["next_iid"])
        self._queue = deque(dict(q) for q in d.get("queue", []))
        self._live = {}
        for iid_s, s in d.get("instances", {}).items():
            iid = int(iid_s)
            self._live[iid] = _Instance(
                iid=iid, template=s["template"],
                deadline=(float("inf") if s["deadline"] is None
                          else float(s["deadline"])),
                admitted_tick=int(s["admitted_tick"]),
                elapsed=float(s["elapsed"]),
                completions={k: float(v)
                             for k, v in s["completions"].items()},
                weights={k: np.asarray(v, np.float64)
                         for k, v in s["weights"].items()},
                stage_mu={k: float(v) for k, v in s["stage_mu"].items()},
                stage_var={k: float(v) for k, v in s["stage_var"].items()},
                steps_left=int(s["steps_left"]),
                lam=float(s["lam"]),
                stat_snap={k: (np.asarray(m, np.float64),
                               np.asarray(sg, np.float64))
                           for k, (m, sg) in s["stat_snap"].items()})
        self.heads = InstanceHeads.from_state_dict(d["heads"])
        self.sims = {name: WorkflowSim.from_state_dict(sd)
                     for name, sd in d["sims"].items()}
        self.telemetry = ServeTelemetry.from_state_dict(d["telemetry"])
        return self

    @classmethod
    def from_state_dict(cls, d: dict, templates: Dict[str, object],
                        device="cuda") -> "WorkflowEngine":
        """Restore against the code-side ``templates`` on ``device``; the
        saved ``"impl"`` does not choose it."""
        cfg = {k: v for k, v in d.get("config", {}).items() if k != "impl"}
        return cls(templates, device=device, **cfg).load_state_dict(d)
