"""Discrete cluster simulator: channels with stochastic service rates.

Channel i processing work fraction w completes in ``w * rate`` with the
rate drawn from its regime, on the host in float64 numpy. The draws are
those of the JAX package's ``sim/cluster.py`` call for call, so a trace made
here matches one made there draw for draw under the same seed:

* ``normal``    — the paper's model (contended compute);
* ``lognormal`` — heavy-tailed transfer times, moment-matched to
  ``(mu, sigma)`` exactly like the lognormal family;
* ``drift``     — within-work straggle, ``T = w r + rho mu w^2 / 2``;
* ``defective`` — attempts fail with probability ``fail_p`` and are re-run,
  a failure costing ``resume_frac`` of an attempt.

The ``empirical`` family has no generating regime: it is a mixture the
estimator fits to whatever the channels produce. Per-step multiplicative mu
drift, a fleet-wide load factor and scheduled churn (fail, recover,
throttle, set_load) complete the physics. :class:`WorkflowSim` runs one
such fleet per stage of a workflow DAG.

Tracing (``obs``): each :meth:`ClusterSim.run_step` and
:meth:`WorkflowSim.tick` is a ``sim.step`` span, and each churn event that
fires is an ``audit.churn`` event, as in the JAX package.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Tuple, Union

import numpy as np

from ..core.distributions import lognormal_shape_np, resolve_family
from ..obs import events as obs_events
from ..obs import names as obs_names
from ..obs import trace as obs

__all__ = ["Channel", "ClusterSim", "WorkflowSim"]

_DISTS = ("normal", "lognormal", "drift", "defective")

_CHURN_ACTIONS = ("fail", "recover", "throttle", "set_load")


@dataclass
class Channel:
    mu: float                      # mean seconds per unit work
    sigma: float                   # std seconds per unit work
    dist: str = "normal"           # normal | lognormal | drift | defective
    drift: float = 0.0             # per-step multiplicative mu drift
    rho: float = 0.0               # within-work drift rate (dist == "drift")
    fail_p: float = 0.0            # attempt failure prob (dist == "defective")
    resume_frac: float = 1.0       # fraction of an attempt a failure costs
    failed: bool = False

    def __post_init__(self):
        if self.dist not in _DISTS:
            raise ValueError(f"dist must be one of {_DISTS}, got {self.dist!r}")
        if not 0.0 <= self.fail_p <= 1.0:
            raise ValueError(f"fail_p must lie in [0, 1], got {self.fail_p}")
        if not 0.0 <= self.resume_frac <= 1.0:
            raise ValueError(f"resume_frac must lie in [0, 1], "
                             f"got {self.resume_frac}")

    def sample(self, rng: np.random.Generator, work: float) -> float:
        """One draw for this channel alone."""
        if self.failed or work <= 0:
            return 0.0
        if self.dist == "lognormal":
            s_l, base = lognormal_shape_np(self.mu, self.sigma)
            r = rng.lognormal(base, s_l)
        else:
            r = rng.normal(self.mu, self.sigma)
        dur = work * r
        if self.dist == "drift":
            dur += 0.5 * self.rho * self.mu * work * work
        elif self.dist == "defective" and self.fail_p > 0:
            nfail = int(rng.geometric(1.0 - min(self.fail_p, 1.0 - 1e-9))) - 1
            lost = nfail * self.mu + np.sqrt(nfail) * self.sigma \
                * rng.standard_normal()
            dur += self.resume_frac * work * lost
        return max(dur, 1e-9)


@dataclass
class ClusterSim:
    """A fleet of channels; ``load_factor`` scales every service time (the
    congestion regime, switched by :meth:`set_load`)."""

    channels: list
    seed: int = 0
    step_count: int = 0
    load_factor: float = 1.0
    churn: dict = field(default_factory=dict)  # step -> [(action, idx, value)]
    rng: np.random.Generator = field(init=False)

    def __post_init__(self):
        self.rng = np.random.default_rng(self.seed)

    def set_load(self, factor: float):
        """Switch the fleet-wide congestion regime."""
        if factor <= 0:
            raise ValueError(f"load factor must be positive, got {factor}")
        self.load_factor = float(factor)

    @classmethod
    def heterogeneous(cls, n: int, mu_range=(10.0, 40.0), cov_range=(0.02, 0.3),
                      seed: int = 0, dist: str = "normal",
                      rho_range=(0.1, 0.8),
                      fail_range=(0.02, 0.15)) -> "ClusterSim":
        """A random fleet of ``n`` channels under regime ``dist`` (drift
        draws per-channel rho from ``rho_range``, defective a failure
        probability from ``fail_range``)."""
        rng = np.random.default_rng(seed)
        chans = []
        for _ in range(n):
            mu = rng.uniform(*mu_range)
            sigma = mu * rng.uniform(*cov_range)
            rho = rng.uniform(*rho_range) if dist == "drift" else 0.0
            fp = rng.uniform(*fail_range) if dist == "defective" else 0.0
            chans.append(Channel(mu=mu, sigma=sigma, dist=dist, rho=rho,
                                 fail_p=fp))
        return cls(channels=chans, seed=seed + 1)

    # ------------------------------------------------------------- churn
    def schedule_churn(self, step: int, action: str, idx: Optional[int] = None,
                       value: Optional[float] = None):
        """Queue a churn event for the ``step``-th :meth:`run_step` call
        (1-based); it fires before that step's draws."""
        if action not in _CHURN_ACTIONS:
            raise ValueError(f"churn action must be one of {_CHURN_ACTIONS}, "
                             f"got {action!r}")
        if action in ("fail", "recover", "throttle") and idx is None:
            raise ValueError(f"churn action {action!r} needs a channel idx")
        if action in ("throttle", "set_load") and value is None:
            raise ValueError(f"churn action {action!r} needs a value")
        self.churn.setdefault(int(step), []).append((action, idx, value))

    def _apply_churn(self):
        for action, idx, value in self.churn.pop(self.step_count, ()):
            obs_events.churn(action, -1 if idx is None else idx, "sim",
                             detail=value)
            if action == "fail":
                self.inject_failure(idx)
            elif action == "recover":
                self.recover(idx)
            elif action == "throttle":
                self.inject_slowdown(idx, value)
            else:
                self.set_load(value)

    @property
    def true_params(self) -> Tuple[np.ndarray, np.ndarray]:
        return (np.asarray([c.mu for c in self.channels]),
                np.asarray([c.sigma for c in self.channels]))

    def _resolve_rng(self, rng) -> np.random.Generator:
        if rng is None:
            return self.rng
        if isinstance(rng, np.random.Generator):
            return rng
        return np.random.default_rng(rng)

    @obs.traced(obs_names.SPAN_SIM_STEP, sim="cluster")
    def run_step(self, weights,
                 rng: Union[None, int, np.random.Generator] = None
                 ) -> Tuple[float, np.ndarray]:
        """One partitioned step: ``(join_time, per-channel durations)``.

        ``weights`` (any array-like, torch tensors included) are scaled to
        sum to 1; ``rng`` (a seed or a Generator) replaces the simulator's
        own stream for this step. The join time is the max over active
        channels.
        """
        self.step_count += 1
        self._apply_churn()
        r = self._resolve_rng(rng)
        if hasattr(weights, "detach"):
            weights = weights.detach().cpu().numpy()
        w = np.asarray(weights, np.float64).reshape(-1)
        if w.shape[0] != len(self.channels):
            raise ValueError(f"got {w.shape[0]} weights for "
                             f"{len(self.channels)} channels")
        total = w.sum()
        if total > 0:
            w = w / total
        mu = np.asarray([c.mu for c in self.channels])
        sigma = np.asarray([c.sigma for c in self.channels])
        active = np.asarray([not c.failed for c in self.channels]) & (w > 0)
        rates = r.normal(mu, sigma)
        ln_mask = np.asarray([c.dist == "lognormal" for c in self.channels])
        if ln_mask.any():
            s_l, base = lognormal_shape_np(mu, sigma)
            rates = np.where(ln_mask, r.lognormal(base, s_l), rates)
        durs = w * rates
        rho = np.asarray([c.rho if c.dist == "drift" else 0.0
                          for c in self.channels])
        if rho.any():
            durs = durs + 0.5 * rho * mu * w * w
        pf = np.asarray([c.fail_p if c.dist == "defective" else 0.0
                         for c in self.channels])
        if pf.any():
            # a geometric count of failed attempts per channel, each costing
            # resume_frac of an attempt's random length
            lam = np.asarray([c.resume_frac for c in self.channels])
            q = np.clip(1.0 - pf, 1e-9, 1.0)
            nfail = r.geometric(q) - 1
            lost = nfail * mu + np.sqrt(nfail) * sigma \
                * r.standard_normal(len(self.channels))
            durs = durs + np.where(pf > 0, lam * w * lost, 0.0)
        if self.load_factor != 1.0:
            durs = durs * self.load_factor
        durs = np.where(active, np.maximum(durs, 1e-9), 0.0)
        for c in self.channels:  # slow multiplicative drift
            if c.drift:
                c.mu *= (1.0 + c.drift)
        return float(durs.max(initial=0.0)), durs

    # ------------------------------------------------------------ persistence
    def state_dict(self) -> dict:
        """Channel physics, churn queue and the generator state: a restored
        sim replays the exact trace."""
        return {
            "seed": self.seed,
            "step_count": self.step_count,
            "load_factor": self.load_factor,
            "churn": {str(k): [list(e) for e in v]
                      for k, v in self.churn.items()},
            "channels": [{
                "mu": float(c.mu), "sigma": float(c.sigma), "dist": c.dist,
                "drift": float(c.drift), "rho": float(c.rho),
                "fail_p": float(c.fail_p),
                "resume_frac": float(c.resume_frac), "failed": bool(c.failed),
            } for c in self.channels],
            "rng_state": self.rng.bit_generator.state,
        }

    @classmethod
    def from_state_dict(cls, d: dict) -> "ClusterSim":
        sim = cls(channels=[Channel(**c) for c in d["channels"]],
                  seed=d.get("seed", 0),
                  step_count=d.get("step_count", 0),
                  load_factor=d.get("load_factor", 1.0),
                  churn={int(k): [tuple(e) for e in v]
                         for k, v in d.get("churn", {}).items()})
        if d.get("rng_state") is not None:
            sim.rng.bit_generator.state = d["rng_state"]
        return sim

    def inject_failure(self, idx: int):
        self.channels[idx].failed = True

    def inject_slowdown(self, idx: int, factor: float):
        self.channels[idx].mu *= factor
        self.channels[idx].sigma *= factor

    def recover(self, idx: int, mu: Optional[float] = None,
                sigma: Optional[float] = None):
        c = self.channels[idx]
        c.failed = False
        if mu is not None:
            c.mu = mu
        if sigma is not None:
            c.sigma = sigma


@dataclass
class WorkflowSim:
    """Workflow traces: one :class:`ClusterSim` fleet per DAG stage.

    A stage is released when its last predecessor completes, runs on its
    own stochastic fleet, and the makespan is the latest sink completion:
    the discrete-event twin of ``StageDAG.compose_moments``, with no
    Gaussian approximation. ``stage_sims`` maps stage name to fleet.
    Stages run in topological order; a passed ``rng`` is one stream shared
    by every stage of the step. The draws are the JAX package's
    ``WorkflowSim``'s in the same order, so traces agree draw for draw.
    """

    stage_sims: dict
    seed: int = 0
    step_count: int = 0
    # step -> [(action, stage, idx, value)]
    churn: dict = field(default_factory=dict)

    @classmethod
    def from_dag(cls, dag, seed: int = 0) -> "WorkflowSim":
        """Fleets with each stage's (mus, sigmas) under its family's regime
        (an empirical stage runs the normal regime; the mixture is the
        estimator's, not a generator); stage i draws from seed + 1 + i."""
        sims = {}
        for i, s in enumerate(dag.stages):
            dist = s.dist_id if s.dist_id in _DISTS else "normal"
            rho = np.zeros(s.k)
            fail_p, resume = np.zeros(s.k), np.ones(s.k)
            if dist in ("drift", "defective"):
                ex = np.asarray(resolve_family(s.family, s.k)[1], np.float64)
                if dist == "drift":
                    rho = ex[0]
                else:
                    fail_p, resume = ex[0], ex[1]
            chans = [Channel(mu=float(s.mus[j]), sigma=float(s.sigmas[j]),
                             dist=dist, rho=float(rho[j]),
                             fail_p=float(fail_p[j]),
                             resume_frac=float(resume[j]))
                     for j in range(s.k)]
            sims[s.name] = ClusterSim(channels=chans, seed=seed + 1 + i)
        return cls(stage_sims=sims, seed=seed)

    # ------------------------------------------------------------- churn
    def schedule_churn(self, step: int, action: str,
                       stage: Optional[str] = None, idx: Optional[int] = None,
                       value: Optional[float] = None):
        """Queue a churn event for the ``step``-th :meth:`tick` (1-based):
        fail, recover or throttle channel ``idx`` of ``stage``, or
        set_load on ``stage`` (every stage when None). It fires before
        that step's draws."""
        if action not in _CHURN_ACTIONS:
            raise ValueError(f"churn action must be one of {_CHURN_ACTIONS}, "
                             f"got {action!r}")
        if stage is not None and stage not in self.stage_sims:
            raise ValueError(f"unknown stage {stage!r} "
                             f"(stages: {sorted(self.stage_sims)})")
        if action in ("fail", "recover", "throttle"):
            if stage is None:
                raise ValueError(f"churn action {action!r} needs a stage")
            if idx is None:
                raise ValueError(f"churn action {action!r} needs a "
                                 f"channel idx")
        if action in ("throttle", "set_load") and value is None:
            raise ValueError(f"churn action {action!r} needs a value")
        self.churn.setdefault(int(step), []).append((action, stage, idx,
                                                     value))

    @obs.traced(obs_names.SPAN_SIM_STEP, sim="workflow")
    def tick(self):
        """Advance the workflow clock one step and fire its churn events."""
        self.step_count += 1
        for action, stage, idx, value in self.churn.pop(self.step_count, ()):
            obs_events.churn(action, -1 if idx is None else idx, "sim",
                             detail=(stage if stage is not None else value))
            targets = ([self.stage_sims[stage]] if stage is not None
                       else list(self.stage_sims.values()))
            for sim in targets:
                if action == "fail":
                    sim.inject_failure(idx)
                elif action == "recover":
                    sim.recover(idx)
                elif action == "throttle":
                    sim.inject_slowdown(idx, value)
                else:
                    sim.set_load(value)

    def set_load(self, factor: float, stage: Optional[str] = None):
        """Switch the congestion regime of one stage fleet, or of every
        stage fleet when ``stage`` is None."""
        targets = ([self.stage_sims[stage]] if stage is not None
                   else self.stage_sims.values())
        for sim in targets:
            sim.set_load(factor)

    def run_dag_step(self, dag, weights: dict,
                     rng: Union[None, int, np.random.Generator] = None):
        """One workflow instance under per-stage splits ``weights``
        ({name: (K_s,)}). Returns ``(makespan, completions, durations)``:
        each stage's absolute finish time and its per-channel busy times."""
        self.tick()
        r = (np.random.default_rng(rng) if isinstance(rng, int) else rng)
        completions, durations = {}, {}
        for name in dag.topo_order:
            release = max((completions[u] for u in dag.predecessors(name)),
                          default=0.0)
            join_t, durs = self.stage_sims[name].run_step(weights[name],
                                                          rng=r)
            completions[name] = release + join_t
            durations[name] = durs
        makespan = max(completions[n] for n in dag.sinks)
        return makespan, completions, durations

    # ------------------------------------------------------------ persistence
    def state_dict(self) -> dict:
        """Every stage fleet's state (generators included), the clock and
        the pending churn, under the JAX package's keys."""
        return {
            "seed": self.seed,
            "step_count": self.step_count,
            "churn": {str(k): [list(e) for e in v]
                      for k, v in self.churn.items()},
            "stages": {name: sim.state_dict()
                       for name, sim in self.stage_sims.items()},
        }

    @classmethod
    def from_state_dict(cls, d: dict) -> "WorkflowSim":
        return cls(
            stage_sims={name: ClusterSim.from_state_dict(sd)
                        for name, sd in d["stages"].items()},
            seed=d.get("seed", 0),
            step_count=d.get("step_count", 0),
            churn={int(k): [tuple(e) for e in v]
                   for k, v in d.get("churn", {}).items()})
