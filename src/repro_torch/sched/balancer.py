"""UncertaintyAwareBalancer: the paper's partitioner driving real work splits.

Keeps per-channel Normal-Inverse-Gamma posteriors over per-unit-work
completion time, turns their point estimates into frontier weights through
``core.partitioner`` and emits integer work assignments.

* ``family="auto"`` selects the completion-time family online: a bounded
  (rate, work) history is BIC-scored every ``auto_every`` observations
  (``core.bayes.score_families``) and a challenger must win ``hysteresis``
  passes in a row before the balancer switches; a switch invalidates the
  cached solve.
* ``adaptive_refresh=True`` sizes the refresh cadence by the delta-method
  fragility of each fresh solve (``core.sensitivity``).
* ``risk_lam > 0`` scores candidates by ``mu + lam var + risk_lam
  fragility``.

The solves run on ``device`` (the CUDA kernels on ``"cuda"``, their plain
versions on ``"cpu"``); the posteriors live there too. ``state_dict`` has
the keys of the JAX package's balancer and round-trips the whole estimation
state, so a restored balancer resumes identical ticks. Its ``"impl"`` is
written as ``"xla"``, the JAX package's plain path, so that the JAX
balancer restores the state and solves; the port's own restore ignores it.

:class:`WorkflowBalancer` lifts the loop to a stage DAG: one estimation
head per stage and joint re-solves through ``workflow.solve.solve_dag``.
:class:`InstanceHeads` keeps the serving engine's per-instance heads.

Tracing (``obs``): a refresh that re-solves is a ``sched.refresh`` span;
a family switch, the workflow balancer's fragility gate, its dirty stages
and the failures and recoveries it is told of are audit events. Every
attribute is a number the balancer already holds on the host.
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Optional, Sequence

import numpy as np
import torch

from ..core.bayes import (NIGState, fit_selected_family, nig_init,
                          nig_point_estimates, nig_update_batch,
                          score_families)
from ..core.distributions import (get_family, remaining_work_stats,
                                  resolve_family)
from ..core.partitioner import (equal_split, inverse_mu_split, optimize_2ch,
                                optimize_weights, predict_moments)
from ..device import resolve_device
from ..obs import events as obs_events
from ..obs import names as obs_names
from ..obs import trace as obs

__all__ = ["integerize", "UncertaintyAwareBalancer", "WorkflowBalancer",
           "InstanceHeads"]


def _cadence_from_fragility(rel_fragility: float, cap: int,
                            target_rel: float) -> int:
    """Refresh cadence in [1, cap]: tolerated drift over the current
    relative fragility."""
    cap = max(cap, 1)
    if rel_fragility <= 0.0:
        return cap
    return int(np.clip(round(target_rel / rel_fragility), 1, cap))


def integerize(weights: np.ndarray, total: int) -> np.ndarray:
    """Largest-remainder rounding of simplex weights into nonnegative
    integer counts summing to ``total``."""
    w = np.maximum(np.asarray(weights, np.float64), 0.0)
    w = w / max(w.sum(), 1e-12)
    raw = w * total
    base = np.floor(raw).astype(np.int64)
    rem = total - int(base.sum())
    if rem > 0:
        order = np.argsort(-(raw - base))
        base[order[:rem]] += 1
    return base


@dataclass
class UncertaintyAwareBalancer:
    """Online paper-partitioner over K channels.

    lam     — mean-variance tradeoff on the frontier (0 = pure speed).
    policy  — "frontier" (the paper), "equal" (map-reduce baseline),
              "inverse_mu" (deterministic balance baseline).
    family  — a family name, a ``ChannelFamily``, or "auto".
    device  — where the solves and posteriors run ("cuda" or "cpu").
    """

    num_channels: int
    lam: float = 0.05
    policy: str = "frontier"
    prior_mean: float = 1.0
    min_weight: float = 0.0
    refresh_every: int = 1      # re-solve every N observations
    pgd_steps: int = 150        # K-channel solver budget (warm-started)
    device: object = "cuda"
    num_t: int = 1024           # survival-integral resolution per candidate
    family: object = "normal"   # completion-time family ("auto" = online)
    risk_lam: float = 0.0       # fragility weight in the candidate scoring
    adaptive_refresh: bool = False
    refresh_target_rel: float = 0.02
    history_window: int = 128   # (rate, work) observations kept per channel
    auto_every: int = 8         # BIC-score cadence, in observations
    auto_min_obs: int = 12      # history needed before scoring starts
    hysteresis: int = 3         # consecutive wins before a family switch
    explore: float = 0.15       # auto-mode probe amplitude (see weights())
    _nig: NIGState = field(default=None, repr=False)
    _cached_w: np.ndarray = field(default=None, repr=False)
    _cached_family_key: object = field(default=None, repr=False)
    _obs_count: int = 0
    _selected_family: object = field(default=None, repr=False)
    _challenger: Optional[str] = field(default=None, repr=False)
    _challenger_count: int = 0
    _last_scores: object = field(default=None, repr=False)
    _effective_refresh: Optional[int] = field(default=None, repr=False)
    _last_fragility: Optional[float] = field(default=None, repr=False)
    _last_rel_fragility: Optional[float] = field(default=None, repr=False)
    _hist_rates: list = field(default_factory=list, repr=False)
    _hist_work: list = field(default_factory=list, repr=False)
    _hist_mask: list = field(default_factory=list, repr=False)

    def __post_init__(self):
        self.device = resolve_device(self.device)
        if self._nig is None:
            self._nig = nig_init(self.num_channels, m0=self.prior_mean,
                                 device=self.device)
        if self._selected_family is None:
            self._selected_family = get_family(
                None if self._is_auto else self.family)
        if self._effective_refresh is None:
            self._effective_refresh = max(self.refresh_every, 1)

    @property
    def _is_auto(self) -> bool:
        return isinstance(self.family, str) and self.family == "auto"

    @property
    def selected_family(self):
        """The ChannelFamily the next frontier solve runs under."""
        return (self._selected_family if self._is_auto
                else get_family(self.family))

    @property
    def family_scores(self):
        """The last ``core.bayes.FamilyScores`` (None before the first)."""
        return self._last_scores

    @property
    def effective_refresh(self) -> int:
        """Current refresh cadence (== refresh_every unless adaptive)."""
        return int(self._effective_refresh or max(self.refresh_every, 1))

    # ------------------------------------------------------------ feedback
    def observe(self, durations: Sequence[float], work: Sequence[float]):
        """Per-channel durations for the assigned work fractions; work == 0
        entries (idle or failed channels) are masked out."""
        d = np.asarray(durations, np.float64)
        w = np.asarray(work, np.float64)
        mask = (w > 0).astype(np.float32)
        rates = np.where(w > 0, d / np.maximum(w, 1e-12),
                         0.0).astype(np.float32)
        self._nig = nig_update_batch(self._nig, torch.from_numpy(rates),
                                     torch.from_numpy(mask))
        self._obs_count += 1
        if self._is_auto:
            self._hist_rates.append(rates)
            self._hist_work.append(w.astype(np.float32))
            self._hist_mask.append(mask)
            if len(self._hist_rates) > self.history_window:
                del self._hist_rates[0], self._hist_work[0], \
                    self._hist_mask[0]
            if self._obs_count % max(self.auto_every, 1) == 0:
                self._auto_select()

    def _auto_select(self):
        """One BIC scoring pass plus hysteresis."""
        if len(self._hist_rates) < self.auto_min_obs:
            return
        scores = score_families(np.stack(self._hist_rates),
                                np.stack(self._hist_work),
                                np.stack(self._hist_mask),
                                min_obs=self.auto_min_obs)
        if scores is None:
            return
        self._last_scores = scores
        current = self._selected_family.dist_id
        if scores.winner == current:
            # the incumbent re-won: refit its parameters in place (the
            # family key then invalidates the solve if they moved)
            self._challenger, self._challenger_count = None, 0
            if current in ("drift", "empirical"):
                self._selected_family = fit_selected_family(scores)
            return
        if scores.winner != self._challenger:
            self._challenger, self._challenger_count = scores.winner, 1
        else:
            self._challenger_count += 1
        if self._challenger_count >= max(self.hysteresis, 1):
            obs_events.family_switch(current, scores.winner, scores.bics,
                                     streak=self._challenger_count)
            self._selected_family = fit_selected_family(scores)
            self._challenger, self._challenger_count = None, 0
            self._cached_w = None

    def estimates(self):
        """``(mu_hat, sigma_hat)`` as float64 numpy (K,)."""
        mu, sigma = nig_point_estimates(self._nig)
        return (mu.cpu().numpy().astype(np.float64),
                sigma.cpu().numpy().astype(np.float64))

    # ------------------------------------------------------------ decisions
    @staticmethod
    def _family_key(fam) -> str:
        """Canonical JSON fingerprint of a family spec (the cache key)."""
        fam = get_family(fam)
        items = {k: (np.asarray(v).ravel().tolist() if not isinstance(v, str)
                     else v)
                 for k, v in fam.state_dict().items()}
        return json.dumps([fam.dist_id, items], sort_keys=True)

    def _size_refresh(self, rel_fragility: float):
        self._effective_refresh = _cadence_from_fragility(
            rel_fragility, self.refresh_every, self.refresh_target_rel)

    def weights(self, family=None) -> np.ndarray:
        """Current split; ``family`` overrides the configured family for
        this solve."""
        mus, sigmas = self.estimates()
        k = self.num_channels
        fam = self.selected_family if family is None else family
        if self.policy == "equal":
            w = np.full((k,), 1.0 / k)
        elif self.policy == "inverse_mu":
            w = inverse_mu_split(mus, self.device).cpu().numpy().astype(
                np.float64)
        else:
            # cached between refreshes; a family change always re-solves
            fam_key = self._family_key(fam)
            cadence = (self.effective_refresh if self.adaptive_refresh
                       else max(self.refresh_every, 1))
            stale = (self._cached_w is None
                     or len(self._cached_w) != k
                     or fam_key != self._cached_family_key
                     or self._obs_count % cadence == 0)
            if not stale:
                w = self._cached_w.copy()
            elif k == 2 and self.risk_lam <= 0 and not self.adaptive_refresh:
                w = optimize_2ch(mus[0], sigmas[0], mus[1], sigmas[1],
                                 lam=self.lam, family=fam,
                                 device=self.device).weights
            else:
                restarts = 2 if k <= 16 else 0
                warm = (self._cached_w
                        if self._cached_w is not None
                        and len(self._cached_w) == k else None)
                with obs.span(obs_names.SPAN_SCHED_REFRESH, kind="fleet",
                              k=k, warm=warm is not None):
                    out = optimize_weights(
                        mus, sigmas, lam=self.lam, steps=self.pgd_steps,
                        restarts=restarts,
                        num_t=self.num_t, warm_start=warm, family=fam,
                        risk_lam=self.risk_lam,
                        posterior=(self._nig if self.risk_lam > 0
                                   or self.adaptive_refresh else None),
                        return_sensitivity=self.adaptive_refresh,
                        device=self.device)
                if self.adaptive_refresh:
                    dec, report = out
                    self._last_fragility = report.fragility
                    self._last_rel_fragility = report.relative_fragility
                    self._size_refresh(report.relative_fragility)
                else:
                    dec = out
                w = dec.weights
            self._cached_w = np.asarray(w, np.float64)
            self._cached_family_key = fam_key
        if self._is_auto and self.explore > 0 and self.policy == "frontier":
            # deterministic +-explore probe so the drift regression sees
            # spread in every channel's work share; before the floor
            sign = 1.0 - 2.0 * ((np.arange(k) + self._obs_count) % 2)
            w = w * (1.0 + self.explore * sign)
            w = np.maximum(w, 0.0)
            w = w / max(w.sum(), 1e-12)
        if self.min_weight > 0:
            w = np.maximum(w, self.min_weight)
            w = w / w.sum()
        return np.asarray(w, np.float64)

    def assign(self, total_units: int) -> np.ndarray:
        """Integer work assignment (e.g. microbatch counts per pod)."""
        return integerize(self.weights(), total_units)

    def resolve_inflight(self, done, failed=None) -> np.ndarray:
        """Mid-flight re-solve of a partly executed job.

        ``done``: per-channel fractions of the whole job already completed;
        ``failed``: channel indices now dead (they get zero share). Returns
        shares of the remaining work ``1 - sum(done)``, warm-started from the
        previous solve minus the sunk progress. With no failures, an
        adaptive-refresh balancer whose last solve was firm returns the warm
        start without a solve; a failure always forces the solve.
        """
        done = np.asarray(done, np.float64)
        k = self.num_channels
        active = np.ones(k, bool)
        if failed is not None:
            failed = np.asarray(sorted(set(int(i) for i in failed)), int)
            active[failed] = False
        r = float(max(1.0 - done.sum(), 0.0))
        if r <= 0.0 or not active.any():
            return np.zeros(k)
        mus, sigmas = self.estimates()
        dist_id, extra = resolve_family(self.selected_family, k)
        mus_r, sigmas_r, extra_r, _ = remaining_work_stats(
            dist_id, mus, sigmas, np.asarray(extra), done)
        prev = (self._cached_w
                if self._cached_w is not None and len(self._cached_w) == k
                else None)
        if prev is not None:
            warm = np.maximum(np.asarray(prev, np.float64) - done, 0.0)
            warm *= active
        else:
            warm = active.astype(np.float64)
        s = warm.sum()
        warm = warm / s if s > 0 else active / active.sum()
        if (active.all() and prev is not None and self.adaptive_refresh
                and self._last_rel_fragility is not None
                and self._last_rel_fragility <= self.refresh_target_rel):
            return warm
        idx = np.flatnonzero(active)
        dec = optimize_weights(
            mus_r[idx], sigmas_r[idx], lam=self.lam, steps=self.pgd_steps,
            restarts=0, num_t=self.num_t,
            family=(dist_id, np.asarray(extra_r, np.float32)[:, idx]),
            warm_start=warm[idx], device=self.device)
        out = np.zeros(k)
        out[idx] = dec.weights
        return out

    def predicted_moments(self, weights: Optional[np.ndarray] = None,
                          family=None):
        mus, sigmas = self.estimates()
        w = self.weights() if weights is None else weights
        fam = self.selected_family if family is None else family
        return predict_moments(w, mus, sigmas, family=fam,
                               device=self.device)

    # ------------------------------------------------------------ elasticity
    def add_channel(self, prior_mean: Optional[float] = None):
        """Enlist a new channel (elastic scale-up) with a weak prior."""
        mus, _ = self.estimates()
        m0 = prior_mean if prior_mean is not None else float(np.mean(mus))
        old = self._nig
        new = nig_init(self.num_channels + 1, m0=m0, device=self.device)
        self._nig = NIGState(*(torch.cat([o, n[-1:]])
                               for o, n in zip(old, new)))
        self.num_channels += 1
        self._reset_after_resize()

    def remove_channel(self, idx: int):
        """Drop a failed or retired channel (elastic scale-down)."""
        keep = torch.tensor([i for i in range(self.num_channels) if i != idx],
                            dtype=torch.long, device=self.device)
        self._nig = NIGState(*(o[keep] for o in self._nig))
        self.num_channels -= 1
        self._reset_after_resize()

    def _reset_after_resize(self):
        """A fleet-shape change drops the solve, the history and any
        auto-mode fit sized to the old K."""
        self._cached_w = None
        self._hist_rates, self._hist_work, self._hist_mask = [], [], []
        self._challenger, self._challenger_count = None, 0
        self._last_scores = None
        if self._is_auto and self._selected_family.dist_id in ("drift",
                                                               "empirical"):
            self._selected_family = get_family("normal")

    # ------------------------------------------------------------ persistence
    def state_dict(self) -> dict:
        """The whole estimation state, under the JAX balancer's keys.
        ``"impl"`` is ``"xla"``, the role of the port's plain path there, so
        the JAX balancer restores the state and solves; the port's own
        restore ignores it (the device is the caller's)."""
        return {
            "num_channels": self.num_channels, "lam": self.lam,
            "policy": self.policy, "impl": "xla",
            "num_t": self.num_t,
            "min_weight": self.min_weight,
            "refresh_every": self.refresh_every,
            "pgd_steps": self.pgd_steps,
            "risk_lam": self.risk_lam,
            "adaptive_refresh": self.adaptive_refresh,
            "refresh_target_rel": self.refresh_target_rel,
            "history_window": self.history_window,
            "auto_every": self.auto_every,
            "auto_min_obs": self.auto_min_obs,
            "hysteresis": self.hysteresis,
            "explore": self.explore,
            "family": ("auto" if self._is_auto
                       else get_family(self.family).state_dict()),
            "selected_family": self._selected_family.state_dict(),
            "challenger": self._challenger,
            "challenger_count": self._challenger_count,
            "obs_count": self._obs_count,
            "effective_refresh": self._effective_refresh,
            "last_fragility": self._last_fragility,
            "last_rel_fragility": self._last_rel_fragility,
            "cached_w": (None if self._cached_w is None
                         else np.asarray(self._cached_w).tolist()),
            "cached_family_key": self._cached_family_key,
            "history": {
                "rates": np.asarray(self._hist_rates, np.float64).tolist(),
                "work": np.asarray(self._hist_work, np.float64).tolist(),
                "mask": np.asarray(self._hist_mask, np.float64).tolist(),
            },
            "nig": {k: v.cpu().tolist() for k, v in self._nig._asdict().items()},
        }

    @classmethod
    def from_state_dict(cls, d: dict,
                        device="cuda") -> "UncertaintyAwareBalancer":
        """Restore on ``device``; the saved ``"impl"`` does not choose it."""
        fam_spec = d.get("family", "normal")
        fam = "auto" if fam_spec == "auto" else get_family(fam_spec)
        b = cls(num_channels=d["num_channels"], lam=d["lam"],
                policy=d["policy"], device=device,
                num_t=d.get("num_t", 1024),
                min_weight=d.get("min_weight", 0.0),
                refresh_every=d.get("refresh_every", 1),
                pgd_steps=d.get("pgd_steps", 150),
                risk_lam=d.get("risk_lam", 0.0),
                adaptive_refresh=d.get("adaptive_refresh", False),
                refresh_target_rel=d.get("refresh_target_rel", 0.02),
                history_window=d.get("history_window", 128),
                auto_every=d.get("auto_every", 8),
                auto_min_obs=d.get("auto_min_obs", 12),
                hysteresis=d.get("hysteresis", 3),
                explore=d.get("explore", 0.15),
                family=fam)
        b._nig = NIGState(**{k: torch.tensor(np.asarray(v, np.float32),
                                             device=b.device)
                             for k, v in d["nig"].items()})
        if "selected_family" in d:
            b._selected_family = get_family(d["selected_family"])
        b._challenger = d.get("challenger")
        b._challenger_count = d.get("challenger_count", 0)
        b._obs_count = d.get("obs_count", 0)
        b._effective_refresh = d.get("effective_refresh",
                                     max(b.refresh_every, 1))
        b._last_fragility = d.get("last_fragility")
        b._last_rel_fragility = d.get("last_rel_fragility")
        if d.get("cached_w") is not None:
            b._cached_w = np.asarray(d["cached_w"], np.float64)
            key = d.get("cached_family_key")
            b._cached_family_key = (cls._family_key(b.selected_family)
                                    if key is True else key)
        hist = d.get("history")
        if hist and len(hist.get("rates", [])):
            b._hist_rates = [np.asarray(r, np.float32)
                             for r in hist["rates"]]
            b._hist_work = [np.asarray(r, np.float32) for r in hist["work"]]
            b._hist_mask = [np.asarray(r, np.float32) for r in hist["mask"]]
        return b


@dataclass
class WorkflowBalancer:
    """Joint DAG partitioner: the paper's loop lifted to a stage graph.

    One estimation head per stage (a policy-less
    :class:`UncertaintyAwareBalancer` used for its NIG posteriors and, with
    ``family="auto"``, its online family selection); every refresh re-solves
    all stage splits jointly with ``workflow.solve.solve_dag`` on the
    posterior point estimates, warm from the previous solve, one stacked
    kernel call per family group per evaluation. ``dag`` gives the
    structure and fleet sizes; its statistics are only priors.

    The cache is invalidated by a family switch on any stage, a failure or
    recovery, or the refresh cadence (``adaptive_refresh`` sizes it by the
    composed makespan fragility). With ``incremental`` on and the last
    solve's relative fragility at or under ``refresh_target_rel``, a refresh
    re-solves only the stages whose posterior estimates drifted more than
    ``dirty_tol`` (relative) from the statistics their last solve ran on, or
    whose family changed; an empty dirty set keeps the cached split without
    a solver call. Snapshots update only for the stages a solve moved. The
    ladder's knobs (``presolve_num_t``, ``prune_margin``,
    ``plateau_tol``/``plateau_patience``) ride every solve.

    ``state_dict`` has the JAX package's keys and writes ``"impl": "xla"``
    (and ``block_rows`` as ``"block_f"``), so the JAX package's
    ``WorkflowBalancer.from_state_dict`` restores it and solves.
    """

    dag: object                      # workflow.StageDAG
    lam_var: float = 0.0             # makespan variance weight
    family: object = "auto"          # per-stage family mode
    refresh_every: int = 1
    pgd_steps: int = 60
    restarts: int = 1
    device: object = "cuda"
    num_t: int = 512
    block_rows: Optional[int] = None   # plain-path rows per chunk (CPU)
    risk_lam: float = 0.0
    adaptive_refresh: bool = False
    refresh_target_rel: float = 0.02
    prior_mean: float = 1.0
    min_weight: float = 0.0
    presolve_num_t: Optional[int] = None
    prune_margin: Optional[float] = 5e-3
    plateau_tol: float = 1e-6
    plateau_patience: Optional[int] = 8
    incremental: bool = True
    dirty_tol: float = 0.05          # relative drift that dirties a stage
    _est: dict = field(default=None, repr=False)
    _cached: object = field(default=None, repr=False)
    _cached_key: object = field(default=None, repr=False)
    _obs_count: int = 0
    _effective_refresh: Optional[int] = field(default=None, repr=False)
    _last_decision: object = field(default=None, repr=False)
    _last_rel_frag: Optional[float] = field(default=None, repr=False)
    _failed: dict = field(default_factory=dict, repr=False)
    _solve_stats: dict = field(default_factory=dict, repr=False)
    _solve_fams: dict = field(default_factory=dict, repr=False)

    def __post_init__(self):
        self.device = resolve_device(self.device)
        if self._est is None:
            # estimation heads only: their own solve path is never used,
            # so the exploration probe is off
            self._est = {
                s.name: UncertaintyAwareBalancer(
                    num_channels=s.k, family=self.family,
                    prior_mean=self.prior_mean, explore=0.0,
                    device=self.device)
                for s in self.dag.stages}
        if self._effective_refresh is None:
            self._effective_refresh = max(self.refresh_every, 1)

    @property
    def effective_refresh(self) -> int:
        return int(self._effective_refresh or max(self.refresh_every, 1))

    @property
    def last_decision(self):
        """The DAGDecision of the most recent solve (None before)."""
        return self._last_decision

    def selected_families(self) -> dict:
        """dist_id per stage the next joint solve runs under."""
        return {n: e.selected_family.dist_id for n, e in self._est.items()}

    # ------------------------------------------------------------ feedback
    def observe(self, durations: dict, work: dict):
        """Per-stage feedback {stage: per-channel durations / work shares};
        absent stages are skipped."""
        for name, durs in durations.items():
            self._est[name].observe(durs, work[name])
        self._obs_count += 1

    # ------------------------------------------------------------- failures
    def handle_failure(self, stage: str, idx: int):
        """Channel ``idx`` of ``stage`` is dead: it gets zero share until
        :meth:`handle_recovery`, and the cached solve is dropped."""
        if not any(s.name == stage for s in self.dag.stages):
            raise KeyError(f"unknown stage {stage!r}")
        self._failed.setdefault(stage, set()).add(int(idx))
        self._cached = None
        obs_events.churn("fail", idx, "balancer", detail=stage)

    def handle_recovery(self, stage: str, idx: int):
        """Re-admit a recovered channel (a no-op if it never failed)."""
        bad = self._failed.get(stage)
        if bad is not None:
            bad.discard(int(idx))
            if not bad:
                self._failed.pop(stage)
        self._cached = None
        obs_events.churn("recover", idx, "balancer", detail=stage)

    def failed_channels(self) -> dict:
        """{stage: sorted failed channel indices}."""
        return {n: sorted(v) for n, v in self._failed.items() if v}

    def _mask_failed(self, name: str, w: np.ndarray) -> np.ndarray:
        """Zero dead channels and renormalize the survivors' shares."""
        bad = self._failed.get(name)
        if not bad:
            return w
        w = w.copy()
        w[sorted(bad)] = 0.0
        s = w.sum()
        if s > 0:
            return w / s
        alive = np.ones(len(w))
        alive[sorted(bad)] = 0.0
        return alive / max(alive.sum(), 1.0)

    # ------------------------------------------------------------ decisions
    def _live_dag(self):
        mus, sigmas, fams = {}, {}, {}
        for s in self.dag.stages:
            est = self._est[s.name]
            mus[s.name], sigmas[s.name] = est.estimates()
            fams[s.name] = est.selected_family
        return self.dag.with_stats(mus, sigmas, fams)

    def _solve_key(self) -> str:
        fams = [UncertaintyAwareBalancer._family_key(
            self._est[s.name].selected_family) for s in self.dag.stages]
        key = "|".join(fams)
        if self._failed:
            bad = ";".join(f"{n}:{sorted(v)}"
                           for n, v in sorted(self._failed.items()) if v)
            key += f"|failed[{bad}]"
        return key

    def _dirty_stages(self, live):
        """None for a full solve, else the (possibly empty) set of stages
        whose estimation state moved past ``dirty_tol``; incremental solves
        are trusted only after a firm solve (relative fragility at or under
        ``refresh_target_rel``)."""
        if not self.incremental or self._cached is None \
                or not self._solve_stats:
            return None
        rel = self._last_rel_frag
        if rel is None or rel > self.refresh_target_rel:
            obs_events.fragility_gate(False, rel, self.refresh_target_rel)
            return None
        obs_events.fragility_gate(True, rel, self.refresh_target_rel)
        dirty = set()
        for s in live.stages:
            snap = self._solve_stats.get(s.name)
            fkey = UncertaintyAwareBalancer._family_key(
                self._est[s.name].selected_family)
            if snap is None or self._solve_fams.get(s.name) != fkey:
                dirty.add(s.name)
                obs_events.dirty("workflow", s.name, "family")
                continue
            mu0, sg0 = snap
            mu = np.asarray(s.mus, np.float64)
            sg = np.asarray(s.sigmas, np.float64)
            drift = max(
                float(np.max(np.abs(mu - mu0)
                             / np.maximum(np.abs(mu0), 1e-9))),
                float(np.max(np.abs(sg - sg0)
                             / np.maximum(np.abs(sg0), 1e-9))))
            if drift > self.dirty_tol:
                dirty.add(s.name)
                obs_events.dirty("workflow", s.name, "drift", drift)
        if len(dirty) == len(live.stages):
            return None      # everything moved: a plain full solve
        return dirty

    def _snapshot(self, live, dirty):
        """Record the statistics this solve ran on, for the stages it
        moved."""
        for s in live.stages:
            if dirty is not None and s.name not in dirty:
                continue
            self._solve_stats[s.name] = (
                np.asarray(s.mus, np.float64).copy(),
                np.asarray(s.sigmas, np.float64).copy())
            self._solve_fams[s.name] = UncertaintyAwareBalancer._family_key(
                self._est[s.name].selected_family)

    def _solve(self, live, **kw):
        from ..workflow.solve import solve_dag  # lazy: layering

        return solve_dag(live, lam_var=self.lam_var, steps=self.pgd_steps,
                         num_t=self.num_t, device=self.device,
                         block_rows=self.block_rows,
                         presolve_num_t=self.presolve_num_t,
                         prune_margin=self.prune_margin,
                         plateau_tol=self.plateau_tol,
                         plateau_patience=self.plateau_patience, **kw)

    def weights(self) -> dict:
        """Current per-stage splits; re-solves jointly when stale, and only
        over the dirty stages when the fragility gate allows it."""
        key = self._solve_key()
        cadence = (self.effective_refresh if self.adaptive_refresh
                   else max(self.refresh_every, 1))
        stale = (self._cached is None or key != self._cached_key
                 or self._obs_count % cadence == 0)
        if stale:
            live = self._live_dag()
            dirty = self._dirty_stages(live)
            if dirty is not None and not dirty:
                # nothing drifted after a firm solve: the cached split
                # stands, no solver call
                self._cached_key = key
            else:
                posteriors = None
                if self.risk_lam > 0 or self.adaptive_refresh:
                    posteriors = {s.name: self._est[s.name]._nig
                                  for s in self.dag.stages}
                with obs.span(obs_names.SPAN_SCHED_REFRESH, kind="workflow",
                              stages=len(live.stages),
                              dirty=(-1 if dirty is None else len(dirty)),
                              warm=self._cached is not None):
                    dec = self._solve(live, restarts=self.restarts,
                                      warm_start=self._cached,
                                      risk_lam=self.risk_lam,
                                      posteriors=posteriors, dirty=dirty)
                self._last_decision = dec
                self._last_rel_frag = dec.relative_fragility
                if (self.adaptive_refresh
                        and dec.relative_fragility is not None):
                    self._effective_refresh = _cadence_from_fragility(
                        dec.relative_fragility, self.refresh_every,
                        self.refresh_target_rel)
                self._cached = {n: np.asarray(w, np.float64)
                                for n, w in dec.weights.items()}
                self._cached_key = key
                self._snapshot(live, dirty)
        out = {}
        for n, w in self._cached.items():
            w = self._mask_failed(n, w.copy())
            if self.min_weight > 0:
                # floor only live channels: a dead channel's zero share is
                # a constraint
                bad = self._failed.get(n)
                live_ch = np.ones(len(w), bool)
                if bad:
                    live_ch[sorted(bad)] = False
                w = np.where(live_ch, np.maximum(w, self.min_weight), 0.0)
                w = w / w.sum()
            out[n] = w
        return out

    def assign(self, total_units) -> dict:
        """Integer work per stage; ``total_units`` an int (the same batch
        for every stage) or {stage: int}."""
        ws = self.weights()
        if not isinstance(total_units, dict):
            total_units = {n: int(total_units) for n in ws}
        return {n: integerize(w, total_units[n]) for n, w in ws.items()}

    def predicted_moments(self):
        """Composed (makespan mu, var) at the current splits."""
        from ..workflow.solve import evaluate_dag  # lazy: layering

        dec = evaluate_dag(self._live_dag(), self.weights(),
                           num_t=max(self.num_t, 2048), device=self.device,
                           block_rows=self.block_rows)
        return dec.makespan_mu, dec.makespan_var

    def resolve_inflight(self, done: dict) -> dict:
        """Sunk-work joint re-solve of a partly executed pipeline: ``done``
        maps stage to per-channel completed fractions. Returns {stage:
        shares of its remaining work}, warm from the cached solve, dead
        channels at zero; the cache is untouched. When the fragility gate
        admits it, only the stages with sunk work or drift re-solve."""
        warm = (None if self._cached is None
                else {n: self._mask_failed(n, w.copy())
                      for n, w in self._cached.items()})
        live = self._live_dag()
        dirty = self._dirty_stages(live)
        if dirty is not None:
            dirty = dirty | set(done)
            if len(dirty) >= len(live.stages):
                dirty = None
        dec = self._solve(live, restarts=0, warm_start=warm, done=done,
                          dirty=dirty)
        return {n: self._mask_failed(n, np.asarray(w, np.float64))
                for n, w in dec.weights.items()}

    # ------------------------------------------------------------ persistence
    def state_dict(self) -> dict:
        """Everything but the DAG (the caller passes it back to
        :meth:`from_state_dict`), under the JAX package's keys."""
        return {
            "kind": "workflow",
            "lam_var": self.lam_var,
            "family": ("auto" if (isinstance(self.family, str)
                                  and self.family == "auto")
                       else get_family(self.family).state_dict()),
            "refresh_every": self.refresh_every,
            "pgd_steps": self.pgd_steps,
            "restarts": self.restarts,
            "impl": "xla", "num_t": self.num_t,
            "block_f": self.block_rows,
            "risk_lam": self.risk_lam,
            "adaptive_refresh": self.adaptive_refresh,
            "refresh_target_rel": self.refresh_target_rel,
            "prior_mean": self.prior_mean,
            "min_weight": self.min_weight,
            "presolve_num_t": self.presolve_num_t,
            "prune_margin": self.prune_margin,
            "plateau_tol": self.plateau_tol,
            "plateau_patience": self.plateau_patience,
            "incremental": self.incremental,
            "dirty_tol": self.dirty_tol,
            "obs_count": self._obs_count,
            "effective_refresh": self._effective_refresh,
            "last_rel_fragility": self._last_rel_frag,
            "cached": (None if self._cached is None
                       else {n: np.asarray(w).tolist()
                             for n, w in self._cached.items()}),
            "cached_key": self._cached_key,
            "failed": {n: sorted(v) for n, v in self._failed.items() if v},
            "solve_stats": {n: [m.tolist(), sg.tolist()]
                            for n, (m, sg) in self._solve_stats.items()},
            "solve_fams": dict(self._solve_fams),
            "est": {n: e.state_dict() for n, e in self._est.items()},
        }

    @classmethod
    def from_state_dict(cls, d: dict, dag,
                        device="cuda") -> "WorkflowBalancer":
        """Restore against ``dag`` on ``device``; the saved ``"impl"`` does
        not choose it."""
        fam_spec = d.get("family", "auto")
        fam = "auto" if fam_spec == "auto" else get_family(fam_spec)
        b = cls(dag=dag, lam_var=d.get("lam_var", 0.0), family=fam,
                refresh_every=d.get("refresh_every", 1),
                pgd_steps=d.get("pgd_steps", 60),
                restarts=d.get("restarts", 1), device=device,
                num_t=d.get("num_t", 512),
                block_rows=d.get("block_f"),
                risk_lam=d.get("risk_lam", 0.0),
                adaptive_refresh=d.get("adaptive_refresh", False),
                refresh_target_rel=d.get("refresh_target_rel", 0.02),
                prior_mean=d.get("prior_mean", 1.0),
                min_weight=d.get("min_weight", 0.0),
                presolve_num_t=d.get("presolve_num_t"),
                prune_margin=d.get("prune_margin", 5e-3),
                plateau_tol=d.get("plateau_tol", 1e-6),
                plateau_patience=d.get("plateau_patience", 8),
                incremental=d.get("incremental", True),
                dirty_tol=d.get("dirty_tol", 0.05))
        for name, sd in d.get("est", {}).items():
            if name not in b._est:
                raise ValueError(
                    f"state_dict stage {name!r} not in the supplied DAG "
                    f"(stages: {[s.name for s in dag.stages]})")
            b._est[name] = UncertaintyAwareBalancer.from_state_dict(
                sd, device=b.device)
        b._obs_count = d.get("obs_count", 0)
        b._effective_refresh = d.get("effective_refresh",
                                     max(b.refresh_every, 1))
        if d.get("cached") is not None:
            b._cached = {n: np.asarray(w, np.float64)
                         for n, w in d["cached"].items()}
            b._cached_key = d.get("cached_key")
        b._failed = {n: set(int(i) for i in v)
                     for n, v in d.get("failed", {}).items() if v}
        b._last_rel_frag = d.get("last_rel_fragility")
        b._solve_stats = {n: (np.asarray(m, np.float64),
                              np.asarray(sg, np.float64))
                          for n, (m, sg) in d.get("solve_stats",
                                                  {}).items()}
        b._solve_fams = dict(d.get("solve_fams", {}))
        return b


class InstanceHeads:
    """Per-instance estimation heads for the continuous-batching engine.

    Two instances of one template admitted at different times have seen
    different service, so each prices its rows of the shared stacked
    launch from its own posterior. The bank keeps one PROTOTYPE head per
    ``"template/stage"`` key (the fleet-wide posterior, learning from all
    traffic) and forks it at admission into a private per-instance copy (a
    ``state_dict`` round trip, an exact snapshot). Observations feed both
    the instance's head and the prototype.

    Heads are policy-less :class:`UncertaintyAwareBalancer` instances
    (``explore=0``) read only for their posteriors and family: they never
    solve, the engine's stacked launch does. So they live on the host: a
    fork is made on its prototype's device (the engine builds its
    prototypes on the CPU) and :meth:`from_state_dict` restores them on the
    CPU. At hundreds of live instances a tick observes and reads a thousand
    heads or more; on the card each would be several launches and a
    device synchronization. This places host-side state; it is not a
    fallback, the engine's launch still runs on its device.
    """

    def __init__(self, prototypes: dict):
        self.prototypes = dict(prototypes)
        self._bank: dict = {}

    # ------------------------------------------------------------ lifecycle
    def admit(self, iid: int, keys) -> None:
        """Fork the prototype of every ``key`` for instance ``iid``."""
        iid = int(iid)
        if iid in self._bank:
            raise ValueError(f"instance {iid} already admitted")
        bank = {}
        for key in keys:
            proto = self.prototypes[key]
            bank[key] = UncertaintyAwareBalancer.from_state_dict(
                proto.state_dict(), device=proto.device)
        self._bank[iid] = bank

    def retire(self, iid: int) -> None:
        self._bank.pop(int(iid), None)

    @property
    def live(self):
        return tuple(sorted(self._bank))

    # ------------------------------------------------------------ accessors
    def observe(self, iid: int, key: str, durations, work) -> None:
        """One stage execution's feedback: instance head AND prototype."""
        self._bank[int(iid)][key].observe(durations, work)
        self.prototypes[key].observe(durations, work)

    def estimates(self, iid: int, key: str):
        return self._bank[int(iid)][key].estimates()

    def family(self, iid: int, key: str):
        return self._bank[int(iid)][key].selected_family

    # ------------------------------------------------------------ state
    def state_dict(self) -> dict:
        """The JAX package's keys: every prototype's and every live head's
        balancer state."""
        return {
            "prototypes": {k: p.state_dict()
                           for k, p in self.prototypes.items()},
            "bank": {str(iid): {k: h.state_dict() for k, h in heads.items()}
                     for iid, heads in self._bank.items()},
        }

    @classmethod
    def from_state_dict(cls, d: dict) -> "InstanceHeads":
        """Restore every head on the CPU."""
        def head(sd):
            return UncertaintyAwareBalancer.from_state_dict(sd, device="cpu")

        obj = cls({k: head(sd) for k, sd in d["prototypes"].items()})
        obj._bank = {int(iid): {k: head(sd) for k, sd in heads.items()}
                     for iid, heads in d.get("bank", {}).items()}
        return obj
