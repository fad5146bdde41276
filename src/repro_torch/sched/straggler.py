"""Straggler detection and mitigation on top of the balancer.

The paper's mechanism *is* the mitigation: a slowing channel's posterior
mean rises and the frontier moves work away from it. This policy adds the
operational edges of a large fleet:

* z-score detection of acute stragglers against each channel's posterior;
* two mitigation modes:
    - ``"quarantine"``: weight 0 after repeated offenses, with probation
      retries;
    - ``"drift"``: a detected straggler keeps its (discounted) capacity
      under the ``drift`` completion-time family, with a per-channel drift
      rate estimated from its observed slowdown; channels that behave again
      decay back to rho = 0, the plain normal family;
* hard failure (missed heartbeat: elastic removal, indices shift down) and
  soft failure (zero weight until :meth:`recover`), wired both ways to a
  bound :class:`sim.cluster.ClusterSim`.

:meth:`weights` zeroes quarantined and failed channels in the array the
balancer returns. After a fresh solve that array is the balancer's cached
warm start, so the next warm-started solve starts from the zeroed split:
the JAX package's policy does the same.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..core import Drift
from .balancer import UncertaintyAwareBalancer, integerize

__all__ = ["StragglerPolicy"]


@dataclass
class StragglerPolicy:
    balancer: UncertaintyAwareBalancer
    z_threshold: float = 3.0          # acute-straggler z score
    quarantine_after: int = 3         # offenses before weight 0 (quarantine)
    probation_period: int = 20        # steps before a quarantined node retries
    mitigation: str = "quarantine"    # "quarantine" | "drift"
    drift_decay: float = 0.5          # per-clean-step multiplicative rho decay
    max_rho: float = 4.0              # cap on the estimated drift rate
    offenses: Dict[int, int] = field(default_factory=dict)
    quarantined: Dict[int, int] = field(default_factory=dict)  # idx -> step
    drift_rhos: Dict[int, float] = field(default_factory=dict)  # idx -> rho
    failed: set = field(default_factory=set)   # soft-failed (recoverable)
    step: int = 0
    _sim: object = field(default=None, repr=False)

    def __post_init__(self):
        if self.mitigation not in ("quarantine", "drift"):
            raise ValueError(f"mitigation must be 'quarantine' or 'drift', "
                             f"got {self.mitigation!r}")

    def record(self, durations: Sequence[float],
               work: Sequence[float]) -> List[int]:
        """Feed one step's observations; returns the indices flagged as
        acute stragglers."""
        self.step += 1
        self.balancer.observe(durations, work)
        mus, sigmas = self.balancer.estimates()
        d = np.asarray(durations, np.float64)
        w = np.asarray(work, np.float64)
        flagged = []
        for i in range(len(d)):
            if w[i] <= 0:
                continue
            rate = d[i] / w[i]
            z = (rate - mus[i]) / max(sigmas[i], 1e-9)
            if z > self.z_threshold:
                self.offenses[i] = self.offenses.get(i, 0) + 1
                flagged.append(i)
                if self.mitigation == "drift":
                    # the observed mean excess over the posterior as a drift
                    # rate (the drift family's E[T] = w mu (1 + rho w / 2)
                    # at the observed share), EMA over repeat offenses
                    excess = max(rate / max(mus[i], 1e-9) - 1.0, 0.0)
                    rho_obs = min(2.0 * excess / max(w[i], 1e-6), self.max_rho)
                    old = self.drift_rhos.get(i, 0.0)
                    self.drift_rhos[i] = min(0.5 * old + 0.5 * rho_obs,
                                             self.max_rho)
                elif self.offenses[i] >= self.quarantine_after:
                    self.quarantined[i] = self.step
            else:
                self.offenses[i] = max(0, self.offenses.get(i, 0) - 1)
                if i in self.drift_rhos:
                    # behaving again: decay the priced-in drift toward normal
                    rho = self.drift_rhos[i] * self.drift_decay
                    if rho < 1e-3:
                        del self.drift_rhos[i]
                    else:
                        self.drift_rhos[i] = rho
        # probation: quarantined nodes come back for re-evaluation
        for i, since in list(self.quarantined.items()):
            if self.step - since >= self.probation_period:
                del self.quarantined[i]
                self.offenses[i] = 0
        return flagged

    def family(self) -> Optional[Drift]:
        """The Drift family pricing the current stragglers, or None when
        clean (or in quarantine mode)."""
        if self.mitigation != "drift" or not self.drift_rhos:
            return None
        rho = np.zeros(self.balancer.num_channels, np.float32)
        for i, r in self.drift_rhos.items():
            if i < rho.shape[0]:
                rho[i] = r
        return Drift(rho)

    def weights(self) -> np.ndarray:
        """The balancer's split with quarantined and failed channels
        zeroed (in place, see the module docstring), renormalized."""
        fam = self.family()
        w = self.balancer.weights(family=fam) if fam is not None \
            else self.balancer.weights()
        for i in self.quarantined:
            w[i] = 0.0
        for i in self.failed:
            w[i] = 0.0
        s = w.sum()
        return w / s if s > 0 else np.full_like(w, 1.0 / len(w))

    def assign(self, total_units: int) -> np.ndarray:
        return integerize(self.weights(), total_units)

    def fail(self, idx: int, remove: bool = True):
        """Channel failure. ``remove=True`` (missed heartbeat) is the
        elastic path: the channel and its posterior are deleted and every
        index above shifts down. ``remove=False`` is a soft failure: the
        channel keeps its posterior and index but gets zero weight until
        :meth:`recover`."""
        if not remove:
            self.failed.add(int(idx))
            if self._sim is not None:
                self._sim.inject_failure(idx)
            return
        self.balancer.remove_channel(idx)
        self.offenses = {i - (i > idx): c for i, c in self.offenses.items()
                         if i != idx}
        self.quarantined = {i - (i > idx): s
                            for i, s in self.quarantined.items() if i != idx}
        self.drift_rhos = {i - (i > idx): r for i, r in self.drift_rhos.items()
                           if i != idx}
        self.failed = {i - (i > idx) for i in self.failed if i != idx}

    def recover(self, idx: int):
        """Re-admit a soft-failed channel (posterior intact)."""
        self.failed.discard(int(idx))
        if self._sim is not None:
            self._sim.recover(idx)

    def bind_sim(self, sim):
        """Two-way wiring to a ``ClusterSim``: soft fail and recover reach
        the sim's failure flags, and :meth:`sync_with_sim` pulls sim-side
        churn back into the policy."""
        self._sim = sim

    def sync_with_sim(self) -> set:
        """Adopt the bound sim's failure flags as the soft-fail set (once a
        tick, after ``run_step``); returns the new set."""
        if self._sim is None:
            raise RuntimeError("no sim bound; call bind_sim(sim) first")
        self.failed = {i for i, c in enumerate(self._sim.channels)
                       if getattr(c, "failed", False)}
        return set(self.failed)

    def join(self, prior_mean=None):
        """Elastic scale-up."""
        self.balancer.add_channel(prior_mean)
