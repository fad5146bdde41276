"""Runtime sanitizer: NaN/Inf and domain-invariant checks, off by default.

The JAX package's ``analysis/sanitize.py``, as eager torch checks. Set
``REPRO_SANITIZE=1`` (the same variable: one switch turns on both
packages' checks) and the frontier entry points grow teeth:

* **Boundary checks** on the inputs of a call: ``ops.frontier_moments``
  and ``frontier_moments_with_grads`` require weights, statistics and
  family extras to be finite, weights nonnegative with row mass <= 1 and
  sigmas nonnegative, and for the defective family probabilities in
  [0, 1] with finite retry-conditioned moments; the quadrature and Clark
  oracles in ``core.maxstat`` check their fold inputs and that the
  integration grid increases. Every condition of one call is reduced on
  the tensors' device into one small vector, read on the host ONCE per
  call (one device synchronization on the card), and a violation raises
  :class:`SanitizeError` at the call that brought it in, with the
  reference's message.
* **In-loop checks** (:class:`LoopChecks`) take the place of JAX's
  ``checkify``, which has no torch twin: the PGD loops
  (``core.partitioner._pgd_multi``, ``workflow.solve._pgd_phase``) keep,
  per check, a device int tensor holding the first step at which it failed
  (``torch.where(bad & (first < 0), step, first)``), and read them once
  after the loop. So, as under ``checkify``, the loop runs to its end and
  then its first failure is raised, naming the check and the step; and
  the loop's own steps add no host read. A solve checks its inputs once
  before the loop (the per-step entry-point calls skip it), so a
  sanitized solve adds two host reads in all, none per step.

With the sanitizer off, no check runs a tensor operation. The
``sanitizer`` tier of the repository's ``scripts/ci.sh --full`` runs the
tests under ``REPRO_SANITIZE=1``, the port's included.
"""
from __future__ import annotations

import os
from typing import List

import torch

__all__ = ["ENV_VAR", "SanitizeError", "enabled", "check_frontier_inputs",
           "check_stacked_inputs", "check_fold_inputs",
           "assert_monotone_grid", "LoopChecks"]

ENV_VAR = "REPRO_SANITIZE"

# slack for float32 round-off: PGD projections land within ulps of the
# simplex, and finite-difference probes in tests nudge one weight by up to
# 1e-3, so the tolerance sits clearly above that nudge
_MASS_ATOL = 5e-3
_NEG_ATOL = 1e-5
# the defective family's upper clamp of p (core.distributions)
_Q_FLOOR = 1e-6


class SanitizeError(ValueError):
    """A sanitizer invariant failed."""


def enabled() -> bool:
    """True when the sanitizer is switched on for this process."""
    return os.environ.get(ENV_VAR, "") == "1"


class _Stats:
    """Per-array summaries gathered on the device and read in one copy:
    ``add`` queues a float64 scalar tensor and returns its slot; ``read``
    moves them all to the host at once."""

    def __init__(self):
        self._parts: List[torch.Tensor] = []

    def add(self, x: torch.Tensor) -> int:
        self._parts.append(x.to(torch.float64).reshape(()))
        return len(self._parts) - 1

    def read(self) -> List[float]:
        if not self._parts:
            return []
        return torch.stack(self._parts).tolist()


def _finite(st: _Stats, name: str, a: torch.Tensor):
    """Queue the non-finite count of ``a``; returns the check to run on
    the host values."""
    slot = st.add((~torch.isfinite(a)).sum())
    shape = tuple(a.shape)

    def check(v):
        bad = int(v[slot])
        if bad:
            raise SanitizeError(
                f"sanitize: {name} contains {bad} non-finite value(s) "
                f"(shape {shape})")
    return check


def _nonneg(st: _Stats, name: str, a: torch.Tensor, atol: float = _NEG_ATOL):
    if not a.numel():
        return lambda v: None
    slot = st.add(a.min())

    def check(v):
        lo = v[slot]
        if lo < -atol:
            raise SanitizeError(
                f"sanitize: {name} must be nonnegative, min is {lo:.3e}")
    return check


def _prob(st: _Stats, name: str, a: torch.Tensor, atol: float = _NEG_ATOL):
    finite = _finite(st, name, a)
    if not a.numel():
        return finite
    lo, hi = st.add(a.min()), st.add(a.max())

    def check(v):
        finite(v)
        if v[lo] < -atol or v[hi] > 1.0 + atol:
            raise SanitizeError(
                f"sanitize: {name} must lie in [0, 1], range is "
                f"[{v[lo]:.3e}, {v[hi]:.3e}]")
    return check


def _weight_rows(st: _Stats, W: torch.Tensor, atol: float = _MASS_ATOL):
    checks = [_finite(st, "W", W), _nonneg(st, "W", W)]
    if W.numel():
        slot = st.add(W.sum(dim=-1).max())

        def mass(v):
            if v[slot] > 1.0 + atol:
                raise SanitizeError(
                    f"sanitize: split weights leave the simplex — max row "
                    f"mass {v[slot]:.6f} > 1 (off-simplex W scales every "
                    f"downstream moment)")
        checks.append(mass)
    return checks


def _run(st: _Stats, checks) -> None:
    """One host read, then the checks in order: the first failure
    raises."""
    v = st.read()
    for check in checks:
        check(v)


# repro: allow[RPA001] finiteness and positivity are family-agnostic; the
# one dist_id branch (the defective family's probability domain) adds to
# the generic checks of every family
def check_frontier_inputs(W, mus, sigmas, extra=None, dist_id=None) -> None:
    """Boundary checks of a frontier entry point's inputs (tensors on one
    device), in the reference's order: W (finite, nonnegative, row mass),
    mus, sigmas (finite, nonnegative), the family extra (finite; for
    ``defective`` p and lam in [0, 1] and the retry-conditioned moments
    finite). A no-op unless the sanitizer is on."""
    if not enabled():
        return
    st = _Stats()
    checks = _weight_rows(st, W)
    checks += [_finite(st, "mus", mus), _finite(st, "sigmas", sigmas),
               _nonneg(st, "sigmas", sigmas)]
    if extra is not None:
        checks.append(_finite(st, "family extra", extra))
        if dist_id == "defective":
            p, lam = extra[0].double(), extra[1].double()
            checks += [_prob(st, "failure probabilities p", p),
                       _prob(st, "failure pricing lam", lam)]
            # core.distributions.defective_moments_np, on the device
            mu, sg = mus.double(), sigmas.double()
            q = 1.0 - torch.clamp(p, 0.0, 1.0 - _Q_FLOOR)
            ratio = (1.0 - q) / q
            a = mu * (1.0 + lam * ratio)
            b = torch.sqrt(torch.clamp_min(
                sg * sg * (1.0 + lam * lam * ratio)
                + (lam * mu) ** 2 * ratio / q, 0.0))
            checks.append(_finite(st, "defective conditioned moments",
                                  torch.stack([a, b])))
    _run(st, checks)


def check_stacked_inputs(W, stats) -> None:
    """A workflow solve's inputs: the (R, S, K) start stack's simplex rows
    and each family group's ``(mus, sigmas)`` (finite, sigmas
    nonnegative), as the JAX package's ``solve_dag`` checks them. A no-op
    unless the sanitizer is on."""
    if not enabled():
        return
    st = _Stats()
    checks = _weight_rows(st, W)
    for mus, sigmas in stats:
        checks += [_finite(st, "stage mus", mus),
                   _finite(st, "stage sigmas", sigmas),
                   _nonneg(st, "stage sigmas", sigmas)]
    _run(st, checks)


def check_fold_inputs(means, stds) -> None:
    """Boundary checks of the Clark fold and quadrature oracles: means and
    stds finite, stds nonnegative. A no-op unless the sanitizer is on."""
    if not enabled():
        return
    st = _Stats()
    _run(st, [_finite(st, "fold means", means),
              _finite(st, "fold stds", stds),
              _nonneg(st, "fold stds", stds)])


def assert_monotone_grid(name: str, ts) -> None:
    """Integration grid strictly increasing (a non-monotone grid flips the
    sign of the survival quadrature). A no-op unless the sanitizer is
    on."""
    if not enabled() or ts.ndim == 0 or ts.shape[-1] < 2:
        return
    st = _Stats()
    slot = st.add((~(torch.diff(ts, dim=-1) > 0)).sum())
    if st.read()[slot]:
        raise SanitizeError(
            f"sanitize: {name} integration grid is not strictly increasing "
            f"(tmax <= 0 or non-finite reach)")


class LoopChecks:
    """The in-loop checks of one PGD loop (see the module docstring).

    Each check is a slot with its message; ``first`` holds, per slot, the
    step at which it first failed (-1: never), as a device int64 tensor.
    Nothing is read until :meth:`raise_first`."""

    def __init__(self, device):
        self.device = torch.device(device)
        self._msgs: List[str] = []
        self._first: List[torch.Tensor] = []

    def _record(self, msg: str, bad: torch.Tensor, step: int) -> None:
        if msg not in self._msgs:
            self._msgs.append(msg)
            self._first.append(torch.full((), -1, dtype=torch.int64,
                                          device=self.device))
        i = self._msgs.index(msg)
        first = self._first[i]
        self._first[i] = torch.where(bad & (first < 0), step, first)

    def check_finite(self, x: torch.Tensor, name: str, step: int) -> None:
        """``x`` is all finite at ``step``."""
        self._record(f"sanitize: {name} became non-finite inside the solve",
                     ~torch.isfinite(x).all(), step)

    def check_weight_rows(self, W: torch.Tensor, name: str, step: int,
                          atol: float = _MASS_ATOL) -> None:
        """The simplex invariant of the iterate ``W`` at ``step``."""
        self.check_finite(W, name, step)
        self._record(f"sanitize: {name} left the nonnegative orthant",
                     W.min() < -_NEG_ATOL, step)
        self._record(f"sanitize: {name} row mass exceeded the simplex",
                     W.sum(dim=-1).max() > 1.0 + atol, step)

    def raise_first(self) -> None:
        """One host read; raise the earliest failure (the first check
        recorded, within a step) as a :class:`SanitizeError`."""
        if not self._first:
            return
        first = torch.stack(self._first).tolist()
        failed = [(s, i) for i, s in enumerate(first) if s >= 0]
        if failed:
            step, i = min(failed)
            raise SanitizeError(f"{self._msgs[i]} (first at PGD step "
                                f"{step})")

