"""Typed audit-event emitters: the *why* log.

The JAX package's ``obs/events.py``, for the port. Spans say how long
things took; these say why they happened: which stage went dirty and what
drift pushed it over, whether the fragility gate let a refresh through,
which family BIC selection switched to and at what scores, which row's SLO
headroom escalated its risk lam, what churn hit the fleet, and every
checkpoint save and restore. Each helper owns the attribute schema of its
event type, returns at once when tracing is off, and coerces values to
JSON scalars. The reference's ``kernel_compile`` (a jit trace of a
frontier entry point) has no counterpart: the port runs eagerly.

Every attribute is a value the host already holds (a Python or numpy
number, a string). A torch tensor is refused with a ``TypeError`` when
tracing is on: reading a CUDA tensor here would be a device
synchronization hidden in the trace, which the zero-perturbation contract
of :mod:`repro_torch.obs.trace` forbids, and a test finds the emit site
that tried.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from . import names, trace

__all__ = [
    "dirty", "fragility_gate", "family_switch", "slo_lam", "churn",
    "ckpt_save", "ckpt_restore",
]


def _host(x):
    """``x`` unchanged, unless it is a tensor (refused: see the module
    docstring)."""
    if isinstance(x, torch.Tensor):
        raise TypeError(
            f"trace attribute is a torch tensor on {x.device}: pass a host "
            f"number (reading a CUDA tensor would synchronize the device)")
    return x


def _f(x) -> Optional[float]:
    return None if x is None else float(_host(x))


def _i(x) -> int:
    return int(_host(x))


def dirty(scope: str, key, cause: str, drift=None) -> None:
    """A row or stage joined the dirty set: who, and which trigger fired."""
    if not trace.enabled():
        return
    trace.event(names.EV_DIRTY, scope=scope, key=str(_host(key)),
                cause=cause, drift=_f(drift))


def fragility_gate(passed: bool, rel_frag, target) -> None:
    """The balancer's fragility gate verdict on a refresh tick."""
    if not trace.enabled():
        return
    trace.event(names.EV_FRAGILITY, passed=bool(_host(passed)),
                rel_frag=_f(rel_frag), target=_f(target))


def family_switch(old: str, new: str, scores: Dict[str, Any],
                  streak: int = 0) -> None:
    """BIC model selection changed the completion-time family."""
    if not trace.enabled():
        return
    trace.event(names.EV_FAMILY_SWITCH, old=str(old), new=str(new),
                scores={str(k): _f(v) for k, v in scores.items()},
                streak=_i(streak))


def slo_lam(instance, lam, base, headroom=None) -> None:
    """A row's risk lam was escalated above base by SLO deadline pressure."""
    if not trace.enabled():
        return
    trace.event(names.EV_SLO_LAM, instance=str(_host(instance)),
                lam=_f(lam), base=_f(base), headroom=_f(headroom))


def churn(kind: str, channel, source: str, detail=None) -> None:
    """Failure, recovery, throttle or load churn observed at ``source``."""
    if not trace.enabled():
        return
    trace.event(names.EV_CHURN, kind=str(kind), channel=_i(channel),
                source=source,
                detail=None if detail is None else str(_host(detail)))


def ckpt_save(step, kind: str, path: str) -> None:
    if not trace.enabled():
        return
    trace.event(names.EV_CKPT_SAVE, step=_i(step), kind=str(kind),
                path=str(path))


def ckpt_restore(step, kind: str, path: str) -> None:
    """First record of a restored replica's fresh (never restored) trace."""
    if not trace.enabled():
        return
    trace.event(names.EV_CKPT_RESTORE, step=_i(step), kind=str(kind),
                path=str(path))

