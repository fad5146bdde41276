"""Low-overhead tracer: spans and audit events into a thread-safe ring buffer.

The JAX package's ``obs/trace.py``, for the port. Off by default;
``REPRO_TRACE=1`` (read once at import, overridable with
:func:`set_enabled`) switches recording on. The design contract is
**zero perturbation** of the system under observation:

* timestamps come from ``time.perf_counter_ns`` (monotonic, never the wall
  clock, never a random draw);
* nothing here touches a simulation or engine random stream, and trace
  state is absent from every ``state_dict``: the kill/restore bitwise
  tick-parity contract holds with tracing on, and a restored replica
  starts a fresh trace whose first record is the restore audit event;
* nothing here touches the device: a span measures the host clock around
  launches that run asynchronously on the card (as JAX's asynchronous
  dispatch does in the reference), and never synchronizes. An attribute
  must be a value the host already holds; :mod:`repro_torch.obs.events`
  refuses a CUDA tensor, whose read would be a hidden synchronization.

The port runs eagerly, so every frontier call is a concrete launch: the
reference's trace-time test (``all_concrete``) and its compile audit
event have nothing to do here.

The off path is a single attribute load and truth test: :func:`span`
returns a shared no-op context manager and :func:`event` returns at once.
:func:`timed_span` is the one deliberate exception: it always measures
(its ``dur_us`` replaces a hand timer the caller paid for anyway) and
records only when tracing is on; that is what makes spans the single
timing source of profiles such as ``solve_dag``'s ``phase_us``.

Records are plain dicts (validated by
:func:`repro_torch.obs.export.validate_records`); the ring buffer drops
the oldest records past ``capacity`` and counts the drops.
"""
from __future__ import annotations

import functools
import os
import threading
import time
from collections import deque
from contextlib import contextmanager
from typing import Any, Dict, Iterator, List, Optional

from . import names

__all__ = [
    "ENV_VAR", "Tracer", "TRACER", "enabled", "set_enabled", "span",
    "timed_span", "event", "traced", "set_tick", "current_tick", "mark",
    "records", "dropped", "clear", "capture",
]

ENV_VAR = "REPRO_TRACE"
_DEFAULT_CAPACITY = 1 << 16


def _now_us() -> float:
    return time.perf_counter_ns() / 1000.0


class _NoopSpan:
    """Shared do-nothing context manager for the tracing-off fast path."""

    __slots__ = ()
    dur_us = 0.0

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False


_NOOP = _NoopSpan()


class _Span:
    """Context manager measuring one span; records on exit when asked."""

    __slots__ = ("_tracer", "name", "attrs", "_record", "_t0_ns", "dur_us")

    def __init__(self, tracer: "Tracer", name: str, attrs: Dict[str, Any],
                 record: bool):
        self._tracer = tracer
        self.name = name
        self.attrs = attrs
        self._record = record
        self._t0_ns = 0
        self.dur_us = 0.0

    def __enter__(self) -> "_Span":
        self._t0_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        t1 = time.perf_counter_ns()
        self.dur_us = (t1 - self._t0_ns) / 1000.0
        if self._record:
            self._tracer._emit({
                "type": "span",
                "name": self.name,
                "ts_us": self._t0_ns / 1000.0,
                "dur_us": self.dur_us,
                "tick": self._tracer._tick,
                "tid": threading.get_ident(),
                "attrs": self.attrs,
            })
        return False


class Tracer:
    """Ring buffer of span/event records with a zero-cost disabled path."""

    def __init__(self, capacity: int = _DEFAULT_CAPACITY):
        self._buf: deque = deque(maxlen=capacity)
        self._lock = threading.Lock()
        self._seq = 0
        self._appended = 0
        self._tick: Optional[int] = None
        self._enabled = os.environ.get(ENV_VAR, "") == "1"

    # ------------------------------------------------------------- switches
    def enabled(self) -> bool:
        return self._enabled

    def set_enabled(self, flag: bool) -> None:
        self._enabled = bool(flag)

    def set_tick(self, tick: Optional[int]) -> None:
        """Correlation id stamped on every subsequent record."""
        self._tick = None if tick is None else int(tick)

    def current_tick(self) -> Optional[int]:
        return self._tick

    # --------------------------------------------------------------- emit
    def _emit(self, rec: Dict[str, Any]) -> None:
        if rec["name"] not in names.ALL_NAMES:
            raise ValueError(
                f"unregistered trace name {rec['name']!r} — add it to "
                f"repro_torch.obs.names")
        with self._lock:
            self._seq += 1
            self._appended += 1
            rec["seq"] = self._seq
            self._buf.append(rec)

    def event(self, name: str, **attrs: Any) -> None:
        if not self._enabled:
            return
        self._emit({
            "type": "event",
            "name": name,
            "ts_us": _now_us(),
            "tick": self._tick,
            "tid": threading.get_ident(),
            "attrs": attrs,
        })

    def span(self, name: str, **attrs: Any):
        if not self._enabled:
            return _NOOP
        return _Span(self, name, attrs, record=True)

    def timed_span(self, name: str, **attrs: Any) -> _Span:
        """A span that always measures; recorded only when tracing is on."""
        return _Span(self, name, attrs, record=self._enabled)

    # ------------------------------------------------------------- readout
    def mark(self) -> int:
        with self._lock:
            return self._seq

    def records(self, since: int = 0) -> List[Dict[str, Any]]:
        with self._lock:
            return [r for r in self._buf if r["seq"] > since]

    def dropped(self) -> int:
        with self._lock:
            return self._appended - len(self._buf)

    def clear(self) -> None:
        with self._lock:
            self._buf.clear()
            self._appended = 0


TRACER = Tracer()


# ------------------------------------------------------------ module facade
def enabled() -> bool:
    return TRACER._enabled


def set_enabled(flag: bool) -> None:
    TRACER.set_enabled(flag)


def span(name: str, **attrs: Any):
    if not TRACER._enabled:
        return _NOOP
    return _Span(TRACER, name, attrs, record=True)


def timed_span(name: str, **attrs: Any) -> _Span:
    return TRACER.timed_span(name, **attrs)


def event(name: str, **attrs: Any) -> None:
    TRACER.event(name, **attrs)


def set_tick(tick: Optional[int]) -> None:
    TRACER.set_tick(tick)


def current_tick() -> Optional[int]:
    return TRACER.current_tick()


def mark() -> int:
    return TRACER.mark()


def records(since: int = 0) -> List[Dict[str, Any]]:
    return TRACER.records(since)


def dropped() -> int:
    return TRACER.dropped()


def clear() -> None:
    TRACER.clear()


def traced(name: str, **attrs: Any):
    """Decorator form: spans every call of the wrapped function."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if not TRACER._enabled:
                return fn(*args, **kwargs)
            with TRACER.span(name, **attrs):
                return fn(*args, **kwargs)
        return wrapper
    return deco


@contextmanager
def capture() -> Iterator[List[Dict[str, Any]]]:
    """Force-record within the block; yields a list filled on exit.

    Enables tracing for the dynamic extent regardless of ``REPRO_TRACE``
    and hands back exactly the records emitted inside the block — the tool
    benchmarks use to aggregate phase spans without turning tracing on for
    the whole process.
    """
    prev = TRACER._enabled
    tok = TRACER.mark()
    TRACER.set_enabled(True)
    out: List[Dict[str, Any]] = []
    try:
        yield out
    finally:
        TRACER.set_enabled(prev)
        out.extend(TRACER.records(since=tok))
