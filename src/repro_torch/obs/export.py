"""Exporters for trace records: JSONL, Chrome/Perfetto, Prometheus text.

The JAX package's ``obs/export.py``, for the port: the same record schema
and the same outputs, so either package's tools read the other's traces.

Record schema (one dict per span/event, produced by
:mod:`repro_torch.obs.trace`):

    {"type": "span",  "name": <names.SPAN_*>, "ts_us": float,
     "dur_us": float, "tick": int|None, "tid": int, "seq": int,
     "attrs": {...}}
    {"type": "event", "name": <names.EV_*>,   "ts_us": float,
     "tick": int|None, "tid": int, "seq": int, "attrs": {...}}

``validate_records`` is the schema gate run over the
exported JSONL; ``to_perfetto`` emits the Chrome ``trace_event`` JSON that
chrome://tracing and https://ui.perfetto.dev load directly (complete
``"X"`` events for spans, instant ``"i"`` events for the audit log);
``prometheus_snapshot`` folds the same records into counter/summary text
built on :class:`repro_torch.serve.telemetry.StreamingStat`.
"""
from __future__ import annotations

import json
from collections import defaultdict
from typing import Any, Dict, Iterable, List, Optional

from . import names, trace

__all__ = [
    "write_jsonl", "read_jsonl", "validate_records", "to_perfetto",
    "write_perfetto", "prometheus_snapshot", "phase_totals",
    "span_kinds", "event_types",
]

_COMMON_KEYS = {"type", "name", "ts_us", "tick", "tid", "seq", "attrs"}


# --------------------------------------------------------------------- JSONL
def write_jsonl(records: Iterable[Dict[str, Any]], path: str) -> int:
    """One record per line; returns the number written."""
    n = 0
    with open(path, "w") as f:
        for rec in records:
            f.write(json.dumps(rec, sort_keys=True) + "\n")
            n += 1
    return n


def read_jsonl(path: str) -> List[Dict[str, Any]]:
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out


# ---------------------------------------------------------------- validation
def validate_records(records: Iterable[Dict[str, Any]]) -> int:
    """Raise ``ValueError`` on the first malformed record; return count.

    Checks every record against the schema above: known type, a name from
    the central registry (RPA090's runtime half), monotonic-clock fields
    present and numeric, spans carrying a nonnegative duration, and a
    JSON-serializable attrs dict.
    """
    n = 0
    for rec in records:
        n += 1
        where = f"record {n} ({rec.get('name')!r})"
        if rec.get("type") not in ("span", "event"):
            raise ValueError(f"{where}: bad type {rec.get('type')!r}")
        if rec.get("name") not in names.ALL_NAMES:
            raise ValueError(f"{where}: name not in the obs.names registry")
        if rec["type"] == "span" and rec["name"] not in names.SPAN_KINDS:
            raise ValueError(f"{where}: span with an event name")
        if rec["type"] == "event" and rec["name"] not in names.EVENT_TYPES:
            raise ValueError(f"{where}: event with a span name")
        for key in ("ts_us", "tid", "seq"):
            if not isinstance(rec.get(key), (int, float)):
                raise ValueError(f"{where}: missing/bad {key}")
        if rec.get("tick") is not None and not isinstance(rec["tick"], int):
            raise ValueError(f"{where}: bad tick {rec['tick']!r}")
        if rec["type"] == "span":
            dur = rec.get("dur_us")
            if not isinstance(dur, (int, float)) or dur < 0:
                raise ValueError(f"{where}: bad span dur_us {dur!r}")
        if not isinstance(rec.get("attrs"), dict):
            raise ValueError(f"{where}: attrs must be a dict")
        json.dumps(rec["attrs"])  # must serialize
    return n


def span_kinds(records: Iterable[Dict[str, Any]]) -> set:
    return {r["name"] for r in records if r["type"] == "span"}


def event_types(records: Iterable[Dict[str, Any]]) -> set:
    return {r["name"] for r in records if r["type"] == "event"}


# ------------------------------------------------------------------ Perfetto
def to_perfetto(records: Iterable[Dict[str, Any]],
                process_name: str = "repro") -> Dict[str, Any]:
    """Chrome ``trace_event`` document (loadable by ui.perfetto.dev)."""
    tids = {}
    events: List[Dict[str, Any]] = [{
        "name": "process_name", "ph": "M", "pid": 0,
        "args": {"name": process_name},
    }]
    for rec in records:
        tid = tids.setdefault(rec["tid"], len(tids))
        args = dict(rec["attrs"])
        if rec.get("tick") is not None:
            args["tick"] = rec["tick"]
        if rec["type"] == "span":
            events.append({
                "name": rec["name"], "cat": rec["name"].split(".")[0],
                "ph": "X", "ts": rec["ts_us"], "dur": rec["dur_us"],
                "pid": 0, "tid": tid, "args": args,
            })
        else:
            events.append({
                "name": rec["name"], "cat": "audit", "ph": "i",
                "ts": rec["ts_us"], "pid": 0, "tid": tid, "s": "p",
                "args": args,
            })
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def write_perfetto(records: Iterable[Dict[str, Any]], path: str,
                   process_name: str = "repro") -> int:
    doc = to_perfetto(records, process_name=process_name)
    with open(path, "w") as f:
        json.dump(doc, f)
    return len(doc["traceEvents"])


# ---------------------------------------------------------------- Prometheus
def prometheus_snapshot(records: Iterable[Dict[str, Any]],
                        dropped: Optional[int] = None) -> str:
    """Counters + duration summaries in Prometheus text exposition format.

    Built on the serving tier's :class:`StreamingStat` so span-duration
    quantiles come from the same reservoir estimator the engine telemetry
    already trusts. These stats are constructed fresh per snapshot with
    their own seeded RNG — nothing here touches a checkpointed stream.
    """
    from ..serve.telemetry import StreamingStat  # deferred: avoid cycle

    span_stats: Dict[str, Any] = {}
    event_counts: Dict[str, int] = defaultdict(int)
    for rec in records:
        if rec["type"] == "span":
            st = span_stats.get(rec["name"])
            if st is None:
                st = span_stats[rec["name"]] = StreamingStat()
            st.add(rec["dur_us"])
        else:
            event_counts[rec["name"]] += 1

    lines = [
        f"# HELP {names.METRIC_SPAN_COUNT} spans recorded per kind",
        f"# TYPE {names.METRIC_SPAN_COUNT} counter",
    ]
    for name in sorted(span_stats):
        st = span_stats[name].summary()
        lines.append(f'{names.METRIC_SPAN_COUNT}{{kind="{name}"}} '
                     f'{st["count"]}')
    lines += [
        f"# HELP {names.METRIC_SPAN_US} span duration microseconds",
        f"# TYPE {names.METRIC_SPAN_US} summary",
    ]
    for name in sorted(span_stats):
        st = span_stats[name].summary()
        for q in ("p50", "p90", "p99"):
            lines.append(
                f'{names.METRIC_SPAN_US}{{kind="{name}",quantile='
                f'"0.{q[1:]}"}} {st[q]:.3f}')
        lines.append(f'{names.METRIC_SPAN_US}_sum{{kind="{name}"}} '
                     f'{st["mean"] * st["count"]:.3f}')
        lines.append(f'{names.METRIC_SPAN_US}_count{{kind="{name}"}} '
                     f'{st["count"]}')
    lines += [
        f"# HELP {names.METRIC_EVENT_COUNT} audit events per type",
        f"# TYPE {names.METRIC_EVENT_COUNT} counter",
    ]
    for name in sorted(event_counts):
        lines.append(f'{names.METRIC_EVENT_COUNT}{{type="{name}"}} '
                     f'{event_counts[name]}')
    if dropped is None:
        dropped = trace.dropped()
    lines += [
        f"# HELP {names.METRIC_DROPPED} records dropped by the ring buffer",
        f"# TYPE {names.METRIC_DROPPED} counter",
        f"{names.METRIC_DROPPED} {dropped}",
    ]
    return "\n".join(lines) + "\n"


# ------------------------------------------------------------- aggregations
def phase_totals(records: Iterable[Dict[str, Any]],
                 name: str = names.SPAN_SOLVER_PHASE,
                 attr: str = "phase") -> Dict[str, int]:
    """Sum span durations (in integer microseconds) keyed by one attribute.

    The span-derived replacement for hand-rolled ``phase_us`` profiles:
    ``phase_totals(cap)`` over a captured ``solve_dag`` gives exactly the
    ladder attribution the dag_scale benchmark reports.
    """
    out: Dict[str, int] = defaultdict(int)
    for rec in records:
        if rec["type"] == "span" and rec["name"] == name:
            key = rec["attrs"].get(attr)
            if key is not None:
                out[str(key)] += int(round(rec["dur_us"]))
    return dict(out)
