"""Cross-layer tracing and the decision audit, for the port.

Spans (how long), audit events (why) and exporters (JSONL, Perfetto,
Prometheus) for the port's main path: solver ladder phases, frontier
launches, engine tick stages, balancer refreshes, sim steps, chaos cycles
and checkpoints, under the JAX package's zero-perturbation contract: no
random draws, no trace state in any checkpoint and, on the card, no device
synchronization. ``REPRO_TRACE=1`` turns recording on; off is a no-op fast
path. The record schema and the name registry are the JAX package's
``repro.obs``.

``repro_torch.obs.export`` is imported on demand (not here), so the
serving tier imports ``repro_torch.obs`` without a cycle through
``repro_torch.serve``.
"""
from . import events, names  # noqa: F401
from .trace import (TRACER, Tracer, capture, clear, current_tick,  # noqa: F401
                    dropped, enabled, event, mark, records, set_enabled,
                    set_tick, span, timed_span, traced)

__all__ = [
    "names", "events", "Tracer", "TRACER", "enabled", "set_enabled",
    "span", "timed_span", "event", "traced", "set_tick", "current_tick",
    "mark", "records", "dropped", "clear", "capture",
]
