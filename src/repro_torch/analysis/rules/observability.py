"""Observability discipline (RPA090/RPA091).

The tracing and decision-audit subsystem (``repro_torch/obs/``) keys every
consumer — a dashboard query, the Perfetto converter, the schema validator
— on span/event names, so an emit site inventing its own string drifts out
of every consumer silently. The central registry is
``repro_torch.obs.names`` (the JAX package's ``repro.obs.names``, copied);
the tracer rejects unregistered names at runtime (when tracing is on) and
RPA090 rejects them statically (always).

Both rules patrol files under a ``repro`` or a ``repro_torch`` directory,
so linting ``src/`` checks both packages.

* **RPA090** — a call to an obs emit entry point (``span`` /
  ``timed_span`` / ``event`` / ``traced``) must not pass a string literal
  as the name: use an ``obs.names`` constant. The obs package itself and
  tests are exempt (they define and exercise the machinery).
* **RPA091** — no ``time.time()`` inside either package: every duration
  and span is measured on the monotonic clock (``time.perf_counter`` /
  ``perf_counter_ns``). Wall-clock time is subject to NTP steps and DST,
  which turns benchmark deltas and span durations into lies; a deliberate
  wall-clock need (e.g. naming an artifact by date) takes a pragma.
"""
from __future__ import annotations

import ast
import os
from typing import Iterator, Optional

from ..framework import Finding, Project, dotted_name, register

_EMITTERS = {"span", "timed_span", "event", "traced"}


def _parts(path: str):
    return os.path.normpath(path).split(os.sep)


def _obs_emit_name_literal(node: ast.Call) -> Optional[str]:
    """The literal string passed as an emit name, if any."""
    func = node.func
    # only attribute calls rooted at an obs-ish module count — a bare
    # ``event(...)`` in unrelated code (e.g. a sim's event queue) is not an
    # obs emit site
    dn = dotted_name(func)
    if dn is None:
        return None
    head, _, tail = dn.rpartition(".")
    if tail not in _EMITTERS:
        return None
    if not head or not (head == "obs" or head.endswith(".obs")
                        or head in ("trace", "TRACER")
                        or head.endswith("obs.trace")):
        return None
    if not node.args:
        return None
    first = node.args[0]
    if isinstance(first, ast.Constant) and isinstance(first.value, str):
        return first.value
    return None


@register
class ObservabilityRule:
    CODES = {
        "RPA090": "obs emit site names a span/event with a free string "
                  "literal — use a repro_torch.obs.names constant",
        "RPA091": "time.time() in src/repro/ or src/repro_torch/ — "
                  "durations must come from the monotonic clock "
                  "(time.perf_counter)",
    }

    def run(self, project: Project) -> Iterator[Finding]:
        for ctx in project.files:
            parts = _parts(ctx.path)
            in_repro = (("repro" in parts or "repro_torch" in parts)
                        and "tests" not in parts)
            in_obs = in_repro and "obs" in parts
            for node in ast.walk(ctx.tree):
                if not isinstance(node, ast.Call):
                    continue
                if in_repro and not in_obs and "tests" not in parts:
                    lit = _obs_emit_name_literal(node)
                    if lit is not None:
                        yield ctx.finding(
                            node, "RPA090",
                            f"span/event name {lit!r} is a free string — "
                            f"name records with repro_torch.obs.names "
                            f"constants so emit sites and consumers cannot "
                            f"drift")
                if in_repro and dotted_name(node.func) == "time.time":
                    yield ctx.finding(
                        node, "RPA091",
                        "time.time() is wall clock (NTP steps, DST) — "
                        "measure durations with time.perf_counter()")
