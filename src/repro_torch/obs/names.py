"""Central registry of every span kind, audit-event type and metric name.

A copy of the JAX package's ``obs/names.py``, kept here so the port
imports nothing of that package: the three sets are the same, so a
dashboard (or that package's ``obs.export.validate_records``) reads the
port's records unchanged.

Every ``obs.span`` / ``obs.timed_span`` / ``obs.event`` emit site MUST name
its record with a constant from this module — never a free string literal.
The tracer validates names against this registry at emit time (when
tracing is on), and a test (``tests/test_torch_obs.py``) enforces the same
statically over the port, as lint rule RPA090 does over the JAX package,
so a dashboard reading ``solver.phase`` can never silently diverge from an emit
site that renamed itself ``solve.phase``.

Naming convention: ``<layer>.<thing>`` for spans, ``audit.<decision>`` for
events, ``repro_<snake>`` for Prometheus metric names. Attribute keys ride
free-form on each record (they are schema-checked per event type in
:mod:`repro_torch.obs.export`, not here).
"""
from __future__ import annotations

# --------------------------------------------------------------------- spans
# Solver ladder phases inside workflow.solve.solve_dag (attr ``phase`` is one
# of starts/presolve/triage/refine/final_score/fragility).
SPAN_SOLVER_PHASE = "solver.phase"
# One stacked PGD solve over the rows of a family group
# (serve.engine.row_pgd_step); attrs family, rows, K, num_t.
SPAN_SOLVER_PGD = "solver.pgd"
# One ``ops.frontier_moments*`` call: attrs family, mode (fwd|grad|pgrad), F,
# K, num_t, impl (cuda|plain), stacked, autotune (hit|model|sweep|explicit)
# and the launch plan: threads and split on the card, block_rows on the
# plain path (the JAX package's block_f).
SPAN_KERNEL_LAUNCH = "kernel.launch"
# One WorkflowEngine.tick; attrs live, queue, rows, launches.
SPAN_ENGINE_TICK = "engine.tick"
# A stage of the tick: attr ``stage`` in admission|stack_rows|launch|commit.
SPAN_ENGINE_STAGE = "engine.stage"
# A balancer refresh that actually re-solved (attr kind, stages/dirty count).
SPAN_SCHED_REFRESH = "sched.refresh"
# One ClusterSim.run_step / WorkflowSim.tick; attr sim in cluster|workflow.
SPAN_SIM_STEP = "sim.step"
# One kill/restore cycle in sim.chaos; attrs step, kind.
SPAN_CHAOS_CYCLE = "chaos.cycle"

SPAN_KINDS = frozenset({
    SPAN_SOLVER_PHASE, SPAN_SOLVER_PGD, SPAN_KERNEL_LAUNCH,
    SPAN_ENGINE_TICK, SPAN_ENGINE_STAGE, SPAN_SCHED_REFRESH,
    SPAN_SIM_STEP, SPAN_CHAOS_CYCLE,
})

# -------------------------------------------------------------- audit events
# Why a row/stage became dirty: attrs scope (engine|workflow), key, cause
# (drift|churn|fragility|new|slo), drift (float, when cause == drift).
EV_DIRTY = "audit.dirty"
# Fragility-gate outcome on a balancer refresh: attrs passed (bool),
# rel_frag, target.
EV_FRAGILITY = "audit.fragility_gate"
# BIC family switch in UncertaintyAwareBalancer._auto_select: attrs old,
# new, scores (name -> BIC), streak.
EV_FAMILY_SWITCH = "audit.family_switch"
# SLO-driven risk_lam escalation for a row: attrs instance, lam, base,
# headroom.
EV_SLO_LAM = "audit.slo_lam"
# Failure/recovery/throttle churn reaching a decider or sim: attrs kind
# (fail|recover|throttle|set_load), channel, source (sim|balancer|engine).
EV_CHURN = "audit.churn"
# Pipeline checkpoint committed: attrs step, kind, path.
EV_CKPT_SAVE = "audit.ckpt_save"
# Pipeline checkpoint restored — the FIRST record of a restored replica's
# fresh trace (trace state is never checkpointed): attrs step, kind, path.
EV_CKPT_RESTORE = "audit.ckpt_restore"
# A frontier kernel entry point was traced (jit compile / retrace), as
# opposed to launched eagerly: attrs mode, F, K, num_t, impl. The JAX
# package emits it; the port has no trace time and never does, but keeps
# the name so the two registries stay one set.
EV_KERNEL_COMPILE = "audit.kernel_compile"

EVENT_TYPES = frozenset({
    EV_DIRTY, EV_FRAGILITY, EV_FAMILY_SWITCH, EV_SLO_LAM, EV_CHURN,
    EV_CKPT_SAVE, EV_CKPT_RESTORE, EV_KERNEL_COMPILE,
})

ALL_NAMES = SPAN_KINDS | EVENT_TYPES

# ------------------------------------------------------------------- metrics
# Prometheus-style snapshot names (obs.export.prometheus_snapshot).
METRIC_SPAN_COUNT = "repro_span_count"
METRIC_SPAN_US = "repro_span_duration_us"
METRIC_EVENT_COUNT = "repro_audit_event_count"
METRIC_DROPPED = "repro_trace_dropped_records"

METRIC_NAMES = frozenset({
    METRIC_SPAN_COUNT, METRIC_SPAN_US, METRIC_EVENT_COUNT, METRIC_DROPPED,
})
