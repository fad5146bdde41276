"""The port's tracing and decision audit (``repro_torch.obs``) against the
JAX package's ``repro.obs``.

* The tracer and the exporters, case for case as ``tests/test_obs.py``
  holds the reference's: the off path, ring-buffer drops, the registry
  check at emit time, tick correlation, ``capture``, ``traced``; JSONL,
  schema validation, Perfetto, phase totals, the Prometheus text.
* One registry: the port's names are the reference's set, and the port's
  records pass the reference's ``validate_records``.
* The solver and the kernels: ``solve_dag``'s ``phase_us`` is its phase
  spans, and each frontier call is one ``kernel.launch`` span with the
  reference's attributes and the port's launch plan.
* Zero perturbation: engine ticks and chaos runs are bitwise the same
  traced and untraced; a restore's event carries the manifest step; no
  trace state rides a manifest; an audit attribute that is a tensor is
  refused.
* Parity with the reference: a 5-tick engine run and a chaos run from the
  same seeds emit the same sequence of audit events in both packages
  (name, scope, key, cause, kind; drift within 1e-5 relative).
* Every emit site of ``src/repro_torch`` names its record with a constant
  of ``obs.names`` (the JAX package's lint rule RPA090 does not patrol
  the port).
"""
import ast
import json
import pathlib

import numpy as np
import pytest
import torch

import repro.obs.names as jnames
import repro.workflow.dag as jdag
from repro.obs import export as jexport
from repro.obs import trace as jobs
from repro.serve import WorkflowEngine as JEngine
from repro.sim.chaos import run_chaos_trace as j_run_chaos_trace
from repro_torch.obs import events as obs_events
from repro_torch.obs import export as obs_export
from repro_torch.obs import names as obs_names
from repro_torch.obs import trace as obs
from repro_torch.obs.trace import _NOOP, Tracer
from repro_torch.serve import WorkflowEngine
from repro_torch.sim.chaos import run_chaos_trace, run_workflow_chaos_trace
from repro_torch.workflow import Stage, StageDAG, linear_edges

DEV = "cpu"
ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def tracing():
    """Force-enable the port's tracer for one test; restore and clear."""
    prev = obs.enabled()
    obs.clear()
    obs.set_enabled(True)
    yield
    obs.set_enabled(prev)
    obs.set_tick(None)
    obs.clear()


@pytest.fixture
def both_tracing():
    """Both packages' tracers on for one test; restored and cleared."""
    prev = (obs.enabled(), jobs.enabled())
    for t in (obs, jobs):
        t.clear()
        t.set_enabled(True)
    yield
    for t, p in zip((obs, jobs), prev):
        t.set_enabled(p)
        t.set_tick(None)
        t.clear()


def _dag(k=3, seed=7):
    rng = np.random.default_rng(seed)
    stages = [Stage("a", rng.uniform(10, 30, k), rng.uniform(1, 4, k)),
              Stage("b", rng.uniform(10, 30, k), rng.uniform(1, 4, k))]
    return StageDAG(stages, linear_edges(["a", "b"]))


# ---------------------------------------------------------------- registry
def test_registry_is_the_references():
    assert obs_names.ALL_NAMES == jnames.ALL_NAMES
    assert obs_names.SPAN_KINDS == jnames.SPAN_KINDS
    assert obs_names.EVENT_TYPES == jnames.EVENT_TYPES
    assert obs_names.METRIC_NAMES == jnames.METRIC_NAMES


# ---------------------------------------------------------------- tracer
def test_off_by_default_is_noop():
    assert not obs.enabled()  # REPRO_TRACE unset in the test env
    sp = obs.span(obs_names.SPAN_SIM_STEP, sim="x")
    assert sp is _NOOP
    with sp:
        pass
    obs.event(obs_names.EV_CHURN, kind="fail")
    obs_events.churn("fail", 0, "test")
    assert obs.records() == []


def test_timed_span_measures_even_when_off():
    assert not obs.enabled()
    with obs.timed_span(obs_names.SPAN_SOLVER_PHASE, phase="p") as sp:
        sum(range(1000))
    assert sp.dur_us > 0.0
    assert obs.records() == []


def test_span_records_fields(tracing):
    with obs.span(obs_names.SPAN_SIM_STEP, sim="cluster", k=4):
        pass
    (rec,) = obs.records()
    assert rec["type"] == "span"
    assert rec["name"] == obs_names.SPAN_SIM_STEP
    assert rec["dur_us"] >= 0.0
    assert rec["attrs"] == {"sim": "cluster", "k": 4}
    assert isinstance(rec["seq"], int)


def test_event_and_tick_correlation(tracing):
    obs.set_tick(7)
    obs_events.dirty("engine", 3, "drift", 0.125)
    (rec,) = obs.records()
    assert rec["type"] == "event" and rec["tick"] == 7
    assert rec["attrs"] == {"scope": "engine", "key": "3", "cause": "drift",
                            "drift": 0.125}
    assert obs.current_tick() == 7


def test_unregistered_name_rejected_at_emit(tracing):
    with pytest.raises(ValueError, match="unregistered trace name"):
        obs.event("made.up.name", x=1)
    with pytest.raises(ValueError, match="obs.names"):
        with obs.span("also.not.registered"):
            pass


def test_ring_buffer_drops_oldest_and_counts():
    t = Tracer(capacity=8)
    t.set_enabled(True)
    for i in range(20):
        t.event(obs_names.EV_CHURN, i=i)
    recs = t.records()
    assert len(recs) == 8
    assert [r["attrs"]["i"] for r in recs] == list(range(12, 20))
    assert t.dropped() == 12
    t.clear()
    assert t.records() == [] and t.dropped() == 0


def test_capture_scopes_records_and_restores_state(tracing):
    obs.set_enabled(False)
    obs_events.churn("fail", 0, "before")
    with obs.capture() as cap:
        assert obs.enabled()
        obs_events.churn("recover", 1, "inside")
    assert not obs.enabled()
    assert [r["attrs"]["source"] for r in cap] == ["inside"]


def test_traced_decorator(tracing):
    @obs.traced(obs_names.SPAN_SIM_STEP, sim="deco")
    def f(x):
        return x + 1

    assert f(1) == 2
    (rec,) = obs.records()
    assert rec["attrs"] == {"sim": "deco"}
    obs.set_enabled(False)
    obs.clear()
    assert f(2) == 3 and obs.records() == []


@pytest.mark.parametrize("emit", [
    lambda x: obs_events.dirty("engine", 1, "drift", x),
    lambda x: obs_events.slo_lam(1, x, 0.02),
    lambda x: obs_events.fragility_gate(True, x, 0.1),
    lambda x: obs_events.churn("fail", x, "sim"),
    lambda x: obs_events.ckpt_save(x, "engine", "p"),
], ids=["dirty", "slo_lam", "fragility_gate", "churn", "ckpt_save"])
def test_a_tensor_attribute_is_refused(tracing, emit):
    # on the card, reading it would be a device synchronization
    with pytest.raises(TypeError, match="synchronize"):
        emit(torch.tensor(1.0))
    assert obs.records() == []
    obs.set_enabled(False)
    emit(torch.tensor(1.0))  # off: nothing is read, nothing raises


# ---------------------------------------------------------------- export
def _sample_records(tick=3):
    obs.set_tick(tick)
    with obs.span(obs_names.SPAN_SOLVER_PHASE, phase="presolve"):
        pass
    with obs.span(obs_names.SPAN_SOLVER_PHASE, phase="refine"):
        pass
    obs_events.fragility_gate(True, 0.02, 0.1)
    obs_events.ckpt_save(5, "engine", "/tmp/ck")
    return obs.records()


def test_jsonl_round_trip(tracing, tmp_path):
    recs = _sample_records()
    path = str(tmp_path / "t.jsonl")
    assert obs_export.write_jsonl(recs, path) == len(recs)
    back = obs_export.read_jsonl(path)
    assert back == json.loads(json.dumps(recs))
    # the JAX package's reader and gate take the port's file as it is
    assert jexport.validate_records(jexport.read_jsonl(path)) == len(recs)


def test_validate_accepts_real_records(tracing):
    recs = _sample_records()
    assert obs_export.validate_records(recs) == len(recs)
    assert obs_export.span_kinds(recs) == {obs_names.SPAN_SOLVER_PHASE}
    assert obs_export.event_types(recs) == {obs_names.EV_FRAGILITY,
                                            obs_names.EV_CKPT_SAVE}


def test_validate_rejects_malformed(tracing):
    (good,) = [r for r in _sample_records()
               if r["name"] == obs_names.EV_CKPT_SAVE]

    def bad(**patch):
        return [{**good, **patch}]

    with pytest.raises(ValueError, match="registry"):
        obs_export.validate_records(bad(name="rogue.name"))
    with pytest.raises(ValueError, match="event with a span name"):
        obs_export.validate_records(bad(name=obs_names.SPAN_SIM_STEP))
    with pytest.raises(ValueError, match="bad type"):
        obs_export.validate_records(bad(type="metric"))
    with pytest.raises(ValueError, match="dur_us"):
        obs_export.validate_records(
            bad(type="span", name=obs_names.SPAN_SIM_STEP, dur_us=-1.0))
    with pytest.raises(ValueError, match="attrs"):
        obs_export.validate_records(bad(attrs=None))
    with pytest.raises(ValueError, match="ts_us"):
        obs_export.validate_records(bad(ts_us=None))


def test_perfetto_structure(tracing):
    doc = obs_export.to_perfetto(_sample_records(tick=9))
    json.dumps(doc)
    evs = doc["traceEvents"]
    assert evs[0]["ph"] == "M" and evs[0]["name"] == "process_name"
    xs = [e for e in evs if e["ph"] == "X"]
    inst = [e for e in evs if e["ph"] == "i"]
    assert len(xs) == 2 and all(e["dur"] >= 0 for e in xs)
    assert len(inst) == 2 and all(e["s"] == "p" for e in inst)
    assert all(e["args"]["tick"] == 9 for e in xs + inst)
    assert {e["tid"] for e in xs} == {0}
    assert doc == jexport.to_perfetto(obs.records())


def test_phase_totals(tracing):
    totals = obs_export.phase_totals(_sample_records())
    assert set(totals) == {"presolve", "refine"}
    assert all(v >= 0 for v in totals.values())


def test_prometheus_snapshot(tracing):
    recs = _sample_records()
    text = obs_export.prometheus_snapshot(recs, dropped=2)
    assert f'{obs_names.METRIC_SPAN_COUNT}{{kind="solver.phase"}} 2' in text
    assert 'quantile="0.50"' in text
    assert f'{obs_names.METRIC_EVENT_COUNT}{{type="audit.ckpt_save"}} 1' \
        in text
    assert text.rstrip().endswith(f"{obs_names.METRIC_DROPPED} 2")
    assert text == jexport.prometheus_snapshot(recs, dropped=2)


# ---------------------------------------------------------------- solver
def test_solve_dag_phase_us_is_its_spans():
    from repro_torch.workflow import solve_dag

    with obs.capture() as cap:
        dec = solve_dag(_dag(), steps=6, restarts=1, num_t=64, device=DEV,
                        seed=0)
    phases = [r for r in cap if r["name"] == obs_names.SPAN_SOLVER_PHASE]
    ladder = ["starts", "presolve", "triage", "refine", "final_score"]
    assert [r["attrs"]["phase"] for r in phases] == ladder
    # one measurement: the profile books each span's own duration
    assert dec.profile["phase_us"] == {
        r["attrs"]["phase"]: round(r["dur_us"], 1) for r in phases}
    totals = obs_export.phase_totals(cap)
    assert set(totals) == set(ladder)
    for p in ladder:
        assert abs(totals[p] - dec.profile["phase_us"][p]) <= 0.55
    # the port's solve is eager: its frontier calls are launch spans too
    assert obs_export.span_kinds(cap) == {obs_names.SPAN_SOLVER_PHASE,
                                          obs_names.SPAN_KERNEL_LAUNCH}
    assert jexport.validate_records(cap) == len(cap)


def test_greedy_and_noop_solves_record_phases():
    from repro_torch.workflow import solve_dag, solve_dag_greedy

    dag = _dag()
    with obs.capture() as cap:
        g = solve_dag_greedy(dag, steps=4, restarts=0, num_t=64,
                             device=DEV)
        n = solve_dag(dag, num_t=64, device=DEV, warm_start=g.weights,
                      dirty=())
    phases = [r["attrs"]["phase"] for r in cap
              if r["name"] == obs_names.SPAN_SOLVER_PHASE]
    assert phases == ["stage_solves", "final_score", "final_score"]
    assert set(g.profile["phase_us"]) == {"stage_solves", "final_score"}
    assert n.method == "pgd-dag-noop"


@pytest.mark.parametrize("call,mode", [("fwd", "fwd"), ("grad", "grad"),
                                       ("pgrad", "pgrad"),
                                       ("fwd_needs_grad", "pgrad")])
def test_kernel_launch_span_attrs(call, mode):
    from repro_torch.kernels import autotune, ops

    W = torch.full((2, 3), 1 / 3)
    mus = torch.linspace(10, 20, 6).reshape(2, 3)
    sigmas = torch.full((2, 3), 1.5)
    if call == "fwd_needs_grad":
        W.requires_grad_(True)
    with obs.capture() as cap:
        if call.startswith("fwd"):
            ops.frontier_moments(W, mus, sigmas, num_t=32, device=DEV)
        else:
            ops.frontier_moments_with_grads(W, mus, sigmas, num_t=32,
                                            device=DEV,
                                            param_grads=call == "pgrad")
        ops.frontier_moments_with_grads(W.detach(), mus, sigmas, num_t=32,
                                        device=DEV, block_rows=1)
    first, explicit = [r["attrs"] for r in cap
                       if r["name"] == obs_names.SPAN_KERNEL_LAUNCH]
    want = {"family": "normal", "mode": mode, "F": 2, "K": 3, "num_t": 32,
            "impl": "plain", "stacked": True,
            "block_rows": autotune.pick_block_rows(2, 3, 32, mode,
                                                   "normal")}
    assert {k: first[k] for k in want} == want
    assert first["autotune"] in ("hit", "model")
    assert explicit["autotune"] == "explicit" and explicit["block_rows"] == 1
    assert explicit["mode"] == "grad"


def test_launch_spans_match_the_launches_of_a_solve():
    from repro_torch.core.partitioner import optimize_weights

    with obs.capture() as cap:
        optimize_weights([10.0, 14.0, 20.0], [1.0, 2.0, 3.0], lam=0.05,
                         steps=7, restarts=1, num_t=64, device=DEV)
    modes = [r["attrs"]["mode"] for r in cap
             if r["name"] == obs_names.SPAN_KERNEL_LAUNCH]
    assert modes == ["grad"] * 7 + ["fwd"]


# ------------------------------------------------------ zero perturbation
def _engine_run(ticks=5, seed=0):
    eng = WorkflowEngine({"wf": _dag(k=2, seed=3)}, max_live=8,
                         lam_var=0.02, num_t=64, seed=seed, prior_obs=2,
                         settle_steps=2, device=DEV)
    rng = np.random.default_rng(seed)
    outs = []
    for _ in range(ticks):
        arrivals = [("wf", 30.0)] * int(rng.poisson(2.0))
        out = eng.tick(arrivals)
        outs.append((out["live"], out["queue"], out["rows"],
                     out["launches"],
                     tuple(r["join_latency_s"] for r in out["retired"])))
    weights = {iid: {n: w.copy() for n, w in inst.weights.items()}
               for iid, inst in eng._live.items()}
    return outs, weights


def _same_weights(a, b):
    return a.keys() == b.keys() and all(
        a[i].keys() == b[i].keys()
        and all(np.array_equal(a[i][n], b[i][n]) for n in a[i]) for i in a)


def test_engine_ticks_bitwise_traced_vs_untraced(tracing):
    obs.set_enabled(False)
    plain, w_plain = _engine_run()
    obs.set_enabled(True)
    obs.clear()
    traced, w_traced = _engine_run()
    assert plain == traced
    assert _same_weights(w_plain, w_traced)
    recs = obs.records()
    kinds = obs_export.span_kinds(recs)
    assert {obs_names.SPAN_ENGINE_TICK, obs_names.SPAN_ENGINE_STAGE,
            obs_names.SPAN_SOLVER_PGD, obs_names.SPAN_KERNEL_LAUNCH,
            obs_names.SPAN_SIM_STEP} <= kinds
    ticks = [r for r in recs if r["name"] == obs_names.SPAN_ENGINE_TICK]
    assert [(r["attrs"]["live"], r["attrs"]["queue"], r["attrs"]["rows"],
             r["attrs"]["launches"]) for r in ticks] == \
        [o[:4] for o in traced]
    stages = [r["attrs"]["stage"] for r in recs
              if r["name"] == obs_names.SPAN_ENGINE_STAGE]
    assert stages == ["admission", "stack_rows", "launch", "commit"] * 5
    launches = [r for r in recs if r["name"] == obs_names.SPAN_KERNEL_LAUNCH]
    pgd = [r for r in recs if r["name"] == obs_names.SPAN_SOLVER_PGD]
    assert len(launches) == len(pgd) == sum(o[3] for o in traced)
    assert all(r["attrs"]["mode"] == "grad" for r in launches)
    assert jexport.validate_records(recs) == len(recs)


def test_chaos_parity_holds_with_tracing(tracing):
    obs.set_enabled(False)
    res_plain = run_chaos_trace(num_channels=4, ticks=6, kill_every=3,
                                device=DEV)
    obs.set_enabled(True)
    obs.clear()
    res = run_chaos_trace(num_channels=4, ticks=6, kill_every=3, device=DEV)
    assert res.kills == 1 and res.parity_checks == 1
    np.testing.assert_array_equal(res.joins, res_plain.joins)
    recs = obs.records()
    obs_export.validate_records(recs)
    restores = [r for r in recs if r["name"] == obs_names.EV_CKPT_RESTORE]
    assert [(r["attrs"]["step"], r["attrs"]["kind"]) for r in restores] == \
        [(3, "balancer")]
    saves = [r["attrs"]["step"] for r in recs
             if r["name"] == obs_names.EV_CKPT_SAVE]
    assert saves == list(range(1, 7))
    cycles = [r for r in recs if r["name"] == obs_names.SPAN_CHAOS_CYCLE]
    assert [(c["attrs"]["step"], c["attrs"]["kind"]) for c in cycles] == \
        [(3, "balancer")]
    # the restore happened inside its cycle
    (c,) = cycles
    (r,) = restores
    assert c["ts_us"] <= r["ts_us"] <= c["ts_us"] + c["dur_us"]
    assert obs_names.SPAN_SCHED_REFRESH in obs_export.span_kinds(recs)


def test_workflow_chaos_restore_event_carries_manifest_step(tracing):
    res = run_workflow_chaos_trace(_dag(), ticks=4, kill_every=2,
                                   device=DEV)
    assert res.kills == 1 and res.parity_checks == 1
    recs = obs.records()
    restores = [r for r in recs if r["name"] == obs_names.EV_CKPT_RESTORE]
    assert [(r["attrs"]["step"], r["attrs"]["kind"]) for r in restores] == \
        [(2, "workflow")]
    refreshes = [r for r in recs if r["name"] == obs_names.SPAN_SCHED_REFRESH]
    assert refreshes and all(r["attrs"]["kind"] == "workflow"
                             for r in refreshes)


def test_trace_state_not_checkpointed(tracing, tmp_path):
    from repro_torch.ckpt import save_pipeline
    from repro_torch.sched import UncertaintyAwareBalancer

    bal = UncertaintyAwareBalancer(num_channels=3, lam=0.05, explore=0.0,
                                   device=DEV)
    rng = np.random.default_rng(0)
    for _ in range(3):
        bal.observe(rng.uniform(8, 30, 3), np.full(3, 1 / 3))
    with obs.span(obs_names.SPAN_SCHED_REFRESH, kind="fleet"):
        bal.weights()
    path = save_pipeline(str(tmp_path), 1, bal)
    with open(f"{path}/meta.json") as f:
        manifest = f.read()
    assert "trace" not in manifest and "span" not in manifest
    (save,) = [r for r in obs.records()
               if r["name"] == obs_names.EV_CKPT_SAVE]
    assert save["attrs"] == {"step": 1, "kind": "balancer", "path": path}


# ---------------------------------------------------------------- parity
def _audit(recs):
    """The audit events, each as (name, its identifying attributes), and
    the drift values beside them."""
    keys = ("scope", "key", "cause", "kind", "instance", "source",
            "channel", "step")
    seq, drifts = [], []
    for r in recs:
        if r["type"] != "event":
            continue
        a = r["attrs"]
        seq.append((r["name"],) + tuple(a.get(k) for k in keys))
        drifts.append(a.get("drift"))
    return seq, drifts


def _assert_same_audit(port, ref):
    seq, drifts = _audit(port)
    # the JAX package also logs its jit compiles, which the port has not
    jseq, jdrifts = _audit([r for r in ref
                            if r["name"] != jnames.EV_KERNEL_COMPILE])
    assert seq == jseq
    for d, jd in zip(drifts, jdrifts):
        assert (d is None) == (jd is None)
        if d is not None:
            assert d == pytest.approx(jd, rel=1e-5, abs=1e-9)


def _engine_templates(stage, dag, edges):
    """Two templates, one with a join, in two families."""
    chain = dag([stage("a", mus=[1.0, 1.5], sigmas=[0.2, 0.3]),
                 stage("b", mus=[2.0, 2.5, 3.0], sigmas=[0.3, 0.4, 0.5])],
                edges=edges(["a", "b"]))
    diamond = dag([
        stage("s", mus=[1.2, 1.8], sigmas=[0.25, 0.35], family="lognormal"),
        stage("l", mus=[2.0, 2.6], sigmas=[0.4, 0.5], family="lognormal"),
        stage("r", mus=[1.9, 2.4], sigmas=[0.35, 0.45], family="lognormal"),
        stage("m", mus=[1.1, 1.4], sigmas=[0.2, 0.25], family="lognormal"),
    ], edges=[("s", "l"), ("s", "r"), ("l", "m"), ("r", "m")])
    return {"chain": chain, "diamond": diamond}


def test_engine_audit_events_are_the_references(both_tracing):
    kw = dict(max_live=6, settle_steps=1, num_t=128, seed=3, lam_var=0.02,
              dirty_tol=0.05, prior_obs=2)
    eng = WorkflowEngine(_engine_templates(Stage, StageDAG, linear_edges),
                         device=DEV, **kw)
    ref = JEngine(_engine_templates(jdag.Stage, jdag.StageDAG,
                                    jdag.linear_edges), **kw)
    for e in (eng, ref):
        e.sims["chain"].schedule_churn(2, "throttle", stage="a", idx=0,
                                       value=2.0)
    rng = np.random.default_rng(1)
    for _ in range(5):
        arr = [(("chain", "diamond")[int(rng.integers(2))],
                float(rng.uniform(2.0, 6.0))) for _ in range(3)]
        got, want = eng.tick(arr), ref.tick(arr)
        assert got["rows"] == want["rows"]
    port, jref = obs.records(), jobs.records()
    # an slo re-dirty carries the urgency's move as its drift value
    causes = {r["attrs"]["cause"] for r in port
              if r["name"] == obs_names.EV_DIRTY}
    assert {"admit", "slo"} <= causes, causes
    assert any(r["name"] == obs_names.EV_SLO_LAM for r in port)
    assert any(r["name"] == obs_names.EV_CHURN for r in port)
    _assert_same_audit(port, jref)
    assert jexport.validate_records(port) == len(port)


def test_chaos_audit_events_are_the_references(both_tracing):
    churn = [(2, "fail", 1), (5, "recover", 1)]
    res = run_chaos_trace(num_channels=4, ticks=6, kill_every=3, churn=churn,
                          seed=0, device=DEV)
    jres = j_run_chaos_trace(num_channels=4, ticks=6, kill_every=3,
                             churn=churn, seed=0)
    assert res.kills == jres.kills == 1
    port, jref = obs.records(), jobs.records()
    names = [r["name"] for r in port if r["type"] == "event"]
    assert names.count(obs_names.EV_CKPT_SAVE) == 6
    assert names.count(obs_names.EV_CHURN) == 2
    _assert_same_audit(port, jref)
    # the cycles are the same spans in both
    cyc = [(r["attrs"]["step"], r["attrs"]["kind"]) for r in port
           if r["name"] == obs_names.SPAN_CHAOS_CYCLE]
    jcyc = [(r["attrs"]["step"], r["attrs"]["kind"]) for r in jref
            if r["name"] == jnames.SPAN_CHAOS_CYCLE]
    assert cyc == jcyc == [(3, "balancer")]


# ---------------------------------------------------------------- the CLI
def test_serve_cli_trace_export(tmp_path):
    from repro_torch.launch import serve as cli

    prefix = str(tmp_path / "tr")
    was = obs.enabled()
    cli.main(["--engine", "--batches", "3", "--device", DEV,
              "--trace", prefix])
    assert obs.enabled() == was   # the CLI switched tracing back
    recs = obs_export.read_jsonl(prefix + ".jsonl")
    assert jexport.validate_records(recs) == len(recs)
    assert obs_names.SPAN_ENGINE_TICK in obs_export.span_kinds(recs)
    with open(prefix + ".perfetto.json") as fh:
        doc = json.load(fh)
    assert len(doc["traceEvents"]) == len(recs) + 1
    obs.clear()


def test_serve_trace_smoke_trace_section(tmp_path):
    from repro_torch.bench import serve_trace

    plain = serve_trace.run(smoke=True, ticks=6, device=DEV)
    assert "trace" not in plain
    with obs.capture():
        res = serve_trace.run(smoke=True, ticks=6, device=DEV,
                              out_dir=str(tmp_path))
    tr = res["trace"]
    assert tr["records"] > 0 and tr["dropped"] == 0
    assert {obs_names.SPAN_ENGINE_TICK, obs_names.SPAN_ENGINE_STAGE,
            obs_names.SPAN_SOLVER_PGD, obs_names.SPAN_KERNEL_LAUNCH,
            obs_names.SPAN_SIM_STEP} <= set(tr["span_kinds"])
    assert {obs_names.EV_DIRTY, obs_names.EV_SLO_LAM} <= \
        set(tr["event_types"])
    recs = obs_export.read_jsonl(tr["jsonl"])
    assert jexport.validate_records(recs) == tr["records"]
    assert isinstance(tr["overhead_pct"], float)
    # tracing changed nothing the experiment reports
    for k in ("latency", "counters", "slo", "live_instances"):
        assert res[k] == plain[k], k
    obs.clear()


# ---------------------------------------------------------------- emit sites
_EMITTERS = {"span", "timed_span", "event", "traced"}
_OBS_HEADS = {"obs", "_obs", "trace", "TRACER", "obs.trace"}
_NAME_MODULES = {"obs_names", "_obs_names", "names"}


def _emit_sites():
    for path in sorted(PORT.rglob("*.py")):
        if "obs" in path.relative_to(PORT).parts[:1]:
            continue   # the tracer itself
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call):
                continue
            f = node.func
            if not (isinstance(f, ast.Attribute) and f.attr in _EMITTERS):
                continue
            head = ast.unparse(f.value)
            if head in _OBS_HEADS:
                yield path, node


def test_every_emit_site_names_a_registered_constant():
    sites = list(_emit_sites())
    assert len(sites) >= 10, len(sites)
    for path, node in sites:
        where = f"{path.relative_to(ROOT)}:{node.lineno}"
        assert node.args, where
        first = node.args[0]
        assert isinstance(first, ast.Attribute) and isinstance(
            first.value, ast.Name) and first.value.id in _NAME_MODULES, \
            f"{where}: the record name must be an obs.names constant"
        assert getattr(obs_names, first.attr, None) in obs_names.ALL_NAMES, \
            f"{where}: {first.attr} is not in the registry"
