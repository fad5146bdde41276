"""The port's continuous-batching serving engine against the JAX package.

* ``row_pgd_step`` on the same seeded stacked rows (every family): the
  moments at mu rtol 1e-4, var rtol 1e-2 / atol 1e-3, the stepped splits at
  atol 1e-4; pad rows and zero-padded channels stay exact.
* The engine as a whole: both packages serve the same arrivals for 6 ticks;
  per tick the admissions, retirements, rows and launches are equal, the
  row moments agree at the tolerances above, every live split at atol
  1e-4, the join latencies to 1e-4 relative, and the counters at the end.
* One stacked call per family group (spied at ``ops``), admission back
  pressure, deadline pressure, the dirty-instance protocol, a JSON round
  trip of ``state_dict`` with bitwise tick parity, and each package
  restoring and ticking the other's state.
* ``StreamingStat`` and ``ServeTelemetry``: the copied module matches the
  reference bit for bit, ``merge`` and the sampler's generator included.
* The serve_trace smoke run on the port against the JAX package's own
  smoke result, and the serving CLI's engine mode.
"""
import json
import os

import numpy as np
import pytest
import torch

import repro.workflow.dag as jdag
from repro.core.distributions import Drift as JDrift
from repro.serve import WorkflowEngine as JEngine
from repro.serve import engine as jengine
from repro.serve.telemetry import ServeTelemetry as JTelemetry
from repro.serve.telemetry import StreamingStat as JStat
import repro_torch.workflow as tw
from repro_torch import convert
from repro_torch.core.distributions import Drift, resolve_family
from repro_torch.kernels import ops
from repro_torch.sched import InstanceHeads, UncertaintyAwareBalancer
from repro_torch.serve import WorkflowEngine, row_pgd_step
from repro_torch.serve.telemetry import ServeTelemetry, StreamingStat

DEV = "cpu"
ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
TOL_MU = 1e-4
TOL_VAR = (1e-2, 1e-3)
TOL_W = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _templates(pkg=tw, drift=Drift):
    """Three tiny templates across three completion-time families."""
    normal = pkg.StageDAG([
        pkg.Stage("a", mus=[1.0, 1.5], sigmas=[0.2, 0.3]),
        pkg.Stage("b", mus=[2.0, 2.5, 3.0], sigmas=[0.3, 0.4, 0.5]),
    ], edges=pkg.linear_edges(["a", "b"]))
    logn = pkg.StageDAG([
        pkg.Stage("x", mus=[1.2, 1.8], sigmas=[0.25, 0.35],
                  family="lognormal"),
    ])
    drift_wf = pkg.StageDAG([
        pkg.Stage("r", mus=[1.5, 2.0, 2.4], sigmas=[0.3, 0.35, 0.4],
                  family=drift(0.3)),
    ])
    return {"normal_wf": normal, "logn_wf": logn, "drift_wf": drift_wf}


def _ref_templates():
    return _templates(jdag, JDrift)


def _engine(**kw):
    kw.setdefault("max_live", 8)
    kw.setdefault("settle_steps", 2)
    kw.setdefault("num_t", 128)
    kw.setdefault("seed", 3)
    return WorkflowEngine(_templates(), device=DEV, **kw)


def _arrivals(seed=0, ticks=6, per_tick=3):
    rng = np.random.default_rng(seed)
    names = ("normal_wf", "logn_wf", "drift_wf")
    out = []
    for _ in range(ticks):
        tick = []
        for _ in range(per_tick):
            tpl = names[int(rng.integers(3))]
            tick.append((tpl, float(rng.uniform(2.0, 6.0)))
                        if rng.random() < 0.5 else tpl)
        out.append(tick)
    return out


def _close_moments(mu, var, mu_ref, var_ref):
    np.testing.assert_allclose(mu, mu_ref, rtol=TOL_MU, atol=TOL_MU)
    np.testing.assert_allclose(var, var_ref, rtol=TOL_VAR[0],
                               atol=TOL_VAR[1])


# ------------------------------------------------------------ row_pgd_step
@pytest.mark.parametrize("family", ["normal", "lognormal", Drift(0.3),
                                    "defective"], ids=str)
def test_row_pgd_step_matches_the_reference(family):
    rng = np.random.default_rng(7)
    F, K, n = 16, 6, 11
    ks = rng.integers(2, K + 1, n)
    W = np.zeros((F, K), np.float32)
    mus = np.zeros((F, K), np.float32)
    sgs = np.zeros((F, K), np.float32)
    mask = np.zeros((F, K), np.float32)
    for j, k in enumerate(ks):
        W[j, :k] = rng.dirichlet(np.ones(k))
        mus[j, :k] = rng.uniform(1.0, 4.0, k)
        sgs[j, :k] = mus[j, :k] * rng.uniform(0.1, 0.3, k)
        mask[j, :k] = 1.0
    W[n:], mus[n:], sgs[n:], mask[n:] = W[0], mus[0], sgs[0], mask[0]
    fam = (("defective", np.stack([rng.uniform(0.02, 0.2, K),
                                   np.ones(K)]).astype(np.float32))
           if family == "defective" else family)
    dist_id, ex = resolve_family(fam, K)
    ex = np.repeat(np.asarray(ex, np.float32)[:, None], F, 1) * mask
    lam = rng.uniform(0.0, 2.0, F).astype(np.float32)
    lam[n:] = lam[0]
    m, v, W2 = row_pgd_step(W, mus, sgs, dist_id, ex, lam, mask, num_t=128,
                            device=DEV)
    jm, jv, jW2 = jengine.row_pgd_step(W, mus, sgs, dist_id, ex, lam, mask,
                                       num_t=128)
    assert m.dtype == v.dtype == W2.dtype == np.float64
    assert W2.shape == (F, K)
    _close_moments(m, v, jm, jv)
    np.testing.assert_allclose(W2, jW2, rtol=0, atol=TOL_W)
    # the stepped rows stay on their masked simplices; pad rows are row 0's
    np.testing.assert_allclose(W2.sum(1), 1.0, atol=1e-5)
    assert np.all(W2[mask == 0] == 0.0)
    assert np.array_equal(W2[n:], np.broadcast_to(W2[0], W2[n:].shape))


# ------------------------------------------------------------ the engine
def test_engine_trace_matches_the_reference():
    kw = dict(max_live=6, settle_steps=2, num_t=128, seed=3, lam_var=0.02,
              dirty_tol=0.08, prior_obs=2)
    eng = WorkflowEngine(_templates(), device=DEV, **kw)
    ref = JEngine(_ref_templates(), **kw)
    for arr in _arrivals(ticks=6, per_tick=4):
        got, want = eng.tick(arr), ref.tick(arr)
        for key in ("tick", "admitted", "live", "queue", "rows",
                    "launches"):
            assert got[key] == want[key], (key, got, want)
        assert [r["iid"] for r in got["retired"]] == \
            [r["iid"] for r in want["retired"]]
        for a, b in zip(got["retired"], want["retired"]):
            assert a["slo_miss"] == b["slo_miss"]
            assert a["join_latency_s"] == pytest.approx(b["join_latency_s"],
                                                        rel=1e-4)
        assert [(r.iid, r.stage) for r in eng.last_rows] == \
            [(r.iid, r.stage) for r in ref.last_rows]
        if eng.last_rows:
            _close_moments([r.mu for r in eng.last_rows],
                           [r.var for r in eng.last_rows],
                           [r.mu for r in ref.last_rows],
                           [r.var for r in ref.last_rows])
    assert eng.telemetry.counters == ref.telemetry.counters
    assert sorted(eng._live) == sorted(ref._live)
    assert eng._live, "the trace must end with instances in flight"
    for iid, inst in eng._live.items():
        for name, w in inst.weights.items():
            np.testing.assert_allclose(w, ref._live[iid].weights[name],
                                       rtol=0, atol=TOL_W)


def test_one_stacked_launch_per_family_group(monkeypatch):
    eng = _engine()
    for tpl in ("normal_wf", "normal_wf", "logn_wf", "drift_wf",
                "drift_wf"):
        eng.submit(tpl)
    calls = []
    orig = ops.frontier_moments_with_grads

    def spy(W, mus, sigmas, *, family, **kw):
        calls.append((family[0], tuple(W.shape)))
        return orig(W, mus, sigmas, family=family, **kw)

    monkeypatch.setattr(ops, "frontier_moments_with_grads", spy)
    out = eng.tick()
    fams = [c[0] for c in calls]
    # 5 admitted instances, 7 remaining stages, 3 families: one call per
    # family group, never one per instance
    assert out["admitted"] == 5 and out["rows"] == 7
    assert len(fams) == len(set(fams)), fams
    assert set(fams) == {"normal", "lognormal", "drift"}
    assert out["launches"] == len(fams)
    assert {s for _, s in calls} <= {(8, eng.kmax)}


def test_row_moments_match_solo_calls():
    # the kmax and bucket padding is exact: each row's priced moments are
    # those of an unpadded call on its own split
    eng = _engine()
    for tpl in ("normal_wf", "logn_wf", "drift_wf"):
        eng.submit(tpl)
    eng.tick()
    assert eng.last_rows
    for r in eng.last_rows:
        mu, var = ops.frontier_moments(
            np.asarray(r.w, np.float32)[None],
            np.asarray(r.mus, np.float32)[None],
            np.asarray(r.sigmas, np.float32)[None],
            num_t=eng.num_t, device=DEV, family=r.family)
        assert float(mu[0]) == pytest.approx(r.mu, rel=1e-5)
        assert float(var[0]) == pytest.approx(r.var, rel=1e-4, abs=1e-6)


# ------------------------------------------------------------ admission
def test_queue_backpressure_and_wait_telemetry():
    eng = _engine(max_live=2)
    for _ in range(5):
        eng.submit("logn_wf")
    out = eng.tick()
    # single-stage instances retire in the tick they run, freeing slots
    assert out["admitted"] == 2 and out["queue"] == 3
    out = eng.tick()
    assert out["admitted"] == 2 and out["queue"] == 1
    tel = eng.telemetry
    assert tel.counters["admitted"] == 4
    assert tel.stats["queue_wait_ticks"].count == 4
    assert tel.stats["queue_wait_ticks"].max() >= 1.0


def test_unknown_template_and_duplicate_admission_rejected():
    eng = _engine()
    with pytest.raises(ValueError, match="unknown template"):
        eng.submit("nope")
    with pytest.raises(ValueError, match="at least one template"):
        WorkflowEngine({}, device=DEV)
    heads = InstanceHeads({"t/s": UncertaintyAwareBalancer(
        num_channels=2, explore=0.0, device=DEV)})
    heads.admit(0, ["t/s"])
    with pytest.raises(ValueError, match="already"):
        heads.admit(0, ["t/s"])


def test_heads_fork_on_the_host_and_feed_the_prototype():
    eng = _engine()
    eng.submit("normal_wf")
    eng.tick()
    (iid,) = eng.heads.live
    head = eng.heads._bank[iid]["normal_wf/a"]
    proto = eng.heads.prototypes["normal_wf/a"]
    assert head.device.type == proto.device.type == "cpu"
    # one observation each; the prototype kept learning with the head
    assert head._obs_count == proto._obs_count == 1
    np.testing.assert_array_equal(head.estimates()[0], proto.estimates()[0])


# ------------------------------------------------------------ SLO, dirty set
def test_deadline_pressure_raises_row_lam():
    eng = _engine(lam_var=0.01, slo_gain=1.0)
    relaxed = eng.submit("normal_wf")                 # no SLO
    urgent = eng.submit("normal_wf", deadline=0.5)    # nearly no slack
    eng.tick()
    lam = {r.iid: r.lam for r in eng.last_rows}
    assert lam[relaxed] == pytest.approx(eng.lam_var)
    assert lam[urgent] > lam[relaxed]
    assert lam[urgent] <= eng.lam_var + eng.slo_gain * eng.slo_lam_cap


def test_settled_instances_contribute_no_rows():
    eng = _engine(settle_steps=1, dirty_tol=1e9)
    eng.submit("normal_wf")
    out1 = eng.tick()
    assert out1["launches"] >= 1 and out1["live"] == 1
    out2 = eng.tick()
    assert out2["rows"] == 0 and out2["launches"] == 0


def test_urgency_drift_redirties():
    eng = _engine(settle_steps=1, dirty_tol=1e-6, slo_gain=1.0)
    eng.submit("normal_wf", deadline=3.0)
    assert eng.tick()["launches"] >= 1
    out2 = eng.tick()
    assert out2["rows"] >= 1 and out2["launches"] >= 1


def test_posterior_drift_redirties():
    eng = _engine(settle_steps=3, dirty_tol=0.05)
    eng.submit("normal_wf")
    eng.tick()
    inst = next(iter(eng._live.values()))
    inst.steps_left = 0
    assert eng._posterior_drift(inst) <= eng.dirty_tol
    mu0, sg0 = inst.stat_snap["b"]
    inst.stat_snap["b"] = (mu0 * 2.0, sg0)   # 50% relative drift
    assert eng._posterior_drift(inst) == pytest.approx(0.5, rel=1e-6)
    eng._maybe_redirty(inst)
    assert inst.steps_left == eng.settle_steps


# ------------------------------------------------------------ state
def test_state_dict_json_round_trip_tick_parity():
    eng = _engine()
    for tpl in ("normal_wf", "logn_wf", "drift_wf", "normal_wf"):
        eng.submit(tpl, deadline=6.0)
    eng.tick()
    state = json.loads(json.dumps(eng.state_dict()))
    assert state["config"]["impl"] == "xla"
    assert "device" not in state["config"]
    eng2 = WorkflowEngine.from_state_dict(state, _templates(), device=DEV)
    for arr in _arrivals(seed=5, ticks=3):
        assert eng.tick(arr) == eng2.tick(arr)
        for iid, inst in eng._live.items():
            for name, w in inst.weights.items():
                np.testing.assert_array_equal(
                    w, eng2._live[iid].weights[name])
    # every stream but the solver's wall clock repeats
    s1, s2 = eng.telemetry.summary(), eng2.telemetry.summary()
    del s1["solver_tick_us"], s2["solver_tick_us"]
    assert s1 == s2


def _run_on(eng, ref, arrivals):
    """Tick both engines on the same arrivals; hold them to each other."""
    for arr in arrivals:
        got, want = eng.tick(arr), ref.tick(arr)
        for key in ("admitted", "live", "queue", "rows", "launches"):
            assert got[key] == want[key], (key, got, want)
        assert [r["iid"] for r in got["retired"]] == \
            [r["iid"] for r in want["retired"]]
    for iid, inst in eng._live.items():
        for name, w in inst.weights.items():
            np.testing.assert_allclose(w, ref._live[iid].weights[name],
                                       rtol=0, atol=TOL_W)
    assert eng.telemetry.counters == ref.telemetry.counters


def test_port_state_restores_and_ticks_in_the_reference():
    eng = _engine()
    for arr in _arrivals(seed=1, ticks=2):
        eng.tick(arr)
    assert eng._live
    ref = JEngine.from_state_dict(json.loads(json.dumps(eng.state_dict())),
                                  _ref_templates())
    assert ref.impl == "xla"
    _run_on(eng, ref, _arrivals(seed=2, ticks=3))


def test_reference_state_restores_and_ticks_in_the_port():
    ref = JEngine(_ref_templates(), max_live=8, settle_steps=2, num_t=128,
                  seed=3)
    for arr in _arrivals(seed=3, ticks=2):
        ref.tick(arr)
    assert ref._live and ref.queue_depth == 0
    eng = convert.workflow_engine_from_reference(ref, device=DEV)
    assert eng.device.type == "cpu" and eng.tick_count == ref.tick_count
    _run_on(eng, ref, _arrivals(seed=4, ticks=3))


# ------------------------------------------------------------ telemetry
def _feed(stat, xs):
    for x in xs:
        stat.add(x)


def test_streaming_stat_is_the_reference_bit_for_bit():
    rng = np.random.default_rng(0)
    xs, ys = rng.lognormal(0.0, 1.0, 300), rng.normal(5.0, 2.0, 170)
    a, ja = StreamingStat(capacity=64, seed=4), JStat(capacity=64, seed=4)
    b, jb = StreamingStat(capacity=64, seed=9), JStat(capacity=64, seed=9)
    _feed(a, xs)
    _feed(ja, xs)
    _feed(b, ys)
    _feed(jb, ys)
    assert a.summary() == ja.summary()
    assert a.state_dict() == ja.state_dict()
    a.merge(b)
    ja.merge(jb)
    assert a.summary() == ja.summary()
    sd = a.state_dict()
    assert sd == ja.state_dict()
    # the sampler's generator rides the state: the restored stat samples on
    # exactly as the reference's does
    c = StreamingStat.from_state_dict(json.loads(json.dumps(sd)))
    jc = JStat.from_state_dict(json.loads(json.dumps(sd)))
    _feed(c, xs[:50])
    _feed(jc, xs[:50])
    _feed(a, xs[:50])
    assert c.state_dict() == jc.state_dict() == a.state_dict()
    with pytest.raises(ValueError, match="capacities differ"):
        a.merge(StreamingStat(capacity=8))
    empty = StreamingStat(capacity=64)
    assert empty.summary()["p99"] == 0.0
    assert empty.merge(a).summary() == a.summary()


def test_serve_telemetry_is_the_reference():
    t, jt = ServeTelemetry(capacity=16, seed=2), JTelemetry(capacity=16,
                                                            seed=2)
    rng = np.random.default_rng(1)
    for x in rng.uniform(0, 3, 40):
        for tel in (t, jt):
            tel.add("join_latency_s", x)
            tel.add("rows_per_launch", 2 * x)
            tel.bump("retired")
    assert t.summary() == jt.summary()
    back = ServeTelemetry.from_state_dict(
        json.loads(json.dumps(jt.state_dict())))
    assert back.summary() == jt.summary()


# ------------------------------------------------------------ entry points
def test_serve_trace_smoke_matches_the_reference_result():
    # the JAX package's committed smoke result (benchmarks/serve_trace.py
    # --smoke --json): the same seeded trace through the port on the CPU
    from repro_torch.bench import serve_trace
    res = serve_trace.run(ticks=serve_trace.SMOKE_TICKS, smoke=True,
                          device=DEV)
    with open(os.path.join(ROOT, "BENCH_serve_trace_smoke.json")) as fh:
        want = json.load(fh)
    assert res["counters"] == want["counters"]
    assert res["slo"] == want["slo"]
    assert res["live_instances"] == want["live_instances"]
    for key in ("mean", "p50", "p99", "max"):
        assert res["latency"][key] == pytest.approx(want["latency"][key],
                                                     rel=1e-4)
    assert res["batched_vs_looped_ratio"] > 1.0


def test_serve_cli_engine_mode():
    from repro_torch.launch import serve
    eng = serve.main(["--engine", "--batches", "6", "--device", "cpu",
                      "--deadline", "4.0"])
    c = eng.telemetry.counters
    assert c["ticks"] == 6 and c["admitted"] > 0
    assert c["launches"] <= 2 * 6   # two families: one call each per tick
