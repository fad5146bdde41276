"""The port's workflow runtime (``WorkflowSim``, ``WorkflowBalancer``)
against the JAX package.

* ``WorkflowSim``: the same DAG, seed and splits give bitwise-identical
  makespans, completions and durations, churn included (the port makes the
  same numpy draws); its ``state_dict`` round-trips, across packages too.
* The slice as a whole: a JAX ``WorkflowBalancer`` on a 5-stage DAG runs 5
  warm-up ticks, the port's is built from its ``state_dict``
  (``convert``), and both are driven for 10 more ticks by simulators with
  one seed. Their weights agree to atol 1e-3 on every tick, as
  ``tests/test_torch_balancer.py`` holds the single-stage loop. A port
  balancer's ``state_dict`` restores in the JAX package, which solves.
"""
import numpy as np
import pytest
import torch

import repro.workflow as jw
from repro.sched import WorkflowBalancer as JWBalancer
from repro.sim import WorkflowSim as JWSim
import repro_torch.workflow as tw
from repro_torch import convert
from repro_torch.sched import WorkflowBalancer
from repro_torch.sim import WorkflowSim
from repro_torch.workflow import solve as tsolve

DEV = "cpu"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _five(pkg, seed=0, k=4, families=("normal",) * 5):
    """src -> {a, b} -> c -> sink, with c also fed by src: a 3-way join."""
    rng = np.random.default_rng(seed)
    stages = []
    for i, (name, fam) in enumerate(zip(("src", "a", "b", "c", "sink"),
                                        families)):
        mus = rng.uniform(10.0, 40.0, k + i % 2)
        stages.append(pkg.Stage(name, mus, mus * rng.uniform(0.05, 0.3,
                                                             mus.shape),
                                family=fam))
    edges = [("src", "a"), ("src", "b"), ("a", "c"), ("b", "c"),
             ("src", "c"), ("c", "sink")]
    return pkg.StageDAG(stages, edges)


def _churn(sim):
    sim.schedule_churn(2, "fail", stage="a", idx=1)
    sim.schedule_churn(3, "throttle", stage="c", idx=0, value=2.5)
    sim.schedule_churn(4, "set_load", value=1.5)
    sim.schedule_churn(5, "recover", stage="a", idx=1)
    sim.schedule_churn(5, "set_load", stage="sink", value=0.8)


@pytest.mark.parametrize("families", [("normal",) * 5,
                                      ("normal", "lognormal", "normal",
                                       "lognormal", "normal")])
def test_workflow_sim_traces_are_bitwise_the_reference(families):
    jd, td = _five(jw, 3, families=families), _five(tw, 3, families=families)
    js, ts = JWSim.from_dag(jd, seed=4), WorkflowSim.from_dag(td, seed=4)
    _churn(js)
    _churn(ts)
    rng = np.random.default_rng(0)
    for step in range(7):
        w = {s.name: rng.dirichlet(np.ones(s.k)) for s in td.stages}
        shared = 100 + step if step % 2 else None
        mj, cj, dj = js.run_dag_step(jd, w, rng=shared)
        mt, ct, dt = ts.run_dag_step(td, w, rng=shared)
        assert mt == mj and ct == cj
        assert all(np.array_equal(dt[n], dj[n]) for n in dj)
        for u, v in td.edges:
            assert ct[v] >= ct[u]
    sd = js.state_dict()
    assert ts.state_dict().keys() == sd.keys()
    crossed = convert.workflow_sim_from_reference(sd)
    again = WorkflowSim.from_state_dict(ts.state_dict())
    w = {s.name: np.full(s.k, 1.0 / s.k) for s in td.stages}
    want = js.run_dag_step(jd, w)
    for sim in (crossed, again):
        got = sim.run_dag_step(td, w)
        assert got[0] == want[0] and got[1] == want[1]


def test_workflow_sim_drift_and_defective_regimes_follow_the_dag():
    from repro_torch.core.distributions import Defective, Drift
    k = 4
    rng = np.random.default_rng(1)
    stages = [tw.Stage("p", rng.uniform(5, 9, k), np.full(k, 0.5),
                       family=Drift(np.full(k, 0.4, np.float32))),
              tw.Stage("q", rng.uniform(5, 9, k), np.full(k, 0.5),
                       family=Defective(np.full(k, 0.1, np.float32)))]
    dag = tw.StageDAG(stages, [("p", "q")])
    sim = WorkflowSim.from_dag(dag, seed=2)
    assert [c.dist for c in sim.stage_sims["p"].channels] == ["drift"] * k
    assert sim.stage_sims["q"].channels[0].fail_p == pytest.approx(0.1)
    with pytest.raises(ValueError, match="unknown stage"):
        sim.schedule_churn(1, "fail", stage="zz", idx=0)
    with pytest.raises(ValueError, match="needs a stage"):
        sim.schedule_churn(1, "fail", idx=0)
    with pytest.raises(ValueError, match="needs a value"):
        sim.schedule_churn(1, "set_load")
    sim.set_load(2.0, stage="q")
    mk, comp, _ = sim.run_dag_step(dag, {s.name: np.full(k, 0.25)
                                         for s in stages}, rng=3)
    assert mk == comp["q"] > comp["p"] > 0


def _drive(bal, sim, dag, ticks, weights_log):
    for _ in range(ticks):
        w = bal.weights()
        weights_log.append(w)
        _, _, durs = sim.run_dag_step(dag, w)
        bal.observe(durs, w)


@pytest.mark.parametrize("risk", [False, True])
def test_closed_loop_matches_the_reference_tick_by_tick(risk):
    kw = dict(refresh_every=2, pgd_steps=20, num_t=128, restarts=0,
              family="normal", prior_mean=20.0)
    if risk:
        kw.update(adaptive_refresh=True, risk_lam=0.5, refresh_every=3,
                  pgd_steps=12)
    jd, td = _five(jw, 5), _five(tw, 5)
    jb = JWBalancer(jd, **kw)
    js = JWSim.from_dag(jd, seed=6)
    _drive(jb, js, jd, 5, [])
    tb = convert.workflow_balancer_from_reference(jb.state_dict(), jd,
                                                  device=DEV)
    ts = convert.workflow_sim_from_reference(js.state_dict())
    js.schedule_churn(js.step_count + 4, "throttle", stage="b", idx=0,
                      value=3.0)
    ts.schedule_churn(ts.step_count + 4, "throttle", stage="b", idx=0,
                      value=3.0)
    for tick in range(10):
        wj, wt = jb.weights(), tb.weights()
        assert set(wt) == set(wj)
        for n in wj:
            np.testing.assert_allclose(wt[n], wj[n], atol=1e-3,
                                       err_msg=f"tick {tick} stage {n}")
        assert tb.effective_refresh == jb.effective_refresh
        _, _, dj = js.run_dag_step(jd, wj)
        _, _, dt = ts.run_dag_step(td, wt)
        jb.observe(dj, wj)
        tb.observe(dt, wt)
    sd = tb.state_dict()
    assert sd.keys() == jb.state_dict().keys()
    again = WorkflowBalancer.from_state_dict(sd, td, device=DEV)
    assert again.state_dict() == sd
    for n, w in tb.weights().items():
        np.testing.assert_array_equal(again.weights()[n], w)


def test_port_state_restores_and_solves_in_the_reference():
    td = _five(tw, 7)
    bal = WorkflowBalancer(td, refresh_every=2, pgd_steps=15, num_t=128,
                           restarts=0, family="normal", prior_mean=20.0,
                           device=DEV)
    _drive(bal, WorkflowSim.from_dag(td, seed=8), td, 4, [])
    sd = bal.state_dict()
    assert sd["impl"] == "xla" and sd["kind"] == "workflow"
    assert all(e["impl"] == "xla" for e in sd["est"].values())
    ref = JWBalancer.from_state_dict(sd, _five(jw, 7))
    assert ref.impl == "xla"
    bal._obs_count = ref._obs_count = 0     # both re-solve now
    wr, wp = ref.weights(), bal.weights()
    for n in wr:
        np.testing.assert_allclose(wp[n], wr[n], atol=1e-3)


def test_min_weight_floor_and_failure_masking_match_the_reference():
    kw = dict(pgd_steps=10, num_t=128, restarts=0, family="normal",
              min_weight=0.05, prior_mean=20.0)
    jb, tb = JWBalancer(_five(jw, 9), **kw), WorkflowBalancer(
        _five(tw, 9), device=DEV, **kw)
    jb.handle_failure("b", 2)
    tb.handle_failure("b", 2)
    wj, wt = jb.weights(), tb.weights()
    assert tb.failed_channels() == jb.failed_channels() == {"b": [2]}
    for n in wj:
        np.testing.assert_allclose(wt[n], wj[n], atol=1e-3)
        assert abs(wt[n].sum() - 1.0) < 1e-9
    assert wt["b"][2] == 0.0
    assert all((w[w > 0] >= 0.05 - 1e-9).all() for w in wt.values())
    at, aj = tb.assign(101), jb.assign({n: 101 for n in wj})
    assert all(at[n].sum() == 101 and np.abs(at[n] - aj[n]).max() <= 1
               for n in wj)
    inflight = tb.resolve_inflight({"a": np.array([0.2, 0.1, 0.0, 0.0, 0.1]),
                                    "b": np.zeros(4)})
    assert inflight["b"][2] == 0.0
    assert all(abs(w.sum() - 1.0) < 1e-5 for w in inflight.values())
    mu, var = tb.predicted_moments()
    jmu, jvar = jb.predicted_moments()
    assert mu == pytest.approx(jmu, rel=1e-4) and var >= 0.0
    tb.handle_recovery("b", 2)
    jb.handle_recovery("b", 2)
    assert tb.failed_channels() == {} and tb._solve_key() == jb._solve_key()
    with pytest.raises(KeyError):
        tb.handle_failure("ghost", 0)


def test_incremental_ticks_resolve_only_dirty_stages(monkeypatch):
    calls = []
    real = tsolve.solve_dag

    def spy(dag, **kw):
        calls.append(kw.get("dirty"))
        return real(dag, **kw)

    monkeypatch.setattr(tsolve, "solve_dag", spy)
    td = _five(tw, 10)
    # risk_lam > 0 puts the fragility on every solve and the wide target
    # keeps the incremental gate open
    bal = WorkflowBalancer(td, refresh_every=1, pgd_steps=10, num_t=128,
                           restarts=0, family="normal", risk_lam=1e-6,
                           refresh_target_rel=100.0, device=DEV)
    w0 = bal.weights()
    assert calls == [None]
    w0b = bal.weights()
    assert len(calls) == 1          # nothing drifted: no solver call
    assert all(np.array_equal(w0[n], w0b[n]) for n in w0)
    for _ in range(4):
        bal.observe({"b": np.full(4, 5.0)}, {"b": w0["b"]})
    w1 = bal.weights()
    assert calls[-1] == {"b"}
    assert all(np.array_equal(w0[n], w1[n]) for n in w0 if n != "b")
    sd = bal.state_dict()
    assert set(sd["solve_stats"]) == set(td.names)
    b2 = WorkflowBalancer.from_state_dict(sd, td, device=DEV)
    n_calls = len(calls)
    w2 = b2.weights()
    assert len(calls) == n_calls
    assert all(np.array_equal(w1[n], w2[n]) for n in w1)
