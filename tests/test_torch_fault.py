"""The port's fault tolerance (``ckpt/store.py``, ``sim/chaos.py``,
``bench/fault_trace.py``), the counterpart of ``tests/test_fault.py``.

* Kill/restore tick parity within the port: a balancer, a workflow
  balancer, a serving batcher and a ``WorkflowEngine`` with instances in
  flight, each rebuilt from a ``save_pipeline`` manifest, make a next tick
  bitwise identical to the survivor's. Bitwise equality across the two
  packages is not required; their states cross both ways (a port manifest
  restores in the JAX package, a JAX engine manifest in the port) and tick
  on within 1e-4 (splits) with equal counters.
* The store: manifests of all three kinds with their errors, the autotune
  snapshot riding the manifest, tensor leaves (bf16 included) restored bit
  for bit, a missing leaf and a shape mismatch naming the key, a damaged
  pointer, and ``CheckpointManager``'s retention and host copy.
* The chaos harness on a normal and a defective fleet and on a workflow,
  parity held at every kill.
* The fault_trace smoke run: the failure-aware solve beats the blind one,
  and the run is the JAX package's committed smoke result to 1e-5.
"""
import json
import os

import numpy as np
import pytest
import torch

from repro.ckpt import restore_pipeline as j_restore_pipeline
from repro.ckpt import save_pipeline as j_save_pipeline
import repro.workflow.dag as jdag
from repro.serve import WorkflowEngine as JEngine
from repro_torch.ckpt import (CheckpointManager, latest_step, restore,
                              restore_pipeline, save, save_pipeline)
from repro_torch.kernels import autotune
from repro_torch.sched import UncertaintyAwareBalancer, WorkflowBalancer
from repro_torch.serve import WorkflowEngine
from repro_torch.sim import ClusterSim
from repro_torch.sim.chaos import run_chaos_trace, run_workflow_chaos_trace
from repro_torch.workflow import Stage, StageDAG, linear_edges

DEV = "cpu"
ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _seeded_balancer(k=4, seed=0, **kw):
    kw.setdefault("lam", 0.05)
    kw.setdefault("pgd_steps", 40)
    kw.setdefault("explore", 0.0)
    b = UncertaintyAwareBalancer(num_channels=k, device=DEV, **kw)
    rng = np.random.default_rng(seed)
    for _ in range(5):
        b.observe(rng.uniform(8, 30, k), np.full(k, 1.0 / k))
    return b


def _dag(k=3):
    rng = np.random.default_rng(7)
    stages = [Stage("a", rng.uniform(10, 30, k), rng.uniform(1, 4, k)),
              Stage("b", rng.uniform(10, 30, k), rng.uniform(1, 4, k))]
    return StageDAG(stages, linear_edges(["a", "b"]))


def _engine_templates(pkg=None):
    """Two mixed-family templates (the port's, or the JAX package's)."""
    S, D, E = ((Stage, StageDAG, linear_edges) if pkg is None
               else (pkg.Stage, pkg.StageDAG, pkg.linear_edges))
    wf = D([
        S("a", mus=[1.0, 1.5], sigmas=[0.2, 0.3]),
        S("b", mus=[2.0, 2.6, 3.2], sigmas=[0.3, 0.4, 0.5]),
    ], edges=E(["a", "b"]))
    fan = D([
        S("src", mus=[1.2, 1.7], sigmas=[0.25, 0.3], family="lognormal"),
        S("left", mus=[2.1, 2.8], sigmas=[0.4, 0.5], family="lognormal"),
        S("right", mus=[1.9, 2.5], sigmas=[0.35, 0.45], family="lognormal"),
    ], edges=[("src", "left"), ("src", "right")])
    return {"wf": wf, "fan": fan}


def _seeded_workflow_balancer(dag, seed=0, **kw):
    kw.setdefault("pgd_steps", 30)
    wb = WorkflowBalancer(dag=dag, device=DEV, **kw)
    rng = np.random.default_rng(seed)
    w = {s.name: np.full(s.k, 1.0 / s.k) for s in dag.stages}
    for _ in range(4):
        wb.observe({s.name: rng.uniform(8, 30, s.k) for s in dag.stages}, w)
    return wb


def _busy_engine(cls=WorkflowEngine, templates=None, **kw):
    """An engine mid-flight: live instances and a backed-up queue."""
    eng = cls(templates or _engine_templates(), max_live=4, settle_steps=2,
              num_t=128, seed=7, **kw)
    for i in range(6):
        eng.submit("wf" if i % 2 else "fan", deadline=6.0)
    eng.tick()
    assert eng.live_count > 0 and eng.queue_depth > 0
    return eng


# ------------------------------------------------------------ parity
def test_balancer_tick_parity(tmp_path):
    b = _seeded_balancer()
    save_pipeline(str(tmp_path), 3, b)
    w_survivor = b.weights()
    b2, inflight, meta = restore_pipeline(str(tmp_path), device=DEV)
    assert inflight is None and meta["step"] == 3
    np.testing.assert_array_equal(w_survivor, b2.weights())
    obs = np.array([12.0, 25.0, 18.0, 30.0])
    b.observe(obs, w_survivor)
    b2.observe(obs, w_survivor)
    np.testing.assert_array_equal(b.weights(), b2.weights())


def test_workflow_balancer_tick_parity(tmp_path):
    dag = _dag()
    wb = _seeded_workflow_balancer(dag)
    wb.handle_failure("a", 1)   # the failure set survives the crash too
    save_pipeline(str(tmp_path), 1, wb)
    w_survivor = wb.weights()
    wb2, _, _ = restore_pipeline(str(tmp_path), dag=dag, device=DEV)
    w_replica = wb2.weights()
    assert wb2.failed_channels() == {"a": [1]}
    for n in w_survivor:
        np.testing.assert_array_equal(w_survivor[n], w_replica[n])
    assert w_replica["a"][1] == 0.0


def test_partitioned_batcher_tick_parity(tmp_path):
    from repro_torch.serve import PartitionedBatcher, ReplicaGroup
    groups = [ReplicaGroup(name=f"g{i}") for i in range(3)]
    pb = PartitionedBatcher(groups, lam=0.02, seed=5, device=DEV)
    prompts = np.zeros((18, 4), np.int32)
    for _ in range(2):
        pb.run_batch(prompts)
    save_pipeline(str(tmp_path), 2, pb.balancer,
                  inflight={"sim": pb.sim.state_dict()})
    join_sv, counts_sv, _ = pb.run_batch(prompts)
    bal2, inflight, _ = restore_pipeline(str(tmp_path), device=DEV)
    pb2 = PartitionedBatcher(groups, device=DEV)
    pb2.balancer = bal2
    pb2.sim = ClusterSim.from_state_dict(inflight["sim"])
    join_rp, counts_rp, _ = pb2.run_batch(prompts)
    assert join_sv == join_rp
    np.testing.assert_array_equal(counts_sv, counts_rp)


def test_engine_kill_restore_tick_parity(tmp_path):
    templates = _engine_templates()
    eng = _busy_engine(device=DEV)
    save_pipeline(str(tmp_path), eng.tick_count, eng)
    eng2, _, _ = restore_pipeline(str(tmp_path), templates=templates,
                                  device=DEV)
    for _ in range(3):
        assert eng.tick() == eng2.tick()
        for iid, inst in eng._live.items():
            for name, w in inst.weights.items():
                np.testing.assert_array_equal(
                    w, eng2._live[iid].weights[name])


@pytest.mark.parametrize("kind", ["workflow", "engine", "none"])
def test_manifest_kinds_and_their_errors(tmp_path, kind):
    d = str(tmp_path)
    if kind == "workflow":
        save_pipeline(d, 1, _seeded_workflow_balancer(_dag()))
        with pytest.raises(ValueError, match="dag="):
            restore_pipeline(d, device=DEV)
    elif kind == "engine":
        eng = WorkflowEngine(_engine_templates(), num_t=128, device=DEV)
        save_pipeline(d, 1, eng)
        with pytest.raises(ValueError, match="templates="):
            restore_pipeline(d, device=DEV)
    else:
        save(d, 1, {"x": np.zeros(2)})
        with pytest.raises(ValueError, match="pipeline"):
            restore_pipeline(d, device=DEV)
        return
    with open(os.path.join(d, "step_00000001", "meta.json")) as fh:
        assert json.load(fh)["pipeline"]["kind"] == kind


# ------------------------------------------------------------ across packages
def test_port_manifest_restores_in_the_reference(tmp_path):
    b = _seeded_balancer(k=3, seed=2)
    save_pipeline(str(tmp_path), 4, b)
    jb, _, meta = j_restore_pipeline(str(tmp_path), autotune=False)
    assert meta["step"] == 4
    np.testing.assert_allclose(jb.weights(), b.weights(), rtol=0, atol=1e-3)


def test_reference_engine_manifest_runs_on_in_the_port(tmp_path):
    ref = _busy_engine(JEngine, _engine_templates(jdag))
    j_save_pipeline(str(tmp_path), ref.tick_count, ref)
    eng, _, _ = restore_pipeline(str(tmp_path), templates=_engine_templates(),
                                 autotune=False, device=DEV)
    for _ in range(3):
        got, want = eng.tick(), ref.tick()
        for key in ("admitted", "live", "queue", "rows", "launches"):
            assert got[key] == want[key]
    for iid, inst in eng._live.items():
        for name, w in inst.weights.items():
            np.testing.assert_allclose(w, ref._live[iid].weights[name],
                                       rtol=0, atol=1e-4)
    assert eng.telemetry.counters == ref.telemetry.counters


# ------------------------------------------------------------ the store
def test_autotune_state_rides_the_manifest(tmp_path):
    key = autotune._key(8, 3, 64, "split", "grad", "defective")
    saved = autotune.cache_state()
    autotune.clear_cache()
    try:
        autotune._CACHE[key] = {"value": [4, 8, 32, 4], "source": "model"}
        save_pipeline(str(tmp_path), 1, _seeded_balancer(k=3, seed=1))
        autotune.clear_cache()
        assert key not in autotune.cache_state()
        restore_pipeline(str(tmp_path), device=DEV)
        assert autotune.lookup_split(8, 3, 64, mode="grad",
                                     dist_id="defective") == (4, 8, 32, 4)
        autotune.clear_cache()
        restore_pipeline(str(tmp_path), autotune=False, device=DEV)
        assert key not in autotune.cache_state()
    finally:
        autotune.clear_cache()
        autotune.load_cache_state(saved)


def test_tensor_leaves_restore_bit_for_bit(tmp_path):
    g = torch.Generator().manual_seed(0)
    tree = {"w": torch.randn(3, 4, generator=g),
            "h": [torch.randn(5, generator=g).bfloat16(),
                  np.arange(6, dtype=np.int32)],
            "skip": None, "s": 2.5}
    save(str(tmp_path), 1, tree)
    got, meta = restore(str(tmp_path), tree)
    assert meta["step"] == 1 and got["skip"] is None
    assert torch.equal(got["w"], tree["w"])
    assert got["h"][0].dtype == torch.bfloat16
    assert torch.equal(got["h"][0], tree["h"][0])
    np.testing.assert_array_equal(got["h"][1], tree["h"][1])
    assert float(got["s"]) == 2.5


def test_missing_leaf_names_the_key(tmp_path):
    save(str(tmp_path), 1, {"a": np.zeros(3), "b": np.ones((2, 2))})
    with pytest.raises(ValueError, match=r"leaf 'c' missing"):
        restore(str(tmp_path), {"a": np.zeros(3), "c": np.zeros(2)})


def test_shape_mismatch_names_leaf_and_shapes(tmp_path):
    save(str(tmp_path), 1, {"a": {"b": torch.zeros(3)}})
    with pytest.raises(ValueError,
                       match=r"'a/b'.*expected \(4,\).*found \(3,\)"):
        restore(str(tmp_path), {"a": {"b": torch.zeros(4)}})


def test_latest_step_survives_pointer_damage(tmp_path):
    d = str(tmp_path)
    save(d, 1, {"x": np.zeros(2)})
    save(d, 2, {"x": np.zeros(2)})
    ptr = os.path.join(d, "LATEST")
    for damage in ("garbage", ""):
        with open(ptr, "w") as f:
            f.write(damage)
        assert latest_step(d) == 2
    os.remove(ptr)
    assert latest_step(d) == 2
    # an incomplete step directory is not a restore candidate
    os.makedirs(os.path.join(d, "step_00000009"))
    assert latest_step(d) == 2
    assert latest_step(str(tmp_path / "nowhere")) is None
    with pytest.raises(FileNotFoundError):
        restore(str(tmp_path / "nowhere"), {})


def test_manifest_carries_inflight_and_model_tree(tmp_path):
    b = _seeded_balancer()
    tree = {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3)}
    save_pipeline(str(tmp_path), 5, b, inflight={"done": [0.1, 0.2, 0, 0]},
                  tree=tree, meta={"note": "mid-flight"})
    b2, inflight, meta = restore_pipeline(
        str(tmp_path), template={"w": torch.zeros(2, 3)}, device=DEV)
    assert inflight == {"done": [0.1, 0.2, 0, 0]}
    assert meta["note"] == "mid-flight"
    assert torch.equal(meta["tree"]["w"], tree["w"])
    np.testing.assert_array_equal(b.weights(), b2.weights())


def test_checkpoint_manager(tmp_path):
    b = _seeded_balancer()
    d = str(tmp_path / "pipe")
    mgr = CheckpointManager(d, interval=2, keep=2)
    saved = [s for s in range(1, 7)
             if mgr.maybe_save_pipeline(s, b, blocking=True)]
    assert saved == [2, 4, 6]
    assert latest_step(d) == 6
    assert len([p for p in os.listdir(d) if p.startswith("step_")]) == 2
    b2, _, _ = restore_pipeline(d, device=DEV)
    np.testing.assert_array_equal(b.weights(), b2.weights())
    # the tree is copied to the host before the writer runs: a tensor the
    # caller changes right after the call is saved as it was
    d2 = str(tmp_path / "tree")
    mgr2 = CheckpointManager(d2, interval=1, keep=3)
    x = torch.ones(1000)
    assert mgr2.maybe_save(1, {"x": x})
    x.mul_(3.0)
    mgr2.wait()
    got, _ = restore(d2, {"x": torch.zeros(1000)})
    assert torch.equal(got["x"], torch.ones(1000))
    assert not mgr2.maybe_save(1.5, {"x": x})


# ------------------------------------------------------------ chaos
@pytest.mark.parametrize("dist,ticks,kill_every,churn,kills", [
    ("normal", 9, 3, [(4, "fail", 1), (7, "recover", 1)], 2),
    ("defective", 6, 2, None, 2)])
def test_chaos_trace_holds_parity(dist, ticks, kill_every, churn, kills):
    res = run_chaos_trace(num_channels=5, ticks=ticks, kill_every=kill_every,
                          churn=churn, seed=2, dist=dist, device=DEV)
    assert res.kills == kills and res.parity_checks == kills
    assert len(res.joins) == ticks and all(j > 0 for j in res.joins)
    assert res.final_failed == []
    assert res.summary()["parity_checks"] == kills


def test_workflow_chaos_trace_holds_parity():
    dag = StageDAG([
        Stage("s1", mus=[10.0, 14.0, 18.0], sigmas=[1.0, 1.5, 2.0]),
        Stage("s2", mus=[12.0, 16.0], sigmas=[1.2, 1.8]),
    ], edges=linear_edges(["s1", "s2"]))
    res = run_workflow_chaos_trace(
        dag, ticks=6, kill_every=3, seed=1,
        churn=[(2, "fail", "s1", 0, None), (5, "recover", "s1", 0, None)],
        device=DEV)
    assert res.kills == 1 and res.parity_checks == 1
    assert len(res.joins) == 6 and all(j > 0 for j in res.joins)
    assert res.final_failed == []


# ------------------------------------------------------------ fault_trace
def test_fault_trace_smoke_aware_beats_blind():
    from repro_torch.bench import fault_trace
    res = fault_trace.run(ticks=fault_trace.SMOKE_TICKS, smoke=True,
                          device=DEV)
    assert res["mean_fail_p"] >= 0.05
    assert res["improvement_pct"] > 0
    with open(os.path.join(ROOT, "BENCH_fault_trace_smoke.json")) as fh:
        want = json.load(fh)
    assert res["mean_fail_p"] == want["mean_fail_p"]
    assert res["improvement_pct"] == pytest.approx(want["improvement_pct"],
                                                   rel=1e-5)
    for name in ("blind", "aware"):
        assert res["makespan"][name]["mean"] == pytest.approx(
            want["makespan"][name]["mean"], rel=1e-5)
