"""The port's examples and suite harness (``bench/quickstart.py``,
``file_transfer.py``, ``partitioned_training.py``, ``serve_partitioned.py``,
``run.py``) beside the repository's ``examples/`` and ``benchmarks/`` on the
JAX package, on the same numpy draws, on the CPU plain path; and the
acceptance gates of ``dag_scale`` and ``cluster_scale``.

Each reference runs whole (its own asserts included) with its simulator
recorded; each port module runs with the reference's asserts. Splits of
two or four channels come from solves with random restarts (a JAX key in
the reference, the port's own generator), so a policy's joins agree as
the elastic fleet's do (``tests/test_torch_cluster_scale.py``): mean 1e-3,
p99 1e-2 and variance 5e-2 relative; a fixed split ("equal") gives the
same joins bit for bit. Solves are held as in
``tests/test_torch_workflow.py`` (makespan 1e-4 relative), the engine demo
print for print, and its mid-trace kill/restore against an unkilled run
bit for bit (every tick and the telemetry, all but the host clock's
solver-tick times). Files go to ``tmp_path``.
"""
import importlib.util
import json
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from repro_torch.bench import cluster_scale as tcs  # noqa: E402
from repro_torch.bench import common  # noqa: E402
from repro_torch.bench import dag_scale as tds  # noqa: E402
from repro_torch.bench import file_transfer  # noqa: E402
from repro_torch.bench import partitioned_training as tpt  # noqa: E402
from repro_torch.bench import quickstart  # noqa: E402
from repro_torch.bench import run as harness  # noqa: E402
from repro_torch.bench import serve_partitioned as tsp  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402

DEV = "cpu"


@pytest.fixture(autouse=True)
def _results_in_tmp(monkeypatch, tmp_path):
    monkeypatch.setattr(common, "RESULTS_DIR", str(tmp_path))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _example(name):
    spec = importlib.util.spec_from_file_location(
        f"{name}_example", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _recording_sim(base, sink):
    """``base`` (a ClusterSim or WorkflowSim class) whose steps append
    their join times to ``sink``."""
    step = "run_dag_step" if hasattr(base, "run_dag_step") else "run_step"

    def record(self, *a, **k):
        out = getattr(base, step)(self, *a, **k)
        sink.append(float(out[0]))
        return out

    return type(f"Recording{base.__name__}", (base,), {step: record})


def _stats(x):
    x = np.asarray(x)
    return {"mean": float(x.mean()), "var": float(x.var()),
            "p99": float(np.percentile(x, 99))}


def _joins_close(got, want):
    assert got["mean"] == pytest.approx(want["mean"], rel=1e-3)
    assert got["p99"] == pytest.approx(want["p99"], rel=1e-2)
    assert got["var"] == pytest.approx(want["var"], rel=5e-2)


# ----------------------------------------------------------- quickstart
def test_quickstart_matches_the_reference(monkeypatch, capsys):
    from repro.core import frontier_2ch as j_frontier_2ch
    from repro.core import optimize_2ch as j_optimize_2ch
    ex = _example("quickstart")
    joins = []
    monkeypatch.setattr(ex, "ClusterSim", _recording_sim(ex.ClusterSim,
                                                         joins))
    ex.main()
    got = quickstart.run(device=DEV)
    capsys.readouterr()
    want_res = j_frontier_2ch(30.0, 2.0, 20.0, 6.0, num_f=101)
    res = got["frontier"]
    np.testing.assert_allclose(res.mu, want_res.mu, rtol=1e-4)
    np.testing.assert_allclose(res.var, want_res.var, rtol=1e-3)
    assert np.array_equal(res.efficient, np.asarray(want_res.efficient))
    want_dec = j_optimize_2ch(30.0, 2.0, 20.0, 6.0, lam=0.1)
    np.testing.assert_allclose(got["optimize_2ch"].weights,
                               np.asarray(want_dec.weights), atol=1e-6)
    steps, burn = quickstart.STEPS, quickstart.BURN_IN
    for i, policy in enumerate(quickstart.POLICIES):
        want = _stats(joins[i * steps + burn:(i + 1) * steps])
        if policy == "equal":
            assert got["policies"][policy]["mean"] == want["mean"]
            assert got["policies"][policy]["p99"] == want["p99"]
        _joins_close(got["policies"][policy], want)
    fr = got["policies"]["frontier"]
    assert fr["mean"] < got["policies"]["equal"]["mean"]


# -------------------------------------------------------- file transfer
FT_STEPS, FT_TRIALS = 40, 300


def test_file_transfer_matches_the_reference(monkeypatch, capsys):
    import repro.sim
    import repro.workflow
    ex = _example("file_transfer")
    seen, mc = {}, []
    solve = repro.workflow.solve_dag

    def solve_dag(*a, **k):
        k["steps"] = FT_STEPS
        seen["dec"] = solve(*a, **k)
        return seen["dec"]

    monkeypatch.setattr(repro.workflow, "solve_dag", solve_dag)
    monkeypatch.setattr(repro.sim, "WorkflowSim",
                        _recording_sim(repro.sim.WorkflowSim, mc))
    monkeypatch.setattr(sys, "argv", ["file_transfer.py", "--trials",
                                      str(FT_TRIALS)])
    ex.main()
    got = file_transfer.run(device=DEV, trials=FT_TRIALS, steps=FT_STEPS)
    capsys.readouterr()
    want = seen["dec"]
    assert got["decision"].makespan_mu == pytest.approx(want.makespan_mu,
                                                        rel=1e-4)
    np.testing.assert_allclose(got["weights"], want.weights["transfer"],
                               atol=1e-2)
    assert got["single"].makespan_mu < got["equal"].makespan_mu * 2
    assert got["mc_mean"] == pytest.approx(float(np.mean(mc)), rel=1e-3)
    assert got["mc_rel_mu_err"] < 0.05


# ------------------------------------------------ partitioned training
def test_harness_runs_parttrain_beside_the_reference(monkeypatch, capsys,
                                                     tmp_path):
    from benchmarks import partitioned_training as rpt
    rows = {}
    monkeypatch.setattr(rpt, "save_table", lambda *a, **k: None)
    monkeypatch.setattr(rpt, "emit", lambda *a, **k: None)
    want = rpt.run()
    harness.main(["--only", "parttrain", "--device", DEV])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "name,us_per_call,derived"
    assert [r.split(",")[0] for r in out[1:]] == [
        f"parttrain_{p}" for p in tpt.POLICIES]
    table = (tmp_path / "partitioned_training.csv").read_text().splitlines()
    assert table[0] == "policy,join_mu,join_var,micro_per_s"
    for line in table[1:]:
        p, mu, var, thr = line.split(",")
        rows[p] = (float(mu), float(var), float(thr))
    assert rows["equal"] == pytest.approx(want["equal"], rel=1e-12)
    for p in ("inverse_mu", "frontier"):
        assert rows[p][0] == pytest.approx(want[p][0], rel=1e-3)
        assert rows[p][1] == pytest.approx(want[p][1], rel=5e-2)
        assert rows[p][2] == pytest.approx(want[p][2], rel=1e-3)


def test_harness_reports_a_failing_suite_and_keeps_going(monkeypatch,
                                                          capsys):
    ran = []

    def suite(name, fail):
        def run(device):
            ran.append((name, device))
            if fail:
                raise RuntimeError(f"{name} broke")
        return types.SimpleNamespace(run=run)

    monkeypatch.setattr(harness, "SUITES", {"a": suite("a", True),
                                            "b": suite("b", False)})
    with pytest.raises(SystemExit) as exc:
        harness.main(["--device", DEV])
    assert exc.value.code == 1
    assert ran == [("a", DEV), ("b", DEV)]
    assert "FAILED suites: ['a']" in capsys.readouterr().err


def test_harness_roofline_names_its_roadmap_item(monkeypatch, tmp_path,
                                                capsys):
    """The roofline suite (ROADMAP 13a) tabulates the dry run's records; a
    cell the port does not run names its item and passes the gate (a
    synthetic record: since 12g every cell of the matrix runs, with and
    without ``--seq-parallel``)."""
    import json
    from repro_torch.bench import common, roofline_table
    rec_dir = tmp_path / "dryrun"
    rec_dir.mkdir()
    terms = {"compute_s": 1.0, "memory_s": 2.0, "collective_s": 0.5,
             "dominant": "memory_s", "roofline_fraction": 0.5}
    for i, rec in enumerate((
            {"arch": "a", "shape": "s", "mesh": "m", "status": "ok",
             "roofline": terms, "useful_flops_ratio": 0.25},
            {"arch": "w", "shape": "s", "mesh": "m", "status": "not_ported",
             "reason": "ROADMAP.md section 1, item 12g"})):
        (rec_dir / f"{i}.json").write_text(json.dumps(rec))
    monkeypatch.setattr(roofline_table, "DRYRUN_DIR", str(rec_dir))
    monkeypatch.setattr(common, "RESULTS_DIR", str(tmp_path))
    harness.main(["--only", "roofline", "--device", DEV])
    assert "skipped=0;not_ported=1;failed=0" in capsys.readouterr().out
    table = (tmp_path / "roofline_table.csv").read_text().splitlines()
    assert table[1].split(",")[3:8] == ["ok", "1.0000", "2.0000", "0.5000",
                                        "memory"]
    assert "NOT_PORTED" in table[2] and "item 12g" in table[2]


# ------------------------------------------------------------- serving
SERVE_BATCHES = 24


def test_serve_batcher_matches_the_reference(monkeypatch, capsys):
    import repro.sim
    ex = _example("serve_partitioned")
    joins = []
    monkeypatch.setattr(repro.sim, "ClusterSim",
                        _recording_sim(repro.sim.ClusterSim, joins))
    monkeypatch.setattr(sys, "argv", ["serve_partitioned.py", "--batches",
                                      str(SERVE_BATCHES)])
    ex.main()
    cfg = get_config(tsp.ARCH).tiny()
    got = tsp.run_batcher(cfg, batches=SERVE_BATCHES, execute=True,
                          device=DEV)
    dry = tsp.run_batcher(cfg, batches=SERVE_BATCHES, device=DEV)
    capsys.readouterr()
    for i, policy in enumerate(tsp.POLICIES):
        want = joins[i * SERVE_BATCHES + tsp.BURN_IN:
                     (i + 1) * SERVE_BATCHES]
        lat = got["latencies"][policy]
        if policy == "equal":
            assert np.array_equal(lat, np.asarray(want))
        _joins_close(_stats(lat), _stats(want))
        # generating does not move the split or the joins
        assert np.array_equal(lat, dry["latencies"][policy])
    # --execute: the first frontier batches generated on both groups
    assert len(got["generated"]) == tsp.EXECUTE_BATCHES
    for g in got["generated"]:
        for c, resp in zip(g["counts"], g["responses"]):
            if c:
                assert resp.shape == (c, 8)
                assert resp.min() >= 0 and resp.max() < cfg.vocab_size
    assert got["tokens"] == 2 * 64 * 8 and not dry["generated"]


ENGINE_TICKS = 12


def _no_clock(summary):
    return {k: v for k, v in summary.items() if k != "solver_tick_us"}


def test_engine_demo_matches_the_reference_and_restores_bitwise(
        tmp_path, capsys):
    ex = _example("serve_partitioned")
    ex.run_engine_demo(ticks=ENGINE_TICKS)
    want = capsys.readouterr().out
    killed = tsp.run_engine_demo(ticks=ENGINE_TICKS, device=DEV,
                                 ckpt_dir=str(tmp_path / "a"))
    got = capsys.readouterr().out
    assert got == want
    assert "-- kill/restore at tick" in got
    whole = tsp.run_engine_demo(ticks=ENGINE_TICKS, device=DEV,
                                ckpt_dir=str(tmp_path / "b"), kill=False)
    assert killed["ticks"] == whole["ticks"]
    assert _no_clock(killed["summary"]) == _no_clock(whole["summary"])
    # its own checkpoint directory lives under RESULTS_DIR and is removed
    tsp.run_engine_demo(ticks=2, device=DEV)
    assert list(Path(common.RESULTS_DIR).glob("serve_partitioned_ckpt_*")) \
        == []


# --------------------------------------------------------------- gates
def _dag_res(**over):
    res = {"single_batched_path": True, "family_groups": 1,
           "improvement_pct": 0.2047,
           "joint_vs_greedy_wallclock_ratio": 0.5,
           "scale_point": {"stages": 512}}
    res.update(over)
    return res


DAG_BREAKS = {
    "two family groups": {"single_batched_path": False, "family_groups": 2},
    "improvement": {"improvement_pct": 0.08},
    "wall clock": {"joint_vs_greedy_wallclock_ratio": 1.001},
    "scale point": {"scale_point": {"stages": 256}},
}


def test_dag_gates_pass_a_result_that_keeps_them():
    tds.check_gates(_dag_res())
    tds.check_gates(_dag_res(joint_vs_greedy_wallclock_ratio=1.0,
                             improvement_pct=0.088))


@pytest.mark.parametrize("broken", sorted(DAG_BREAKS))
def test_dag_gates_raise_on_each_broken_gate(broken):
    with pytest.raises(AssertionError):
        tds.check_gates(_dag_res(**DAG_BREAKS[broken]))


def test_dag_main_writes_then_gates_at_full_scale(monkeypatch, tmp_path):
    res = _dag_res(joint_vs_greedy_wallclock_ratio=1.2,
                   realized_improvement_pct=0.1, weights={})
    monkeypatch.setattr(tds, "run", lambda **k: res)
    out = tmp_path / "dag.json"
    with pytest.raises(AssertionError, match="1.2"):
        tds.main(["--json", "--device", DEV, "--out", str(out)])
    assert json.loads(out.read_text())["joint_vs_greedy_wallclock_ratio"] \
        == 1.2
    tds.main(["--smoke", "--device", DEV])    # the smoke scale is not gated


@pytest.mark.parametrize("ratio,ok", [(1.05, True), (1.2, True),
                                      (1.2001, False), (4.787, False)])
def test_cluster_gate(ratio, ok):
    res = {"auto_family_tick_overhead": ratio}
    if ok:
        tcs.check_gates(res)
    else:
        with pytest.raises(AssertionError, match="1.2x bound"):
            tcs.check_gates(res)


def test_cluster_main_gates_at_full_scale(monkeypatch):
    res = {"auto_family_tick_overhead": 5.202}
    monkeypatch.setattr(tcs, "run", lambda **k: res)
    with pytest.raises(AssertionError, match="5.202"):
        tcs.main(["--device", DEV])
    tcs.main(["--smoke", "--device", DEV])
