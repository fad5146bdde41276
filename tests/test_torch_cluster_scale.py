"""The port's fleet experiment (``bench/cluster_scale.py``) and the elastic
fleet scenario against the JAX package, on the CPU plain path.

* ``_run_policy`` at 16 channels for 40 steps (the hotspot at step 20),
  each policy in both packages on the same simulator seed: the realized
  join mean within 1e-3 relative (the restarts differ, see
  ``tests/test_torch_group.py``).
* The tick sections at ``--smoke`` shape (K=64, F=256, T=128), with their
  own gradient-parity asserts (relative L2 <= 1e-4); the auto-family tick
  picks the reference's family on the same history; the tick's moments and
  adjoints under normal, lognormal and drift against the reference's xla
  path on the same inputs.
* ``examples/elastic_fleet.py`` through the JAX package and
  ``bench/elastic_fleet.py`` through the port, in both mitigation modes, on
  the same simulator draws with the same PGD budget: the same decisions and
  fleet sizes, the join statistics to the tolerances stated there.
"""
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from benchmarks import cluster_scale as rcs  # noqa: E402
from repro_torch.bench import cluster_scale as tcs  # noqa: E402
from repro_torch.bench import common  # noqa: E402
from repro_torch.bench import elastic_fleet  # noqa: E402

DEV = "cpu"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("policy", ["equal", "inverse_mu", "frontier"])
def test_run_policy_matches_reference(policy):
    want = rcs._run_policy(16, policy, steps=40)
    got = tcs._run_policy(16, policy, steps=40, device=DEV)
    assert got[0] == pytest.approx(want[0], rel=1e-3)
    assert got[2] == pytest.approx(want[2], rel=1e-2)


def test_tick_sections_at_smoke_shape(monkeypatch, tmp_path):
    from repro_torch.kernels import autotune

    monkeypatch.setattr(common, "RESULTS_DIR", str(tmp_path))
    monkeypatch.setattr(tcs, "RESULTS_DIR", str(tmp_path))
    cache = tmp_path / "autotune_cache.json"
    monkeypatch.setattr(autotune, "_DEFAULT_CACHE_PATH", str(cache))
    saved = autotune.cache_state()
    try:
        res = tcs.main(["--smoke", "--ticks-only", "--json", "--device",
                        DEV])
    finally:
        autotune.clear_cache()
        autotune.load_cache_state(saved)
    assert res["grad_rel_l2"] <= 1e-4
    assert all(r <= 1e-4 for r in res["family_grad_rel_l2"].values())
    assert res["pgd_speedup_vs_autodiff"] > 0
    assert (tmp_path / "cluster_tick_kernel_smoke.csv").exists()
    doc = json.loads((tmp_path / "cluster_scale_smoke.json").read_text())
    assert set(tcs.SCHEMA_KEYS) <= set(doc) and doc["smoke"] is True
    assert doc["card"] is None and doc["device"] == "cpu"
    names = [e["name"] for e in doc["entries"]]
    for name in ("fwd_tick_kernel", "pgd_tick_fused",
                 "pgd_tick_autodiff_plain", "lognormal_tick_fused",
                 "drift_tick_fwd", "auto_tick_score_plus_fused",
                 "autotune_fused_plain_F256_K64_T128"):
        assert name in names
    for e in doc["entries"]:
        assert set(tcs.ENTRY_KEYS) <= set(e) and e["impl"] == "plain"
    assert {s["name"] for s in doc["skipped"]} == {
        "fwd_tick_pallas_interpret", "pgd_tick_fused_pallas_interpret"}
    # the sweep section filed its winner (rows per chunk, on the CPU)
    (sweep,) = [e for e in doc["entries"] if e["name"].startswith(
        "autotune_fused")]
    disk = json.loads(cache.read_text())["cpu"]
    assert [v["value"] for v in disk.values()] == [sweep["plan"]]

    # the reference's auto tick on the same history picks the same family
    rows, _ = rcs.tick_auto_family_compare(64, 256, 128)
    assert rows[0][3] == f"auto_tick_fixed_{res['auto_family']}_fused_xla"


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("fam_name", ["normal", "lognormal", "drift"])
def test_tick_outputs_match_the_reference_at_smoke_shape(fam_name,
                                                        monkeypatch):
    # the fleet tick's inputs at --smoke shape (K=64, F=256, T=128; the
    # drift rhos on ~3% of the fleet from default_rng(11)) through the
    # port's forward and fused calls and the reference's xla path: mu
    # rtol = atol = 1e-4, var rtol 1e-2 atol 1e-3, both adjoints relative
    # L2 1e-4 with the reference's erf in the port, which isolates the
    # algorithm, as tests/test_torch_frontier does (with each framework's
    # own erf the var adjoint reads 7.6e-4 to 8.0e-4 here)
    import jax
    import jax.numpy as jnp
    from repro.kernels import ops as jops
    from repro_torch.core import Drift
    from repro_torch.core import distributions as td
    from repro_torch.core.distributions import resolve_family
    from repro_torch.kernels import ops as tops

    def xla_erf(x):
        y = np.asarray(jax.lax.erf(jnp.asarray(x.detach().cpu().numpy())))
        return torch.tensor(y, device=x.device)

    monkeypatch.setattr(td, "_erf", xla_erf)
    K, F, T = 64, 256, 128
    W, mus, sgs = tcs._tick_problem(K, F, device=DEV)
    if fam_name == "drift":
        rng = np.random.default_rng(11)
        rho = np.where(rng.random(K) < 0.03, rng.uniform(0.5, 2.0, K), 0.0)
        assert rho.any()
        family = Drift(rho.astype(np.float32))
    else:
        family = fam_name
    dist_id, extra = resolve_family(family, K)
    extra = np.asarray(extra, np.float32)
    jW, jmus, jsgs = (jnp.asarray(x.numpy()) for x in (W, mus, sgs))
    jfam = (dist_id, jnp.asarray(extra))
    tfam = (dist_id, torch.tensor(extra))
    want_f = jops.frontier_moments(jW, jmus, jsgs, num_t=T, impl="xla",
                                   family=jfam)
    got_f = tops.frontier_moments(W, mus, sgs, num_t=T, device=DEV,
                                  family=tfam)
    want = jops.frontier_moments_with_grads(jW, jmus, jsgs, num_t=T,
                                            impl="xla", family=jfam)
    got = tops.frontier_moments_with_grads(W, mus, sgs, num_t=T, device=DEV,
                                           family=tfam)
    for g, w in ((got_f, want_f), (got[:2], want[:2])):
        np.testing.assert_allclose(g[0].numpy(), np.asarray(w[0]),
                                   rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(g[1].numpy(), np.asarray(w[1]),
                                   rtol=1e-2, atol=1e-3)
    assert _rel_l2(got[2].numpy(), want[2]) <= 1e-4
    assert _rel_l2(got[3].numpy(), want[3]) <= 1e-4


EF_PGD_STEPS = 10   # a solve's PGD budget in both packages (150 would
                    # take minutes on the CPU plain path)


def _reference_fleet(monkeypatch, mitigation):
    """``examples/elastic_fleet.py`` through the JAX package, its balancer
    at EF_PGD_STEPS and its policy in ``mitigation`` mode, reporting what
    the port's ``elastic_fleet.run`` reports (join times, flags, the
    quarantined and drifting channels, the fleet size after each step)."""
    import functools
    import importlib.util
    from repro.sched import StragglerPolicy, UncertaintyAwareBalancer
    from repro.sim import ClusterSim

    spec = importlib.util.spec_from_file_location(
        "elastic_fleet_example", ROOT / "examples" / "elastic_fleet.py")
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    seen = {"window": [], "fleet": [], "flagged": set(), "quarantined": set(),
            "rho": {}}

    class Sim(ClusterSim):
        def run_step(self, weights, rng=None):
            t, durs = super().run_step(weights, rng)
            seen["window"].append(t)
            return t, durs

    class Policy(StragglerPolicy):
        def record(self, durations, work):
            flagged = super().record(durations, work)
            if len(seen["fleet"]) >= elastic_fleet.SLOW_AT:
                seen["flagged"].update(flagged)
            seen["fleet"].append(self.balancer.num_channels)
            seen["quarantined"].update(self.quarantined)
            for i, r in self.drift_rhos.items():
                seen["rho"][i] = max(seen["rho"].get(i, 0.0), r)
            return flagged

    monkeypatch.setattr(example, "ClusterSim", Sim)
    monkeypatch.setattr(example, "StragglerPolicy",
                        functools.partial(Policy, mitigation=mitigation))
    monkeypatch.setattr(example, "UncertaintyAwareBalancer",
                        functools.partial(UncertaintyAwareBalancer,
                                          pgd_steps=EF_PGD_STEPS))
    example.main()
    w, fleet = seen["window"], seen["fleet"]
    return {"before": elastic_fleet._stats(w[20:60]),
            "after": elastic_fleet._stats(w[-40:]),
            "flagged_after_slow": sorted(seen["flagged"]),
            "quarantined_ever": sorted(seen["quarantined"]),
            "drift_rho_max": seen["rho"],
            "fleet_at": {"start": fleet[0],
                         "after_fail": fleet[elastic_fleet.FAIL_AT + 1],
                         "after_join": fleet[elastic_fleet.JOIN_AT + 1],
                         "end": fleet[-1]},
            "steps": len(w)}


@pytest.mark.parametrize("mitigation", ["quarantine", "drift"])
def test_elastic_fleet_scenario(monkeypatch, mitigation):
    # the scenario and its checks whole, in both packages on the same
    # ClusterSim(seed=5) draws with the same PGD budget: the same flags,
    # quarantines, drifting channels (rho 1e-3) and fleet sizes; the join
    # statistics before and after the chaos: mean 1e-3 and p99 1e-2
    # relative, as the policy comparison above, and var 5e-2. The solves
    # at K <= 16 take two random restarts, from a JAX key in the reference
    # and from the port's own generator: at 10 PGD steps the splits differ
    # slightly, and the variance of 40 joins moves by up to 2.4% (mean by
    # 3.4e-4, p99 by 5e-3)
    import functools
    from repro_torch.sched import UncertaintyAwareBalancer
    want = _reference_fleet(monkeypatch, mitigation)
    monkeypatch.setattr(elastic_fleet, "UncertaintyAwareBalancer",
                        functools.partial(UncertaintyAwareBalancer,
                                          pgd_steps=EF_PGD_STEPS))
    res = elastic_fleet.run(device=DEV, mitigation=mitigation)
    assert want["steps"] == elastic_fleet.STEPS
    assert elastic_fleet.SLOW_IDX in res["flagged_after_slow"]
    if mitigation == "quarantine":
        assert elastic_fleet.SLOW_IDX in res["quarantined_ever"]
    else:
        assert res["drift_rho_max"][elastic_fleet.SLOW_IDX] > 0.0
    assert res["fleet_at"] == {"start": 16, "after_fail": 15,
                               "after_join": 17, "end": 17}
    for key in ("flagged_after_slow", "quarantined_ever", "fleet_at"):
        assert res[key] == want[key], key
    assert res["drift_rho_max"] == pytest.approx(want["drift_rho_max"],
                                                 rel=1e-3)
    for key in ("before", "after"):
        assert res[key]["mean"] > 0 and res[key]["p99"] >= res[key]["mean"]
        assert res[key]["mean"] == pytest.approx(want[key]["mean"], rel=1e-3)
        assert res[key]["var"] == pytest.approx(want[key]["var"], rel=5e-2)
        assert res[key]["p99"] == pytest.approx(want[key]["p99"], rel=1e-2)
