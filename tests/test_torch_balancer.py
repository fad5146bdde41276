"""The port's simulator and closed-loop balancer against the JAX package.

* ``ClusterSim``: identical weights and seed give bitwise-identical
  durations in every regime (the port makes the same numpy draws).
* The slice as a whole: a JAX balancer runs 5 warm-up ticks, the port's
  balancer is built from its ``state_dict`` (``convert``), and both are
  driven for 20 more ticks by simulators with one seed. Their weights agree
  to atol 1e-3 on every tick (``tests/test_frontier_grads.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.sched import UncertaintyAwareBalancer as JBalancer
from repro.sim import ClusterSim as JSim
from repro_torch import convert
from repro_torch.core import partitioner
from repro_torch.sched import UncertaintyAwareBalancer, integerize
from repro_torch.sim import Channel, ClusterSim


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # the tensors here are tiny: intra-op threads only contend with the
    # other test workers
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


DEV = "cpu"


@pytest.mark.parametrize("dist", ["normal", "lognormal", "drift",
                                  "defective"])
def test_cluster_sim_durations_are_bitwise_identical(dist):
    a = ClusterSim.heterogeneous(9, seed=4, dist=dist)
    b = JSim.heterogeneous(9, seed=4, dist=dist)
    a.channels[2].drift = b.channels[2].drift = 0.01
    for sim in (a, b):
        sim.schedule_churn(2, "fail", 1)
        sim.schedule_churn(3, "throttle", 4, 2.5)
        sim.schedule_churn(4, "set_load", value=1.5)
        sim.schedule_churn(5, "recover", 1)
    rng = np.random.default_rng(0)
    for step in range(7):
        w = rng.dirichlet(np.ones(9))
        ja, da = a.run_step(w)
        jb, db = b.run_step(w)
        assert ja == jb and np.array_equal(da, db)
    ja, da = a.run_step(w, rng=11)
    jb, db = b.run_step(w, rng=11)
    assert np.array_equal(da, db)
    sd = b.state_dict()
    c = convert.sim_from_reference(sd)
    assert c.run_step(w)[1].tolist() == b.run_step(w)[1].tolist()
    assert ClusterSim.from_state_dict(a.state_dict()).state_dict().keys() \
        == sd.keys()
    ch = Channel(mu=10.0, sigma=1.0, dist="defective", fail_p=0.3)
    assert ch.sample(np.random.default_rng(1), 0.5) > 0.0
    with pytest.raises(ValueError):
        Channel(mu=1.0, sigma=0.1, dist="empirical")


def _warm_reference(family, K=8, seed=3):
    jb = JBalancer(num_channels=K, lam=0.02, pgd_steps=30, num_t=256,
                   family=family, prior_mean=20.0)
    js = JSim.heterogeneous(K, seed=seed,
                            dist="lognormal" if family == "lognormal"
                            else "drift")
    for _ in range(5):
        w = jb.weights()
        _, d = js.run_step(w)
        jb.observe(d, w)
    return jb, js


@pytest.mark.parametrize("family", ["lognormal", "auto"])
def test_closed_loop_matches_reference_tick_by_tick(family, monkeypatch):
    K = 8
    jb, js = _warm_reference(family, K)
    # the reference draws its two PGD restarts from PRNGKey(0) every solve;
    # the port's solver takes the same rows here
    starts = np.asarray(jax.random.dirichlet(jax.random.PRNGKey(0),
                                             jnp.ones((K,)), (2,)))

    def jax_starts(k, restarts, rng):
        assert (k, restarts, rng) == (K, 2, None)
        return starts

    monkeypatch.setattr(partitioner, "_dirichlet_starts", jax_starts)
    tb = convert.balancer_from_reference(jb.state_dict(), device=DEV)
    ts = convert.sim_from_reference(js.state_dict())
    for tick in range(20):
        wj, wt = jb.weights(), tb.weights()
        np.testing.assert_allclose(wt, wj, atol=1e-3, err_msg=f"tick {tick}")
        assert tb.selected_family.dist_id == jb.selected_family.dist_id
        _, dj = js.run_step(wj)
        _, dt = ts.run_step(wt)
        jb.observe(dj, wj)
        tb.observe(dt, wt)
    sd = tb.state_dict()
    assert sd.keys() == jb.state_dict().keys()
    again = UncertaintyAwareBalancer.from_state_dict(sd, device=DEV)
    assert again.state_dict() == sd
    np.testing.assert_array_equal(again.weights(), tb.weights())


def test_balancer_policies_adaptive_refresh_and_inflight():
    K = 6
    sim = ClusterSim.heterogeneous(K, seed=2)
    bal = UncertaintyAwareBalancer(K, lam=0.02, pgd_steps=20, num_t=128,
                                   adaptive_refresh=True, risk_lam=0.5,
                                   prior_mean=20.0, device=DEV)
    for _ in range(4):
        w = bal.weights()
        _, d = sim.run_step(w)
        bal.observe(d, w)
    assert bal._last_rel_fragility is not None
    assert 1 <= bal.effective_refresh <= bal.refresh_every
    out = bal.resolve_inflight(np.full(K, 0.05), failed=[2])
    assert out[2] == 0.0 and abs(out.sum() - 1.0) < 1e-6
    assert integerize(out, 100).sum() == 100
    mu, var = bal.predicted_moments()
    assert np.isfinite(mu) and mu > 0 and var >= 0
    for policy in ("equal", "inverse_mu"):
        b = UncertaintyAwareBalancer(K, policy=policy, device=DEV)
        assert abs(b.weights().sum() - 1.0) < 1e-6
    bal.add_channel()
    assert bal.num_channels == K + 1 and bal.estimates()[0].shape == (K + 1,)
    bal.remove_channel(0)
    assert bal.num_channels == K and bal._cached_w is None
    two = UncertaintyAwareBalancer(2, device=DEV)
    assert two.weights().shape == (2,)


def test_integerize_matches_reference():
    from repro.sched import integerize as jint
    rng = np.random.default_rng(5)
    for _ in range(5):
        w = rng.dirichlet(np.ones(7))
        assert np.array_equal(integerize(w, 97), jint(w, 97))


def _jax_starts(monkeypatch, K):
    """The reference draws its two PGD restarts from PRNGKey(0) every solve;
    the port's solver takes the same rows."""
    starts = np.asarray(jax.random.dirichlet(jax.random.PRNGKey(0),
                                             jnp.ones((K,)), (2,)))
    monkeypatch.setattr(partitioner, "_dirichlet_starts",
                        lambda k, restarts, rng: starts)


@pytest.mark.parametrize("via", ["balancer", "batcher"])
def test_port_state_restores_and_solves_in_the_reference(via, monkeypatch):
    # a port checkpoint must load in the reference and solve there: its
    # "impl" names the reference's plain path, never the port's device
    from repro.serve import PartitionedBatcher as JBatcher
    from repro.serve import ReplicaGroup as JGroup
    from repro_torch.serve import PartitionedBatcher, ReplicaGroup
    K = 4
    _jax_starts(monkeypatch, K)
    if via == "balancer":
        bal = UncertaintyAwareBalancer(K, lam=0.02, pgd_steps=30, num_t=256,
                                       prior_mean=20.0, device=DEV)
        sim = ClusterSim.heterogeneous(K, seed=6)
        for _ in range(5):
            w = bal.weights()
            _, d = sim.run_step(w)
            bal.observe(d, w)
        sd = bal.state_dict()
        ref = JBalancer.from_state_dict(sd)
    else:
        port = PartitionedBatcher([ReplicaGroup(f"g{i}", None)
                                   for i in range(K)], num_t=256, seed=6,
                                  device=DEV)
        prompts = np.zeros((40, 4), np.int32)
        for _ in range(5):
            port.run_batch(prompts)
        sd = port.state_dict()
        jb = JBatcher([JGroup(f"g{i}", None, None) for i in range(K)],
                      num_t=256, seed=6)
        jb.load_state_dict(sd)
        bal, ref = port.balancer, jb.balancer
        sd = sd["balancer"]
    assert sd["impl"] == ref.impl == "xla"
    np.testing.assert_allclose(ref.weights(), bal.weights(), atol=1e-3)
