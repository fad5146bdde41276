"""The port's ``StragglerPolicy`` against the JAX package's, on the CPU
plain path: the cases of ``tests/test_sched.py`` (TestStraggler),
``tests/test_families.py`` (drift mitigation) and ``tests/test_fault.py``
(soft failure and sim wiring), each run through both packages on the same
observations.

Equal in both: the flagged lists, offenses, quarantine, the failed set and
the drift rhos (rtol 1e-5: float32 posteriors); the weights, and the
balancer's cached warm start after a quarantine zeroed it in place, within
1e-3 (``tests/test_frontier_grads.py``; the restarts come from a JAX key
in one and a numpy generator in the other).
"""
import numpy as np
import pytest
import torch

from repro.sched import StragglerPolicy as JPolicy
from repro.sched import UncertaintyAwareBalancer as JBalancer
from repro.sim import ClusterSim as JSim
from repro_torch.sched import StragglerPolicy, UncertaintyAwareBalancer
from repro_torch.sim import ClusterSim

DEV = "cpu"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class Pair:
    """One policy per package, built alike and fed alike."""

    def __init__(self, k, bal_kw=None, **pol_kw):
        bal_kw = bal_kw or {}
        self.j = JPolicy(JBalancer(k, **bal_kw), **pol_kw)
        self.t = StragglerPolicy(
            UncertaintyAwareBalancer(k, device=DEV, **bal_kw), **pol_kw)

    def record(self, durations, work):
        a = self.t.record(durations, work)
        b = self.j.record(durations, work)
        assert a == b
        self.same_state()
        return a

    def same_state(self):
        t, j = self.t, self.j
        assert t.offenses == j.offenses
        assert t.quarantined == j.quarantined
        assert t.failed == j.failed
        assert t.step == j.step
        assert sorted(t.drift_rhos) == sorted(j.drift_rhos)
        for i, r in j.drift_rhos.items():
            assert t.drift_rhos[i] == pytest.approx(r, rel=1e-5)

    def weights(self):
        a, b = self.t.weights(), self.j.weights()
        np.testing.assert_allclose(a, b, atol=1e-3)
        return a


def test_acute_straggler_flagged_quarantined_and_warm_start_zeroed():
    p = Pair(2, z_threshold=2.5, quarantine_after=2)
    for _ in range(30):
        p.record([10.0, 12.0], [0.5, 0.5])
    flagged = []
    for _ in range(3):   # channel 1 degrades 5x
        flagged = p.record([10.0, 60.0], [0.5, 0.5])
    assert 1 in flagged and 1 in p.t.quarantined
    w = p.weights()
    assert w[1] == 0.0 and abs(w.sum() - 1.0) < 1e-9
    # weights() zeroed the balancer's cached warm start in place, in both
    # packages alike
    assert p.t.balancer._cached_w[1] == 0.0
    np.testing.assert_allclose(p.t.balancer._cached_w,
                               p.j.balancer._cached_w, atol=1e-3)


def test_quarantine_zeroes_the_cached_warm_start_at_k4():
    # a PGD solve (K > 2): the array weights() zeroes is the cache the next
    # warm-started solve starts from
    p = Pair(4, bal_kw={"pgd_steps": 40}, z_threshold=2.5,
             quarantine_after=2)
    rng = np.random.default_rng(0)
    for _ in range(25):
        p.record(rng.uniform(9.5, 10.5, 4) * 0.25, np.full(4, 0.25))
    p.weights()
    for _ in range(2):
        p.record([2.5, 2.5, 15.0, 2.5], np.full(4, 0.25))
    assert 2 in p.t.quarantined
    w = p.weights()
    assert w[2] == 0.0
    assert p.t.balancer._cached_w is not None
    assert p.t.balancer._cached_w[2] == 0.0 == p.j.balancer._cached_w[2]
    np.testing.assert_allclose(p.t.balancer._cached_w,
                               p.j.balancer._cached_w, atol=1e-3)
    p.record([2.5, 2.6, 2.4, 2.5], np.full(4, 0.25))
    p.weights()   # the warm-started re-solve from the zeroed split


def test_probation_restores_channel():
    p = Pair(2, z_threshold=2.0, quarantine_after=1, probation_period=5)
    for _ in range(20):
        p.record([10.0, 12.0], [0.5, 0.5])
    p.record([10.0, 80.0], [0.5, 0.5])
    assert 1 in p.t.quarantined
    for _ in range(6):
        p.record([10.0, 12.0], [0.5, 0.5])
    assert 1 not in p.t.quarantined


def test_hard_failure_removes_and_reindexes():
    p = Pair(4, bal_kw={"pgd_steps": 30, "explore": 0.0}, z_threshold=2.5,
             quarantine_after=1)
    for _ in range(12):
        p.record([2.5, 2.6, 2.4, 2.5], np.full(4, 0.25))
    p.record([2.5, 2.6, 2.4, 9.0], np.full(4, 0.25))
    assert 3 in p.t.quarantined
    for pol in (p.t, p.j):
        pol.fail(2, remove=False)
        pol.fail(1)                        # hard removal shifts indices down
    p.same_state()
    assert p.t.failed == {1} and p.t.quarantined == {2: 13}
    assert p.t.balancer.num_channels == 3 == p.j.balancer.num_channels
    w = p.weights()
    assert w.shape == (3,) and w[1] == 0.0 and w[2] == 0.0


def test_drift_mitigation_keeps_channel():
    p = Pair(3, bal_kw={"lam": 0.01, "pgd_steps": 60}, z_threshold=2.5,
             mitigation="drift")
    for _ in range(30):
        p.record([10.0, 10.2, 9.8], np.full(3, 1.0 / 3))
    w_before = p.weights()
    for _ in range(4):   # channel 0 straggles hard
        p.record([40.0, 10.2, 9.8], np.full(3, 1.0 / 3))
    assert 0 in p.t.drift_rhos and p.t.drift_rhos[0] > 0
    assert not p.t.quarantined
    fam_t, fam_j = p.t.family(), p.j.family()
    np.testing.assert_allclose(fam_t.rho, fam_j.rho, rtol=1e-5)
    w_after = p.weights()
    assert 0.0 < w_after[0] < w_before[0]   # discounted, not dropped
    for _ in range(30):
        p.record([10.0, 10.2, 9.8], np.full(3, 1.0 / 3))
    assert 0 not in p.t.drift_rhos and p.t.family() is None


def test_bad_mitigation_raises():
    with pytest.raises(ValueError, match="mitigation"):
        StragglerPolicy(UncertaintyAwareBalancer(2, device=DEV),
                        mitigation="drop")


def _wired(k=3, seed=0):
    p = Pair(k, bal_kw={"lam": 0.01, "pgd_steps": 40, "explore": 0.0},
             z_threshold=4.0)
    rng = np.random.default_rng(seed)
    for _ in range(6):
        p.record(rng.uniform(9, 11, k), np.full(k, 1.0 / k))
    return p


def test_soft_fail_zero_weight_then_readmit():
    p = _wired()
    assert (p.weights() > 0).all()
    for pol in (p.t, p.j):
        pol.fail(1, remove=False)
    w = p.weights()
    assert w[1] == 0.0 and abs(w.sum() - 1.0) < 1e-9
    for pol in (p.t, p.j):
        pol.recover(1)
    assert p.weights()[1] > 0.0      # the posterior survived the outage


def test_sim_wiring_and_sync():
    p = _wired()
    sims = (ClusterSim.heterogeneous(3, seed=2), JSim.heterogeneous(3, seed=2))
    for pol, sim in zip((p.t, p.j), sims):
        pol.bind_sim(sim)
        pol.fail(2, remove=False)
        assert sim.channels[2].failed
        pol.recover(2)
        assert not sim.channels[2].failed
        sim.inject_failure(0)           # a sim-side event the policy missed
        assert pol.sync_with_sim() == {0}
    assert p.weights()[0] == 0.0
    for pol, sim in zip((p.t, p.j), sims):
        sim.recover(0)
        assert pol.sync_with_sim() == set()
    with pytest.raises(RuntimeError, match="bind_sim"):
        _wired().t.sync_with_sim()


def test_hard_removal_reindexes_soft_failures():
    p = _wired(k=4)
    for pol in (p.t, p.j):
        pol.fail(3, remove=False)
        pol.fail(1)
    p.same_state()
    assert p.t.failed == {2}
    assert len(p.weights()) == 3
    assert p.t.assign(100).sum() == 100
