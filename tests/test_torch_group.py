"""The port's channel-count selection (``core/group.py``) against the JAX
package, on the CPU plain path, with the same numpy fleets.

The reference draws its Dirichlet restarts from a JAX key and the port
from a numpy generator, so the solves start from different random rows:
the chosen channel indices must be equal, the objective within 1e-4
relative and the winning split within 1e-3 (``tests/test_frontier_grads.py``);
a one-channel subset's moments within mu 1e-4 / var 1e-3 relative.
"""
import numpy as np
import pytest
import torch

import repro.core as jc
import repro_torch.core as tc
from repro_torch.core import group as tgroup
from repro.core import group as jgroup

DEV = "cpu"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # the tensors here are tiny: intra-op threads only contend with the
    # other test workers
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fleet(n, seed):
    rng = np.random.default_rng(seed)
    mus = rng.uniform(10.0, 40.0, n)
    sgs = mus * rng.uniform(0.05, 0.3, n)
    p = rng.uniform(0.0, 0.4, n).astype(np.float32)
    return mus, sgs, p


def _families(fam, p):
    """(reference family, port family) for a family name; the defective
    fleet's p per channel."""
    if fam == "defective":
        j = jc.Defective(p=p)
        return j, tc.get_family(j.state_dict())
    return fam, fam


def _same_choice(a, b):
    assert a.indices.tolist() == b.indices.tolist()
    assert a.objective == pytest.approx(b.objective, rel=1e-4)
    np.testing.assert_allclose(a.decision.weights, b.decision.weights,
                               atol=1e-3)
    assert a.decision.method == b.decision.method


@pytest.mark.parametrize("fam", ["normal", "lognormal", "defective"])
@pytest.mark.parametrize("search,n", [("greedy", 6), ("exhaustive", 5)])
def test_selection_matches_reference(fam, search, n):
    mus, sgs, p = _fleet(n, seed=n + len(fam))
    jfam, tfam = _families(fam, p)
    kw = dict(lam=0.1, join_cost=0.5, pgd_steps=60)
    if search == "greedy":
        b = jc.select_channels(mus, sgs, family=jfam, **kw)
        a = tc.select_channels(mus, sgs, family=tfam, device=DEV, **kw)
    else:
        b = jc.select_channels_exhaustive(mus, sgs, family=jfam, **kw)
        a = tc.select_channels_exhaustive(mus, sgs, family=tfam, device=DEV,
                                          **kw)
    _same_choice(a, b)


def test_greedy_within_the_oracle_and_failure_aware_admission():
    # tests/test_core.py's TestGroupSelection cases, through both packages
    mus, sgs = [30.0, 20.0, 28.0, 45.0], [2.0, 6.0, 3.0, 1.0]
    g = tc.select_channels(mus, sgs, lam=0.1, join_cost=0.5, pgd_steps=80,
                           device=DEV)
    e = tc.select_channels_exhaustive(mus, sgs, lam=0.1, join_cost=0.5,
                                      pgd_steps=80, device=DEV)
    assert g.objective <= e.objective * 1.1
    _same_choice(g, jc.select_channels(mus, sgs, lam=0.1, join_cost=0.5,
                                       pgd_steps=80))

    mus, sgs = [10.0, 12.0, 12.5, 13.0], [1.0, 1.2, 1.2, 1.3]
    reliable = tc.select_channels(mus, sgs, lam=0.05, join_cost=1.0,
                                  pgd_steps=60, device=DEV,
                                  family=tc.Defective(p=[0.0] * 4))
    flaky = tc.select_channels(mus, sgs, lam=0.05, join_cost=1.0,
                               pgd_steps=60, device=DEV,
                               family=tc.Defective(p=[0.6, 0.0, 0.0, 0.0]))
    assert 0 in reliable.indices.tolist()
    assert 0 not in flaky.indices.tolist()
    assert flaky.objective > reliable.objective
    _same_choice(flaky, jc.select_channels(
        mus, sgs, lam=0.05, join_cost=1.0, pgd_steps=60,
        family=jc.Defective(p=[0.6, 0.0, 0.0, 0.0])))

    fam = tc.Defective(p=[0.5, 0.0, 0.3, 0.0])
    mus, sgs = [11.0, 14.0, 12.0, 16.0], [1.0, 1.5, 1.1, 1.8]
    g = tc.select_channels(mus, sgs, lam=0.05, join_cost=0.8, pgd_steps=60,
                           family=fam, device=DEV)
    e = tc.select_channels_exhaustive(mus, sgs, lam=0.05, join_cost=0.8,
                                      pgd_steps=60, family=fam, device=DEV)
    assert sorted(g.indices.tolist()) == sorted(e.indices.tolist())
    assert g.objective == pytest.approx(e.objective, rel=1e-6)

    mus, sgs = [20.0, 24.0, 28.0], [2.0, 2.4, 2.8]
    normal = tc.select_channels(mus, sgs, lam=0.05, join_cost=1.5,
                                pgd_steps=60, device=DEV)
    zero_p = tc.select_channels(mus, sgs, lam=0.05, join_cost=1.5,
                                pgd_steps=60, family=tc.Defective(p=0.0),
                                device=DEV)
    assert sorted(normal.indices.tolist()) == sorted(zero_p.indices.tolist())
    assert normal.objective == pytest.approx(zero_p.objective, rel=1e-5)


def test_join_cost_is_monotone_in_k():
    # a dearer join never enlists more channels, in step with the reference
    mus, sgs, _ = _fleet(6, seed=21)
    ks = []
    for cost in (0.0, 0.5, 2.0, 5.0, 20.0):
        a = tc.select_channels(mus, sgs, lam=0.05, join_cost=cost,
                               pgd_steps=60, device=DEV)
        b = jc.select_channels(mus, sgs, lam=0.05, join_cost=cost,
                               pgd_steps=60)
        assert a.indices.tolist() == b.indices.tolist()
        ks.append(len(a.indices))
    assert ks == sorted(ks, reverse=True) and ks[-1] < ks[0]
    same = tc.select_channels([20.0] * 6, [2.0] * 6, join_cost=5.0,
                              pgd_steps=60, device=DEV)
    assert len(same.indices) <= len(tc.select_channels(
        [20.0] * 6, [2.0] * 6, join_cost=0.0, pgd_steps=60,
        device=DEV).indices)


@pytest.mark.parametrize("fam", ["normal", "lognormal", "drift",
                                 "empirical", "defective"])
def test_single_channel_subset(fam):
    # the K = 1 path: closed form under normal, one quadrature otherwise;
    # a dear join makes the one-channel group win
    mus, sgs, p = _fleet(4, seed=33)
    jfam = {"normal": lambda: "normal", "lognormal": lambda: "lognormal",
            "drift": lambda: jc.Drift(np.full(4, 0.3, np.float32)),
            "empirical": lambda: jc.Empirical([0.5, 0.3, 0.2],
                                              [15.0, 20.0, 30.0],
                                              [1.0, 2.0, 4.0]),
            "defective": lambda: jc.Defective(p=p)}[fam]()
    tfam = jfam if isinstance(jfam, str) else tc.get_family(jfam.state_dict())
    dist_id, extra = tc.resolve_family(tfam, 4)
    jd_id, jextra = jc.resolve_family(jfam, 4)
    for i in range(4):
        idx = np.asarray([i])
        a = tgroup._subset_decision(idx, mus, sgs, dist_id,
                                    np.asarray(extra), 0.1, 60, DEV)
        b = jgroup._subset_decision(idx, mus, sgs, jd_id,
                                    np.asarray(jextra), 0.1, 60)
        assert a.method == b.method == "single"
        assert a.mu == pytest.approx(b.mu, rel=1e-4)
        assert a.var == pytest.approx(b.var, rel=1e-3)
    a = tc.select_channels(mus, sgs, lam=0.1, join_cost=50.0, pgd_steps=40,
                           family=tfam, device=DEV)
    b = jc.select_channels(mus, sgs, lam=0.1, join_cost=50.0, pgd_steps=40,
                           family=jfam)
    assert len(a.indices) == 1
    _same_choice(a, b)
