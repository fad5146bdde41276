"""The port's solver and estimation loop against the JAX package, on the
CPU plain path, with the same numpy inputs from a seed.

Tolerances: moments as in ``tests/test_kernels.py`` (mu 1e-4, var 1e-2 /
1e-3); optimized weights atol 1e-3 (``tests/test_frontier_grads.py``);
posterior arithmetic rtol 1e-6 (float32 elementwise); fragility rtol 1e-3
(it contracts the pgrad adjoints, whose cross-framework relative L2 is
1e-3, see ``tests/test_torch_frontier.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jc
from repro.core import bayes as jb
from repro.core import sensitivity as jsens
import repro_torch.core as tc
from repro_torch.core import bayes as tb
from repro_torch.core import sensitivity as tsens
from repro_torch.core import partitioner as tpart


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # the tensors here are tiny: intra-op threads only contend with the
    # other test workers
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


DEV = "cpu"


def _fleet(k, seed=0):
    rng = np.random.default_rng(seed)
    mus = rng.uniform(10.0, 40.0, k).astype(np.float32)
    sgs = (mus * rng.uniform(0.05, 0.3, k)).astype(np.float32)
    return mus, sgs


def test_maxstat_matches_reference():
    mus, sgs = _fleet(5)
    w = np.random.default_rng(1).dirichlet(np.ones(5)).astype(np.float32)
    for fam in ("normal", "lognormal", ("drift", np.full((1, 5), 0.3,
                                                          np.float32))):
        a = tc.max_moments_quad_w(w, mus, sgs, num=1024, family=fam,
                                  device=DEV)
        b = jc.max_moments_quad_w(w, mus, sgs, num=1024, family=fam)
        np.testing.assert_allclose(float(a[0]), float(b[0]), rtol=1e-4)
        np.testing.assert_allclose(float(a[1]), float(b[1]), rtol=1e-2,
                                   atol=1e-3)
    a = tc.max_moments_quad(w * mus, w * sgs, num=1024, device=DEV)
    b = jc.max_moments_quad(w * mus, w * sgs, num=1024)
    np.testing.assert_allclose(float(a[0]), float(b[0]), rtol=1e-4)
    a = tc.clark_max_moments_seq(w * mus, w * sgs, device=DEV)
    b = jc.clark_max_moments_seq(jnp.asarray(w * mus), jnp.asarray(w * sgs))
    np.testing.assert_allclose([float(x) for x in a], [float(x) for x in b],
                               rtol=1e-5)
    a = tc.clark_max_moments_2(30.0, 2.0, 20.0, 0.0, device=DEV)
    b = jc.clark_max_moments_2(30.0, 2.0, 20.0, 0.0)
    np.testing.assert_allclose([float(x) for x in a], [float(x) for x in b],
                               rtol=1e-6)
    t = np.linspace(0.0, 20.0, 9, dtype=np.float32)
    np.testing.assert_allclose(
        tc.joint_cdf_w(t, w, mus, sgs, device=DEV).numpy(),
        np.asarray(jc.joint_cdf_w(t, w, mus, sgs)), rtol=1e-5, atol=1e-6)
    g = torch.Generator().manual_seed(0)
    m, _ = tc.max_moments_mc(g, w * mus, w * sgs, num_samples=100_000)
    quad = jc.max_moments_quad(w * mus, w * sgs, num=1024)
    np.testing.assert_allclose(float(m), float(quad[0]), rtol=1e-2)


def test_frontier_2ch_at_the_papers_figure_1():
    a = tc.frontier_2ch(30.0, 2.0, 20.0, 6.0, num_f=101, num_t=1024,
                        device=DEV)
    b = jc.frontier_2ch(30.0, 2.0, 20.0, 6.0, num_f=101, num_t=1024)
    np.testing.assert_allclose(a.f, np.asarray(b.f), atol=1e-7)
    np.testing.assert_allclose(a.mu, b.mu, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(a.var, b.var, rtol=1e-2, atol=1e-3)
    assert np.array_equal(a.efficient, b.efficient)
    assert tc.select_on_frontier(a, 0.1)[0] == jc.select_on_frontier(b, 0.1)[0]


def test_pareto_and_simplex_candidates_match():
    rng = np.random.default_rng(3)
    mu, var = rng.uniform(size=200), rng.uniform(size=200)
    assert np.array_equal(tc.pareto_mask(mu, var), jc.pareto_mask(mu, var))
    for k, n in ((2, 11), (3, 20), (6, 64)):
        np.testing.assert_array_equal(tc.simplex_candidates(k, n),
                                      jc.simplex_candidates(k, n))


def test_frontier_kch_matches_reference():
    mus, sgs = _fleet(4, seed=4)
    a = tc.frontier_kch(mus, sgs, num_f=40, num_t=256, pgd_steps=30,
                        device=DEV)
    b = jc.frontier_kch(mus, sgs, num_f=40, num_t=256, pgd_steps=30)
    np.testing.assert_allclose(a.f, b.f, atol=1e-3)
    np.testing.assert_allclose(a.mu, b.mu, rtol=1e-3, atol=1e-3)


def test_project_simplex_batched():
    rng = np.random.default_rng(5)
    V = rng.normal(size=(7, 6)).astype(np.float32)
    got = tpart._project_simplex(torch.tensor(V)).numpy()
    want = np.asarray(jax.vmap(jc.partitioner._project_simplex)(V))
    np.testing.assert_allclose(got, want, atol=1e-6)
    np.testing.assert_allclose(got.sum(1), 1.0, atol=1e-5)


@pytest.mark.parametrize("fam", ["normal", "lognormal", "drift",
                                 "defective"])
def test_optimize_weights_with_the_same_starts(fam):
    k = 6
    mus, sgs = _fleet(k, seed=6)
    family = {"normal": "normal", "lognormal": "lognormal",
              "drift": jc.Drift(np.full(k, 0.4, np.float32)),
              "defective": jc.Defective(np.full(k, 0.1, np.float32))}[fam]
    tfamily = family if isinstance(family, str) else \
        tc.get_family(family.state_dict())
    key = jax.random.PRNGKey(7)
    starts = np.asarray(jax.random.dirichlet(key, jnp.ones((k,)), (2,)))
    b = jc.optimize_weights(mus, sgs, lam=0.05, steps=40, num_t=256,
                            restarts=2, key=key, family=family)
    a = tc.optimize_weights(mus, sgs, lam=0.05, steps=40, num_t=256,
                            restart_starts=starts, family=tfamily,
                            device=DEV)
    np.testing.assert_allclose(a.weights, b.weights, atol=1e-3)
    np.testing.assert_allclose(a.mu, b.mu, rtol=1e-4)
    assert a.method == b.method


def test_optimize_weights_sunk_work_and_risk():
    k = 5
    mus, sgs = _fleet(k, seed=8)
    done = np.array([0.05, 0.0, 0.1, 0.02, 0.0])
    a = tc.optimize_weights(mus, sgs, steps=30, num_t=256, restarts=0,
                            done=done, device=DEV)
    b = jc.optimize_weights(mus, sgs, steps=30, num_t=256, restarts=0,
                            done=done)
    np.testing.assert_allclose(a.weights, b.weights, atol=1e-3)
    nig_j = jc.nig_init(k, m0=20.0)
    nig_t = tc.nig_init(k, m0=20.0, device=DEV)
    rng = np.random.default_rng(9)
    for _ in range(4):
        r = rng.normal(mus, sgs).astype(np.float32)
        m = np.ones(k, np.float32)
        nig_j = jc.nig_update_batch(nig_j, jnp.asarray(r), jnp.asarray(m))
        nig_t = tc.nig_update_batch(nig_t, torch.tensor(r), torch.tensor(m))
    a, ra = tc.optimize_weights(mus, sgs, steps=30, num_t=256, restarts=0,
                                risk_lam=0.5, posterior=nig_t,
                                return_sensitivity=True, device=DEV)
    b, rb = jc.optimize_weights(mus, sgs, steps=30, num_t=256, restarts=0,
                                risk_lam=0.5, posterior=nig_j,
                                return_sensitivity=True)
    np.testing.assert_allclose(a.weights, b.weights, atol=1e-3)
    assert a.method == b.method == "pgd-simplex-risk"
    np.testing.assert_allclose(ra.fragility, rb.fragility, rtol=1e-3)


def test_optimize_2ch_and_predict_moments():
    a = tc.optimize_2ch(30.0, 2.0, 20.0, 6.0, lam=0.02, num_f=101,
                        num_t=1024, device=DEV)
    b = jc.optimize_2ch(30.0, 2.0, 20.0, 6.0, lam=0.02, num_f=101,
                        num_t=1024)
    np.testing.assert_allclose(a.weights, b.weights, atol=1e-3)
    mus, sgs = _fleet(4)
    w = np.array([0.1, 0.2, 0.3, 0.4])
    for exact in (True, False):
        got = tc.predict_moments(w, mus, sgs, exact=exact, num_t=1024,
                                 device=DEV)
        want = jc.predict_moments(w, mus, sgs, exact=exact, num_t=1024)
        np.testing.assert_allclose(got[0], want[0], rtol=1e-4)
    obj = tc.objective(w, mus, sgs, 0.1, num_t=256, device=DEV)
    objj = jc.objective(w, mus, sgs, 0.1, num_t=256)
    np.testing.assert_allclose(float(obj), float(objj), rtol=1e-3)


def test_nig_updates_and_standard_errors():
    k = 7
    rng = np.random.default_rng(10)
    nj = jb.nig_init(k, m0=5.0)
    nt = tb.nig_init(k, m0=5.0, device=DEV)
    for i in range(6):
        r = rng.uniform(1.0, 9.0, k).astype(np.float32)
        m = (rng.uniform(size=k) > 0.2).astype(np.float32)
        nj = jb.nig_update_batch(nj, jnp.asarray(r), jnp.asarray(m))
        nt = tb.nig_update_batch(nt, torch.tensor(r), torch.tensor(m))
        nj = jb.nig_update(nj, i % k, 3.5)
        nt = tb.nig_update(nt, i % k, 3.5)
    for a, b in zip(nt, nj):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)
    for a, b in zip(tb.nig_point_estimates(nt), jb.nig_point_estimates(nj)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)
    for a, b in zip(tb.nig_estimate_ses(nt), jb.nig_estimate_ses(nj)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)


def test_score_families_and_fit():
    rng = np.random.default_rng(11)
    N, K = 40, 6
    works = rng.uniform(0.05, 0.3, (N, K))
    rates = rng.normal(10.0, 1.0, (N, K)) * (1.0 + 0.4 * works)
    mask = (rng.uniform(size=(N, K)) > 0.1).astype(np.float64)
    mask[:, 5] = 0.0
    mask[:3, 5] = 1.0                  # one channel below min_obs
    a = tb.score_families(rates, works, mask, min_obs=8)
    b = jb.score_families(rates, works, mask, min_obs=8)
    assert a.winner == b.winner and a.n_channels == b.n_channels
    for fam in a.bics:
        np.testing.assert_allclose(a.bics[fam], b.bics[fam], rtol=1e-9)
    np.testing.assert_array_equal(a.rho, b.rho)
    for x, y in zip(a.gmm, b.gmm):
        np.testing.assert_array_equal(x, y)
    for name in ("drift", "empirical", "normal"):
        fa = tb.fit_selected_family(a, name)
        fb = jb.fit_selected_family(b, name)
        assert fa.state_dict() == fb.state_dict()
    assert tb.score_families(rates[:3], works[:3], mask[:3]) is None


@pytest.mark.parametrize("fam", ["normal", "drift"])
def test_sensitivity_and_fragility_batch(fam):
    k = 5
    mus, sgs = _fleet(k, seed=12)
    family = fam if fam == "normal" else ("drift",
                                          np.full((1, k), 0.3, np.float32))
    nj = jb.nig_init(k, m0=20.0)
    nt = tb.nig_init(k, m0=20.0, device=DEV)
    rng = np.random.default_rng(13)
    for _ in range(3):
        r = rng.normal(mus, sgs).astype(np.float32)
        m = np.ones(k, np.float32)
        nj = jb.nig_update_batch(nj, jnp.asarray(r), jnp.asarray(m))
        nt = tb.nig_update_batch(nt, torch.tensor(r), torch.tensor(m))
    W = rng.dirichlet(np.ones(k), 4).astype(np.float32)
    a = tsens.fragility_batch(W, mus, sgs, nt, family=family, num_t=256,
                              device=DEV)
    b = jsens.fragility_batch(W, mus, sgs, nj, family=family, num_t=256)
    np.testing.assert_allclose(a, b, rtol=1e-3)
    sa = tsens.moment_sensitivity(W[0], mus, sgs, family=family, num_t=256,
                                  device=DEV)
    sb = jsens.moment_sensitivity(W[0], mus, sgs, family=family, num_t=256)
    pa = tsens.posterior_sensitivity(sa, nt)
    pb = jsens.posterior_sensitivity(sb, nj)
    for name in ("dmu_dm", "dmu_dkappa", "dmu_dalpha", "dmu_dbeta"):
        x, y = getattr(pa, name), getattr(pb, name)
        assert np.linalg.norm(x - y) <= 1e-3 * np.linalg.norm(y) + 1e-12
    np.testing.assert_allclose(pa.fragility, pb.fragility, rtol=1e-3)
    np.testing.assert_allclose(pa.relative_fragility, pb.relative_fragility,
                               rtol=1e-3)
