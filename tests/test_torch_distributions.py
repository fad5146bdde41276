"""Family math of the PyTorch port against the JAX package, element by
element: the same numpy inputs (made from a seed) go through
``repro.core.distributions`` and ``repro_torch.core.distributions``.

Tolerance: rtol 1e-5, atol 1e-6. Both sides compute in float32; the two
frameworks' erf, exp and log differ by a few ulps.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import distributions as jd
from repro_torch.core import distributions as td


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # the tensors here are tiny: intra-op threads only contend with the
    # other test workers
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


RTOL, ATOL = 1e-5, 1e-6
K, T = 12, 40


def _extra(fam, rng, shape):
    if fam == "drift":
        ex = rng.uniform(0.0, 0.8, (1,) + shape)
    elif fam == "defective":
        ex = np.stack([rng.uniform(0.0, 0.3, shape), np.full(shape, 0.5)])
        ex[0, ..., 1] = 0.0                      # p = 0 edge
    elif fam == "empirical":
        pis = np.moveaxis(rng.dirichlet(np.ones(3), shape), -1, 0)
        ms = rng.uniform(5.0, 30.0, (3,) + shape)
        ss = rng.uniform(0.5, 4.0, (3,) + shape)
        if shape[-1] > 4:
            ss[1, ..., 2] = 0.0                  # a spread-free component
            ss[:, ..., 4] = 0.0                  # a spread-free mixture
        ex = np.concatenate([pis, ms, ss])
    else:
        ex = np.zeros((1,) + shape)
    return ex.astype(np.float32)


def _inputs(fam, seed=0):
    """(t, w, mu, sigma, extra) broadcasting as (T, 1) x (K,), with the
    w = 0 and sigma = 0 edges in channels 0 and 3."""
    rng = np.random.default_rng(seed)
    w = rng.dirichlet(np.ones(K)).astype(np.float32)
    w[0] = 0.0
    mu = rng.uniform(5.0, 30.0, K).astype(np.float32)
    sg = (mu * rng.uniform(0.05, 0.4, K)).astype(np.float32)
    sg[3] = 0.0
    ex = _extra(fam, rng, (K,))
    m_eff, s_eff = jd.family_effective_moments(fam, w, mu, sg, ex)
    tmax = float(np.max(np.asarray(m_eff) + 6.0 * np.asarray(s_eff)))
    t = np.linspace(0.0, tmax, T, dtype=np.float32)[:, None]
    # the point masses' own locations, to hit the right-continuous edge
    t[1:4, 0] = np.asarray(m_eff)[[0, 3, 4]]
    return t, w, mu, sg, ex


def _both(fn_name, fam, args, *extra_args):
    j = getattr(jd, fn_name)(fam, *[jnp.asarray(a) for a in args],
                             *extra_args)
    t = getattr(td, fn_name)(fam, *[torch.tensor(a) for a in args],
                             *extra_args)
    return j, t


def _close(j, t):
    if isinstance(j, (tuple, list)):
        assert len(j) == len(t)
        for a, b in zip(j, t):
            _close(a, b)
        return
    a = np.asarray(j, np.float64)
    b = np.asarray(t.numpy() if hasattr(t, "numpy") else t, np.float64)
    if a.dtype == bool or b.dtype == bool:
        np.testing.assert_array_equal(a, b)
        return
    np.testing.assert_allclose(np.broadcast_to(b, a.shape), a,
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("fam", td.FAMILIES)
def test_effective_moments_coeffs_and_reach(fam):
    _, w, mu, sg, ex = _inputs(fam)
    args = (w, mu, sg, ex)
    for name in ("family_effective_moments", "family_coeffs",
                 "family_param_coeffs"):
        _close(*_both(name, fam, args))
    for name in ("family_dreach", "family_dreach_params"):
        _close(*_both(name, fam, args, 10.0))


@pytest.mark.parametrize("fam", td.FAMILIES)
def test_cdf_and_adjoint_parts(fam):
    t, w, mu, sg, ex = _inputs(fam, seed=1)
    args = (t, w, mu, sg, ex)
    _close(*_both("family_cdf", fam, args))
    j, tt = _both("family_adjoint_parts", fam, args)
    for a, b in zip(j, tt):
        if a.dtype == jnp.bool_:
            np.testing.assert_array_equal(np.asarray(a), b.numpy())
        else:
            _close(a, b)


def test_degenerate_channels_are_right_continuous_point_masses():
    t = torch.tensor([[0.0], [5.0], [4.999], [5.001]])
    for fam in ("normal", "lognormal", "drift", "defective"):
        ex = torch.zeros((td.extra_rows(fam), 2))
        if fam == "defective":
            ex[1] = 1.0
        w = torch.tensor([0.0, 0.5])
        mu = torch.tensor([10.0, 10.0])
        sg = torch.tensor([1.0, 0.0])
        c = td.family_cdf(fam, t, w, mu, sg, ex)
        assert torch.all(c[:, 0] == 1.0)             # w = 0: already done
        assert c[:, 1].tolist() == [0.0, 1.0, 0.0, 1.0]   # mass at 5


def test_phi_keeps_the_erf_form_and_saturates_like_the_reference():
    # the adjoint's gate reads where 0.5 * (1 + erf(x / sqrt 2)) rounds to
    # 1.0 in float32. Torch's erf reaches it at z = 5.34, XLA's at 5.48
    # (ROADMAP section 3); between the two the pdf is below 1e-6 of its peak
    x = np.linspace(4.5, 6.5, 2001, dtype=np.float32)
    ours = td.Phi(torch.tensor(x)).numpy()
    theirs = np.asarray(jd.Phi(jnp.asarray(x)))
    edge_ours = x[np.argmax(ours >= 1.0)]
    edge_theirs = x[np.argmax(theirs >= 1.0)]
    assert 5.2 < edge_ours < 5.5 and abs(edge_ours - edge_theirs) < 0.15
    np.testing.assert_allclose(ours, theirs, rtol=RTOL, atol=ATOL)


def test_numpy_helpers_and_sampling_match_draw_for_draw():
    mu, sg = np.array([10.0, 20.0]), np.array([1.0, 5.0])
    for a, b in zip(td.lognormal_shape_np(mu, sg), jd.lognormal_shape_np(mu, sg)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(td.defective_moments_np(mu, sg, [0.1, 0.0], 1.0),
                    jd.defective_moments_np(mu, sg, [0.1, 0.0], 1.0)):
        np.testing.assert_array_equal(a, b)
    w = np.array([0.4, 0.6])
    for fam in td.FAMILIES:
        ex = _extra(fam, np.random.default_rng(3), (2,)).astype(np.float64)
        a = td.family_sample(fam, np.random.default_rng(7), w, mu, sg, ex, 50)
        b = jd.family_sample(fam, np.random.default_rng(7), w, mu, sg, ex, 50)
        np.testing.assert_array_equal(a, b)
    x = np.random.default_rng(5).normal(3.0, 1.0, 300)
    for a, b in zip(td._em_1d(x, 3, 20, 1e-3), jd._em_1d(x, 3, 20, 1e-3)):
        np.testing.assert_array_equal(a, b)


def test_families_state_dicts_and_resolution_round_trip():
    samples = np.random.default_rng(0).normal(10.0, 2.0, (200, 4))
    fams = [td.Normal(), td.LogNormal(), td.Drift([0.1, 0.2, 0.0, 0.4]),
            td.Defective([0.1, 0.0, 0.2, 0.05], pricing="resume"),
            td.Empirical.from_samples(samples)]
    jfams = [jd.Normal(), jd.LogNormal(), jd.Drift([0.1, 0.2, 0.0, 0.4]),
             jd.Defective([0.1, 0.0, 0.2, 0.05], pricing="resume"),
             jd.Empirical.from_samples(samples)]
    for f, g in zip(fams, jfams):
        assert f.state_dict() == g.state_dict()
        back = td.get_family(g.state_dict())
        np.testing.assert_array_equal(back.extra(4), g.extra(4))
        dist_id, ex = td.resolve_family(f, 4)
        assert dist_id == g.dist_id
        again = td.family_from_extra(dist_id, ex)
        np.testing.assert_allclose(again.extra(4), ex, rtol=1e-6)
    with pytest.raises(ValueError):
        td.get_family("empirical")
    with pytest.raises(ValueError):
        td.resolve_family(("drift", np.zeros((2, 4))), 4)


@pytest.mark.parametrize("fam", td.FAMILIES)
def test_remaining_work_stats(fam):
    rng = np.random.default_rng(2)
    mu, sg = rng.uniform(5, 20, 6), rng.uniform(0.5, 3, 6)
    ex = _extra(fam, rng, (6,)).astype(np.float64)
    done = rng.uniform(0.0, 0.1, 6)
    a = td.remaining_work_stats(fam, mu, sg, ex, done)
    b = jd.remaining_work_stats(fam, mu, sg, ex, done)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
