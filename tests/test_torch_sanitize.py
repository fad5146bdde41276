"""The port's runtime sanitizer (``repro_torch.analysis.sanitize``) against
the JAX package's ``repro.analysis.sanitize``.

* Each boundary check on the same inputs as the reference's: the same
  raise or no raise, and the same message (numbers and shapes aside).
* The entry points' boundary checks (``ops``, ``core.maxstat``), and the
  NaN that an unsanitized call lets through.
* The in-loop checks that replace ``checkify``: a sanitized solve
  (``optimize_weights``, ``solve_dag``) is bitwise the unsanitized one,
  reads the host twice per loop whatever its steps, and a NaN planted at
  step k raises naming step k after the loop ran.
* With the sanitizer off, no tensor operation is added (counted with a
  ``TorchDispatchMode``).
"""
import re

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.analysis import sanitize as jsan
from repro_torch.analysis import sanitize as san
from repro_torch.core import maxstat
from repro_torch.core.partitioner import optimize_weights
from repro_torch.kernels import ops
from repro_torch.workflow import Stage, StageDAG, linear_edges, solve_dag

pytestmark = pytest.mark.sanitizer

DEV = "cpu"


@pytest.fixture
def on(monkeypatch):
    monkeypatch.setenv(san.ENV_VAR, "1")


@pytest.fixture
def off(monkeypatch):
    monkeypatch.delenv(san.ENV_VAR, raising=False)


def _problem():
    W = np.asarray([[0.5, 0.3, 0.2]], np.float32)
    mus = np.asarray([10.0, 20.0, 30.0], np.float32)
    sgs = np.asarray([1.0, 2.0, 3.0], np.float32)
    return W, mus, sgs


def _substance(msg: str) -> str:
    """A check's message without its numbers and shapes."""
    msg = re.sub(r"\(shape [^)]*\)", "", msg)
    return re.sub(r"[-+]?\d[\d.e+-]*", "#", msg).strip()


def _outcome(fn):
    try:
        fn()
    except (san.SanitizeError, jsan.SanitizeError) as e:
        return _substance(str(e))
    return None


def _t(a):
    return torch.tensor(np.asarray(a, np.float32))


def _frontier_cases():
    W, mus, sgs = _problem()
    nan_w = W.copy()
    nan_w[0, 1] = np.nan
    neg_w = np.asarray([[0.6, -0.1, 0.5]], np.float32)
    inf_mu = mus.copy()
    inf_mu[2] = np.inf
    nan_sg = sgs.copy()
    nan_sg[0] = np.nan
    p = np.asarray([0.1, 0.2, 0.05], np.float32)
    ones = np.ones(3, np.float32)
    return {
        "clean": (W, mus, sgs, None, None),
        "nan_weight": (nan_w, mus, sgs, None, None),
        "negative_weight": (neg_w, mus, sgs, None, None),
        "off_simplex": (W * 2.0, mus, sgs, None, None),
        "nudged_mass_passes": (W + np.float32(1e-3), mus, sgs, None, None),
        "inf_mu": (W, inf_mu, sgs, None, None),
        "nan_sigma": (W, mus, nan_sg, None, None),
        "negative_sigma": (W, mus, -sgs, None, None),
        "zero_sigma_passes": (W, mus, 0 * sgs, None, None),
        "nan_extra": (W, mus, sgs, np.asarray([[0.1, np.nan, 0.2]],
                                             np.float32), "drift"),
        "defective_clean": (W, mus, sgs, np.stack([p, ones]), "defective"),
        "defective_p_above_one": (W, mus, sgs,
                                  np.stack([p + 1.0, ones]), "defective"),
        "defective_p_negative": (W, mus, sgs,
                                 np.stack([-p, ones]), "defective"),
        "defective_lam_above_one": (W, mus, sgs,
                                    np.stack([p, 2 * ones]), "defective"),
        "defective_p_one_is_finite": (W, mus, sgs, np.stack([ones, ones]),
                                      "defective"),
        "per_row_stats": (W, mus[None], sgs[None], None, None),
    }


@pytest.mark.parametrize("case", list(_frontier_cases()))
def test_frontier_input_checks_match_the_reference(on, case):
    W, mus, sgs, extra, dist_id = _frontier_cases()[case]
    got = _outcome(lambda: san.check_frontier_inputs(
        _t(W), _t(mus), _t(sgs), None if extra is None else _t(extra),
        dist_id=dist_id))
    want = _outcome(lambda: jsan.check_frontier_inputs(
        W, mus, sgs, extra, dist_id=dist_id))
    assert got == want
    assert (got is None) == (case == "clean" or case.endswith("passes")
                             or case.endswith("clean")
                             or case.endswith("finite")
                             or case == "per_row_stats")


@pytest.mark.parametrize("means,stds", [
    ([1.0, 2.0], [0.1, 0.2]), ([1.0, np.nan], [0.1, 0.1]),
    ([1.0, 2.0], [np.inf, 0.1]), ([1.0, 2.0], [0.1, -0.2])],
    ids=["clean", "nan_mean", "inf_std", "negative_std"])
def test_fold_input_checks_match_the_reference(on, means, stds):
    m, s = np.asarray(means, np.float32), np.asarray(stds, np.float32)
    got = _outcome(lambda: san.check_fold_inputs(_t(m), _t(s)))
    want = _outcome(lambda: jsan.check_fold_inputs(m, s))
    assert got == want
    # the Clark fold runs the same check in both packages
    got = _outcome(lambda: maxstat.clark_max_moments_seq(m, s, device=DEV))
    assert got == want


@pytest.mark.parametrize("ts", [[0.0, 1.0, 2.0], [0.0, 0.0, 0.0],
                                [0.0, 2.0, 1.0], [3.0]],
                         ids=["increasing", "flat", "bent", "one_point"])
def test_monotone_grid_check_matches_the_reference(on, ts):
    ts = np.asarray(ts, np.float32)
    got = _outcome(lambda: san.assert_monotone_grid("g", _t(ts)))
    want = _outcome(lambda: jsan.assert_monotone_grid("g", ts))
    assert got == want


def test_disabled_by_default(off):
    assert not san.enabled()
    W, mus, sgs = _problem()
    san.check_frontier_inputs(_t(W * np.nan), _t(mus), _t(sgs))


def test_entry_points_check_their_inputs(on, monkeypatch):
    W, mus, sgs = _problem()
    bad = W.copy()
    bad[0, 0] = np.nan
    with pytest.raises(san.SanitizeError, match="non-finite"):
        ops.frontier_moments(bad, mus, sgs, num_t=128, device=DEV)
    with pytest.raises(san.SanitizeError, match="row mass"):
        ops.frontier_moments(W * 2.0, mus, sgs, num_t=128, device=DEV)
    inf_mus = mus.copy()
    inf_mus[1] = np.inf
    with pytest.raises(san.SanitizeError, match="mus"):
        ops.frontier_moments_with_grads(W, inf_mus, sgs, num_t=128,
                                        device=DEV)
    with pytest.raises(san.SanitizeError, match="nonneg"):
        ops.frontier_moments_with_grads(W, mus, -sgs, num_t=128, device=DEV,
                                        param_grads=True)
    with pytest.raises(san.SanitizeError, match="fold means"):
        maxstat.max_moments_quad_w(W[0], inf_mus, sgs, num=64, device=DEV)
    # a per-step call skips the boundary check: its loop holds the check
    mu, _ = ops.frontier_moments(bad, mus, sgs, num_t=128, device=DEV,
                                 _check=False)
    assert torch.isnan(mu[0])
    # unsanitized, the NaN flows silently into the moments
    monkeypatch.delenv(san.ENV_VAR)
    mu, _ = ops.frontier_moments(bad, mus, sgs, num_t=128, device=DEV)
    assert torch.isnan(mu[0])


def _counting_reads(monkeypatch):
    """Count the sanitizer's host reads (its only ones, by design)."""
    reads = {"n": 0}
    orig_read, orig_raise = san._Stats.read, san.LoopChecks.raise_first

    def read(self):
        reads["n"] += 1
        return orig_read(self)

    def raise_first(self):
        reads["n"] += 1
        return orig_raise(self)

    monkeypatch.setattr(san._Stats, "read", read)
    monkeypatch.setattr(san.LoopChecks, "raise_first", raise_first)
    return reads


@pytest.mark.parametrize("steps", [3, 11])
def test_sanitized_solve_is_bitwise_and_reads_twice(monkeypatch, steps):
    mus = np.asarray([10.0, 14.0, 20.0, 26.0], np.float32)
    sgs = np.asarray([1.0, 2.0, 3.0, 1.5], np.float32)
    kw = dict(lam=0.1, steps=steps, num_t=128, restarts=2, device=DEV)
    monkeypatch.delenv(san.ENV_VAR, raising=False)
    d0 = optimize_weights(mus, sgs, **kw)
    monkeypatch.setenv(san.ENV_VAR, "1")
    reads = _counting_reads(monkeypatch)
    d1 = optimize_weights(mus, sgs, **kw)
    assert np.array_equal(d1.weights, d0.weights)
    assert (d1.mu, d1.var) == (d0.mu, d0.var)
    assert reads["n"] == 2     # the inputs, then the loop's flags


def _dag():
    rng = np.random.default_rng(0)

    def mk(name, k):
        m = rng.uniform(10, 40, k)
        return Stage(name, m, m * rng.uniform(0.1, 0.4, k))

    return StageDAG([mk("a", 3), mk("b", 2), mk("c", 3)],
                    linear_edges(["a", "b", "c"]))


def test_sanitized_dag_solve_is_bitwise(monkeypatch):
    kw = dict(lam_var=0.05, steps=6, restarts=1, num_t=64, device=DEV,
              seed=0)
    monkeypatch.delenv(san.ENV_VAR, raising=False)
    d0 = solve_dag(_dag(), **kw)
    monkeypatch.setenv(san.ENV_VAR, "1")
    reads = _counting_reads(monkeypatch)
    d1 = solve_dag(_dag(), **kw)
    for name, w in d0.weights.items():
        assert np.array_equal(d1.weights[name], w)
    assert (d1.makespan_mu, d1.makespan_var) == (d0.makespan_mu,
                                                  d0.makespan_var)
    # the starts and statistics on the host, then one flag read a phase
    assert reads["n"] == 3


@pytest.mark.parametrize("k", [0, 4, 9])
def test_nan_planted_at_step_k_raises_naming_k(on, monkeypatch, k):
    calls = {"n": 0}
    orig = ops.frontier_moments_with_grads

    def planted(*a, **kw):
        out = orig(*a, **kw)
        if calls["n"] == k:
            out[2][0, 0] = float("nan")
        calls["n"] += 1
        return out

    monkeypatch.setattr(ops, "frontier_moments_with_grads", planted)
    with pytest.raises(san.SanitizeError,
                       match=rf"PGD gradient became non-finite .*step {k}\)"):
        optimize_weights([10.0, 20.0, 30.0], [1.0, 2.0, 3.0], lam=0.1,
                         steps=12, num_t=64, restarts=0, device=DEV)
    assert calls["n"] == 12   # the loop ran to its end, as under checkify


def test_nan_lam_raises_in_both_solvers(on):
    with pytest.raises(san.SanitizeError, match=r"non-finite.*step 0\)"):
        optimize_weights([10.0, 20.0, 30.0], [1.0, 2.0, 3.0],
                         lam=float("nan"), steps=4, num_t=128, restarts=0,
                         device=DEV)
    with pytest.raises(san.SanitizeError, match="DAG PGD gradient"):
        solve_dag(_dag(), lam_var=float("nan"), steps=4, num_t=64,
                  restarts=0, device=DEV)


def test_nan_input_raises_before_any_launch(on, monkeypatch):
    calls = {"n": 0}
    orig = ops.frontier_moments_with_grads

    def spy(*a, **kw):
        calls["n"] += 1
        return orig(*a, **kw)

    monkeypatch.setattr(ops, "frontier_moments_with_grads", spy)
    # the inverse-mu start is NaN too, and the starts are checked first,
    # as in the reference
    with pytest.raises(san.SanitizeError, match="non-finite"):
        optimize_weights([10.0, np.nan, 30.0], [1.0, 2.0, 3.0], steps=4,
                         num_t=64, restarts=0, device=DEV)
    assert calls["n"] == 0


class _OpCount(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


def _ops_of(fn):
    with _OpCount() as c:
        fn()
    return c.n


def test_off_adds_no_tensor_operation(off, monkeypatch):
    W, mus, sgs = (_t(a) for a in _problem())
    rho = _t([[0.1, 0.2, 0.3]])
    with _OpCount() as c:
        san.check_frontier_inputs(W, mus, sgs, rho, dist_id="drift")
        san.check_fold_inputs(mus, sgs)
        san.assert_monotone_grid("g", mus)
    assert c.n == 0
    # an entry point costs the same with the check as without it
    assert _ops_of(lambda: ops.frontier_moments(
        W, mus, sgs, num_t=64, device=DEV)) == _ops_of(
        lambda: ops.frontier_moments(W, mus, sgs, num_t=64, device=DEV,
                                     _check=False))
    # and a solve pays nothing per step: no in-loop check is even made

    def refuse(*a, **kw):
        raise AssertionError("an in-loop check was made with the "
                             "sanitizer off")

    monkeypatch.setattr(san.LoopChecks, "__init__", refuse)
    optimize_weights([10.0, 14.0, 20.0], [1.0, 2.0, 3.0], lam=0.1, steps=5,
                     num_t=64, restarts=1, device=DEV)
    solve_dag(_dag(), steps=4, restarts=0, num_t=64, device=DEV)


def test_on_adds_operations_per_step(on):
    kw = dict(lam=0.1, num_t=64, restarts=0, device=DEV)
    mus, sgs = [10.0, 14.0, 20.0], [1.0, 2.0, 3.0]
    a = _ops_of(lambda: optimize_weights(mus, sgs, steps=4, **kw))
    b = _ops_of(lambda: optimize_weights(mus, sgs, steps=8, **kw))
    with pytest.MonkeyPatch.context() as mp:
        mp.delenv(san.ENV_VAR)
        a0 = _ops_of(lambda: optimize_weights(mus, sgs, steps=4, **kw))
        b0 = _ops_of(lambda: optimize_weights(mus, sgs, steps=8, **kw))
    # the checks run on the device at every step (no host read there)
    assert (b - a) > (b0 - a0)
