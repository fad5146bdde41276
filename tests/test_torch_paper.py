"""The paper's own figures on the port against the JAX package's
``benchmarks/``, on the CPU plain path.

Each figure's ``run()`` runs in both packages at the paper's sizes. The
reference's tables are captured from its ``save_table`` (nothing is written
to ``experiments/bench/``); the port's go to a temporary directory.

Tolerances: Figs 1 and 2, mu 1e-4 and var 1e-3 relative, the same
efficient mask and the same picks (also against the JAX package's tables
committed in ``experiments/bench/``); Figs 3 and 4, the simulated mu and var
columns bit for bit (numpy draws in both) and the joined solution's MSE
1e-4 relative (300 float32 momentum steps in each framework); Figs 5 and
6, the empirical columns and the f = 0.5 histogram bit for bit, the theory
columns mu 1e-4 and var 1e-3 relative.
"""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from benchmarks import fig1_theory as r_fig1  # noqa: E402
from benchmarks import fig2_frontier as r_fig2  # noqa: E402
from benchmarks import fig34_convex_opt as r_fig34  # noqa: E402
from benchmarks import fig56_file_transfer as r_fig56  # noqa: E402
from repro_torch.bench import common  # noqa: E402
from repro_torch.bench import fig1_theory as t_fig1  # noqa: E402
from repro_torch.bench import fig2_frontier as t_fig2  # noqa: E402
from repro_torch.bench import fig34_convex_opt as t_fig34  # noqa: E402
from repro_torch.bench import fig56_file_transfer as t_fig56  # noqa: E402

DEV = "cpu"


@pytest.fixture(autouse=True)
def _tables(monkeypatch, tmp_path):
    """The port writes its tables under tmp_path; the reference's tables
    are captured by file name."""
    monkeypatch.setattr(common, "RESULTS_DIR", str(tmp_path))
    captured = {}

    def capture(fname, header, rows):
        captured[fname] = [tuple(r) for r in rows]
        return fname

    for mod in (r_fig1, r_fig2, r_fig34, r_fig56):
        monkeypatch.setattr(mod, "save_table", capture)
    return captured


def _read(path):
    lines = Path(path).read_text().splitlines()[1:]
    return [tuple(x.split(",")) for x in lines]


def _frontier_matches(res, table):
    f = np.array([float(r[0]) for r in table])
    mu = np.array([float(r[1]) for r in table])
    var = np.array([float(r[2]) for r in table])
    eff = np.array([bool(r[3]) for r in table])
    np.testing.assert_allclose(res.f, f, atol=1e-7)
    np.testing.assert_allclose(res.mu, mu, rtol=1e-4)
    np.testing.assert_allclose(res.var, var, rtol=1e-3)
    assert np.array_equal(res.efficient, eff)


def test_fig1_theory_matches_reference(_tables):
    want = r_fig1.run()
    got = t_fig1.run(device=DEV)
    _frontier_matches(got["table"], _tables["fig1_theory.csv"])
    assert got["f_mu"] == want["f_mu"] and got["f_var"] == want["f_var"]
    assert got["mu_min"] == pytest.approx(want["mu_min"], rel=1e-4)
    assert got["var_min"] == pytest.approx(want["var_min"], rel=1e-3)
    assert len(_read(Path(common.RESULTS_DIR) / "fig1_theory.csv")) == 201


def test_fig2_frontier_matches_reference(_tables):
    want = r_fig2.run()
    got = t_fig2.run(device=DEV)
    _frontier_matches(got["table"], _tables["fig2_frontier.csv"])
    assert got["n_efficient"] == want["n_efficient"]
    from repro.core import frontier_2ch, select_on_frontier
    ref = frontier_2ch(30.0, 2.0, 20.0, 6.0, num_f=401, num_t=2048)
    for lam, (f, mu, var) in zip(t_fig2.LAMS, got["picks"]):
        fj, muj, varj = select_on_frontier(ref, lam)[1]
        assert f == fj
        assert mu == pytest.approx(muj, rel=1e-4)
        assert var == pytest.approx(varj, rel=1e-3)


@pytest.mark.parametrize("mod", [t_fig1, t_fig2], ids=["fig1", "fig2"])
def test_figs_1_2_match_the_committed_tables(mod):
    # experiments/bench/ holds the JAX package's tables of both figures:
    # the port's, regenerated, agree with them
    name = mod.__name__.rsplit(".", 1)[-1]
    path = Path(__file__).resolve().parents[1] / "experiments" / "bench" \
        / f"{name}.csv"
    table = [(r[0], r[1], r[2], r[3] == "True") for r in _read(path)]
    _frontier_matches(mod.run(device=DEV)["table"], table)


def test_fig34_convex_opt_matches_reference(_tables):
    want = r_fig34.run()
    got = t_fig34.run(device=DEV)
    assert got["mu_min_f"] == want["mu_min_f"]
    assert got["var_min_f"] == want["var_min_f"]
    ref_rows = _tables["fig34_convex_opt.csv"]
    assert len(got["rows"]) == len(ref_rows) == 11
    for a, b in zip(got["rows"], ref_rows):
        assert a[0] == b[0]
        assert a[1] == b[1] and a[2] == b[2]       # the sim: bit for bit
        assert a[3] == pytest.approx(b[3], rel=1e-4)


def test_fig34_solve_matches_reference_gradient_descent():
    # one machine's solve alone, on the reference's data
    import jax.numpy as jnp
    X, y, _ = t_fig34._make_problem(device=DEV)
    w, loss = t_fig34._solve(X[:300], y[:300], steps=40)
    wj, lj = r_fig34._solve(jnp.asarray(X[:300].numpy()),
                            jnp.asarray(y[:300].numpy()), steps=40)
    np.testing.assert_allclose(w.numpy(), np.asarray(wj), rtol=1e-4,
                               atol=1e-5)
    assert loss == pytest.approx(lj, rel=1e-5)


def test_fig56_file_transfer_matches_reference(_tables):
    want = r_fig56.run()
    got = t_fig56.run(device=DEV)
    assert got["skew"] == want["skew"] and got["kurt"] == want["kurt"]
    assert got["max_rel_mu_err"] == pytest.approx(want["max_rel_mu_err"],
                                                  rel=1e-3, abs=1e-6)
    hist = np.array([r[0] for r in _tables["fig5_hist_f05.csv"]])
    assert np.array_equal(got["hist_f05"], hist)
    for a, b in zip(got["rows"], _tables["fig6_file_transfer.csv"]):
        assert a[0] == b[0] and a[5] == b[5]
        assert a[1] == b[1] and a[2] == b[2]       # empirical: bit for bit
        assert a[3] == pytest.approx(b[3], rel=1e-4)
        assert a[4] == pytest.approx(b[4], rel=1e-3)


def test_paper_runs_refuse_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    for mod in (t_fig1, t_fig2, t_fig34, t_fig56):
        with pytest.raises(RuntimeError, match="cuda"):
            mod.run()
