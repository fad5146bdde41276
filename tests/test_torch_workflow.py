"""The port's workflow DAG and joint solver against the JAX package.

The same numpy-seeded inputs go through ``repro.workflow`` (``impl="xla"``)
and ``repro_torch.workflow`` (``device="cpu"``, the kernels' plain
versions). Tolerances follow ``tests/test_frontier_grads.py`` and
``tests/test_workflow.py``: stage and makespan mu 1e-4 relative, var 1e-2 /
1e-3 (1e-3 relative for the composed var), kernel adjoints 1e-4 relative
L2. The composition alone is held with the reference's float32 erf
substituted into the port (``shared_erf``, as in
``tests/test_torch_frontier.py``), which isolates the algorithm: the
completion means to 1e-6 relative; the variances to 1e-6 of the second
moment ``mu^2 + var`` they are cancelled from (Clark's ``var = m2 -
m1^2``: one float32 ulp of m2 is ~1e-5 of a small var, and the two
frameworks round m2 differently); every cotangent to 1e-5 of its row's
largest. With each framework's own erf the means still agree to 1e-6 and
the variances to OWN_ERF_VAR_RTOL.
"""
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.workflow as jw
from repro.core.bayes import nig_init as j_nig_init
from repro.core.bayes import nig_update_batch as j_nig_update
from repro.core.distributions import Drift as JDrift
from repro.workflow import dag as jdag
from repro.workflow import solve as jsolve
import repro_torch.workflow as tw
from repro_torch import convert
from repro_torch.core import distributions as td
from repro_torch.core.bayes import NIGState
from repro_torch.core.distributions import Drift as TDrift
from repro_torch.kernels import ops
from repro_torch.bench import dag_scale as tbench
from repro_torch.workflow import dag as tdag
from repro_torch.workflow import solve as tsolve

ROOT = pathlib.Path(__file__).resolve().parents[1]
DEV = "cpu"
PKGS = {"jax": jw, "torch": tw}
OWN_ERF_VAR_RTOL = 1e-4


class _XlaErf(torch.autograd.Function):
    """The reference's float32 erf, differentiable (d erf = 2/sqrt(pi)
    exp(-x^2))."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        y = np.asarray(jax.lax.erf(jnp.asarray(x.detach().numpy())))
        return torch.tensor(y)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g * (2.0 / np.sqrt(np.pi)) * torch.exp(-x * x)


@pytest.fixture
def shared_erf(monkeypatch):
    monkeypatch.setattr(td, "_erf", _XlaErf.apply)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # the tensors here are small: intra-op threads only contend with the
    # other test workers
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mk(pkg, name, k, seed=0, cov=(0.05, 0.4), family="normal"):
    rng = np.random.default_rng(seed)
    mus = rng.uniform(10, 40, k)
    return pkg.Stage(name, mus, mus * rng.uniform(*cov, k), family=family)


def _diamond(pkg, seed=0, family="normal"):
    stages = [_mk(pkg, "a", 4, seed), _mk(pkg, "b", 3, seed + 1, family=family),
              _mk(pkg, "c", 5, seed + 2, family=family),
              _mk(pkg, "d", 4, seed + 3)]
    return pkg.StageDAG(stages, [("a", "b"), ("a", "c"), ("b", "d"),
                                 ("c", "d")])


def _mixed(pkg):
    """Normal, lognormal and drift stages of different K (padding), with a
    3-way join."""
    rho = np.linspace(0.2, 0.6, 6).astype(np.float32)
    fam_d = (JDrift if pkg is jw else TDrift)(rho)
    stages = [_mk(pkg, "src", 4, 0), _mk(pkg, "x", 6, 1, family=fam_d),
              _mk(pkg, "y", 5, 2, family="lognormal"), _mk(pkg, "z", 3, 3),
              _mk(pkg, "sink", 6, 4, family="lognormal")]
    edges = [("src", "x"), ("src", "y"), ("src", "z"), ("x", "sink"),
             ("y", "sink"), ("z", "sink")]
    return pkg.StageDAG(stages, edges)


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    den = np.linalg.norm(b)
    return float(np.linalg.norm(a - b) / den) if den > 0 else \
        float(np.linalg.norm(a - b))


# ------------------------------------------------------------- validation
_BAD_SPECS = {
    "duplicate names": lambda p: p.StageDAG([_mk(p, "a", 2), _mk(p, "a", 2)]),
    "unknown endpoint": lambda p: p.StageDAG([_mk(p, "a", 2)],
                                             [("a", "ghost")]),
    "self loop": lambda p: p.StageDAG([_mk(p, "a", 2)], [("a", "a")]),
    "duplicate edge": lambda p: p.StageDAG([_mk(p, "a", 2), _mk(p, "b", 2)],
                                           [("a", "b"), ("a", "b")]),
    "cycle": lambda p: p.StageDAG([_mk(p, n, 2) for n in "abcd"],
                                  [("d", "a"), ("a", "b"), ("b", "c"),
                                   ("c", "a")]),
    "depth": lambda p: p.StageDAG(
        [_mk(p, f"s{i}", 2) for i in range(6)],
        p.linear_edges([f"s{i}" for i in range(6)]), max_depth=4),
    "mismatched stats": lambda p: p.Stage("x", np.ones(3), np.ones(2)),
    "negative mean": lambda p: p.Stage("x", np.asarray([1.0, -1.0]),
                                       np.ones(2)),
    "no channels": lambda p: p.Stage("x", np.zeros(0), np.zeros(0)),
    "unknown family": lambda p: p.Stage("x", np.ones(2), np.ones(2),
                                        family="gamma"),
}


@pytest.mark.parametrize("case", sorted(_BAD_SPECS))
def test_validation_errors_match_the_reference(case):
    msgs = {}
    for name, pkg in PKGS.items():
        exc = (pkg.DAGValidationError if case != "unknown family"
               else ValueError)
        with pytest.raises(exc) as err:
            _BAD_SPECS[case](pkg)
        msgs[name] = str(err.value)
    assert msgs["torch"] == msgs["jax"]


@pytest.mark.parametrize("pkg", list(PKGS.values()), ids=list(PKGS))
def test_cycle_error_names_its_path(pkg):
    stages = [_mk(pkg, n, 2) for n in "abc"]
    with pytest.raises(pkg.DAGValidationError,
                       match="cycle detected: a -> b -> c -> a"):
        pkg.StageDAG(stages, [("a", "b"), ("b", "c"), ("c", "a")])


@pytest.mark.parametrize("pkg", list(PKGS.values()), ids=list(PKGS))
def test_depth_bound_and_topology_accessors(pkg):
    names = [f"s{i}" for i in range(6)]
    stages = [_mk(pkg, n, 2) for n in names]
    assert pkg.StageDAG(stages, pkg.linear_edges(names),
                        max_depth=6).depth == 6
    dag = _diamond(pkg)
    assert dag.topo_order == ("a", "b", "c", "d")
    assert dag.sources == ("a",) and dag.sinks == ("d",)
    assert dag.predecessors("d") == ("b", "c")
    assert dag.successors("a") == ("b", "c")
    assert dag.depth == 3
    assert dag.critical_path()[0] == "a" and len(dag.critical_path()) == 3


def test_topology_and_structure_match_the_reference():
    j, t = _mixed(jw), _mixed(tw)
    assert t.structure == j.structure
    assert t.topo_order == j.topo_order and t.depth == j.depth
    assert t.critical_path() == j.critical_path()
    assert [s.dist_id for s in t.stages] == [s.dist_id for s in j.stages]
    assert tw.StageDAG.from_names(["p", "q"], [("p", "q")]).structure == \
        jw.StageDAG.from_names(["p", "q"], [("p", "q")]).structure
    c = convert.dag_from_reference(j)
    assert c.structure == j.structure and c.edges == j.edges
    for a, b in zip(c.stages, j.stages):
        assert np.array_equal(a.mus, b.mus) and a.dist_id == b.dist_id
    live = t.with_stats({"x": t.stages[1].mus * 2}, {}, {"z": "lognormal"})
    assert live.stages[3].dist_id == "lognormal"
    assert np.array_equal(live.stages[1].mus, t.stages[1].mus * 2)


# ------------------------------------------------------------ composition
def _structure(kind):
    if kind == "series":
        names = [f"s{i}" for i in range(4)]
        return jw.StageDAG.from_names(names, jw.linear_edges(names)).structure
    width = 3 if kind == "join3" else 17
    names = ["src"] + [f"b{i}" for i in range(width)] + ["sink", "tail",
                                                         "side"]
    edges = [("src", f"b{i}") for i in range(width)]
    edges += [(f"b{i}", "sink") for i in range(width)]
    edges += [("sink", "tail")]
    # two sinks ("tail", "side"): the makespan folds once more
    return jw.StageDAG.from_names(names, edges).structure


def _moments(S, seed=0, R=3):
    rng = np.random.default_rng(seed)
    mu = rng.uniform(2.0, 12.0, (R, S)).astype(np.float32)
    var = rng.uniform(0.05, 3.0, (R, S)).astype(np.float32)
    var[0, 1] = 0.0          # a deterministic stage
    return mu, var


def _compose_both(kind, seed=0):
    st = _structure(kind)
    mu, var = _moments(len(st[1]), seed=seed)
    want = jax.vmap(lambda m, v: jnp.stack(jdag.compose_structure(st, m, v)))(
        jnp.asarray(mu), jnp.asarray(var))
    (got_mu, got_var), (nm, nv) = tdag.compose_structure(
        st, torch.tensor(mu), torch.tensor(var), return_nodes=True)
    (_, _), (jm, jv) = jdag.compose_structure(st, mu[0], var[0],
                                              return_nodes=True)
    return (got_mu.numpy(), got_var.numpy(), nm[0].numpy(), nv[0].numpy()), \
        (np.asarray(want[:, 0]), np.asarray(want[:, 1]), np.asarray(jm),
         np.asarray(jv))


def _close_var(got, want, mu):
    """|got - want| <= 1e-6 (mu^2 + var): 1e-6 of the second moment the
    variance is cancelled from."""
    bound = 1e-6 * (np.asarray(mu, np.float64) ** 2 + np.abs(want))
    assert np.all(np.abs(np.asarray(got, np.float64) - want) <= bound), \
        np.max(np.abs(np.asarray(got, np.float64) - want) / bound)


@pytest.mark.parametrize("kind", ["series", "join3", "join17"])
def test_compose_structure_matches_the_reference(kind, shared_erf):
    got, want = _compose_both(kind)
    for i in (0, 2):
        np.testing.assert_allclose(got[i], want[i], rtol=1e-6)
    for i in (1, 3):
        _close_var(got[i], want[i], want[i - 1])


@pytest.mark.parametrize("kind", ["series", "join3", "join17"])
def test_compose_structure_with_torch_erf(kind):
    got, want = _compose_both(kind, seed=2)
    for i in (0, 2):
        np.testing.assert_allclose(got[i], want[i], rtol=1e-6)
    for i in (1, 3):
        np.testing.assert_allclose(got[i], want[i], rtol=OWN_ERF_VAR_RTOL)


@pytest.mark.parametrize("kind", ["series", "join3", "join17"])
def test_compose_gradients_match_jax_grad(kind, shared_erf):
    st = _structure(kind)
    mu, var = _moments(len(st[1]), seed=1)
    lam = np.float32(0.3)

    def loss(m, v):
        a, b = jdag.compose_structure(st, m, v)
        return a + lam * b

    gj = jax.vmap(jax.grad(loss, argnums=(0, 1)))(jnp.asarray(mu),
                                                  jnp.asarray(var))
    _, g_mu, g_var = tsolve._compose_grads(st, torch.tensor(mu),
                                           torch.tensor(var), float(lam))
    for got, want in ((g_mu.numpy(), np.asarray(gj[0])),
                      (g_var.numpy(), np.asarray(gj[1]))):
        row_max = np.abs(want).max(axis=1, keepdims=True)
        assert np.all(np.abs(got - want) <= 1e-5 * row_max), \
            np.max(np.abs(got - want) / row_max)


# --------------------------------------------------------------- stacking
def test_stack_rows_groups_pads_and_pins_like_the_reference():
    rows = [(np.array([1.0, 2.0]), np.array([0.1, 0.2]), "normal"),
            (np.array([1.0, 2.0, 3.0]), np.array([0.1, 0.2, 0.3]),
             "lognormal"),
            (np.array([2.0, 1.0]), np.array([0.2, 0.1]), "normal"),
            (np.array([4.0, 3.0]), np.array([0.4, 0.3]),
             JDrift(np.array([0.2, 0.5], np.float32)).state_dict())]
    jrows = rows[:3] + [(rows[3][0], rows[3][1],
                         JDrift(np.array([0.2, 0.5], np.float32)))]
    for kmax in (None, 5):
        tg, tm, tk = tsolve.stack_rows(rows, kmax=kmax)
        jg, jm, jk = jsolve.stack_rows(jrows, kmax=kmax)
        assert tk == jk and np.array_equal(tm, jm)
        assert [g.dist_id for g in tg] == ["normal", "lognormal", "drift"]
        for a, b in zip(tg, jg):
            assert (a.dist_id, a.idx) == (b.dist_id, b.idx)
            for x, y in ((a.mus, b.mus), (a.sigmas, b.sigmas),
                         (a.extra, b.extra)):
                assert x.dtype == np.float32 and np.array_equal(x, y)
    for pkg in (tsolve, jsolve):
        with pytest.raises(ValueError, match="kmax=2"):
            pkg.stack_rows(rows[:2], kmax=2)


def test_masked_projection_matches_the_reference_row_for_row():
    rng = np.random.default_rng(4)
    R, S, K = 3, 4, 7
    v = rng.normal(0.2, 0.6, (R, S, K)).astype(np.float32)
    mask = np.ones((S, K), np.float32)
    mask[1, 5:] = 0.0
    mask[2, 2:] = 0.0
    mask[3, 1:] = 0.0        # one active channel
    v[0, 0] = 1.0 / K        # already on the simplex
    got = tsolve._project_simplex_masked(
        torch.tensor(v), torch.tensor(mask).expand(R, S, K)).numpy()
    want = np.asarray(jax.vmap(jax.vmap(jsolve._project_simplex_masked))(
        jnp.asarray(v), jnp.broadcast_to(jnp.asarray(mask), (R, S, K))))
    np.testing.assert_allclose(got, want, atol=1e-6)
    assert np.all(got[:, mask == 0] == 0.0)
    np.testing.assert_allclose(got.sum(-1), 1.0, atol=1e-6)


# ------------------------------------------------------- stacked launches
def _stacks_both(seed=0, R=3):
    jd, td = _mixed(jw), _mixed(tw)
    groups, mask, kmax = tsolve._stage_groups(td)
    rng = np.random.default_rng(seed)
    e = rng.exponential(size=(R, len(td.stages), kmax)) * mask
    W = (e / e.sum(-1, keepdims=True)).astype(np.float32)
    jg, _, _ = jsolve._stage_groups(jd)
    jargs = (tuple(g.dist_id for g in jg), tuple(g.idx for g in jg),
             tuple((jnp.asarray(g.mus), jnp.asarray(g.sigmas),
                    jnp.asarray(g.extra)) for g in jg))
    stacks = tsolve._Stacks(groups, torch.device(DEV))
    return jd, td, W, jargs, stacks, jg


def test_stage_moments_grads_match_the_reference_on_a_mixed_dag():
    jd, td, W, (dist_ids, idxs, stats), stacks, _ = _stacks_both()
    assert len(stacks.groups) == 3
    want = jax.jit(jsolve._stage_moments_grads, static_argnums=(1, 2, 4, 5,
                                                                6))(
        jnp.asarray(W), dist_ids, idxs, stats, 256, "xla", (None,) * 3)
    got = tsolve._stage_moments_grads(torch.tensor(W), stacks, 256, None)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                               rtol=1e-2, atol=1e-3)
    for g, w in zip(got[2:], want[2:]):
        assert _rel_l2(g.numpy(), w) <= 1e-4
    # padded channels keep zero adjoints in both
    mask = tsolve._stage_groups(td)[1]
    assert np.all(np.asarray(want[2])[:, mask == 0] == 0.0)
    assert np.all(got[2].numpy()[:, mask == 0] == 0.0)


def test_score_dag_matches_the_reference_on_a_mixed_dag():
    jd, td, W, (dist_ids, idxs, stats), stacks, _ = _stacks_both(seed=1)
    want = jsolve._score_dag(jd.structure, dist_ids, idxs, stats,
                             jnp.asarray(W), 512, "xla", (None,) * 3)
    got = tsolve._score_dag(td.structure, stacks, torch.tensor(W), 512, None)
    for i, (rtol, atol) in enumerate(((1e-4, 0), (1e-3, 0), (1e-4, 1e-4),
                                      (1e-2, 1e-3))):
        np.testing.assert_allclose(got[i].numpy(), np.asarray(want[i]),
                                   rtol=rtol, atol=atol)


def test_one_stacked_call_per_family_group(monkeypatch):
    # the mixed DAG has three families: every moment evaluation is three
    # calls, never one per stage
    calls = {"fwd": 0, "grad": 0, "pgrad": 0}
    real_g, real_f = ops.frontier_moments_with_grads, ops.frontier_moments

    def spy_g(*a, **kw):
        calls["pgrad" if kw.get("param_grads") else "grad"] += 1
        return real_g(*a, **kw)

    def spy_f(*a, **kw):
        calls["fwd"] += 1
        return real_f(*a, **kw)

    monkeypatch.setattr(ops, "frontier_moments_with_grads", spy_g)
    monkeypatch.setattr(ops, "frontier_moments", spy_f)
    td = _mixed(tw)
    dec = tw.solve_dag(td, steps=6, restarts=1, num_t=64, device=DEV,
                       plateau_patience=None)
    assert dec.family_groups == 3
    p = dec.profile
    assert p["presolve_steps_run"] == p["refine_steps_run"] == 6
    assert calls == {"fwd": 3 * 2, "grad": 3 * 12, "pgrad": 0}


def test_evaluate_dag_matches_the_reference():
    jd, td = _mixed(jw), _mixed(tw)
    rng = np.random.default_rng(5)
    weights = {s.name: rng.dirichlet(np.ones(s.k)) for s in td.stages}
    weights["z"][1] = 0.0
    want = jw.evaluate_dag(jd, weights, num_t=1024)
    got = tw.evaluate_dag(td, weights, num_t=1024, device=DEV)
    assert got.family_groups == want.family_groups == 3
    assert got.makespan_mu == pytest.approx(want.makespan_mu, rel=1e-4)
    assert got.makespan_var == pytest.approx(want.makespan_var, rel=1e-3)
    np.testing.assert_allclose(got.stage_mu, want.stage_mu, rtol=1e-4)
    for n in weights:
        np.testing.assert_array_equal(got.weights[n], want.weights[n])


# ------------------------------------------------------------- end to end
@pytest.fixture(scope="module")
def smoke():
    """The dag_scale smoke configuration (8 stages, K = 32, T = 128, 30
    steps, one restart), solved jointly and greedily by both packages."""
    with pytest.MonkeyPatch.context() as mp:
        mp.syspath_prepend(str(ROOT))
        import benchmarks.dag_scale as jbench
        jd = jbench.make_dag(2, 3, 32)
    td = tbench.make_dag(2, 3, 32)
    kw = dict(steps=30, restarts=1, num_t=128)
    return {"jd": jd, "td": td,
            "jj": jw.solve_dag(jd, key=jax.random.PRNGKey(0), **kw),
            "jg": jw.solve_dag_greedy(jd, **kw),
            "tj": tw.solve_dag(td, seed=0, device=DEV, **kw),
            "tg": tw.solve_dag_greedy(td, device=DEV, **kw)}


def test_bench_dag_is_the_reference_dag(smoke):
    jd, td = smoke["jd"], smoke["td"]
    assert td.structure == jd.structure
    for a, b in zip(td.stages, jd.stages):
        assert a.name == b.name and np.array_equal(a.mus, b.mus) \
            and np.array_equal(a.sigmas, b.sigmas)


@pytest.mark.parametrize("warm", [False, True])
def test_starts_are_bitwise_the_reference(smoke, warm):
    jd, td = smoke["jd"], smoke["td"]
    _, mask, kmax = tsolve._stage_groups(td)
    ws = smoke["tj"].weights if warm else None
    upd = np.array([1.0 if i % 3 == 0 else 0.0 for i in range(8)],
                   np.float32) if warm else None
    for seed in (0, 7):
        got = tsolve._starts(td, mask, kmax, 2, ws, seed, upd=upd)
        want = jsolve._starts(jd, mask, kmax, 2, ws,
                              jax.random.PRNGKey(seed), upd=upd)
        assert got.dtype == want.dtype and np.array_equal(got, want)


def test_solve_dag_end_to_end_matches_the_reference(smoke):
    jj, jg, tj, tg = smoke["jj"], smoke["jg"], smoke["tj"], smoke["tg"]
    assert tj.method == jj.method == "pgd-dag-joint"
    assert tj.family_groups == jj.family_groups == 1
    assert tj.makespan_mu == pytest.approx(jj.makespan_mu, rel=1e-4)
    assert tj.makespan_var == pytest.approx(jj.makespan_var, rel=1e-2)
    assert tg.makespan_mu == pytest.approx(jg.makespan_mu, rel=1e-4)
    # the joint solve never loses to greedy on the shared evaluator
    assert tj.makespan_mu <= tg.makespan_mu
    assert jj.makespan_mu <= jg.makespan_mu
    for n, w in tj.weights.items():
        assert w.shape == jj.weights[n].shape
        assert abs(w.sum() - 1.0) < 1e-5 and (w >= 0).all()
    assert set(tj.profile) == set(jj.profile)
    assert set(tj.profile["phase_us"]) == set(jj.profile["phase_us"]) == {
        "starts", "presolve", "triage", "refine", "final_score"}
    for key in ("starts", "survivors", "pool", "presolve_num_t",
                "eval_num_t", "presolve_steps_run", "refine_steps_run"):
        assert tj.profile[key] == jj.profile[key], key
    assert set(tg.profile) == set(jg.profile)


def test_plateau_stop_reads_the_host_only_when_it_can_fire():
    td = _diamond(tw, seed=13)
    tsolve.reset_syncs()
    stopped = tw.solve_dag(td, steps=60, restarts=0, num_t=64, device=DEV,
                           plateau_tol=0.5, plateau_patience=2)
    p = stopped.profile
    # every step past the warmup stalls: the refine stops after warmup +
    # patience steps, and the presolve likewise
    assert p["refine_steps_run"] == p["presolve_steps_run"] == 30 + 2
    assert tsolve.SYNCS == {"plateau": 2, "steps": 64}
    tsolve.reset_syncs()
    fixed = tw.solve_dag(td, steps=60, restarts=0, num_t=64, device=DEV,
                         plateau_patience=None)
    assert fixed.profile["refine_steps_run"] == 60
    assert tsolve.SYNCS == {"plateau": 0, "steps": 120}


# ------------------------------------------- incremental, mid-flight, risk
def test_empty_dirty_set_is_the_warm_split_without_pgd(monkeypatch):
    td = _diamond(tw, seed=14)
    dec = tw.solve_dag(td, steps=20, restarts=0, num_t=128, device=DEV)

    def boom(*a, **kw):
        raise AssertionError("a PGD call on an empty dirty set")

    monkeypatch.setattr(ops, "frontier_moments_with_grads", boom)
    monkeypatch.setattr(tsolve, "_pgd_phase", boom)
    dec2 = tw.solve_dag(td, steps=20, restarts=0, num_t=128, device=DEV,
                        warm_start=dec.weights, dirty=set())
    assert dec2.method == "pgd-dag-noop"
    assert dec2.profile["noop"] and dec2.profile["starts"] == 0
    assert set(dec2.profile["phase_us"]) == {"final_score"}
    for s in td.stages:
        assert np.array_equal(dec.weights[s.name], dec2.weights[s.name])
    assert dec2.makespan_mu == pytest.approx(dec.makespan_mu, rel=5e-3)


def test_one_dirty_stage_freezes_every_other_row_bitwise():
    td = _diamond(tw, seed=15)
    dec = tw.solve_dag(td, steps=20, restarts=0, num_t=128, device=DEV)
    dec2 = tw.solve_dag(td, steps=20, restarts=1, num_t=128, device=DEV,
                        warm_start=dec.weights, dirty={"b"})
    assert dec2.method == "pgd-dag-joint-inc"
    for s in td.stages:
        if s.name != "b":
            assert np.array_equal(dec.weights[s.name], dec2.weights[s.name])
    g = tw.solve_dag_greedy(td, steps=10, restarts=0, num_t=128, device=DEV,
                            warm_start=dec.weights, dirty={"c"})
    for s in td.stages:
        if s.name != "c":
            assert np.array_equal(dec.weights[s.name], g.weights[s.name])


def test_dirty_validation_matches_the_reference():
    jd, td = _diamond(jw, seed=16), _diamond(tw, seed=16)
    warm = {s.name: np.full(s.k, 1.0 / s.k) for s in td.stages}
    cases = [dict(dirty={"b"}), dict(dirty={"ghost", "a"}, warm_start=warm)]
    for kw in cases:
        for solver in ("solve_dag", "solve_dag_greedy"):
            errs = []
            for pkg, dag, extra in ((jw, jd, {}), (tw, td, {"device": DEV})):
                with pytest.raises((KeyError, ValueError)) as err:
                    getattr(pkg, solver)(dag, steps=5, num_t=64, **kw,
                                         **extra)
                errs.append((type(err.value), str(err.value)))
            assert errs[0] == errs[1]


def test_done_stage_has_zero_moments_and_shares_of_the_rest():
    td = _diamond(tw, seed=17)
    done = {"b": np.full(3, 1.0 / 3), "c": np.array([0.1, 0.0, 0.2, 0.0,
                                                     0.0])}
    dec = tw.solve_dag(td, steps=10, restarts=0, num_t=128, device=DEV,
                       done=done)
    b = td.names.index("b")
    assert dec.stage_mu[b] < 1e-6 and dec.stage_var[b] < 1e-6
    for w in dec.weights.values():
        assert abs(w.sum() - 1.0) < 1e-5
    full = tw.solve_dag(td, steps=10, restarts=0, num_t=128, device=DEV)
    assert dec.makespan_mu < full.makespan_mu


def _posteriors(td, seed=0):
    """The same NIG posteriors for both packages: five seeded rounds."""
    rng = np.random.default_rng(seed)
    jp, tp = {}, {}
    for s in td.stages:
        nig = j_nig_init(s.k, m0=float(np.mean(s.mus)))
        for _ in range(5):
            rates = rng.normal(s.mus, s.sigmas).astype(np.float32)
            nig = j_nig_update(nig, jnp.asarray(rates),
                               jnp.ones(s.k, jnp.float32))
        jp[s.name] = nig
        tp[s.name] = NIGState(*(torch.tensor(np.asarray(x)) for x in nig))
    return jp, tp


def test_dag_fragility_matches_the_reference():
    jd, td, W, (dist_ids, idxs, stats), stacks, jg = _stacks_both(seed=2)
    jp, tp = _posteriors(td)
    mask_k = tsolve._stage_groups(td)[2]
    smu, svar = tsolve._stage_moments(torch.tensor(W), stacks, 512, None)
    want = jsolve._dag_fragility(
        jd.structure, jg, stats, jsolve._se_stacks(jd, jg, jp, mask_k),
        jnp.asarray(W), jnp.asarray(smu.numpy()), jnp.asarray(svar.numpy()),
        256, "xla", (None,) * 3)
    got = tsolve._dag_fragility(
        td.structure, stacks,
        tsolve._se_stacks(td, stacks.groups, tp, mask_k, torch.device(DEV)),
        torch.tensor(W), smu, svar, 256, None)
    assert np.all(want > 0)
    np.testing.assert_allclose(got, want, rtol=1e-3)


def test_risk_solve_fragility_matches_the_reference():
    jd, td = _diamond(jw, seed=4), _diamond(tw, seed=4)
    jp, tp = _posteriors(td, seed=1)
    kw = dict(steps=20, restarts=0, num_t=128, risk_lam=0.5)
    want = jw.solve_dag(jd, posteriors=jp, **kw)
    got = tw.solve_dag(td, posteriors=tp, device=DEV, **kw)
    assert got.method == want.method == "pgd-dag-joint-risk"
    assert got.makespan_mu == pytest.approx(want.makespan_mu, rel=1e-4)
    assert got.fragility == pytest.approx(want.fragility, rel=1e-3)
    # posteriors without risk: the winner's fragility only
    rep = tw.solve_dag(td, posteriors=tp, device=DEV,
                       **{**kw, "risk_lam": 0.0})
    assert rep.method == "pgd-dag-joint" and rep.fragility > 0
    assert set(rep.profile["phase_us"]) >= {"fragility", "final_score"}
