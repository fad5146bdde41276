"""The composed makespan's reverse pass: ``workflow.solve._compose_grads``
against ``jax.grad`` of the JAX package's jitted ``compose_structure``, and
the ``compose_grads`` kernel (``kernels/compose.py``) against its plain
version.

The plain path (``_compose_grads_plain``: ``compose_structure`` and
``torch.autograd.grad``, what the CPU runs) is held against the reference
on seeded DAGs with a chain, joins wider than the reference's ``lax.scan``
fold threshold (``repro/workflow/dag.py`` ``_SCAN_FOLD_MIN``), several
sinks and a zero-variance stage: the losses to 1e-6 relative and the
gradient (in smu and svar together) to 1e-5 relative L2. With ``lam > 0``
the loss carries Clark's ``var = m2 - m1^2``, which cancels in float32
and which the two frameworks round differently (ROADMAP §3 item 13), so
the same 1e-6 and 1e-5 are taken of the quantities before the
cancellation: the loss's ``mk_mu + lam m2`` and the gradient of
``mk_mu + lam m2`` (``m2 = mk_var + mk_mu^2``); at ``lam = 0`` these are
the plain relative tolerances. The reference's float32 erf is substituted
into the port for that comparison (``shared_erf``, as in
``tests/test_torch_workflow.py``): the two frameworks' erfs differ by a few
ulps (ROADMAP §3 item 2). The kernel runs only on the card (marked
``cuda``), where it is held against its plain version bit for bit (one
framework, one rounding, autograd's order of adds), and a second launch
against the first. Here its plan is checked: the encoding, the shared
memory layout, and the level schedule with its cotangent order replayed in
float32 torch scalar operations (``_replay``, the kernel's arithmetic
operation for operation), which is the plain version bit for bit on the
CPU; and a CUDA tensor is shown never to reach the plain path. JAX is
imported inside the tests that compare with it, so the ``cuda`` cases also
run on a machine without it:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_compose.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core import distributions as td
from repro_torch.kernels import compose
from repro_torch.workflow import StageDAG, linear_edges
from repro_torch.workflow import solve as tsolve


def _xla_erf():
    """The reference's float32 erf as a differentiable torch function."""
    import jax
    import jax.numpy as jnp

    class XlaErf(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            ctx.save_for_backward(x)
            return torch.tensor(np.asarray(jax.lax.erf(jnp.asarray(
                x.detach().numpy()))))

        @staticmethod
        def backward(ctx, g):
            (x,) = ctx.saved_tensors
            return g * (2.0 / np.sqrt(np.pi)) * torch.exp(-x * x)

    return XlaErf.apply


@pytest.fixture
def shared_erf(monkeypatch):
    """The reference's float32 erf in the port."""
    monkeypatch.setattr(td, "_erf", _xla_erf())


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _wide(width, sinks=1, seed=0):
    """src -> ``width`` branches of random length 1-3 -> join; then a tail
    and ``sinks - 1`` side sinks hanging off random branch stages."""
    rng = np.random.default_rng(seed)
    names, edges = ["src"], []
    ends, inner = [], []
    for b in range(width):
        prev = "src"
        for j in range(int(rng.integers(1, 4))):
            n = f"b{b}_{j}"
            names.append(n)
            edges.append((prev, n))
            inner.append(n)
            prev = n
        ends.append(prev)
    names.append("join")
    edges += [(e, "join") for e in ends]
    names.append("tail")
    edges.append(("join", "tail"))
    for s in range(sinks - 1):
        n = f"side{s}"
        names.append(n)
        edges.append((inner[int(rng.integers(len(inner)))], n))
    return names, edges


def _structure(kind):
    """A ``StageDAG.structure`` (the same tuples in both packages,
    ``tests/test_torch_workflow.py``)."""
    if kind == "chain":
        names = [f"s{i}" for i in range(6)]
        return StageDAG.from_names(names, linear_edges(names)).structure
    if kind == "fanout_levels":
        # s feeds a (level 1), x (level 1) and the join b (level 3): a
        # multi-consumer node whose consumers sit on different levels
        names = ["s", "a", "x", "y", "b", "t"]
        edges = [("s", "a"), ("s", "x"), ("x", "y"), ("y", "b"), ("s", "b"),
                 ("a", "t"), ("b", "t")]
        return StageDAG.from_names(names, edges).structure
    if kind == "wide_join":
        # a source, 1500 branches, one join: state past 227 KB a row
        n = 1500
        return ((0, *range(1, n + 1), n + 1),
                ((),) + ((0,),) * n + (tuple(range(1, n + 1)),), (n + 1,))
    if kind.startswith("dag_scale"):
        from repro_torch.bench import dag_scale
        branches = 170 if kind.endswith("512") else 10
        return dag_scale.make_dag(branches, 3, 2).structure
    width, sinks = {"join16": (16, 1), "join24_sinks3": (24, 3),
                    "join5_sinks4": (5, 4)}[kind]
    names, edges = _wide(width, sinks, seed=width)
    return StageDAG.from_names(names, edges).structure


def _moments(S, seed, R=3):
    rng = np.random.default_rng(seed)
    mu = rng.uniform(2.0, 12.0, (R, S)).astype(np.float32)
    var = rng.uniform(0.05, 3.0, (R, S)).astype(np.float32)
    r = min(2, R - 1)
    var[0, 1] = 0.0                 # a deterministic stage
    var[min(1, R - 1), 0] = 0.0     # a deterministic source
    mu[r, 2] = mu[r, 3]             # an exact tie
    return mu, var


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    den = np.linalg.norm(b)
    return float(np.linalg.norm(a - b) / den) if den > 0 else \
        float(np.linalg.norm(a - b))


KINDS = ["chain", "join16", "join24_sinks3", "join5_sinks4"]


@pytest.mark.parametrize("lam", [0.0, 0.3])
@pytest.mark.parametrize("kind", KINDS)
def test_plain_compose_grads_match_jax_grad(kind, lam, shared_erf):
    import jax
    import jax.numpy as jnp
    from repro.workflow import dag as jdag
    st = _structure(kind)
    mu, var = _moments(len(st[1]), seed=len(st[1]))
    lam32 = np.float32(lam)

    def loss(m, v):
        a, b = jdag.compose_structure(st, m, v)
        return a + lam32 * b

    def before_cancellation(m, v):
        a, b = jdag.compose_structure(st, m, v)
        return a + lam32 * (b + a * a)

    args = (jnp.asarray(mu), jnp.asarray(var))
    want_l = np.asarray(jax.vmap(loss)(*args), np.float64)
    scale_l = np.asarray(jax.vmap(before_cancellation)(*args), np.float64)
    want_g = np.concatenate([np.asarray(g) for g in jax.vmap(jax.grad(
        loss, argnums=(0, 1)))(*args)], axis=1)
    scale_g = np.concatenate([np.asarray(g) for g in jax.vmap(jax.grad(
        before_cancellation, argnums=(0, 1)))(*args)], axis=1)
    losses, g_mu, g_var = tsolve._compose_grads(st, torch.tensor(mu),
                                                torch.tensor(var),
                                                float(lam32))
    got_g = np.concatenate([g_mu.numpy(), g_var.numpy()], axis=1)
    assert np.all(np.isfinite(got_g))
    assert np.all(np.abs(losses.numpy() - want_l) <= 1e-6 * np.abs(scale_l))
    assert np.linalg.norm(got_g - want_g) <= 1e-5 * np.linalg.norm(scale_g)
    if lam == 0.0:
        np.testing.assert_allclose(losses.numpy(), want_l, rtol=1e-6)
        assert _rel_l2(got_g, want_g) <= 1e-5


@pytest.mark.parametrize("kind", KINDS)
def test_structure_encoding(kind):
    st = _structure(kind)
    topo, preds, sinks = st
    a = compose.encode_arrays(st)
    t, off, idx, sk, steps = a[:5]
    assert all(x.dtype == np.int32 for x in a if isinstance(x, np.ndarray))
    assert t.tolist() == list(topo) and sk.tolist() == list(sinks)
    assert off[0] == 0 and off[-1] == len(idx)
    for i, p in enumerate(preds):
        # each stage's predecessors in the order _fold_max folds them
        assert idx[off[i]:off[i + 1]].tolist() == list(p)
    joins = sum(len(p) - 1 for p in preds if len(p) > 1)
    assert steps == joins + (len(sinks) - 1 if len(sinks) > 1 else 0)
    enc = compose.encode(st, "cpu")
    assert enc.n_steps == steps and enc.S == len(topo)
    ints, hdr = compose.layout(a)
    assert enc.ints.dtype == torch.int32          # the kernel's ints
    assert enc.ints.tolist() == ints.tolist()
    assert list(enc.header) == hdr.tolist()
    h = dict(zip(compose.HEADER, hdr.tolist()))
    for name, sec in (("pred_off", off), ("pred_idx", idx), ("sinks_at", sk),
                      ("nodes", a.lvl_nodes), ("mref", a.mref),
                      ("vref", a.vref)):
        assert ints[h[name]:h[name] + len(sec)].tolist() == sec.tolist()
    # the solve's stacks hold the plan on a card only
    assert tsolve._Stacks([], torch.device("cpu"), st).compose is None


def _levels_ok(st, a):
    """Every node sits one level past its deepest predecessor, and the
    levels list each node once."""
    topo, preds, _ = st
    level = np.empty(len(preds), int)
    for L in range(len(a.lvl_off) - 1):
        level[a.lvl_nodes[a.lvl_off[L]:a.lvl_off[L + 1]]] = L
    assert sorted(a.lvl_nodes.tolist()) == list(range(len(preds)))
    for i, p in enumerate(preds):
        assert level[i] == (1 + max(level[list(p)]) if p else 0)


F32 = torch.float32
_ZERO = torch.tensor(0.0, dtype=F32)
_ONE = torch.tensor(1.0, dtype=F32)
_INV_SQRT2 = 0.7071067811865476
_INV_SQRT_2PI = 0.3989422804014327
_TWO_OVER_SQRT_PI = 1.1283791670955126


def _fold_item(mu2, v2):
    """``csrc/compose.cu`` ``fold_item`` in float32 torch scalars."""
    s2 = torch.sqrt(torch.clamp_min(v2, 1e-18))
    return {"mu2": mu2, "v2": v2, "s2": s2, "B": mu2 * mu2 + s2 * s2}


def _clark_chain(mu1, v1, f):
    """``clark_chain``: the step's record from its item side ``f``, and its
    variance."""
    mu2, s2 = f["mu2"], f["s2"]
    s1 = torch.sqrt(torch.clamp_min(v1, 1e-18))
    a2 = s1 * s1 + s2 * s2
    a = torch.sqrt(torch.clamp_min(a2, 0.0))
    ok = bool(a > 0.0)
    den = a if ok else _ONE
    alpha = (mu1 - mu2) / den
    u = alpha * _INV_SQRT2
    P = 0.5 * (1.0 + torch.erf(u))
    ha = -0.5 * alpha
    ex = torch.exp(ha * alpha)
    cdf = P if ok else (_ONE if bool(mu1 >= mu2) else _ZERO)
    pdf = ex * _INV_SQRT_2PI if ok else _ZERO
    omc = 1.0 - cdf
    m1 = (mu1 * cdf + mu2 * omc) + a * pdf
    A = mu1 * mu1 + s1 * s1
    sum12 = mu1 + mu2
    Cc = sum12 * a
    vr = ((A * cdf + f["B"] * omc) + Cc * pdf) - m1 * m1
    f.update(mu1=mu1, v1=v1, s1=s1, a2=a2, a=a, ok=ok, den=den, alpha=alpha,
             ha=ha, ex=ex, cdf=cdf, pdf=pdf, omc=omc, m1=m1, A=A,
             sum12=sum12, Cc=Cc, vr=vr)
    return torch.clamp_min(vr, 0.0)


def _fold_after(f):
    """``fold_after``: what only the reverse reads."""
    u = f["alpha"] * _INV_SQRT2
    f.update(eu=torch.exp(-(u * u)) * _TWO_OVER_SQRT_PI,
             ad=f["alpha"] / f["den"])


def _clark_bwd(f, gm, gv):
    """``clark_bwd``: the reverse chain of a step; stores its g_m2, g_m1,
    g_d, g_a2 in the record, returns the accumulator's (gm, gv)."""
    ok = f["ok"]
    g_m2 = gv if bool(f["vr"] >= 0.0) else _ZERO
    g_mm = -g_m2
    g_m1 = (gm + g_mm * f["m1"]) + g_mm * f["m1"]
    g_y9 = g_m2 * f["pdf"]
    g_y8 = g_y9 * f["a"]
    g_A = g_m2 * f["cdf"]
    g_cdf = -(g_m2 * f["B"])
    g_cdf = g_cdf + g_m2 * f["A"]
    g_cdf = g_cdf + -(g_m1 * f["mu2"])
    g_cdf = g_cdf + g_m1 * f["mu1"]
    g_pdf = g_m2 * f["Cc"] + g_m1 * f["a"]
    g_P = g_cdf if ok else _ZERO
    g_ph = g_pdf if ok else _ZERO
    g_q = (g_ph * _INV_SQRT_2PI) * f["ex"]
    g_alpha = g_q * f["ha"] + (g_q * f["alpha"]) * -0.5
    g_u = f["eu"] * (g_P * 0.5)
    g_alpha = g_alpha + g_u * _INV_SQRT2
    g_d = g_alpha / f["den"]
    g_den = -g_alpha * f["ad"]
    g_a = g_y9 * f["sum12"]
    g_a = g_a + g_m1 * f["pdf"]
    g_a = g_a + (g_den if ok else _ZERO)
    g_ca = g_a / (2.0 * f["a"])
    g_a2 = g_ca if bool(f["a2"] >= 0.0) else _ZERO
    g_s1 = g_A * f["s1"]
    for g in (g_A, g_a2, g_a2):
        g_s1 = g_s1 + g * f["s1"]
    ngv = g_s1 / (2.0 * f["s1"]) if bool(f["v1"] >= 1e-18) else _ZERO
    ngm = g_y8
    for g in (g_A * f["mu1"], g_A * f["mu1"], g_m1 * f["cdf"], g_d):
        ngm = ngm + g
    f.update(g_m2=g_m2, g_m1=g_m1, g_d=g_d, g_a2=g_a2)
    return ngm, ngv


def _fold_edges(f, first):
    """``fold_edges``: (item's five mu edges, its var edge) and, for a
    fold's first step, item 0's."""
    g_y8 = (f["g_m2"] * f["pdf"]) * f["a"]
    g_B = f["g_m2"] * f["omc"]
    e2 = [g_y8, g_B * f["mu2"], g_B * f["mu2"], f["g_m1"] * f["omc"],
          -f["g_d"]]
    g_s2 = g_B * f["s2"]
    for g in (g_B, f["g_a2"], f["g_a2"]):
        g_s2 = g_s2 + g * f["s2"]
    ev2 = (g_s2 / (2.0 * f["s2"]) if bool(f["v2"] >= 1e-18) else _ZERO)
    if not first:
        return e2, ev2, None, None
    g_A = f["g_m2"] * f["cdf"]
    e1 = [g_y8, g_A * f["mu1"], g_A * f["mu1"], f["g_m1"] * f["cdf"],
          f["g_d"]]
    g_s1 = g_A * f["s1"]
    for g in (g_A, f["g_a2"], f["g_a2"]):
        g_s1 = g_s1 + g * f["s1"]
    ev1 = (g_s1 / (2.0 * f["s1"]) if bool(f["v1"] >= 1e-18) else _ZERO)
    return e2, ev2, e1, ev1


def _replay(st, mu, var, lam32):
    """The kernel's schedule (``compose.encode_arrays``) replayed on the CPU
    in float32 torch scalar operations, operation for operation as
    ``csrc/compose.cu`` does it: each level's fold steps' item sides (its
    group of ``lst``), then its nodes (a join's chain of records); the
    sinks; every step's after-values; then the levels in reverse, each
    node's cotangent summed from zero over its sources in the plan's order
    (U), each join's reverse chain, then its group's edges."""
    a = compose.encode_arrays(st)
    S, nf = len(a.topo), a.n_folds
    emu0, ev0 = 2 * (S + 1), 2 * (S + 1) + 5 * nf
    n_levels = len(a.lvl_off) - 1
    groups = [a.lst.reshape(-1, 3)[a.lst_off[g]:a.lst_off[g + 1]]
              for g in range(n_levels + 1)]
    out = []
    for r in range(mu.shape[0]):
        m_r = [torch.tensor(x, dtype=F32) for x in mu[r]]
        v_r = [torch.tensor(x, dtype=F32) for x in var[r]]
        cm, cv, rec = [None] * S, [None] * S, [None] * nf
        U = [None] * (ev0 + nf)

        def items_of(g):
            for e, it, _ in groups[g]:
                rec[e] = _fold_item(cm[it], cv[it])

        def edges_of(g):
            for e, _, first in groups[g]:
                e2, ev2, e1, ev1 = _fold_edges(rec[e], bool(first))
                U[emu0 + 5 * e:emu0 + 5 * e + 5] = e2
                U[ev0 + e] = ev2
                if first:
                    U[emu0 + 5 * (e - 1):emu0 + 5 * e] = e1
                    U[ev0 + e - 1] = ev1

        def fold_fwd(items, fb):
            m, v = cm[items[0]], cv[items[0]]
            for j in range(1, len(items)):
                v = _clark_chain(m, v, rec[fb + j])
                m = rec[fb + j]["m1"]
            return m, v

        def fold_bwd(w, fb, gm, gv):
            for j in range(w - 1, 0, -1):
                gm, gv = _clark_bwd(rec[fb + j], gm, gv)

        levels = [a.lvl_nodes[a.lvl_off[L]:a.lvl_off[L + 1]]
                  for L in range(n_levels)]
        for L, nodes in enumerate(levels):
            items_of(L)
            for i in nodes:
                p0, p1 = a.pred_off[i], a.pred_off[i + 1]
                if p1 == p0:
                    cm[i], cv[i] = m_r[i], v_r[i]
                    continue
                if p1 - p0 == 1:
                    m, v = cm[a.pred_idx[p0]], cv[a.pred_idx[p0]]
                else:
                    m, v = fold_fwd(a.pred_idx[p0:p1], a.fbase[i])
                cm[i], cv[i] = m + m_r[i], v + v_r[i]
        sk = a.sinks
        items_of(n_levels)
        if len(sk) == 1:
            mk_m, mk_v = cm[sk[0]], cv[sk[0]]
        else:
            mk_m, mk_v = fold_fwd(sk, a.sink_base)
        loss = mk_m + lam32 * mk_v
        lam = torch.tensor(lam32, dtype=F32)
        U[S], U[2 * S + 1] = _ONE, lam
        for e, _, _ in a.lst.reshape(-1, 3):
            _fold_after(rec[e])
        if len(sk) > 1:
            fold_bwd(len(sk), a.sink_base, _ONE, lam)
            edges_of(n_levels)
        for L in reversed(range(n_levels)):
            for i in levels[L]:
                g, h = _ZERO, _ZERO
                for q in a.mref[a.mref_off[i]:a.mref_off[i + 1]]:
                    g = g + U[q]
                for q in a.vref[a.vref_off[i]:a.vref_off[i + 1]]:
                    h = h + U[q]
                U[i], U[S + 1 + i] = g, h
                w = a.pred_off[i + 1] - a.pred_off[i]
                if w > 1:
                    fold_bwd(w, a.fbase[i], g, h)
            edges_of(L)
        out.append((loss, torch.stack(U[:S]), torch.stack(U[S + 1:2 * S + 1])))
    return tuple(torch.stack(x) for x in zip(*out))


def _bits(t):
    return t.contiguous().view(torch.int32)


@pytest.mark.parametrize("lam", [0.0, 0.05])
@pytest.mark.parametrize("kind", KINDS + ["dag_scale", "dag_scale_512"])
def test_level_schedule_is_autograds_order(kind, lam):
    """The plan's levels and cotangent order, replayed on the CPU, are the
    plain version bit for bit: the lanes' order is autograd's."""
    st = _structure(kind)
    a = compose.encode_arrays(st)
    _levels_ok(st, a)
    mu, var = _moments(len(st[1]), seed=7)
    lam32 = float(np.float32(lam))
    want = tsolve._compose_grads_plain(st, torch.tensor(mu),
                                       torch.tensor(var), lam32)
    got = _replay(st, mu, var, lam32)
    for g, w in zip(got, want):
        assert torch.equal(_bits(g), _bits(w))


@pytest.mark.parametrize("kind", KINDS + ["dag_scale", "dag_scale_512",
                                          "fanout_levels", "wide_join"])
def test_the_plan_fits_shared_memory_or_says_so(kind):
    """The header's sections and sizes: the state a row needs, in shared
    memory where it fits 227 KB, else 0 (a device-memory workspace)."""
    st = _structure(kind)
    a = compose.encode_arrays(st)
    ints, hdr = compose.layout(a)
    h = dict(zip(compose.HEADER, hdr.tolist()))
    S = len(st[0])
    assert len(ints) % 4 == 0 and h["ints"] == len(ints)
    assert h["rec"] % 4 == 0 and h["floats"] % 4 == 0
    assert h["floats"] == h["rec"] + compose.REC_FLOATS * a.n_folds
    assert h["U"] + 2 * (S + 1) + 6 * a.n_folds <= h["rec"]
    need = 4 * (len(ints) + h["floats"])
    assert h["smem"] == (need if need <= compose.SMEM_MAX else 0)
    # every fold edge has its two cotangents taken exactly once, and every
    # fold step sits in one group, a fold's first step flagged
    n_fold_refs = sum(1 for r in a.vref if r >= 2 * (S + 1))
    assert n_fold_refs == a.n_folds
    steps = a.lst.reshape(-1, 3)
    assert len(steps) == a.n_steps == a.lst_off[-1]
    assert len(a.lst_off) == len(a.lvl_off) + 1
    assert len(set(steps[:, 0].tolist())) == a.n_steps
    assert sum(steps[:, 2]) == sum(len(p) > 1 for p in st[1]) + (
        len(st[2]) > 1)
    if kind == "wide_join":
        assert h["smem"] == 0
    if kind == "dag_scale_512":
        assert 0 < h["smem"] < 64 * 1024


class _CudaLooking(torch.Tensor):
    """A CPU tensor that reports itself a CUDA tensor, to follow the
    dispatch without a card."""

    @property
    def is_cuda(self):
        return True


def test_a_cuda_tensor_never_reaches_the_plain_path(monkeypatch):
    st = _structure("join5_sinks4")
    mu, var = _moments(len(st[1]), seed=0)

    def plain(*a, **k):
        raise AssertionError("the plain version ran for a CUDA tensor")

    def build():
        raise RuntimeError("compose kernel build")

    monkeypatch.setattr(tsolve, "_compose_grads_plain", plain)
    monkeypatch.setattr(compose, "build", build)
    smu = torch.tensor(mu).as_subclass(_CudaLooking)
    svar = torch.tensor(var).as_subclass(_CudaLooking)
    with pytest.raises(RuntimeError, match="compose kernel build"):
        tsolve._compose_grads(st, smu, svar, 0.1)
    # and the kernel's wrapper refuses CPU tensors instead of computing
    with pytest.raises(ValueError, match="CUDA tensors"):
        compose.compose_grads(compose.encode(st, "cpu"), torch.tensor(mu),
                              torch.tensor(var), 0.1)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; chip_smoke.py runs these checks "
                    "on the card")
    return torch.device("cuda")


def _hold_on_the_card(st, mu, var, lam, card):
    """The kernel against its plain version on the card, bit for bit, and
    a second launch against the first."""
    smu, svar = torch.tensor(mu, device=card), torch.tensor(var, device=card)
    lam32 = float(np.float32(lam))
    n = compose.LAUNCHES["compose_grads"]
    got = tsolve._compose_grads(st, smu, svar, lam32)
    assert compose.LAUNCHES["compose_grads"] == n + 1
    want = tsolve._compose_grads_plain(st, smu, svar, lam32)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(_bits(g), _bits(w))
    again = tsolve._compose_grads(st, smu, svar, lam32)
    assert all(torch.equal(_bits(a), _bits(b)) for a, b in zip(got, again))


@pytest.mark.cuda
@pytest.mark.parametrize("lam", [0.0, 0.05])
@pytest.mark.parametrize("kind", KINDS + ["dag_scale", "dag_scale_512",
                                          "fanout_levels", "wide_join"])
def test_kernel_matches_plain_on_the_card(card, kind, lam):
    st = _structure(kind)
    mu, var = _moments(len(st[1]), seed=3, R=5)
    _hold_on_the_card(st, mu, var, lam, card)


@pytest.mark.cuda
@pytest.mark.parametrize("lam", [0.0, 0.05])
@pytest.mark.parametrize("R", [1, 20, 33])
def test_kernel_rows_on_the_card(card, R, lam):
    """One block a row at the scale point: R = 1 (the refine step), 20 (the
    solver's starts), 33 (past a warp of rows)."""
    st = _structure("dag_scale_512")
    mu, var = _moments(len(st[1]), seed=R, R=R)
    _hold_on_the_card(st, mu, var, lam, card)


@pytest.mark.cuda
def test_the_solve_uploads_its_structure_once(card, monkeypatch):
    from repro_torch.bench import dag_scale
    calls = []
    encode = compose.encode

    def counted(structure, device):
        calls.append(structure)
        return encode(structure, device)

    monkeypatch.setattr(compose, "encode", counted)
    dag = dag_scale.make_dag(4, 3, 8)
    n = compose.LAUNCHES["compose_grads"]
    tsolve.solve_dag(dag, steps=12, restarts=1, num_t=256, device=card)
    assert compose.LAUNCHES["compose_grads"] > n + 1
    assert calls == [dag.structure]


def _direct_readings():
    """The plain path against ``jax.grad`` of the reference at each case of
    ``test_plain_compose_grads_match_jax_grad``, read directly: the losses'
    largest relative error and the gradients' relative L2 (smu, svar and
    both), with the reference's erf substituted."""
    import jax
    import jax.numpy as jnp
    from repro.workflow import dag as jdag
    saved, td._erf = td._erf, _xla_erf()
    try:
        for kind in KINDS:
            for lam in (0.0, 0.3):
                st = _structure(kind)
                mu, var = _moments(len(st[1]), seed=len(st[1]))
                lam32 = np.float32(lam)

                def loss(m, v):
                    a, b = jdag.compose_structure(st, m, v)
                    return a + lam32 * b

                args = (jnp.asarray(mu), jnp.asarray(var))
                want_l = np.asarray(jax.vmap(loss)(*args), np.float64)
                gm, gv = (np.asarray(g) for g in jax.vmap(jax.grad(
                    loss, argnums=(0, 1)))(*args))
                got_l, g_mu, g_var = tsolve._compose_grads(
                    st, torch.tensor(mu), torch.tensor(var), float(lam32))
                g_mu, g_var = g_mu.numpy(), g_var.numpy()
                loss_rel = np.max(np.abs(got_l.numpy() - want_l)
                                  / np.abs(want_l))
                both = _rel_l2(np.concatenate([g_mu, g_var], 1),
                               np.concatenate([gm, gv], 1))
                print(f"{kind:14s} lam {lam}: losses rel {loss_rel:.2e}, "
                      f"gradient rel L2 smu {_rel_l2(g_mu, gm):.2e} svar "
                      f"{_rel_l2(g_var, gv):.2e} both {both:.2e}")
    finally:
        td._erf = saved


if __name__ == "__main__":
    # PYTHONPATH=src python tests/test_torch_compose.py
    torch.set_num_threads(1)
    _direct_readings()
