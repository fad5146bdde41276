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
ulps (ROADMAP §3 item 2). The kernel against its plain version (one
framework, one rounding) is held at 1e-6 and 1e-5 relative directly. The kernel runs only on the card (marked
``cuda``, held to the same tolerances against the plain version there);
here its structure encoding is checked and a CUDA tensor is shown never to
reach the plain path. JAX is imported inside the tests that compare with
it, so the ``cuda`` cases also run on a machine without it:

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
    var[0, 1] = 0.0           # a deterministic stage
    var[1, 0] = 0.0           # a deterministic source
    mu[2, 2] = mu[2, 3]       # an exact tie
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
    t, off, idx, sk, steps = compose.encode_arrays(st)
    assert t.dtype == off.dtype == idx.dtype == sk.dtype == np.int32
    assert t.tolist() == list(topo) and sk.tolist() == list(sinks)
    assert off[0] == 0 and off[-1] == len(idx)
    for i, p in enumerate(preds):
        # each stage's predecessors in the order _fold_max folds them
        assert idx[off[i]:off[i + 1]].tolist() == list(p)
    joins = sum(len(p) - 1 for p in preds if len(p) > 1)
    assert steps == joins + (len(sinks) - 1 if len(sinks) > 1 else 0)
    enc = compose.encode(st, "cpu")
    assert enc.n_steps == steps and enc.topo.tolist() == t.tolist()
    assert all(a.dtype == torch.int32 for a in enc[:4])   # the kernel's ints
    assert enc.pred_idx[:len(idx)].tolist() == idx.tolist()
    assert enc.pred_off.tolist() == off.tolist()
    assert enc.sinks.tolist() == sk.tolist()
    # the solve's stacks hold the arrays on a card only
    assert tsolve._Stacks([], torch.device("cpu"), st).compose is None


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


@pytest.mark.cuda
@pytest.mark.parametrize("lam", [0.0, 0.05])
@pytest.mark.parametrize("kind", KINDS + ["dag_scale", "dag_scale_512"])
def test_kernel_matches_plain_on_the_card(card, kind, lam):
    st = _structure(kind)
    mu, var = _moments(len(st[1]), seed=3, R=5)
    smu, svar = torch.tensor(mu, device=card), torch.tensor(var, device=card)
    lam32 = float(np.float32(lam))
    n = compose.LAUNCHES["compose_grads"]
    got = tsolve._compose_grads(st, smu, svar, lam32)
    assert compose.LAUNCHES["compose_grads"] == n + 1
    want = tsolve._compose_grads_plain(st, smu, svar, lam32)
    torch.cuda.synchronize()
    np.testing.assert_allclose(got[0].cpu().numpy(), want[0].cpu().numpy(),
                               rtol=1e-6)
    for g, w in zip(got[1:], want[1:]):
        assert _rel_l2(g.cpu().numpy(), w.cpu().numpy()) <= 1e-5
    again = tsolve._compose_grads(st, smu, svar, lam32)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


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
