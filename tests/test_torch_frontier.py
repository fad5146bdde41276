"""The port's frontier oracle, kernel wrappers, dispatch and launch shapes
against the JAX package.

The same numpy inputs (made from a seed) go through ``repro.kernels.ref``
(and ``repro.kernels.ops`` on its ``impl="xla"`` path) and through
``repro_torch`` on ``device="cpu"``, where every wrapper runs its kernel's
plain version.

Tolerances: ``mu`` rtol = atol = 1e-4; ``var`` rtol 1e-2, atol 1e-3
(``tests/test_kernels.py``); every adjoint relative L2 <= 1e-4
(``tests/test_frontier_grads.py``). The adjoints are held to 1e-4 with the
reference's erf substituted into the port (``shared_erf``), which isolates
the algorithm. With each framework's own float32 erf (up to 5 ulps apart)
the mu-adjoints still read under 4e-5 and are held to 1e-4; the var
cancellation amplifies the erf difference in the var-adjoints to at most
3.7e-4 over the seeds and shapes of ROADMAP section 3, so they alone are
held to 5e-4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import distributions as jd
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.core import distributions as td
from repro_torch.core import (clark_max_moments_2, clark_max_moments_seq,
                              equal_split, inverse_mu_split, joint_cdf,
                              predict_moments)
from repro_torch.kernels import autotune, ops
from repro_torch.kernels import frontier_grid as fg
from repro_torch.kernels import ref
from repro_torch.launch import serve as serve_cli
from repro_torch.models import build_model
from repro_torch.sched import UncertaintyAwareBalancer
from repro_torch.serve import PartitionedBatcher, ReplicaGroup, ServeEngine


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # the tensors here are tiny: intra-op threads only contend with the
    # other test workers
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


F, K, T = 24, 8, 256
ADJ_TOL = 1e-4
ADJ_TOL_OWN_ERF_VAR = 5e-4


def _xla_erf(x):
    y = np.asarray(jax.lax.erf(jnp.asarray(x.detach().cpu().numpy())))
    return torch.tensor(y, device=x.device)


@pytest.fixture
def shared_erf(monkeypatch):
    monkeypatch.setattr(td, "_erf", _xla_erf)


def _case(fam, per_row, seed=0, F=F, K=K):
    """Inputs with the edge rows: a zero weight (row 0), a zero sigma
    (channel 3), p = 0 (defective, channel 5), an argmax tie between
    identical channels 0 and 1 (rows 2 and 3)."""
    rng = np.random.default_rng(seed)
    W = rng.dirichlet(np.ones(K), F)
    W[0, 7] = 0.0
    shape = (F, K) if per_row else (K,)
    mus = rng.uniform(10.0, 40.0, shape)
    sgs = mus * rng.uniform(0.02, 0.3, shape)
    sgs[..., 3] = 0.0
    mus[..., 1] = mus[..., 0]
    sgs[..., 1] = sgs[..., 0]
    W[2:4, 0] = W[2:4, 1] = 0.5
    W[2:4, 2:] = 0.0
    W = W / W.sum(1, keepdims=True)
    if fam == "drift":
        ex = rng.uniform(0.0, 0.8, (1,) + shape)
        ex[:, ..., 1] = ex[:, ..., 0]
    elif fam == "defective":
        ex = np.stack([rng.uniform(0.02, 0.3, shape), np.full(shape, 1.0)])
        ex[0, ..., 5] = 0.0
        ex[0, ..., 1] = ex[0, ..., 0]
    elif fam == "empirical":
        pis = np.moveaxis(rng.dirichlet(np.ones(3), shape), -1, 0)
        ms = mus[None] * rng.uniform(0.7, 1.3, (3,) + shape)
        ss = np.maximum(sgs[None], 0.5) * rng.uniform(0.3, 1.0, (3,) + shape)
        ss[2, ..., 6] = 0.0
        ex = np.concatenate([pis, ms, ss])
        ex[:, ..., 1] = ex[:, ..., 0]
    else:
        ex = np.zeros((1,) + shape)
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    return f32(W), f32(mus), f32(sgs), f32(ex)


def _t(*arrays):
    return tuple(torch.tensor(a) for a in arrays)


def _rel_l2(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    n = np.linalg.norm(b)
    return np.linalg.norm(a - b) / (n if n > 0 else 1.0)


def _check(got, want, adj_tol, var_adj_tol=None):
    """mu, var, then (d mu, d var) adjoint pairs; ``var_adj_tol`` (default
    ``adj_tol``) holds the var-adjoints."""
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                               rtol=1e-2, atol=1e-3)
    for i, (g, w) in enumerate(zip(got[2:], want[2:])):
        tol = adj_tol if i % 2 == 0 or var_adj_tol is None else var_adj_tol
        assert _rel_l2(g.numpy(), w) <= tol, (i, _rel_l2(g.numpy(), w))


MODES = ("fwd", "grad", "pgrad")


def _run_both(fam, per_row, mode, seed=0):
    W, mus, sgs, ex = _case(fam, per_row, seed)
    if mode == "fwd":
        want = jref.frontier_grid_ref(W, mus, sgs, num_t=T, dist_id=fam,
                                      extra=ex)
        got = ref.frontier_grid_ref(*_t(W, mus, sgs), num_t=T, dist_id=fam,
                                    extra=torch.tensor(ex))
    else:
        pg = mode == "pgrad"
        want = jref.frontier_grid_with_grads_ref(
            W, mus, sgs, num_t=T, dist_id=fam, extra=ex, param_grads=pg)
        got = ref.frontier_grid_with_grads_ref(
            *_t(W, mus, sgs), num_t=T, dist_id=fam, extra=torch.tensor(ex),
            param_grads=pg)
    assert len(got) == len(want)
    return got, want


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("per_row", [False, True], ids=["shared", "per_row"])
@pytest.mark.parametrize("fam", td.FAMILIES)
def test_plain_version_matches_reference(fam, per_row, mode, shared_erf):
    got, want = _run_both(fam, per_row, mode)
    _check(got, want, ADJ_TOL)


@pytest.mark.parametrize("fam", td.FAMILIES)
def test_plain_version_with_torch_erf(fam):
    for per_row in (False, True):
        for seed in range(4):
            got, want = _run_both(fam, per_row, "pgrad", seed=seed)
            _check(got, want, ADJ_TOL, ADJ_TOL_OWN_ERF_VAR)


def test_grid_is_j_over_t_minus_one():
    fr = ref.time_fractions(7, "cpu")
    assert fr.dtype == torch.float32
    np.testing.assert_array_equal(
        fr.numpy(), np.arange(7, dtype=np.float32) / np.float32(6))
    with pytest.raises(ValueError):
        ref.time_fractions(1, "cpu")


def test_ties_split_the_grid_term_and_degenerate_rows_get_no_direct_term():
    W, mus, sgs, ex = _case("normal", False)
    out = ref.frontier_grid_with_grads_ref(*_t(W, mus, sgs), num_t=T,
                                           extra=torch.tensor(ex))
    dmu = out[2].numpy()
    assert dmu[2, 0] == dmu[2, 1] and dmu[2, 0] != 0.0
    # a zero-sigma channel is a point mass: no direct term unless it sets
    # the grid end
    reach = W * mus + 10.0 * W * sgs
    rows = np.flatnonzero(np.argmax(reach, 1) != 3)
    assert np.all(dmu[rows, 3] == 0.0)


def test_pv_accumulators_do_not_cancel_when_var_is_tiny():
    # var << mu^2: a tight fleet far from zero
    W = np.full((2, 4), 0.25, np.float32)
    mus = np.array([100.0, 100.5, 99.7, 100.2], np.float32)
    sgs = np.full(4, 4.0, np.float32)
    got = ref.frontier_grid_with_grads_ref(*_t(W, mus, sgs), num_t=512)
    want = jref.frontier_grid_with_grads_ref(W, mus, sgs, num_t=512)
    assert float(got[1][0]) > 0.0
    assert _rel_l2(got[2].numpy(), want[2]) <= ADJ_TOL
    assert _rel_l2(got[3].numpy(), want[3]) <= ADJ_TOL_OWN_ERF_VAR


@pytest.mark.parametrize("fam", td.FAMILIES)
def test_wrappers_on_cpu_run_the_plain_version(fam):
    W, mus, sgs, ex = _t(*_case(fam, False))
    a = fg.frontier_grid(W, mus, sgs, ex, num_t=T, dist_id=fam)
    b = ref.frontier_grid_ref(W, mus, sgs, num_t=T, dist_id=fam, extra=ex)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    a = fg.frontier_grid_with_grads(W, mus, sgs, ex, num_t=T, dist_id=fam,
                                    param_grads=True)
    b = ref.frontier_grid_with_grads_ref(W, mus, sgs, num_t=T, dist_id=fam,
                                         extra=ex, param_grads=True)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert fg.LAUNCHES == {"fwd": 0, "grad": 0, "pgrad": 0}


def test_wrappers_reject_bad_launches():
    W, mus, sgs, ex = _t(*_case("normal", False))
    with pytest.raises(ValueError):
        fg.frontier_grid(W, mus[:-1], sgs, ex, num_t=T)
    with pytest.raises(ValueError):
        fg.frontier_grid(W, mus, sgs, ex[:, :-1], num_t=T)
    with pytest.raises(TypeError):
        fg.frontier_grid(W.double(), mus, sgs, ex, num_t=T)
    with pytest.raises(ValueError):
        fg.frontier_grid(W, mus, sgs, ex, num_t=autotune.MAX_NUM_T + 1)
    with pytest.raises(ValueError):
        fg.frontier_grid_with_grads(W, mus, sgs, ex, num_t=T,
                                    dist_id="weibull")


@pytest.mark.parametrize("per_row", [False, True], ids=["shared", "per_row"])
@pytest.mark.parametrize("fam", ["normal", "lognormal", "drift",
                                 "defective", "empirical"])
def test_autograd_function_matches_jax_grad(fam, per_row, shared_erf):
    W, mus, sgs, ex = _case(fam, per_row, seed=3, F=6)
    rng = np.random.default_rng(4)
    g_mu = rng.normal(size=6).astype(np.float32)
    g_var = rng.normal(size=6).astype(np.float32)

    def jloss(W, mus, sgs, ex):
        mu, var = jops.frontier_moments(W, mus, sgs, num_t=T, impl="xla",
                                        family=(fam, ex))
        return jnp.sum(g_mu * mu + g_var * var)

    want = jax.grad(jloss, argnums=(0, 1, 2, 3))(W, mus, sgs, ex)
    Wt, mt, st, et = (torch.tensor(a, requires_grad=True)
                      for a in (W, mus, sgs, ex))
    mu, var = ops.frontier_moments(Wt, mt, st, num_t=T, device="cpu",
                                   family=(fam, et))
    torch.sum(torch.tensor(g_mu) * mu + torch.tensor(g_var) * var).backward()
    for got, ref_grad in zip((Wt.grad, mt.grad, st.grad, et.grad), want):
        assert got.shape == tuple(ref_grad.shape)
        assert _rel_l2(got.numpy(), ref_grad) <= ADJ_TOL
    # only extra row 0 gets a cotangent
    assert torch.all(et.grad[1:] == 0.0)


def test_with_grads_chunking_and_shared_extra_broadcast():
    W, mus, sgs, ex = _case("drift", True, seed=5)
    full = ops.frontier_moments_with_grads(W, mus, sgs, num_t=T,
                                           device="cpu",
                                           family=("drift", ex),
                                           param_grads=True)
    chunked = ops.frontier_moments_with_grads(W, mus, sgs, num_t=T,
                                              device="cpu",
                                              family=("drift", ex),
                                              block_rows=5, param_grads=True)
    for a, b in zip(full, chunked):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)
    want = jops.frontier_moments_with_grads(W, mus, sgs, num_t=T,
                                            family=("drift", ex[:, 0]))
    got = ops.frontier_moments_with_grads(W, mus, sgs, num_t=T, device="cpu",
                                          family=("drift", ex[:, 0]))
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-2,
                                   atol=1e-3)


def test_device_rule_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CUDA path is exercised by "
                    "test_kernels_match_plain_on_the_card")
    W, mus, sgs, _ = _case("normal", False)
    with pytest.raises(RuntimeError):
        ops.frontier_moments(W, mus, sgs, num_t=T)      # device="cuda"


def _saved_balancer():
    return UncertaintyAwareBalancer(4, device="cpu").state_dict()


_MUS4 = np.array([10.0, 12.0, 15.0, 20.0], np.float32)
_W4 = np.full(4, 0.25, np.float32)

# every public entry point defaults to the card, however small its work
_ENTRY_POINTS = {
    "equal_split": lambda: equal_split(4),
    "inverse_mu_split": lambda: inverse_mu_split(_MUS4),
    "predict_moments_clark": lambda: predict_moments(
        _W4, _MUS4, 0.1 * _MUS4, exact=False),
    "clark_max_moments_2": lambda: clark_max_moments_2(3.0, 1.0, 2.0, 1.0),
    "clark_max_moments_seq": lambda: clark_max_moments_seq(_MUS4,
                                                           0.1 * _MUS4),
    "joint_cdf": lambda: joint_cdf(np.float32(12.0), _MUS4, 0.1 * _MUS4),
    "balancer": lambda: UncertaintyAwareBalancer(4),
    "balancer_from_state_dict": lambda: UncertaintyAwareBalancer
    .from_state_dict(_saved_balancer()),
    "balancer_from_reference": lambda: convert.balancer_from_reference(
        _saved_balancer()),
    "build_model": lambda: build_model(get_config("qwen3-8b").tiny()),
    "serve_engine": lambda: ServeEngine(
        build_model(get_config("qwen3-8b").tiny(), device="cpu"),
        get_config("qwen3-8b").tiny()),
    "partitioned_batcher": lambda: PartitionedBatcher(
        [ReplicaGroup("fast"), ReplicaGroup("slow")]),
    "serve_cli": lambda: serve_cli.main(["--arch", "qwen3-8b", "--tiny",
                                         "--batches", "1"]),
}


@pytest.mark.parametrize("name", sorted(_ENTRY_POINTS))
def test_device_rule_entry_points_raise_without_a_card(name):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the entry points run there")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        _ENTRY_POINTS[name]()


def test_autotune_buckets_modes_and_launch_model():
    assert autotune.bucket_rows(3) == 8 and autotune.bucket_rows(9) == 16
    assert autotune.bucket_rows(5000) == 5000
    assert autotune.accumulators("drift", False) == 4
    assert autotune.accumulators("defective", True) == 6
    assert autotune.accumulators("normal", False) == 2
    for mode in autotune.MODES:
        for fam in td.FAMILIES:
            th = autotune.pick_threads(2048, mode, fam)
            assert th % 32 == 0 and th * autotune.MAX_POINTS_PER_THREAD >= 2048
            assert autotune.smem_bytes(th, 2048, mode, fam) \
                <= autotune.SMEM_LIMIT_BYTES
    with pytest.raises(ValueError):
        autotune.check_launch(48, 256, "fwd", "normal")
    with pytest.raises(ValueError):
        autotune.lookup(8, 4, 256, mode="bwd")
    autotune.clear_cache()
    th = autotune.lookup(64, 128, 1024, mode="pgrad", dist_id="defective")
    state = autotune.cache_state()
    autotune.clear_cache()
    autotune.load_cache_state(state)
    assert autotune.cache_state() == state
    assert autotune.lookup(64, 128, 1024, mode="pgrad",
                           dist_id="defective") == th
    rows = autotune.lookup(4096, 1024, 256, backend="plain", mode="grad")
    assert 1 <= rows < 4096


@pytest.mark.cuda
@pytest.mark.parametrize("fam", td.FAMILIES)
def test_kernels_match_plain_on_the_card(fam):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; chip_smoke.py runs this check on "
                    "the card")
    for per_row in (False, True):
        W, mus, sgs, ex = (t.cuda() for t in _t(*_case(fam, per_row)))
        for pg in (False, True):
            got = fg.frontier_grid_with_grads(W, mus, sgs, ex, num_t=T,
                                              dist_id=fam, param_grads=pg)
            want = ref.frontier_grid_with_grads_ref(
                W, mus, sgs, num_t=T, dist_id=fam, extra=ex, param_grads=pg)
            _check([g.cpu() for g in got], [w.cpu().numpy() for w in want],
                   ADJ_TOL)
        got = fg.frontier_grid(W, mus, sgs, ex, num_t=T, dist_id=fam)
        want = ref.frontier_grid_ref(W, mus, sgs, num_t=T, dist_id=fam,
                                     extra=ex)
        _check([g.cpu() for g in got], [w.cpu().numpy() for w in want],
               ADJ_TOL)
