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
    with pytest.raises(ValueError, match="num_t"):
        fg.frontier_grid(W, mus, sgs, ex, num_t=1)
    # the card's grid limit names itself (the plain path has none)
    with pytest.raises(ValueError, match=str(autotune.MAX_NUM_T)):
        autotune.pick_split(3, 1024, autotune.MAX_NUM_T + 1, "fwd", "normal")
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
            # the split's tiles cover the grid: T sets no thread count
            th = autotune.pick_threads(2048, mode, fam)
            assert th == autotune.pick_threads(16384, mode, fam) == 256
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
    for mode in ("grad", "pgrad"):
        for fam in td.FAMILIES:
            split = autotune.pick_split(24, 8, 2048, mode, fam)
            th = autotune.pick_threads(2048, mode, fam)
            autotune.check_launch(th, 2048, mode, fam, split)
            assert autotune.smem_bytes(th, 2048, mode, fam, split) \
                <= autotune.smem_bytes(th, 2048, mode, fam)
    with pytest.raises(ValueError):
        autotune.pick_split(8, 4, 256, "bwd", "normal")


# the launch shapes of one balancer refresh at K=1024 (PGD steps, and
# sensitivity at F=3 and F=1) and of the fleet tick
REFRESH_SHAPES = ((3, 1024, 1024), (1, 1024, 1024))
FLEET_TICK = (4096, 1024, 256)


@pytest.mark.parametrize("mode", ["grad", "pgrad"])
@pytest.mark.parametrize("fam", td.FAMILIES)
def test_split_spreads_a_refresh_over_the_card(fam, mode):
    for F, K, T in REFRESH_SHAPES:
        split = autotune.pick_split(F, K, T, mode, fam)
        blocks = autotune.split_blocks(F, K, T, split)
        assert min(blocks) >= autotune.TARGET_BLOCKS == 132, (F, blocks)
        autotune.check_launch(autotune.pick_threads(T, mode, fam), T, mode,
                              fam, split)
    # where F alone fills the card, one block per row in every launch
    F, K, T = FLEET_TICK
    split = autotune.pick_split(F, K, T, mode, fam)
    assert autotune.split_blocks(F, K, T, split) == (F, F, F)
    assert split == (T, T, K, K)


def test_split_depends_on_the_shape_alone():
    # a pure function of (F, K, T, mode, family): every row count from 1 to
    # 300 gives the same split twice, and more rows never a narrower one
    last = None
    for F in range(1, 301):
        a = autotune.pick_split(F, 1024, 1024, "grad", "normal")
        assert a == autotune.pick_split(F, 1024, 1024, "grad", "normal")
        if last is not None:
            assert all(x >= y for x, y in zip(a, last))
        last = a
    n = autotune.grad_scratch_elems(3, 1024, 1024, "defective", True,
                                    autotune.pick_split(3, 1024, 1024,
                                                        "pgrad", "defective"))
    # rows (4), tiles (2 x 64), w F (1024), parts (2 x 16 x 4), accumulators
    # (16 chunks x 6 x 1024) per row
    assert n == 3 * (4 + 128 + 1024 + 128 + 16 * 6 * 1024)


def test_autotune_key_version_is_v3():
    # the version went from v3 to v4 when forward keys gained a split; the
    # test keeps its name and checks the current keys
    autotune.clear_cache()
    autotune.lookup(3, 1024, 1024, mode="grad")
    autotune.lookup_split(3, 1024, 1024, mode="grad")
    autotune.lookup_split(3, 1024, 2048, mode="fwd")
    keys = sorted(autotune.cache_state())
    assert autotune._KEY_VERSION == "v4"
    assert keys == ["v4:cuda:T1024:modegrad:famnormal",
                    "v4:split:F3:K1024:T1024:modegrad:famnormal",
                    "v4:split:F3:K1024:T2048:modefwd:famnormal"]
    autotune.clear_cache()


def test_cache_state_round_trip_restores_the_split():
    autotune.clear_cache()
    split = autotune.lookup_split(3, 1024, 1024, mode="pgrad",
                                  dist_id="lognormal")
    state = autotune.cache_state()
    (key,) = [k for k in state if ":split:" in k]
    assert state[key]["value"] == list(split)
    # a checkpoint written with another split restores that split, so the
    # restored process sums in the checkpointed order
    state[key]["value"] = [8, 32, 512, 64]
    autotune.clear_cache()
    autotune.load_cache_state(state)
    assert autotune.lookup_split(3, 1024, 1024, mode="pgrad",
                                 dist_id="lognormal") == (8, 32, 512, 64)
    assert autotune.cache_state() == state
    autotune.clear_cache()
    assert autotune.lookup_split(3, 1024, 1024, mode="pgrad",
                                 dist_id="lognormal") == split
    autotune.clear_cache()


@pytest.mark.parametrize("fam", td.FAMILIES)
def test_forward_split_spreads_the_finalists_over_the_card(fam):
    # a refresh's finalists (F=3, K=1024, T=2048): pass 1 in 192-256 blocks,
    # then one epilogue block per row; the fleet tick degenerates to one
    # tile per row; T = 8192 and 16384 tile the grid with the same threads
    F, K, T = 3, 1024, 2048
    split = autotune.pick_split(F, K, T, "fwd", fam)
    blocks = autotune.split_blocks(F, K, T, split)
    assert 192 <= blocks[0] <= 256 and blocks[1] == F, blocks
    assert split == (32, 0, 0, 0)
    F, K, T = FLEET_TICK
    split = autotune.pick_split(F, K, T, "fwd", fam)
    assert autotune.split_blocks(F, K, T, split) == (F, F)
    for T in (8192, 16384):
        split = autotune.pick_split(3, 1024, T, "fwd", fam)
        th, plan_split, n = autotune.launch_plan(3, 1024, T, "fwd", fam)
        assert plan_split == split and th == 256
        assert autotune.split_blocks(3, 1024, T, split)[0] >= 132
        assert n == autotune.fwd_scratch_elems(3, T, split) \
            == 3 * (1 + 2 * (T // split.points))


def test_forward_split_depends_on_the_shape_alone():
    last = None
    for F in range(1, 301):
        a = autotune.pick_split(F, 1024, 2048, "fwd", "lognormal")
        assert a == autotune.pick_split(F, 1024, 2048, "fwd", "lognormal")
        assert a.points >= autotune.MIN_POINTS
        if last is not None:
            assert a.points >= last.points
        last = a
    assert last.points == 256


def test_split_caps_pass_two_chunk_at_long_grids():
    # one chunk per row at the fleet tick's F would stage 20 bytes a grid
    # point: at T = 16384 that is 327680 bytes, so the chunk is capped at
    # the widest power of two that fits (8192) instead of raising
    for mode in ("grad", "pgrad"):
        split = autotune.pick_split(4096, 1024, 16384, mode, "empirical")
        assert split.t_chunk == 8192
        th, _, _ = autotune.launch_plan(4096, 1024, 16384, mode,
                                        "empirical")
        autotune.check_launch(th, 16384, mode, "empirical", split)
        assert autotune.smem_bytes(th, 16384, mode, "empirical", split) \
            <= autotune.SMEM_LIMIT_BYTES
        # a refresh's row count still gets 132 blocks a launch at long T
        split = autotune.pick_split(3, 1024, 16384, mode, "normal")
        assert min(autotune.split_blocks(3, 1024, 16384, split)) >= 132
    autotune.clear_cache()


@pytest.mark.parametrize("T", [8192, 16384])
def test_long_grids_match_the_reference(T):
    # num_t above 4096: the reference computes at any T; at T = 8192 it
    # gives mu 15.0768, var 1.06548 for W = (0.5, 0.5), mus (30, 20),
    # sigmas (2, 6)
    W = np.array([[0.5, 0.5], [0.3, 0.7]], np.float32)
    mus = np.array([30.0, 20.0], np.float32)
    sgs = np.array([2.0, 6.0], np.float32)
    jmu, jvar = jops.frontier_moments(jnp.asarray(W), jnp.asarray(mus),
                                      jnp.asarray(sgs), num_t=T, impl="xla")
    if T == 8192:
        np.testing.assert_allclose(float(jmu[0]), 15.0768, rtol=1e-5)
        np.testing.assert_allclose(float(jvar[0]), 1.06548, rtol=1e-4)
    tW, tm, ts = (torch.from_numpy(a) for a in (W, mus, sgs))
    ex = torch.zeros((1, 2))
    mu, var = fg.frontier_grid(tW, tm, ts, ex, num_t=T)
    np.testing.assert_allclose(mu.numpy(), np.asarray(jmu), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(var.numpy(), np.asarray(jvar), rtol=1e-2,
                               atol=1e-3)
    out = fg.frontier_grid_with_grads(tW, tm, ts, ex, num_t=T,
                                      param_grads=True)
    assert torch.equal(out[0], mu) and torch.equal(out[1], var)
    assert all(bool(torch.isfinite(o).all()) for o in out)


def test_check_launch_refuses_a_split_over_the_smem_limit():
    split = autotune.pick_split(3, 1024, 4096, "grad", "empirical")
    th = autotune.pick_threads(4096, "grad", "empirical")
    autotune.check_launch(th, 4096, "grad", "empirical", split)
    # pass 2 stages 20 bytes per grid point of its chunk: 16384 points are
    # 327680 bytes, over the 232448 a block may use
    wide = split._replace(t_chunk=16384)
    with pytest.raises(ValueError, match="shared memory"):
        autotune.check_launch(512, 16384, "grad", "empirical", wide)
    with pytest.raises(ValueError, match="power of two"):
        autotune.check_launch(th, 4096, "grad", "empirical",
                              split._replace(points=24))
    with pytest.raises(ValueError, match="chunks"):
        autotune.check_launch(th, 4096, "grad", "empirical",
                              split._replace(k_chunk=0))


def _split_adjoint_f64(W, mus, sgs, ex, T, fam, params, split):
    """A float64 model in plain torch of the split adjoint's summation
    order (``csrc/frontier_grid.cu``): per-channel terms as
    ``ref.frontier_grid_with_grads_ref`` forms them, every sum cut into the
    pieces the split cuts it into and the pieces added in index order (log
    F by channel slice, the trapezoid sums by pass-1 tile, the accumulators
    by pass-2 grid chunk, S_mu and S_var by (grid chunk, channel chunk)).
    Returns mu, m2 - mu^2 and the adjoints of the ref's order, all float64
    and unrounded."""
    points, t_chunk, k_chunk, _ = split
    mode = "pgrad" if params else "grad"
    slices = autotune.pick_threads(T, mode, fam) // points
    K = W.shape[1]
    means, stds = td.family_effective_moments(fam, W, mus, sgs, ex)
    reach = means + 10.0 * stds
    amax = torch.amax(reach, -1)
    tmax = torch.clamp_min(amax, 1e-12)
    ts = tmax[:, None] * ref.time_fractions(T, W.device)[None, :]
    mus_b, sgs_b, ex_b = ref._stat_bcast(mus, sgs, ex)
    cdf_raw, D, ok, zsc = td.family_adjoint_parts(
        fam, ts[:, :, None], W[:, None, :], mus_b, sgs_b, ex_b)
    cdf = torch.where(ok, cdf_raw,
                      td.point_mass_cdf(ts[:, :, None], means[:, None, :]))
    Cc = torch.clamp(cdf, ref.CDF_FLOOR, 1.0)
    logc = torch.log(Cc).double()
    logF = sum(logc[..., q::slices].sum(-1) for q in range(slices))
    wq = ref._trapezoid_weights(T, W.device)
    Fj = torch.exp(logF)
    t64 = ts.double()
    tiles = range(0, T, points)
    s1 = sum((wq * (1.0 - Fj))[:, j:j + points].sum(-1) for j in tiles)
    s2 = sum((wq * t64 * (1.0 - Fj))[:, j:j + points].sum(-1) for j in tiles)
    dt = tmax.double() / (T - 1)
    mu = s1 * dt
    var_raw = 2.0 * s2 * dt - mu * mu
    gate = (torch.where(cdf_raw >= 1.0, 0.5, 1.0)
            * (cdf_raw > ref.CDF_FLOOR) * ok)
    a = ((wq * Fj).float()[:, :, None] * (gate * D / Cc)).double()
    tmu = (t64 - mu[:, None])[:, :, None]
    use_1, use_t, use_z = td.family_features(fam, params=params)
    zero = torch.zeros_like(a)
    basis = (a if use_1 else zero, a * t64[:, :, None] if use_t else zero,
             a * zsc.double() if use_z else zero)
    chunks = [slice(j, j + t_chunk) for j in range(0, T, t_chunk)]
    P_c = [[x[:, c].sum(1) for x in basis] for c in chunks]
    Pv_c = [[(x[:, c] * tmu[:, c]).sum(1) for x in basis] for c in chunks]
    _, _, g0, g1 = (c.double() for c in td.family_coeffs(fam, W, mus, sgs,
                                                         ex))
    kcs = [slice(k, k + k_chunk) for k in range(0, K, k_chunk)]
    S_mu = sum((g0 * P[0] + g1 * P[1])[:, kc].sum(-1)
               for P in P_c for kc in kcs)
    S_var = sum((g0 * Pv[0] + g1 * Pv[1])[:, kc].sum(-1)
                for Pv in Pv_c for kc in kcs)
    P = [sum(Pc[i] for Pc in P_c) for i in range(3)]
    Pv = [sum(Pc[i] for Pc in Pv_c) for i in range(3)]
    tmx = tmax.double()
    b_mu = (mu - dt * S_mu) / tmx
    b_var = 2.0 * (var_raw - dt * S_var) / tmx
    ind = (reach == amax[:, None]).double()
    tie = ind / ind.sum(-1, keepdim=True) * (amax > 1e-12)[:, None]

    def contract(coeffs, dreach):
        c = [torch.as_tensor(x).double() for x in coeffs]
        gvec = dreach.double() * tie
        dmu = (-dt[:, None] * sum(ci * Pi for ci, Pi in zip(c, P))
               + b_mu[:, None] * gvec)
        dvar = torch.where(
            (var_raw > 0.0)[:, None],
            -2.0 * dt[:, None] * sum(ci * Pi for ci, Pi in zip(c, Pv))
            + b_var[:, None] * gvec, 0.0)
        return dmu, dvar

    al, be, _, _ = td.family_coeffs(fam, W, mus, sgs, ex)
    out = [mu, var_raw,
           *contract((al, be, 0.0), td.family_dreach(fam, W, mus, sgs, ex,
                                                     10.0))]
    if params:
        cm, cs, ce = td.family_param_coeffs(fam, W, mus, sgs, ex)
        dm, ds, de = td.family_dreach_params(fam, W, mus, sgs, ex, 10.0)
        out += [*contract(cm, dm), *contract(cs, ds)]
        out += (contract(ce, de) if td.family_has_extra_grads(fam)
                else [torch.zeros_like(mu[:, None] * W)] * 2)
    return out


@pytest.mark.parametrize("params", [False, True], ids=["grad", "pgrad"])
@pytest.mark.parametrize("fam", ["normal", "defective"])
def test_split_summation_order_matches_the_unsplit_sums(fam, params):
    # at a refresh's shape (F=3, K=1024, T=1024) the split's order of every
    # float64 sum agrees with one tile, one chunk and one slice to 1e-12
    # relative (L2 per output), and that unsplit model, rounded to float32,
    # is the plain version
    W, mus, sgs, ex = _t(*_case(fam, False, seed=5, F=3, K=1024))
    T = 1024
    mode = "pgrad" if params else "grad"
    split = autotune.pick_split(3, 1024, T, mode, fam)
    assert split.points < T and split.t_chunk < T
    got = _split_adjoint_f64(W, mus, sgs, ex, T, fam, params, split)
    threads = autotune.pick_threads(T, mode, fam)
    whole = autotune.GradSplit(threads, T, 1024, 1024)
    want = _split_adjoint_f64(W, mus, sgs, ex, T, fam, params, whole)
    for i, (g, w) in enumerate(zip(got, want)):
        assert _rel_l2(g.numpy(), w.numpy()) <= 1e-12, (i, _rel_l2(g, w))
    plain = ref.frontier_grid_with_grads_ref(W, mus, sgs, num_t=T,
                                             dist_id=fam, extra=ex,
                                             param_grads=params)
    want[1] = torch.clamp_min(want[1], 0.0)
    for i, (w, p) in enumerate(zip(want, plain)):
        assert _rel_l2(w.float().numpy(), p.numpy()) <= 1e-6, i


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
