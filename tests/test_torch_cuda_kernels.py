"""The model kernels and the split frontier adjoint on the card against
their plain versions.

Marked ``cuda``: each test skips without an NVIDIA GPU. This file imports
neither jax nor the JAX package, so it runs on a machine with only the
port's dependencies:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_kernels.py

Tolerances: atol = rtol = 2e-4 in float32, 1e-2 in bf16 (one bf16 ulp is
about 0.4% of the value); the SSD scan 5e-4 in float32 (y and the final
state) and 1e-2 for bf16 y. The bf16 attention kernel is also held against
``ref.flash_attention_bf16p_ref`` (its own arithmetic: P rounded to bf16)
and the split decode against ``ref.decode_attention_split_ref``. The split
frontier adjoint and the split forward moments are held at
``chip_smoke.py``'s tolerances: mu rtol = atol = 1e-4, var rtol 1e-2 / atol
1e-3, every adjoint relative L2 <= 1e-4; so are the workflow solver's
stacked per-row launches at the rung shapes of a joint solve (``-k dag``),
with a mixed-family DAG solved on the card against the plain path, and
the serving engine's stacked launches (K <= 6 zero-padded, row buckets of
8 to 512, T = 128 and 256, four families) with an engine run on the card
against the CPU (``-k engine``), and the channel-count selection's small
subsets (K = 1, 2, 3, all five families) with a ``select_channels`` on the
card against the CPU (``-k group``), and every candidate of the timed
autotune sweep at a small shape, all families and modes (``-k sweep``).
"""
import pytest
import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import flash_decode as fd
from repro_torch.kernels import ref
from repro_torch.kernels import rmsnorm as rn
from repro_torch.kernels import ssd_scan as ssd

TOL = {torch.float32: 2e-4, torch.bfloat16: 1e-2}
DTYPES = [torch.float32, torch.bfloat16]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; chip_smoke.py runs these checks "
                    "on the card")
    return torch.device("cuda")


def _randn(gen, shape, dtype, dev):
    return torch.randn(shape, generator=gen, device=dev).to(dtype)


def _close(got, want):
    tol = TOL[got.dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("causal,window,Sq,Sk", [
    (True, None, 200, 200), (True, 64, 300, 300), (False, None, 100, 260)])
def test_flash_attention_matches_plain(card, dtype, causal, window, Sq, Sk):
    g = torch.Generator(device=card).manual_seed(0)
    q = _randn(g, (2, 8, Sq, 128), dtype, card)
    k = _randn(g, (2, 2, Sk, 128), dtype, card)
    v = _randn(g, (2, 2, Sk, 128), dtype, card)
    n = fa.LAUNCHES["flash_attention"]
    got = fa.flash_attention(q, k, v, causal=causal, window=window)
    assert fa.LAUNCHES["flash_attention"] == n + 1
    _close(got, ref.flash_attention_ref(q, k, v, causal=causal,
                                        window=window))
    # strided (B, S, H, D) views, as the model passes them
    qs = q.transpose(1, 2).contiguous().transpose(1, 2)
    assert torch.equal(fa.flash_attention(qs, k, v, causal=causal,
                                          window=window), got)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("D", [64, 80, 128, 192])
@pytest.mark.parametrize("Hq,Hkv,Sq", [
    (8, 2, 333),    # ragged Sq against the 128-row query tile
    (32, 8, 16),    # a short prompt: the heads of a kv group packed
    (15, 5, 16),    # packed, a group of 3 (48 of 64 rows)
    (24, 2, 16)])   # packed, a group of 12 across two blocks
def test_flash_attention_head_dims(card, dtype, D, Hq, Hkv, Sq):
    g = torch.Generator(device=card).manual_seed(6)
    q = _randn(g, (2, Sq, Hq, D), dtype, card).transpose(1, 2)
    k = _randn(g, (2, Sq, Hkv, D), dtype, card).transpose(1, 2)
    v = _randn(g, (2, Sq, Hkv, D), dtype, card).transpose(1, 2)
    got = fa.flash_attention(q, k, v, causal=True)
    _close(got, ref.flash_attention_ref(q, k, v, causal=True))
    assert torch.equal(fa.flash_attention(q, k, v, causal=True), got)
    if dtype == torch.bfloat16:
        _close(got, ref.flash_attention_bf16p_ref(q, k, v, causal=True))


@pytest.mark.cuda
def test_flash_attention_refuses_what_it_cannot_read(card):
    q = torch.zeros((1, 2, 16, 72), dtype=torch.bfloat16, device=card)
    with pytest.raises(ValueError, match="multiples of 8"):
        fa.flash_attention(q[..., :68], q[..., :68], q[..., :68])
    with pytest.raises(ValueError, match="16 bytes"):
        w = q[..., 1:65]   # unit stride on D, base off by 2 bytes
        fa.flash_attention(w, w, w)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("S", [16, 333])
def test_flash_attention_value_head_dim_of_its_own(card, dtype, S):
    # MLA's prefill: q, k of head dim 192, v of 128 (the bf16 kernel's
    # (192, 128) instance), against the plain version; bf16 also against
    # its own arithmetic (P rounded to bf16)
    g = torch.Generator(device=card).manual_seed(12)
    q = _randn(g, (2, 8, S, 192), dtype, card)
    k = _randn(g, (2, 8, S, 192), dtype, card)
    v = _randn(g, (2, 8, S, 128), dtype, card)
    got = fa.flash_attention(q, k, v, causal=True, sm_scale=192 ** -0.5)
    assert got.shape == (2, 8, S, 128)
    _close(got, ref.flash_attention_ref(q, k, v, causal=True,
                                        sm_scale=192 ** -0.5))
    if dtype == torch.bfloat16:
        _close(got, ref.flash_attention_bf16p_ref(q, k, v, causal=True,
                                                  sm_scale=192 ** -0.5))
        with pytest.raises(ValueError, match="no instance"):
            fa.flash_attention(q, k, v[..., :64], causal=True)
    assert torch.equal(fa.flash_attention(q, k, v, causal=True,
                                          sm_scale=192 ** -0.5), got)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,Hkv,G,S,D,dead", [
    (1, 2, 4, 4096, 128, 600),    # 16 splits, the first two invalid
    (2, 8, 4, 777, 80, 259),      # 3 splits, the first invalid
    (2, 8, 12, 1000, 192, 0),     # Nemotron-4-340B's group of 12
    (1, 2, 16, 600, 256, 0)])     # G * D = 16 x 256
def test_flash_decode_splits(card, dtype, B, Hkv, G, S, D, dead):
    g = torch.Generator(device=card).manual_seed(7)
    q = _randn(g, (B, Hkv, G, D), dtype, card)
    k = _randn(g, (B, Hkv, S, D), dtype, card)
    v = _randn(g, (B, Hkv, S, D), dtype, card)
    valid = torch.rand(S, generator=g, device=card) < 0.7
    valid[:dead] = False
    splits, split_len = fd.decode_splits(
        B, Hkv, S, torch.cuda.get_device_properties(card).multi_processor_count)
    assert splits > 1 and (dead == 0 or dead >= split_len)
    n = fd.LAUNCHES["flash_decode"]
    got = fd.flash_decode(q, k, v, valid)
    assert fd.LAUNCHES["flash_decode"] == n + 1
    _close(got, ref.decode_attention_ref(q, k, v, valid))
    _close(got, ref.decode_attention_split_ref(q, k, v, valid, splits))
    assert torch.equal(fd.flash_decode(q, k, v, valid), got)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("G,S", [(1, 200), (4, 24)])
def test_flash_decode_matches_plain(card, dtype, G, S):
    g = torch.Generator(device=card).manual_seed(1)
    q = _randn(g, (3, 8, G, 128), dtype, card)
    k = _randn(g, (3, 8, S, 128), dtype, card)
    v = _randn(g, (3, 8, S, 128), dtype, card)
    valid = torch.rand(S, generator=g, device=card) < 0.7
    valid[0] = True
    got = fd.flash_decode(q, k, v, valid)
    _close(got, ref.decode_attention_ref(q, k, v, valid))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("rows,D", [(21, 4096), (300, 128)])
def test_rmsnorm_matches_plain(card, dtype, rows, D):
    g = torch.Generator(device=card).manual_seed(2)
    x = 3.0 * _randn(g, (rows, D), dtype, card)
    w = _randn(g, (D,), dtype, card)
    _close(rn.rmsnorm(x, w), ref.rmsnorm_ref(x, w))


@pytest.mark.cuda
def test_dead_rows_give_zero(card):
    g = torch.Generator(device=card).manual_seed(3)
    q, k, v = (_randn(g, (1, 2, 64, 32), torch.float32, card)
               for _ in range(3))
    assert (fa.flash_attention(q, k, v, window=0) == 0).all()
    none = torch.zeros(64, dtype=torch.bool, device=card)
    assert (fd.flash_decode(q[:, :, :4].contiguous(), k, v, none) == 0).all()


def _ssd_inputs(g, B, S, H, P, G, N, dtype, dev):
    x = _randn(g, (B, S, H, P), dtype, dev)
    dt = torch.nn.functional.softplus(_randn(g, (B, S, H), torch.float32,
                                             dev)) * 0.5
    A = -torch.exp(0.3 * _randn(g, (H,), torch.float32, dev))
    Bm = (0.3 * _randn(g, (B, S, G, N), torch.float32, dev)).to(dtype)
    Cm = (0.3 * _randn(g, (B, S, G, N), torch.float32, dev)).to(dtype)
    D = 0.5 + _randn(g, (H,), torch.float32, dev).abs()
    return x, dt, A, Bm, Cm, D


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,S,H,P,G,N,chunk", [
    (2, 200, 4, 32, 2, 64, 64), (1, 1100, 2, 16, 1, 32, 128),
    (2, 37, 4, 8, 4, 16, 16), (2, 300, 8, 64, 1, 128, 128),
    (3, 13, 2, 64, 1, 128, 128)])
def test_ssd_scan_matches_plain(card, dtype, B, S, H, P, G, N, chunk):
    g = torch.Generator(device=card).manual_seed(4)
    args = _ssd_inputs(g, B, S, H, P, G, N, dtype, card)
    n = ssd.LAUNCHES["ssd_scan"]
    y, state = ssd.ssd_scan(*args, chunk=chunk, return_final_state=True)
    assert ssd.LAUNCHES["ssd_scan"] == n + 1
    want_y, want_state = ref.ssd_chunked_ref(*args, chunk=chunk,
                                             return_final_state=True)
    tol = 5e-4 if dtype == torch.float32 else 1e-2
    torch.testing.assert_close(y.float(), want_y.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(state, want_state, atol=5e-4, rtol=5e-4)
    again = ssd.ssd_scan(*args, chunk=chunk, return_final_state=True)
    assert torch.equal(again[0], y) and torch.equal(again[1], state)
    assert torch.equal(ssd.ssd_scan(*args, chunk=chunk), y)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,S,H,chunk,groups", [
    (8, 300, 80, 128, 1),    # one group of three chunks, the last ragged
    (4, 300, 80, 128, 2),    # groups of two chunks and one
    (1, 1100, 4, 64, 18),    # a group per chunk, the last ragged
    (2, 1030, 8, 16, 33)])   # groups of two chunks at the tiny chunk
def test_ssd_scan_groups_match_plain(card, dtype, B, S, H, chunk, groups):
    # the group split (pass 1, pass 2, pass 3) against the plain version in
    # the same groups and in one sequential walk; y and the final state; a
    # second call repeats the bits
    from repro_torch.kernels import autotune
    assert autotune.ssd_groups(B, H, S, chunk).groups == groups
    g = torch.Generator(device=card).manual_seed(10)
    P, N = (64, 128) if chunk > 16 else (16, 32)
    args = _ssd_inputs(g, B, S, H, P, 1, N, dtype, card)
    y, state = ssd.ssd_scan(*args, chunk=chunk, return_final_state=True)
    tol = 5e-4 if dtype == torch.float32 else 1e-2
    for n_groups in (None, 1):
        want_y, want_state = ref.ssd_chunked_ref(
            *args, chunk=chunk, return_final_state=True, groups=n_groups)
        torch.testing.assert_close(y.float(), want_y.float(), atol=tol,
                                   rtol=tol)
        torch.testing.assert_close(state, want_state, atol=5e-4, rtol=5e-4)
    again = ssd.ssd_scan(*args, chunk=chunk, return_final_state=True)
    assert torch.equal(again[0], y) and torch.equal(again[1], state)


@pytest.mark.cuda
def test_ssd_scan_refuses_a_state_past_its_strips(card):
    g = torch.Generator(device=card).manual_seed(11)
    args = _ssd_inputs(g, 1, 32, 2, 128, 1, 128, torch.bfloat16, card)
    with pytest.raises(ValueError, match="strips"):
        ssd.ssd_scan(*args, chunk=16)


@pytest.mark.cuda
def test_ssd_scan_reads_strided_b_c(card):
    g = torch.Generator(device=card).manual_seed(5)
    x, dt, A, _, _, D = _ssd_inputs(g, 2, 40, 4, 16, 2, 32, torch.bfloat16,
                                    card)
    bc = _randn(g, (2, 40, 128), torch.bfloat16, card)
    Bm, Cm = bc[..., :64].reshape(2, 40, 2, 32), bc[..., 64:].reshape(
        2, 40, 2, 32)
    got = ssd.ssd_scan(x, dt, A, Bm, Cm, D, chunk=16)
    assert torch.equal(got, ssd.ssd_scan(x, dt, A, Bm.contiguous(),
                                         Cm.contiguous(), D, chunk=16))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("D", [16, 21, 128, 2560, 4096, 5120, 18432])
def test_rmsnorm_forms_match_plain(card, dtype, D):
    # 16-byte vectors in lane groups (D = 16, 128) or in a block fitted to D
    # (2560 ... 18432, Nemotron-4-340B's d_model), the scalar form for a
    # row that is no whole number of vectors (D = 21)
    g = torch.Generator(device=card).manual_seed(8)
    w = (1.0 + 0.1 * _randn(g, (D,), torch.float32, card)).to(dtype)
    for rows in (1, 21, 1024):
        x = 3.0 * _randn(g, (rows, D), dtype, card)
        n = rn.LAUNCHES["rmsnorm"]
        got = rn.rmsnorm(x, w)
        assert rn.LAUNCHES["rmsnorm"] == n + 1
        _close(got, ref.rmsnorm_ref(x, w))
        assert torch.equal(rn.rmsnorm(x, w), got)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_rmsnorm_reads_a_view_off_16_bytes(card, dtype):
    # contiguous views whose storage offset is not a multiple of 16 bytes
    # take the scalar form and agree with the aligned copy's vector form
    g = torch.Generator(device=card).manual_seed(9)
    rows, D = 33, 4096
    buf = 3.0 * _randn(g, (rows * D + 1,), dtype, card)
    x = buf[1:].view(rows, D)
    wbuf = (1.0 + 0.1 * _randn(g, (D + 1,), torch.float32, card)).to(dtype)
    w = wbuf[1:]
    assert x.is_contiguous() and x.data_ptr() % 16 != 0
    got = rn.rmsnorm(x, w)
    _close(got, ref.rmsnorm_ref(x, w))
    assert torch.equal(rn.rmsnorm(x, w), got)
    _close(got, rn.rmsnorm(x.clone(), w.clone()))


def _frontier_case(fam, F, K, per_row, seed, dev):
    """Seeded inputs with edge rows: a zero weight, a zero sigma (channel
    3), p = 0 (defective, channel 5), argmax ties between channels 0 and 1
    (rows 2 and 3 where F > 3, the last row where F is 2 or 3)."""
    import numpy as np
    from repro_torch.core.distributions import extra_rows
    rng = np.random.default_rng(seed)
    W = rng.dirichlet(np.ones(K), F)
    W[0, 7] = 0.0
    shape = (F, K) if per_row else (K,)
    mus = rng.uniform(10.0, 40.0, shape)
    sgs = mus * rng.uniform(0.02, 0.3, shape)
    sgs[..., 3] = 0.0
    mus[..., 1] = mus[..., 0]
    sgs[..., 1] = sgs[..., 0]
    if F > 1:
        tie = slice(2, 4) if F > 3 else slice(F - 1, F)
        W[tie, 0] = W[tie, 1] = 0.5
        W[tie, 2:] = 0.0
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
        ex = np.zeros((extra_rows(fam),) + shape)
    return tuple(torch.tensor(np.asarray(a, np.float32), device=dev)
                 for a in (W, mus, sgs, ex))


def _rel_l2(a, b):
    den = torch.linalg.norm(b.double())
    num = torch.linalg.norm((a - b).double())
    return float(num / den) if float(den) > 0 else float(num)


@pytest.mark.cuda
@pytest.mark.parametrize("F,K,T", [(1, 1024, 1024), (3, 1024, 1024),
                                   (256, 128, 256)])
@pytest.mark.parametrize("fam", ["normal", "lognormal", "drift", "empirical",
                                 "defective"])
def test_split_adjoint_matches_plain(card, fam, F, K, T):
    # the split fused adjoint (grad and pgrad, both statistics layouts)
    # against its plain version at chip_smoke.py's tolerances: mu rtol =
    # atol = 1e-4, var rtol 1e-2 / atol 1e-3, adjoints relative L2 1e-4;
    # a second call repeats the bits
    from repro_torch.kernels import autotune
    from repro_torch.kernels import frontier_grid as fg
    for per_row in (False, True):
        W, mus, sgs, ex = _frontier_case(fam, F, K, per_row, F + K, card)
        for pg in (False, True):
            mode = "pgrad" if pg else "grad"
            split = autotune.lookup_split(F, K, T, mode=mode, dist_id=fam)
            if F < 4:
                assert min(autotune.split_blocks(F, K, T, split)) >= 132
            n = fg.LAUNCHES[mode]
            got = fg.frontier_grid_with_grads(W, mus, sgs, ex, num_t=T,
                                              dist_id=fam, param_grads=pg)
            assert fg.LAUNCHES[mode] == n + 1
            want = ref.frontier_grid_with_grads_ref(
                W, mus, sgs, num_t=T, dist_id=fam, extra=ex, param_grads=pg)
            torch.testing.assert_close(got[0], want[0], rtol=1e-4, atol=1e-4)
            torch.testing.assert_close(got[1], want[1], rtol=1e-2, atol=1e-3)
            for i, (g, w) in enumerate(zip(got[2:], want[2:])):
                assert bool(torch.isfinite(g).all())
                assert _rel_l2(g, w) <= 1e-4, (per_row, mode, i,
                                               _rel_l2(g, w))
            again = fg.frontier_grid_with_grads(W, mus, sgs, ex, num_t=T,
                                                dist_id=fam, param_grads=pg)
            assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.cuda
@pytest.mark.parametrize("F,K,T", [(1, 1024, 2048), (3, 1024, 2048),
                                   (256, 128, 256), (3, 1024, 8192)])
@pytest.mark.parametrize("fam", ["normal", "lognormal", "drift", "empirical",
                                 "defective"])
def test_split_forward_matches_plain(card, fam, F, K, T):
    # the forward moments split across the card (pass 1 over tiles of grid
    # points, then one warp per row) against the plain version, both
    # statistics layouts; a second call repeats the bits
    from repro_torch.kernels import autotune
    from repro_torch.kernels import frontier_grid as fg
    for per_row in (False, True):
        W, mus, sgs, ex = _frontier_case(fam, F, K, per_row, F + K + 1, card)
        split = autotune.lookup_split(F, K, T, mode="fwd", dist_id=fam)
        blocks = autotune.split_blocks(F, K, T, split)
        assert len(blocks) == 2 and blocks[1] == F
        if F < 4:
            assert blocks[0] >= 132
        n = fg.LAUNCHES["fwd"]
        got = fg.frontier_grid(W, mus, sgs, ex, num_t=T, dist_id=fam)
        assert fg.LAUNCHES["fwd"] == n + 1
        want = ref.frontier_grid_ref(W, mus, sgs, num_t=T, dist_id=fam,
                                     extra=ex)
        torch.testing.assert_close(got[0], want[0], rtol=1e-4, atol=1e-4)
        torch.testing.assert_close(got[1], want[1], rtol=1e-2, atol=1e-3)
        again = fg.frontier_grid(W, mus, sgs, ex, num_t=T, dist_id=fam)
        assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.cuda
@pytest.mark.parametrize("T", [8192, 16384])
@pytest.mark.parametrize("fam", ["normal", "lognormal"])
def test_long_grids_match_plain(card, fam, T):
    # num_t above 4096: the split tiles the grid in every mode
    from repro_torch.kernels import frontier_grid as fg
    W, mus, sgs, ex = _frontier_case(fam, 3, 1024, False, T, card)
    for pg in (False, True):
        got = fg.frontier_grid_with_grads(W, mus, sgs, ex, num_t=T,
                                          dist_id=fam, param_grads=pg)
        want = ref.frontier_grid_with_grads_ref(
            W, mus, sgs, num_t=T, dist_id=fam, extra=ex, param_grads=pg)
        torch.testing.assert_close(got[0], want[0], rtol=1e-4, atol=1e-4)
        torch.testing.assert_close(got[1], want[1], rtol=1e-2, atol=1e-3)
        for g, w in zip(got[2:], want[2:]):
            assert _rel_l2(g, w) <= 1e-4
    mu, var = fg.frontier_grid(W, mus, sgs, ex, num_t=T, dist_id=fam)
    want = ref.frontier_grid_ref(W, mus, sgs, num_t=T, dist_id=fam, extra=ex)
    torch.testing.assert_close(mu, want[0], rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(var, want[1], rtol=1e-2, atol=1e-3)


def _dag_groups(R, dev, seed=0):
    """The stacked per-row launch inputs of ``workflow.solve`` for a
    mixed-family DAG: three stages each of normal, lognormal and drift
    with K of 256, 200 and 131 (zero-padded to 256), every group's
    statistics tiled over R starts and weights on the active channels."""
    import numpy as np
    from repro_torch.core.distributions import Drift
    from repro_torch.workflow import solve as wsolve
    rng = np.random.default_rng(seed)
    rows = []
    for fam in ("normal", "lognormal", "drift"):
        for k in (256, 200, 131):
            mus = rng.uniform(10.0, 40.0, k)
            sgs = mus * rng.uniform(0.05, 0.5, k)
            f = Drift(rng.uniform(0.1, 0.8, k).astype(np.float32)) \
                if fam == "drift" else fam
            rows.append((mus, sgs, f))
    groups, mask, kmax = wsolve.stack_rows(rows)
    stacks = wsolve._Stacks(groups, dev)
    e = rng.exponential(size=(R, len(rows), kmax)) * mask
    W = torch.tensor((e / e.sum(-1, keepdims=True)).astype(np.float32),
                     device=dev)
    for g, grp in enumerate(groups):
        yield (grp.dist_id, stacks.rows(W, g).contiguous(),
               *stacks.tiled(g, R))


# (mode, starts R, num_t): the rungs of one joint solve at the dag_scale
# configuration: presolve (grad, R starts, T = 128), triage (fwd, 2 R),
# refine (grad, survivors), final score (fwd, 3 survivors, T = 2048),
# fragility (pgrad)
DAG_RUNGS = [("grad", 3, 128), ("fwd", 6, 128), ("grad", 1, 256),
             ("grad", 3, 256), ("fwd", 9, 2048), ("pgrad", 3, 256),
             ("pgrad", 1, 256)]


@pytest.mark.cuda
@pytest.mark.parametrize("mode,R,T", DAG_RUNGS)
def test_dag_stacked_launches_match_plain(card, mode, R, T):
    # per-row statistics with zero-padded channels (w = mu = sigma = 0),
    # one family group a call, against the plain version; a second call
    # repeats the bits
    from repro_torch.kernels import frontier_grid as fg
    for fam, W, mus, sgs, ex in _dag_groups(R, card, seed=R * T):
        if mode == "fwd":
            def run():
                return fg.frontier_grid(W, mus, sgs, ex, num_t=T,
                                        dist_id=fam)
            want = ref.frontier_grid_ref(W, mus, sgs, num_t=T, dist_id=fam,
                                         extra=ex)
        else:
            def run(pg=(mode == "pgrad")):
                return fg.frontier_grid_with_grads(
                    W, mus, sgs, ex, num_t=T, dist_id=fam, param_grads=pg)
            want = ref.frontier_grid_with_grads_ref(
                W, mus, sgs, num_t=T, dist_id=fam, extra=ex,
                param_grads=(mode == "pgrad"))
        got = run()
        torch.testing.assert_close(got[0], want[0], rtol=1e-4, atol=1e-4)
        torch.testing.assert_close(got[1], want[1], rtol=1e-2, atol=1e-3)
        for g, w in zip(got[2:], want[2:]):
            assert bool(torch.isfinite(g).all())
            assert _rel_l2(g, w) <= 1e-4, (fam, mode, _rel_l2(g, w))
        again = run()
        assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.cuda
def test_dag_solve_on_the_card_matches_the_plain_path(card):
    # a mixed-family DAG: one call per family group per evaluation, the
    # same decision as on the CPU, and an empty dirty set launches no PGD
    import numpy as np
    from repro_torch.core.distributions import Drift
    from repro_torch.kernels import frontier_grid as fg
    from repro_torch.workflow import Stage, StageDAG, solve_dag
    rng = np.random.default_rng(3)
    fams = ("normal", "lognormal", Drift(np.full(20, 0.3, np.float32)))
    # stage i: family i % 3 with K = 24, 22, 20 (zero-padded to 24)
    stages = [Stage(f"s{i}", rng.uniform(10, 40, 24 - 2 * (i % 3)),
                    np.full(24 - 2 * (i % 3), 2.0), family=fams[i % 3])
              for i in range(6)]
    dag = StageDAG(stages, [("s0", "s1"), ("s0", "s2"), ("s1", "s3"),
                            ("s2", "s3"), ("s0", "s4"), ("s3", "s5"),
                            ("s4", "s5")])
    kw = dict(steps=12, restarts=1, num_t=128, plateau_patience=None)
    fg.reset_launches()
    got = solve_dag(dag, device=card, **kw)
    counts = dict(fg.LAUNCHES)
    want = solve_dag(dag, device="cpu", **kw)
    assert got.family_groups == want.family_groups == 3
    assert counts == {"fwd": 3 * 2, "grad": 3 * 24, "pgrad": 0}
    assert got.makespan_mu == pytest.approx(want.makespan_mu, rel=1e-4)
    for n, w in got.weights.items():
        np.testing.assert_allclose(w, want.weights[n], atol=1e-3)
    fg.reset_launches()
    noop = solve_dag(dag, device=card, warm_start=got.weights, dirty=(),
                     **kw)
    assert dict(fg.LAUNCHES) == {"fwd": 3, "grad": 0, "pgrad": 0}
    assert all(np.array_equal(noop.weights[n], w)
               for n, w in got.weights.items())


def _engine_rows(fam, F, dev, seed):
    """A serving engine's stacked launch (``serve.engine.launch_group``):
    3/4 of the F rows real, each with K in {2, 3, 4, 6} channels
    zero-padded to 6, per-row statistics and parameters; the pad rows
    repeat row 0."""
    import numpy as np
    from repro_torch.core.distributions import extra_rows
    rng = np.random.default_rng(seed)
    kmax, n = 6, max(1, 3 * F // 4)
    W, mus, sgs = (np.zeros((F, kmax), np.float32) for _ in range(3))
    ex = np.zeros((extra_rows(fam), F, kmax), np.float32)
    for j in range(n):
        k = int(rng.choice((2, 3, 4, 6)))
        W[j, :k] = rng.dirichlet(np.ones(k))
        mus[j, :k] = rng.uniform(1.0, 5.0, k)
        sgs[j, :k] = mus[j, :k] * rng.uniform(0.1, 0.3, k)
        if fam == "drift":
            ex[0, j, :k] = rng.uniform(0.1, 0.8, k)
        elif fam == "defective":
            ex[0, j, :k] = rng.uniform(0.02, 0.15, k)
            ex[1, j, :k] = 1.0
    W[n:], mus[n:], sgs[n:], ex[:, n:] = W[0], mus[0], sgs[0], ex[:, :1]
    return tuple(torch.tensor(a, device=dev) for a in (W, mus, sgs, ex))


@pytest.mark.cuda
@pytest.mark.parametrize("F,T", [(8, 128), (64, 128), (512, 128),
                                 (8, 256), (64, 256), (512, 256)])
@pytest.mark.parametrize("fam", ["normal", "lognormal", "drift",
                                 "defective"])
def test_engine_stacked_launches_match_plain(card, fam, F, T):
    # the serving engine's shapes: a tiny channel axis (K = 6, most rows
    # fewer), row buckets, per-row statistics; grad (every engine tick) and
    # fwd against the plain versions, and a second call repeats the bits
    from repro_torch.kernels import frontier_grid as fg
    W, mus, sgs, ex = _engine_rows(fam, F, card, seed=F + T)
    got = fg.frontier_grid_with_grads(W, mus, sgs, ex, num_t=T, dist_id=fam)
    want = ref.frontier_grid_with_grads_ref(W, mus, sgs, num_t=T,
                                            dist_id=fam, extra=ex)
    torch.testing.assert_close(got[0], want[0], rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(got[1], want[1], rtol=1e-2, atol=1e-3)
    for g, w in zip(got[2:], want[2:]):
        assert bool(torch.isfinite(g).all())
        assert _rel_l2(g, w) <= 1e-4, (fam, _rel_l2(g, w))
    again = fg.frontier_grid_with_grads(W, mus, sgs, ex, num_t=T,
                                        dist_id=fam)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    mu, var = fg.frontier_grid(W, mus, sgs, ex, num_t=T, dist_id=fam)
    want = ref.frontier_grid_ref(W, mus, sgs, num_t=T, dist_id=fam, extra=ex)
    torch.testing.assert_close(mu, want[0], rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(var, want[1], rtol=1e-2, atol=1e-3)
    again = fg.frontier_grid(W, mus, sgs, ex, num_t=T, dist_id=fam)
    assert torch.equal(mu, again[0]) and torch.equal(var, again[1])


@pytest.mark.cuda
def test_engine_tick_on_the_card_matches_the_cpu(card):
    # the serve_trace templates (three families) for 8 ticks on the card
    # and on the CPU: the same admissions, rows, launches and retirements,
    # join latencies to 1e-4 relative, splits to 1e-4; one grad call per
    # family group with rows
    import numpy as np
    from repro_torch.bench import serve_trace
    from repro_torch.kernels import frontier_grid as fg
    from repro_torch.serve import WorkflowEngine
    runs = {}
    for dev in (card, torch.device("cpu")):
        eng = WorkflowEngine(serve_trace.templates(), max_live=24,
                             lam_var=0.02, settle_steps=4, dirty_tol=0.08,
                             num_t=128, seed=0, prior_obs=4, device=dev)
        rng = np.random.default_rng(0)
        names = list(eng.templates)
        fg.reset_launches()
        ticks, groups = [], []
        for _ in range(8):
            arrivals = [(names[int(rng.integers(3))], 4.0)
                        for _ in range(int(rng.poisson(6)))]
            ticks.append(eng.tick(arrivals))
            groups.append(len({r.family.dist_id for r in eng.last_rows}))
        runs[dev.type] = (ticks, groups, eng, dict(fg.LAUNCHES))
    (tc, gc, ec, lc), (tp, gp, ep, _) = runs["cuda"], runs["cpu"]
    assert lc["grad"] == sum(t["launches"] for t in tc) == sum(gc)
    assert lc["fwd"] == lc["pgrad"] == 0
    for a, b in zip(tc, tp):
        for key in ("admitted", "live", "queue", "rows", "launches"):
            assert a[key] == b[key], (key, a, b)
        assert [r["iid"] for r in a["retired"]] == \
            [r["iid"] for r in b["retired"]]
        for x, y in zip(a["retired"], b["retired"]):
            assert x["join_latency_s"] == pytest.approx(y["join_latency_s"],
                                                        rel=1e-4)
    assert ec._live
    for iid, inst in ec._live.items():
        for name, w in inst.weights.items():
            np.testing.assert_allclose(w, ep._live[iid].weights[name],
                                       rtol=0, atol=1e-4)


def _small_k_case(fam, F, K, seed, dev):
    """F Dirichlet rows over K (1-3) channels with the family's extra, as
    float32 tensors on ``dev``: the shapes of select_channels' small
    subsets (K = 1 is a one-channel subset)."""
    import numpy as np
    from repro_torch.core.distributions import extra_rows
    rng = np.random.default_rng(seed)
    W = rng.dirichlet(np.ones(K), F) if K > 1 else \
        np.linspace(1.0 / F, 1.0, F)[:, None]
    mus = rng.uniform(10.0, 40.0, K)
    sgs = mus * rng.uniform(0.02, 0.3, K)
    if fam == "drift":
        ex = rng.uniform(0.1, 0.8, (1, K))
    elif fam == "defective":
        ex = np.stack([rng.uniform(0.02, 0.3, K), np.ones(K)])
    elif fam == "empirical":
        ex = np.concatenate([np.moveaxis(rng.dirichlet(np.ones(3), K), -1, 0),
                             mus[None] * rng.uniform(0.7, 1.3, (3, K)),
                             sgs[None] * rng.uniform(0.3, 1.0, (3, K))])
    else:
        ex = np.zeros((extra_rows(fam), K))
    return tuple(torch.tensor(np.asarray(a, np.float32), device=dev)
                 for a in (W, mus, sgs, ex))


@pytest.mark.cuda
@pytest.mark.parametrize("K", [1, 2, 3])
@pytest.mark.parametrize("fam", ["normal", "lognormal", "drift", "empirical",
                                 "defective"])
def test_group_small_k_kernels_match_plain(card, fam, K):
    # select_channels' subsets: the forward kernel at T=2048 (finalists and
    # one-channel subsets) and the adjoint at T=1024 (PGD steps), F = 1 and
    # 5, against the plain versions at chip_smoke.py's tolerances; a second
    # call repeats the bits
    from repro_torch.kernels import frontier_grid as fg
    for F in (1, 5):
        W, mus, sgs, ex = _small_k_case(fam, F, K, 10 * K + F, card)
        got = fg.frontier_grid(W, mus, sgs, ex, num_t=2048, dist_id=fam)
        want = ref.frontier_grid_ref(W, mus, sgs, num_t=2048, dist_id=fam,
                                     extra=ex)
        torch.testing.assert_close(got[0], want[0], rtol=1e-4, atol=1e-4)
        torch.testing.assert_close(got[1], want[1], rtol=1e-2, atol=1e-3)
        again = fg.frontier_grid(W, mus, sgs, ex, num_t=2048, dist_id=fam)
        assert all(torch.equal(a, b) for a, b in zip(got, again))
        got = fg.frontier_grid_with_grads(W, mus, sgs, ex, num_t=1024,
                                          dist_id=fam)
        want = ref.frontier_grid_with_grads_ref(W, mus, sgs, num_t=1024,
                                                dist_id=fam, extra=ex)
        torch.testing.assert_close(got[0], want[0], rtol=1e-4, atol=1e-4)
        torch.testing.assert_close(got[1], want[1], rtol=1e-2, atol=1e-3)
        for g, w in zip(got[2:], want[2:]):
            assert bool(torch.isfinite(g).all())
            assert _rel_l2(g, w) <= 1e-4, (fam, K, F, _rel_l2(g, w))
        again = fg.frontier_grid_with_grads(W, mus, sgs, ex, num_t=1024,
                                            dist_id=fam)
        assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.cuda
def test_group_select_channels_on_the_card_matches_the_cpu(card):
    # a 10-channel heterogeneous fleet, normal and defective: the same
    # indices, objective 1e-4 relative, the split to 1e-3
    import numpy as np
    from repro_torch.core import Defective, select_channels
    from repro_torch.kernels import frontier_grid as fg
    from repro_torch.sim import ClusterSim
    for dist in ("normal", "defective"):
        sim = ClusterSim.heterogeneous(10, seed=0, dist=dist)
        mus, sgs = sim.true_params
        fam = (Defective(p=[c.fail_p for c in sim.channels])
               if dist == "defective" else "normal")
        n = fg.LAUNCHES["grad"]
        a = select_channels(mus, sgs, lam=0.02, join_cost=0.5, pgd_steps=60,
                            family=fam, device=card)
        assert fg.LAUNCHES["grad"] > n
        b = select_channels(mus, sgs, lam=0.02, join_cost=0.5, pgd_steps=60,
                            family=fam, device="cpu")
        assert a.indices.tolist() == b.indices.tolist()
        assert a.objective == pytest.approx(b.objective, rel=1e-4)
        np.testing.assert_allclose(a.decision.weights, b.decision.weights,
                                   atol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["fwd", "grad", "pgrad"])
@pytest.mark.parametrize("fam", ["normal", "lognormal", "drift", "empirical",
                                 "defective"])
def test_sweep_candidates_match_plain_and_repeat(card, tmp_path, fam, mode):
    """``autotune.sweep`` on the card at a small shape: every candidate
    (the model's split and its neighbours) runs twice with its bits
    repeated and within the frontier tolerances of the plain version, or
    the sweep raises; the winner is filed under this card's name."""
    import json

    from repro_torch.kernels import autotune
    F, K, T = 64, 32, 256
    saved = autotune.cache_state()
    path = tmp_path / "autotune_cache.json"
    try:
        entry = autotune.sweep(F, K, T, mode=mode, dist_id=fam, repeats=1,
                               cache_path=str(path), device=card)
        cands = autotune.sweep_candidates(F, K, T, mode, fam)
        assert set(entry["timings"]) == {autotune._label(c) for c in cands}
        assert entry["model"] == autotune._label(cands[0])
        key = autotune._key(F, K, T, "split", mode, fam)
        disk = json.loads(path.read_text())
        assert disk[torch.cuda.get_device_name()][key] == entry
        assert autotune.plan_outcome(F, K, T, mode, fam)[2] == "sweep"
    finally:
        autotune.clear_cache()
        autotune.load_cache_state(saved)
