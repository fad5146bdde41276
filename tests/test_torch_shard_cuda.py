"""The sharded decode's kernel on the card: ``flash_decode_partial``
against its plain version, and the sequence-sharded decode (every rank's
partial on the kernel, combined in rank order) against one
``flash_decode`` over the whole cache.

Marked ``cuda``: each test skips without an NVIDIA GPU. This file imports
no JAX. On the card::

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_shard_cuda.py
"""
import pytest
import torch

from repro_torch.kernels import flash_decode as fd
from repro_torch.kernels import ref
from repro_torch.models import attention

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 2e-4, torch.bfloat16: 1e-2}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; chip_smoke.py's shard phase runs "
                    "these checks on the card")
    return torch.device("cuda")


def _inputs(B, Hkv, G, S, D, dtype, mode, dev, seed=0):
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    q = torch.randn((B, Hkv, G, D), generator=g, device=dev)
    k = torch.randn((B, Hkv, S, D), generator=g, device=dev)
    v = torch.randn((B, Hkv, S, D), generator=g, device=dev)
    valid = torch.rand(S, generator=g, device=dev) < 0.7
    if mode == "empty":
        valid[:] = False
    elif mode == "neg":
        # every valid logit near -119
        q = 1.0 + 0.1 * q
        k = -10.5 + 0.5 * k
        valid[0] = True
    return q.to(dtype), k.to(dtype), v.to(dtype), valid


def _assert_partial_close(got, want, tol=2e-4):
    """m absolutely, l relatively and acc relative to l (a float32 logit's
    rounding grows with its size, l and acc with the number of valid
    slots), and acc / l elementwise."""
    (m, l, acc), (wm, wl, wacc) = got, want
    assert bool(((m - wm).abs() <= tol).all())
    assert bool(((l - wl).abs() <= tol * wl).all())
    assert bool(((acc - wacc).abs() <= tol * wl).all())
    torch.testing.assert_close(acc / l.clamp(min=1e-30),
                               wacc / wl.clamp(min=1e-30), atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("B,Hkv,G,S,D,mode", [
    (2, 8, 4, 200, 128, "mask"),        # one split
    (4, 2, 4, 2048, 128, "mask"),       # several
    (2, 4, 16, 1024, 64, "mask"),
    (4, 8, 4, 2048, 128, "empty"),
    (4, 8, 4, 2048, 128, "neg"),
])
def test_partial_matches_plain(card, dtype, B, Hkv, G, S, D, mode):
    q, k, v, valid = _inputs(B, Hkv, G, S, D, dtype, mode, card)
    sm = torch.cuda.get_device_properties(card).multi_processor_count
    splits = fd.decode_splits(B, Hkv, S, sm)[0]
    fd.reset_launches()
    got = fd.flash_decode_partial(q, k, v, valid)
    again = fd.flash_decode_partial(q, k, v, valid)
    assert fd.LAUNCHES["flash_decode_partial"] == 2
    assert fd.LAUNCHES["flash_decode"] == 0
    want = ref.decode_attention_partial_ref(q, k, v, valid, splits=splits)
    for a, b, w in zip(got, again, want):
        assert a.dtype == torch.float32 and a.shape == w.shape
        assert torch.equal(a, b)
    _assert_partial_close(got, want)
    if mode == "empty":
        assert bool((got[0] == ref.NEG_INF).all())
        assert not got[1].any() and not got[2].any()
    if mode == "neg":
        assert float(got[0].max()) < -100


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("shards", [2, 4])
def test_sharded_decode_matches_whole(card, dtype, shards):
    q, k, v, valid = _inputs(4, 8, 4, 4096, 128, dtype, "mask", card, 1)
    parts = attention.seq_shards(k, v, valid, shards)
    got = attention.lse_ranks(q, parts)
    assert torch.equal(got, attention.lse_ranks(q, parts))
    whole = fd.flash_decode(q, k, v, valid)
    tol = TOL[dtype]
    torch.testing.assert_close(got.float(), whole.float(), atol=tol,
                               rtol=tol)


def test_partial_raises_under_grad(card):
    q, k, v, valid = _inputs(1, 2, 4, 64, 64, torch.float32, "mask", card)
    q.requires_grad_(True)
    with pytest.raises(RuntimeError):
        fd.flash_decode_partial(q, k, v, valid)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("D", [2560, 320, 40, 37], ids=lambda d: f"D{d}")
def test_split_row_norm_kernels(card, dtype, D):
    """The split-row RMSNorm's kernels (a rank's row sums, the norm given
    the all-reduced totals, its backward) on two ranks' shards against
    their plain versions, twice (the bits repeat): Mamba2-2.7B's shard at
    tp 2 and 16, a lane-group width and a ragged one (the scalar forms)."""
    from repro_torch.kernels import rmsnorm as rn
    g = torch.Generator(device=card)
    g.manual_seed(D)
    n = 2 * D
    x = torch.randn((300, n), generator=g, device=card).to(dtype)
    w = (1 + 0.1 * torch.randn(n, generator=g, device=card)).to(dtype)
    dy = torch.randn((300, n), generator=g, device=card).to(dtype)
    parts = [(x[:, r * D:(r + 1) * D].contiguous(), w[r * D:(r + 1) * D],
              dy[:, r * D:(r + 1) * D].contiguous()) for r in range(2)]
    tol = TOL[dtype]
    for rep in range(2):
        stats = [rn.row_stat(xr) for xr, _, _ in parts]
        dots = [rn.row_stat(xr, wr, gr) for xr, wr, gr in parts]
        for (xr, wr, gr), st, dt in zip(parts, stats, dots):
            torch.testing.assert_close(st, ref.rmsnorm_stat_ref(xr),
                                       atol=tol * D, rtol=tol)
            torch.testing.assert_close(dt, ref.rmsnorm_stat_ref(xr, wr, gr),
                                       atol=tol * D, rtol=tol)
        ss, dot = stats[0] + stats[1], dots[0] + dots[1]
        y = torch.cat([rn.rmsnorm_rows(xr, wr, ss, n) for xr, wr, _ in
                       parts], -1)
        torch.testing.assert_close(y.float(), ref.rmsnorm_ref(x, w).float(),
                                   atol=tol, rtol=tol)
        grads = [rn.rmsnorm_rows_bwd(xr, wr, gr, ss, dot, n)
                 for xr, wr, gr in parts]
        dx_w, dw_w = ref.rmsnorm_bwd_ref(x, w, dy)
        torch.testing.assert_close(
            torch.cat([gr[0] for gr in grads], -1).float(), dx_w.float(),
            atol=tol, rtol=tol)
        torch.testing.assert_close(
            torch.cat([gr[1] for gr in grads], -1).float(), dw_w.float(),
            atol=tol * 300, rtol=tol)
        if rep == 0:
            first = (y, *[t for gr in grads for t in gr])
    again = (y, *[t for gr in grads for t in gr])
    assert all(torch.equal(a, b) for a, b in zip(first, again))
