"""The model kernels on the card against their plain versions.

Marked ``cuda``: each test skips without an NVIDIA GPU. This file imports
neither jax nor the JAX package, so it runs on a machine with only the
port's dependencies:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_kernels.py

Tolerances: atol = rtol = 2e-4 in float32, 1e-2 in bf16 (one bf16 ulp is
about 0.4% of the value); the SSD scan 5e-4 in float32 (y and the final
state) and 1e-2 for bf16 y. The bf16 attention kernel is also held against
``ref.flash_attention_bf16p_ref`` (its own arithmetic: P rounded to bf16)
and the split decode against ``ref.decode_attention_split_ref``.
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
