"""The arithmetic of the redesigned CUDA attention kernels, on the CPU.

The CUDA kernels run only on the card; their arithmetic has test-only
plain models in ``repro_torch.kernels.ref``, held here against the JAX
package on the same numpy-seeded inputs:

* ``decode_attention_split_ref`` (the split flash decode: per-split float32
  partials (m, l, acc), merged in split order) against the Pallas
  ``flash_decode`` in interpret mode and ``repro.kernels.ref``'s
  ``decode_attention_ref``, float32, atol = rtol = 2e-4 (the float32
  kernel tolerance of ``tests/test_kernels.py``); splits of 1, 3 and 7,
  with a split that has no valid slot, and a call with no valid slot at
  all (0, as from the Pallas kernel).
* ``flash_attention_bf16p_ref`` (the bf16 tensor-core prefill: P rounded to
  bf16 before P . V, l summed from the rounded P) against the Pallas
  ``flash_attention`` in interpret mode on bf16 inputs, which keeps P in
  float32, at atol = rtol = 1e-2, the bf16 kernel tolerance: the rounding
  of P moves each weight by at most 2^-9 of itself.

* ``split_einsum`` in TF32 (the float32 kernels' products on the tensor
  cores: each operand split into hi = TF32(x) and lo = x - hi, read
  toward zero, the product lo.hi + hi.lo + hi.hi) through
  ``flash_attention_lse_ref``'s arithmetic and the backward formulas of
  ``flash_attention_bwd_ref``: within 2e-4 relative L2 of the same
  formulas in float64 (the float32 tolerance of ``chip_smoke.py``'s
  ``BWD_TOL`` and ``LM_TOL``) at head dims 16, 64, 80 and 192 with ragged
  S, for the output and dq, dk, dv, and against the JAX package's
  ``ref.flash_attention_ref`` on the same float32 inputs at atol = rtol =
  2e-4 (the Pallas kernel takes no ragged S). One TF32 product (hi.hi)
  misses the same shapes: that is why the kernels take three. Two bf16
  planes with three products hold them as well, which is why
  ``chip_smoke.py`` reckons the float32 attention bound at a third of the
  bf16 rate.

Head dims include 80 and 192 (h2o-danube, Nemotron-4). The wrapper's choice
of splits (``flash_decode.decode_splits``) is checked here too.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as jflash_attention
from repro.kernels.flash_decode import flash_decode as jflash_decode
from repro_torch.kernels import flash_decode as fd
from repro_torch.kernels import ref

F32_TOL = dict(atol=2e-4, rtol=2e-4)
BF16_TOL = dict(atol=1e-2, rtol=1e-2)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _normal(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _decode_inputs(seed, B, Hkv, G, S, D, invalid):
    """q, k, v and a valid mask with the slots in ``invalid`` cleared and
    a third of the rest cleared at random."""
    q, k, v = (_normal(seed + i, B, Hkv, n, D)
               for i, n in ((0, G), (1, S), (2, S)))
    valid = np.random.default_rng(seed + 3).random(S) < 0.67
    valid[invalid] = False
    return q, k, v, valid


# (B, Hkv, G, S, D, invalid slots): the first of three splits of 48 is
# invalid, the fourth of seven splits of 12 (slots 36..47), a ragged last
# split; D = 80 and 192
DECODE_CASES = {
    "g4-d64": (2, 2, 4, 144, 64, slice(0, 48)),
    "g1-d128": (1, 2, 1, 80, 128, slice(36, 48)),
    "g3-d80": (2, 1, 3, 96, 80, slice(0, 32)),
    "g12-d192": (1, 2, 12, 112, 192, slice(16, 48)),
}


@pytest.mark.parametrize("splits", [1, 3, 7])
@pytest.mark.parametrize("case", sorted(DECODE_CASES))
def test_split_decode_matches_pallas(case, splits):
    B, Hkv, G, S, D, invalid = DECODE_CASES[case]
    q, k, v, valid = _decode_inputs(7, B, Hkv, G, S, D, invalid)
    got = ref.decode_attention_split_ref(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(valid), splits)
    want_k = jflash_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           jnp.asarray(valid), block_s=16, interpret=True)
    want_r = jref.decode_attention_ref(jnp.asarray(q), jnp.asarray(k),
                                       jnp.asarray(v), jnp.asarray(valid))
    for want in (want_k, want_r):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)


@pytest.mark.parametrize("splits", [3, 7])
def test_split_without_valid_slot_weighs_nothing(splits):
    """A split with no valid slot carries m = -1e30, l = 0 and acc = 0; the
    others carry a finite max."""
    B, Hkv, G, S, D = 1, 2, 4, 70, 64
    q, k, v, valid = _decode_inputs(11, B, Hkv, G, S, D, slice(0, 24))
    valid[24:] = True
    _, (m, l, acc) = ref.decode_attention_split_ref(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(valid), splits, return_partials=True)
    assert m.shape == (splits, B, Hkv, G, 1)
    dead = (np.arange(1, splits + 1) * -(-S // splits)) <= 24
    assert dead[0] and not dead[-1]
    assert (m[dead] == ref.NEG_INF).all() and (l[dead] == 0).all()
    assert (acc[dead] == 0).all()
    assert (m[~dead] > ref.NEG_INF / 2).all() and (l[~dead] > 0).all()


@pytest.mark.parametrize("splits", [1, 3, 7])
def test_split_decode_no_valid_slot_gives_zero(splits):
    """A row with no valid slot anywhere gives 0, as from the Pallas
    kernel (the softmax reference gives NaN there)."""
    q, k, v, valid = _decode_inputs(13, 1, 2, 4, 64, 80, slice(0, 64))
    got = ref.decode_attention_split_ref(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(valid), splits)
    want = jflash_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         jnp.asarray(valid), block_s=16, interpret=True)
    assert (got == 0).all()
    np.testing.assert_array_equal(np.asarray(want), 0.0)


def _bf16(a):
    """A numpy array rounded to bf16, as a torch and a jax array."""
    t = torch.from_numpy(a).to(torch.bfloat16)
    return t, jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)


# (B, Hq, Hkv, S, D, causal, window): GQA 1, 2 and 12, D = 64, 80, 128
# and 192 (the kernel's tiles of 64 and 128 keys both cut S = 192)
ATTN_CASES = {
    "causal-d64": (1, 2, 1, 192, 64, True, None),
    "window48-d80": (1, 4, 2, 192, 80, True, 48),
    "noncausal-d80": (2, 2, 1, 128, 80, False, None),
    "gqa2-d128": (1, 4, 2, 192, 128, True, None),
    "gqa12-d192": (1, 12, 1, 128, 192, True, None),
    "window40-d192": (1, 2, 1, 192, 192, True, 40),
}


@pytest.mark.parametrize("case", sorted(ATTN_CASES))
def test_bf16p_attention_matches_pallas(case):
    B, Hq, Hkv, S, D, causal, window = ATTN_CASES[case]
    (tq, jq), (tk, jk), (tv, jv) = (_bf16(_normal(20 + i, B, h, S, D))
                                     for i, h in ((0, Hq), (1, Hkv),
                                                  (2, Hkv)))
    got = ref.flash_attention_bf16p_ref(tq, tk, tv, causal=causal,
                                        window=window)
    assert got.dtype == torch.bfloat16
    want = jflash_attention(jq, jk, jv, causal=causal, window=window,
                            block_q=64, block_k=64, interpret=True)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               **BF16_TOL)


def test_bf16p_attention_value_head_dim_of_its_own():
    """MLA's prefill tiles (q, k of 192, v of 128) against the reference's
    model path, ``ref.flash_attention_ref`` on the same bf16 inputs."""
    (tq, jq), (tk, jk) = (_bf16(_normal(40 + i, 1, 4, 130, 192))
                          for i in range(2))
    tv, jv = _bf16(_normal(42, 1, 4, 130, 128))
    got = ref.flash_attention_bf16p_ref(tq, tk, tv, causal=True,
                                        sm_scale=192 ** -0.5)
    assert got.shape == (1, 4, 130, 128) and got.dtype == torch.bfloat16
    want = jref.flash_attention_ref(jq, jk, jv, causal=True,
                                    sm_scale=192 ** -0.5)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               **BF16_TOL)


def test_bf16p_attention_dead_rows_give_zero():
    """window = 0 leaves no live key: every row gives 0, as from the
    Pallas kernel."""
    (tq, jq), (tk, jk), (tv, jv) = (_bf16(_normal(30 + i, 1, 2, 64, 80))
                                     for i in range(3))
    got = ref.flash_attention_bf16p_ref(tq, tk, tv, causal=True, window=0)
    want = jflash_attention(jq, jk, jv, causal=True, window=0, block_q=32,
                            block_k=32, interpret=True)
    assert (got == 0).all()
    np.testing.assert_array_equal(np.asarray(want.astype(jnp.float32)), 0.0)


@pytest.mark.parametrize("B,Hkv,S", [(32, 8, 32768), (32, 8, 24),
                                     (32, 8, 2048), (1, 2, 4096),
                                     (1, 8, 300), (4, 8, 100000)])
def test_decode_splits_cover_the_cache(B, Hkv, S):
    """Splits of at least MIN_SPLIT slots (or one), about four blocks per
    SM where S allows, every split non-empty and the cache covered."""
    sms = 132
    splits, split_len = fd.decode_splits(B, Hkv, S, sms)
    assert splits >= 1 and (splits - 1) * split_len < S <= splits * split_len
    assert splits == 1 or split_len >= fd.MIN_SPLIT
    if S >= fd.MIN_SPLIT * 4 * sms:
        assert B * Hkv * splits >= 4 * sms
    if S < 2 * fd.MIN_SPLIT:
        assert splits == 1


def test_tf32_round_is_round_to_nearest_ties_away():
    """``ref.tf32_round`` keeps 10 mantissa bits, rounds a half away from
    zero (cvt.rna) and keeps a NaN (the largest mantissa too) and an
    infinity; x - TF32(x) is exact and, read toward zero, the low part of
    the split, within 2^-21 of x."""
    half = 2.0 ** -11
    x = torch.tensor([1.0, 1.0 + half, 1.0 + half / 2, -(1.0 + half),
                      1.0 + 3 * half, 0.0, 1e-30], dtype=torch.float32)
    got = ref.tf32_round(x)
    want = torch.tensor([1.0, 1.0 + 2 * half, 1.0, -(1.0 + 2 * half),
                         1.0 + 4 * half, 0.0, float(ref.tf32_round(
                             torch.tensor([1e-30]))[0])])
    assert torch.equal(got, want)
    assert torch.equal(ref.tf32_round(got), got)
    bits = got.view(torch.int32) & 0x1FFF
    assert (bits == 0).all()
    special = torch.tensor([0x7FFFFFFF, -1, 0x7FC00000, 0x7F800000,
                            -0x800000], dtype=torch.int32).view(torch.float32)
    for f in (ref.tf32_round, ref.tf32_trunc):
        out = f(special)
        assert torch.isnan(out[:3]).all() and torch.equal(out[3:],
                                                          special[3:])
    r = torch.tensor(_normal(9, 1000))
    hi = ref.tf32_round(r)
    lo = ref.tf32_trunc(r - hi)
    assert ((r.double() - hi.double() - lo.double()).abs()
            <= 2.0 ** -21 * r.double().abs()).all()


# (B, Hq, Hkv, S, D, window): the tiny configs' head dim 16, SmolLM's 64,
# h2o-danube's 80 (not a multiple of the 64-column tile) and the 192 tile,
# each at a ragged S, causal, one with a window
SPLIT_CASES = {
    "d16": (2, 4, 2, 37, 16, None),
    "d64": (2, 4, 2, 77, 64, None),
    "d80": (2, 4, 1, 61, 80, None),
    "d192-window16": (2, 2, 2, 45, 192, 16),
}
SPLIT_REL = 2e-4


def _split_case(case, planes, terms):
    """rel L2 of (out, dq, dk, dv) in the split arithmetic from float64,
    and the split forward's output with the inputs."""
    B, Hq, Hkv, S, D, window = SPLIT_CASES[case]
    q, k, v, do = (torch.tensor(_normal(50 + i, B, h, S, D))
                   for i, h in enumerate((Hq, Hkv, Hkv, Hq)))
    ein = ref.split_einsum(planes, terms)
    out, lse = ref.flash_attention_lse_ref(q, k, v, causal=True,
                                           window=window, einsum=ein)
    grads = ref.flash_attention_bwd_ref(q, k, v, out, lse, do, causal=True,
                                        window=window, einsum=ein)
    d = [t.double() for t in (q, k, v, do)]
    o64, l64 = ref.flash_attention_lse_ref(*d[:3], causal=True,
                                           window=window)
    g64 = ref.flash_attention_bwd_ref(*d[:3], o64, l64, d[3], causal=True,
                                      window=window)
    rel = [float(torch.linalg.vector_norm(a.double() - b)
                 / torch.linalg.vector_norm(b))
           for a, b in zip((out, *grads), (o64, *g64))]
    return rel, out, (q, k, v, window)


@pytest.mark.parametrize("case", sorted(SPLIT_CASES))
def test_split_tf32_attention_holds_float32(case):
    rel, out, (q, k, v, window) = _split_case(case, "tf32", 3)
    assert max(rel) < SPLIT_REL, rel
    want = jref.flash_attention_ref(*(jnp.asarray(t.numpy())
                                      for t in (q, k, v)),
                                    causal=True, window=window)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), **F32_TOL)


@pytest.mark.parametrize("case", sorted(SPLIT_CASES))
def test_one_tf32_product_misses_float32(case):
    rel, _, _ = _split_case(case, "tf32", 1)
    assert max(rel) > SPLIT_REL, rel


@pytest.mark.parametrize("case", sorted(SPLIT_CASES))
def test_split_bf16_attention_holds_float32(case):
    """Two bf16 planes, three products: the route of chip_smoke.py's
    float32 attention bound (a third of the bf16 rate) meets the float32
    tolerance too."""
    rel, _, _ = _split_case(case, "bf16", 3)
    assert max(rel) < SPLIT_REL, rel
