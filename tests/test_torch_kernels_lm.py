"""The port's model kernels against the JAX package's, on the CPU.

Each wrapper (``repro_torch.kernels.flash_attention``, ``flash_decode``,
``rmsnorm``) runs its plain version on CPU tensors; the same numpy inputs go
through the JAX Pallas kernel in interpret mode and through ``ref.*``.
float32 throughout, at atol = rtol = 2e-4 (``tests/test_kernels.py``).
The CUDA kernels themselves are held against the plain versions on the card
by ``tests/test_torch_cuda_kernels.py`` and ``chip_smoke.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as jflash_attention
from repro.kernels.flash_decode import flash_decode as jflash_decode
from repro.kernels.rmsnorm import rmsnorm as jrmsnorm
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_decode import flash_decode
from repro_torch.kernels.rmsnorm import rmsnorm

TOL = dict(atol=2e-4, rtol=2e-4)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _normal(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _close(got, *wants):
    for want in wants:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# (B, Hq, Hkv, S, D): GQA groups 1, 2 and 4, S of 128 and 256, D of 64 and 128
ATTN_SHAPES = [(1, 2, 2, 128, 64), (2, 4, 2, 256, 64), (1, 8, 2, 128, 128),
               (1, 4, 1, 256, 128)]
MASKS = {"causal": (True, None), "window64": (True, 64),
         "noncausal": (False, None)}


@pytest.mark.parametrize("mask", sorted(MASKS))
@pytest.mark.parametrize("shape", ATTN_SHAPES, ids=lambda s: "x".join(map(
    str, s)))
def test_flash_attention_matches_pallas_and_ref(shape, mask):
    B, Hq, Hkv, S, D = shape
    causal, window = MASKS[mask]
    q, k, v = (_normal(i, B, h, S, D) for i, h in ((0, Hq), (1, Hkv),
                                                   (2, Hkv)))
    got = flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v), causal=causal, window=window)
    want_k = jflash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              causal=causal, window=window, interpret=True)
    want_r = jref.flash_attention_ref(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(v), causal=causal,
                                      window=window)
    _close(got, want_k, want_r)


def test_flash_attention_rectangular_and_strided_views():
    """Non-causal cross-attention (Sq != Sk) with GQA group 2, fed as the
    model feeds it: (B, S, H, D) tensors viewed as (B, H, S, D)."""
    B, Hq, Hkv, Sq, Sk, D = 2, 4, 2, 128, 256, 64
    q = _normal(3, B, Sq, Hq, D)
    k = _normal(4, B, Sk, Hkv, D)
    v = _normal(5, B, Sk, Hkv, D)
    tq, tk, tv = (torch.from_numpy(a).transpose(1, 2) for a in (q, k, v))
    assert not tq.is_contiguous()
    got = ops.attention(tq, tk, tv, causal=False)
    jq, jk, jv = (jnp.asarray(a).swapaxes(1, 2) for a in (q, k, v))
    _close(got, jflash_attention(jq, jk, jv, causal=False, interpret=True),
           jref.flash_attention_ref(jq, jk, jv, causal=False))


@pytest.mark.parametrize("entry", ["ops.attention", "flash_attention"])
def test_flash_attention_value_head_dim_of_its_own(entry):
    """MLA's prefill (DeepSeek-V2-Lite): q, k of head dim 192, v of 128,
    against the reference's model path (``impl="xla"``)."""
    q, k = _normal(20, 1, 4, 16, 192), _normal(21, 1, 4, 16, 192)
    v = _normal(22, 1, 4, 16, 128)
    fn = ops.attention if entry == "ops.attention" else flash_attention
    got = fn(*(torch.from_numpy(a) for a in (q, k, v)), causal=True,
             sm_scale=192 ** -0.5)
    assert got.shape == (1, 4, 16, 128)
    _close(got, jref.flash_attention_ref(jnp.asarray(q), jnp.asarray(k),
                                         jnp.asarray(v), causal=True,
                                         sm_scale=192 ** -0.5))


def test_flash_attention_rules():
    q = torch.zeros(1, 2, 8, 16)
    k = torch.zeros(1, 2, 16, 16)
    with pytest.raises(ValueError, match="rectangular"):
        flash_attention(q, k, k, causal=True)
    with pytest.raises(ValueError, match="rectangular"):
        flash_attention(q, k, k, causal=False, window=4)
    with pytest.raises(ValueError, match="window"):
        flash_attention(k, k, k, window=-1)
    with pytest.raises(ValueError, match="Hkv"):
        flash_attention(torch.zeros(1, 3, 16, 16), k, k)
    with pytest.raises(TypeError):
        flash_attention(k.half(), k.half(), k.half())
    with pytest.raises(ValueError, match="Dv"):
        flash_attention(k, k, torch.zeros(1, 2, 15, 8))


def test_dead_rows_pallas_zero_plain_nan():
    """A row with no live key: the Pallas kernel gives 0 (its dead-row
    guard, which the CUDA kernel keeps), the plain versions NaN (-inf
    masking, as the JAX refs). The LM never makes such a row."""
    q, k, v = (_normal(i, 1, 2, 128, 32) for i in range(3))
    got = flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v), window=0)
    want_k = jflash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              window=0, interpret=True)
    assert np.all(np.asarray(want_k) == 0.0)
    assert torch.isnan(got).all()
    qd = _normal(6, 1, 2, 4, 32)
    none = np.zeros(24, bool)
    got = flash_decode(torch.from_numpy(qd), torch.from_numpy(k[:, :, :24]),
                       torch.from_numpy(v[:, :, :24]), torch.from_numpy(none))
    want_k = jflash_decode(jnp.asarray(qd), jnp.asarray(k[:, :, :24]),
                           jnp.asarray(v[:, :, :24]), jnp.asarray(none),
                           interpret=True)
    assert np.all(np.asarray(want_k) == 0.0)
    assert torch.isnan(got).all()


# (B, Hkv, G, S, valid slots): G of 1 and 4, caches of 200 and 24 slots
# (neither a multiple of 128), partly valid
DECODE_CASES = [(2, 2, 1, 200, 150), (2, 2, 4, 200, 150), (3, 8, 4, 24, 17),
                (1, 2, 4, 256, 256)]


@pytest.mark.parametrize("case", DECODE_CASES, ids=lambda c: "x".join(map(
    str, c)))
def test_flash_decode_matches_pallas_and_ref(case):
    B, Hkv, G, S, n_valid = case
    D = 64
    q = _normal(7, B, Hkv, G, D)
    k = _normal(8, B, Hkv, S, D)
    v = _normal(9, B, Hkv, S, D)
    valid = np.zeros(S, bool)
    valid[np.random.default_rng(10).permutation(S)[:n_valid]] = True
    got = ops.decode_attention(*(torch.from_numpy(a) for a in (q, k, v,
                                                               valid)))
    args = [jnp.asarray(a) for a in (q, k, v, valid)]
    _close(got, jflash_decode(*args, interpret=True),
           jref.decode_attention_ref(*args))


@pytest.mark.parametrize("D", [128, 4096])
@pytest.mark.parametrize("lead", [(3, 7), (300,)], ids=["21rows", "300rows"])
def test_rmsnorm_matches_pallas_and_ref(D, lead):
    x = _normal(11, *lead, D) * 3.0
    w = 1.0 + 0.1 * _normal(12, D)
    got = ops.rmsnorm(torch.from_numpy(x), torch.from_numpy(w), eps=1e-6)
    assert got.shape == x.shape
    _close(got, jrmsnorm(jnp.asarray(x), jnp.asarray(w), interpret=True),
           jref.rmsnorm_ref(jnp.asarray(x), jnp.asarray(w)))


def test_rmsnorm_rules():
    with pytest.raises(ValueError):
        rmsnorm(torch.zeros(4, 8), torch.ones(4))
    with pytest.raises(TypeError):
        rmsnorm(torch.zeros(4, 8), torch.ones(8, dtype=torch.bfloat16))
    x = torch.zeros(4, 8, dtype=torch.bfloat16)
    assert rmsnorm(x, torch.ones(8, dtype=torch.bfloat16)).dtype == \
        torch.bfloat16
