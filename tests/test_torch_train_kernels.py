"""The training path's kernels: the backward kernels of ``rmsnorm`` and
``flash_attention`` and the rule that no CUDA wrapper cuts a gradient
(``ssd_scan``'s backward has its own file, ``test_torch_ssd_grad.py``).

Tests marked ``cuda`` skip without an NVIDIA GPU; this file imports neither
jax nor the JAX package, so they run on a machine with only the port's
dependencies:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_train_kernels.py

On the card each backward kernel is held against autograd of its plain
forward (``ref.rmsnorm_ref``; ``ref.flash_attention_bf16p_ref`` in bf16,
``ref.flash_attention_ref`` in float32) at relative L2 2e-4 in float32 and
1e-2 in bf16 on every output (dx, dw; dq, dk, dv), at cut-down versions of
``chip_smoke.py``'s training shapes and at the edges of the kernels' tiles
and forms (ragged S and rows, GQA groups of 1 and 8, windows at D = 128,
dO views, every rmsnorm form's D, views with a storage offset; the head
dim of 192 with v of 192 and of 128), and repeats its bits. On the CPU the
two ``autograd.Function``s pass ``torch.autograd.gradcheck`` in float64
through their plain route (``ref.rmsnorm_bwd_ref``,
``ref.flash_attention_bwd_ref``: the kernels' formulas), and those formulas
agree with autograd of the plain forwards.
"""
import pytest
import torch

from repro_torch.kernels import _cuda
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import flash_decode as fd
from repro_torch.kernels import ref
from repro_torch.kernels import rmsnorm as rn
from repro_torch.kernels import ssd_scan as ssd

REL = {torch.float32: 2e-4, torch.bfloat16: 1e-2}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # the float64 gradchecks run thousands of tiny forwards: one thread a
    # worker keeps them from fighting the other test workers for cores
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; chip_smoke.py's train phase runs "
                    "these checks on the card")
    return torch.device("cuda")


def _rel_l2(got, want):
    got, want = got.double(), want.double()
    return float(torch.linalg.vector_norm(got - want)
                 / torch.clamp(torch.linalg.vector_norm(want), min=1e-30))


def _randn(gen, shape, dtype, dev):
    return torch.randn(shape, generator=gen, device=dev).to(dtype)


def _leaf(t):
    return t.detach().clone().requires_grad_(True)


# (name, B, Hq, Hkv, Sq, Sk, D, causal, window): SmolLM-360M's training
# shape and Qwen3-8B's cut in B and S, a window, Whisper's non-causal
# cross shape (Sq != Sk), a ragged S, D = 80, dead rows (window 0); then
# the bf16 kernels' edges: S not a multiple of their 64- and 128-row tiles
# (129, 1000), GQA groups of 1 and 8, D = 128 with a window, a
# rectangular non-causal call at D = 128
ATTN_CASES = (
    ("smollm-360m", 2, 15, 5, 256, 256, 64, True, None),
    ("qwen3-8b", 1, 32, 8, 192, 192, 128, True, None),
    ("window", 2, 4, 2, 300, 300, 64, True, 64),
    ("noncausal-16x300", 2, 4, 4, 16, 300, 64, False, None),
    ("ragged", 1, 6, 2, 200, 200, 64, True, None),
    ("d80", 1, 4, 1, 130, 130, 80, True, None),
    ("tiny", 2, 4, 2, 16, 16, 16, True, None),
    ("s129", 1, 4, 2, 129, 129, 64, True, None),
    ("s1000-group8", 1, 8, 1, 1000, 1000, 64, True, None),
    ("group1-d128", 2, 4, 4, 256, 256, 128, True, None),
    ("d128-window", 1, 8, 2, 300, 300, 128, True, 100),
    ("noncausal-d128", 1, 4, 2, 70, 200, 128, False, None),
)


def _attn_grads(q, k, v, g, fn, **kw):
    q, k, v = (_leaf(t) for t in (q, k, v))
    # the model's (B, S, H, D) projections reach the kernel as views
    qv, kv, vv = (t.transpose(1, 2).contiguous().transpose(1, 2)
                  for t in (q, k, v))
    out = fn(qv, kv, vv, **kw)
    out.backward(g)
    return out.detach(), q.grad, k.grad, v.grad


# (name, B, Hq, Hkv, Sq, Sk, D, Dv, causal, window): the 192 tile of the
# bf16 backward (dK and dV a pass each) and the float32 kernel's widest
# columns: Nemotron's head (192, 192) cut in heads and S, MLA's (192, 128),
# a ragged S with a window, a rectangular non-causal call
WIDE_CASES = (
    ("nemotron-192", 1, 12, 1, 256, 256, 192, 192, True, None),
    ("mla-192x128", 2, 4, 4, 200, 200, 192, 128, True, None),
    ("d192-window", 1, 4, 2, 300, 300, 192, 192, True, 100),
    ("noncausal-192x128", 1, 4, 2, 70, 200, 192, 128, False, None),
)


def _attn_case_check(card, dtype, B, Hq, Hkv, Sq, Sk, D, Dv, causal, window):
    gen = torch.Generator(device=card).manual_seed(0)
    q = _randn(gen, (B, Hq, Sq, D), dtype, card)
    k = _randn(gen, (B, Hkv, Sk, D), dtype, card)
    v = _randn(gen, (B, Hkv, Sk, Dv), dtype, card)
    g = _randn(gen, (B, Hq, Sq, Dv), dtype, card)
    plain = (ref.flash_attention_bf16p_ref if dtype == torch.bfloat16
             else ref.flash_attention_ref)
    n = fa.LAUNCHES["flash_attention_bwd"]
    got = _attn_grads(q, k, v, g, fa.flash_attention, causal=causal,
                      window=window)
    assert fa.LAUNCHES["flash_attention_bwd"] == n + 1
    want = _attn_grads(q, k, v, g, plain, causal=causal, window=window)
    for name, a, b in zip(("out", "dq", "dk", "dv"), got, want):
        assert torch.isfinite(a.float()).all(), name
        assert _rel_l2(a, b) < REL[dtype], (name, _rel_l2(a, b))
    again = _attn_grads(q, k, v, g, fa.flash_attention, causal=causal,
                        window=window)
    for a, b in zip(got, again):   # no atomics: the bits repeat
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", ATTN_CASES, ids=lambda c: c[0])
def test_flash_attention_bwd_matches_plain(card, case, dtype):
    _, B, Hq, Hkv, Sq, Sk, D, causal, window = case
    _attn_case_check(card, dtype, B, Hq, Hkv, Sq, Sk, D, D, causal, window)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", WIDE_CASES, ids=lambda c: c[0])
def test_flash_attention_bwd_wide_heads_match_plain(card, case, dtype):
    _attn_case_check(card, dtype, *case[1:])


@pytest.mark.cuda
def test_a_cuda_tensor_never_reaches_the_plain_attention(card, monkeypatch):
    """Under grad mode on the card at D <= 192, the forward and the
    backward launch the kernels: no plain version is called."""
    def refuse(*a, **k):
        raise AssertionError("the plain attention was reached")
    for name in ("flash_attention_ref", "flash_attention_lse_ref",
                 "flash_attention_bwd_ref", "flash_attention_bf16p_ref"):
        monkeypatch.setattr(ref, name, refuse)
    gen = torch.Generator(device=card).manual_seed(6)
    for dtype, D, Dv in ((torch.bfloat16, 192, 128), (torch.bfloat16, 64, 64),
                         (torch.float32, 192, 192)):
        q = _randn(gen, (1, 4, 130, D), dtype, card).requires_grad_(True)
        k = _randn(gen, (1, 2, 130, D), dtype, card).requires_grad_(True)
        v = _randn(gen, (1, 2, 130, Dv), dtype, card).requires_grad_(True)
        n = dict(fa.LAUNCHES)
        out = fa.flash_attention(q, k, v)
        grads = torch.autograd.grad(out, (q, k, v), torch.ones_like(out))
        assert all(torch.isfinite(t.float()).all() for t in grads)
        assert fa.LAUNCHES["flash_attention"] == n["flash_attention"] + 1
        assert (fa.LAUNCHES["flash_attention_bwd"]
                == n["flash_attention_bwd"] + 1)


def _off16_view(t):
    """``t``'s values in a (B, H, S, D) view whose S stride is D + 4
    elements: off 16 bytes in bf16."""
    B, H, S, D = t.shape
    wide = torch.zeros((B, H, S, D + 4), dtype=t.dtype, device=t.device)
    wide[..., :D] = t
    return wide[..., :D]


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["transposed", "off16"])
def test_flash_attention_bwd_dout_views(card, layout):
    """dO as the model's transposed view (read as it lies) and with strides
    off 16 bytes (copied first): the kernels run and match plain."""
    bf = torch.bfloat16
    gen = torch.Generator(device=card).manual_seed(5)
    B, Hq, Hkv, S, D = 2, 6, 2, 200, 64
    q = _randn(gen, (B, Hq, S, D), bf, card)
    k = _randn(gen, (B, Hkv, S, D), bf, card)
    v = _randn(gen, (B, Hkv, S, D), bf, card)
    g = _randn(gen, (B, Hq, S, D), bf, card)
    view = (g.transpose(1, 2).contiguous().transpose(1, 2)
            if layout == "transposed" else _off16_view(g))
    assert torch.equal(view, g)
    assert (fa._tma_operand(view) is view) == (layout == "transposed")
    out, lse = fa._forward(q, k, v, True, None, None, with_lse=True)
    n = fa.LAUNCHES["flash_attention_bwd"]
    got = fa.flash_attention_bwd(q, k, v, out, lse, view)
    assert fa.LAUNCHES["flash_attention_bwd"] == n + 1
    want = _attn_grads(q, k, v, g, ref.flash_attention_bf16p_ref)[1:]
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert _rel_l2(a, b) < REL[bf], (name, _rel_l2(a, b))
    again = fa.flash_attention_bwd(q, k, v, out, lse, view)
    for a, b in zip(got, again):
        assert torch.equal(a, b)
    base = fa.flash_attention_bwd(q, k, v, out, lse, g.contiguous())
    for a, b in zip(got, base):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_flash_attention_dead_rows_give_zero_gradients(card, dtype):
    gen = torch.Generator(device=card).manual_seed(1)
    q, k, v, g = (_randn(gen, (1, 2, 70, 64), dtype, card) for _ in range(4))
    out, dq, dk, dv = _attn_grads(q, k, v, g, fa.flash_attention,
                                  causal=True, window=0)
    for t in (out, dq, dk, dv):
        assert torch.equal(t, torch.zeros_like(t))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("rows,D,offset", [
    (2048, 960, 0), (512, 4096, 0), (37, 64, 0), (5, 13, 0), (1, 960, 0),
    # each form's D (scalar 13; lane groups 64; row groups of 1, 4 and 8
    # warps in bf16, 2, 8 and 16 in float32) at row counts that are not
    # a multiple of the rows a block walks
    (1001, 13, 0), (3001, 64, 0), (16385, 960, 0), (2049, 4096, 0),
    (777, 8192, 0),
    # a view with a storage offset (off 16 bytes: the scalar form)
    (300, 960, 1), (300, 64, 1)])
def test_rmsnorm_bwd_matches_plain(card, rows, D, offset, dtype):
    gen = torch.Generator(device=card).manual_seed(0)
    x = _randn(gen, (rows * D + offset,), dtype, card)[offset:].view(rows, D)
    w = (1.0 + 0.1 * torch.randn(D, generator=gen, device=card)).to(dtype)
    g = _randn(gen, (rows, D), dtype, card)

    def grads(fn):
        xl, wl = _leaf(x), _leaf(w)
        y = fn(xl, wl, eps=1e-6)
        y.backward(g)
        return y.detach(), xl.grad, wl.grad

    n = rn.LAUNCHES["rmsnorm_bwd"]
    got = grads(rn.rmsnorm)
    assert rn.LAUNCHES["rmsnorm_bwd"] == n + 1
    want = grads(ref.rmsnorm_ref)
    for name, a, b in zip(("y", "dx", "dw"), got, want):
        assert a.dtype == b.dtype, name
        assert _rel_l2(a, b) < REL[dtype], (name, _rel_l2(a, b))
    for a, b in zip(got, grads(rn.rmsnorm)):
        assert torch.equal(a, b)
    # the wrapper on x itself (autograd's leaf is an aligned clone)
    direct = rn.rmsnorm_bwd(x, w, g)
    for name, a, b in zip(("dx", "dw"), direct, want[1:]):
        assert _rel_l2(a, b) < REL[dtype], (name, _rel_l2(a, b))
    for a, b in zip(direct, rn.rmsnorm_bwd(x, w, g)):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_no_wrapper_cuts_a_gradient(card):
    """A CUDA tensor that needs a gradient: rmsnorm, flash_attention and
    ssd_scan return outputs with a grad_fn (their backward kernels);
    flash_decode, which no training path calls, raises."""
    gen = torch.Generator(device=card).manual_seed(0)
    bf = torch.bfloat16
    x = _randn(gen, (4, 64), bf, card).requires_grad_(True)
    w = torch.ones(64, dtype=bf, device=card)
    assert rn.rmsnorm(x, w).grad_fn is not None
    q = _randn(gen, (1, 2, 16, 64), bf, card).requires_grad_(True)
    k = _randn(gen, (1, 2, 16, 64), bf, card)
    assert fa.flash_attention(q, k, k).grad_fn is not None
    with pytest.raises(RuntimeError, match="flash_decode.*ROADMAP"):
        fd.flash_decode(_randn(gen, (1, 2, 2, 64), bf, card).requires_grad_(),
                        k, k, torch.ones(16, dtype=torch.bool, device=card))
    f32 = torch.float32
    xs = _randn(gen, (1, 16, 2, 16), bf, card).requires_grad_(True)
    ssd_args = (torch.rand((1, 16, 2), device=card),
                -torch.ones(2, device=card),
                _randn(gen, (1, 16, 1, 16), bf, card),
                _randn(gen, (1, 16, 1, 16), bf, card),
                torch.ones(2, dtype=f32, device=card))
    assert ssd.ssd_scan(xs, *ssd_args, chunk=16).grad_fn is not None
    # without grad mode the serving path is unchanged, and no graph
    with torch.inference_mode():
        assert rn.rmsnorm(x, w).grad_fn is None
        assert fa.flash_attention(q, k, k).grad_fn is None
        assert ssd.ssd_scan(xs, *ssd_args, chunk=16).grad_fn is None


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_lse_leaves_the_forward_bitwise(card, dtype):
    gen = torch.Generator(device=card).manual_seed(2)
    q = _randn(gen, (2, 15, 200, 64), dtype, card)
    k = _randn(gen, (2, 5, 200, 64), dtype, card)
    with torch.inference_mode():
        serve = fa.flash_attention(q, k, k)
    train = fa.flash_attention(_leaf(q), k, k)
    assert torch.equal(serve, train.detach())
    _, lse = ref.flash_attention_lse_ref(q, k, k)
    out, got = fa._forward(q, k, k, True, None, None, with_lse=True)
    assert torch.equal(out, serve)
    torch.testing.assert_close(got, lse, atol=REL[dtype], rtol=REL[dtype])


# ------------------------------------------------------------ on the CPU
def test_rmsnorm_function_gradcheck_float64():
    gen = torch.Generator().manual_seed(0)
    x = torch.randn((3, 5, 24), generator=gen, dtype=torch.float64,
                    requires_grad=True)
    w = torch.randn((24,), generator=gen, dtype=torch.float64,
                    requires_grad=True)
    assert torch.autograd.gradcheck(
        lambda x, w: rn._RMSNorm.apply(x, w, 1e-6), (x, w))


@pytest.mark.parametrize("causal,window,Sq,Sk", [
    (True, None, 9, 9), (True, 4, 9, 9), (False, None, 5, 7),
    (True, 0, 4, 4)], ids=["causal", "window", "rect", "dead"])
def test_flash_attention_function_gradcheck_float64(causal, window, Sq, Sk):
    gen = torch.Generator().manual_seed(0)

    def leaf(*shape):
        return torch.randn(shape, generator=gen, dtype=torch.float64,
                           requires_grad=True)
    q, k, v = leaf(1, 6, Sq, 4), leaf(1, 2, Sk, 4), leaf(1, 2, Sk, 3)
    assert torch.autograd.gradcheck(
        lambda q, k, v: fa._FlashAttention.apply(q, k, v, causal, window,
                                                 None), (q, k, v))


@pytest.mark.parametrize("Dv", [192, 128])
def test_flash_attention_function_gradcheck_float64_d192(Dv):
    """The head dims of Nemotron (192) and MLA (q, k of 192, v of 128)
    through the Function's plain route."""
    gen = torch.Generator().manual_seed(1)

    def leaf(*shape):
        return torch.randn(shape, generator=gen, dtype=torch.float64,
                           requires_grad=True)
    q, k, v = leaf(1, 2, 3, 192), leaf(1, 1, 3, 192), leaf(1, 1, 3, Dv)
    assert torch.autograd.gradcheck(
        lambda q, k, v: fa._FlashAttention.apply(q, k, v, True, None, None),
        (q, k, v))


@pytest.mark.parametrize("D,Dv,dtype,ok", [
    (192, 192, torch.bfloat16, True), (192, 128, torch.bfloat16, True),
    (64, 64, torch.bfloat16, True), (128, 128, torch.bfloat16, True),
    (192, 192, torch.float32, True), (100, 40, torch.float32, True),
    (256, 256, torch.bfloat16, False), (256, 256, torch.float32, False),
    (64, 128, torch.bfloat16, False), (128, 192, torch.bfloat16, False)],
    ids=lambda v: str(v).replace("torch.", ""))
def test_backward_head_dims(D, Dv, dtype, ok):
    """The backward's head dims: up to 192 in both dtypes (bf16: the (q/k,
    v) tile pairs of its instances); 256, which no architecture of the zoo
    trains, raises with its own message."""
    q = torch.zeros((1, 2, 4, D), dtype=dtype)
    v = torch.zeros((1, 2, 4, Dv), dtype=dtype)
    if ok:
        fa._check_bwd(q, q, v)
    else:
        with pytest.raises(ValueError, match="no architecture" if D == 256
                           else "tiles are in"):
            fa._check_bwd(q, q, v)


@pytest.mark.parametrize("case", ATTN_CASES[2:], ids=lambda c: c[0])
def test_attention_bwd_formulas_match_autograd(case):
    """The backward kernels' formulas (``ref.flash_attention_bwd_ref`` from
    the forward's out and LSE) against autograd of the plain forward."""
    _, B, Hq, Hkv, Sq, Sk, D, causal, window = case
    gen = torch.Generator().manual_seed(3)
    q, k, v = (torch.randn(s, generator=gen) for s in (
        (B, Hq, Sq, D), (B, Hkv, Sk, D), (B, Hkv, Sk, D)))
    g = torch.randn((B, Hq, Sq, D), generator=gen)
    _, dq, dk, dv = _attn_grads(q, k, v, g, ref.flash_attention_ref,
                                causal=causal, window=window)
    out, lse = ref.flash_attention_lse_ref(q, k, v, causal=causal,
                                           window=window)
    got = fa.flash_attention_bwd(q, k, v, out, lse, g, causal=causal,
                                 window=window)
    for a, b in zip(got, (dq, dk, dv)):
        assert _rel_l2(a, b) < 1e-5


def test_tma_operand_copies_only_what_tma_cannot_read():
    """The bf16 backward's dO and out: the model's transposed view is read
    as it lies; strides or a base off 16 bytes, or a strided last axis, are
    copied to a contiguous tensor."""
    bf = torch.bfloat16
    g = torch.randn(2, 6, 200, 64).to(bf)
    transposed = g.transpose(1, 2).contiguous().transpose(1, 2)
    assert fa._tma_ready(g) and fa._tma_ready(transposed)
    assert fa._tma_operand(transposed) is transposed
    flat = torch.empty(g.numel() + 1, dtype=bf)
    offset = flat[1:].view(g.shape).copy_(g)
    for t in (_off16_view(g), offset, g.transpose(2, 3).contiguous()
              .transpose(2, 3)):
        assert not fa._tma_ready(t)
        c = fa._tma_operand(t)
        assert c.is_contiguous() and c.data_ptr() != t.data_ptr()
        assert fa._tma_ready(c) and torch.equal(c, t)


def test_rmsnorm_bwd_formula_matches_autograd():
    gen = torch.Generator().manual_seed(4)
    x = torch.randn((9, 40), generator=gen)
    w = torch.randn((40,), generator=gen)
    g = torch.randn((9, 40), generator=gen)
    xl, wl = _leaf(x), _leaf(w)
    ref.rmsnorm_ref(xl, wl).backward(g)
    dx, dw = rn.rmsnorm_bwd(x, w, g)
    assert _rel_l2(dx, xl.grad) < 1e-6 and _rel_l2(dw, wl.grad) < 1e-6


def test_forbid_grad_raises_only_when_a_gradient_is_due():
    t = torch.zeros(3, requires_grad=True)
    with pytest.raises(RuntimeError, match="kern's CUDA kernel has no "
                                           "backward.*ROADMAP"):
        _cuda.forbid_grad("kern", None, t, why="see ROADMAP.md")
    _cuda.forbid_grad("kern", t.detach(), why="see ROADMAP.md")
    with torch.no_grad():
        _cuda.forbid_grad("kern", t, why="see ROADMAP.md")


def test_cpu_wrappers_keep_the_plain_gradient():
    """On the CPU the wrappers run the plain versions, whose own autograd
    gives the gradient (no Function, no kernel)."""
    x = torch.randn(4, 8, requires_grad=True)
    w = torch.ones(8, requires_grad=True)
    y = rn.rmsnorm(x, w)
    y.sum().backward()
    assert x.grad is not None and w.grad is not None
    q = torch.randn(1, 2, 5, 8, requires_grad=True)
    out = fa.flash_attention(q, q.detach(), q.detach())
    out.sum().backward()
    assert q.grad is not None
