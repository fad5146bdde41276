"""The gradient of the port's SSD scan.

On the CPU, with numpy inputs from a seed, the gradient of
``kernels.ssd_scan.ssd_scan`` (autograd of its plain version,
``ref.ssd_chunked_ref``) is held against ``jax.grad`` of the JAX package's
``ops.ssd(..., impl="xla")`` at relative L2 1e-4 on each of x, dt, A, B, C
and D: short and ragged S, one and two B/C groups, chunks of 8 and 16, the
plain grouped walk, and a tie of two cumulative decays (dt = 0 on a row),
where the clamp ``min(cum_t - cum_s, 0)`` passes half its gradient to each
side in JAX. ``ref.ssd_chunked_bwd_ref`` (the backward kernel's formulas)
is held against autograd of the forward at 1e-5, and the
``autograd.Function`` passes ``torch.autograd.gradcheck`` in float64
through its plain route. The backward walked in chunks shorter than the
forward's (64 under Mamba2's 128) holds ``jax.grad`` at the forward's
chunk with ties across its chunk boundaries and across the forward's.
JAX is imported inside the tests that use it. Run as a script, it prints
which step of the plain scan sets its float32 gradient's distance from
float64 (ROADMAP.md section 3, item 26), and ddt's distance at a tie
across the backward's chunks with the clamp acting within them and
within the forward's (item 31).

Tests marked ``cuda`` skip without an NVIDIA GPU and need no JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_ssd_grad.py

On the card the backward kernel is held against ``ref.ssd_chunked_bwd_ref``
and against autograd of ``ref.ssd_chunked_ref`` at 2e-4 (float32) and 1e-2
(bf16) on every gradient, at cut-down versions of ``chip_smoke.py``'s
``BWD_SSD_CASES`` and at ties across its chunks, and repeats its bits.
"""
import contextlib

import numpy as np
import pytest
import torch

from repro_torch.kernels import ref
from repro_torch.kernels import ssd_scan as ssd

NAMES = ("x", "dt", "A", "B", "C", "D")
REL = {torch.float32: 2e-4, torch.bfloat16: 1e-2}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; chip_smoke.py's train phase runs "
                    "these checks on the card")
    return torch.device("cuda")


def _as_tensor(a):
    return a.detach() if isinstance(a, torch.Tensor) else torch.from_numpy(
        np.array(a))


def _rel_l2(got, want):
    got, want = _as_tensor(got).double(), _as_tensor(want).double()
    return float(torch.linalg.vector_norm(got - want)
                 / torch.clamp(torch.linalg.vector_norm(want), min=1e-30))


def _inputs(B, S, H, P, G, N, seed=0, zero_rows=()):
    """x, dt, A, Bm, Cm, D and the cotangent dy as float32 numpy arrays."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, H, P)).astype(np.float32)
    dt = (0.05 + 0.1 * rng.random((B, S, H))).astype(np.float32)
    dt[:, list(zero_rows)] = 0.0
    A = -(0.5 + rng.random(H)).astype(np.float32)
    Bm = rng.standard_normal((B, S, G, N)).astype(np.float32)
    Cm = rng.standard_normal((B, S, G, N)).astype(np.float32)
    D = rng.standard_normal(H).astype(np.float32)
    dy = rng.standard_normal((B, S, H, P)).astype(np.float32)
    return (x, dt, A, Bm, Cm, D), dy


def _jax_grads(arrs, dy, chunk):
    import jax
    import jax.numpy as jnp
    from repro.kernels import ops as jops

    def loss(*a):
        return jnp.sum(jops.ssd(*a, chunk=chunk, impl="xla") * dy)
    return [np.asarray(g) for g in jax.grad(loss, argnums=tuple(range(6)))(
        *[jnp.asarray(a) for a in arrs])]


def _port_grads(arrs, dy, chunk, fn=None):
    leaves = [torch.tensor(a, requires_grad=True) for a in arrs]
    y = (fn or (lambda *a: ssd.ssd_scan(*a, chunk=chunk)))(*leaves)
    return [g.numpy() for g in torch.autograd.grad(y, leaves,
                                                   torch.tensor(dy))]


def _hold(got, want, tol):
    for name, a, b in zip(NAMES, got, want):
        assert _rel_l2(a, b) < tol, (name, _rel_l2(a, b))


# (B, S, H, P, G, N, chunk): S of 16 and a ragged 37, one and two groups,
# chunks of 8 and 16
JAX_CASES = tuple((2, S, 4, 4, G, 8, chunk) for S in (16, 37)
                  for G in (1, 2) for chunk in (8, 16))


@pytest.mark.parametrize("case", JAX_CASES, ids=lambda c: "S%d-G%d-L%d" % (
    c[1], c[4], c[6]))
def test_ssd_grad_matches_jax(case):
    B, S, H, P, G, N, chunk = case
    arrs, dy = _inputs(B, S, H, P, G, N, seed=S + G + chunk)
    _hold(_port_grads(arrs, dy, chunk), _jax_grads(arrs, dy, chunk), 1e-4)


def test_grouped_walk_grad_matches_jax():
    """The plain walk in groups of chunks (each group's end state from
    zero, then the incoming states in group order) differentiates to the
    reference's gradient."""
    arrs, dy = _inputs(1, 40, 2, 4, 1, 8, seed=7)
    want = _jax_grads(arrs, dy, 8)
    for groups in (2, 3, 5):
        got = _port_grads(arrs, dy, 8, fn=lambda *a: ref.ssd_chunked_ref(
            *a, chunk=8, groups=groups))
        _hold(got, want, 1e-4)


def test_tied_decays_split_the_clamp_gradient_as_jax():
    """dt = 0 on row 5 ties cum_5 with cum_4 inside a chunk of 8: the
    clamp's gradient there is 0.5 a side in JAX (``jnp.minimum``); a clamp
    that passes all of it puts ddt 5e-2 relative L2 from the reference."""
    arrs, dy = _inputs(1, 16, 2, 4, 1, 8, seed=0, zero_rows=(5,))
    got = _port_grads(arrs, dy, 8)
    _hold(got, _jax_grads(arrs, dy, 8), 1e-4)
    _hold(ref.ssd_chunked_bwd_ref(*[torch.tensor(a) for a in arrs],
                                  torch.tensor(dy), chunk=8), got, 1e-5)


# (B, S, H, P, G, N, chunk, zero rows): short, ragged, two groups, a
# chunk longer than S, ties inside and across chunks
BWD_CASES = (
    (1, 16, 2, 4, 1, 8, 8, ()),
    (2, 37, 4, 4, 2, 8, 16, ()),
    (2, 37, 4, 4, 2, 8, 8, (3, 4, 15, 16)),
    (1, 9, 3, 5, 3, 6, 64, ()),
    (1, 50, 2, 8, 1, 16, 16, (0,)),
)


@pytest.mark.parametrize("case", BWD_CASES, ids=lambda c: "S%d-G%d-L%d%s" % (
    c[1], c[4], c[6], "-tie" if c[7] else ""))
def test_bwd_formulas_match_autograd(case):
    """``ref.ssd_chunked_bwd_ref`` (the reverse walk the kernel takes)
    against autograd of the forward, at the forward's chunk."""
    B, S, H, P, G, N, chunk, zeros = case
    arrs, dy = _inputs(B, S, H, P, G, N, seed=S, zero_rows=zeros)
    want = _port_grads(arrs, dy, chunk, fn=lambda *a: ref.ssd_chunked_ref(
        *a, chunk=chunk))
    got = ref.ssd_chunked_bwd_ref(*[torch.tensor(a) for a in arrs],
                                  torch.tensor(dy), chunk=chunk)
    for g, a in zip(got, arrs):
        assert g.shape == a.shape and g.dtype == torch.float32
    _hold(got, want, 1e-5)


@pytest.mark.parametrize("S,chunk", [(11, 4), (7, 16)],
                         ids=["ragged", "one-chunk"])
def test_function_gradcheck_float64(S, chunk):
    gen = torch.Generator().manual_seed(0)
    f64 = torch.float64

    def leaf(t):
        return t.to(f64).requires_grad_(True)
    x = leaf(torch.randn((1, S, 4, 3), generator=gen))
    dt = leaf(0.05 + 0.2 * torch.rand((1, S, 4), generator=gen))
    A = leaf(-0.5 - torch.rand((4,), generator=gen))
    Bm = leaf(torch.randn((1, S, 2, 5), generator=gen))
    Cm = leaf(torch.randn((1, S, 2, 5), generator=gen))
    D = leaf(torch.randn((4,), generator=gen))
    assert torch.autograd.gradcheck(
        lambda *a: ssd._SsdScan.apply(*a, chunk, False),
        (x, dt, A, Bm, Cm, D))


def test_function_rejects_a_final_state_cotangent():
    arrs, _ = _inputs(1, 8, 2, 4, 1, 8)
    leaves = [torch.tensor(a, requires_grad=True) for a in arrs]
    y, state = ssd._SsdScan.apply(*leaves, 4, True)
    y.sum().backward(retain_graph=True)   # the state unused: no cotangent
    assert leaves[0].grad is not None
    with pytest.raises(RuntimeError, match="no cotangent of the final"):
        (y.sum() + state.sum()).backward()


def test_bwd_chunk_is_the_shape_alone():
    # Mamba2-2.7B's layer: the forward's 128 rows cut to 64
    assert ssd.bwd_chunk(2048, 128) == ssd.BWD_MAX_CHUNK == 64
    assert ssd.bwd_chunk(10, 16) == 10      # S under the chunk
    assert ssd.bwd_chunk(100, 16) == 16     # the forward's chunk


# (B, S, H, P, G, N, forward chunk, backward chunk, zero rows): a zero run
# across a backward boundary inside a forward chunk; across a forward
# boundary inside a backward chunk (12 is no multiple of 8), alone and with
# a run across the backward boundary at 16; one longer than a backward
# chunk; a ragged S with two groups; and no tie at all
SHORT_CASES = (
    (1, 32, 2, 4, 1, 8, 16, 8, (5, 6, 7, 8, 9, 10)),
    (2, 40, 3, 4, 1, 8, 12, 8, (10, 11, 12, 13, 14, 15, 16, 17)),
    (2, 40, 3, 4, 1, 8, 12, 8, (10, 11, 12, 14, 15, 16, 17)),
    (1, 64, 2, 4, 1, 8, 32, 8, tuple(range(5, 21))),
    (2, 37, 4, 4, 2, 8, 16, 8, (6, 7, 8, 9, 22, 23, 24, 25)),
    (1, 40, 2, 4, 1, 8, 12, 8, ()),
)


@pytest.mark.parametrize("case", SHORT_CASES, ids=lambda c: "S%d-Lf%d-L%d-%d" % (
    c[1], c[6], c[7], len(c[8])))
def test_bwd_formulas_in_shorter_chunks_match_jax(case):
    """The backward walked in chunks shorter than the forward's keeps the
    reference's clamp, which acts within the forward's chunks: ties across
    the walk's boundaries, and pairs of one of its chunks in two forward
    chunks, take JAX's gradient."""
    B, S, H, P, G, N, fwd, bwd, zeros = case
    arrs, dy = _inputs(B, S, H, P, G, N, seed=S + fwd, zero_rows=zeros)
    got = ref.ssd_chunked_bwd_ref(*[torch.tensor(a) for a in arrs],
                                  torch.tensor(dy), chunk=bwd, fwd_chunk=fwd)
    _hold(got, _jax_grads(arrs, dy, fwd), 1e-4)


# dt = 0 on rows 60-67 of a forward chunk of 128 (Mamba2's), across the
# backward's chunk boundary at row 64: row 59's decay ties with rows 60-67's
STRADDLE_ROWS = tuple(range(60, 68))


def test_tie_across_the_backward_chunk_matches_jax():
    """At Mamba2's widths (P 64, N 128; B 1, S 256, H 2) the wrapper's
    backward (chunks of 64 under the forward's 128) against ``jax.grad`` of
    the reference at 128, with a tie across row 64."""
    assert ssd.bwd_chunk(256, 128) == 64
    arrs, dy = _inputs(1, 256, 2, 64, 1, 128, zero_rows=STRADDLE_ROWS)
    got = ssd.ssd_scan_bwd(*[torch.tensor(a) for a in arrs],
                           torch.tensor(dy), chunk=128)
    _hold(got, _jax_grads(arrs, dy, 128), 1e-4)


def test_cpu_wrappers_give_the_plain_gradient():
    """On the CPU ssd_scan is the plain version with its own autograd (no
    Function), and ssd_scan_bwd the kernel's formulas."""
    arrs, dy = _inputs(1, 20, 2, 4, 1, 8, seed=3)
    leaves = [torch.tensor(a, requires_grad=True) for a in arrs]
    y = ssd.ssd_scan(*leaves, chunk=8)
    assert "SsdScan" not in type(y.grad_fn).__name__
    want = torch.autograd.grad(y, leaves, torch.tensor(dy))
    n = ssd.LAUNCHES["ssd_scan_bwd"]
    got = ssd.ssd_scan_bwd(*[torch.tensor(a) for a in arrs],
                           torch.tensor(dy), chunk=8)
    assert ssd.LAUNCHES["ssd_scan_bwd"] == n
    _hold(got, want, 1e-5)


# ------------------------------------------------------------ on the card
# (name, B, S, H, P, G, N, chunk): cut-down versions of chip_smoke.py's
# BWD_SSD_CASES (Mamba2-2.7B's layer width at B 1, S 512, H 8; a ragged S;
# G > 1; several chunks of a long S), and a one-chunk sequence
CARD_CASES = (
    ("mamba2-layer", 1, 512, 8, 64, 1, 128, 128),
    ("ragged", 2, 300, 4, 64, 1, 128, 128),
    ("groups", 1, 256, 8, 64, 2, 128, 128),
    ("long", 1, 2048, 2, 64, 1, 128, 128),
    ("one-chunk", 2, 40, 4, 16, 1, 32, 64),
    ("tiny-jamba", 2, 37, 4, 8, 1, 16, 16),
)


def _card_inputs(case, dtype, dev):
    _, B, S, H, P, G, N, _ = case
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(shape, dt=dtype, scale=1.0):
        return (scale * torch.randn(shape, generator=gen, device=dev)).to(dt)
    x = randn((B, S, H, P))
    dt = torch.nn.functional.softplus(randn((B, S, H), torch.float32) - 2.0)
    A = -torch.linspace(1.0, 16.0, H, device=dev)
    # B and C as the model's strided column views of one projection
    bc = randn((B, S, 2 * G * N), scale=0.3)
    Bm = bc[..., :G * N].reshape(B, S, G, N)
    Cm = bc[..., G * N:].reshape(B, S, G, N)
    D = torch.ones((H,), device=dev)
    dy = randn((B, S, H, P))
    return (x, dt, A, Bm, Cm, D), dy


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", CARD_CASES, ids=lambda c: c[0])
def test_ssd_bwd_kernel_matches_plain(card, case, dtype):
    chunk = case[-1]
    arrs, dy = _card_inputs(case, dtype, card)
    leaves = [t.detach().clone().requires_grad_(True) for t in arrs]
    n = ssd.LAUNCHES["ssd_scan_bwd"]
    y = ssd.ssd_scan(*leaves, chunk=chunk)
    assert y.grad_fn is not None
    got = torch.autograd.grad(y, leaves, dy)
    assert ssd.LAUNCHES["ssd_scan_bwd"] == n + 1
    L = ssd.bwd_chunk(case[2], chunk)
    formulas = ref.ssd_chunked_bwd_ref(*arrs, dy, chunk=L, fwd_chunk=chunk)
    pl = [t.detach().clone().requires_grad_(True) for t in arrs]
    auto = torch.autograd.grad(ref.ssd_chunked_ref(*pl, chunk=chunk), pl, dy)
    for name, a, f, w in zip(NAMES, got, formulas, auto):
        assert a.dtype == w.dtype and a.shape == w.shape, name
        assert torch.isfinite(a.float()).all(), name
        assert _rel_l2(a, f) < REL[dtype], (name, _rel_l2(a, f))
        assert _rel_l2(a, w) < REL[dtype], (name, _rel_l2(a, w))
    again = torch.autograd.grad(ssd.ssd_scan(*leaves, chunk=chunk), leaves,
                                dy)
    for a, b in zip(got, again):   # no atomics: the bits repeat
        assert torch.equal(a, b)


# (name, S, forward chunk, zero rows) at Mamba2's widths (B 1, H 8, P 64,
# N 128): a tie across the backward's boundary at 64 inside a forward chunk
# of 128; with forward chunks of 96, zero runs across the forward boundary
# at 96 inside the backward chunk [64, 128) and across the backward
# boundary at 128 inside the forward chunk [96, 192)
CARD_TIE_CASES = (
    ("straddle", 256, 128, STRADDLE_ROWS),
    ("chunk-96", 256, 96, tuple(range(90, 101)) + tuple(range(120, 136))),
)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", CARD_TIE_CASES, ids=lambda c: c[0])
def test_ssd_bwd_kernel_ties_across_its_chunks(card, case, dtype):
    """The kernel (chunks of 64, its fifth launch taking the ties' halves)
    against its formulas and against autograd of the plain forward."""
    name, S, chunk, zeros = case
    arrs, dy = _card_inputs((name, 1, S, 8, 64, 1, 128, chunk), dtype, card)
    arrs[1][:, list(zeros)] = 0.0
    leaves = [t.detach().clone().requires_grad_(True) for t in arrs]
    got = torch.autograd.grad(ssd.ssd_scan(*leaves, chunk=chunk), leaves, dy)
    formulas = ref.ssd_chunked_bwd_ref(*arrs, dy, chunk=ssd.bwd_chunk(S),
                                       fwd_chunk=chunk)
    pl = [t.detach().clone().requires_grad_(True) for t in arrs]
    auto = torch.autograd.grad(ref.ssd_chunked_ref(*pl, chunk=chunk), pl, dy)
    _hold(got, formulas, REL[dtype])
    _hold(got, auto, REL[dtype])


@pytest.mark.cuda
def test_a_cuda_tensor_never_reaches_the_plain_scan(card, monkeypatch):
    """Under grad mode on the card, the forward and the backward launch the
    kernels: neither plain version is called."""
    arrs, dy = _card_inputs(CARD_CASES[1], torch.bfloat16, card)

    def refuse(*a, **k):
        raise AssertionError("the plain SSD scan was reached")
    monkeypatch.setattr(ref, "ssd_chunked_ref", refuse)
    monkeypatch.setattr(ref, "ssd_chunked_bwd_ref", refuse)
    leaves = [t.detach().clone().requires_grad_(True) for t in arrs]
    n = dict(ssd.LAUNCHES)
    grads = torch.autograd.grad(ssd.ssd_scan(*leaves, chunk=128), leaves, dy)
    assert all(torch.isfinite(g.float()).all() for g in grads)
    assert ssd.LAUNCHES["ssd_scan"] == n["ssd_scan"] + 1
    assert ssd.LAUNCHES["ssd_scan_bwd"] == n["ssd_scan_bwd"] + 1


@pytest.mark.cuda
def test_card_rejects_a_final_state_cotangent(card):
    arrs, _ = _card_inputs(CARD_CASES[1], torch.float32, card)
    leaves = [t.detach().clone().requires_grad_(True) for t in arrs]
    y, state = ssd.ssd_scan(*leaves, chunk=128, return_final_state=True)
    with pytest.raises(RuntimeError, match="no cotangent of the final"):
        (y.sum() + state.sum()).backward()


# ----------------------------------------------- the float64 witness, by step
def _scan_inputs(arch="mamba2-2.7b", B=2, S=64):
    """The scan inputs (numpy, float32) of the tiny ``arch``'s first mamba
    layer on a SyntheticStream batch (seed 0), and a seeded cotangent."""
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticStream
    from repro_torch.kernels import ops
    from repro_torch.models import build_model
    from repro_torch.models.layers import embed_lookup, rms_norm
    from repro_torch.models import ssm
    cfg = get_config(arch).tiny()
    model = build_model(cfg, device="cpu", seed=0)
    blk = next(b for b in model.layers if b.spec.mixer == "mamba")
    tokens = torch.as_tensor(SyntheticStream(cfg, S, B, seed=0)
                             .batch_at(0).tokens)
    seen = []
    real = ops.ssd

    def record(*a, **k):
        seen.append([t.detach().numpy().copy() for t in a])
        return real(*a, **k)
    ops.ssd = record
    try:
        with torch.no_grad():
            h = rms_norm(embed_lookup(model.embed, tokens, cfg), blk.ln1,
                         cfg.norm_eps)
            ssm.mamba_apply(blk.mixer, h, cfg)
    finally:
        ops.ssd = real
    dy = np.random.default_rng(1).standard_normal(
        seen[0][0].shape).astype(np.float32)
    return seen[0], dy, cfg.ssd_chunk


@contextlib.contextmanager
def _widened(name):
    """``torch.<name>`` computing float32 operands in float64 (forward and,
    through autograd, backward) and rounding the result to float32."""
    real = getattr(torch, name)

    def wide(*args, **kw):
        is32 = any(isinstance(a, torch.Tensor) and a.dtype == torch.float32
                   for a in args)
        args = [a.double() if isinstance(a, torch.Tensor)
                and a.dtype == torch.float32 else a for a in args]
        out = real(*args, **kw)
        return out.float() if is32 else out
    setattr(torch, name, wide)
    try:
        yield
    finally:
        setattr(torch, name, real)


def _witness():
    """Which step of the plain scan costs the port's float32 gradient its
    distance from float64, at the tiny Mamba2's first layer: the port's
    and the reference's float32 gradients from the float64 one, then the
    port's with each step's torch function widened to float64."""
    arrs, dy, chunk = _scan_inputs()
    truth = _port_grads([a.astype(np.float64) for a in arrs],
                        dy.astype(np.float64), chunk)

    def report(who, got):
        errs = [_rel_l2(g, t) for g, t in zip(got, truth)]
        print(f"  {who:34s} " + " ".join(
            f"{n} {e:.2e}" for n, e in zip(NAMES, errs)))
    print(f"scan gradient from float64 (tiny mamba2-2.7b layer 0, x "
          f"{arrs[0].shape}, chunk {chunk})")
    report("reference float32 (jax.grad)", _jax_grads(arrs, dy, chunk))
    report("port float32 (autograd)", _port_grads(arrs, dy, chunk))
    for name in ("cumsum", "exp", "einsum", "minimum"):
        with _widened(name):
            report(f"port, torch.{name} in float64", _port_grads(arrs, dy,
                                                                 chunk))


def _tie_report():
    """ddt of the backward's formulas in chunks of 64 from ``jax.grad`` at
    the forward's chunk of 128, with a tie across row 64 (P 64, N 128): the
    clamp acting within the backward's chunks (as before ROADMAP.md
    section 3 item 31's repair) and within the forward's."""
    arrs, dy = _inputs(1, 256, 2, 64, 1, 128, zero_rows=STRADDLE_ROWS)
    want = _jax_grads(arrs, dy, 128)[1]
    rows = list(STRADDLE_ROWS)
    print("ddt from jax.grad, a tie across the backward's chunk boundary")
    for label, fwd in (("the backward's chunks", None), ("the forward's", 128)):
        got = ref.ssd_chunked_bwd_ref(*[torch.tensor(a) for a in arrs],
                                      torch.tensor(dy), chunk=64,
                                      fwd_chunk=fwd)[1]
        print(f"  clamp within {label}: on the tied rows "
              f"{_rel_l2(got[:, rows], want[:, rows]):.2e}, over all rows "
              f"{_rel_l2(got, want):.2e}")


if __name__ == "__main__":
    # the float64 witness of ROADMAP.md section 3, item 26, at the scan, and
    # item 31's tie across the backward's chunks:
    #   PYTHONPATH=src python tests/test_torch_ssd_grad.py
    _witness()
    _tie_report()
