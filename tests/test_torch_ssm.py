"""The port's Mamba2 slice against the JAX package, on the CPU.

* The scan: ``ops.ssd`` (the plain chunked version on CPU tensors, walked
  in the kernel's groups of chunks) against the JAX Pallas ``ssd_scan`` in
  interpret mode on the shapes of ``tests/test_kernels.py`` and a
  six-group shape (atol = rtol = 5e-4 in float32, 0.05 in bf16), against
  the JAX XLA chunked path with its final state, at S = 256 and a ragged
  S = 200 with chunk 64 and at a ragged S = 300 in 1, 2, 3, 5 and 10 groups
  (atol 5e-5 / rtol 5e-4), and against the sequential oracles of both
  packages. The group split (``autotune.ssd_groups``) is a function of the
  shape alone. The wrapper's rules raise on the CPU as on the card.
* The mixer: ``mamba_apply`` (with and without its prefill states) and
  ``mamba_decode`` on carried weights, at S = 2 (shorter than the conv
  width - 1) and S = 24 (ragged against the tiny chunk of 16).
* The model: tiny ``mamba2-2.7b`` in float32 with weights carried by
  ``convert.lm_from_reference``: ``apply`` logits at atol 2e-4 / rtol 2e-3,
  ``prefill`` then decode steps against JAX at atol 5e-4 / rtol 5e-3, and
  token-by-token decode against the teacher-forced forward.
* The slice as a whole: tiny Mamba2 behind two JAX and two port replica
  groups on one seed, 5 batches: equal counts, join latencies and tokens.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.ssd_scan import ssd_scan as jssd_scan
from repro.models import build_model as jbuild_model
from repro.models import ssm as jssm
from repro.serve import PartitionedBatcher as JBatcher
from repro.serve import ReplicaGroup as JGroup
from repro.serve import ServeEngine as JEngine
from repro.sim import Channel as JChannel
from repro.sim import ClusterSim as JSim
from repro_torch import convert
from repro_torch.core import partitioner
from repro_torch.kernels import autotune, ops, ref
from repro_torch.models import ssm
from repro_torch.serve import PartitionedBatcher, ReplicaGroup, ServeEngine

DEV = "cpu"
KERNEL_TOL = {"float32": 5e-4, "bfloat16": 0.05}
XLA_TOL = dict(atol=5e-5, rtol=5e-4)
APPLY_TOL = dict(atol=2e-4, rtol=2e-3)
DECODE_TOL = dict(atol=5e-4, rtol=5e-3)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(seed, B, S, H, P, G, N):
    """Seeded numpy inputs of the scan, as ``tests/test_kernels.py`` draws
    them: dt = softplus(normal) / 2, A = -exp(0.3 normal), D = 0.5."""
    rng = np.random.default_rng(seed)
    f = np.float32
    x = rng.standard_normal((B, S, H, P)).astype(f)
    dt = (np.logaddexp(rng.standard_normal((B, S, H)), 0.0) * 0.5).astype(f)
    A = (-np.exp(rng.standard_normal(H) * 0.3)).astype(f)
    Bm = (rng.standard_normal((B, S, G, N)) * 0.3).astype(f)
    Cm = (rng.standard_normal((B, S, G, N)) * 0.3).astype(f)
    D = np.full(H, 0.5, f)
    return x, dt, A, Bm, Cm, D


def _both(arrays, dtype):
    """(JAX, torch) copies; x, Bm and Cm (0, 3, 4) in ``dtype``."""
    jd = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    td = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    j = [jnp.asarray(a).astype(jd) if i in (0, 3, 4) else jnp.asarray(a)
         for i, a in enumerate(arrays)]
    t = [torch.from_numpy(a).to(td) if i in (0, 3, 4) else torch.from_numpy(a)
         for i, a in enumerate(arrays)]
    return j, t


def _f32(a):
    return np.asarray(a.float() if isinstance(a, torch.Tensor)
                      else jnp.asarray(a, jnp.float32))


# (B, S, H, P, G, N, chunk): tests/test_kernels.py::test_ssd_scan_sweep,
# then six chunks in six groups
PALLAS_SHAPES = [(1, 128, 2, 16, 1, 32, 64), (2, 256, 4, 32, 2, 64, 128),
                 (1, 64, 2, 16, 1, 32, 64), (1, 128, 4, 8, 1, 16, 32),
                 (1, 192, 2, 16, 1, 32, 32)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", PALLAS_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_ssd_matches_pallas_interpret(shape, dtype):
    *dims, chunk = shape
    j, t = _both(_inputs(0, *dims), dtype)
    want = jssd_scan(*j, chunk=chunk, interpret=True)
    got = ops.ssd(*t, chunk=chunk)
    assert got.dtype == t[0].dtype and got.shape == t[0].shape
    tol = KERNEL_TOL[dtype]
    np.testing.assert_allclose(_f32(got), _f32(want), atol=tol, rtol=tol)


@pytest.mark.parametrize("S", [256, 200])
def test_ssd_final_state_matches_the_xla_path(S):
    j, t = _both(_inputs(1, 1, S, 2, 16, 1, 32), "float32")
    jy, jstate = jops.ssd(*j, impl="xla", chunk=64, return_final_state=True)
    y, state = ops.ssd(*t, chunk=64, return_final_state=True)
    assert state.shape == (1, 2, 16, 32) and state.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **XLA_TOL)
    np.testing.assert_allclose(state.numpy(), np.asarray(jstate), **XLA_TOL)
    # without the state, y is the same
    assert torch.equal(ops.ssd(*t, chunk=64), y)


@pytest.mark.parametrize("shape", [(1, 256, 2, 16, 1, 32, 64),
                                   (2, 75, 4, 8, 2, 16, 32),
                                   (1, 5, 2, 8, 1, 16, 128)],
                         ids=lambda s: "x".join(map(str, s)))
def test_ssd_matches_the_sequential_oracles(shape):
    *dims, chunk = shape
    j, t = _both(_inputs(2, *dims), "float32")
    seq = ref.ssd_scan_ref(*t)
    np.testing.assert_allclose(seq.numpy(), np.asarray(jref.ssd_scan_ref(*j)),
                               **XLA_TOL)
    y, state = ops.ssd(*t, chunk=chunk, return_final_state=True)
    np.testing.assert_allclose(y.numpy(), seq.numpy(), **XLA_TOL)
    # the state carried across chunks equals the one-chunk decomposition's
    _, whole = ref.ssd_chunked_ref(*t, chunk=dims[1],
                                   return_final_state=True)
    np.testing.assert_allclose(state.numpy(), whole.numpy(), **XLA_TOL)


@pytest.mark.parametrize("groups", [1, 2, 3, 5, 10])
def test_ssd_group_split_matches_the_xla_path(groups):
    # ten chunks of 32, the last ragged (S = 300), cut into 1, 2, 3 (of 4,
    # 4 and 2), 5 and 10 groups: each group's end state from zero, the
    # incoming states in group order, y restarted from them
    j, t = _both(_inputs(5, 2, 300, 2, 16, 1, 32), "float32")
    jy, jstate = jops.ssd(*j, impl="xla", chunk=32, return_final_state=True)
    y, state = ref.ssd_chunked_ref(*t, chunk=32, return_final_state=True,
                                   groups=groups)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **XLA_TOL)
    np.testing.assert_allclose(state.numpy(), np.asarray(jstate), **XLA_TOL)
    # the wrapper walks the shape's own split: at B * H = 4 every chunk is
    # its own group
    assert autotune.ssd_groups(2, 2, 300, 32).groups == 10
    got = ops.ssd(*t, chunk=32, return_final_state=True)
    assert torch.equal(got[0], ref.ssd_chunked_ref(*t, chunk=32,
                                                   groups=10))
    np.testing.assert_allclose(got[1].numpy(), state.numpy(), **XLA_TOL)


def test_ssd_group_split_depends_on_the_shape_alone():
    # Mamba2-2.7B (H = 80, chunk 128): the serving path's prompts are one
    # group of one chunk, prefill_32k at B = 8 one group (640 sequences
    # fill the card), long_500k at B = 1 eight groups of 512 chunks
    assert autotune.ssd_groups(32, 80, 16, 128) == (16, 1, 1, 1)
    assert autotune.ssd_groups(8, 80, 32768, 128) == (128, 256, 256, 1)
    assert autotune.ssd_groups(1, 80, 524288, 128) == (128, 4096, 512, 8)
    for B in range(1, 40):
        for S in (1, 100, 1000, 5000):
            a = autotune.ssd_groups(B, 80, S, 128)
            assert a == autotune.ssd_groups(B, 80, S, 128)
            L, nc, per, ng = a
            # every chunk in one group, no group empty, enough blocks
            assert (ng - 1) * per < nc <= ng * per and L == min(128, S)
            assert B * 80 * ng >= min(autotune.SSD_MIN_BLOCKS, B * 80 * nc)
    # the last group may hold fewer chunks: 65 chunks in 33 groups of 2
    assert autotune.ssd_groups(2, 8, 1030, 16) == (16, 65, 2, 33)


def _rule_cases():
    x, dt, A, Bm, Cm, D = (torch.from_numpy(a) for a in
                           _inputs(3, 1, 8, 4, 8, 1, 16))
    bc = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (1, 8, 3 * 16)).astype(np.float32))
    return {
        "H % G": (x, dt, A, torch.cat([Bm] * 3, 2), torch.cat([Cm] * 3, 2),
                  D),
        "dtype": (x.bfloat16(), dt, A, Bm, Cm, D),
        "dt dtype": (x, dt.double(), A, Bm, Cm, D),
        "last stride": (x, dt, A, bc[..., ::3].reshape(1, 8, 1, 16), Cm, D),
        "device": (x, dt, A.to("meta"), Bm, Cm, D),
    }


@pytest.mark.parametrize("case", ["H % G", "dtype", "dt dtype",
                                  "last stride", "device"])
def test_ssd_rules_raise(case):
    with pytest.raises((ValueError, TypeError)):
        ops.ssd(*_rule_cases()[case], chunk=4)


def test_ssd_takes_the_mixer_strided_b_c_views():
    x, dt, A, _, _, D = (torch.from_numpy(a) for a in
                         _inputs(5, 2, 24, 4, 8, 2, 16))
    bc = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (2, 24, 2 * 2 * 16)).astype(np.float32))
    Bm = bc[..., :32].reshape(2, 24, 2, 16)
    Cm = bc[..., 32:].reshape(2, 24, 2, 16)
    assert not Bm.is_contiguous() and Bm.stride() == (24 * 64, 64, 16, 1)
    got = ops.ssd(x, dt, A, Bm, Cm, D, chunk=16)
    want = ops.ssd(x, dt, A, Bm.contiguous(), Cm.contiguous(), D, chunk=16)
    assert torch.equal(got, want)


# ---------------------------------------------------------------- the mixer
def _mixer(seed=0):
    jcfg = jget_config("mamba2-2.7b").tiny()
    cfg = convert.config_from_reference(dataclasses.asdict(jcfg))
    jp = jssm.mamba_init(jax.random.PRNGKey(seed), jcfg)
    # dt_bias and D away from their init, so that the test reads them
    rng = np.random.default_rng(seed)
    jp["dt_bias"] = jnp.asarray(rng.uniform(-1, 1, cfg.ssm_heads), jnp.float32)
    jp["D"] = jnp.asarray(rng.uniform(0, 2, cfg.ssm_heads), jnp.float32)
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    return jcfg, cfg, jp, tp


@pytest.mark.parametrize("return_state", [False, True])
@pytest.mark.parametrize("S", [2, 24])
def test_mamba_apply_matches_the_reference(S, return_state):
    jcfg, cfg, jp, tp = _mixer()
    x = np.random.default_rng(S).standard_normal((2, S, cfg.d_model)
                                                 ).astype(np.float32)
    want = jssm.mamba_apply(jp, jnp.asarray(x), jcfg,
                            return_state=return_state)
    got = ssm.mamba_apply(tp, torch.from_numpy(x), cfg,
                          return_state=return_state)
    if not return_state:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **APPLY_TOL)
        return
    (y, (s, c)), (jy, (js, jc)) = got, want
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **APPLY_TOL)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), **APPLY_TOL)
    assert c.shape == (2, cfg.ssm_conv_width - 1, cfg.ssm_inner)
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), **APPLY_TOL)


def test_mamba_decode_matches_the_reference():
    jcfg, cfg, jp, tp = _mixer(1)
    rng = np.random.default_rng(9)
    x0 = rng.standard_normal((3, 5, cfg.d_model)).astype(np.float32)
    _, (js, jc) = jssm.mamba_apply(jp, jnp.asarray(x0), jcfg,
                                   return_state=True)
    s = torch.from_numpy(np.array(js))
    c = torch.from_numpy(np.array(jc))
    for step in range(3):
        xt = rng.standard_normal((3, 1, cfg.d_model)).astype(np.float32)
        jy, (js, jc) = jssm.mamba_decode(jp, jnp.asarray(xt), jcfg, js, jc)
        y, (s2, c2) = ssm.mamba_decode(tp, torch.from_numpy(xt), cfg, s, c)
        assert s2 is s and c2 is c   # updated in place
        np.testing.assert_allclose(y.numpy(), np.asarray(jy),
                                   err_msg=f"step {step}", **DECODE_TOL)
        np.testing.assert_allclose(s.numpy(), np.asarray(js), **DECODE_TOL)
        np.testing.assert_allclose(c.numpy(), np.asarray(jc), **DECODE_TOL)


# ---------------------------------------------------------------- the model
def _pair(seed=0, **overrides):
    jcfg = jget_config("mamba2-2.7b").tiny().replace(**overrides)
    jm = jbuild_model(jcfg)
    params = jm.init(jax.random.PRNGKey(seed))
    cfg = convert.config_from_reference(dataclasses.asdict(jcfg))
    lm = convert.lm_from_reference(jax.tree.map(np.asarray, params), cfg,
                                   device=DEV)
    return jm, params, lm


def _tokens(cfg, B, S, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S)
                                                ).astype(np.int32)


def test_mamba2_apply_logits_match_the_reference():
    jm, params, lm = _pair()
    assert [b.spec.mixer for b in lm.layers] == ["mamba"] * 2
    tokens = _tokens(lm.cfg, 2, 40)   # chunks of 16: 16 + 16 + 8
    want = np.asarray(jm.apply(params, jnp.asarray(tokens)))
    got = lm.apply(torch.from_numpy(tokens).long())
    assert got.shape == want.shape == (2, 40, lm.cfg.padded_vocab)
    np.testing.assert_allclose(got.numpy(), want, **APPLY_TOL)


@pytest.mark.parametrize("S,steps", [(20, 6), (3, 4)])
def test_mamba2_prefill_then_decode_matches_the_reference(S, steps):
    jm, params, lm = _pair()
    toks = _tokens(lm.cfg, 2, S + steps, seed=1)
    jlog, jcache = jax.jit(lambda p, t: jm.prefill(p, t))(
        params, jnp.asarray(toks[:, :S]))
    log, cache = lm.prefill(torch.from_numpy(toks[:, :S]).long())
    np.testing.assert_allclose(log.numpy(), np.asarray(jlog), **APPLY_TOL)
    for r, layer in enumerate(cache["layers"]):
        for key in ("ssm", "conv"):
            np.testing.assert_allclose(
                layer[key].numpy(),
                np.asarray(jcache["blocks"]["pos0"][key][r]), **APPLY_TOL)
    assert cache["layers"][0]["ssm"].dtype == torch.float32
    jstep = jax.jit(jm.decode_step)
    for t in range(S, S + steps):
        jlog, jcache = jstep(params, jcache, jnp.asarray(toks[:, t:t + 1]))
        log, cache = lm.decode_step(cache, torch.from_numpy(
            toks[:, t:t + 1]).long())
        np.testing.assert_allclose(log.numpy(), np.asarray(jlog),
                                   err_msg=f"step {t}", **DECODE_TOL)
    assert cache["pos"] == int(jcache["pos"]) == S + steps


def test_mamba2_decode_matches_the_full_forward():
    """Token-by-token decode from an empty cache == the teacher-forced
    forward (``tests/test_models.py::test_decode_matches_full_forward``)."""
    _, _, lm = _pair(2)
    B, S = 2, 24
    tokens = torch.from_numpy(_tokens(lm.cfg, B, S, seed=3)).long()
    full = lm.apply(tokens)
    cache = lm.cache_init(B, S)
    assert cache["layers"][0]["ssm"].shape == (B, lm.cfg.ssm_heads,
                                               lm.cfg.ssm_head_dim,
                                               lm.cfg.ssm_state)
    outs = []
    for t in range(S):
        lg, cache = lm.decode_step(cache, tokens[:, t:t + 1])
        outs.append(lg[:, 0])
    np.testing.assert_allclose(torch.stack(outs, 1).numpy(), full.numpy(),
                               atol=5e-4, rtol=5e-3)


def test_bf16_mamba2_keeps_its_float32_leaves_bit_exact():
    _, params, lm = _pair(0, param_dtype="bfloat16",
                          activation_dtype="bfloat16")
    mixer = lm.layers[1].mixer
    for name in ("A_log", "dt_bias", "D"):
        want = np.asarray(params["blocks"]["pos0"]["mixer"][name][1])
        assert want.dtype == np.float32
        assert mixer[name].dtype == torch.float32
        np.testing.assert_array_equal(mixer[name].numpy(), want)
    assert mixer["w_in_x"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        mixer["conv"].float().numpy(),
        np.asarray(params["blocks"]["pos0"]["mixer"]["conv"][1], np.float32))
    tokens = torch.from_numpy(_tokens(lm.cfg, 2, 20)).long()
    logits = lm.apply(tokens)
    assert logits.dtype == torch.bfloat16 and bool(torch.isfinite(
        logits.float()).all())


def test_partitioned_batcher_serves_mamba2_as_the_reference(monkeypatch):
    jm, params, lm = _pair()
    jeng = JEngine(jm, jm.cfg)
    jb = JBatcher([JGroup("fast", jeng, params), JGroup("slow", jeng, params)],
                  sim=JSim([JChannel(mu=20.0, sigma=2.0),
                            JChannel(mu=14.0, sigma=5.0)], seed=5))
    # the reference draws its two PGD restarts from PRNGKey(0) every solve;
    # the port's solver takes the same rows here
    starts = np.asarray(jax.random.dirichlet(jax.random.PRNGKey(0),
                                             jnp.ones((2,)), (2,)))
    monkeypatch.setattr(partitioner, "_dirichlet_starts",
                        lambda k, restarts, rng: starts)
    eng = ServeEngine(lm, lm.cfg, device=DEV)
    sim = convert.sim_from_reference(jb.sim.state_dict())
    pb = PartitionedBatcher([ReplicaGroup("fast", eng),
                             ReplicaGroup("slow", eng)], sim=sim, device=DEV)
    pb.balancer = convert.balancer_from_reference(jb.balancer.state_dict(),
                                                  device=DEV)
    rng = np.random.default_rng(7)
    for batch in range(5):
        prompts = rng.integers(0, lm.cfg.vocab_size, (8, 16)).astype(np.int32)
        jt, jc, jr = jb.run_batch(prompts, max_new=4, execute=True)
        t, c, r = pb.run_batch(prompts, max_new=4, execute=True)
        np.testing.assert_array_equal(c, jc, err_msg=f"batch {batch}")
        assert t == jt, batch
        for got, want in zip(r, jr):
            assert (got is None) == (want is None)
            if got is not None:
                np.testing.assert_array_equal(got, np.asarray(want))
