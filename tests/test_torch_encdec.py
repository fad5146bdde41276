"""The port's encoder-decoder (Whisper) and VLM (InternVL2) wrappers
against the JAX package's, on the CPU.

Tiny configs with the reference's ``init(PRNGKey(0))`` weights carried
across (``convert.encdec_from_reference``, ``vlm_from_reference``) and
seeded numpy frames and patches: ``encode`` and ``apply`` at atol 2e-4 /
rtol 2e-3, a prefill (logits, self and cross caches) and then decode steps
at atol 5e-4 / rtol 5e-3 step by step. Float32 frames in a bf16 Whisper
promote the encoder to float32, as the reference's
``frames.astype(act) + sinusoid(F, d, frames.dtype)`` does: with the same
bf16 weights both encoders compute in float32 and agree at atol 2e-4 /
rtol 2e-3.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import build_model as jbuild_model
from repro.models.whisper import sinusoid as jsinusoid
from repro_torch import convert
from repro_torch.models import EncDec, VLM, build_model
from repro_torch.models.whisper import sinusoid

APPLY_TOL = dict(atol=2e-4, rtol=2e-3)
DECODE_TOL = dict(atol=5e-4, rtol=5e-3)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(arch, **overrides):
    jcfg = jget_config(arch).tiny().replace(**overrides)
    jm = jbuild_model(jcfg)
    params = jm.init(jax.random.PRNGKey(0))
    cfg = convert.config_from_reference(dataclasses.asdict(jcfg))
    np_params = jax.tree.map(np.asarray, params)
    if cfg.is_encoder_decoder:
        return jm, params, convert.encdec_from_reference(np_params, cfg,
                                                         device="cpu")
    return jm, params, convert.vlm_from_reference(np_params, cfg,
                                                  device="cpu")


def _inputs(cfg, B, S, seed):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    n = cfg.encoder_seq or cfg.num_patches
    extra = rng.standard_normal((B, n, cfg.d_model)).astype(np.float32)
    return toks, extra


def _t(a):
    return torch.from_numpy(np.array(a))


def test_sinusoid_matches_the_reference():
    for S, d in ((24, 64), (1500, 1280)):
        np.testing.assert_allclose(sinusoid(S, d, torch.float32).numpy(),
                                   np.asarray(jsinusoid(S, d, jnp.float32)),
                                   atol=2e-4, rtol=0)
    # a row taken at an offset is that row of the table
    assert torch.equal(sinusoid(1, 64, torch.float32, start=17),
                       sinusoid(24, 64, torch.float32)[17:18])


def test_whisper_encode_and_apply_match_the_reference():
    jm, params, m = _pair("whisper-large-v3")
    assert isinstance(m, EncDec)
    toks, frames = _inputs(m.cfg, 2, 12, seed=0)
    np.testing.assert_allclose(
        m.encode(_t(frames)).numpy(),
        np.asarray(jm.encode(params, jnp.asarray(frames))), **APPLY_TOL)
    want = jax.jit(jm.apply)(params, jnp.asarray(toks), jnp.asarray(frames))
    got = m.apply(_t(toks).long(), _t(frames))
    assert got.shape == want.shape == (2, 12, m.cfg.padded_vocab)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **APPLY_TOL)


@pytest.mark.parametrize("S,steps,cache_len", [(12, 6, 18), (16, 6, 20)])
def test_whisper_prefill_then_decode_matches_the_reference(S, steps,
                                                           cache_len):
    jm, params, m = _pair("whisper-large-v3")
    toks, frames = _inputs(m.cfg, 2, S + steps, seed=S)
    jlog, jcache = jax.jit(lambda p, t, f: jm.prefill(
        p, t, f, cache_len=cache_len))(params, jnp.asarray(toks[:, :S]),
                                       jnp.asarray(frames))
    log, cache = m.prefill(_t(toks[:, :S]).long(), _t(frames),
                           cache_len=cache_len)
    np.testing.assert_allclose(log.numpy(), np.asarray(jlog), **APPLY_TOL)
    for key in ("k", "v", "xk", "xv"):
        np.testing.assert_allclose(cache["layers"][1][key].numpy(),
                                   np.asarray(jcache[key][1]), **APPLY_TOL)
    jstep = jax.jit(jm.decode_step)
    for t in range(S, S + steps):
        jlog, jcache = jstep(params, jcache, jnp.asarray(toks[:, t:t + 1]))
        log, cache = m.decode_step(cache, _t(toks[:, t:t + 1]).long())
        np.testing.assert_allclose(log.numpy(), np.asarray(jlog),
                                   err_msg=f"step {t}", **DECODE_TOL)
    assert cache["pos"] == int(jcache["pos"])
    np.testing.assert_array_equal(cache["slot_pos"].numpy(),
                                  np.asarray(jcache["slot_pos"]))


def test_whisper_cache_init_matches_the_reference_shapes():
    jm, _, m = _pair("whisper-large-v3")
    want = jax.eval_shape(lambda: jm.cache_init(2, 20, m.cfg.encoder_seq))
    cache = m.cache_init(2, 20, m.cfg.encoder_seq)
    assert len(cache["layers"]) == m.cfg.num_layers
    for key in ("k", "v", "xk", "xv"):
        assert (m.cfg.num_layers, *cache["layers"][0][key].shape) == \
            want[key].shape


def test_float32_frames_promote_a_bf16_encoder():
    jm, params, m = _pair("whisper-large-v3", param_dtype="bfloat16",
                          activation_dtype="bfloat16")
    assert m.enc_blocks[0].mixer["wq"].dtype == torch.bfloat16
    _, frames = _inputs(m.cfg, 2, 4, seed=3)
    got = m.encode(_t(frames))
    want = jm.encode(params, jnp.asarray(frames))
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **APPLY_TOL)
    # bf16 frames keep the encoder in bf16
    assert m.encode(_t(frames).to(torch.bfloat16)).dtype == torch.bfloat16


def test_vlm_apply_matches_the_reference():
    jm, params, m = _pair("internvl2-76b")
    assert isinstance(m, VLM)
    toks, patches = _inputs(m.cfg, 2, 10, seed=4)
    want = jax.jit(jm.apply)(params, jnp.asarray(toks), jnp.asarray(patches))
    got = m.apply(_t(toks).long(), _t(patches))
    assert got.shape == want.shape == (2, 10 + m.cfg.num_patches,
                                       m.cfg.padded_vocab)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **APPLY_TOL)


def test_vlm_prefill_then_decode_matches_the_reference():
    jm, params, m = _pair("internvl2-76b")
    S, steps = 12, 5
    cache_len = m.cfg.num_patches + S + steps
    toks, patches = _inputs(m.cfg, 2, S + steps, seed=5)
    jlog, jcache = jax.jit(lambda p, t, x: jm.prefill(
        p, t, x, cache_len=cache_len))(params, jnp.asarray(toks[:, :S]),
                                       jnp.asarray(patches))
    log, cache = m.prefill(_t(toks[:, :S]).long(), _t(patches),
                           cache_len=cache_len)
    np.testing.assert_allclose(log.numpy(), np.asarray(jlog), **APPLY_TOL)
    assert cache["pos"] == m.cfg.num_patches + S
    jstep = jax.jit(jm.decode_step)
    for t in range(S, S + steps):
        jlog, jcache = jstep(params, jcache, jnp.asarray(toks[:, t:t + 1]))
        log, cache = m.decode_step(cache, _t(toks[:, t:t + 1]).long())
        np.testing.assert_allclose(log.numpy(), np.asarray(jlog),
                                   err_msg=f"step {t}", **DECODE_TOL)
    np.testing.assert_array_equal(cache["slot_pos"].numpy(),
                                  np.asarray(jcache["slot_pos"]))


def test_build_model_picks_the_wrapper():
    for arch, kind in (("whisper-large-v3", EncDec), ("internvl2-76b", VLM)):
        from repro_torch.configs import get_config
        m = build_model(get_config(arch).tiny(), device="cpu", seed=1)
        assert isinstance(m, kind) and m.device.type == "cpu"
