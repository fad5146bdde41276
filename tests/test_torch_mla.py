"""The port's Multi-head Latent Attention against the JAX package's, on the
CPU.

``mla_apply`` (the decompressed prefill) and ``mla_decode`` (the absorbed
float32 decode over the latent cache) on the same seeded weights and
inputs, then DeepSeek-V2-Lite's tiny config (a first dense layer, then MLA
with MoE) carried across by ``convert.lm_from_reference``: a prefill whose
logits and latent caches agree at atol 2e-4 / rtol 2e-3, then decode steps
at atol 5e-4 / rtol 5e-3 (the tolerances of ``tests/test_torch_models.py``).
The latent is a strided slice of one projection; the norm's kernel takes
it contiguous, so the plain path here is held to the same contract.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import build_model as jbuild_model
from repro.models import mla as jmla
from repro_torch import convert
from repro_torch.kernels import ops
from repro_torch.models import mla

APPLY_TOL = dict(atol=2e-4, rtol=2e-3)
DECODE_TOL = dict(atol=5e-4, rtol=5e-3)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs():
    jcfg = jget_config("deepseek-v2-lite-16b").tiny()
    return jcfg, convert.config_from_reference(dataclasses.asdict(jcfg))


def _mixer(cfg, seed=0):
    rng = np.random.default_rng(seed)
    d, h = cfg.d_model, cfg.num_heads
    nope, rd, vd, lora = (cfg.qk_nope_head_dim, cfg.qk_rope_head_dim,
                          cfg.v_head_dim, cfg.kv_lora_rank)
    shapes = {"wq": (d, h * (nope + rd)), "w_dkv": (d, lora + rd),
              "w_uk": (lora, h * nope), "w_uv": (lora, h * vd),
              "wo": (h * vd, d)}
    p = {k: (rng.standard_normal(s) * s[0] ** -0.5).astype(np.float32)
         for k, s in shapes.items()}
    p["kv_norm"] = (1.0 + 0.1 * rng.standard_normal(lora)).astype(np.float32)
    return p


def _j(p):
    return {k: jnp.asarray(v) for k, v in p.items()}


def _t(p):
    return {k: torch.from_numpy(v) for k, v in p.items()}


def test_mla_apply_matches_the_reference(monkeypatch):
    jcfg, cfg = _cfgs()
    p = _mixer(cfg)
    B, S = 2, 12
    x = np.random.default_rng(1).standard_normal((B, S, cfg.d_model)
                                                 ).astype(np.float32)
    pos = np.broadcast_to(np.arange(S), (B, S))
    want, (jc, jr) = jmla.mla_apply(_j(p), jnp.asarray(x), jcfg,
                                    jnp.asarray(pos))
    # the card's norm kernel refuses a strided input: so does this path
    norm = ops.rmsnorm

    def contiguous_only(xx, w, **kw):
        assert xx.is_contiguous()
        return norm(xx, w, **kw)
    monkeypatch.setattr(ops, "rmsnorm", contiguous_only)
    got, (c, r) = mla.mla_apply(_t(p), torch.from_numpy(x), cfg,
                                torch.from_numpy(np.array(pos)))
    assert got.shape == (B, S, cfg.d_model)
    assert c.shape == (B, S, cfg.kv_lora_rank)
    assert r.shape == (B, S, cfg.qk_rope_head_dim)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **APPLY_TOL)
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), **APPLY_TOL)
    np.testing.assert_allclose(r.numpy(), np.asarray(jr), **APPLY_TOL)


@pytest.mark.parametrize("pos", [5, 19])
def test_mla_decode_matches_the_reference(pos):
    jcfg, cfg = _cfgs()
    p = _mixer(cfg, seed=2)
    B, S = 3, 20
    rng = np.random.default_rng(pos)
    x = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
    cc = rng.standard_normal((B, S, cfg.kv_lora_rank)).astype(np.float32)
    rc = rng.standard_normal((B, S, cfg.qk_rope_head_dim)).astype(np.float32)
    # filled slots up to pos, some empty (-1) and some ahead of pos
    slot_pos = np.where(np.arange(S) <= pos, np.arange(S), -1).astype(np.int32)
    slot_pos[2] = -1
    want = jmla.mla_decode(_j(p), jnp.asarray(x), jcfg, jnp.asarray(cc),
                           jnp.asarray(rc), jnp.asarray(slot_pos), pos)
    got = mla.mla_decode(_t(p), torch.from_numpy(x), cfg, torch.from_numpy(cc),
                         torch.from_numpy(rc), torch.from_numpy(slot_pos), pos)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **APPLY_TOL)


@pytest.mark.parametrize("S,steps,cache_len", [(16, 4, 20), (8, 6, 14)])
def test_deepseek_prefill_then_decode_matches_the_reference(S, steps,
                                                            cache_len):
    jcfg, cfg = _cfgs()
    jm = jbuild_model(jcfg)
    params = jm.init(jax.random.PRNGKey(0))
    lm = convert.lm_from_reference(jax.tree.map(np.asarray, params), cfg,
                                   device="cpu")
    assert [b.spec.mlp for b in lm.layers] == ["dense", "moe", "moe"]
    toks = np.random.default_rng(S).integers(0, cfg.vocab_size,
                                             (2, S + steps)).astype(np.int32)
    jlog, jcache = jax.jit(lambda p, t: jm.prefill(p, t, cache_len=cache_len)
                           )(params, jnp.asarray(toks[:, :S]))
    log, cache = lm.prefill(torch.from_numpy(toks[:, :S]).long(),
                            cache_len=cache_len)
    np.testing.assert_allclose(log.numpy(), np.asarray(jlog), **APPLY_TOL)
    # the first dense layer's latent cache and repeat 1's
    for got, want in ((cache["layers"][0], jcache["first"]),
                      (cache["layers"][2],
                       jax.tree.map(lambda a: a[1], jcache["blocks"]["pos0"]))):
        for key in ("c", "rope"):
            assert got[key].shape == want[key].shape
            np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                       **APPLY_TOL)
    jstep = jax.jit(jm.decode_step)
    for t in range(S, S + steps):
        jlog, jcache = jstep(params, jcache, jnp.asarray(toks[:, t:t + 1]))
        log, cache = lm.decode_step(cache, torch.from_numpy(
            toks[:, t:t + 1]).long())
        np.testing.assert_allclose(log.numpy(), np.asarray(jlog),
                                   err_msg=f"step {t}", **DECODE_TOL)
    np.testing.assert_array_equal(cache["slot_pos"].numpy(),
                                  np.asarray(jcache["slot_pos"]))
    np.testing.assert_allclose(cache["layers"][0]["c"].numpy(),
                               np.asarray(jcache["first"]["c"]), **DECODE_TOL)


def test_mla_cache_init_matches_the_reference_shapes():
    jcfg, cfg = _cfgs()
    jshapes = jax.eval_shape(lambda: jbuild_model(jcfg).cache_init(3, 24))
    lm = convert.lm_from_reference(
        jax.tree.map(np.asarray, jbuild_model(jcfg).init(jax.random.PRNGKey(0))),
        cfg, device="cpu")
    cache = lm.cache_init(3, 24)
    assert {k: v.shape for k, v in cache["layers"][0].items()} == {
        k: v.shape for k, v in jshapes["first"].items()}
    assert {k: (cfg.num_repeats, *v.shape) for k, v in
            cache["layers"][1].items()} == {
        k: v.shape for k, v in jshapes["blocks"]["pos0"].items()}
    assert cache["slot_pos"].tolist() == [-1] * 24 and cache["pos"] == 0
