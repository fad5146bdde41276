"""The port's model zoo and model serving against the JAX package, on the CPU.

* Weights carried across: ``convert.lm_from_reference`` on a JAX
  ``LM.init(PRNGKey(0))`` of a tiny config (float32). ``apply`` logits agree
  at atol 2e-4 / rtol 2e-3 (``tests/test_models.py``); a prefill followed by
  decode steps agrees step by step at atol 5e-4 / rtol 5e-3 (Qwen3's append
  rule, and h2o-danube's window-32 ring buffer, wrapped and rotated).
* The slice as a whole: two JAX ``ReplicaGroup``s and two port groups on the
  same weights, each ``PartitionedBatcher`` on ``ClusterSim([Channel(20, 2),
  Channel(14, 5)])`` with one seed (the port's balancer and sim carried
  across by ``convert``), run 5 batches of 8 prompts with ``execute=True``:
  equal counts, join latencies and greedy tokens, batch by batch.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.configs import get_config as jget_config
from repro.models import build_model as jbuild_model
from repro.serve import PartitionedBatcher as JBatcher
from repro.serve import ReplicaGroup as JGroup
from repro.serve import ServeEngine as JEngine
from repro.sim import Channel as JChannel
from repro.sim import ClusterSim as JSim
from repro_torch import convert
from repro_torch.configs import ARCHS, get_config
from repro_torch.core import partitioner
from repro_torch.models import build_model
from repro_torch.serve import PartitionedBatcher, ReplicaGroup, ServeEngine

DEV = "cpu"
APPLY_TOL = dict(atol=2e-4, rtol=2e-3)
DECODE_TOL = dict(atol=5e-4, rtol=5e-3)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(arch):
    """(JAX model, JAX params, port LM) on the same weights."""
    jcfg = jget_config(arch).tiny()
    jm = jbuild_model(jcfg)
    params = jm.init(jax.random.PRNGKey(0))
    cfg = convert.config_from_reference(dataclasses.asdict(jcfg))
    lm = convert.lm_from_reference(jax.tree.map(np.asarray, params), cfg,
                                   device=DEV)
    return jm, params, lm


def _tokens(cfg, B, S, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S)
                                                ).astype(np.int32)


def test_configs_match_the_reference():
    assert ARCHS == JARCHS
    for arch in ARCHS:
        jcfg = jget_config(arch)
        cfg = get_config(arch)
        for full, port in ((jcfg, cfg), (jcfg.tiny(), cfg.tiny())):
            d = dataclasses.asdict(full)
            for key in ("attention_impl", "ssd_impl", "remat",
                        "remat_policy"):
                d.pop(key)
            assert dataclasses.asdict(port) == d, arch
            assert port.padded_vocab == full.padded_vocab
            assert port.num_repeats == full.num_repeats
        assert convert.config_from_reference(dataclasses.asdict(jcfg)) == cfg
    q = get_config("qwen3-8b")
    assert (q.num_layers, q.d_model, q.num_heads, q.num_kv_heads, q.head_dim,
            q.d_ff, q.padded_vocab) == (36, 4096, 32, 8, 128, 12288, 152064)


def test_apply_logits_match_the_reference():
    jm, params, lm = _pair("qwen3-8b")
    tokens = _tokens(lm.cfg, 2, 16)
    want = np.asarray(jm.apply(params, jnp.asarray(tokens)))
    got = lm.apply(torch.from_numpy(tokens).long())
    assert got.shape == want.shape == (2, 16, lm.cfg.padded_vocab)
    np.testing.assert_allclose(got.numpy(), want, **APPLY_TOL)


# (arch, prompt length, decode steps, cache length): Qwen3's append rule,
# and h2o-danube's window-32 ring buffer, filled from a short prompt and
# wrapped by 40 steps, or rotated from a prompt longer than the window
DECODE_CASES = [("qwen3-8b", 16, 4, 20), ("h2o-danube-1.8b", 16, 40, 32),
                ("h2o-danube-1.8b", 40, 8, 32)]


@pytest.mark.parametrize("arch,S,steps,cache_len", DECODE_CASES)
def test_prefill_then_decode_matches_the_reference(arch, S, steps, cache_len):
    jm, params, lm = _pair(arch)
    toks = _tokens(lm.cfg, 2, S + steps, seed=1)
    jlog, jcache = jax.jit(lambda p, t: jm.prefill(p, t, cache_len=cache_len)
                           )(params, jnp.asarray(toks[:, :S]))
    log, cache = lm.prefill(torch.from_numpy(toks[:, :S]).long(),
                            cache_len=cache_len)
    np.testing.assert_allclose(log.numpy(), np.asarray(jlog), **APPLY_TOL)
    np.testing.assert_array_equal(cache["slot_pos"].numpy(),
                                  np.asarray(jcache["slot_pos"]))
    np.testing.assert_allclose(
        cache["layers"][1]["k"].numpy(),
        np.asarray(jcache["blocks"]["pos0"]["k"][1]), **APPLY_TOL)
    jstep = jax.jit(jm.decode_step)
    for t in range(S, S + steps):
        jlog, jcache = jstep(params, jcache, jnp.asarray(toks[:, t:t + 1]))
        log, cache = lm.decode_step(cache, torch.from_numpy(
            toks[:, t:t + 1]).long())
        np.testing.assert_allclose(log.numpy(), np.asarray(jlog),
                                   err_msg=f"step {t}", **DECODE_TOL)
    assert cache["pos"] == int(jcache["pos"])
    np.testing.assert_array_equal(cache["slot_pos"].numpy(),
                                  np.asarray(jcache["slot_pos"]))


def test_partitioned_batcher_matches_the_reference(monkeypatch):
    jm, params, lm = _pair("qwen3-8b")
    jeng = JEngine(jm, jm.cfg)
    jgroups = [JGroup("fast", jeng, params), JGroup("slow", jeng, params)]
    jsim = JSim([JChannel(mu=20.0, sigma=2.0), JChannel(mu=14.0, sigma=5.0)],
                seed=5)
    jb = JBatcher(jgroups, sim=jsim)
    # the reference draws its two PGD restarts from PRNGKey(0) every solve;
    # the port's solver takes the same rows here
    starts = np.asarray(jax.random.dirichlet(jax.random.PRNGKey(0),
                                             jnp.ones((2,)), (2,)))
    monkeypatch.setattr(partitioner, "_dirichlet_starts",
                        lambda k, restarts, rng: starts)
    eng = ServeEngine(lm, lm.cfg, device=DEV)
    pb = PartitionedBatcher([ReplicaGroup("fast", eng),
                             ReplicaGroup("slow", eng)],
                            sim=convert.sim_from_reference(jsim.state_dict()),
                            device=DEV)
    pb.balancer = convert.balancer_from_reference(jb.balancer.state_dict(),
                                                  device=DEV)
    rng = np.random.default_rng(7)
    splits = set()
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
        splits.add(tuple(c.tolist()))
    assert len(splits) > 1   # the balancer moved the split
    sd = pb.state_dict()
    assert sd.keys() == jb.state_dict().keys()
    again = PartitionedBatcher.from_state_dict(sd, pb.groups, device=DEV)
    np.testing.assert_array_equal(again.split(64), pb.split(64))


def test_generate_is_deterministic_and_matches_its_steps():
    cfg = get_config("qwen3-8b").tiny()
    lm = build_model(cfg, device=DEV, seed=3)
    eng = ServeEngine(lm, cfg, device=DEV)
    prompts = _tokens(cfg, 3, 16, seed=2)
    a, b = eng.generate(prompts, 6), eng.generate(torch.from_numpy(prompts),
                                                  6)
    assert a.shape == (3, 6) and a.dtype == torch.int64
    assert torch.equal(a, b)
    assert int(a.max()) < cfg.vocab_size
    # greedy: each token is the argmax of a full forward over what precedes
    seq = torch.cat([torch.from_numpy(prompts).long(), a], dim=1)
    logits = lm.apply(seq[:, :-1])[:, 15:, :cfg.vocab_size]
    assert torch.equal(logits.argmax(-1), a)


def test_unported_mixers_and_wrappers_raise():
    for arch in ("deepseek-v2-lite-16b", "qwen3-moe-235b-a22b",
                 "jamba-1.5-large-398b"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            build_model(get_config(arch).tiny(), device=DEV)
    for arch in ("whisper-large-v3", "internvl2-76b"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            build_model(get_config(arch).tiny(), device=DEV)


@pytest.mark.parametrize("act", ["swiglu", "relu2", "gelu"])
def test_mlp_activations_match_the_reference(act):
    from repro.models.layers import mlp_apply as jmlp_apply
    from repro_torch.models.layers import mlp_apply
    rng = np.random.default_rng(4)
    p = {k: rng.standard_normal(s).astype(np.float32) * 0.2
         for k, s in (("w_up", (16, 32)), ("w_gate", (16, 32)),
                      ("w_down", (32, 16)))}
    x = rng.standard_normal((3, 5, 16)).astype(np.float32)
    want = jmlp_apply({k: jnp.asarray(v) for k, v in p.items()},
                      jnp.asarray(x), act)
    got = mlp_apply({k: torch.from_numpy(v) for k, v in p.items()},
                    torch.from_numpy(x), act)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **APPLY_TOL)
