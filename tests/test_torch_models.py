"""The port's model zoo and model serving against the JAX package, on the CPU.

* Weights carried across: ``convert.lm_from_reference`` on a JAX
  ``LM.init(PRNGKey(0))`` of a tiny config (float32). ``apply`` logits agree
  at atol 2e-4 / rtol 2e-3 (``tests/test_models.py``); a prefill followed by
  decode steps agrees step by step at atol 5e-4 / rtol 5e-3 (Qwen3's append
  rule, h2o-danube's window-32 ring buffer, wrapped and rotated, and the
  MoE and MLA stacks: DeepSeek-V2-Lite, Qwen3-MoE, Jamba's hybrid).
* The slice as a whole: two JAX ``ReplicaGroup``s and two port groups on the
  same weights, each ``PartitionedBatcher`` on ``ClusterSim([Channel(20, 2),
  Channel(14, 5)])`` with one seed (the port's balancer and sim carried
  across by ``convert``), run 5 batches of 8 prompts with ``execute=True``:
  equal counts, join latencies and greedy tokens, batch by batch (Qwen3-8B,
  and DeepSeek-V2-Lite for the MoE and MLA slice).
* Every one of the ten archs builds on the CPU and runs a prefill.
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
            for key in ("attention_impl", "ssd_impl"):
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
# wrapped by 40 steps, or rotated from a prompt longer than the window;
# DeepSeek-V2-Lite (a first dense layer, MLA, MoE with a shared expert),
# Qwen3-MoE (GQA with qk_norm, MoE) and Jamba (mamba, attention, MoE)
DECODE_CASES = [("qwen3-8b", 16, 4, 20), ("h2o-danube-1.8b", 16, 40, 32),
                ("h2o-danube-1.8b", 40, 8, 32),
                ("deepseek-v2-lite-16b", 16, 4, 20),
                ("qwen3-moe-235b-a22b", 16, 4, 20),
                ("jamba-1.5-large-398b", 16, 4, 20)]


# Jamba's 14 tiny mamba layers compound the chunked scan's float32 rounding
# against XLA's (ROADMAP §3 items 5 and 12): the hybrid's prefill is held
# at the decode tolerance (relative L2 2.3e-5, its worst logit 3.1e-4 from
# the reference's on the CPU)
PREFILL_TOL = {"jamba-1.5-large-398b": DECODE_TOL}


def _repeat_one(cache, jcache, cfg):
    """(port, reference) cache entries of repeat 1 of pattern position 0."""
    off = 1 if cfg.first_layer_dense else 0
    return (cache["layers"][off + cfg.pattern_len],
            jax.tree.map(lambda a: a[1], jcache["blocks"]["pos0"]))


@pytest.mark.parametrize("arch,S,steps,cache_len", DECODE_CASES)
def test_prefill_then_decode_matches_the_reference(arch, S, steps, cache_len):
    jm, params, lm = _pair(arch)
    toks = _tokens(lm.cfg, 2, S + steps, seed=1)
    jlog, jcache = jax.jit(lambda p, t: jm.prefill(p, t, cache_len=cache_len)
                           )(params, jnp.asarray(toks[:, :S]))
    log, cache = lm.prefill(torch.from_numpy(toks[:, :S]).long(),
                            cache_len=cache_len)
    tol = PREFILL_TOL.get(arch, APPLY_TOL)
    np.testing.assert_allclose(log.numpy(), np.asarray(jlog), **tol)
    np.testing.assert_array_equal(cache["slot_pos"].numpy(),
                                  np.asarray(jcache["slot_pos"]))
    got, want = _repeat_one(cache, jcache, lm.cfg)
    assert got.keys() == want.keys()
    for key in got:
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   **tol)
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
    _batcher_against_the_reference(monkeypatch, "qwen3-8b")


def test_partitioned_batcher_serves_moe_and_mla_as_the_reference(
        monkeypatch):
    _batcher_against_the_reference(monkeypatch, "deepseek-v2-lite-16b")


def _batcher_against_the_reference(monkeypatch, arch):
    jm, params, lm = _pair(arch)
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


@pytest.mark.parametrize("arch", ARCHS)
def test_every_arch_builds_and_prefills(arch):
    cfg = get_config(arch).tiny()
    model = build_model(cfg, device=DEV, seed=0)
    tokens = torch.from_numpy(_tokens(cfg, 2, 8)).long()
    rng = np.random.default_rng(0)
    extra = ()
    n = cfg.encoder_seq or cfg.num_patches
    if n:
        extra = (torch.from_numpy(rng.standard_normal(
            (2, n, cfg.d_model)).astype(np.float32)),)
    S = 8 + cfg.num_patches
    logits, cache = model.prefill(tokens, *extra, cache_len=S + 2)
    assert logits.shape == (2, S, cfg.padded_vocab)
    assert bool(torch.isfinite(logits).all())
    assert cache["pos"] == S
    logits, cache = model.decode_step(cache, tokens[:, :1])
    assert logits.shape == (2, 1, cfg.padded_vocab) and cache["pos"] == S + 1


def test_serve_cli_serves_moe_and_mla_and_refuses_the_wrappers(capsys):
    from repro_torch.launch import serve as cli
    cli.main(["--arch", "deepseek-v2-lite-16b", "--tiny", "--device", "cpu",
              "--execute", "--batches", "3"])
    out = capsys.readouterr().out
    assert "tokens/s" in out and "batch   0 split=" in out
    for arch, what in (("whisper-large-v3", "frames"),
                       ("internvl2-76b", "patches")):
        with pytest.raises(ValueError, match=what):
            cli.main(["--arch", arch, "--tiny", "--device", "cpu",
                      "--execute", "--batches", "1"])


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
