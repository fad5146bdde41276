"""The port's MoE block against the JAX package's, on the CPU.

The reference's one-shard body ``repro.models.moe._local_moe`` (``tp=1``)
runs eagerly here, and its routing intermediates are read as it computes
them: the router probabilities (``jax.nn.softmax``), the top-k
(``jax.lax.top_k``), the stable sort of the copies (``jnp.argsort``) and
the keep mask, slots and sorted weights (its ``jnp.where`` calls), each
recorded from calls made in ``repro/models/moe.py`` and passed through
unchanged. The port's :func:`route` on those probabilities must give the
same experts, weights, order, keep mask and slots bit for bit; the port's
whole path from x (its own float32 logits, which differ from XLA's by
ulps) the same discrete decisions; and ``moe_apply`` agrees at atol 2e-4 /
rtol 2e-3 (``tests/test_models.py``'s tolerance). Cases: DeepSeek-V2-Lite's
tiny config (4 experts, top-2, one shared expert) and without the shared
expert, 8 experts top-6, a skewed router whose capacity drops copies, and
a router with exact ties.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import moe as jmoe
from repro_torch import convert
from repro_torch.models import moe

TOL = dict(atol=2e-4, rtol=2e-3)
# the port's float32 router probabilities (and weights) against XLA's: the
# logits differ by ulps of the summation order
PROB_TOL = dict(rtol=1e-5, atol=1e-7)
JMOE_FILE = os.path.abspath(jmoe.__file__)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(shared=1, **kw):
    jcfg = jget_config("deepseek-v2-lite-16b").tiny().replace(
        num_shared_experts=shared, **kw)
    return jcfg, convert.config_from_reference(dataclasses.asdict(jcfg))


def _params(cfg, seed=0, skew=0.0, tie_cols=()):
    """float32 weights: the router scaled by d^-1/2, plus ``skew / d`` on
    expert 0's column (a logit ``skew * mean(x)`` higher); ``tie_cols``
    zeroed (exactly tied logits)."""
    rng = np.random.default_rng(seed)
    d, E, ff = cfg.d_model, cfg.num_experts, cfg.moe_d_ff
    p = {"router": rng.standard_normal((d, E)) * d ** -0.5,
         "moe_up": rng.standard_normal((E, d, ff)) * d ** -0.5,
         "moe_gate": rng.standard_normal((E, d, ff)) * d ** -0.5,
         "moe_down": rng.standard_normal((E, ff, d)) * ff ** -0.5}
    p["router"][:, 0] += skew / d
    for c in tie_cols:
        p["router"][:, c] = 0.0
    if cfg.num_shared_experts:
        sf = ff * cfg.num_shared_experts
        p.update(shared_up=rng.standard_normal((d, sf)) * d ** -0.5,
                 shared_gate=rng.standard_normal((d, sf)) * d ** -0.5,
                 shared_down=rng.standard_normal((sf, d)) * sf ** -0.5)
    return {k: v.astype(np.float32) for k, v in p.items()}


def _reference_intermediates(monkeypatch, p, x, jcfg):
    """``_local_moe``'s output and its routing intermediates."""
    seen = {"where": []}

    def from_moe():
        import sys
        return os.path.abspath(sys._getframe(2).f_code.co_filename) == JMOE_FILE

    def recording(name, fn):
        def wrapper(*a, **kw):
            out = fn(*a, **kw)
            if from_moe():
                if name == "where":
                    seen["where"].append((a, out))
                else:
                    seen[name] = out
            return out
        return wrapper

    monkeypatch.setattr(jax.nn, "softmax", recording("softmax", jax.nn.softmax))
    monkeypatch.setattr(jax.lax, "top_k", recording("top_k", jax.lax.top_k))
    monkeypatch.setattr(jnp, "argsort", recording("argsort", jnp.argsort))
    monkeypatch.setattr(jnp, "where", recording("where", jnp.where))
    y = jmoe._local_moe(jnp.asarray(x), *(jnp.asarray(p[k]) for k in (
        "router", "moe_up", "moe_gate", "moe_down")), cfg=jcfg, tp=1,
        my_rank=0, fsdp_axis=None)
    monkeypatch.undo()
    # the where calls: local_e, slot (cond keep), slot_of_copy, w_of_copy
    (_, _), ((keep, _, _), slot), _, ((_, sw, _), _) = seen["where"]
    top_w, top_e = seen["top_k"]
    return np.asarray(y), {
        "probs": np.asarray(seen["softmax"]),
        "top_w_raw": np.asarray(top_w), "top_e": np.asarray(top_e),
        "order": np.asarray(seen["argsort"]), "keep": np.asarray(keep),
        "slot": np.asarray(slot), "sw": np.asarray(sw)}


def _port_route(probs, cfg, T):
    return moe.route(torch.from_numpy(np.array(probs)), cfg.top_k,
                     moe.capacity(cfg, T))


def _assert_same_decisions(r, ref, bitwise_weights):
    np.testing.assert_array_equal(r.top_e.numpy(), ref["top_e"])
    np.testing.assert_array_equal(r.order.numpy(), ref["order"])
    np.testing.assert_array_equal(r.keep.numpy(), ref["keep"])
    np.testing.assert_array_equal(r.slot.numpy(), ref["slot"])
    sw = r.top_w.reshape(-1)[r.order].numpy()
    if bitwise_weights:
        np.testing.assert_array_equal(sw, ref["sw"])
    else:
        np.testing.assert_allclose(sw, ref["sw"], **PROB_TOL)


def _port_params(p):
    return {k: torch.from_numpy(v) for k, v in p.items()}


CASES = [  # (id, shared, config overrides, T, skew, tied columns)
    ("deepseek-tiny", 1, {}, 64, 0.0, ()),
    ("no-shared", 0, {}, 64, 0.0, ()),
    ("e8-top6", 1, dict(num_experts=8, top_k=6), 48, 0.0, ()),
    ("skewed-drops", 1, {}, 96, 3.0, ()),
    ("tied", 0, dict(num_experts=6, top_k=3), 40, 0.0, (1, 2, 4)),
]


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_routing_is_the_reference_bit_for_bit(monkeypatch, case):
    _, shared, kw, T, skew, ties = case
    jcfg, cfg = _cfgs(shared, **kw)
    p = _params(cfg, seed=len(ties) + T, skew=skew, tie_cols=ties)
    # a skewed router sees inputs of mean 1: expert 0 wins most tokens
    x = (np.random.default_rng(T).standard_normal((T, cfg.d_model))
         + (1.0 if skew else 0.0)).astype(np.float32)
    want, ref = _reference_intermediates(monkeypatch, p, x, jcfg)
    # the decisions on the reference's own probabilities: bitwise
    r = _port_route(ref["probs"], cfg, T)
    np.testing.assert_array_equal(
        torch.sort(torch.from_numpy(np.array(ref["probs"])), dim=-1,
                   descending=True,
                   stable=True).values[:, :cfg.top_k].numpy(),
        ref["top_w_raw"])
    _assert_same_decisions(r, ref, bitwise_weights=True)
    # the port's whole path from x: its probabilities within float32
    # rounding, the same discrete decisions
    probs = torch.softmax(torch.from_numpy(x) @ torch.from_numpy(p["router"]),
                          dim=-1)
    np.testing.assert_allclose(probs.numpy(), ref["probs"], **PROB_TOL)
    _assert_same_decisions(_port_route(probs.numpy(), cfg, T), ref,
                           bitwise_weights=False)
    got = moe._local_moe(_port_params(p), torch.from_numpy(x), cfg)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    if skew:
        assert int((~r.keep).sum()) > 0     # copies were dropped
    if ties:
        # exactly tied experts: the lower index first, as jax.lax.top_k
        tied = ref["probs"][:, list(ties)]
        assert (tied == tied[:, :1]).all()
        for t in range(T):
            picked = [e for e in r.top_e[t].tolist() if e in ties]
            assert picked == sorted(picked)
            assert picked == list(ties)[:len(picked)]


@pytest.mark.parametrize("shared", [0, 1])
@pytest.mark.parametrize("B,S", [(2, 16), (32, 1)])
def test_moe_apply_matches_the_reference(shared, B, S):
    jcfg, cfg = _cfgs(shared)
    p = _params(cfg, seed=B * S)
    x = np.random.default_rng(S).standard_normal((B, S, cfg.d_model)
                                                 ).astype(np.float32)
    want = jmoe.moe_apply({k: jnp.asarray(v) for k, v in p.items()},
                          jnp.asarray(x), jcfg)
    got = moe.moe_apply(_port_params(p), torch.from_numpy(x), cfg)
    assert got.shape == (B, S, cfg.d_model)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_capacity_rule_and_trash_slot():
    _, cfg = _cfgs(1)
    for T in (1, 7, 32, 512):
        assert moe.capacity(cfg, T) == max(
            int(T * cfg.top_k * cfg.capacity_factor / cfg.num_experts), 1)
    # every copy to expert 0: it keeps cap of them, the rest hit the trash
    probs = torch.zeros(20, cfg.num_experts)
    probs[:, 0] = 0.7
    probs[:, 1:] = 0.3 / (cfg.num_experts - 1)
    cap = moe.capacity(cfg, 20)
    r = moe.route(probs, cfg.top_k, cap)
    kept0 = r.keep & (r.top_e.reshape(-1)[r.order] == 0)
    assert int(kept0.sum()) == cap
    assert (r.slot[~r.keep] == cfg.num_experts * cap).all()
    assert len(set(r.slot[r.keep].tolist())) == int(r.keep.sum())


def test_moe_apply_repeats_its_bits():
    _, cfg = _cfgs(1)
    p = _port_params(_params(cfg, seed=3))
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (4, 8, cfg.d_model)).astype(np.float32))
    assert torch.equal(moe.moe_apply(p, x, cfg), moe.moe_apply(p, x, cfg))
