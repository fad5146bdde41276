"""Rematerialization (``models/remat.py``): one checkpoint per layer unit,
"full" and "dots", as the JAX package's ``remat`` and ``remat_policy``.

Held on the CPU (tiny configs, float32):

* for every arch, after one AdamW step (so the state's weights differ
  from the module's, which ``functional_call`` swaps out again before the
  backward recomputes), the loss and every gradient leaf under "full" and
  "dots" bitwise equal to the step without remat;
* the port's step under each policy against the reference's
  ``make_train_step`` with the same ``remat`` and ``remat_policy``, from
  the initial state and from the state the reference's first step made,
  at ``test_torch_train_archs.py``'s tolerances (Jamba in float64 as
  there);
* serving (``apply`` without a gradient, ``prefill``, ``decode_step``)
  bitwise the same with and without remat, entering no checkpoint;
* the "dots" policy saves exactly the outputs of a unit's ``mm`` and
  ``addmm`` and never a ``bmm``.
"""
import numpy as np
import pytest
import torch
from torch.utils.checkpoint import CheckpointPolicy
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs import ARCHS, get_config
from repro_torch.models import build_model, remat
from repro_torch.optim import adamw
from repro_torch.train import step as tstep
from test_torch_train_archs import (FLOAT64, GRAD_TOL, LOSS_TOL, _batch,
                                    _capturing, _np, _reference, _rel,
                                    _widened)

POLICIES = (("full", True, "full"), ("dots", True, "dots"))
# repeats of the tiny configs: Jamba's unit is already 8 layers (4 of them
# MoE), the others take two units
REPEATS = {"jamba-1.5-large-398b": 1}
LR = adamw.cosine_schedule(1e-3, 2, 10)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tiny(arch):
    return get_config(arch).tiny(REPEATS.get(arch, 2))


def _torch_batch(cfg):
    return tuple(None if a is None else torch.as_tensor(a)
                 for a in _batch(cfg))


def _grads(cfg, params, batch):
    """(loss, {name: grad}) of ``params`` through a model built for
    ``cfg`` (its own weights the seed's, not the state's)."""
    model = build_model(cfg, device="cpu", seed=0, trainable=True)
    fn = tstep.value_and_grad(tstep.make_loss_fn(model, cfg))
    (loss, _), grads = fn(params, *batch)
    return loss, grads


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_gradients_are_bitwise_after_an_update(arch, monkeypatch):
    cfg = _tiny(arch).replace(remat=False)
    batch = _torch_batch(cfg)
    model = build_model(cfg, device="cpu", seed=0, trainable=True)
    state, _ = tstep.make_train_step(model, cfg, LR)(
        tstep.init_state(model), *batch)
    assert any(not torch.equal(p, state.params[n])
               for n, p in model.named_parameters())
    entered = []
    ck = remat.checkpoint
    monkeypatch.setattr(remat, "checkpoint",
                        lambda *a, **k: entered.append(1) or ck(*a, **k))
    loss, want = _grads(cfg, state.params, batch)
    assert not entered
    units = (cfg.num_encoder_layers + cfg.num_layers if cfg.is_encoder_decoder
             else cfg.num_repeats)
    for _, on, policy in POLICIES:
        loss_r, got = _grads(cfg.replace(remat=on, remat_policy=policy),
                             state.params, batch)
        assert len(entered) == units
        entered.clear()
        assert torch.equal(loss_r, loss), policy
        assert set(got) == set(want)
        for name, g in want.items():
            assert torch.equal(got[name], g), (policy, name)


def _steps(arch, on, policy):
    """Each package's step under the same remat settings, from the
    reference's initial state and again from the state its first step
    made (the port's model keeps the initial weights, so the second step's
    state differs from its module's): [(reference loss, its gradients,
    port loss, port gradients)] a step, the gradients as numpy under the
    port's names."""
    import dataclasses
    import jax
    import jax.numpy as jnp
    from repro.models import build_model as jbuild_model
    from repro.optim import adamw as jadamw
    from repro.train import step as jstep
    from repro_torch import convert
    wide = arch in FLOAT64
    jcfg0, _, host = _reference(arch, REPEATS.get(arch, 2))
    out = []
    with _widened(wide), pytest.MonkeyPatch.context() as mp:
        jcfg = dataclasses.replace(jcfg0, remat=on, remat_policy=policy)
        jm = jbuild_model(jcfg)
        cfg = convert.config_from_reference(dataclasses.asdict(jcfg))
        assert (cfg.remat, cfg.remat_policy) == (on, policy)

        if wide:
            host = jax.tree.map(
                lambda a: a.astype(np.float64) if a.dtype.kind == "f" else a,
                host)
            cfg = cfg.replace(param_dtype="float64",
                              activation_dtype="float64")
        model = convert.model_from_reference(host.params, cfg, device="cpu")
        tokens, labels, extra = _batch(cfg)
        if wide and extra is not None:
            extra = extra.astype(np.float64)
        pgrads = {}
        mp.setattr(jstep, "adamw_update",
                   _capturing(jadamw.adamw_update, None))
        mp.setattr(tstep, "adamw_update",
                   _capturing(adamw.adamw_update, pgrads))
        jfn = jax.jit(jstep.make_train_step(jm, jcfg, jadamw.cosine_schedule(
            1e-3, 2, 10)))
        pfn = tstep.make_train_step(model, cfg, LR)
        jargs = (jnp.asarray(tokens), jnp.asarray(labels),
                 None if extra is None else jnp.asarray(extra))
        pargs = tuple(None if a is None else torch.as_tensor(a)
                      for a in (tokens, labels, extra))
        for _ in range(2):
            st = convert.train_state_from_reference(host, cfg, device="cpu")
            jst, jmet = jfn(jax.tree.map(jnp.asarray, host), *jargs)
            _, pmet = pfn(st, *pargs)
            out.append((float(jmet["loss"]),
                        convert._model_state(_np(jmet["_grads"]), cfg),
                        float(pmet["loss"]), dict(pgrads)))
            host = _np(jst)
    return out


@pytest.mark.parametrize("policy", [p for p, _, _ in POLICIES])
@pytest.mark.parametrize("arch", ["smollm-360m", "deepseek-v2-lite-16b",
                                  "jamba-1.5-large-398b", "whisper-large-v3"])
def test_remat_step_matches_the_reference(arch, policy):
    on, pol = next((o, p) for name, o, p in POLICIES if name == policy)
    for jloss, want, ploss, pgrads in _steps(arch, on, pol):
        assert abs(ploss - jloss) <= LOSS_TOL * abs(jloss)
        assert set(want) == set(pgrads)
        errs = {k: _rel(g, want[k]) for k, g in pgrads.items()}
        worst = max(errs, key=errs.get)
        assert errs[worst] < GRAD_TOL, (worst, errs[worst])


def _serve(model, cfg, batch):
    """apply's logits, then a prefill and two decode steps' logits."""
    tokens, _, extra = batch
    extra_args = () if extra is None else (extra,)
    outs = [model.apply(tokens, *extra_args) if extra_args
            else model.apply(tokens)]
    logits, cache = model.prefill(tokens, *extra_args,
                                  cache_len=tokens.shape[1] + 8)
    outs.append(logits)
    nxt = logits[:, -1:].argmax(-1)
    for _ in range(2):
        logits, cache = model.decode_step(cache, nxt)
        outs.append(logits)
        nxt = logits.argmax(-1)
    return outs


@pytest.mark.parametrize("arch", ["smollm-360m", "deepseek-v2-lite-16b",
                                  "jamba-1.5-large-398b", "whisper-large-v3",
                                  "internvl2-76b"])
def test_serving_is_bitwise_without_a_checkpoint(arch, monkeypatch):
    cfg = _tiny(arch)
    batch = _torch_batch(cfg)
    entered = []
    monkeypatch.setattr(remat, "checkpoint",
                        lambda *a, **k: entered.append(1))
    runs = []
    for on in (False, True):
        c = cfg.replace(remat=on)
        # a serving model (no parameter needs a gradient) in grad mode, and
        # a trainable one under no_grad
        runs.append(_serve(build_model(c, device="cpu", seed=0), c, batch))
        with torch.no_grad():
            runs.append(_serve(build_model(c, device="cpu", seed=0,
                                           trainable=True), c, batch))
    assert not entered
    for run in runs[1:]:
        for a, b in zip(run, runs[0]):
            assert torch.equal(a, b)


class _OpLog(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(func)
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("arch,products", [
    ("smollm-360m", 7),             # wq, wk, wv, wo, w_up, w_gate, w_down
    ("deepseek-v2-lite-16b", None),  # MLA, the router, shared experts
    ("jamba-1.5-large-398b", None),  # the 8-layer unit: mamba, attn, MoE
])
def test_dots_saves_the_products_without_batch_dims(arch, products,
                                                     monkeypatch):
    cfg = _tiny(arch).replace(remat_policy="dots")
    model = build_model(cfg, device="cpu", seed=0, trainable=True)
    tokens = _torch_batch(cfg)[0]
    off = 1 if cfg.first_layer_dense else 0
    params = [remat.unit_params(b)
              for b in model.layers[off:off + cfg.pattern_len]]
    x = model._embed(tokens, None).detach().requires_grad_(True)
    positions = model._positions(*x.shape[:2])
    with torch.no_grad(), _OpLog() as plain:
        model._unit(x, params, positions)
    decided = []

    def policy(ctx, op, *a, **k):
        d = policy_dots(ctx, op, *a, **k)
        if not ctx.is_recompute:
            decided.append((op, d))
        return d
    policy_dots = remat._dots_policy
    monkeypatch.setattr(remat, "_dots_policy", policy)
    y = remat.checkpointed(model._unit, x, params, positions, policy="dots")
    y.sum().backward()
    saved = [op for op, d in decided if d == CheckpointPolicy.MUST_SAVE]
    dots = [op for op in plain.ops if op in remat.SAVED_BY_DOTS]
    assert set(saved) <= set(remat.SAVED_BY_DOTS)
    assert len(saved) == len(dots) > 0
    if products is not None:
        assert len(saved) == products
    bmm = [d for op, d in decided if op == torch.ops.aten.bmm.default]
    assert bmm and all(d != CheckpointPolicy.MUST_SAVE for d in bmm)


def test_remat_policy_is_checked():
    cfg = _tiny("smollm-360m")
    with pytest.raises(ValueError, match="remat_policy"):
        cfg.replace(remat_policy="offload")
    assert (cfg.remat, cfg.remat_policy) == (True, "full")
    with pytest.raises(ValueError, match="unknown remat policy"):
        remat.checkpointed(lambda t: t, torch.ones(1, requires_grad=True),
                           policy="offload")
