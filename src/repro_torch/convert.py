"""Carry state across from the JAX package.

What a running balancer accumulates is its estimation state (per-channel
posteriors, the selected family with its fitted parameters, the rate
history, the cached solve) and its simulated world (channel physics and
the generator state). Both packages serialize them as plain lists, numbers
and numpy arrays, so a JAX
``UncertaintyAwareBalancer.state_dict()`` or ``ClusterSim.state_dict()``
turns into the port's objects here without importing the JAX package.
Families cross through ``ChannelFamily.state_dict`` dictionaries. A
workflow crosses the same way: a JAX ``StageDAG`` (its stages' numpy
statistics, families and edges), a ``WorkflowBalancer.state_dict()`` (one
balancer state per stage head) and a ``WorkflowSim.state_dict()`` (one
simulator state per stage fleet). A serving ``WorkflowEngine`` crosses
whole (:func:`workflow_engine_from_reference`): its templates, admission
queue, live instances, estimation heads, simulated worlds and telemetry.

The model zoo's configurations and weights cross too:
:func:`config_from_reference` takes ``dataclasses.asdict`` of a JAX
``ModelConfig``, and :func:`lm_from_reference`, :func:`encdec_from_reference`
and :func:`vlm_from_reference` the JAX ``LM``, ``EncDec`` and ``VLM``
``init`` pytrees as numpy arrays. Weights stacked over repeats or layers
are unstacked into the port's per-layer submodules; each leaf lands in
its parameter's dtype, so a mamba mixer's float32 ``A_log``, ``dt_bias``
and ``D`` and a MoE router stay float32, bit for bit, inside a bf16
model. Every load is ``strict``: a leaf missing on either side raises.
A training state crosses too (:func:`train_state_from_reference`): the
parameters as above, and AdamW's step and float32 moments under the same
names, so a run trained in the JAX package continues in the port.
"""
from __future__ import annotations

import copy

import numpy as np
import torch

from .configs.base import LayerSpec, ModelConfig
from .models import LM, VLM, EncDec
from .sched.balancer import UncertaintyAwareBalancer, WorkflowBalancer
from .serve.engine import WorkflowEngine
from .sim.cluster import ClusterSim, WorkflowSim
from .workflow.dag import MAX_DEPTH_DEFAULT, Stage, StageDAG

__all__ = ["balancer_from_reference", "sim_from_reference",
           "dag_from_reference", "workflow_balancer_from_reference",
           "workflow_sim_from_reference", "workflow_engine_from_reference",
           "config_from_reference", "lm_from_reference",
           "encdec_from_reference", "vlm_from_reference",
           "model_from_reference", "train_state_from_reference"]

# the JAX ModelConfig's kernel switches; the port selects by device
_JAX_ONLY_FIELDS = ("attention_impl", "ssd_impl")


def _plain(x):
    """Lists and Python scalars for any numpy values in a state tree."""
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    if isinstance(x, np.ndarray):
        return x.tolist()
    if isinstance(x, np.generic):
        return x.item()
    return x


def balancer_from_reference(state_dict: dict,
                            device="cuda") -> UncertaintyAwareBalancer:
    """The port's balancer from a JAX balancer's ``state_dict``, solving on
    ``device``. The reference's ``"impl"`` names a JAX backend and is not
    carried over. The PGD restarts are not state: the port draws them from
    ``default_rng(0)``, the reference from a JAX key."""
    d = _plain(copy.deepcopy(state_dict))
    return UncertaintyAwareBalancer.from_state_dict(d, device=device)


def sim_from_reference(state_dict: dict) -> ClusterSim:
    """The port's simulator from a JAX ``ClusterSim.state_dict()``,
    generator state included, so the two replay the same draws."""
    d = copy.deepcopy(state_dict)
    rng_state = d.pop("rng_state", None)
    sim = ClusterSim.from_state_dict(_plain(d))
    if rng_state is not None:
        sim.rng.bit_generator.state = rng_state
    return sim


def _family_spec(family):
    """A JAX family (a name or a ``ChannelFamily``) as the port reads it:
    the name, or the instance's ``state_dict``."""
    if isinstance(family, str):
        return family
    return _plain(family.state_dict())


def dag_from_reference(dag) -> StageDAG:
    """The port's :class:`StageDAG` from a JAX ``StageDAG``: the same
    stages (numpy statistics, families), edges and order."""
    if isinstance(dag, StageDAG):
        return dag
    stages = [Stage(s.name, np.asarray(s.mus, np.float64),
                    np.asarray(s.sigmas, np.float64),
                    family=_family_spec(s.family)) for s in dag.stages]
    return StageDAG(stages, [tuple(e) for e in dag.edges],
                    max_depth=max(MAX_DEPTH_DEFAULT, dag.depth))


def workflow_balancer_from_reference(state_dict: dict, dag,
                                     device="cuda") -> WorkflowBalancer:
    """The port's :class:`WorkflowBalancer` from a JAX one's
    ``state_dict`` against ``dag`` (a JAX or a port ``StageDAG``), solving
    on ``device``; each stage head crosses as
    :func:`balancer_from_reference` does."""
    d = _plain(copy.deepcopy(state_dict))
    return WorkflowBalancer.from_state_dict(d, dag_from_reference(dag),
                                            device=device)


def workflow_sim_from_reference(state_dict: dict) -> WorkflowSim:
    """The port's :class:`WorkflowSim` from a JAX one's ``state_dict``,
    every stage fleet's generator state included."""
    d = copy.deepcopy(state_dict)
    stages = d.pop("stages")
    sim = WorkflowSim.from_state_dict(_plain({**d, "stages": {}}))
    sim.stage_sims = {name: sim_from_reference(sd)
                      for name, sd in stages.items()}
    return sim


def workflow_engine_from_reference(eng, device="cuda") -> WorkflowEngine:
    """The port's :class:`WorkflowEngine` from a JAX one, solving on
    ``device``: its templates through :func:`dag_from_reference` and its
    ``state_dict`` (queue, instances, heads, simulators with their
    generator states, telemetry with its samplers), so the engine's trace
    runs on in the port."""
    templates = {name: dag_from_reference(dag)
                 for name, dag in eng.templates.items()}
    d = _plain(copy.deepcopy(eng.state_dict()))
    return WorkflowEngine.from_state_dict(d, templates, device=device)


def config_from_reference(d: dict) -> ModelConfig:
    """The port's ``ModelConfig`` from ``dataclasses.asdict`` of a JAX one;
    ``remat`` and ``remat_policy`` carry across, its two kernel switches
    (``attention_impl``, ``ssd_impl``) are dropped."""
    d = {k: v for k, v in d.items() if k not in _JAX_ONLY_FIELDS}
    d["pattern"] = tuple(LayerSpec(**s) if isinstance(s, dict)
                         else LayerSpec(*s) for s in d["pattern"])
    return ModelConfig(**d)


def _leaves(tree: dict, prefix: str = ""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def _tensor(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":   # ml_dtypes: exact through float32
        a = a.astype(np.float32)
    return torch.from_numpy(np.array(a))   # a writable copy


def _lm_state(params: dict, cfg: ModelConfig, prefix: str = "") -> dict:
    """The port's LM state (numpy leaves) of a JAX ``LM.init`` pytree:
    ``params["first"]`` (a first dense layer) becomes ``layers[0]``, and
    repeat r of pattern position i, the r-th slice of ``blocks/pos{i}/*``,
    ``layers[off + r * P + i]``."""
    state = {"embed.embedding": params["embed"]["embedding"],
             "embed.head": params["embed"]["head"],
             "final_norm": params["final_norm"]}
    off = 0
    if cfg.first_layer_dense:
        for name, leaf in _leaves(params["first"]):
            state[f"layers.0.{name}"] = leaf
        off = 1
    P = cfg.pattern_len
    for i in range(P):
        for name, stacked in _leaves(params["blocks"][f"pos{i}"]):
            for r in range(cfg.num_repeats):
                state[f"layers.{off + r * P + i}.{name}"] = (
                    np.asarray(stacked)[r])
    return {prefix + k: v for k, v in state.items()}


def _load(model, state: dict):
    model.load_state_dict({k: _tensor(v) for k, v in state.items()},
                          strict=True)
    return model


def _placed(model, ctx):
    """``model`` at ``ctx``'s placements: each rank keeps its shard of the
    converted state (``models.place``; nothing without a context)."""
    if ctx is None:
        return model
    ctx.check_local()
    from .models import place
    return place(model, ctx)


def lm_from_reference(params: dict, cfg: ModelConfig, device="cuda",
                      ctx=None) -> LM:
    """The port's :class:`LM` on ``device`` holding the weights of a JAX
    ``LM.init`` pytree (numpy leaves), under the sharding context ``ctx``
    (a ``ShardCtx``) if given."""
    return _placed(_load(LM(cfg, device=device, ctx=ctx),
                         _lm_state(params, cfg)), ctx)


def vlm_from_reference(params: dict, cfg: ModelConfig, device="cuda",
                       ctx=None) -> VLM:
    """The port's :class:`VLM` on ``device`` holding the weights of a JAX
    ``VLM.init`` pytree (its LM backbone's), under ``ctx`` if given."""
    return _placed(_load(VLM(cfg, device=device, ctx=ctx),
                         _lm_state(params, cfg, "lm.")), ctx)


def _encdec_state(params: dict, cfg: ModelConfig) -> dict:
    """The port's EncDec state (numpy leaves) of a JAX ``EncDec.init``
    pytree: layer l of the stacked ``enc_blocks`` and ``dec_blocks``
    becomes ``enc_blocks[l]`` and ``dec_blocks[l]``."""
    state = {"embed.embedding": params["embed"]["embedding"],
             "embed.head": params["embed"]["head"],
             "enc_norm": params["enc_norm"],
             "final_norm": params["final_norm"]}
    for stack, n in (("enc_blocks", cfg.num_encoder_layers),
                     ("dec_blocks", cfg.num_layers)):
        for name, stacked in _leaves(params[stack]):
            for layer in range(n):
                state[f"{stack}.{layer}.{name}"] = np.asarray(stacked)[layer]
    return state


def encdec_from_reference(params: dict, cfg: ModelConfig, device="cuda",
                          ctx=None) -> EncDec:
    """The port's :class:`EncDec` on ``device`` holding the weights of a
    JAX ``EncDec.init`` pytree (:func:`_encdec_state`), under ``ctx`` if
    given (each rank keeping its shard of every layer's weights)."""
    return _placed(_load(EncDec(cfg, device=device, ctx=ctx),
                         _encdec_state(params, cfg)), ctx)


def _model_state(tree: dict, cfg: ModelConfig) -> dict:
    """Names of the port's parameters to the leaves of a pytree shaped like
    the JAX model's parameters (its weights, or AdamW moments)."""
    if cfg.is_encoder_decoder:
        return _encdec_state(tree, cfg)
    return _lm_state(tree, cfg, "lm." if cfg.num_patches else "")


def model_from_reference(params: dict, cfg: ModelConfig, device="cuda",
                         ctx=None):
    """The port's model (LM, EncDec or VLM, by ``cfg``) on ``device``
    holding a JAX model's weights (numpy leaves); ``ctx`` as in
    :func:`lm_from_reference`."""
    if cfg.is_encoder_decoder:
        return encdec_from_reference(params, cfg, device=device, ctx=ctx)
    if cfg.num_patches:
        return vlm_from_reference(params, cfg, device=device, ctx=ctx)
    return lm_from_reference(params, cfg, device=device, ctx=ctx)


def train_state_from_reference(state, cfg: ModelConfig, device="cuda"):
    """The port's ``train.step.TrainState`` on ``device`` from a JAX
    ``TrainState`` with numpy leaves (``jax.tree.map(np.asarray, state)``):
    the parameters under the port's names, each in its parameter's dtype
    and requiring a gradient, and AdamW's ``step`` (int32) and float32
    moments ``m`` and ``v`` under the same names."""
    from .optim.adamw import AdamWState
    from .train.step import TrainState
    params, (step, m, v) = state
    model = model_from_reference(params, cfg, device=device)
    dev = model.device
    names = dict(model.named_parameters())
    mm, vv = _model_state(m, cfg), _model_state(v, cfg)
    if set(mm) != set(names) or set(vv) != set(names):
        raise ValueError("the AdamW moments do not match the parameters")

    def moment(tree):
        return {k: _tensor(tree[k]).to(dev, torch.float32) for k in names}

    return TrainState(
        params={k: p.detach().requires_grad_(True) for k, p in names.items()},
        opt=AdamWState(step=torch.as_tensor(np.array(step), dtype=torch.int32,
                                            device=dev),
                       m=moment(mm), v=moment(vv)))
