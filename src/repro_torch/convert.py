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
simulator state per stage fleet).

The model zoo's configurations and weights cross too:
:func:`config_from_reference` takes ``dataclasses.asdict`` of a JAX
``ModelConfig``, and :func:`lm_from_reference` the JAX ``LM.init`` pytree
as numpy arrays (its per-pattern-position weights stacked over repeats are
unstacked into the port's per-layer submodules; each leaf lands in its
parameter's dtype, so a mamba mixer's float32 ``A_log``, ``dt_bias`` and
``D`` stay float32, bit for bit, inside a bf16 model).
"""
from __future__ import annotations

import copy

import numpy as np
import torch

from .configs.base import LayerSpec, ModelConfig
from .models.transformer import LM
from .sched.balancer import UncertaintyAwareBalancer, WorkflowBalancer
from .sim.cluster import ClusterSim, WorkflowSim
from .workflow.dag import MAX_DEPTH_DEFAULT, Stage, StageDAG

__all__ = ["balancer_from_reference", "sim_from_reference",
           "dag_from_reference", "workflow_balancer_from_reference",
           "workflow_sim_from_reference", "config_from_reference",
           "lm_from_reference"]

# the JAX ModelConfig's execution switches; the port selects by device
_JAX_ONLY_FIELDS = ("attention_impl", "ssd_impl", "remat", "remat_policy")


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


def config_from_reference(d: dict) -> ModelConfig:
    """The port's ``ModelConfig`` from ``dataclasses.asdict`` of a JAX one;
    its four execution switches are dropped."""
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


def lm_from_reference(params: dict, cfg: ModelConfig, device="cuda") -> LM:
    """The port's :class:`LM` on ``device`` holding the weights of a JAX
    ``LM.init`` pytree (numpy leaves): repeat r of pattern position i, the
    r-th slice of ``blocks/pos{i}/*``, becomes ``layers[r * P + i]``."""
    lm = LM(cfg, device=device)
    state = {"embed.embedding": params["embed"]["embedding"],
             "embed.head": params["embed"]["head"],
             "final_norm": params["final_norm"]}
    P = cfg.pattern_len
    for i in range(P):
        for name, stacked in _leaves(params["blocks"][f"pos{i}"]):
            for r in range(cfg.num_repeats):
                state[f"layers.{r * P + i}.{name}"] = np.asarray(stacked)[r]
    lm.load_state_dict({k: _tensor(v) for k, v in state.items()}, strict=True)
    return lm
