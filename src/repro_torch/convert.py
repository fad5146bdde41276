"""Carry state across from the JAX package.

The system has no model weights: what a running deployment accumulates is
its estimation state (per-channel posteriors, the selected family with its
fitted parameters, the rate history, the cached solve) and its simulated
world (channel physics and the generator state). Both packages serialize
them as plain lists, numbers and numpy arrays, so a JAX
``UncertaintyAwareBalancer.state_dict()`` or ``ClusterSim.state_dict()``
turns into the port's objects here without importing the JAX package.
Families cross through ``ChannelFamily.state_dict`` dictionaries.
"""
from __future__ import annotations

import copy

import numpy as np

from .sched.balancer import UncertaintyAwareBalancer
from .sim.cluster import ClusterSim

__all__ = ["balancer_from_reference", "sim_from_reference"]


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
