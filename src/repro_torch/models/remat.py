"""Rematerialization: one checkpoint per layer unit (the JAX package's
``jax.checkpoint`` around each scanned unit).

:func:`checkpointed` runs ``unit(*args)`` under a non-reentrant
``torch.utils.checkpoint``: the forward keeps what the policy saves and
the backward runs the unit again for the rest.

* ``"full"`` keeps the unit's inputs only (``jax.checkpoint(unit,
  policy=None)``);
* ``"dots"`` also keeps the outputs of the products without batch dims,
  ``aten.mm`` and ``aten.addmm`` (JAX's ``dots_with_no_batch_dims_saveable``):
  the projections, the MoE router and its shared experts. Batched products
  (``bmm``: the MoE's experts and combine, the plain attention) and every
  hand-written kernel are recomputed. A kernel launched through ``ctypes``
  is invisible to the policy's dispatch mode; its output buffer comes from
  an aten allocation, which is recomputed with it.

The unit takes its parameters as arguments: the caller gathers them while
``torch.func.functional_call`` has the state's tensors in the module, and
the recomputation reads those same tensors (a unit that read them from the
module in the backward would recompute with the module's own weights and
raise no error). Without a gradient to take (``torch.no_grad``, or no
input that requires one: serving, prefill, decode) the unit runs directly,
as a ``jax.checkpoint`` that is not differentiated does nothing. The units
draw no random numbers, so no generator state is kept for the replay.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
from torch import nn
from torch.utils import _pytree as pytree
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

__all__ = ["checkpointed", "unit_params", "SAVED_BY_DOTS"]

# the products without batch dims: 2-D operands, ``x @ w`` folded to 2-D
SAVED_BY_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def unit_params(module: nn.Module) -> dict:
    """``module``'s parameters as nested dicts of the tensors it holds now
    (inside ``functional_call``, the state's), by the leaf names the model
    code indexes (``p["ln1"]``, ``p["mixer"]["wq"]``)."""
    out = dict(module.named_parameters(recurse=False))
    for name, child in module.named_children():
        out[name] = unit_params(child)
    return out


def _dots_policy(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in SAVED_BY_DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _dots_context():
    return create_selective_checkpoint_contexts(_dots_policy)


def _needs_grad(args) -> bool:
    return torch.is_grad_enabled() and any(
        isinstance(t, torch.Tensor) and t.requires_grad
        for t in pytree.tree_leaves(args))


def checkpointed(unit: Callable, *args, policy: Optional[str]):
    """``unit(*args)``, recomputed in the backward under ``policy``
    ("full", "dots"; None runs it directly). ``args`` may nest tensors in
    dicts, lists and tuples: the unit's parameters among them."""
    if policy is None or not _needs_grad(args):
        return unit(*args)
    if policy == "full":
        kw = {}
    elif policy == "dots":
        kw = {"context_fn": _dots_context}
    else:
        raise ValueError(f"unknown remat policy {policy!r}")
    return checkpoint(unit, *args, use_reentrant=False,
                      preserve_rng_state=False, **kw)
