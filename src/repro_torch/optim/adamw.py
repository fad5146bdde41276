"""AdamW with decoupled weight decay, global-norm clipping and LR schedules.

The JAX package's ``optim/adamw.py`` on dictionaries of tensors: plain
PyTorch, no ``torch.optim``, the same arithmetic in the same order. The
moments are float32 whatever the parameter dtype; a parameter is updated in
float32 and cast back to its dtype every step, with no float32 master copy
(a master copy would be a different optimizer from the reference's).
Weight decay applies to leaves of two or more dimensions only, or to the
leaves a caller names (``decayed``: the train steps name the layer units'
leaves too, which the reference stores stacked over the repeats, two or
more dimensions there); clipping is by the global norm, in float32. Every function is pure: it returns new
tensors and leaves its inputs as they were, so a state can be kept,
checkpointed and compared.

A parameter may be a DTensor (a model placed on a ``DeviceMesh``,
``launch/shardings.py``): its moments are DTensors at its placements
(``state_specs``), and every update is computed on this rank's shard in
the same order, so a world of one is bitwise the unplaced update.
:func:`global_norm` adds each leaf once over the mesh: a sharded leaf's
sum of squares is summed over the axes that shard it (one ``all_reduce``
per set of such axes), a replicated leaf's is its own.
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple, Union

import torch

from ..launch import collectives
from ..launch.shardings import like, local, sharded_axes

__all__ = ["AdamWState", "adamw_init", "adamw_update", "cosine_schedule",
           "global_norm", "clip_by_global_norm"]


class AdamWState(NamedTuple):
    step: torch.Tensor   # () int32
    m: dict              # float32, like the params
    v: dict              # float32, like the params


def _zeros(p) -> torch.Tensor:
    """float32 zeros at ``p``'s placements."""
    loc = local(p)
    return like(p, torch.zeros(loc.shape, dtype=torch.float32,
                               device=loc.device))


def adamw_init(params: dict) -> AdamWState:
    dev = local(next(iter(params.values()))).device
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                      m={k: _zeros(p) for k, p in params.items()},
                      v={k: _zeros(p) for k, p in params.items()})


@torch.no_grad()
def global_norm(tree: dict) -> torch.Tensor:
    """sqrt of the sum of every leaf's float32 sum of squares, leaf by leaf
    in the dictionary's order (each leaf's once over the mesh)."""
    parts = [torch.sum(torch.square(local(x).float())) for x in tree.values()]
    by_axes: dict = {}
    for i, x in enumerate(tree.values()):
        axes = sharded_axes(x)
        if axes:
            by_axes.setdefault((axes, x.device_mesh), []).append(i)
    for (axes, mesh), idx in by_axes.items():
        vec = torch.stack([parts[i] for i in idx])
        for a in axes:
            vec = collectives.all_reduce(vec, mesh.get_group(a))
        for j, i in enumerate(idx):
            parts[i] = vec[j]
    total = 0
    for ss in parts:
        total = total + ss
    return torch.sqrt(torch.as_tensor(total, dtype=torch.float32))


@torch.no_grad()
def clip_by_global_norm(grads: dict, max_norm: float):
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    return ({k: like(g, (local(g).float() * scale).to(g.dtype))
             for k, g in grads.items()}, norm)


def cosine_schedule(base_lr: float, warmup: int, total: int,
                    min_frac: float = 0.1) -> Callable:
    """step (int tensor) -> float32 learning rate: linear warmup, then a
    cosine from base_lr down to min_frac * base_lr at ``total``."""
    def lr(step: torch.Tensor) -> torch.Tensor:
        step = step.float()
        warm = base_lr * torch.clamp(step / max(warmup, 1), max=1.0)
        prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = min_frac + (1 - min_frac) * 0.5 * (1 + torch.cos(math.pi * prog))
        return torch.where(step < warmup, warm, base_lr * cos)
    return lr


@torch.no_grad()
def adamw_update(params: dict, grads: dict, state: AdamWState,
                 lr: Union[Callable, float], *, b1: float = 0.9,
                 b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1, max_grad_norm: float = 1.0,
                 decayed=None):
    """One AdamW step: ``(params, state, {"grad_norm", "lr"})``. ``lr`` is a
    schedule or a float. ``decayed``: the names of the leaves that take
    weight decay (None: those of two or more dimensions). New parameters
    are leaves that require a gradient when the old ones did."""
    grads, gnorm = clip_by_global_norm(grads, max_grad_norm)
    step = state.step + 1
    lr_t = (lr(step) if callable(lr)
            else torch.tensor(lr, dtype=torch.float32, device=step.device))
    b1t = 1 - b1 ** step.float()
    b2t = 1 - b2 ** step.float()
    new_p, new_m, new_v = {}, {}, {}
    for k, p in params.items():
        gf = local(grads[k]).float()
        m_n = b1 * local(state.m[k]) + (1 - b1) * gf
        v_n = b2 * local(state.v[k]) + (1 - b2) * gf * gf
        update = (m_n / b1t) / (torch.sqrt(v_n / b2t) + eps)
        pf = local(p).float()
        if (p.ndim >= 2) if decayed is None else (k in decayed):
            update = update + weight_decay * pf
        new_p[k] = like(p, (pf - lr_t * update).to(p.dtype)).requires_grad_(
            p.requires_grad)
        new_m[k], new_v[k] = like(p, m_n), like(p, v_n)
    return (new_p, AdamWState(step=step, m=new_m, v=new_v),
            {"grad_norm": gnorm, "lr": lr_t})
