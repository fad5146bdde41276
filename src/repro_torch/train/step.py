"""Train steps: the standard step and the paper's partitioned step (the JAX
package's ``train/step.py``).

``make_train_step`` — a fixed number of gradient-accumulation microsteps
  (a Python loop where the reference scans), the AdamW update, loss and
  metrics. The trainer's step.
``make_partitioned_train_step`` — THE PAPER AS A TRAINING FEATURE: pods
  are the paper's channels. Pod p runs its own, variable, number of
  accumulation microsteps k_p (the integerized split from the frontier),
  and one cross-pod sum joins them (optionally int8-compressed). Each rank
  of the pod axis of the mesh is one pod (``torch.distributed`` where the
  reference has a manual-over-"pod" ``shard_map``).

A state is functional, as in the reference: :class:`TrainState` holds the
parameters as a dictionary of leaf tensors by the model's parameter names
and the AdamW state; the model runs on them through
``torch.func.functional_call``, and a step returns a new state and leaves
the old one as it was. On the card the forward launches the ``rmsnorm``
and ``flash_attention`` kernels and the backward their backward kernels
(``kernels/``); projections are cuBLAS matrix products. With the config's
``remat`` (the default, as in the reference) the model recomputes each
layer unit in the backward (``models/remat.py``), launching its forward
kernels a second time; the unit reads the state's tensors, which the model
gathers while ``functional_call`` has them in place.

On a mesh (a model built with a ``ShardCtx`` on a ``DeviceMesh``) the
state's parameters and moments are DTensors at ``state_specs``'
placements. Each step takes the global batch, and the model computes this
rank's rows of it (``LM.rows``): the logits are the rank's rows, the loss
is summed over the batch axes (``train/loss.py``), and each gradient comes
out at its parameter's placements, the sum over every rank's rows
(``models/transformer.py`` says how the gathers' adjoints make it).
A batch over "pod" and "data" together
(``ShardCtx(batch_axes=("pod", "data"))``, the reference's multi-pod
cells) sums the loss over both axes, reduce-scatters the FSDP gathers'
gradients over "data" and sums the pod-replicated weights' gradients over
"pod": the join ``pod_axis`` makes, from the context.
Accumulation and the update run on this rank's shards. Where the vocab
runs on its TP rank the logits are also the rank's vocab columns and the
loss is vocab-parallel, so no rank holds the (B, S, Vp) logits. At a world
of one every step is bitwise the unplaced model's.
"""
from __future__ import annotations

import functools
import re
from typing import Any, Callable, NamedTuple, Sequence

import numpy as np
import torch
from torch.func import functional_call

from ..configs.base import ModelConfig
from ..launch import collectives
from ..launch import mesh as mesh_lib
from ..launch.shardings import like, local
from ..optim.adamw import AdamWState, adamw_init, adamw_update
from ..optim.compress import dequantize_int8, quantize_int8
from .loss import softmax_xent

__all__ = ["TrainState", "init_state", "make_train_step",
           "make_partitioned_train_step", "forward", "make_loss_fn",
           "value_and_grad", "trainable", "decayed_leaves"]


class TrainState(NamedTuple):
    params: Any        # {name: leaf tensor}, the model's parameter names
    opt: AdamWState


def init_state(model) -> TrainState:
    """The state of ``model``'s current weights, each a leaf that requires
    a gradient, and fresh AdamW moments."""
    params = {k: p.detach().requires_grad_(True)
              for k, p in model.named_parameters()}
    return TrainState(params=params, opt=adamw_init(params))


_UNIT = re.compile(r"^(?:lm\.)?layers\.(\d+)\.")


def decayed_leaves(model, cfg: ModelConfig) -> frozenset:
    """The names of the parameters AdamW decays, as the reference does:
    it decays every leaf of two or more dimensions, and it stores each
    layer unit's leaves stacked over the repeats (a unit's norm scale is
    (repeats, d) there), so every leaf of a unit is decayed; a first dense
    layer, the embedding's and the final norm are not stacked."""
    off = 1 if cfg.first_layer_dense else 0
    out = set()
    for name, p in model.named_parameters():
        unit = _UNIT.match(name)
        if (p.ndim >= 2 or (unit is not None and int(unit.group(1)) >= off)
                or name.startswith(("enc_blocks.", "dec_blocks."))):
            out.add(name)
    return frozenset(out)


def forward(model, cfg: ModelConfig, params, tokens, extra_embeds=None):
    """Uniform forward dispatch across LM / EncDec / VLM, on ``params``:
    the logits of this rank's rows of the batch (all of them off a
    mesh)."""
    if cfg.is_encoder_decoder:
        return functional_call(model, params, (tokens, extra_embeds))
    if cfg.num_patches:
        return functional_call(model, params, (tokens, extra_embeds),
                               {"rows": True})
    return functional_call(model, params, (tokens,), {"rows": True})


def _ctx(model):
    """The model's ``ShardCtx``."""
    return getattr(getattr(model, "lm", model), "ctx", None)


def make_loss_fn(model, cfg: ModelConfig, *, reduce: str = "mean",
                 groups=()):
    """The loss of ``params`` on a batch; ``groups``: the process groups
    of further axes whose ranks hold other rows (the pod axis of
    :func:`make_train_step`), besides the model's batch axes."""
    ctx = _ctx(model)
    groups = ([ctx.group(a) for a in ctx.row_axes] if ctx is not None
              else []) + list(groups)
    # the rank's vocab columns of the logits (a vocab run by rank)
    vocab = model.logits_shard() if ctx is not None else None

    def loss_fn(params, tokens, labels, extra_embeds=None):
        logits = forward(model, cfg, params, tokens, extra_embeds)
        if ctx is not None:
            labels = model.rows(labels)
        loss, metrics = softmax_xent(logits, labels, cfg.vocab_size,
                                     groups, vocab)
        if reduce == "sum":
            return loss * metrics["tokens"], metrics
        return loss, metrics
    return loss_fn


def value_and_grad(loss_fn: Callable) -> Callable:
    """``fn(params, *args) -> ((loss, metrics), grads)``, the gradient of
    the loss in every leaf of ``params`` (zeros for a leaf the loss does
    not reach), in the leaf's dtype."""
    def fn(params, *args):
        with torch.enable_grad():
            loss, metrics = loss_fn(params, *args)
            leaves = list(params.values())
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = {k: g if g is not None else like(p, torch.zeros_like(
                     local(p))) for (k, p), g in zip(params.items(), grads)}
        metrics = {k: v.detach() for k, v in metrics.items()}
        return (loss.detach(), metrics), grads
    return fn


def make_train_step(model, cfg: ModelConfig, lr, *, accum: int = 1,
                    weight_decay: float = 0.1, max_grad_norm: float = 1.0,
                    accum_dtype=torch.float32, pod_axis=None):
    """The standard train step with optional fixed gradient accumulation
    (``accum`` microbatches of B / accum rows, gradients summed in
    ``accum_dtype`` and averaged).

    ``pod_axis``: an axis of the model's mesh that its context leaves out
    (the pods of the multi-pod mesh, over which the reference shards the
    batch together with "data"): each pod takes its block of the batch's
    rows, the loss is summed over the pod group too, and one
    ``all_reduce`` over it joins the gradients (data parallelism across
    pods)."""
    ctx = _ctx(model)
    pod_group = (mesh_lib.axis_group(ctx.mesh, pod_axis)
                 if pod_axis is not None else None)
    npods = mesh_lib.axis_size(ctx.mesh, pod_axis) if pod_group else 1
    pod = mesh_lib.axis_rank(ctx.mesh, pod_axis) if pod_group else 0
    grad_fn = value_and_grad(make_loss_fn(
        model, cfg, groups=[pod_group] if pod_group else []))
    decayed = decayed_leaves(model, cfg)

    def pod_rows(x):
        if x is None or npods == 1:
            return x
        n = x.shape[0] // npods
        return x[pod * n:(pod + 1) * n]

    def train_step(state: TrainState, tokens, labels, extra_embeds=None):
        tokens, labels, extra_embeds = (pod_rows(tokens), pod_rows(labels),
                                        pod_rows(extra_embeds))
        if accum == 1:
            (loss, metrics), grads = grad_fn(state.params, tokens, labels,
                                             extra_embeds)
        else:
            mb = tokens.shape[0] // accum

            def rows(x, i):
                return None if x is None else x[i * mb:(i + 1) * mb]

            acc = {k: torch.zeros(local(p).shape, dtype=accum_dtype,
                                  device=local(p).device)
                   for k, p in state.params.items()}
            loss = torch.zeros((), dtype=torch.float32, device=tokens.device)
            for i in range(accum):
                (li, metrics), g = grad_fn(state.params, rows(tokens, i),
                                           rows(labels, i),
                                           rows(extra_embeds, i))
                acc = {k: a + local(g[k]).to(a.dtype) for k, a in acc.items()}
                loss = loss + li
            grads = {k: like(state.params[k], a / accum)
                     for k, a in acc.items()}
            loss = loss / accum
            metrics = dict(metrics)
            metrics["loss"] = loss
        if pod_group is not None:
            locs = {k: local(g) for k, g in grads.items()}
            flat = collectives.all_reduce(_flat(locs), pod_group)
            grads = {k: like(state.params[k], g.to(locs[k].dtype))
                     for k, g in _unflat(flat, locs).items()}
        params, opt, om = adamw_update(state.params, grads, state.opt, lr,
                                       weight_decay=weight_decay,
                                       max_grad_norm=max_grad_norm,
                                       decayed=decayed)
        return TrainState(params, opt), {**metrics, **om}

    return train_step


def _flat(tree: dict) -> torch.Tensor:
    return torch.cat([t.reshape(-1) for t in tree.values()])


def _unflat(flat: torch.Tensor, like: dict) -> dict:
    out, at = {}, 0
    for k, t in like.items():
        out[k] = flat[at:at + t.numel()].reshape(t.shape)
        at += t.numel()
    return out


def _compressed_join(g_sum: dict, npods: int, group) -> dict:
    """The int8 join: every pod's blocks and scales gathered (one
    ``all_gather`` each), dequantized and summed in pod order; on one pod,
    the dequantized blocks of its own sum, as the reference's 1-device
    mesh computes it."""
    qs = {k: quantize_int8(g) for k, g in g_sum.items()}
    q_flat = torch.cat([q.reshape(-1) for q, _ in qs.values()])
    s_flat = torch.cat([s.reshape(-1) for _, s in qs.values()])
    if npods > 1:
        q_all = collectives.all_gather(q_flat, 0, group,
                                       partial_grads=False).chunk(npods)
        s_all = collectives.all_gather(s_flat, 0, group,
                                       partial_grads=False).chunk(npods)
    else:
        q_all, s_all = [q_flat], [s_flat]
    out = {}
    qa = sa = 0
    for k, (q, s) in qs.items():
        parts = [dequantize_int8(q_all[p][qa:qa + q.numel()].reshape(q.shape),
                                 s_all[p][sa:sa + s.numel()].reshape(s.shape),
                                 g_sum[k].shape, torch.float32)
                 for p in range(npods)]
        out[k] = functools.reduce(torch.add, parts)
        qa += q.numel()
        sa += s.numel()
    return out


def make_partitioned_train_step(model, cfg: ModelConfig, mesh, lr, *,
                                max_micro: int, weight_decay: float = 0.1,
                                max_grad_norm: float = 1.0,
                                compress_pod_reduce: bool = False,
                                pod_axis: str = "pod"):
    """Uncertainty-partitioned train step (see the module docstring).

    Inputs per call:
      tokens/labels: (max_micro, B_mb, S), the whole slab on every pod;
        pod p takes its rows, ``B_mb / |pod|`` of them, and its microsteps
        the slabs [0, k_p).
      k_pods: the partitioner's microstep counts, a host sequence (numpy,
        a list): the loop bound stays on the host, as the reference's
        ``while_loop`` bound is a host value; no device value decides it.
        Pod p reads entry ``p * len(k_pods) // |pod|`` (on a one-pod mesh,
        entry 0 and the whole slab, as the reference on its 1-device mesh).

    Each pod sums its microsteps' summed-loss gradients in float32; one
    ``all_reduce(SUM)`` over the pod group joins gradients, loss and
    tokens (or, with ``compress_pod_reduce``, an int8 ``all_gather`` of the
    gradients and a dequantized sum in pod order), then both are divided
    by the tokens.
    """
    grad_fn = value_and_grad(make_loss_fn(model, cfg, reduce="sum"))
    decayed = decayed_leaves(model, cfg)
    npods = mesh_lib.axis_size(mesh, pod_axis)
    pod = mesh_lib.axis_rank(mesh, pod_axis)
    group = mesh_lib.axis_group(mesh, pod_axis)

    def train_step(state: TrainState, tokens, labels,
                   k_pods: Sequence[int]):
        if isinstance(k_pods, torch.Tensor) and k_pods.is_cuda:
            raise TypeError("k_pods must be a host sequence: the microstep "
                            "loop never reads a device value")
        k_host = np.asarray(k_pods)
        k = int(k_host[pod * (len(k_host) // npods)])
        rows = tokens.shape[1] // npods
        sl = slice(pod * rows, (pod + 1) * rows)
        params = state.params
        dev = tokens.device
        g_sum = {p_: torch.zeros(local(t).shape, dtype=torch.float32,
                                 device=dev)
                 for p_, t in params.items()}
        loss_sum = torch.zeros((), dtype=torch.float32, device=dev)
        tok_sum = torch.zeros((), dtype=torch.float32, device=dev)
        for i in range(min(k, max_micro)):
            (lsum, m), g = grad_fn(params, tokens[i, sl], labels[i, sl], None)
            g_sum = {p_: a + local(g[p_]).float() for p_, a in g_sum.items()}
            loss_sum = loss_sum + lsum
            tok_sum = tok_sum + m["tokens"]
        if compress_pod_reduce:
            g_tot = _compressed_join(g_sum, npods, group)
            if npods > 1:
                lt = collectives.all_reduce(torch.stack([loss_sum, tok_sum]),
                                            group)
                loss_sum, tok_sum = lt[0], lt[1]
        elif npods > 1:
            flat = collectives.all_reduce(torch.cat(
                [_flat(g_sum), loss_sum[None], tok_sum[None]]), group)
            g_tot = _unflat(flat[:-2], g_sum)
            loss_sum, tok_sum = flat[-2], flat[-1]
        else:   # one pod: the sum over the pod axis is the pod's own
            g_tot = g_sum
        denom = torch.clamp(tok_sum, min=1.0)
        grads = {p_: like(params[p_], g / denom) for p_, g in g_tot.items()}
        new_params, opt, om = adamw_update(params, grads, state.opt, lr,
                                           weight_decay=weight_decay,
                                           max_grad_norm=max_grad_norm,
                                           decayed=decayed)
        return (TrainState(new_params, opt),
                {"loss": loss_sum / denom, "tokens": tok_sum, **om})

    return train_step


def trainable(state: TrainState) -> TrainState:
    """``state`` with every parameter a leaf that requires a gradient (a
    restored checkpoint's tensors do not)."""
    return TrainState({k: p.detach().requires_grad_(True)
                       for k, p in state.params.items()}, state.opt)
