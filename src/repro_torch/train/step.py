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
(``kernels/``); projections are cuBLAS matrix products.
"""
from __future__ import annotations

import functools
from typing import Any, Callable, NamedTuple, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch.func import functional_call

from ..configs.base import ModelConfig
from ..launch import mesh as mesh_lib
from ..optim.adamw import AdamWState, adamw_init, adamw_update
from ..optim.compress import dequantize_int8, quantize_int8
from .loss import softmax_xent

__all__ = ["TrainState", "init_state", "make_train_step",
           "make_partitioned_train_step", "forward", "make_loss_fn",
           "value_and_grad", "trainable"]


class TrainState(NamedTuple):
    params: Any        # {name: leaf tensor}, the model's parameter names
    opt: AdamWState


def init_state(model) -> TrainState:
    """The state of ``model``'s current weights, each a leaf that requires
    a gradient, and fresh AdamW moments."""
    params = {k: p.detach().requires_grad_(True)
              for k, p in model.named_parameters()}
    return TrainState(params=params, opt=adamw_init(params))


def forward(model, cfg: ModelConfig, params, tokens, extra_embeds=None):
    """Uniform forward dispatch across LM / EncDec / VLM, on ``params``."""
    if cfg.is_encoder_decoder or cfg.num_patches:
        return functional_call(model, params, (tokens, extra_embeds))
    return functional_call(model, params, (tokens,))


def make_loss_fn(model, cfg: ModelConfig, *, reduce: str = "mean"):
    def loss_fn(params, tokens, labels, extra_embeds=None):
        logits = forward(model, cfg, params, tokens, extra_embeds)
        loss, metrics = softmax_xent(logits, labels, cfg.vocab_size)
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
        grads = {k: g if g is not None else torch.zeros_like(p)
                 for (k, p), g in zip(params.items(), grads)}
        metrics = {k: v.detach() for k, v in metrics.items()}
        return (loss.detach(), metrics), grads
    return fn


def make_train_step(model, cfg: ModelConfig, lr, *, accum: int = 1,
                    weight_decay: float = 0.1, max_grad_norm: float = 1.0,
                    accum_dtype=torch.float32):
    """The standard train step with optional fixed gradient accumulation
    (``accum`` microbatches of B / accum rows, gradients summed in
    ``accum_dtype`` and averaged)."""
    grad_fn = value_and_grad(make_loss_fn(model, cfg))

    def train_step(state: TrainState, tokens, labels, extra_embeds=None):
        if accum == 1:
            (loss, metrics), grads = grad_fn(state.params, tokens, labels,
                                             extra_embeds)
        else:
            mb = tokens.shape[0] // accum

            def rows(x, i):
                return None if x is None else x[i * mb:(i + 1) * mb]

            grads = {k: torch.zeros(p.shape, dtype=accum_dtype,
                                    device=p.device)
                     for k, p in state.params.items()}
            loss = torch.zeros((), dtype=torch.float32, device=tokens.device)
            for i in range(accum):
                (li, metrics), g = grad_fn(state.params, rows(tokens, i),
                                           rows(labels, i),
                                           rows(extra_embeds, i))
                grads = {k: a + g[k].to(a.dtype) for k, a in grads.items()}
                loss = loss + li
            grads = {k: g / accum for k, g in grads.items()}
            loss = loss / accum
            metrics = dict(metrics)
            metrics["loss"] = loss
        params, opt, om = adamw_update(state.params, grads, state.opt, lr,
                                       weight_decay=weight_decay,
                                       max_grad_norm=max_grad_norm)
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
        q_all = [torch.empty_like(q_flat) for _ in range(npods)]
        s_all = [torch.empty_like(s_flat) for _ in range(npods)]
        dist.all_gather(q_all, q_flat, group=group)
        dist.all_gather(s_all, s_flat, group=group)
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
        g_sum = {p_: torch.zeros(t.shape, dtype=torch.float32, device=dev)
                 for p_, t in params.items()}
        loss_sum = torch.zeros((), dtype=torch.float32, device=dev)
        tok_sum = torch.zeros((), dtype=torch.float32, device=dev)
        for i in range(min(k, max_micro)):
            (lsum, m), g = grad_fn(params, tokens[i, sl], labels[i, sl], None)
            g_sum = {p_: a + g[p_].float() for p_, a in g_sum.items()}
            loss_sum = loss_sum + lsum
            tok_sum = tok_sum + m["tokens"]
        if compress_pod_reduce:
            g_tot = _compressed_join(g_sum, npods, group)
            if npods > 1:
                lt = torch.stack([loss_sum, tok_sum])
                dist.all_reduce(lt, group=group)
                loss_sum, tok_sum = lt[0], lt[1]
        elif npods > 1:
            flat = torch.cat([_flat(g_sum), loss_sum[None], tok_sum[None]])
            dist.all_reduce(flat, group=group)
            g_tot = _unflat(flat[:-2], g_sum)
            loss_sum, tok_sum = flat[-2], flat[-1]
        else:   # one pod: the sum over the pod axis is the pod's own
            g_tot = g_sum
        denom = torch.clamp(tok_sum, min=1.0)
        grads = {p_: g / denom for p_, g in g_tot.items()}
        new_params, opt, om = adamw_update(params, grads, state.opt, lr,
                                           weight_decay=weight_decay,
                                           max_grad_norm=max_grad_norm)
        return (TrainState(new_params, opt),
                {"loss": loss_sum / denom, "tokens": tok_sum, **om})

    return train_step


def trainable(state: TrainState) -> TrainState:
    """``state`` with every parameter a leaf that requires a gradient (a
    restored checkpoint's tensors do not)."""
    return TrainState({k: p.detach().requires_grad_(True)
                       for k, p in state.params.items()}, state.opt)
