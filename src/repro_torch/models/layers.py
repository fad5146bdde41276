"""Common building blocks: init helpers, norms, RoPE, dense MLPs, embeddings.

Parameters live in ``nn.ParameterDict``s under the JAX package's leaf names
(``wq``, ``w_up``, ``embedding``, ...), with its ``(in, out)`` layout, so a
block applies ``x @ p["wq"]`` as the reference does and weights cross over
by name (``convert.lm_from_reference``). A model is built for serving:
parameters do not require gradients until ``build_model(...,
trainable=True)`` (the training path) asks for them. Initializers take an explicit
``torch.Generator``; its numbers differ from ``jax.random``'s, so tests
carry the reference's weights across instead of re-drawing them.

Under tensor parallelism (``models/tp.py``) :func:`mlp_apply` takes a
rank's hidden columns (``w_up``, ``w_gate``) and rows (``w_down``) as they
are and returns its partial; :func:`embed_lookup` and :func:`lm_head`
take a rank's vocab rows of the table and columns of the head.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..configs.base import ModelConfig
from ..kernels import ops
from ..launch import collectives

__all__ = [
    "dense_init", "rmsnorm_init", "rms_norm", "rope", "mlp_init", "mlp_apply",
    "embed_init", "embed_lookup", "lm_head", "dtype_of", "param",
]

# truncated-normal bounds of dense_init, in standard deviations
_TRUNC = 3.0


def dtype_of(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32,
            "float16": torch.float16, "float64": torch.float64}[name]


def wide(dtype: torch.dtype) -> torch.dtype:
    """The type of the math the reference keeps in float32 whatever the
    model's dtype: float32, or float64 in a float64 model (the CPU's plain
    route, which then holds the reference in float64 throughout)."""
    return torch.float64 if dtype == torch.float64 else torch.float32


def param(t: torch.Tensor) -> nn.Parameter:
    """A parameter built without a gradient (``build_model`` turns them on
    for training)."""
    return nn.Parameter(t, requires_grad=False)


def dense_init(shape, dtype, generator: torch.Generator, device,
               scale: Optional[float] = None) -> torch.Tensor:
    """Truncated-normal fan-in init, drawn in float32 on ``device`` (the
    inverse-CDF draw of ``torch.nn.init.trunc_normal_``) and cast."""
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    std = scale if scale is not None else fan_in ** -0.5
    lo = math.erf(-_TRUNC / math.sqrt(2.0))
    hi = math.erf(_TRUNC / math.sqrt(2.0))
    t = torch.empty(shape, dtype=torch.float32, device=device)
    t.uniform_(lo, hi, generator=generator)
    t.erfinv_().mul_(math.sqrt(2.0)).clamp_(-_TRUNC, _TRUNC).mul_(std)
    return t.to(dtype)


def rmsnorm_init(d: int, dtype, device) -> torch.Tensor:
    return torch.ones((d,), dtype=dtype, device=device)


def rms_norm(x, w, eps: float = 1e-6):
    """Through ``ops.rmsnorm``: the CUDA kernel on the card. (The JAX model
    defaults to its XLA reference here; the function is the same.)"""
    return ops.rmsnorm(x, w, eps=eps)


def rope(x, positions, theta: float):
    """Rotary embedding. x: (..., S, H, D) or (..., S, D); positions: (..., S).
    Computed in float32 (``wide``) and cast back to x's dtype, as in the
    reference."""
    d = x.shape[-1]
    half = d // 2
    ct = wide(x.dtype)
    freq = torch.pow(theta, -torch.arange(0, half, dtype=ct,
                                          device=x.device) / half)
    ang = positions[..., None].to(ct) * freq  # (..., S, half)
    cos, sin = torch.cos(ang), torch.sin(ang)
    if x.ndim == cos.ndim + 1:  # head axis present: (..., S, H, D)
        cos, sin = cos[..., None, :], sin[..., None, :]
    xf1, xf2 = x[..., :half].to(ct), x[..., half:].to(ct)
    return torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin],
                     dim=-1).to(x.dtype)


# ---------------------------------------------------------------- dense MLP
def mlp_init(cfg: ModelConfig, generator: torch.Generator, device,
             d_ff: Optional[int] = None) -> nn.ParameterDict:
    d, ff = cfg.d_model, d_ff or cfg.d_ff
    dt = dtype_of(cfg.param_dtype)
    p = {"w_up": dense_init((d, ff), dt, generator, device),
         "w_down": dense_init((ff, d), dt, generator, device)}
    if cfg.mlp_act == "swiglu":
        p["w_gate"] = dense_init((d, ff), dt, generator, device)
    return nn.ParameterDict({k: param(v) for k, v in p.items()})


def mlp_apply(p, x, act: str):
    """x: (..., d) -> (..., d), in the parameters' dtype."""
    up = x @ p["w_up"]
    if act == "swiglu":
        h = F.silu(x @ p["w_gate"]) * up
    elif act == "relu2":
        r = F.relu(up)
        h = r * r
    elif act == "gelu":
        h = F.gelu(up, approximate="tanh")  # jax.nn.gelu's default
    else:
        raise ValueError(act)
    return h @ p["w_down"]


# ---------------------------------------------------------------- embeddings
def embed_init(cfg: ModelConfig, generator: torch.Generator,
               device) -> nn.ParameterDict:
    dt = dtype_of(cfg.param_dtype)
    return nn.ParameterDict({
        "embedding": param(dense_init((cfg.padded_vocab, cfg.d_model), dt,
                                      generator, device, scale=1.0)),
        "head": param(dense_init((cfg.d_model, cfg.padded_vocab), dt,
                                 generator, device)),
    })


def embed_lookup(p, tokens, cfg: ModelConfig, shard=None):
    """Row lookup in the activation dtype. The reference contracts a one-hot
    with the table, which picks each row exactly, as a gather does.

    ``shard`` ``(start, group)``: ``p["embedding"]`` holds this rank's
    vocab rows from ``start``; a token outside them gives a zero row, and
    an ``all_reduce`` over ``group`` sums the ranks' rows, of which one
    is the token's and the rest are zero (what the reference's one-hot
    contraction lowers to on a vocab-sharded table): the sum is exact."""
    adt = dtype_of(cfg.activation_dtype)
    if shard is None:
        return F.embedding(tokens, p["embedding"]).to(adt)
    start, group = shard
    table = p["embedding"]
    loc = tokens - start
    inside = (loc >= 0) & (loc < table.shape[0])
    x = F.embedding(torch.where(inside, loc, 0), table).to(adt)
    x = torch.where(inside[..., None], x, torch.zeros((), dtype=adt,
                                                      device=x.device))
    return collectives.all_reduce(x, group)


def lm_head(p, x, cfg: ModelConfig, group=None):
    """Logits (..., V) of x (..., d); with ``group`` ``p["head"]`` holds
    this rank's vocab columns and so do the logits, and x (the same on
    every rank of ``group``) enters through Megatron's f (its gradient
    summed over the ranks)."""
    return collectives.reduce_grad(x, group) @ p["head"].to(x.dtype)
