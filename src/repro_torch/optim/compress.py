"""Int8 gradient compression with error feedback for the cross-pod join
(the JAX package's ``optim/compress.py``).

Blockwise symmetric int8 over the last axis: blocks of 256 (the last one
zero-padded), one float32 scale per block (its max |x| / 127), values
rounded half to even (``torch.round``, as ``jnp.round``). Leading axes
are kept, so a leaf's blocks are its own rows'.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

__all__ = ["quantize_int8", "dequantize_int8", "ef_compress", "EFState",
           "ef_init", "BLOCK"]

BLOCK = 256


@torch.no_grad()
def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(q int8 (..., blocks, 256), scale float32 (..., blocks, 1))."""
    xf = x.float()
    if xf.ndim == 0:
        xf = xf[None]
    last = xf.shape[-1]
    pad = (-last) % BLOCK
    if pad:
        xf = F.pad(xf, (0, pad))
    blocks = xf.reshape(*xf.shape[:-1], (last + pad) // BLOCK, BLOCK)
    scale = torch.amax(torch.abs(blocks), dim=-1, keepdim=True) / 127.0
    q = torch.round(blocks / torch.clamp(scale, min=1e-12)).to(torch.int8)
    return q, scale


@torch.no_grad()
def dequantize_int8(q: torch.Tensor, scale: torch.Tensor, shape,
                    dtype) -> torch.Tensor:
    deq = q.float() * scale
    deq = deq.reshape(*deq.shape[:-2], -1)   # merge the block axes
    last = shape[-1] if len(shape) else 1
    return deq[..., :last].reshape(shape).to(dtype)


class EFState(NamedTuple):
    residual: dict   # float32, like the grads


def ef_init(grads: dict) -> EFState:
    return EFState(residual={k: torch.zeros(g.shape, dtype=torch.float32,
                                            device=g.device)
                             for k, g in grads.items()})


@torch.no_grad()
def ef_compress(grads: dict, ef: EFState):
    """Error-feedback compression: ``({name: (q, scale)}, EFState)`` with
    q = Q(g + r) and r' = (g + r) - deQ(q)."""
    qs, res = {}, {}
    for k, g in grads.items():
        tot = g.float() + ef.residual[k]
        q, s = quantize_int8(tot)
        qs[k] = (q, s)
        res[k] = tot - dequantize_int8(q, s, g.shape, torch.float32)
    return qs, EFState(residual=res)
