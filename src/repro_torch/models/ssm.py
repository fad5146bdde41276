"""Mamba2 (SSD) mixer: in-projections, causal depthwise conv, SSD scan,
gated norm.

The full-sequence path goes through ``kernels.ops.ssd`` (the CUDA chunked
scan on the card, its plain chunked version on the CPU), which also returns
the state after the last token for the prefill cache. Decode is the O(1)
recurrence on the carried (B, H, P, N) float32 state plus a conv state of
the last ``width - 1`` inputs, in plain PyTorch: the JAX package has no
kernel for it. As in the reference, ``dt_bias``, ``A_log`` and ``D`` stay
float32 whatever the parameter dtype, the conv runs in the activation dtype
during prefill and in float32 during decode. Unlike the reference,
:func:`mamba_decode` updates the two states in place.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..configs.base import ModelConfig
from ..kernels import ops
from .layers import (dense_init, dtype_of, param, rms_norm, rmsnorm_init,
                     wide)

__all__ = ["mamba_init", "mamba_apply", "mamba_decode", "mamba_state_init"]


def mamba_init(cfg: ModelConfig, generator: torch.Generator,
               device) -> nn.ParameterDict:
    d, di = cfg.d_model, cfg.ssm_inner
    H, N, G = cfg.ssm_heads, cfg.ssm_state, cfg.ssm_groups
    cw = cfg.ssm_conv_width
    dt = dtype_of(cfg.param_dtype)
    wt = wide(dt)
    conv = torch.randn((cw, di), generator=generator, dtype=wt,
                       device=device) * (cw ** -0.5)
    p = {
        "w_in_x": dense_init((d, di), dt, generator, device),
        "w_in_z": dense_init((d, di), dt, generator, device),
        "w_bc": dense_init((d, 2 * G * N), dt, generator, device),
        "w_dt": dense_init((d, H), dt, generator, device),
        "dt_bias": torch.zeros((H,), dtype=wt, device=device),
        "A_log": torch.log(torch.linspace(1.0, 16.0, H, dtype=wt,
                                          device=device)),
        "D": torch.ones((H,), dtype=wt, device=device),
        "conv": conv.to(dt),
        "ssm_norm": rmsnorm_init(di, dt, device),
        "w_out": dense_init((di, d), dt, generator, device),
    }
    return nn.ParameterDict({k: param(v) for k, v in p.items()})


def _depthwise_conv(x, w):
    """Causal depthwise conv in x's dtype. x: (B, S, C); w: (width, C)."""
    width, S = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, width - 1, 0))
    return sum(xp[:, i:i + S, :] * w[i][None, None, :] for i in range(width))


def _dt(p, x):
    """softplus(x W_dt + dt_bias) in float32 (``wide``)."""
    ct = wide(x.dtype)
    return F.softplus(x.to(ct) @ p["w_dt"].to(ct) + p["dt_bias"])


def mamba_apply(p, x, cfg: ModelConfig, *, return_state: bool = False):
    """x: (B, S, d) -> (B, S, d) [, (ssm_state, conv_state) for prefill]."""
    B, S, _ = x.shape
    H, P, N, G = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state, cfg.ssm_groups
    xi_raw = x @ p["w_in_x"]                               # (B, S, di)
    z = x @ p["w_in_z"]
    xi = F.silu(_depthwise_conv(xi_raw, p["conv"]))
    bc = x @ p["w_bc"]
    # strided (B, S, G, N) views of one projection; the kernel reads them
    # through their strides
    Bm = bc[..., :G * N].reshape(B, S, G, N)
    Cm = bc[..., G * N:].reshape(B, S, G, N)
    A = -torch.exp(p["A_log"])                             # (H,) negative
    out = ops.ssd(xi.reshape(B, S, H, P), _dt(p, x), A, Bm, Cm, p["D"],
                  chunk=cfg.ssd_chunk, return_final_state=return_state)
    y, final_state = out if return_state else (out, None)
    y = y.reshape(B, S, H * P)
    y = rms_norm(y * F.silu(z), p["ssm_norm"], cfg.norm_eps)
    y = y @ p["w_out"]
    if return_state:
        w = cfg.ssm_conv_width
        pad = xi_raw.new_zeros((B, max(w - 1 - S, 0), cfg.ssm_inner))
        conv_state = torch.cat([pad, xi_raw[:, max(S - (w - 1), 0):, :]],
                               dim=1)
        return y, (final_state, conv_state)
    return y


def mamba_state_init(cfg: ModelConfig, batch: int, dtype,
                     device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(ssm_state, conv_state): ((B, H, P, N) float32, (B, width-1, di))."""
    H, P, N = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    ssm = torch.zeros((batch, H, P, N), dtype=torch.float32, device=device)
    conv = torch.zeros((batch, cfg.ssm_conv_width - 1, cfg.ssm_inner),
                       dtype=dtype, device=device)
    return ssm, conv


def mamba_decode(p, x, cfg: ModelConfig, ssm_state, conv_state):
    """One-token recurrence. x: (B, 1, d). Returns (y (B, 1, d),
    (ssm_state, conv_state)), both states updated in place."""
    B = x.shape[0]
    H, P, N, G = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state, cfg.ssm_groups
    xt = x[:, 0]
    xi = xt @ p["w_in_x"]                                  # (B, di)
    z = xt @ p["w_in_z"]
    # the conv state holds the last width - 1 inputs
    hist = torch.cat([conv_state, xi[:, None, :].to(conv_state.dtype)], 1)
    xi = F.silu(torch.einsum("bwc,wc->bc", hist.float(),
                             p["conv"].float())).to(x.dtype)
    conv_state.copy_(hist[:, 1:])
    bc = xt @ p["w_bc"]
    rep = H // G
    Bh = torch.repeat_interleave(bc[..., :G * N].reshape(B, G, N), rep,
                                 dim=1).float()            # (B, H, N)
    Ch = torch.repeat_interleave(bc[..., G * N:].reshape(B, G, N), rep,
                                 dim=1).float()
    dt = _dt(p, xt)                                        # (B, H)
    dA = torch.exp(dt * -torch.exp(p["A_log"]))
    xh = xi.reshape(B, H, P).float()
    ssm_state.mul_(dA[..., None, None]).add_(
        dt[..., None, None] * xh[..., :, None] * Bh[..., None, :])
    y = (torch.einsum("bhpn,bhn->bhp", ssm_state, Ch)
         + p["D"][None, :, None] * xh)
    y = y.reshape(B, H * P).to(x.dtype)
    y = rms_norm(y * F.silu(z), p["ssm_norm"], cfg.norm_eps)
    return (y @ p["w_out"])[:, None, :], (ssm_state, conv_state)
