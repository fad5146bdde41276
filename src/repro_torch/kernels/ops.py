"""The port's kernel entry points: candidate-split moments and the model
kernels.

:func:`attention`, :func:`decode_attention`, :func:`rmsnorm` and
:func:`ssd` are what the model zoo calls. A CUDA tensor launches the CUDA
kernel of ``kernels/flash_attention.py``, ``flash_decode.py``,
``rmsnorm.py`` or ``ssd_scan.py``; a CPU tensor runs its plain version.
(The JAX package chose by an ``impl`` string; here the device chooses. Its
``_xla_chunked_attention`` bounded XLA's memory at long S and has no
counterpart: the kernel takes any S. Its ``ssd`` took the XLA scan
whenever the final state was asked for; the port's kernel returns it.)

:func:`frontier_moments` and :func:`frontier_moments_with_grads` are what
the frontier tracers, the PGD solver, the balancer and the sensitivity
analysis call. On ``device="cuda"`` they launch the CUDA kernels of
``kernels/frontier_grid.py`` (any number of rows, no padding); on
``device="cpu"`` they run the kernels' plain PyTorch versions in row chunks
that bound the (rows, T, K) intermediates.

The family is any of normal, lognormal, drift, empirical or defective, as a
name, a ``ChannelFamily`` or a lowered ``(dist_id, extra)`` pair.

``frontier_moments`` is a ``torch.autograd.Function``: when an input needs
a gradient, its forward runs the full-parameter (``pgrad``) kernel and
saves the adjoints, and the backward contracts them with the output
cotangents — no autograd replay through the quadrature. Per-row statistics
get per-row cotangents; shared ones are summed over rows. Only ``extra``
row 0 (drift's rho, the defective family's p) gets a cotangent: the
empirical mixture's parameters and the defective pricing lam are solve
constants whose cotangent is zero by contract.

Both frontier entry points run the sanitizer's boundary check of their
inputs under ``REPRO_SANITIZE=1`` (``analysis/sanitize.py``; a PGD loop
checks its inputs once before its first step and passes ``_check=False``
on every step) and, when tracing is on, record one ``kernel.launch`` span
(``obs``) per call with the JAX package's attributes; the launch plan
(``threads`` and ``split`` on the card, ``block_rows`` on the plain path)
stands where that package records its ``block_f``. The span times the
host's launch path; it never waits for the card.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..analysis import sanitize as _san
from ..core.distributions import resolve_family
from ..device import resolve_device
from ..obs import names as _obs_names
from ..obs import trace as _obs
from . import autotune as _at
from . import flash_attention as _fa
from . import flash_decode as _fd
from . import frontier_grid as _fg
from . import ref
from . import rmsnorm as _rn
from . import ssd_scan as _ssd

__all__ = ["frontier_moments", "frontier_moments_with_grads",
           "plain_moments", "attention", "decode_attention",
           "decode_attention_partial", "rmsnorm", "rmsnorm_split",
           "ssd"]


def _as_f32(x, device: torch.device):
    """``x`` as a float32 tensor on ``device``. A tensor already there is
    returned as it is, without a dispatch: the PGD loop passes the same
    tensors every step, and on the card each ``as_tensor`` costs the host
    several microseconds."""
    if isinstance(x, torch.Tensor) and x.dtype is torch.float32:
        here = x.device
        if here == device or (here.type == device.type == "cuda"
                              and device.index is None
                              and here.index == torch.cuda.current_device()):
            return x
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def _resolve_family(family, K: int, device):
    """Lower a family spec to (dist_id, float32 extra tensor on device)."""
    dist_id, extra = resolve_family(family, K)
    return dist_id, _as_f32(extra, torch.device(device))


def _stack_extra(extra, F: int):
    """Lift a shared (E, K) extra to the per-row (E, F, K) layout."""
    if extra.ndim == 3:
        return extra
    return extra[:, None, :].expand(extra.shape[0], F, extra.shape[1])


# repro: allow[RPA001] layout-only chunking glue: the family rides in the
# dist_id the caller hands the per-chunk function
def _row_chunks(rows: int, W, mus, sigmas, extra):
    """Yield (W, mus, sigmas, extra) slices of ``rows`` candidate rows;
    per-row statistics are sliced with W."""
    F = W.shape[0]
    for s in range(0, F, rows):
        e = min(s + rows, F)
        if mus.ndim == 2:
            yield W[s:e], mus[s:e], sigmas[s:e], extra[:, s:e]
        else:
            yield W[s:e], mus, sigmas, extra


def plain_moments(W, mus, sigmas, extra, *, num_t: int, z: float = 10.0,
                  dist_id: str = "normal", mode: str = "fwd",
                  block_rows: Optional[int] = None):
    """The kernels' plain PyTorch versions over all rows of W, in row
    chunks, on whatever device the tensors lie (``mode``: fwd, grad or
    pgrad)."""
    F, K = W.shape
    rows = block_rows or _at.lookup(F, K, num_t, backend="plain", mode=mode,
                                    dist_id=dist_id)
    outs = []
    for wb, mb, sb, eb in _row_chunks(rows, W, mus, sigmas, extra):
        if mode == "fwd":
            outs.append(ref.frontier_grid_ref(wb, mb, sb, num_t=num_t, z=z,
                                              dist_id=dist_id, extra=eb))
        else:
            outs.append(ref.frontier_grid_with_grads_ref(
                wb, mb, sb, num_t=num_t, z=z, dist_id=dist_id, extra=eb,
                param_grads=(mode == "pgrad")))
    return tuple(torch.cat(parts, 0) for parts in zip(*outs))


def _moments_fwd(W, mus, sigmas, extra, num_t, z, dist_id, block_rows):
    if W.is_cuda:
        return _fg.frontier_grid(W, mus, sigmas, extra, num_t=num_t, z=z,
                                 dist_id=dist_id)
    return plain_moments(W, mus, sigmas, extra, num_t=num_t, z=z,
                         dist_id=dist_id, mode="fwd", block_rows=block_rows)


def _moments_grads(W, mus, sigmas, extra, num_t, z, dist_id, block_rows,
                   param_grads):
    if W.is_cuda:
        return _fg.frontier_grid_with_grads(
            W, mus, sigmas, extra, num_t=num_t, z=z, dist_id=dist_id,
            param_grads=param_grads)
    return plain_moments(W, mus, sigmas, extra, num_t=num_t, z=z,
                         dist_id=dist_id,
                         mode="pgrad" if param_grads else "grad",
                         block_rows=block_rows)


class _FrontierMoments(torch.autograd.Function):
    """(mu, var) with the analytic adjoints as its backward."""

    @staticmethod
    def forward(ctx, W, mus, sigmas, extra, num_t, z, dist_id, block_rows):
        if not any(ctx.needs_input_grad[:4]):
            return _moments_fwd(W, mus, sigmas, extra, num_t=num_t, z=z,
                                dist_id=dist_id, block_rows=block_rows)
        outs = _moments_grads(W, mus, sigmas, extra, num_t=num_t, z=z,
                              dist_id=dist_id, block_rows=block_rows,
                              param_grads=True)
        ctx.save_for_backward(*outs[2:])
        ctx.extra_shape = tuple(extra.shape)
        return outs[0], outs[1]

    @staticmethod
    def backward(ctx, g_mu, g_var):
        dmu, dvar, dmu_m, dvar_m, dmu_s, dvar_s, dmu_e, dvar_e = \
            ctx.saved_tensors
        gm, gv = g_mu[:, None], g_var[:, None]
        dW = gm * dmu + gv * dvar
        d_extra = torch.zeros(ctx.extra_shape, dtype=dmu.dtype,
                              device=dmu.device)
        if len(ctx.extra_shape) == 3:
            # per-row statistics: every row owns its fleet, no reduction
            d_mus = gm * dmu_m + gv * dvar_m
            d_sigmas = gm * dmu_s + gv * dvar_s
            d_extra[0] = gm * dmu_e + gv * dvar_e
        else:
            # shared statistics: sum the per-row adjoints over rows
            d_mus = g_mu @ dmu_m + g_var @ dvar_m
            d_sigmas = g_mu @ dmu_s + g_var @ dvar_s
            d_extra[0] = g_mu @ dmu_e + g_var @ dvar_e
        return dW, d_mus, d_sigmas, d_extra, None, None, None, None


def _inputs(W, mus, sigmas, family, device):
    dev = resolve_device(device)
    W, mus, sigmas = (_as_f32(x, dev) for x in (W, mus, sigmas))
    dist_id, extra = _resolve_family(family, W.shape[1], dev)
    if mus.ndim == 2:
        extra = _stack_extra(extra, W.shape[0])
    return W, mus, sigmas, dist_id, extra


def _launch_span(mode: str, W, stacked: bool, num_t: int, dist_id: str,
                 block_rows: Optional[int]):
    """The ``kernel.launch`` span of one call (tracing on): the launch
    plan and how ``kernels.autotune`` resolved it (``hit``, ``model``,
    ``sweep``, or ``explicit`` for a caller's ``block_rows``)."""
    F, K = W.shape
    if W.is_cuda:
        threads, split, outcome = _at.plan_outcome(F, K, num_t, mode,
                                                   dist_id)
        plan = {"threads": threads, "split": list(split)}
    else:
        if block_rows is None:
            block_rows = _at.lookup(F, K, num_t, backend="plain", mode=mode,
                                    dist_id=dist_id)
            outcome = _at.last_outcome()
        else:
            outcome = "explicit"
        plan = {"block_rows": int(block_rows)}
    return _obs.span(_obs_names.SPAN_KERNEL_LAUNCH, family=dist_id,
                     mode=mode, F=int(F), K=int(K), num_t=int(num_t),
                     impl="cuda" if W.is_cuda else "plain", stacked=stacked,
                     autotune=outcome, **plan)


def frontier_moments(W, mus, sigmas, *, num_t: int = 1024,
                     device="cuda", block_rows: Optional[int] = None,
                     z: float = 10.0, family="normal", _check: bool = True):
    """Batched (mu, var), each (F,), over candidate splits W (F, K).

    ``mus``/``sigmas`` (K,) shared or (F, K) per-row (then ``extra`` may be
    (E, F, K)). Differentiable in W, mus, sigmas and ``extra`` row 0
    through the analytic adjoints. ``block_rows`` bounds the rows per chunk
    of the plain (CPU) path; None asks ``kernels.autotune``.
    """
    W, mus, sigmas, dist_id, extra = _inputs(W, mus, sigmas, family, device)
    if _check:
        _san.check_frontier_inputs(W, mus, sigmas, extra, dist_id=dist_id)
    if _obs.enabled():
        # the forward runs the full-parameter kernel when a gradient is due
        grads = torch.is_grad_enabled() and any(
            x.requires_grad for x in (W, mus, sigmas, extra))
        with _launch_span("pgrad" if grads else "fwd", W, mus.ndim == 2,
                          num_t, dist_id, block_rows):
            return _FrontierMoments.apply(W, mus, sigmas, extra, num_t, z,  # repro: allow[RPA002] autograd.Function.apply takes positional arguments only; dist_id is the seventh
                                          dist_id, block_rows)
    return _FrontierMoments.apply(W, mus, sigmas, extra, num_t, z,  # repro: allow[RPA002] autograd.Function.apply takes positional arguments only; dist_id is the seventh
                                  dist_id, block_rows)


def frontier_moments_with_grads(W, mus, sigmas, *, num_t: int = 1024,
                                device="cuda",
                                block_rows: Optional[int] = None,
                                z: float = 10.0, family="normal",
                                param_grads: bool = False,
                                _check: bool = True):
    """Fused ``(mu, var, dmu_dW, dvar_dW)`` in one launch; with
    ``param_grads=True`` the 10-tuple that adds ``(dmu_dmus, dvar_dmus,
    dmu_dsigmas, dvar_dsigmas, dmu_dex, dvar_dex)``, all (F, K)."""
    W, mus, sigmas, dist_id, extra = _inputs(W, mus, sigmas, family, device)
    if _check:
        _san.check_frontier_inputs(W, mus, sigmas, extra, dist_id=dist_id)
    with torch.no_grad():
        if _obs.enabled():
            with _launch_span("pgrad" if param_grads else "grad", W,
                              mus.ndim == 2, num_t, dist_id, block_rows):
                return _moments_grads(W, mus, sigmas, extra, num_t=num_t,
                                      z=z, dist_id=dist_id,
                                      block_rows=block_rows,
                                      param_grads=param_grads)
        return _moments_grads(W, mus, sigmas, extra, num_t=num_t, z=z,
                              dist_id=dist_id, block_rows=block_rows,
                              param_grads=param_grads)


def attention(q, k, v, *, causal: bool = True, window: Optional[int] = None,
              sm_scale: Optional[float] = None):
    """GQA flash attention. q: (B, Hq, Sq, D); k: (B, Hkv, Sk, D); v:
    (B, Hkv, Sk, Dv) -> (B, Hq, Sq, Dv)."""
    return _fa.flash_attention(q, k, v, causal=causal, window=window,
                               sm_scale=sm_scale)


def decode_attention(q, k_cache, v_cache, valid, *, sm_scale=None):
    """Single-token attention over a KV cache. q: (B, Hkv, G, D); caches:
    (B, Hkv, S, D); valid: (S,) bool."""
    return _fd.flash_decode(q, k_cache, v_cache, valid, sm_scale=sm_scale)


def decode_attention_partial(q, k_cache, v_cache, valid, *, sm_scale=None):
    """A sequence shard's float32 (m, l, acc) of :func:`decode_attention`
    (``flash_decode.flash_decode_partial``)."""
    return _fd.flash_decode_partial(q, k_cache, v_cache, valid,
                                    sm_scale=sm_scale)


def rmsnorm(x, w, *, eps: float = 1e-6):
    """RMSNorm of x (..., D) over its last axis, scaled by w (D,)."""
    return _rn.rmsnorm(x, w, eps=eps)


def rmsnorm_split(x, w, group, n: int, *, eps: float = 1e-6):
    """RMSNorm of rows split over the ranks of ``group``: this rank's
    columns x (..., D) of rows n wide, scaled by its columns w (D,)
    (``rmsnorm.rmsnorm_split``)."""
    return _rn.rmsnorm_split(x, w, group, n, eps=eps)


def ssd(x, dt, A, Bm, Cm, D_skip, *, chunk: int = 128,
        return_final_state: bool = False):
    """Mamba2 SSD scan. x: (B, S, H, P); dt: (B, S, H) float32; A, D_skip:
    (H,) float32; Bm, Cm: (B, S, G, N). Returns y (B, S, H, P) and, with
    ``return_final_state``, the (B, H, P, N) float32 state after the last
    token (the prefill path)."""
    return _ssd.ssd_scan(x, dt, A, Bm, Cm, D_skip, chunk=chunk,
                         return_final_state=return_final_state)
