"""Joint optimization of every stage split in a StageDAG.

The greedy baseline solves each stage alone and composes what comes out;
the joint solver descends the composed end-to-end makespan, so a stage that
feeds a join can trade a little expected time for less spread.

1. **Stack.** Every stage's iterate is one row of an ``(R, S, K_max)``
   weight stack (R starts, S stages, fleets zero-padded to ``K_max``: a
   ``w = 0`` channel drops out of the survival product, and a mask keeps
   padded weights at zero through the projection). Stages group by family
   (:func:`stack_rows`); a group's rows ride the per-row statistics layout
   of ``ops.frontier_moments_with_grads``, so each moment evaluation is ONE
   call per family group (two or three kernel launches on the card), never
   one per stage.
2. **Compose.** The per-stage ``(mu, var)`` flow through
   ``dag.compose_structure`` to the makespan; autograd runs over those
   O(S) series adds and Clark folds only, and the kernel adjoints chain by
   hand: ``dL/dW_s = dL/dmu_s dmu_s/dW_s + dL/dvar_s dvar_s/dW_s``.
3. **Descend.** Projected gradient on all stage simplices at once (masked
   Held projection), cosine step decay, multi-start, warm-startable.

The fidelity ladder, the triage (prune and dedupe), the plateau early stop,
incremental ``dirty`` re-solves with bitwise-frozen rows, sunk-work
``done`` re-solves and the risk-adjusted finalist pick are the JAX
package's ``workflow/solve.py``, step for step; its docstrings carry the
reasoning. Differences: the device chooses the path (``device="cuda"``
launches the CUDA kernels, ``"cpu"`` runs their plain versions); the PGD
phase is a Python loop, whose plateau test reads the stall count on the
host only at the steps where it could have reached the patience (each read
is one device synchronization, counted in ``SYNCS``); each phase is a
``solver.phase`` span (``obs.timed_span``) opened and closed after a device
synchronization, and ``profile["phase_us"]`` reads those spans, so the
profile and the trace are one measurement. The solve runs eagerly, so a
trace also shows each frontier call as a ``kernel.launch`` span inside its
phase (the JAX package's jitted solve shows phases alone). Under
``REPRO_SANITIZE=1`` the solve checks its starts and stage statistics once
on the host, and each PGD phase records its stage means, gradients and
iterates on the device at every step, read once after the phase
(``analysis/sanitize.py``).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import obs
from ..analysis import sanitize as _san
from ..core.bayes import nig_estimate_ses
from ..core.distributions import (family_from_extra, remaining_work_stats,
                                  resolve_family)
from ..core.partitioner import optimize_weights
from ..device import resolve_device
from ..kernels import ops
from ..obs import names as obs_names
from .dag import StageDAG, compose_structure

__all__ = ["DAGDecision", "solve_dag", "solve_dag_greedy", "evaluate_dag",
           "stack_rows", "SYNCS", "reset_syncs"]

# the coarse rung of the fidelity ladder: presolve and triage quadrature
_COARSE_NUM_T = 128
# step sizes of the presolve (cold starts) and of the refine (presolved,
# near-frontier iterates)
_PRESOLVE_LR = 0.05
_REFINE_LR = 0.005
# triage survivors whose stacks agree within this L-inf distance are one
# candidate
_DEDUPE_TOL = 5e-3

# host reads of the plateau test since the last reset_syncs(), and the PGD
# steps they were spread over
SYNCS = {"plateau": 0, "steps": 0}


def reset_syncs() -> None:
    for k in SYNCS:
        SYNCS[k] = 0


@dataclass(frozen=True)
class DAGDecision:
    """All stage splits plus the predicted end-to-end moments."""

    weights: Dict[str, np.ndarray]  # per-stage simplex weights (K_s,)
    makespan_mu: float
    makespan_var: float
    stage_mu: np.ndarray            # (S,) per-stage duration means
    stage_var: np.ndarray           # (S,)
    method: str
    family_groups: int = 1          # calls per moment evaluation
    fragility: Optional[float] = None
    profile: Optional[dict] = None  # per-phase wall times + solver counters

    @property
    def relative_fragility(self) -> Optional[float]:
        if self.fragility is None:
            return None
        return float(self.fragility / max(self.makespan_mu, 1e-12))


# --------------------------------------------------------------------- stack
@dataclass(frozen=True)
class _Group:
    """Rows sharing one dist_id: one stacked call serves them all."""

    dist_id: str
    idx: Tuple[int, ...]            # row indices into the stacked rows
    mus: np.ndarray                 # (n, Kmax) zero-padded, float32
    sigmas: np.ndarray              # (n, Kmax)
    extra: np.ndarray               # (E, n, Kmax)


def stack_rows(rows, kmax: Optional[int] = None
               ) -> Tuple[List[_Group], np.ndarray, int]:
    """Group ``(mus, sigmas, family)`` rows for stacked family calls.

    Channel counts may differ; every row zero-pads to ``kmax`` (the
    returned mask (N, kmax) marks the real channels). Rows group by lowered
    ``dist_id`` in first-appearance order and ``group.idx`` indexes back
    into ``rows``. A pinned ``kmax`` below a row's channel count raises.
    Returns ``(groups, mask, kmax)``.
    """
    rows = list(rows)
    ks = [int(np.asarray(m).shape[0]) for m, _, _ in rows]
    kmax = max(ks) if kmax is None else int(kmax)
    if ks and max(ks) > kmax:
        raise ValueError(f"row channel count {max(ks)} exceeds the pinned "
                         f"kmax={kmax}")
    N = len(rows)
    mask = np.zeros((N, kmax), np.float32)
    by_dist: Dict[str, List[int]] = {}
    lowered = []
    for i, (_, _, family) in enumerate(rows):
        dist_id, extra = resolve_family(family, ks[i])
        lowered.append((dist_id, np.asarray(extra, np.float32)))
        by_dist.setdefault(dist_id, []).append(i)
        mask[i, :ks[i]] = 1.0
    groups = []
    for dist_id, idx in by_dist.items():
        n = len(idx)
        E = lowered[idx[0]][1].shape[0]
        mus = np.zeros((n, kmax), np.float32)
        sgs = np.zeros((n, kmax), np.float32)
        ex = np.zeros((E, n, kmax), np.float32)
        for j, i in enumerate(idx):
            k = ks[i]
            mus[j, :k] = rows[i][0]
            sgs[j, :k] = rows[i][1]
            ex[:, j, :k] = lowered[i][1]
        groups.append(_Group(dist_id, tuple(idx), mus, sgs, ex))
    return groups, mask, kmax


def _stage_groups(dag: StageDAG) -> Tuple[List[_Group], np.ndarray, int]:
    """Group stages by family; returns (groups, mask (S, Kmax), Kmax)."""
    return stack_rows([(s.mus, s.sigmas, s.family) for s in dag.stages])


class _Stacks:
    """The groups' statistics on the device, tiled over R starts on demand
    in the JAX package's ``(r, j)`` row order (row ``r n + j`` is start r,
    stage j of the group)."""

    def __init__(self, groups: List[_Group], device: torch.device):
        self.groups = groups
        self.device = device
        self.stats = [tuple(torch.tensor(a, dtype=torch.float32,
                                         device=device)
                            for a in (g.mus, g.sigmas, g.extra))
                      for g in groups]
        self.idx = [torch.tensor(g.idx, dtype=torch.long, device=device)
                    for g in groups]
        self._tiled: Dict[Tuple[int, int], tuple] = {}

    def tiled(self, g: int, R: int):
        key = (g, R)
        if key not in self._tiled:
            m, s, e = self.stats[g]
            self._tiled[key] = (m.repeat(R, 1), s.repeat(R, 1),
                                e.repeat(1, R, 1))
        return self._tiled[key]

    def rows(self, W: torch.Tensor, g: int) -> torch.Tensor:
        R, _, kmax = W.shape
        return W[:, self.idx[g], :].reshape(R * len(self.groups[g].idx),
                                            kmax)


def _project_simplex_masked(v: torch.Tensor, mask: torch.Tensor
                            ) -> torch.Tensor:
    """Held projection of each row of v (..., K) onto the simplex of its
    ACTIVE (mask = 1) channels; inactive entries are pinned far below every
    active value, never enter the threshold and land on exactly zero."""
    k = v.shape[-1]
    vm = torch.where(mask > 0, v, -1e9)
    u = torch.sort(vm, dim=-1, descending=True).values
    css = torch.cumsum(u, dim=-1) - 1.0
    idx = torch.arange(1, k + 1, dtype=v.dtype, device=v.device)
    cond = u - css / idx > 0
    pos = torch.arange(k, device=v.device).expand_as(cond)
    # ranks that fail are filled with 0, not -1: rank 0 qualifies in any
    # finite row with an active channel, and a NaN row (all fail) then
    # projects to NaN for the sanitizer instead of gathering at -1
    rho = torch.amax(torch.where(cond, pos, 0), dim=-1, keepdim=True)
    theta = torch.gather(css, -1, rho) / (rho + 1.0)
    return torch.clamp_min(vm - theta, 0.0)


def _stage_moments_grads(W, stacks: _Stacks, num_t: int,
                         block_rows: Optional[int], param_grads=False):
    """Per-stage ``(mu, var, dmu_dW, dvar_dW)`` of W (R, S, Kmax): one
    stacked call per family group (with ``param_grads``, the 10-tuple's
    parameter adjoints too, as (R, S, Kmax) each)."""
    R, S, kmax = W.shape
    outs = None
    for g, grp in enumerate(stacks.groups):
        mus, sgs, ex = stacks.tiled(g, R)
        got = ops.frontier_moments_with_grads(
            stacks.rows(W, g), mus, sgs, num_t=num_t, device=stacks.device,
            block_rows=block_rows, family=(grp.dist_id, ex),
            param_grads=param_grads, _check=False)
        n = len(grp.idx)
        got = [o.reshape(R, n) if o.ndim == 1 else o.reshape(R, n, kmax)
               for o in got]
        if outs is None:
            outs = [W.new_zeros(o.shape[:1] + (S,) + o.shape[2:])
                    for o in got]
        for o, part in zip(outs, got):
            o[:, stacks.idx[g]] = part
    return outs


def _stage_moments(W, stacks: _Stacks, num_t: int,
                   block_rows: Optional[int]):
    """Per-stage ``(mu, var)``, each (R, S), of W: one forward call per
    family group."""
    R, S, kmax = W.shape
    smu = W.new_zeros((R, S))
    svar = W.new_zeros((R, S))
    for g, grp in enumerate(stacks.groups):
        mus, sgs, ex = stacks.tiled(g, R)
        with torch.no_grad():
            m, v = ops.frontier_moments(
                stacks.rows(W, g), mus, sgs, num_t=num_t,
                device=stacks.device, block_rows=block_rows,
                family=(grp.dist_id, ex), _check=False)
        n = len(grp.idx)
        smu[:, stacks.idx[g]] = m.reshape(R, n)
        svar[:, stacks.idx[g]] = v.reshape(R, n)
    return smu, svar


def _compose_grads(structure, smu, svar, lam32: float):
    """``(losses (R,), d/dsmu, d/dsvar)`` of ``mk_mu + lam mk_var`` through
    the composition: autograd over the folds, one scalar (the sum over
    starts, which are independent) differentiated once."""
    with torch.enable_grad():
        m = smu.detach().requires_grad_(True)
        v = svar.detach().requires_grad_(True)
        mk_mu, mk_var = compose_structure(structure, m, v)
        losses = mk_mu + lam32 * mk_var
        g_mu, g_var = torch.autograd.grad(losses.sum(), (m, v))
    return losses.detach(), g_mu, g_var


def _pgd_phase(structure, stacks: _Stacks, masks, W0, upd_np, lam_var: float,
               plateau_tol: float, steps: int, patience: int, num_t: int,
               composed: bool, lr: float = _PRESOLVE_LR, warmup: int = 0,
               block_rows: Optional[int] = None,
               checks: Optional[_san.LoopChecks] = None):
    """One masked-PGD phase over the stacked stage simplices.

    ``composed=False`` descends each stage's own expected join time (the
    presolve); ``composed=True`` the composed makespan. Rows of frozen
    stages (``upd_np == 0``) take no step: ``torch.where`` passes them
    through bitwise. The plateau stop ends the phase once the pool-best
    objective has failed to improve by a relative ``plateau_tol`` for
    ``patience`` steps in a row, counted past ``warmup``; the stall count
    lives on the device and is read only at steps where it could have
    reached ``patience`` (it grows by at most one a step past the warmup),
    so the steps run are those of the JAX package's ``lax.while_loop``.
    ``checks`` (the sanitizer's) records at every step that the stage
    means and the gradient are finite and the iterate on its simplices.

    Returns ``(W_final, W_best, best_loss, steps_run)``.
    """
    R = W0.shape[0]
    dev = W0.device
    masks_b = masks.expand_as(W0)
    upd_b = torch.as_tensor(upd_np > 0, device=dev)[None, :, None]
    lam32 = float(np.float32(lam_var))
    tol32 = float(np.float32(plateau_tol))
    lr32 = np.float32(lr)
    W, Wb = W0, W0
    # 1e30, not inf: inf - inf poisons the first plateau comparison
    row_best = torch.full((R,), 1e30, dtype=torch.float32, device=dev)
    pool_best = torch.full((), 1e30, dtype=torch.float32, device=dev)
    stall = torch.zeros((), dtype=torch.int32, device=dev)
    zero = torch.zeros_like(stall)
    i = 0
    while i < steps:
        if i - warmup >= patience:
            SYNCS["plateau"] += 1
            if int(stall) >= patience:
                break
        smu, svar, dmu, dvar = _stage_moments_grads(W, stacks, num_t,
                                                    block_rows)
        if composed:
            losses, g_mu, g_var = _compose_grads(structure, smu, svar, lam32)
            G = g_mu[..., None] * dmu + g_var[..., None] * dvar
        else:
            losses = torch.sum(smu, dim=1)
            G = dmu
        if checks is not None:
            checks.check_finite(smu, "DAG stage means", i)
            checks.check_finite(G, "DAG PGD gradient", i)
        better = losses < row_best
        Wb = torch.where(better[:, None, None], W, Wb)
        row_best = torch.minimum(row_best, losses)
        cur = torch.min(losses)
        if i < warmup:
            stall = zero
        else:
            moved = pool_best - cur > tol32 * torch.abs(pool_best)
            stall = torch.where(moved, zero, stall + 1)
        pool_best = torch.minimum(pool_best, cur)
        G = G / (torch.linalg.norm(G, dim=-1, keepdim=True) + 1e-12)
        ang = np.float32(math.pi) * np.float32(i) / np.float32(steps)
        step = lr32 * np.float32(0.5) * (np.float32(1.0) + np.cos(ang))
        W = torch.where(upd_b, _project_simplex_masked(W - float(step) * G,
                                                       masks_b), W)
        if checks is not None:
            checks.check_weight_rows(W, "DAG PGD iterate", i)
        SYNCS["steps"] += 1
        i += 1
    return W, Wb, row_best, i


def _score_dag(structure, stacks: _Stacks, W, num_t: int,
               block_rows: Optional[int]):
    """Composed (makespan mu, var), each (R,), and the stage moments of
    the candidates W (R, S, Kmax)."""
    smu, svar = _stage_moments(W, stacks, num_t, block_rows)
    with torch.no_grad():
        mk_mu, mk_var = compose_structure(structure, smu, svar)
    return mk_mu, mk_var, smu, svar


def _se_stacks(dag: StageDAG, groups, posteriors, kmax: int, device):
    """Per-group (se_mu, se_sigma) stacks (n, Kmax), float64 on device,
    zero-padded like the statistics."""
    ses = {}
    for name, nig in posteriors.items():
        se_mu, se_sg = nig_estimate_ses(nig)
        ses[name] = (se_mu.cpu().numpy().astype(np.float64),
                     se_sg.cpu().numpy().astype(np.float64))
    out = []
    for g in groups:
        n = len(g.idx)
        se_m = np.zeros((n, kmax))
        se_s = np.zeros((n, kmax))
        for j, i in enumerate(g.idx):
            s = dag.stages[i]
            if s.name in ses:
                se_m[j, :s.k], se_s[j, :s.k] = ses[s.name]
        out.append(tuple(torch.tensor(a, dtype=torch.float64, device=device)
                         for a in (se_m, se_s)))
    return out


def _dag_fragility(structure, stacks: _Stacks, se_stacks, W, smu, svar,
                   num_t: int, block_rows: Optional[int]) -> np.ndarray:
    """Delta-method sd of the predicted makespan mean under estimation
    error, per candidate (R,): the composition's cotangents at the scored
    ``smu``/``svar`` chained with every stage's parameter adjoints from one
    stacked full-parameter call per group; stages and channels add
    independently."""
    R, S, kmax = W.shape
    with torch.enable_grad():
        m = smu.detach().requires_grad_(True)
        v = svar.detach().requires_grad_(True)
        g_mu, g_var = torch.autograd.grad(
            compose_structure(structure, m, v)[0].sum(), (m, v))
    g_mu, g_var = g_mu.double()[..., None], g_var.double()[..., None]
    outs = _stage_moments_grads(W, stacks, num_t, block_rows,
                                param_grads=True)
    dmu_m, dvar_m, dmu_s, dvar_s = (o.double() for o in outs[4:8])
    se_m = torch.zeros((S, kmax), dtype=torch.float64, device=W.device)
    se_s = torch.zeros_like(se_m)
    for g, (m_g, s_g) in enumerate(se_stacks):
        se_m[stacks.idx[g]] = m_g
        se_s[stacks.idx[g]] = s_g
    cm = (g_mu * dmu_m + g_var * dvar_m) * se_m
    cs = (g_mu * dmu_s + g_var * dvar_s) * se_s
    frag2 = (cm ** 2).sum(dim=(1, 2)) + (cs ** 2).sum(dim=(1, 2))
    return torch.sqrt(frag2).cpu().numpy()


# --------------------------------------------------------------------- solve
def _dag_with_done(dag: StageDAG, done: Dict[str, np.ndarray]) -> StageDAG:
    """Rescale the named stages' statistics to their remaining work
    (``remaining_work_stats``); a fully done stage floors its means to a
    negligible point mass (Stage requires positive means)."""
    mus_by, sgs_by, fam_by = {}, {}, {}
    for s in dag.stages:
        if s.name not in done:
            continue
        dist_id, extra = resolve_family(s.family, s.k)
        mus_r, sgs_r, extra_r, _ = remaining_work_stats(
            dist_id, np.asarray(s.mus), np.asarray(s.sigmas),
            np.asarray(extra), np.asarray(done[s.name]))
        mus_by[s.name] = np.maximum(mus_r, 1e-9)
        sgs_by[s.name] = sgs_r
        fam_by[s.name] = family_from_extra(dist_id, extra_r)
    return dag.with_stats(mus_by, sgs_by, fam_by)


def _starts(dag: StageDAG, mask: np.ndarray, kmax: int, restarts: int,
            warm_start, seed: Optional[int],
            upd: Optional[np.ndarray] = None) -> np.ndarray:
    """(R, S, Kmax) float32 start stack: warm (if given), equal,
    inverse-mu, then ``restarts`` exponential draws normalized per stage
    from ``np.random.default_rng(seed)`` (``seed=None`` draws from 0). The
    JAX package seeds the same generator from the last word of its key's
    data, which for ``jax.random.PRNGKey(s)`` is s, so the two packages'
    starts are bitwise equal for the same seed. With ``upd`` (the dirty
    mask) the warm row is taken verbatim and every start's frozen rows are
    the warm rows."""
    S = len(dag.stages)
    act = mask.astype(np.float64)
    eq = act / act.sum(axis=1, keepdims=True)
    inv = np.zeros_like(eq)
    for i, s in enumerate(dag.stages):
        w = 1.0 / np.maximum(np.asarray(s.mus), 1e-12)
        inv[i, :s.k] = w / w.sum()
    starts = [eq, inv]
    if warm_start is not None:
        wm = np.zeros((S, kmax))
        for i, s in enumerate(dag.stages):
            w = np.asarray(warm_start[s.name], np.float64)
            if upd is None:
                w = np.maximum(w, 0.0)
                wm[i, :s.k] = w / max(w.sum(), 1e-12)
            else:
                wm[i, :s.k] = w
        starts.insert(0, wm)
    if restarts > 0:
        rng = np.random.default_rng(0 if seed is None else int(seed))
        for _ in range(restarts):
            e = rng.exponential(size=(S, kmax)) * act
            starts.append(e / np.maximum(e.sum(axis=1, keepdims=True),
                                         1e-12))
    out = np.stack(starts)
    if upd is not None:
        frozen = upd <= 0
        out[:, frozen, :] = out[0, frozen, :]
    return out.astype(np.float32)


class _PhaseClock:
    """Sequential ``solver.phase`` spans: ``lap(next)`` closes the open
    phase's span, books its duration into ``phase_us`` and opens the next.
    Each mark waits for the device first, so a phase's span holds its own
    device work; ``obs.timed_span`` always measures and records only when
    tracing is on, so ``phase_us`` and the trace are one measurement."""

    def __init__(self, phase_us: Dict[str, float], device: torch.device):
        self.phase_us = phase_us
        self.device = device
        self._open = None

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _enter(self, phase: str) -> None:
        self._open = obs.timed_span(obs_names.SPAN_SOLVER_PHASE,
                                    phase=phase).__enter__()

    def start(self, phase: str) -> None:
        self._sync()
        self._enter(phase)

    def lap(self, next_phase: Optional[str] = None) -> None:
        self._sync()
        sp = self._open
        sp.__exit__(None, None, None)
        self.phase_us[sp.attrs["phase"]] = round(sp.dur_us, 1)
        self._open = None
        if next_phase is not None:
            self._enter(next_phase)


def _check_inputs(W0: np.ndarray, groups) -> None:
    """The sanitizer's checks of a solve's inputs, on the host: the start
    stack's simplex rows and each family group's statistics."""
    _san.check_stacked_inputs(
        torch.from_numpy(W0),
        [(torch.from_numpy(g.mus), torch.from_numpy(g.sigmas))
         for g in groups])


def _check_dirty(dag: StageDAG, dirty, warm_start):
    dset = {str(n) for n in dirty}
    unknown = dset - {s.name for s in dag.stages}
    if unknown:
        raise KeyError(f"dirty stages not in the DAG: {sorted(unknown)}")
    if warm_start is None:
        raise ValueError("dirty= is an incremental re-solve and requires "
                         "warm_start")
    return dset


def solve_dag(dag: StageDAG, lam_var: float = 0.0, steps: int = 120,
              restarts: int = 2, num_t: int = 1024, device="cuda",
              block_rows: Optional[int] = None, seed: Optional[int] = None,
              warm_start: Optional[Dict[str, np.ndarray]] = None,
              risk_lam: float = 0.0,
              posteriors: Optional[Dict[str, object]] = None,
              presolve_steps: Optional[int] = None,
              eval_num_t: Optional[int] = None,
              done: Optional[Dict[str, np.ndarray]] = None,
              presolve_num_t: Optional[int] = None,
              prune_margin: Optional[float] = 5e-3,
              plateau_tol: float = 1e-6,
              plateau_patience: Optional[int] = 8,
              dirty: Optional[object] = None) -> DAGDecision:
    """Jointly optimize every stage's split for the end-to-end makespan.

    Objective ``makespan_mu + lam_var makespan_var`` through the ladder:
    stage-local presolve at ``presolve_num_t`` (default min(num_t, 128));
    coarse triage of {starts, presolve} on the composed objective (starts
    trailing the incumbent by more than ``prune_margin`` relative are
    dropped, near-duplicates collapse; the warm start always survives);
    composed refine of the survivors at ``num_t`` under the plateau stop
    (``plateau_patience=None`` runs every step); the final pick of the
    pool (refine inits, best-seen and final iterates) at ``eval_num_t``
    (default max(num_t, 2048)).

    ``seed`` takes the place of the JAX package's ``key``: the random
    starts are exponential draws from ``np.random.default_rng(seed)``,
    bitwise the JAX package's for ``key=jax.random.PRNGKey(seed)``.
    ``block_rows`` bounds the rows per chunk of the plain path (the CPU);
    on the card the launch plan comes from ``kernels.autotune``.

    ``dirty`` (with ``warm_start``) re-solves only the named stages; the
    other rows pass through bitwise, and an empty set returns the warm
    split verbatim from one forward evaluation with no PGD call.
    ``posteriors`` ({stage: NIGState}) report the winner's composed
    fragility, and with ``risk_lam > 0`` every finalist pays it. ``done``
    ({stage: per-channel completed fractions}) re-solves the remaining
    work. ``profile`` carries ``phase_us`` and the solver's counters.
    """
    dev = resolve_device(device)
    phase_us: Dict[str, float] = {}
    clock = _PhaseClock(phase_us, dev)
    clock.start("starts")
    if done:
        dag = _dag_with_done(dag, done)
    S = len(dag.stages)
    pnt = min(presolve_num_t if presolve_num_t is not None
              else _COARSE_NUM_T, num_t)
    et = eval_num_t or max(num_t, 2048)

    upd_np = None
    if dirty is not None:
        dset = _check_dirty(dag, dirty, warm_start)
        if not dset:
            # nothing moved: the warm split stands verbatim, one forward
            # evaluation for the reported moments, no PGD call
            clock.start("final_score")
            base = evaluate_dag(dag, warm_start, num_t=et, device=dev,
                                block_rows=block_rows)
            clock.lap()
            return DAGDecision(
                weights={s.name: np.asarray(warm_start[s.name],
                                            np.float64).copy()
                         for s in dag.stages},
                makespan_mu=base.makespan_mu,
                makespan_var=base.makespan_var,
                stage_mu=base.stage_mu, stage_var=base.stage_var,
                method="pgd-dag-noop", family_groups=base.family_groups,
                profile={"phase_us": phase_us, "noop": True, "starts": 0,
                         "survivors": 0, "pool": 1, "presolve_num_t": pnt,
                         "eval_num_t": et})
        upd_np = np.array([1.0 if s.name in dset else 0.0
                           for s in dag.stages], np.float32)

    groups, mask, kmax = _stage_groups(dag)
    stacks = _Stacks(groups, dev)
    masks = torch.tensor(mask, device=dev)
    W0_np = _starts(dag, mask, kmax, restarts, warm_start, seed, upd=upd_np)
    sanitize = _san.enabled()
    if sanitize:
        _check_inputs(W0_np, groups)
    W0 = torch.tensor(W0_np, device=dev)
    R = int(W0.shape[0])
    upd = upd_np if upd_np is not None else np.ones(S, np.float32)
    pre = presolve_steps if presolve_steps is not None else steps
    patience = (plateau_patience if plateau_patience is not None
                else max(steps, pre, 1))
    structure = dag.structure
    clock.lap("presolve")

    # --- stage-local presolve at the coarse rung; stalls count from the
    # middle of the cosine schedule
    checks = _san.LoopChecks(dev) if sanitize else None
    W1, _, _, n_pre = _pgd_phase(structure, stacks, masks, W0, upd, lam_var,
                                 plateau_tol, pre, patience, pnt, False,
                                 lr=_PRESOLVE_LR, warmup=pre // 2,
                                 block_rows=block_rows, checks=checks)
    if checks is not None:
        checks.raise_first()
    clock.lap("triage")

    # --- coarse triage of {starts, presolve} on the composed objective
    pool0 = torch.cat([W0, W1], dim=0)
    c_mu, c_var, _, _ = _score_dag(structure, stacks, pool0, pnt, block_rows)
    csc = c_mu.cpu().numpy().astype(np.float64) \
        + lam_var * c_var.cpu().numpy().astype(np.float64)
    per_start = np.minimum(csc[:R], csc[R:])
    W0h, W1h = W0.cpu().numpy(), W1.cpu().numpy()
    Wch = np.where((csc[R:] <= csc[:R])[:, None, None], W1h, W0h)
    if prune_margin is None:
        keep = np.ones(R, bool)
    else:
        inc = float(per_start.min())
        keep = per_start <= inc + prune_margin * max(abs(inc), 1e-12)
        keep[int(np.argmin(per_start))] = True
    chosen: List[int] = []
    for i in np.argsort(per_start, kind="stable"):
        if not keep[i]:
            continue
        if any(float(np.abs(Wch[i] - Wch[j]).max()) <= _DEDUPE_TOL
               for j in chosen):
            keep[i] = False
        else:
            chosen.append(int(i))
    if warm_start is not None:
        keep[0] = True   # the warm start is never lost to coarse triage
    survivors = int(keep.sum())
    Wr0 = torch.tensor(Wch[np.flatnonzero(keep)], device=dev)
    clock.lap("refine")

    # --- composed refine of the survivors at the solve fidelity
    checks = _san.LoopChecks(dev) if sanitize else None
    Wf, Wb, _, n_ref = _pgd_phase(structure, stacks, masks, Wr0, upd,
                                  lam_var, plateau_tol, steps, patience,
                                  num_t, True, lr=_REFINE_LR,
                                  warmup=steps // 2, block_rows=block_rows,
                                  checks=checks)
    if checks is not None:
        checks.raise_first()
    clock.lap("final_score")

    # --- final pick at evaluation fidelity
    cands = torch.cat([Wr0, Wb, Wf], dim=0)
    ncand = int(cands.shape[0])
    mk_mu, mk_var, smu, svar = _score_dag(structure, stacks, cands, et,
                                          block_rows)
    mk_mu_h = mk_mu.cpu().numpy()
    mk_var_h = mk_var.cpu().numpy()
    score = mk_mu_h.astype(np.float64) + lam_var * mk_var_h.astype(
        np.float64)
    clock.lap("fragility" if posteriors is not None else None)

    method = ("pgd-dag-joint-inc" if upd_np is not None else "pgd-dag-joint")
    frag = None
    frag_best = None
    if posteriors is not None:
        se_stacks = _se_stacks(dag, groups, posteriors, kmax, dev)
        if risk_lam > 0.0:
            frag = _dag_fragility(structure, stacks, se_stacks, cands, smu,
                                  svar, num_t, block_rows)
            score = score + risk_lam * frag
            method += "-risk"
    best = int(np.argmin(score))
    if frag is not None:
        frag_best = float(frag[best])
    elif posteriors is not None:
        # the reported fragility only: one single-row call for the winner
        fb = _dag_fragility(structure, stacks, se_stacks,
                            cands[best:best + 1], smu[best:best + 1],
                            svar[best:best + 1], num_t, block_rows)
        frag_best = float(fb[0])
    if posteriors is not None:
        clock.lap()

    Wbest = cands[best].cpu().numpy().astype(np.float64)
    weights = {s.name: Wbest[i, :s.k] for i, s in enumerate(dag.stages)}
    profile = {"phase_us": phase_us, "starts": R, "survivors": survivors,
               "pool": ncand, "presolve_num_t": pnt, "eval_num_t": et,
               "presolve_steps_run": int(n_pre),
               "refine_steps_run": int(n_ref)}
    return DAGDecision(
        weights=weights,
        makespan_mu=float(mk_mu_h[best]), makespan_var=float(mk_var_h[best]),
        stage_mu=smu[best].cpu().numpy().astype(np.float64),
        stage_var=svar[best].cpu().numpy().astype(np.float64),
        method=method, family_groups=len(groups),
        fragility=frag_best, profile=profile)


def evaluate_dag(dag: StageDAG, weights: Dict[str, np.ndarray],
                 num_t: int = 2048, device="cuda",
                 block_rows: Optional[int] = None) -> DAGDecision:
    """Composed moments of any per-stage split (each stage's weights are
    clipped at 0 and normalized): the shared evaluator that joint and
    greedy decisions are compared on."""
    dev = resolve_device(device)
    groups, mask, kmax = _stage_groups(dag)
    S = len(dag.stages)
    stacks = _Stacks(groups, dev)
    W = np.zeros((1, S, kmax), np.float32)
    for i, s in enumerate(dag.stages):
        w = np.maximum(np.asarray(weights[s.name], np.float64), 0.0)
        W[0, i, :s.k] = w / max(w.sum(), 1e-12)
    if _san.enabled():
        _check_inputs(W, groups)
    mk_mu, mk_var, smu, svar = _score_dag(
        dag.structure, stacks, torch.tensor(W, device=dev), num_t,
        block_rows)
    return DAGDecision(
        weights={s.name: np.asarray(W[0, i, :s.k], np.float64)
                 for i, s in enumerate(dag.stages)},
        makespan_mu=float(mk_mu[0]), makespan_var=float(mk_var[0]),
        stage_mu=smu[0].cpu().numpy().astype(np.float64),
        stage_var=svar[0].cpu().numpy().astype(np.float64),
        method="evaluate", family_groups=len(groups))


def solve_dag_greedy(dag: StageDAG, lam: float = 0.0, steps: int = 120,
                     restarts: int = 2, num_t: int = 1024, device="cuda",
                     eval_num_t: Optional[int] = None,
                     presolve_num_t: Optional[int] = None,
                     warm_start: Optional[Dict[str, np.ndarray]] = None,
                     dirty: Optional[object] = None) -> DAGDecision:
    """Stage-by-stage baseline: each stage solved alone on ``mu + lam var``
    of its own join time by ``core.partitioner.optimize_weights`` (a Python
    loop over independent solves), composed by the shared evaluator.
    ``presolve_num_t`` runs the stage solves at a coarse rung; ``dirty``
    (with ``warm_start``) copies the warm split for the other stages and
    re-solves the named ones warm. The restarts are the port solver's
    Dirichlet draws (``default_rng(0)``), not the JAX package's."""
    dev = resolve_device(device)
    dset = None if dirty is None else _check_dirty(dag, dirty, warm_start)
    solve_t = num_t if presolve_num_t is None else min(presolve_num_t, num_t)
    phase_us: Dict[str, float] = {}
    clock = _PhaseClock(phase_us, dev)
    clock.start("stage_solves")
    weights = {}
    for s in dag.stages:
        if dset is not None and s.name not in dset:
            weights[s.name] = np.asarray(warm_start[s.name],
                                         np.float64).copy()
            continue
        dec = optimize_weights(
            s.mus, s.sigmas, lam=lam, steps=steps, restarts=restarts,
            num_t=solve_t, family=s.family,
            warm_start=(None if warm_start is None
                        else warm_start.get(s.name)),
            eval_num_t=num_t, device=dev)
        weights[s.name] = dec.weights
    clock.lap("final_score")
    out = evaluate_dag(dag, weights, num_t=eval_num_t or max(num_t, 2048),
                       device=dev)
    clock.lap()
    return DAGDecision(
        weights=weights, makespan_mu=out.makespan_mu,
        makespan_var=out.makespan_var, stage_mu=out.stage_mu,
        stage_var=out.stage_var, method="greedy-per-stage",
        family_groups=out.family_groups,
        profile={"phase_us": phase_us, "solve_num_t": solve_t})
