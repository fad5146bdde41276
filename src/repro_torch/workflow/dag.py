"""Stage-DAG workflow specs: fork-join graphs of partitionable workloads.

Every node is a workload with its own channel fleet (its own ``(mus,
sigmas)`` and completion-time family), every edge a precedence constraint.
Stage v starts when all its predecessors have finished:

    C_v = R_v + D_v,      R_v = max_{u in preds(v)} C_u   (0 at sources)

and the makespan is ``M = max_{v in sinks} C_v``. A single predecessor adds
moments exactly (``D_v`` is independent of everything upstream); a join
moment-matches each ``C_u`` to a Gaussian and folds them pairwise with
Clark's two-Gaussian max (``core.maxstat.clark_max_moments_2``), in the
order of the predecessor list. The fold loses the max's skew and treats
branches below a common fork as independent (which biases the composed
mean upward); the JAX package's ``workflow/dag.py`` docstring bounds both
against a Monte-Carlo oracle.

:func:`compose_structure` is plain tensor code over a leading batch axis of
starts ``(R, S)`` and differentiable by autograd: the joint solver takes the
makespan's gradient in every stage's ``(mu, var)`` through it. Validation
errors and messages are the JAX package's: a spec error raises
:class:`DAGValidationError` at construction.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterable, List, Sequence, Tuple

import numpy as np
import torch

from ..core.distributions import get_family, resolve_family
from ..core.maxstat import clark_max_moments_2

__all__ = ["DAGValidationError", "Stage", "StageDAG", "compose_structure",
           "linear_edges"]

MAX_DEPTH_DEFAULT = 64


class DAGValidationError(ValueError):
    """A workflow spec failed validation (cycle, depth, unknown node, ...)."""


@dataclass(frozen=True)
class Stage:
    """One workload node: K channels with per-unit-work statistics
    ``mus``/``sigmas`` (float64 numpy) and a completion-time ``family`` (a
    name or a ``ChannelFamily``). Stages of one DAG may differ in K and in
    family."""

    name: str
    mus: np.ndarray
    sigmas: np.ndarray
    family: object = "normal"

    def __post_init__(self):
        object.__setattr__(self, "mus", np.asarray(self.mus, np.float64))
        object.__setattr__(self, "sigmas",
                           np.asarray(self.sigmas, np.float64))
        if self.mus.ndim != 1 or self.mus.shape != self.sigmas.shape:
            raise DAGValidationError(
                f"stage {self.name!r}: mus/sigmas must be matching 1-D "
                f"arrays, got {self.mus.shape} vs {self.sigmas.shape}")
        if self.mus.shape[0] < 1:
            raise DAGValidationError(f"stage {self.name!r} has no channels")
        if not np.all(self.mus > 0):
            raise DAGValidationError(
                f"stage {self.name!r}: channel means must be positive")
        get_family(self.family)  # fail fast on an unknown family spec

    @property
    def k(self) -> int:
        return self.mus.shape[0]

    @property
    def dist_id(self) -> str:
        return resolve_family(self.family, self.k)[0]


def linear_edges(names: Sequence[str]) -> List[Tuple[str, str]]:
    """Edges of a simple pipeline: each stage precedes the next."""
    return [(a, b) for a, b in zip(names[:-1], names[1:])]


class StageDAG:
    """A validated stage graph and its moment composition.

    ``stages`` order is the stage index of every (S,)-shaped array in the
    solver; ``edges`` are (upstream, downstream) name pairs. Construction
    checks unique names, known endpoints, no self-loops or duplicate edges,
    acyclicity (the error names a cycle) and the depth bound (the longest
    chain of stages <= ``max_depth``).
    """

    def __init__(self, stages: Sequence[Stage],
                 edges: Iterable[Tuple[str, str]] = (),
                 max_depth: int = MAX_DEPTH_DEFAULT):
        stages = tuple(stages)
        names = [s.name for s in stages]
        if len(set(names)) != len(names):
            dupes = sorted({n for n in names if names.count(n) > 1})
            raise DAGValidationError(f"duplicate stage names: {dupes}")
        self.stages: Tuple[Stage, ...] = stages
        self.names: Tuple[str, ...] = tuple(names)
        self.index: Dict[str, int] = {n: i for i, n in enumerate(names)}
        self.edges: Tuple[Tuple[str, str], ...] = self._check_edges(edges)
        self._preds: Dict[str, List[str]] = {n: [] for n in names}
        self._succs: Dict[str, List[str]] = {n: [] for n in names}
        for u, v in self.edges:
            self._preds[v].append(u)
            self._succs[u].append(v)
        self.topo_order: Tuple[str, ...] = self._toposort()
        self.depth: int = self._longest_chain()
        if self.depth > max_depth:
            raise DAGValidationError(
                f"workflow depth {self.depth} exceeds the bound {max_depth} "
                f"(raise max_depth explicitly if this is intentional)")

    # ------------------------------------------------------------ validation
    def _check_edges(self, edges) -> Tuple[Tuple[str, str], ...]:
        seen, out = set(), []
        for u, v in edges:
            for n in (u, v):
                if n not in self.index:
                    raise DAGValidationError(
                        f"edge ({u!r}, {v!r}) references unknown stage {n!r}")
            if u == v:
                raise DAGValidationError(f"self-loop on stage {u!r}")
            if (u, v) in seen:
                raise DAGValidationError(f"duplicate edge ({u!r}, {v!r})")
            seen.add((u, v))
            out.append((u, v))
        return tuple(out)

    def _toposort(self) -> Tuple[str, ...]:
        """Kahn's algorithm, ties broken by declaration order; a cycle
        raises with its path."""
        indeg = {n: len(self._preds[n]) for n in self.names}
        ready = [n for n in self.names if indeg[n] == 0]
        order: List[str] = []
        while ready:
            n = ready.pop(0)
            order.append(n)
            for m in self._succs[n]:
                indeg[m] -= 1
                if indeg[m] == 0:
                    ready.append(m)
        if len(order) != len(self.names):
            raise DAGValidationError(
                "cycle detected: " + " -> ".join(self._find_cycle()))
        return tuple(order)

    def _find_cycle(self) -> List[str]:
        """A cycle's path by depth-first search (one exists)."""
        WHITE, GRAY, BLACK = 0, 1, 2
        color = {n: WHITE for n in self.names}
        stack: List[str] = []

        def dfs(n):
            color[n] = GRAY
            stack.append(n)
            for m in self._succs[n]:
                if color[m] == GRAY:
                    return stack[stack.index(m):] + [m]
                if color[m] == WHITE:
                    cyc = dfs(m)
                    if cyc:
                        return cyc
            stack.pop()
            color[n] = BLACK
            return None

        for n in self.names:
            if color[n] == WHITE:
                cyc = dfs(n)
                if cyc:
                    return cyc
        return ["<unreachable>"]  # pragma: no cover - a cycle exists

    def _longest_chain(self) -> int:
        depth = {n: 1 for n in self.names}
        for n in self.topo_order:
            for m in self._succs[n]:
                depth[m] = max(depth[m], depth[n] + 1)
        return max(depth.values()) if depth else 0

    @classmethod
    def from_names(cls, names: Sequence[str],
                   edges: Iterable[Tuple[str, str]] = (),
                   max_depth: int = MAX_DEPTH_DEFAULT) -> "StageDAG":
        """Structure only (unit placeholder statistics), for callers that
        bring their own per-stage execution."""
        stages = [Stage(n, np.ones(1), np.full(1, 0.1)) for n in names]
        return cls(stages, edges, max_depth=max_depth)

    # ------------------------------------------------------------ structure
    def predecessors(self, name: str) -> Tuple[str, ...]:
        return tuple(self._preds[name])

    def successors(self, name: str) -> Tuple[str, ...]:
        return tuple(self._succs[name])

    @property
    def sources(self) -> Tuple[str, ...]:
        return tuple(n for n in self.names if not self._preds[n])

    @property
    def sinks(self) -> Tuple[str, ...]:
        return tuple(n for n in self.names if not self._succs[n])

    @property
    def structure(self):
        """``(topo, preds, sinks)`` as stage indices: all the composition
        needs, and hashable."""
        topo = tuple(self.index[n] for n in self.topo_order)
        preds = tuple(tuple(self.index[u] for u in self._preds[n])
                      for n in self.names)
        sinks = tuple(self.index[n] for n in self.sinks)
        return topo, preds, sinks

    def with_stats(self, mus_by_stage: Dict[str, np.ndarray],
                   sigmas_by_stage: Dict[str, np.ndarray],
                   family_by_stage: Dict[str, object] = None) -> "StageDAG":
        """Same graph, fresh statistics (the balancer's per-tick rebuild)."""
        family_by_stage = family_by_stage or {}
        stages = [Stage(name=s.name,
                        mus=mus_by_stage.get(s.name, s.mus),
                        sigmas=sigmas_by_stage.get(s.name, s.sigmas),
                        family=family_by_stage.get(s.name, s.family))
                  for s in self.stages]
        return StageDAG(stages, self.edges, max_depth=self.depth)

    # ------------------------------------------------------------ composition
    def compose_moments(self, stage_mu, stage_var, return_nodes: bool = False):
        """(makespan mu, var) from per-stage duration moments (S,) or
        (R, S); see :func:`compose_structure`."""
        return compose_structure(self.structure, stage_mu, stage_var,
                                 return_nodes=return_nodes)

    def critical_path(self) -> List[str]:
        """The longest source-to-sink chain by summed stage means."""
        means = {s.name: float(np.mean(s.mus)) for s in self.stages}
        best = {n: (means[n], [n]) for n in self.names}
        for n in self.topo_order:
            for m in self._succs[n]:
                cand = best[n][0] + means[m]
                if cand > best[m][0]:
                    best[m] = (cand, best[n][1] + [m])
        sink = max(self.sinks, key=lambda n: best[n][0])
        return best[sink][1]


def _fold_max(items):
    """Sequential Clark fold of ``[(mu, var), ...]`` in list order (the
    pairwise max is order-dependent; the JAX package folds wide joins by a
    scan in this same order)."""
    m, v = items[0]
    for m2, v2 in items[1:]:
        m, v = clark_max_moments_2(m, torch.sqrt(torch.clamp_min(v, 1e-18)),
                                   m2, torch.sqrt(torch.clamp_min(v2, 1e-18)),
                                   device=m2.device)
    return m, v


def compose_structure(structure, stage_mu, stage_var,
                      return_nodes: bool = False):
    """Makespan ``(mu, var)`` over a ``StageDAG.structure``.

    ``stage_mu``/``stage_var``: float32 tensors (S,) or (R, S) with a
    leading batch of starts; every operation takes the batch at once.
    Series edges add moments, joins fold by Clark, and several sinks fold
    once more. Returns ``(mu, var)`` (shape of the batch), plus the per-node
    completion moments (..., S) when ``return_nodes``.
    """
    topo, preds, sinks = structure
    stage_mu = torch.as_tensor(stage_mu, dtype=torch.float32)
    stage_var = torch.as_tensor(stage_var, dtype=torch.float32,
                                device=stage_mu.device)
    n = stage_mu.shape[-1]
    comp_mu: List[object] = [None] * n
    comp_var: List[object] = [None] * n
    for i in topo:
        ps = preds[i]
        if not ps:
            comp_mu[i] = stage_mu[..., i]
            comp_var[i] = stage_var[..., i]
            continue
        if len(ps) == 1:
            rel_mu, rel_var = comp_mu[ps[0]], comp_var[ps[0]]
        else:
            rel_mu, rel_var = _fold_max([(comp_mu[p], comp_var[p])
                                         for p in ps])
        comp_mu[i] = rel_mu + stage_mu[..., i]
        comp_var[i] = rel_var + stage_var[..., i]
    if len(sinks) == 1:
        mk_mu, mk_var = comp_mu[sinks[0]], comp_var[sinks[0]]
    else:
        mk_mu, mk_var = _fold_max([(comp_mu[s], comp_var[s]) for s in sinks])
    if return_nodes:
        return (mk_mu, mk_var), (torch.stack(comp_mu, -1),
                                 torch.stack(comp_var, -1))
    return mk_mu, mk_var
