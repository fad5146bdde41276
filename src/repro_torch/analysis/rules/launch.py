"""CUDA launch-shape audit of the kernel wrappers (RPA030-RPA032).

The JAX package audits its Pallas wrappers' VMEM working set at lint time;
the port's frontier kernels take their launch shape from a model instead
(:mod:`repro_torch.kernels.autotune`: ``pick_threads``, ``pick_split``,
``smem_bytes``, ``check_launch``), and a shape the card refuses surfaces
only as a launch error on the card. This rule runs the SAME model at lint
time, over every family x mode x stacked combination, so a change to the
model or to the kernels' shared memory that breaks a combination fails
the lint here, before any card sees it.

A *launch wrapper* is a function that hands the result of a C launcher
call (``err = lib.<launch>(...)``) to ``_cuda.check``. Wrappers that take
their shape from ``autotune.launch_plan`` are audited: a ``param_grads``
parameter means the fused adjoint (``grad`` and ``pgrad`` modes), otherwise
the forward moments (``fwd``). The audit point is the JAX package's, K =
1024 channels x T = 1024 grid points, at F = 3 rows with shared statistics
(a balancer refresh) and, stacked, at the largest serving row bucket.

* **RPA030** — the model's launch plan does not fit some audited
  combination: its dynamic shared memory passes ``SMEM_LIMIT_BYTES``, or
  ``check_launch`` (or the model itself) refuses the shape. The message
  names every failing (family, mode, stacked) combination and the widest
  block that fits them all.
* **RPA031** — a wrapper hands its launcher a block, chunk, split, tile or
  group count (a name such as ``n_blocks`` or ``splits``) made by floor
  division with neither a ``%`` guard on the divisor nor a ceiling
  division (``_cdiv``, or ``-(-a // b)``) in it or in the same-file helper
  that returns it: such a launch drops the tail. Sizes that are not counts
  (``rows = x.numel() // D``) are not audited.
* **RPA032** — NO launch shape fits some audited combination, at any
  thread count or pass-2 chunk: the kernels cannot launch at that scale at
  all, and the shared-memory model or the kernels need rework.
"""
from __future__ import annotations

import ast
from typing import Dict, Iterator, List, Optional, Tuple

from ..framework import (
    Finding,
    Project,
    call_name,
    dotted_name,
    param_names,
    register,
)

# the JAX package's audit point (its analysis/rules/vmem.py)
AUDIT_K = 1024
AUDIT_T = 1024
# rows of an audited call: shared statistics at a balancer refresh's F,
# stacked per-row statistics at the largest serving row bucket
AUDIT_F = {False: 3, True: 4096}

_COUNT_WORDS = {"blocks", "chunks", "splits", "tiles", "groups", "grid"}


def _audit_modes(has_param_grads: bool) -> Tuple[str, ...]:
    return ("grad", "pgrad") if has_param_grads else ("fwd",)


def model_plan(autotune, F: int, K: int, num_t: int, mode: str,
               dist_id: str):
    """``(threads, split, dynamic shared memory bytes)`` of the model's
    launch plan (``launch_plan`` without a cache entry), held by
    ``check_launch``; raises ValueError where either refuses it."""
    threads = autotune.pick_threads(num_t, mode, dist_id)
    split = autotune.pick_split(F, K, num_t, mode, dist_id)
    autotune.check_launch(threads, num_t, mode, dist_id, split)
    return threads, split, autotune.smem_bytes(threads, num_t, mode, dist_id,
                                               split)


def _candidates(autotune, num_t: int, mode: str) -> list:
    """Every launch shape worth trying at ``num_t``: pass-1 threads a power
    of two from 32 to ``MAX_THREADS``, and for the adjoint each pass-2 chunk
    a power of two from ``MIN_T_CHUNK`` to the grid."""
    threads = [32 << i for i in range(16) if 32 << i <= autotune.MAX_THREADS]
    chunks = [0]
    if mode != "fwd":
        top = 1 << max(num_t - 1, 0).bit_length()
        chunks = [autotune.MIN_T_CHUNK << i for i in range(32)
                  if autotune.MIN_T_CHUNK << i <= max(top,
                                                      autotune.MIN_T_CHUNK)]
    return [(t, autotune.GradSplit(autotune.MIN_POINTS, c, 32 if c else 0,
                                   1 if c else 0))
            for t in threads for c in chunks]


def _fits(autotune, shape, num_t: int, mode: str, dist_id: str) -> bool:
    try:
        autotune.check_launch(shape[0], num_t, mode, dist_id, shape[1])
    except ValueError:
        return False
    return True


def _audit(autotune, families, modes, K: int = AUDIT_K, T: int = AUDIT_T):
    """``(failing, infeasible, widest)`` over every family x mode x stacked
    combination: ``failing`` the combinations whose model plan does not
    fit, each with the bytes it needs or the refusal's text, ``infeasible``
    those no candidate fits, ``widest`` the most pass-1 threads some
    candidate fits at in every combination (None if none)."""
    failing, infeasible = [], []
    widest: Optional[set] = None
    for fam in families:
        for mode in modes:
            shapes = _candidates(autotune, T, mode)
            ok = [s for s in shapes if _fits(autotune, s, T, mode, fam)]
            th = {s[0] for s in ok}
            widest = th if widest is None else widest & th
            for stacked in (False, True):
                try:
                    _, _, need = model_plan(autotune, AUDIT_F[stacked], K, T,
                                            mode, fam)
                except ValueError as e:
                    failing.append((fam, mode, stacked, f" ({e})"))
                else:
                    if need > autotune.SMEM_LIMIT_BYTES:
                        failing.append((fam, mode, stacked, f"={need}B"))
                if not ok:
                    infeasible.append((fam, mode, stacked))
    return failing, infeasible, (max(widest) if widest else None)


def _combo(fam: str, mode: str, stacked: bool) -> str:
    return f"{fam}/{mode}{':stk' if stacked else ''}"


# ---------------------------------------------------------------------------
# the wrappers' launches
# ---------------------------------------------------------------------------

def _is_check(node: ast.AST) -> bool:
    return isinstance(node, ast.Call) and (
        dotted_name(node.func) or "").endswith("_cuda.check")


def _launches(fn) -> List[ast.Call]:
    """The C launcher calls of ``fn`` whose result ``_cuda.check`` reads."""
    checked = set()
    out = []
    for node in ast.walk(fn):
        if _is_check(node) and node.args:
            arg = node.args[0]
            if isinstance(arg, ast.Name):
                checked.add(arg.id)
            elif isinstance(arg, ast.Call) and isinstance(arg.func,
                                                          ast.Attribute):
                out.append(arg)
    for node in ast.walk(fn):
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)
                and node.targets[0].id in checked
                and isinstance(node.value, ast.Call)
                and isinstance(node.value.func, ast.Attribute)):
            out.append(node.value)
    return out


def _is_count(name: str) -> bool:
    parts = name.lower().split("_")
    return bool(_COUNT_WORDS & set(parts)) or (
        len(parts) > 1 and parts[0] in ("n", "num"))


def _floors(expr) -> List[ast.BinOp]:
    """Floor divisions in ``expr`` that are not half of ``-(-a // b)``."""
    return [n for n in ast.walk(expr)
            if isinstance(n, ast.BinOp) and isinstance(n.op, ast.FloorDiv)
            and not (isinstance(n.left, ast.UnaryOp)
                     and isinstance(n.left.op, ast.USub))]


def _has_ceil(expr) -> bool:
    for n in ast.walk(expr):
        if isinstance(n, ast.Call) and call_name(n) in ("_cdiv", "cdiv"):
            return True
        if (isinstance(n, ast.BinOp) and isinstance(n.op, ast.FloorDiv)
                and isinstance(n.left, ast.UnaryOp)
                and isinstance(n.left.op, ast.USub)):
            return True
    return False


def _has_mod_on(fn, names) -> bool:
    for node in ast.walk(fn):
        if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Mod):
            for side in (node.left, node.right):
                if any(isinstance(n, ast.Name) and n.id in names
                       for n in ast.walk(side)):
                    return True
    return False


def _returns(fn) -> List[ast.AST]:
    return [n.value for n in ast.walk(fn)
            if isinstance(n, ast.Return) and n.value is not None]


def _sources(fn, name: str, defs) -> List[Tuple[ast.AST, ast.AST]]:
    """``(expression, function holding it)`` for each value ``fn`` stores
    to ``name``: the assigned expression, its element in a tuple unpack,
    or the returned expression of a same-file helper it calls there."""
    out = []
    for node in ast.walk(fn):
        if not isinstance(node, ast.Assign) or len(node.targets) != 1:
            continue
        target, value = node.targets[0], node.value
        index = None
        if isinstance(target, ast.Tuple):
            names = [e.id if isinstance(e, ast.Name) else None
                     for e in target.elts]
            if name not in names:
                continue
            index = names.index(name)
        elif not (isinstance(target, ast.Name) and target.id == name):
            continue
        helper = (defs.get(call_name(value) or "")
                  if isinstance(value, ast.Call) else None)
        if helper is not None and helper is not fn:
            for ret in _returns(helper):
                if index is not None and isinstance(ret, ast.Tuple) \
                        and index < len(ret.elts):
                    ret = ret.elts[index]
                out.append((ret, helper))
        elif index is not None and isinstance(value, ast.Tuple) \
                and index < len(value.elts):
            out.append((value.elts[index], fn))
        elif index is None:
            out.append((value, fn))
    return out


def _launch_args(fn, call: ast.Call) -> List[ast.AST]:
    """The launcher's argument expressions, a starred local tuple opened."""
    args = []
    for a in list(call.args) + [kw.value for kw in call.keywords]:
        if isinstance(a, ast.Starred) and isinstance(a.value, ast.Name):
            for node in ast.walk(fn):
                if (isinstance(node, ast.Assign) and len(node.targets) == 1
                        and isinstance(node.targets[0], ast.Name)
                        and node.targets[0].id == a.value.id
                        and isinstance(node.value, ast.Tuple)):
                    args.extend(node.value.elts)
        else:
            args.append(a)
    return args


@register
class LaunchShapeRule:
    CODES = {
        "RPA030": "the launch plan's shared memory or shape does not fit "
                  "the card's limits",
        "RPA031": "launch count made by floor division without a "
                  "divisibility guard or a ceiling division",
        "RPA032": "no launch shape fits the card's limits at all",
    }

    def run(self, project: Project) -> Iterator[Finding]:
        # the model is imported lazily so the linter runs (minus this
        # audit) in an interpreter without torch
        try:
            from ...core.distributions import FAMILIES
            from ...kernels import autotune
        except ImportError:
            autotune = None
        for ctx in project.files:
            defs: Dict[str, ast.AST] = {
                n.name: n for n in ast.walk(ctx.tree)
                if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}
            for fn in defs.values():
                calls = _launches(fn)
                if not calls:
                    continue
                yield from self._check_counts(ctx, fn, defs, calls)
                if autotune is not None and any(
                        isinstance(n, ast.Call) and (dotted_name(n.func)
                                                     or "").endswith(
                            "autotune.launch_plan")
                        for n in ast.walk(fn)):
                    yield from self._check_plan(ctx, fn, FAMILIES, autotune)

    def _check_counts(self, ctx, fn, defs, calls) -> Iterator[Finding]:
        seen = set()
        for call in calls:
            for arg in _launch_args(fn, call):
                if not (isinstance(arg, ast.Name) and _is_count(arg.id)) \
                        or arg.id in seen:
                    continue
                seen.add(arg.id)
                for expr, holder in _sources(fn, arg.id, defs):
                    floors = _floors(expr)
                    if not floors or _has_ceil(expr):
                        continue
                    divisors = {n.id for f in floors
                                for n in ast.walk(f.right)
                                if isinstance(n, ast.Name)}
                    if _has_mod_on(holder, divisors) or any(
                            _has_mod_on(h, divisors) for h in defs.values()
                            if h is not holder and _calls_with(fn, h,
                                                               divisors)):
                        continue
                    yield ctx.finding(
                        call, "RPA031",
                        f"'{fn.name}' launches with '{arg.id}' = "
                        f"{ast.unparse(expr)}, a floor division with no "
                        f"'%' guard or ceiling division — the launch drops "
                        f"the tail")

    def _check_plan(self, ctx, fn, families, autotune) -> Iterator[Finding]:
        modes = _audit_modes("param_grads" in param_names(fn.args))
        failing, infeasible, widest = _audit(autotune, families, modes)
        limit = autotune.SMEM_LIMIT_BYTES
        if failing:
            combos = ", ".join(f"{_combo(fam, mode, stk)}{why}"
                               for fam, mode, stk, why in failing[:4])
            more = (f" (+{len(failing) - 4} more)" if len(failing) > 4
                    else "")
            hint = (f"widest block fitting every combo is {widest} threads"
                    if widest else "no block fits every combo")
            yield ctx.finding(
                fn, "RPA030",
                f"'{fn.name}' launch plan does not fit the {limit}-byte "
                f"shared memory a block may use at K={AUDIT_K}/T={AUDIT_T} "
                f"for {combos}{more}; {hint}")
        for fam, mode, stk in infeasible:
            yield ctx.finding(
                fn, "RPA032",
                f"'{fn.name}': no launch shape fits the {limit}-byte shared "
                f"memory a block may use for {_combo(fam, mode, stk)} at "
                f"K={AUDIT_K}/T={AUDIT_T} — the working set needs rework")


def _calls_with(fn, helper, names) -> bool:
    """Whether ``fn`` calls ``helper`` passing one of ``names``."""
    for node in ast.walk(fn):
        if isinstance(node, ast.Call) and call_name(node) == helper.name:
            vals = list(node.args) + [kw.value for kw in node.keywords]
            if any(isinstance(v, ast.Name) and v.id in names for v in vals):
                return True
    return False

