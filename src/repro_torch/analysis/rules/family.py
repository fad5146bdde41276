"""Family-threading completeness (RPA001, RPA002).

The completion-time family is pluggable: every layer between the public
API and the kernels must accept ``family=`` (or the lowered ``dist_id``)
and pass it on, or the call silently falls back to the normal family —
numerically plausible, quietly wrong for lognormal/drift/empirical fleets.

* **RPA001** — a function whose signature carries channel statistics (both
  ``mus`` and ``sigmas`` parameters) must also carry ``family`` or
  ``dist_id``. Pure layout helpers that never evaluate a CDF are the
  legitimate exceptions; they take a pragma.
* **RPA002** — inside a family-aware function, any call that hands ``mus``
  or ``sigmas`` to another family-aware callable must forward ``family=`` /
  ``dist_id=`` (keyword, positionally, or via ``**kwargs``) — otherwise the
  callee applies ITS default and the caller's family stops at this frame.
  ``X.apply(...)`` of a ``torch.autograd.Function`` is resolved to
  ``X.forward`` without its ``ctx``: ``apply`` takes positional arguments
  only, so a ``dist_id`` in the right place is forwarded.
"""
from __future__ import annotations

import ast
from typing import Iterator, Optional

from ..framework import (
    Finding,
    Project,
    call_name,
    class_methods,
    keyword_or_positional,
    param_names,
    register,
)

_STATS = {"mus", "sigmas"}
_FAMILY = {"family", "dist_id"}


@register
class FamilyThreadingRule:
    CODES = {
        "RPA001": "function takes mus/sigmas but no family/dist_id parameter",
        "RPA002": "mus/sigmas passed on without forwarding family/dist_id",
    }

    def run(self, project: Project) -> Iterator[Finding]:
        index = project.family_aware_callables()
        functions = project.autograd_functions()
        for ctx in project.files:
            for node in ast.walk(ctx.tree):
                if not isinstance(node, (ast.FunctionDef,
                                         ast.AsyncFunctionDef)):
                    continue
                names = set(param_names(node.args))
                if not _STATS <= names:
                    continue
                if not _FAMILY & names:
                    yield ctx.finding(
                        node, "RPA001",
                        f"'{node.name}' takes mus/sigmas but no "
                        f"family/dist_id parameter — callees will apply the "
                        f"normal-family default")
                    continue
                yield from self._check_forwarding(ctx, node, index,
                                                  functions)

    def _check_forwarding(self, ctx, node, index,
                          functions) -> Iterator[Finding]:
        for call in ast.walk(node):
            if not isinstance(call, ast.Call):
                continue
            callee = call_name(call)
            if callee is None or callee == node.name:
                continue
            callee_args = _apply_args(call, functions)
            if callee_args is not None:
                callee = f"{call.func.value.id}.apply"
                if not _FAMILY & set(param_names(callee_args)):
                    continue
            else:
                callee_args = index.get(callee)
            if callee_args is None:
                continue
            if not _passes_stats(call):
                continue
            if keyword_or_positional(call, callee_args, _FAMILY):
                continue
            yield ctx.finding(
                call, "RPA002",
                f"'{node.name}' passes mus/sigmas to family-aware "
                f"'{callee}' without forwarding family/dist_id — the "
                f"callee's default family takes over here")


def _apply_args(call: ast.Call, functions) -> Optional[ast.arguments]:
    """``X.forward``'s arguments without ``ctx`` for a call ``X.apply(...)``
    of an autograd.Function ``X`` (``forward`` without ``ctx`` where the
    class has ``setup_context``), else None."""
    func = call.func
    if not (isinstance(func, ast.Attribute) and func.attr == "apply"
            and isinstance(func.value, ast.Name)
            and func.value.id in functions):
        return None
    methods = class_methods(functions[func.value.id])
    forward = methods.get("forward")
    if forward is None:
        return None
    args = forward.args
    if "setup_context" in methods:
        return args
    pos = args.posonlyargs + args.args
    if not pos:
        return args
    drop = 1 if args.posonlyargs else 0
    return ast.arguments(posonlyargs=args.posonlyargs[drop:],
                         args=args.args[1 - drop:], vararg=args.vararg,
                         kwonlyargs=args.kwonlyargs,
                         kw_defaults=args.kw_defaults, kwarg=args.kwarg,
                         defaults=args.defaults)


def _passes_stats(call: ast.Call) -> bool:
    """True when any argument is literally the local name mus or sigmas."""
    for arg in call.args:
        if isinstance(arg, ast.Name) and arg.id in _STATS:
            return True
    for kw in call.keywords:
        if isinstance(kw.value, ast.Name) and kw.value.id in _STATS:
            return True
    return False
