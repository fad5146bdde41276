"""Documentation and import contracts (RPA040, RPA050).

* **RPA040** — documented-zero-cotangent check. The adjoint contract
  promises zero cotangents for specific inputs (the empirical family's
  mixture extras are solve constants, never descended). A backward
  returning an all-zeros cotangent (``torch.zeros_like(x)`` built and never
  updated) is either implementing that contract — in which case its
  docstring must SAY so — or silently dropping a gradient someone expects
  to flow. The rule inspects every function with ``bwd`` in its name and
  the ``backward`` of every ``torch.autograd.Function``, and fires when one
  returns an unmodified zeros cotangent and neither its docstring nor the
  enclosing module mentions the zero/stop-grad contract. A subscript store
  (``d_extra[0] = ...``) counts as an update of the zeros tensor.
* **RPA050** — deprecated-import ban. ``core.normal`` became a deprecation
  shim in the JAX package when the completion-time model went pluggable;
  code imports from ``core.distributions``. Every spelling is banned, for
  ``repro.core.normal`` and ``repro_torch.core.normal`` alike (absolute,
  ``from <pkg>.core import normal``, and the relative forms inside a core
  package). A shim module itself (``core/normal.py``) is exempt.
"""
from __future__ import annotations

import ast
import os
from typing import Dict, Iterator, Optional

from ..framework import (
    Finding,
    FileContext,
    Project,
    class_methods,
    is_autograd_function,
    register,
)

_ZERO_WORDS = ("zero", "stop-grad", "stop_grad", "stop gradient")


def _is_zeros_call(node: ast.AST) -> bool:
    return (isinstance(node, ast.Call)
            and isinstance(node.func, (ast.Attribute, ast.Name))
            and (node.func.attr if isinstance(node.func, ast.Attribute)
                 else node.func.id) in ("zeros_like", "zeros"))


def _assignments(fn) -> Dict[str, list]:
    """name -> value nodes stored to it anywhere in ``fn``; a store to a
    subscript of the name (``x[0] = v``) counts as one to the name."""
    out: Dict[str, list] = {}

    def store(target, value):
        if isinstance(target, ast.Subscript):
            target = target.value
        if isinstance(target, ast.Name):
            out.setdefault(target.id, []).append(value)

    for node in ast.walk(fn):
        if isinstance(node, ast.Assign):
            for t in node.targets:
                store(t, node.value)
        elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
            store(node.target, node.value)
    return out


def _documents_zero(*docstrings: Optional[str]) -> bool:
    for doc in docstrings:
        if doc and any(w in doc.lower() for w in _ZERO_WORDS):
            return True
    return False


def _backwards(tree: ast.AST) -> Iterator[ast.FunctionDef]:
    """Every function named with ``bwd``, and every autograd.Function's
    ``backward``."""
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                and "bwd" in node.name:
            yield node
        elif is_autograd_function(node):
            bwd = class_methods(node).get("backward")
            if bwd is not None:
                yield bwd


@register
class ZeroCotangentDocRule:
    CODES = {
        "RPA040": "bwd returns an all-zeros cotangent nothing documents",
    }

    def run(self, project: Project) -> Iterator[Finding]:
        for ctx in project.files:
            module_doc = ast.get_docstring(ctx.tree)
            for fn in _backwards(ctx.tree):
                yield from self._check_bwd(ctx, fn, module_doc)

    def _check_bwd(self, ctx, fn, module_doc) -> Iterator[Finding]:
        if _documents_zero(ast.get_docstring(fn), module_doc):
            return
        assigns = _assignments(fn)
        for node in ast.walk(fn):
            if not (isinstance(node, ast.Return)
                    and isinstance(node.value, ast.Tuple)):
                continue
            for i, elt in enumerate(node.value.elts):
                zero = _is_zeros_call(elt)
                if (not zero and isinstance(elt, ast.Name)
                        and len(assigns.get(elt.id, [])) == 1
                        and _is_zeros_call(assigns[elt.id][0])):
                    zero = True
                if zero:
                    yield ctx.finding(
                        node, "RPA040",
                        f"bwd '{fn.name}' returns an all-zeros cotangent "
                        f"(position {i}) but neither its docstring nor the "
                        f"module documents the stop-gradient contract")


def _in_core_package(path: str) -> bool:
    parts = os.path.normpath(path).split(os.sep)
    return "core" in parts


@register
class DeprecatedNormalImportRule:
    CODES = {
        "RPA050": "import of a deprecated core.normal shim",
    }

    _MSG = ("imports the deprecated repro_torch.core.normal shim — import "
            "from repro_torch.core.distributions instead (the primitives "
            "moved when the completion-time model became a pluggable "
            "ChannelFamily)")

    def run(self, project: Project) -> Iterator[Finding]:
        for ctx in project.files:
            # a shim module is the one legitimate holder of the old name
            if os.path.normpath(ctx.path).endswith(
                    os.path.join("core", "normal.py")):
                continue
            yield from self._check_file(ctx)

    def _check_file(self, ctx: FileContext) -> Iterator[Finding]:
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.Import):
                for alias in node.names:
                    if alias.name.endswith("core.normal"):
                        yield ctx.finding(node, "RPA050",
                                          f"'import {alias.name}' "
                                          f"{self._MSG}")
            elif isinstance(node, ast.ImportFrom):
                mod = node.module or ""
                tail = mod.split(".")[-1] if mod else ""
                if mod.endswith("core.normal"):
                    yield ctx.finding(node, "RPA050",
                                      f"'from {mod} import ...' {self._MSG}")
                elif (tail == "normal" and node.level >= 1
                      and _in_core_package(ctx.path)):
                    yield ctx.finding(node, "RPA050",
                                      f"relative import of '.normal' "
                                      f"{self._MSG}")
                elif any(a.name == "normal" for a in node.names) and (
                        tail == "core"
                        or (node.level >= 1 and not mod
                            and _in_core_package(ctx.path))):
                    yield ctx.finding(node, "RPA050",
                                      f"'from {mod or '.'} import normal' "
                                      f"{self._MSG}")
