"""The ``torch.autograd.Function`` contract (RPA010-RPA012).

The port differentiates its kernels through hand-written
``torch.autograd.Function`` subclasses (the frontier adjoints, the model
kernels' backward kernels, the collectives' adjoints). Torch checks their
internal consistency only when a backward runs, and only the part that
run reaches: a missing backward raises at the first ``.backward()``, a
cotangent tuple of the wrong length raises "returned an incorrect number
of gradients", and a saved tensor nobody reads costs memory silently.
Three structural checks, on every class deriving from
``torch.autograd.Function`` (spelt in full, as ``autograd.Function`` or as
an imported ``Function``), old style (``forward(ctx, ...)``) and new style
(``forward(...)`` plus ``setup_context(ctx, inputs, output)``):

* **RPA010** — a ``forward`` with no ``backward`` (or ``vjp``): autograd
  raises at the first backward through it.
* **RPA011** — a tuple returned by ``backward`` whose length differs from
  ``forward``'s inputs (after ``ctx`` in the old style). A tuple with a
  starred element is not counted; ``(None,) * n`` is.
* **RPA012** — ``ctx.save_for_backward(a, b, ...)`` saves a different
  number of tensors than ``backward`` unpacks from ``ctx.saved_tensors``,
  or an unpacked name is never read (a tensor the forward keeps alive for
  nobody). A starred save (``ctx.save_for_backward(*outs[2:])``) is not
  counted; its unpacked names are still checked.

All resolution is within the class body, where torch looks.
"""
from __future__ import annotations

import ast
from typing import Iterator, List, Optional, Tuple

from ..framework import (
    Finding,
    FileContext,
    Project,
    class_methods,
    is_autograd_function,
    positional_params,
    register,
)


def _returned(fn) -> List[ast.Return]:
    """Return statements of ``fn`` itself (nested defs excluded)."""
    out: List[ast.Return] = []
    stack = list(fn.body)
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda, ast.ClassDef)):
            continue
        if isinstance(node, ast.Return) and node.value is not None:
            out.append(node)
        stack.extend(ast.iter_child_nodes(node))
    return out


def _tuple_len(node: ast.AST) -> Optional[int]:
    """Length of a returned tuple expression: ``(a, b)``, or ``(a,) * n``
    with a literal ``n``; None for anything else or a starred element."""
    if isinstance(node, ast.Tuple):
        if any(isinstance(e, ast.Starred) for e in node.elts):
            return None
        return len(node.elts)
    if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Mult):
        for tup, n in ((node.left, node.right), (node.right, node.left)):
            if (isinstance(n, ast.Constant) and isinstance(n.value, int)
                    and not isinstance(n.value, bool)):
                inner = _tuple_len(tup)
                if inner is not None:
                    return inner * n.value
    return None


def _saves(methods) -> List[Tuple[ast.Call, Optional[int]]]:
    """Every ``<ctx>.save_for_backward(...)`` in ``forward`` and
    ``setup_context``, with the number of tensors it saves (None when an
    argument is starred)."""
    out = []
    for name in ("forward", "setup_context"):
        fn = methods.get(name)
        if fn is None:
            continue
        for node in ast.walk(fn):
            if (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr == "save_for_backward"):
                starred = any(isinstance(a, ast.Starred) for a in node.args)
                out.append((node, None if starred else len(node.args)))
    return out


def _unpack(bwd, ctx_name: str) -> Optional[Tuple[ast.Assign, List[str]]]:
    """(assign node, names) for ``a, b, ... = ctx.saved_tensors``."""
    for node in ast.walk(bwd):
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], (ast.Tuple, ast.List))
                and all(isinstance(e, ast.Name)
                        for e in node.targets[0].elts)
                and isinstance(node.value, ast.Attribute)
                and node.value.attr == "saved_tensors"
                and isinstance(node.value.value, ast.Name)
                and node.value.value.id == ctx_name):
            return node, [e.id for e in node.targets[0].elts]
    return None


def _names_loaded(fn, exclude) -> set:
    used = set()
    for node in ast.walk(fn):
        if node is exclude:
            continue
        if isinstance(node, ast.Name) and isinstance(node.ctx, ast.Load):
            used.add(node.id)
    return used


@register
class AutogradFunctionContractRule:
    CODES = {
        "RPA010": "autograd.Function has a forward but no backward",
        "RPA011": "backward's cotangent tuple arity != forward's input "
                  "count",
        "RPA012": "save_for_backward count != backward's saved_tensors "
                  "unpack, or a saved tensor unpacked but unused",
    }

    def run(self, project: Project) -> Iterator[Finding]:
        for ctx in project.files:
            for node in ast.walk(ctx.tree):
                if is_autograd_function(node):
                    yield from self._check_class(ctx, node)

    def _check_class(self, ctx: FileContext,
                     cls: ast.ClassDef) -> Iterator[Finding]:
        methods = class_methods(cls)
        forward = methods.get("forward")
        if forward is None:
            return
        bwd = methods.get("backward") or methods.get("vjp")
        if bwd is None:
            yield ctx.finding(
                cls, "RPA010",
                f"autograd.Function '{cls.name}' defines forward but no "
                f"backward — autograd raises at the first backward through "
                f"it")
            return
        new_style = "setup_context" in methods
        if forward.args.vararg is None:
            n_in = len(positional_params(forward.args)) - (0 if new_style
                                                            else 1)
            for ret in _returned(bwd):
                n = _tuple_len(ret.value)
                if n is not None and n != n_in:
                    yield ctx.finding(
                        ret, "RPA011",
                        f"'{cls.name}.backward' returns {n} cotangents but "
                        f"forward takes {n_in} inputs — torch raises "
                        f"'returned an incorrect number of gradients'")
        yield from self._check_saved(ctx, cls, methods, bwd)

    def _check_saved(self, ctx, cls, methods, bwd) -> Iterator[Finding]:
        pos = positional_params(bwd.args)
        if not pos:
            return
        unpack = _unpack(bwd, pos[0])
        if unpack is None:
            return
        node, names = unpack
        counts = [n for _, n in _saves(methods)]
        if counts and None not in counts and len(names) not in counts:
            saved = " or ".join(str(n) for n in sorted(set(counts)))
            yield ctx.finding(
                node, "RPA012",
                f"'{cls.name}.backward' unpacks {len(names)} saved tensors "
                f"but forward saves {saved}")
        used = _names_loaded(bwd, exclude=node)
        for nm in names:
            if not nm.startswith("_") and nm not in used:
                yield ctx.finding(
                    node, "RPA012",
                    f"saved tensor '{nm}' unpacked in "
                    f"'{cls.name}.backward' but never used — forward is "
                    f"keeping state nobody reads")
