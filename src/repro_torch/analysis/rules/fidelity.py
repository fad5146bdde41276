"""Fidelity-knob threading (RPA070).

Quadrature resolution is the solve's price knob: the multi-fidelity ladder
in ``workflow.solve`` runs presolve/triage at a coarse ``num_t`` and final
scoring at ``eval_num_t``, and every layer between the public API and
``ops.frontier_moments`` / ``ops.frontier_moments_with_grads`` threads the
resolution it was given. A call site that hard-codes ``num_t=<literal>``
opts out of the ladder: it pins one rung no matter what fidelity the caller
asked for, and its autotune entry silently keys to the pinned ``T`` (the
coarse/fine rungs have distinct keys by design — see kernels/autotune.py).

* **RPA070** — a ``frontier_moments`` / ``frontier_moments_with_grads``
  call passing a literal constant ``num_t=`` must thread a variable (a
  parameter, a module-level knob, a config value) instead. Fixed-resolution
  figure reproductions are the legitimate exception; they take a pragma
  naming the figure. Files under a ``tests`` directory are exempt — a test
  pins its quadrature on purpose.
"""
from __future__ import annotations

import ast
import os
from typing import Iterator

from ..framework import Finding, Project, call_name, register

_TARGETS = {"frontier_moments", "frontier_moments_with_grads"}


def _in_tests(path: str) -> bool:
    parts = os.path.normpath(path).split(os.sep)
    return "tests" in parts


def _is_literal_int(node: ast.AST) -> bool:
    """A bare integer constant (the hard-coded rung this rule exists for).

    Arithmetic over constants (``2 * 1024``) counts too — it is still a
    pinned resolution, just spelled with more characters.
    """
    if isinstance(node, ast.Constant):
        return isinstance(node.value, int) and not isinstance(node.value,
                                                              bool)
    if isinstance(node, ast.BinOp):
        return _is_literal_int(node.left) and _is_literal_int(node.right)
    if isinstance(node, ast.UnaryOp):
        return _is_literal_int(node.operand)
    return False


@register
class FidelityKnobRule:
    CODES = {
        "RPA070": "frontier_moments call hard-codes num_t instead of "
                  "threading the fidelity knob",
    }

    def run(self, project: Project) -> Iterator[Finding]:
        for ctx in project.files:
            if _in_tests(ctx.path):
                continue
            for node in ast.walk(ctx.tree):
                if not isinstance(node, ast.Call):
                    continue
                if call_name(node) not in _TARGETS:
                    continue
                for kw in node.keywords:
                    if kw.arg == "num_t" and _is_literal_int(kw.value):
                        yield ctx.finding(
                            node, "RPA070",
                            f"'{call_name(node)}' pins num_t="
                            f"{ast.unparse(kw.value)} — thread the caller's "
                            f"fidelity knob (presolve_num_t / num_t / "
                            f"eval_num_t) so the multi-fidelity ladder "
                            f"reaches this launch")
