"""Serving-path batching discipline (RPA080).

The serving tier batches continuously: every live workflow instance's
remaining stages ride ONE stacked ``ops.frontier_moments*`` launch per
completion-time family per tick (``workflow.solve.stack_rows`` +
``serve.engine.row_pgd_step``). The anti-pattern is the per-instance /
per-stage Python loop paying one kernel launch — dispatch, autotune
lookup, scratch allocation — per workflow, which is exactly the cost the
stacked ``(F, K)`` row layout exists to amortize.

* **RPA080** — in a file under a ``serve`` directory, a
  ``frontier_moments`` / ``frontier_moments_with_grads`` call must not
  appear lexically inside a ``for`` / ``while`` loop (comprehensions
  included): stack the rows and launch once per family group instead. The
  per-family-group loop is fine — its body calls the stacked helper, not
  the kernel entry point. Tests are exempt; a deliberate exception (e.g. a
  documented baseline) takes a pragma.
"""
from __future__ import annotations

import ast
import os
from typing import Iterator

from ..framework import Finding, Project, call_name, register

_TARGETS = {"frontier_moments", "frontier_moments_with_grads"}
_LOOPS = (ast.For, ast.AsyncFor, ast.While, ast.ListComp, ast.SetComp,
          ast.DictComp, ast.GeneratorExp)


def _serving_path(path: str) -> bool:
    parts = os.path.normpath(path).split(os.sep)
    return "serve" in parts and "tests" not in parts


@register
class ServingBatchRule:
    CODES = {
        "RPA080": "frontier_moments launched inside a per-instance Python "
                  "loop under serve/ — stack rows, one launch per family "
                  "group",
    }

    def run(self, project: Project) -> Iterator[Finding]:
        for ctx in project.files:
            if not _serving_path(ctx.path):
                continue
            seen = set()
            for loop in ast.walk(ctx.tree):
                if not isinstance(loop, _LOOPS):
                    continue
                for node in ast.walk(loop):
                    if not isinstance(node, ast.Call):
                        continue
                    if call_name(node) not in _TARGETS:
                        continue
                    if id(node) in seen:
                        continue
                    seen.add(id(node))
                    yield ctx.finding(
                        node, "RPA080",
                        f"'{call_name(node)}' inside a loop on the serving "
                        f"path pays one kernel launch per iteration — stack "
                        f"the rows (workflow.solve.stack_rows) and launch "
                        f"once per family group per tick")
