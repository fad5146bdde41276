"""Family-coverage completeness (RPA060).

RPA001/002 catch a *call site* that drops the family spec; they cannot catch
a whole *family* that was added to ``core.distributions.FAMILIES`` but never
taught to one of the layers that must understand every ``dist_id``. That is
how a new family ships half-implemented: the kernels fall through to a
default branch, the sim has no generating regime for it, and the first
symptom is a benchmark whose "ground truth" quietly ran a different
distribution than the solver priced.

**RPA060** — every family name in the ``FAMILIES`` tuple (parsed from
``core/distributions.py``, never imported) must appear as a word in each of
the threading sites of the same package:

* ``kernels/ref.py``           — the quadrature oracle,
* ``kernels/frontier_grid.py`` — the kernel wrappers,
* ``kernels/ops.py``           — the custom VJP (an autograd.Function),
* ``kernels/autotune.py``      — plan keys + sweep coverage,
* ``sim/cluster.py``           — the ground-truth generator,
* ``csrc/family.cuh``          — the CUDA kernels' family branches, read as
  text beside the package root (the lint collects ``*.py`` files only).

Each ``core/distributions.py`` is paired with the sites under its own
package root, so linting ``src/`` checks the JAX package and the port each
against its own registry. A site a lint run does not hold is skipped.

A site that legitimately handles a family through a fully generic path can
carry a ``# repro: allow[RPA060]`` pragma at the top of the file with the
justification (none do today).
"""
from __future__ import annotations

import ast
import os
import re
from typing import Iterator, Optional, Sequence

from ..framework import Finding, Project, register

# site suffix -> what the mention proves there
_SITES = (
    ("kernels/ref.py", "reference oracle"),
    ("kernels/frontier_grid.py", "kernel wrappers"),
    ("kernels/ops.py", "custom VJP"),
    ("kernels/autotune.py", "autotune keys/sweep"),
    ("sim/cluster.py", "sim ground truth"),
)
_CUDA_SITE = ("csrc/family.cuh", "CUDA kernels")

_FAMILIES_SRC = "core/distributions.py"


def _parse_families(source: str) -> Optional[Sequence[str]]:
    """The FAMILIES tuple, read statically from the distributions module."""
    tree = ast.parse(source)
    for node in ast.walk(tree):
        if not isinstance(node, ast.Assign):
            continue
        if not any(isinstance(t, ast.Name) and t.id == "FAMILIES"
                   for t in node.targets):
            continue
        try:
            value = ast.literal_eval(node.value)
        except ValueError:
            return None
        if isinstance(value, (tuple, list)) and \
                all(isinstance(v, str) for v in value):
            return tuple(value)
    return None


def _norm(path: str) -> str:
    return os.path.normpath(path).replace("\\", "/")


def _missing(families, source: str):
    return [fam for fam in families
            if not re.search(rf"\b{re.escape(fam)}\b", source)]


def _message(fam: str, suffix: str, role: str) -> str:
    return (f"family '{fam}' (core.distributions.FAMILIES) is never "
            f"mentioned in {suffix} ({role}) — a dist_id this layer does not "
            f"know falls through to a default branch and silently prices "
            f"the wrong distribution")


@register
class FamilyCoverageRule:
    CODES = {
        "RPA060": "family in FAMILIES is never mentioned in a threading site",
    }

    def run(self, project: Project) -> Iterator[Finding]:
        by_path = {_norm(ctx.path): ctx for ctx in project.files}
        for norm, dist_ctx in sorted(by_path.items()):
            if not (norm == _FAMILIES_SRC
                    or norm.endswith("/" + _FAMILIES_SRC)):
                continue
            root = norm[:-len(_FAMILIES_SRC)]
            families = _parse_families(dist_ctx.source)
            if not families:
                yield dist_ctx.finding(
                    1, "RPA060",
                    "FAMILIES tuple is not a literal tuple of strings — the "
                    "coverage rule cannot enumerate the registry")
                continue
            for suffix, role in _SITES:
                ctx = by_path.get(root + suffix)
                if ctx is None:
                    continue
                for fam in _missing(families, ctx.source):
                    yield ctx.finding(1, "RPA060",
                                      _message(fam, suffix, role))
            suffix, role = _CUDA_SITE
            cuh = os.path.join(os.path.dirname(os.path.dirname(
                dist_ctx.path)), *suffix.split("/"))
            try:
                with open(cuh, encoding="utf-8") as fh:
                    text = fh.read()
            except OSError:
                continue
            for fam in _missing(families, text):
                yield Finding(path=cuh, line=1, code="RPA060",
                              message=_message(fam, suffix, role))
