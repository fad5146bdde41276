"""Rule registry, findings, pragmas and reporters for ``repro_torch.analysis``.

The JAX package's ``analysis/framework.py``, for the port's own rule set.
A *rule* is a class with a ``CODES`` mapping (``{"RPA0xx": "one-line
description"}``) and a ``run(project)`` generator yielding
:class:`Finding`s; registration is the :func:`register` decorator. A
:class:`Project` is the parsed view of every ``*.py`` file under the
linted paths (one :class:`FileContext` per file: source, line table,
``ast`` tree, pragma map), built once and shared by all rules.

Suppression is per-line and per-code, with the JAX package's spelling, so
one pragma serves both linters: a finding at ``(path, line)`` is dropped
when that line, or the contiguous comment block directly above it, carries
an allowlist pragma::

    some_flagged_code()  # repro: allow[RPA001] one-line justification
    # repro: allow[RPA040,RPA050] pragma-above form, multiple codes

Pragmas name the exact code (no wildcards), and the text after the bracket
is the justification.

Shared AST helpers used by several rules (dotted-name resolution,
parameter extraction, ``torch.autograd.Function`` classes) live here too,
so the rule modules stay single-purpose.
"""
from __future__ import annotations

import ast
import dataclasses
import json
import os
import re
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

__all__ = [
    "Finding",
    "FileContext",
    "Project",
    "register",
    "all_rules",
    "rule_codes",
    "collect_files",
    "build_project",
    "run_project",
    "run_paths",
    "format_text",
    "format_json",
    "call_name",
    "dotted_name",
    "param_names",
    "positional_params",
    "keyword_or_positional",
    "is_autograd_function",
    "class_methods",
]

_PRAGMA_RE = re.compile(r"#\s*repro:\s*allow\[([A-Za-z0-9_,\s]+)\]")


@dataclasses.dataclass(frozen=True, order=True)
class Finding:
    """One rule violation at a file/line, identified by its RPA code."""

    path: str
    line: int
    code: str
    message: str

    def format(self) -> str:
        return f"{self.path}:{self.line}: {self.code} {self.message}"

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


class FileContext:
    """Parsed view of one source file: tree, line table, pragma map."""

    def __init__(self, path: str, source: str):
        self.path = path
        self.source = source
        self.lines = source.splitlines()
        self.tree = ast.parse(source, filename=path)
        self.allow: Dict[int, set] = {}
        for lineno, text in enumerate(self.lines, start=1):
            m = _PRAGMA_RE.search(text)
            if m:
                self.allow[lineno] = {c.strip() for c in m.group(1).split(",")
                                      if c.strip()}

    def allowed(self, line: int, code: str) -> bool:
        """True when an allow pragma names ``code`` on the line itself or in
        the contiguous comment block directly above it."""
        if code in self.allow.get(line, ()):
            return True
        ln = line - 1
        while 1 <= ln <= len(self.lines) \
                and self.lines[ln - 1].lstrip().startswith("#"):
            if code in self.allow.get(ln, ()):
                return True
            ln -= 1
        return False

    def finding(self, node_or_line, code: str, message: str) -> Finding:
        line = getattr(node_or_line, "lineno", node_or_line)
        return Finding(path=self.path, line=int(line), code=code,
                       message=message)


class Project:
    """All files of one lint run, plus cross-file indexes rules may share."""

    def __init__(self, contexts: Sequence[FileContext]):
        self.files: Tuple[FileContext, ...] = tuple(contexts)
        self._family_aware: Optional[Dict[str, ast.arguments]] = None
        self._functions: Optional[Dict[str, ast.ClassDef]] = None

    def family_aware_callables(self) -> Dict[str, ast.arguments]:
        """Bare name -> arguments for every def with a family/dist_id param.

        Keyed by bare (unqualified) name because call sites spell
        ``ops.frontier_moments`` / ``frontier_moments`` / ``self.solve``
        interchangeably; first definition wins on collisions, which is
        adequate at lint precision.
        """
        if self._family_aware is None:
            index: Dict[str, ast.arguments] = {}
            for ctx in self.files:
                for node in ast.walk(ctx.tree):
                    if isinstance(node, (ast.FunctionDef,
                                         ast.AsyncFunctionDef)):
                        names = param_names(node.args)
                        if "family" in names or "dist_id" in names:
                            index.setdefault(node.name, node.args)
            self._family_aware = index
        return self._family_aware

    def autograd_functions(self) -> Dict[str, ast.ClassDef]:
        """Class name -> definition of every ``torch.autograd.Function``
        subclass in the project (first definition wins), the index that
        resolves ``X.apply(...)`` to ``X.forward``."""
        if self._functions is None:
            index: Dict[str, ast.ClassDef] = {}
            for ctx in self.files:
                for node in ast.walk(ctx.tree):
                    if is_autograd_function(node):
                        index.setdefault(node.name, node)
            self._functions = index
        return self._functions


_REGISTRY: List[type] = []


def register(cls: type) -> type:
    """Class decorator adding a rule to the global registry."""
    _REGISTRY.append(cls)
    return cls


def _ensure_rules_loaded() -> None:
    # importing the rules package runs every @register decorator exactly once
    from . import rules  # noqa: F401


def all_rules() -> list:
    """Fresh instances of every registered rule, registration order."""
    _ensure_rules_loaded()
    return [cls() for cls in _REGISTRY]


def rule_codes() -> Dict[str, str]:
    """Every known code -> one-line description (the --list-rules table)."""
    out: Dict[str, str] = {}
    for rule in all_rules():
        out.update(rule.CODES)
    return dict(sorted(out.items()))


# ---------------------------------------------------------------------------
# project construction / run loop
# ---------------------------------------------------------------------------

def collect_files(paths: Sequence[str]) -> List[str]:
    """Expand files/directories into a sorted list of ``*.py`` paths."""
    out: List[str] = []
    for path in paths:
        if os.path.isfile(path):
            out.append(path)
            continue
        for dirpath, dirnames, filenames in os.walk(path):
            dirnames[:] = [d for d in dirnames
                           if d != "__pycache__" and not d.startswith(".")]
            out.extend(os.path.join(dirpath, f) for f in filenames
                       if f.endswith(".py"))
    return sorted(set(out))


def build_project(paths: Sequence[str]) -> Tuple[Project, List[Finding]]:
    """Parse every file under ``paths``; unparseable files become findings.

    A syntax error is reported as ``RPA000`` rather than crashing the run:
    the linter gates CI, and a broken file is exactly what it must report.
    """
    contexts: List[FileContext] = []
    errors: List[Finding] = []
    for path in collect_files(paths):
        try:
            with open(path, encoding="utf-8") as f:
                source = f.read()
            contexts.append(FileContext(path, source))
        except (OSError, SyntaxError, ValueError) as e:
            line = getattr(e, "lineno", 1) or 1
            errors.append(Finding(path=path, line=int(line), code="RPA000",
                                  message=f"unparseable file: {e}"))
    return Project(contexts), errors


def run_project(project: Project,
                select: Optional[Sequence[str]] = None) -> List[Finding]:
    """Run every registered rule over ``project``; pragma-filtered, sorted."""
    selected = set(select) if select else None
    by_path = {ctx.path: ctx for ctx in project.files}
    findings: List[Finding] = []
    for rule in all_rules():
        if selected is not None and not selected & set(rule.CODES):
            continue
        for finding in rule.run(project):
            if selected is not None and finding.code not in selected:
                continue
            ctx = by_path.get(finding.path)
            if ctx is not None and ctx.allowed(finding.line, finding.code):
                continue
            findings.append(finding)
    return sorted(findings)


def run_paths(paths: Sequence[str],
              select: Optional[Sequence[str]] = None) -> List[Finding]:
    """Parse ``paths`` and run the full rule set (the CLI's core)."""
    project, errors = build_project(paths)
    return sorted(errors + run_project(project, select=select))


# ---------------------------------------------------------------------------
# reporters
# ---------------------------------------------------------------------------

def format_text(findings: Sequence[Finding]) -> str:
    lines = [f.format() for f in findings]
    n = len(findings)
    lines.append(f"{n} finding{'s' if n != 1 else ''}")
    return "\n".join(lines)


def format_json(findings: Sequence[Finding]) -> str:
    return json.dumps({"findings": [f.to_dict() for f in findings],
                       "count": len(findings)}, indent=1, sort_keys=True)


# ---------------------------------------------------------------------------
# shared AST helpers
# ---------------------------------------------------------------------------

def call_name(node: ast.Call) -> Optional[str]:
    """Bare callee name of a call: ``ops.frontier_moments(...)`` ->
    ``frontier_moments``; ``f(...)`` -> ``f``; anything else -> None."""
    func = node.func
    if isinstance(func, ast.Attribute):
        return func.attr
    if isinstance(func, ast.Name):
        return func.id
    return None


def dotted_name(node: ast.AST) -> Optional[str]:
    """Full dotted spelling of a Name/Attribute chain, else None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def param_names(args: ast.arguments) -> List[str]:
    """Every parameter name of a signature, in declaration order."""
    params = [a.arg for a in args.posonlyargs + args.args + args.kwonlyargs]
    if args.vararg:
        params.append(args.vararg.arg)
    if args.kwarg:
        params.append(args.kwarg.arg)
    return params


def positional_params(args: ast.arguments) -> List[str]:
    """Parameters reachable positionally (posonly + regular), in order."""
    return [a.arg for a in args.posonlyargs + args.args]


def keyword_or_positional(call: ast.Call, args: ast.arguments,
                          names: Iterable[str]) -> bool:
    """True when the call passes any of ``names`` to the callee signature
    ``args`` — as a keyword, positionally by index, or via ``**kwargs``."""
    wanted = set(names)
    for kw in call.keywords:
        if kw.arg is None:  # **kwargs splat: assume forwarded
            return True
        if kw.arg in wanted:
            return True
    pos = positional_params(args)
    n_given = len(call.args)
    for i, p in enumerate(pos):
        if p in wanted and i < n_given:
            return True
    return False


_FUNCTION_BASES = {"torch.autograd.Function", "autograd.Function", "Function"}


def is_autograd_function(node: ast.AST) -> bool:
    """A class deriving directly from ``torch.autograd.Function`` (spelt
    in full, as ``autograd.Function`` or as an imported ``Function``)."""
    return isinstance(node, ast.ClassDef) and any(
        dotted_name(b) in _FUNCTION_BASES for b in node.bases)


def class_methods(cls: ast.ClassDef) -> Dict[str, ast.FunctionDef]:
    """Name -> definition of the methods defined in a class body."""
    return {n.name: n for n in cls.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}
