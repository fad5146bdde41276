"""CLI for the port's invariant linter: ``python -m repro_torch.analysis
PATH...``.

Exits 1 when any finding survives pragma filtering, 0 on a clean tree.
``--json`` switches the report to a machine-readable document; ``--select
RPA001,RPA050`` restricts the run to specific codes; ``--list-rules``
prints the catalogue.
"""
from __future__ import annotations

import argparse
import sys
from typing import Optional, Sequence

from .framework import format_json, format_text, rule_codes, run_paths


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="AST invariant linter for the repro_torch port "
                    "(rule catalogue: repro_torch.analysis.rules)")
    parser.add_argument("paths", nargs="*", default=["src"],
                        help="files or directories to lint (default: src)")
    parser.add_argument("--json", action="store_true",
                        help="emit findings as JSON instead of text")
    parser.add_argument("--select", default=None, metavar="CODES",
                        help="comma-separated RPA codes to run (default: all)")
    parser.add_argument("--list-rules", action="store_true",
                        help="print every registered rule code and exit")
    args = parser.parse_args(argv)

    if args.list_rules:
        for code, desc in rule_codes().items():
            print(f"{code}  {desc}")
        return 0

    select = None
    if args.select:
        select = [c.strip() for c in args.select.split(",") if c.strip()]
    findings = run_paths(args.paths or ["src"], select=select)
    print(format_json(findings) if args.json else format_text(findings))
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
