"""The port's suite harness: one module per paper table or figure, plus
the beyond-paper benchmarks (the repository's ``benchmarks/run.py``).

Prints ``name,us_per_call,derived`` CSV rows (``bench.common.emit``) and
writes detailed tables under ``experiments/torch/``. A suite that fails is
reported with its traceback and the others still run; the harness then
exits 1. Every suite runs on ``--device`` (the CUDA kernels by default,
their plain versions with ``--device cpu``).

    PYTHONPATH=src python -m repro_torch.bench.run --device cpu --only fig1,parttrain

The ``roofline`` suite tabulates the records of the dry run
(``python -m repro_torch.launch.dryrun``, ROADMAP §1 item 13a), which it
does not run itself, as the reference's does not.
"""
from __future__ import annotations

import argparse
import sys
import traceback

from . import (cluster_scale, fig1_theory, fig2_frontier, fig34_convex_opt,
               fig56_file_transfer, partitioned_training, roofline_table)

SUITES = {
    "fig1": fig1_theory,
    "fig2": fig2_frontier,
    "fig34": fig34_convex_opt,
    "fig56": fig56_file_transfer,
    "cluster": cluster_scale,
    "parttrain": partitioned_training,
    "roofline": roofline_table,
}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", default="")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    args = ap.parse_args(argv)
    chosen = [s.strip() for s in args.only.split(",") if s.strip()] \
        or list(SUITES)
    print("name,us_per_call,derived")
    failures = []
    for name in chosen:
        try:
            SUITES[name].run(device=args.device)
        except Exception as e:  # noqa: BLE001 — report, keep going
            failures.append((name, e))
            traceback.print_exc()
    if failures:
        print(f"FAILED suites: {[n for n, _ in failures]}", file=sys.stderr)
        raise SystemExit(1)


if __name__ == "__main__":
    main()
