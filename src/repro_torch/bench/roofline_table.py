"""The dry run's records as the roofline table (the repository's
``benchmarks/roofline_table.py``).

Reads ``experiments/torch/dryrun/*.json`` (written by
``python -m repro_torch.launch.dryrun``) and writes
``experiments/torch/roofline_table.csv`` with the three roofline terms,
the dominant one, the compute share of the bound and the useful-FLOPs
ratio per (arch x shape x mesh). The terms are counts times the H100's
datasheet rates (``launch.roofline.HW``): bounds, not measurements. The
reference's gate holds unchanged: no cell may have failed. A cell the
port does not run (``not_ported``, its reason naming the ROADMAP item that
would run it) is counted beside the reference's ``skipped``; since item
12f every cell of the dry run's matrix runs, each TP rank computing its
heads and columns where they divide, and since 12g with
``--seq-parallel`` too (records with ``meta.seq_axis``).

    PYTHONPATH=src python -m repro_torch.bench.roofline_table
"""
from __future__ import annotations

import glob
import json
import os

from . import common
from .common import emit, save_table

DRYRUN_DIR = os.path.join(common.RESULTS_DIR, "dryrun")


def load_records(directory: str = None):
    recs = []
    for path in sorted(glob.glob(os.path.join(directory or DRYRUN_DIR,
                                              "*.json"))):
        with open(path) as f:
            recs.append(json.load(f))
    return recs


def run(device=None, directory: str = None) -> dict:
    """The table of the records in ``directory`` (the dry run's by
    default); ``device`` is the harness's argument, unused: nothing here
    runs on a device."""
    recs = load_records(directory)
    rows = []
    ok = skipped = not_ported = failed = 0
    for r in recs:
        if r["status"] == "skipped":
            skipped += 1
            rows.append((r["arch"], r["shape"], r["mesh"], "SKIP",
                         "", "", "", "", "", r.get("reason", "")))
            continue
        if r["status"] == "not_ported":
            not_ported += 1
            rows.append((r["arch"], r["shape"], r["mesh"], "NOT_PORTED",
                         "", "", "", "", "", r.get("reason", "")))
            continue
        if r["status"] != "ok":
            failed += 1
            rows.append((r["arch"], r["shape"], r["mesh"], "FAIL",
                         "", "", "", "", "", r.get("error", "")[:80]))
            continue
        ok += 1
        t = r["roofline"]
        rows.append((
            r["arch"], r["shape"], r["mesh"], "ok",
            f"{t['compute_s']:.4f}", f"{t['memory_s']:.4f}",
            f"{t['collective_s']:.4f}", t["dominant"].replace("_s", ""),
            f"{t['roofline_fraction']:.4f}",
            f"{r.get('useful_flops_ratio') or 0:.3f}",
        ))
    path = save_table(
        "roofline_table.csv",
        "arch,shape,mesh,status,compute_s,memory_s,collective_s,dominant,"
        "roofline_fraction,useful_flops_ratio", rows)
    emit("roofline_cells_ok", float(ok),
         f"skipped={skipped};not_ported={not_ported};failed={failed}")
    assert failed == 0, f"{failed} dry-run cells failed"
    return {"ok": ok, "skipped": skipped, "not_ported": not_ported,
            "failed": failed, "table": path}


if __name__ == "__main__":
    print(run())
