"""The port's package boundary: ``src/repro_torch`` and ``chip_smoke.py``
import neither jax nor the JAX package ``repro``, and importing the port
builds nothing and needs no card."""
import ast
import pathlib
import re
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def _files():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 15
    return files


@pytest.mark.parametrize("path", _files(), ids=lambda p: str(
    p.relative_to(ROOT)))
def test_no_jax_or_reference_import(path):
    bad = [m for m in _imports(path)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path} imports {bad}"


def test_port_imports_without_jax_or_a_build():
    code = ("import sys, repro_torch.core, repro_torch.kernels.ops, "
            "repro_torch.sched, repro_torch.sim, repro_torch.convert, "
            "repro_torch.configs, repro_torch.models, repro_torch.serve, "
            "repro_torch.launch.serve, repro_torch.workflow, "
            "repro_torch.bench.dag_scale, repro_torch.bench.serve_trace, "
            "repro_torch.bench.fault_trace, repro_torch.ckpt, "
            "repro_torch.sim.chaos, repro_torch.serve.telemetry, "
            "repro_torch.core.group, repro_torch.sched.straggler, "
            "repro_torch.bench.common, repro_torch.bench.fig1_theory, "
            "repro_torch.bench.fig2_frontier, "
            "repro_torch.bench.fig34_convex_opt, "
            "repro_torch.bench.fig56_file_transfer, "
            "repro_torch.bench.cluster_scale, "
            "repro_torch.bench.elastic_fleet, repro_torch.bench.quickstart, "
            "repro_torch.bench.file_transfer, "
            "repro_torch.bench.partitioned_training, "
            "repro_torch.bench.serve_partitioned, repro_torch.bench.run, "
            "repro_torch.kernels.compose, repro_torch.kernels.family_score, "
            "repro_torch.obs, "
            "repro_torch.obs.export, repro_torch.analysis.sanitize, "
            "repro_torch.optim, repro_torch.data, repro_torch.train, "
            "repro_torch.launch.train, repro_torch.launch.mesh, "
            "repro_torch.bench.train_partitioned;"
            "from repro_torch.kernels import _cuda;"
            "assert not _cuda._LIBS and not _cuda.BUILD_INFO;"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'repro')];"
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], check=True,
                   env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"})


def test_kernel_sources_name_every_family():
    text = (PORT / "csrc" / "family.cuh").read_text()
    for fam in ("NORMAL", "LOGNORMAL", "DRIFT", "EMPIRICAL", "DEFECTIVE"):
        assert fam in text
    sources = sorted((PORT / "csrc").glob("*.cu*"))
    assert {p.name for p in sources} >= {"frontier_grid.cu", "rmsnorm.cu",
                                         "attention.cu"}
    for path in sources:   # fixed-order reductions only
        assert not re.search(r"atomic[A-Z]", path.read_text()), path
    for path in (PORT / "kernels").glob("*.py"):
        assert "use_fast_math" not in path.read_text(), path


def test_autotune_imports_first():
    # kernels.autotune imports core, whose package imports kernels.ops,
    # which reaches kernels.ref: ref must not take names from the
    # half-imported autotune
    subprocess.run([sys.executable, "-c",
                    "import repro_torch.kernels.autotune as a; "
                    "assert a.ssd_groups(1, 1, 16, 16).groups == 1"],
                   check=True, env={"PYTHONPATH": str(ROOT / "src"),
                                    "PATH": "/usr/bin:/bin"})
