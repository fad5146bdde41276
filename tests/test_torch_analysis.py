"""The port's invariant linter, ``repro_torch.analysis``, against the JAX
package's, ``repro.analysis``.

* The framework's mechanics (RPA000, sorting, reporters, pragmas,
  ``select``, the CLI's exit codes) through both linters.
* The shared rules (RPA001/002, 040, 050, 060, 070, 080, 090/091) on the
  same fixtures, and on a copy of the JAX package seeded with one fault per
  rule: equal findings (path, line, code) and, once ``repro_torch`` reads
  ``repro``, equal messages.
* The torch twins of the JAX-only rules: RPA010-012 (the
  ``torch.autograd.Function`` contract) and RPA030-032 (the CUDA launch
  shapes against ``kernels.autotune``'s model) fire on seeded bad files
  and are silent on their good twins and on the port's own code.
* The port's tree lints clean, and its rule set is the JAX package's but
  RPA020-022 (``jit`` static arguments: the port traces nothing).
* The ``lint`` phase's helpers of ``chip_smoke.py`` (the resource dump's
  parser, the frontier instances' names) on canned text.
"""
import json
import os
import pathlib
import re
import shutil
import subprocess
import sys
import textwrap

import pytest

import repro.analysis as ref_lint
import repro_torch.analysis as port_lint
from repro_torch.analysis.rules import launch as port_launch
from repro_torch.core.distributions import FAMILIES
from repro_torch.kernels import _cuda, autotune

import chip_smoke

ROOT = pathlib.Path(__file__).resolve().parents[1]
LINTERS = {"repro": ref_lint, "repro_torch": port_lint}


def _write(base, files):
    for rel, source in files.items():
        p = base / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(textwrap.dedent(source))


def _lint(lint, tmp_path, source, select=None, name="fx.py"):
    """Write one fixture module and lint it; returns the findings."""
    _write(tmp_path, {name: source})
    return lint.run_paths([str(tmp_path / name)], select=select)


def _codes(findings):
    return sorted(f.code for f in findings)


# ---------------------------------------------------------------------------
# framework mechanics, through both linters
# ---------------------------------------------------------------------------
@pytest.fixture(params=sorted(LINTERS))
def lint(request):
    return LINTERS[request.param]


class TestFrameworkBothLinters:
    def test_unparseable_file_is_a_finding(self, lint, tmp_path):
        fs = _lint(lint, tmp_path, "def broken(:\n")
        assert _codes(fs) == ["RPA000"]

    def test_every_rule_declares_unique_codes(self, lint):
        codes = lint.rule_codes()
        assert len(codes) >= 13
        assert all(c.startswith("RPA") for c in codes)

    def test_findings_sort_and_format(self, lint, tmp_path):
        fs = _lint(lint, tmp_path, """
            def f(mus, sigmas):
                return mus + sigmas
            """)
        assert fs == sorted(fs)
        line = fs[0].format()
        assert "RPA001" in line and str(fs[0].line) in line

    def test_json_reporter_round_trips(self, lint, tmp_path):
        fs = _lint(lint, tmp_path, """
            def f(mus, sigmas):
                return mus
            """)
        data = json.loads(lint.format_json(fs))
        assert data["count"] == len(fs)
        assert data["findings"][0]["code"] == "RPA001"
        assert "RPA001" in lint.format_text(fs)

    def test_pragma_on_line_suppresses(self, lint, tmp_path):
        fs = _lint(lint, tmp_path, """
            def f(mus, sigmas):  # repro: allow[RPA001] fixture
                return mus
            """)
        assert fs == []

    def test_pragma_block_above_suppresses(self, lint, tmp_path):
        fs = _lint(lint, tmp_path, """
            # this helper is family-agnostic by design
            # repro: allow[RPA001] fixture justification
            def f(mus, sigmas):
                return mus
            """)
        assert fs == []

    def test_pragma_only_silences_named_code(self, lint, tmp_path):
        fs = _lint(lint, tmp_path, """
            def f(mus, sigmas):  # repro: allow[RPA050] wrong code
                return mus
            """)
        assert _codes(fs) == ["RPA001"]

    def test_select_filters(self, lint, tmp_path):
        fs = _lint(lint, tmp_path, """
            def f(mus, sigmas):
                return mus
            """, select=["RPA050"])
        assert fs == []

    def test_cli_exit_codes_and_json(self, lint, tmp_path):
        bad = tmp_path / "bad.py"
        bad.write_text("def f(mus, sigmas):\n    return mus\n")
        env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"}
        r = subprocess.run(
            [sys.executable, "-m", lint.__name__, str(bad), "--json"],
            capture_output=True, text=True, env=env)
        assert r.returncode == 1
        assert json.loads(r.stdout)["findings"][0]["code"] == "RPA001"
        good = tmp_path / "good.py"
        good.write_text("x = 1\n")
        r = subprocess.run([sys.executable, "-m", lint.__name__, str(good)],
                           capture_output=True, text=True, env=env)
        assert r.returncode == 0
        assert r.stdout.strip().endswith("0 findings")


# ---------------------------------------------------------------------------
# the shared rules: the same fixtures through both linters
# ---------------------------------------------------------------------------
_PER_INSTANCE_LOOP = """
    from repro.kernels import ops

    def tick(instances, num_t):
        out = []
        for inst in instances:
            out.append(ops.frontier_moments_with_grads(
                inst.W, inst.mus, inst.sigmas, num_t=num_t,
                family=inst.family))
        return out
    """

_FREE_NAME_EMIT = """
    from repro.obs import trace as obs

    def tick():
        with obs.span("engine.my_new_span", rows=3):
            pass
        obs.event("audit.surprise", cause="drift")
    """

_DISTRIBUTIONS = 'FAMILIES = ("normal", "lognormal", "drift")\n'

# case -> (files under tmp_path, the path linted, select, expected codes)
SHARED = {
    "rpa000": ({"fx.py": "def broken(:\n"}, "fx.py", ["RPA000"],
               ["RPA000"]),
    "rpa001": ({"fx.py": """
        def score(mus, sigmas, lam):
            return mus + lam * sigmas
        """}, "fx.py", ["RPA001"], ["RPA001"]),
    "rpa001_good": ({"fx.py": """
        def score(mus, sigmas, lam, family="normal"):
            return mus + lam * sigmas

        def score2(mus, sigmas, dist_id="normal"):
            return mus
        """}, "fx.py", ["RPA001"], []),
    "rpa002": ({"fx.py": """
        def inner(mus, sigmas, family="normal"):
            return mus

        def outer(mus, sigmas, family="normal"):
            return inner(mus, sigmas)
        """}, "fx.py", ["RPA001", "RPA002"], ["RPA002"]),
    "rpa002_good": ({"fx.py": """
        def inner(mus, sigmas, family="normal"):
            return mus

        def outer(mus, sigmas, family="normal"):
            return inner(mus, sigmas, family=family)
        """}, "fx.py", ["RPA001", "RPA002"], []),
    "rpa040": ({"fx.py": """
        import jax.numpy as jnp

        def prim_bwd(res, ct):
            x, y = res
            return ct * y, jnp.zeros_like(x)
        """}, "fx.py", ["RPA040"], ["RPA040"]),
    "rpa040_good": ({"fx.py": """
        import jax.numpy as jnp

        def prim_bwd(res, ct):
            '''y gets a zero cotangent: it is a stop-gradient constant.'''
            x, y = res
            return ct * y, jnp.zeros_like(x)
        """}, "fx.py", ["RPA040"], []),
    "rpa050": ({"fx.py": """
        import repro.core.normal
        from repro.core.normal import Phi
        from repro.core import normal
        """}, "fx.py", ["RPA050"], ["RPA050"] * 3),
    "rpa050_port_spellings": ({"fx.py": """
        import repro_torch.core.normal
        from repro_torch.core.normal import Phi
        from repro_torch.core import normal
        """}, "fx.py", ["RPA050"], ["RPA050"] * 3),
    "rpa050_relative": ({"pkg/core/fx.py": """
        from .normal import Phi
        from . import normal
        """}, "pkg", ["RPA050"], ["RPA050"] * 2),
    "rpa050_good": ({"fx.py": """
        from repro.core.distributions import Phi, safe_cdf
        """}, "fx.py", ["RPA050"], []),
    "rpa060": ({"pkg/core/distributions.py": _DISTRIBUTIONS,
                "pkg/sim/cluster.py": "# normal and lognormal regimes\n",
                "pkg/kernels/ref.py": "# normal lognormal drift\n"},
               "pkg", ["RPA060"], ["RPA060"]),
    "rpa060_good": ({"pkg/core/distributions.py": _DISTRIBUTIONS,
                     "pkg/sim/cluster.py": "# normal lognormal drift\n"},
                    "pkg", ["RPA060"], []),
    "rpa060_not_literal": ({"pkg/core/distributions.py":
                            "FAMILIES = tuple(x for x in 'ab')\n"},
                           "pkg", ["RPA060"], ["RPA060"]),
    "rpa070": ({"fx.py": """
        from repro.kernels import ops

        def f(W, mus, sigmas, family):
            return ops.frontier_moments(W, mus, sigmas, num_t=2048,
                                        family=family)
        """}, "fx.py", ["RPA070"], ["RPA070"]),
    "rpa070_arithmetic": ({"fx.py": """
        from repro.kernels import ops

        def f(W, mus, sigmas, family):
            return ops.frontier_moments_with_grads(
                W, mus, sigmas, num_t=2 * 1024, family=family)
        """}, "fx.py", ["RPA070"], ["RPA070"]),
    "rpa070_good": ({"fx.py": """
        from repro.kernels import ops

        def f(W, mus, sigmas, family, num_t):
            return ops.frontier_moments(W, mus, sigmas, num_t=num_t,
                                        family=family)
        """}, "fx.py", ["RPA070"], []),
    "rpa070_pragma": ({"fx.py": """
        from repro.kernels import ops

        def f(W, mus, sigmas, family):
            # repro: allow[RPA070] figure reproduction at pinned rung
            return ops.frontier_moments(W, mus, sigmas, num_t=2048,
                                        family=family)
        """}, "fx.py", ["RPA070"], []),
    "rpa070_tests_dir": ({"tests/test_fx.py": """
        from repro.kernels import ops

        def test_f(W, mus, sigmas, family):
            return ops.frontier_moments(W, mus, sigmas, num_t=128,
                                        family=family)
        """}, "tests", ["RPA070"], []),
    "rpa080": ({"serve/engine_fx.py": _PER_INSTANCE_LOOP}, "serve",
               ["RPA080"], ["RPA080"]),
    "rpa080_comprehension": ({"serve/engine_fx.py": """
        from repro.kernels import ops

        def tick(instances, num_t):
            return [ops.frontier_moments(i.W, i.mus, i.sigmas,
                                         num_t=num_t, family=i.family)
                    for i in instances]
        """}, "serve", ["RPA080"], ["RPA080"]),
    "rpa080_outside_serve": ({"fx.py": _PER_INSTANCE_LOOP}, "fx.py",
                             ["RPA080"], []),
    "rpa080_stacked": ({"serve/engine_fx.py": """
        from repro.kernels import ops

        def row_step(W, mus, sigmas, fam, num_t):
            return ops.frontier_moments_with_grads(
                W, mus, sigmas, num_t=num_t, family=fam)

        def tick(groups, num_t):
            return [row_step(g.W, g.mus, g.sigmas, g.fam, num_t)
                    for g in groups]
        """}, "serve", ["RPA080"], []),
    "rpa090": ({"repro/mod_fx.py": _FREE_NAME_EMIT}, "repro", ["RPA090"],
               ["RPA090", "RPA090"]),
    "rpa090_registry": ({"repro/mod_fx.py": """
        from repro.obs import names as obs_names
        from repro.obs import trace as obs

        def tick():
            with obs.span(obs_names.SPAN_ENGINE_TICK, rows=3):
                pass
            obs.event(obs_names.EV_DIRTY, cause="drift")
        """}, "repro", ["RPA090"], []),
    "rpa090_unrelated_event": ({"repro/mod_fx.py": """
        def drain(queue):
            queue.event("fired", at=3)
        """}, "repro", ["RPA090"], []),
    "rpa090_obs_exempt": ({"repro/obs/mod_fx.py": _FREE_NAME_EMIT}, "repro",
                          ["RPA090"], []),
    "rpa091": ({"repro/mod_fx.py": """
        import time

        def span():
            t0 = time.time()
            return time.time() - t0
        """}, "repro", ["RPA091"], ["RPA091", "RPA091"]),
    "rpa091_monotonic": ({"repro/mod_fx.py": """
        import time

        def span():
            t0 = time.perf_counter()
            return time.perf_counter() - t0
        """}, "repro", ["RPA091"], []),
    "rpa091_pragma": ({"repro/mod_fx.py": """
        import time

        def artifact_name():
            # repro: allow[RPA091] artifact date stamp, not a duration
            return int(time.time())
        """}, "repro", ["RPA091"], []),
    "rpa091_outside": ({"fx.py": """
        import time

        def now():
            return time.time()
        """}, "fx.py", ["RPA091"], []),
}


def _as_ref(message):
    """A message with the port's package name read as the reference's."""
    return message.replace("repro_torch", "repro")


def _keyed(findings, base):
    return [(os.path.relpath(f.path, base), f.line, f.code)
            for f in findings]


@pytest.mark.parametrize("case", sorted(SHARED))
def test_shared_rule_parity(case, tmp_path):
    files, target, select, want = SHARED[case]
    _write(tmp_path, files)
    ref = ref_lint.run_paths([str(tmp_path / target)], select=select)
    port = port_lint.run_paths([str(tmp_path / target)], select=select)
    assert _codes(ref) == sorted(want)
    assert _keyed(port, tmp_path) == _keyed(ref, tmp_path)
    assert [_as_ref(f.message) for f in port] == \
        [_as_ref(f.message) for f in ref]


# ---------------------------------------------------------------------------
# a copy of the JAX package with one fault per shared rule
# ---------------------------------------------------------------------------
def _wrap_in_loop(text, first, n):
    """Lines ``first`` .. ``first + n - 1`` (1-based) inside a one-pass
    ``for`` loop."""
    lines = text.split("\n")
    i = first - 1
    indent = re.match(r"\s*", lines[i]).group(0)
    body = ["    " + ln for ln in lines[i:i + n]]
    return "\n".join(lines[:i] + [f"{indent}for _ in range(1):"] + body
                     + lines[i + n:])


# relative path -> (code, the edit)
FAULTS = {
    "core/partitioner.py": ("RPA002", lambda s: s.replace(
        'num_t=num_t, impl="xla", family=family)',
        'num_t=num_t, impl="xla")', 1)),
    "kernels/ops.py": ("RPA060", lambda s: re.sub(
        r"\blognormal\b", "log_normal", s)),
    "sched/balancer.py": ("RPA091", lambda s: s + (
        "\n\ndef _wall_clock():\n    import time\n    return time.time()\n")),
    "workflow/solve.py": ("RPA070", lambda s: s.replace(
        "num_t=num_t, impl=impl, block_f=bfs[g],",
        "num_t=128, impl=impl, block_f=bfs[g],", 1)),
    "serve/engine.py": ("RPA080", lambda s: _wrap_in_loop(s, 210, 4)),
}


@pytest.fixture(scope="module")
def mutated(tmp_path_factory):
    """Both linters' findings on a copy of ``src/repro`` with FAULTS."""
    base = tmp_path_factory.mktemp("corpus")
    tree = base / "repro"
    shutil.copytree(ROOT / "src" / "repro", tree,
                    ignore=shutil.ignore_patterns("__pycache__"))
    for rel, (_, edit) in FAULTS.items():
        p = tree / rel
        before = p.read_text()
        after = edit(before)
        assert after != before, rel
        p.write_text(after)
    return (base, _keyed(ref_lint.run_paths([str(tree)]), base),
            _keyed(port_lint.run_paths([str(tree)]), base))


def test_mutation_corpus_gives_equal_findings(mutated):
    _, ref, port = mutated
    assert port == ref
    assert len(ref) == len(FAULTS)


@pytest.mark.parametrize("rel", sorted(FAULTS))
def test_mutation_corpus_finds_each_fault(mutated, rel):
    _, ref, port = mutated
    code = FAULTS[rel][0]
    path = os.path.join("repro", rel)
    assert [(p, c) for p, _, c in ref if p == path] == [(path, code)]
    assert [f for f in port if f[0] == path] == \
        [f for f in ref if f[0] == path]


# ---------------------------------------------------------------------------
# where the port's shared rules reach further than the JAX package's
# ---------------------------------------------------------------------------
def test_famcov_pairs_each_package_with_its_own_sites(tmp_path):
    """Two packages under one root: the JAX package's linter takes the
    last site by suffix (the port's), so a fault in the first package's
    site goes unseen; the port's pairs each registry with its own sites."""
    _write(tmp_path, {
        "src/repro/core/distributions.py": _DISTRIBUTIONS,
        "src/repro/sim/cluster.py": "# normal lognormal\n",
        "src/repro_torch/core/distributions.py": _DISTRIBUTIONS,
        "src/repro_torch/sim/cluster.py": "# normal lognormal drift\n"})
    src = str(tmp_path / "src")
    assert ref_lint.run_paths([src], select=["RPA060"]) == []
    fs = port_lint.run_paths([src], select=["RPA060"])
    assert _keyed(fs, tmp_path) == [
        (os.path.join("src", "repro", "sim", "cluster.py"), 1, "RPA060")]
    assert "'drift'" in fs[0].message


def test_famcov_reads_the_cuda_family_header(tmp_path):
    _write(tmp_path, {
        "pkg/core/distributions.py": _DISTRIBUTIONS,
        "pkg/csrc/family.cuh": "// normal, lognormal\n"})
    fs = port_lint.run_paths([str(tmp_path / "pkg")], select=["RPA060"])
    assert _keyed(fs, tmp_path) == [
        (os.path.join("pkg", "csrc", "family.cuh"), 1, "RPA060")]
    assert "csrc/family.cuh (CUDA kernels)" in fs[0].message
    (tmp_path / "pkg" / "csrc" / "family.cuh").write_text(
        "// normal lognormal drift\n")
    assert port_lint.run_paths([str(tmp_path / "pkg")],
                               select=["RPA060"]) == []


def test_observability_patrols_the_port_package(tmp_path):
    _write(tmp_path, {"repro_torch/mod_fx.py": """
        import time
        from repro_torch.obs import trace as obs

        def tick():
            obs.event("audit.surprise", at=time.time())
        """})
    target = [str(tmp_path / "repro_torch")]
    assert ref_lint.run_paths(target, select=["RPA090", "RPA091"]) == []
    assert _codes(port_lint.run_paths(target, select=["RPA090", "RPA091"])) \
        == ["RPA090", "RPA091"]


_APPLY = """
    import torch

    class _Moments(torch.autograd.Function):
        @staticmethod
        def forward(ctx, W, mus, sigmas, extra, num_t, z, dist_id):
            return W

        @staticmethod
        def backward(ctx, g):
            return g, None, None, None, None, None, None

    def moments(W, mus, sigmas, extra, num_t, z, dist_id="normal"):
        return _Moments.apply(W, mus, sigmas, extra, num_t, z{tail})
    """


@pytest.mark.parametrize("tail,want", [("", ["RPA002"]),
                                       (", dist_id", [])])
def test_apply_resolves_to_the_functions_forward(tmp_path, tail, want):
    fs = _lint(port_lint, tmp_path, _APPLY.format(tail=tail),
               select=["RPA001", "RPA002"])
    assert _codes(fs) == want
    if want:
        assert "'_Moments.apply'" in fs[0].message


@pytest.mark.parametrize("update,want", [("", ["RPA040"]),
                                         ("d_extra[0] = g\n", [])])
def test_zero_cotangent_rule_reads_autograd_backward(tmp_path, update, want):
    src = textwrap.dedent("""
        import torch

        class _F(torch.autograd.Function):
            @staticmethod
            def forward(ctx, x, extra):
                ctx.shape = extra.shape
                return x

            @staticmethod
            def backward(ctx, g):
                d_extra = torch.zeros(ctx.shape)
        """) + textwrap.indent(update, " " * 8) + \
        "        return g, d_extra\n"
    assert _codes(_lint(port_lint, tmp_path, src, select=["RPA040"])) == want


# ---------------------------------------------------------------------------
# RPA010-012: the torch.autograd.Function contract
# ---------------------------------------------------------------------------
_FN_GOOD = """
    import torch

    class Mul(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, y, scale):
            ctx.save_for_backward(x, y)
            ctx.scale = scale
            return x * y * scale

        @staticmethod
        def backward(ctx, g):
            x, y = ctx.saved_tensors
            return g * y * ctx.scale, g * x * ctx.scale, None
    """

VJP_CASES = {
    "good": (_FN_GOOD, []),
    "rpa010_no_backward": ("""
        from torch.autograd import Function

        class Half(Function):
            @staticmethod
            def forward(ctx, x):
                return x / 2
        """, ["RPA010"]),
    "rpa011_short_tuple": (_FN_GOOD.replace(
        "return g * y * ctx.scale, g * x * ctx.scale, None",
        "return g * y * ctx.scale, g * x * ctx.scale"), ["RPA011"]),
    "rpa011_repeated_none": ("""
        import torch

        class Id(torch.autograd.Function):
            @staticmethod
            def forward(ctx, x, a, b):
                return x.view_as(x)

            @staticmethod
            def backward(ctx, g):
                if g is None:
                    return (None,) * 4
                return g, None, None
        """, ["RPA011"]),
    "rpa011_good_starred_and_repeated": ("""
        import torch

        class Id(torch.autograd.Function):
            @staticmethod
            def forward(ctx, x, a, b):
                return x.view_as(x)

            @staticmethod
            def backward(ctx, g):
                if g is None:
                    return (None,) * 3
                grads = (g,)
                return (*grads, None, None)
        """, []),
    "rpa011_new_style": ("""
        from torch import autograd

        class Sq(autograd.Function):
            @staticmethod
            def forward(x, k):
                return x * x

            @staticmethod
            def setup_context(ctx, inputs, output):
                x, k = inputs
                ctx.save_for_backward(x)

            @staticmethod
            def backward(ctx, g):
                x, = ctx.saved_tensors
                return 2 * g * x, None, None
        """, ["RPA011"]),
    "rpa011_new_style_good": ("""
        from torch import autograd

        class Sq(autograd.Function):
            @staticmethod
            def forward(x, k):
                return x * x

            @staticmethod
            def setup_context(ctx, inputs, output):
                x, k = inputs
                ctx.save_for_backward(x)

            @staticmethod
            def backward(ctx, g):
                x, = ctx.saved_tensors
                return 2 * g * x, None
        """, []),
    "rpa012_count": (_FN_GOOD.replace(
        "ctx.save_for_backward(x, y)", "ctx.save_for_backward(x, y, x)"),
        ["RPA012"]),
    "rpa012_unused": (_FN_GOOD.replace(
        "return g * y * ctx.scale, g * x * ctx.scale, None",
        "return g * ctx.scale, g * x * ctx.scale, None"), ["RPA012"]),
    "rpa012_starred_save_unused": ("""
        import torch

        class Pick(torch.autograd.Function):
            @staticmethod
            def forward(ctx, x, y):
                outs = (x, y, x * y)
                ctx.save_for_backward(*outs[1:])
                return outs[2]

            @staticmethod
            def backward(ctx, g):
                b, c = ctx.saved_tensors
                return g * b, g
        """, ["RPA012"]),
    "rpa012_starred_save_good": ("""
        import torch

        class Pick(torch.autograd.Function):
            @staticmethod
            def forward(ctx, x, y):
                outs = (x, y, x * y)
                ctx.save_for_backward(*outs[1:])
                return outs[2]

            @staticmethod
            def backward(ctx, g):
                b, c = ctx.saved_tensors
                return g * b, g * c
        """, []),
    "not_a_function": ("""
        class Mul:
            def forward(self, x):
                return x

            def backward(self, g):
                return g, g
        """, []),
}


@pytest.mark.parametrize("case", sorted(VJP_CASES))
def test_autograd_function_contract(case, tmp_path):
    source, want = VJP_CASES[case]
    fs = _lint(port_lint, tmp_path, source,
               select=["RPA010", "RPA011", "RPA012"])
    assert _codes(fs) == want


PORT_FUNCTION_FILES = ("kernels/rmsnorm.py", "kernels/flash_attention.py",
                       "kernels/ssd_scan.py", "kernels/ops.py",
                       "launch/collectives.py")


def test_the_ports_functions_lint_clean():
    paths = [str(ROOT / "src" / "repro_torch" / p)
             for p in PORT_FUNCTION_FILES]
    project, errors = port_lint.build_project(paths)
    assert errors == []
    assert sorted(project.autograd_functions()) == [
        "_AllGather", "_AllReduce", "_FlashAttention", "_FrontierMoments",
        "_RMSNorm", "_ReduceGrad", "_ReduceScatter", "_Split",
        "_SplitRMSNorm", "_SsdScan"]
    fs = port_lint.run_project(project, select=[
        "RPA002", "RPA010", "RPA011", "RPA012", "RPA040"])
    assert fs == [], port_lint.format_text(fs)


# ---------------------------------------------------------------------------
# RPA030-032: the CUDA launch shapes
# ---------------------------------------------------------------------------
_WRAPPER = """
    from repro_torch.kernels import _cuda, autotune

    def launch(lib, W, num_t, dist_id{extra}):
        F, K = W.shape
        th, split, n = autotune.launch_plan(F, K, num_t, {mode!r}, dist_id)
        err = lib.fx_launch(F, K, num_t, th, *split, n)
        _cuda.check(err, "fx")
    """


@pytest.mark.parametrize("extra,mode", [("", "fwd"),
                                        (", *, param_grads", "grad")])
def test_launch_plan_audit(tmp_path, monkeypatch, extra, mode):
    src = _WRAPPER.format(extra=extra, mode=mode)
    sel = ["RPA030", "RPA031", "RPA032"]
    assert _lint(port_lint, tmp_path, src, select=sel) == []
    # the model's 256-thread plan needs more; 32-thread blocks still fit
    monkeypatch.setattr(autotune, "SMEM_LIMIT_BYTES", 4096)
    fs = _lint(port_lint, tmp_path, src, select=sel)
    assert _codes(fs) == ["RPA030"]
    for word in (("pgrad", "grad") if extra else ("fwd",)):
        assert f"normal/{word}" in fs[0].message
    assert "widest block fitting every combo is" in fs[0].message
    # nothing fits: every family x mode x stacked combination is refused
    monkeypatch.setattr(autotune, "SMEM_LIMIT_BYTES", 256)
    fs = _lint(port_lint, tmp_path, src, select=sel)
    n = len(FAMILIES) * (2 if extra else 1) * 2
    assert _codes(fs) == ["RPA030"] + ["RPA032"] * n


def test_frontier_wrappers_are_audited_and_clean(monkeypatch):
    path = [str(ROOT / "src" / "repro_torch" / "kernels")]
    sel = ["RPA030", "RPA031", "RPA032"]
    assert port_lint.run_paths(path, select=sel) == []
    monkeypatch.setattr(autotune, "SMEM_LIMIT_BYTES", 4096)
    fs = port_lint.run_paths(path, select=sel)
    assert [(os.path.basename(f.path), f.code) for f in fs] == [
        ("frontier_grid.py", "RPA030")] * 2
    assert sorted(re.match(r"'(\w+)'", f.message).group(1)
                  for f in fs) == ["launch_fwd", "launch_grad"]


def test_audit_point_fits_the_card_with_room_for_static_memory():
    """The model's plan at every audited combination leaves room for the
    frontier kernels' static shared memory (a 33-double reduction)."""
    for fam in FAMILIES:
        for mode in autotune.MODES:
            for stacked in (False, True):
                th, split, need = port_launch.model_plan(
                    autotune, port_launch.AUDIT_F[stacked],
                    port_launch.AUDIT_K, port_launch.AUDIT_T, mode, fam)
                assert need + 33 * 8 <= autotune.SMEM_LIMIT_BYTES
                assert th <= autotune.MAX_THREADS


_COUNT = """
    from repro_torch.kernels import _cuda

    def _cdiv(a, b):
        return -(-a // b)

    def _plan(S, per):
        return {plan}

    def launch(lib, x, D, block):
        F = x.shape[0]
        rows = x.numel() // D
        {body}
        err = lib.fx_launch(rows, n_blocks, *tail)
        _cuda.check(err, "fx")
    """

COUNT_CASES = {
    "floor": ("S // per", "n_blocks = F // block\ntail = (D,)",
              ["RPA031"]),
    "floor_in_helper": ("S // per, per", "n_blocks = 1\n"
                        "n_splits, size = _plan(F, block)\n"
                        "tail = (n_splits, size)", ["RPA031"]),
    "ceiling": ("S // per", "n_blocks = -(-F // block)\ntail = (D,)", []),
    "cdiv": ("S // per", "n_blocks = _cdiv(F, block)\ntail = (D,)", []),
    "guard": ("S // per", "if F % block:\n    raise ValueError(F)\n"
              "n_blocks = F // block\ntail = (D,)", []),
    "ceiling_in_helper": ("-(-S // per), per", "n_blocks = 1\n"
                          "n_splits, size = _plan(F, block)\n"
                          "tail = (n_splits, size)", []),
    "not_a_count": ("S // per", "n_blocks = 1\nsize = F // block\n"
                    "tail = (size,)", []),
}


@pytest.mark.parametrize("case", sorted(COUNT_CASES))
def test_launch_count_floor_division(case, tmp_path):
    plan, body, want = COUNT_CASES[case]
    src = textwrap.dedent(_COUNT).replace("{plan}", plan).replace(
        "{body}", textwrap.indent(body, " " * 4).lstrip())
    assert _codes(_lint(port_lint, tmp_path, src, select=["RPA031"])) == want


def test_decode_splits_floor_would_be_found(tmp_path):
    """flash_decode's helper floors on purpose (``S // MIN_SPLIT``) and
    returns ceiling divisions: silent; a floor in its returned count is
    found."""
    src = (ROOT / "src" / "repro_torch" / "kernels" / "flash_decode.py") \
        .read_text()
    assert _lint(port_lint, tmp_path, src, select=["RPA031"]) == []
    bad = src.replace("return -(-S // split_len), split_len",
                      "return S // split_len, split_len")
    assert bad != src
    fs = _lint(port_lint, tmp_path, bad, select=["RPA031"])
    assert _codes(fs) == ["RPA031"] and "'splits'" in fs[0].message


# ---------------------------------------------------------------------------
# the rule set and the port's tree
# ---------------------------------------------------------------------------
def test_rule_codes_are_the_references_but_the_jit_rules():
    ref, port = set(ref_lint.rule_codes()), set(port_lint.rule_codes())
    assert ref - port == {"RPA020", "RPA021", "RPA022"}
    assert port - ref == set()


def test_port_linter_cli_lints_src_clean():
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", "src"],
        capture_output=True, text=True, cwd=ROOT,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"})
    assert r.returncode == 0, r.stdout + r.stderr
    assert r.stdout.strip() == "0 findings"


# ---------------------------------------------------------------------------
# chip_smoke.py's lint phase: the resource dump and the frontier instances
# ---------------------------------------------------------------------------
_DUMP = """
Fatbin elf code:
================
arch = sm_90a
code version = [1,7]
host = linux
compile_size = 64bit

Resource usage:
 Common:
  GLOBAL:0
 Function _Z18frontier_fwd_pass1ILi0EEv4Args5SplitPd:
  REG:40 STACK:0 SHARED:264 LOCAL:0 CONSTANT[0]:600 TEXTURE:0 SURFACE:0
 Function _Z14fd_split_kernelIL_Z1GEEvv: REG:255 STACK:24 SHARED:0 LOCAL:48
"""


def test_resource_dump_parser():
    usage = _cuda.parse_resource_usage(_DUMP)
    assert usage == {
        "_Z18frontier_fwd_pass1ILi0EEv4Args5SplitPd": {
            "REG": 40, "STACK": 0, "SHARED": 264, "LOCAL": 0,
            "CONSTANT[0]": 600, "TEXTURE": 0, "SURFACE": 0},
        "_Z14fd_split_kernelIL_Z1GEEvv": {
            "REG": 255, "STACK": 24, "SHARED": 0, "LOCAL": 48}}


def test_frontier_instances_name_their_family_and_mode():
    """cu++filt's spelling of the frontier library's instances on the
    card (CUDA 12.8), and a plainer one."""
    names = [f"void fg::frontier_fwd_pass1<(int){f}>(fg::Args, fg::Split, "
             f"double *)" for f in range(5)]
    names.append("fg::frontier_fwd_epilogue(fg::Args, fg::Split, "
                 "const double *, float *, float *)")
    names += [f"void frontier_grad_pass1<{f}>(Args, Split, double *)"
              for f in range(5)]
    for kernel in ("frontier_grad_pass2", "frontier_grad_epilogue"):
        names += [f"void fg::{kernel}<(int){f}, (bool){p}>(fg::Args, "
                  f"fg::Split, fg::GradOut)" for f in range(5)
                  for p in (0, 1)]
    assert len(names) == chip_smoke.FRONTIER_INSTANCES
    served = set()
    for name in names:
        modes = chip_smoke._frontier_modes(*chip_smoke._template(name),
                                           FAMILIES)
        assert modes
        served |= {(chip_smoke._template(name)[0], fam, mode)
                   for fam, mode in modes}
    assert {(k, fam, m) for k, fam, m in served
            if k == "frontier_grad_pass2"} == {
        ("frontier_grad_pass2", fam, m) for fam in FAMILIES
        for m in ("grad", "pgrad")}
    assert chip_smoke._template(
        "void <unnamed>::fa_wgmma_kernel<(int)64, (int)128>(CUtensorMap_st, "
        "<unnamed>::FaArgs)") == ("fa_wgmma_kernel", (64, 128))
    assert chip_smoke._template(
        "void <unnamed>::fd_split_kernel<__nv_bfloat16, (int)16, (int)1>("
        "const T1 *, <unnamed>::FdArgs)") == ("fd_split_kernel",
                                              ("__nv_bfloat16", 16, 1))
    assert chip_smoke._frontier_modes("fa_wgmma_kernel", (64, 128),
                                      FAMILIES) is None
