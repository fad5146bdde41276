"""The dry run without storage (``launch/dryrun.py``) and its roofline
table (``bench/roofline_table.py``), on the CPU.

A handful of cells runs in this process on fake process groups of the
production meshes' sizes (256 ranks on (16, 16), 512 on (2, 16, 16);
``launch.dryrun.fake_world`` destroys each group before the fixture
returns, so no global group reaches another test): SmolLM-360M and
Qwen3-8B train_4k and Qwen3-8B decode_32k on one pod, DeepSeek-V2-Lite-16B
train_4k, Mamba2-2.7B long_500k and the partitioned step on two, Whisper's
train_4k and decode_32k cells (each rank's heads, FFN columns and vocab
shard where they divide the TP size: ``models/tp.py``) and a
full-attention ``skipped`` cell. The train cells take
2 accumulation microsteps instead of the CLI's 8 (the same work a
microstep, a quarter of the time here). Each record has the reference's
keys, its parameter and model-FLOP counts equal the reference's, and the
table's gate holds; the CLI runs one cell in a subprocess, counts a
cell under ``--seq-parallel`` (the residual stream's sequence over
"model": a lower train_4k peak) and raises without ``fake_pg``. The
multi-pod cells shard the batch over "pod" and "data".
"""
import json
import os
import subprocess
import sys

import pytest
import torch.distributed as dist

from repro.configs import SHAPES as JSHAPES, get_config as jget_config
from repro.launch import roofline as jroofline
from repro_torch.bench import common, roofline_table
from repro_torch.launch import dryrun

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SINGLE = [("smollm-360m", "train_4k"), ("qwen3-8b", "decode_32k"),
          ("whisper-large-v3", "train_4k"), ("qwen3-8b", "long_500k"),
          ("qwen3-8b", "train_4k")]
MULTI = [("deepseek-v2-lite-16b", "train_4k"), ("mamba2-2.7b", "long_500k"),
         ("whisper-large-v3", "decode_32k")]
KEYS = {"arch", "shape", "mesh", "status", "meta", "hlo_stats", "roofline",
        "params", "model_flops", "useful_flops_ratio", "memory_analysis"}


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("dryrun"))
    recs = {}
    for kind, cells in (("single", SINGLE), ("multi", MULTI)):
        with dryrun.fake_world(kind == "multi") as mesh:
            for arch, shape in cells:
                recs[arch, shape, kind] = dryrun.run_cell(
                    arch, shape, kind, mesh, out_dir=out, accum=2)
            if kind == "multi":
                recs["partitioned"] = dryrun.run_cell(
                    "smollm-360m", "train_4k", kind, mesh, out_dir=out,
                    partitioned=True)
        assert not dist.is_initialized()
    return out, recs


def _ok(recs):
    return {k: r for k, r in recs.items() if r["status"] == "ok"}


def test_cells_have_the_reference_keys(records):
    _, recs = records
    ok = _ok(recs)
    assert len(ok) == 8, {k: r["status"] for k, r in recs.items()}
    for key, r in ok.items():
        assert KEYS <= set(r), key
        assert {"flops", "hbm_bytes", "ici_bytes", "dcn_bytes",
                "collective_counts", "collective_bytes_by_type"} <= set(
                    r["hlo_stats"])
        assert {"compute_s", "memory_s", "collective_s", "ici_s", "dcn_s",
                "dominant", "step_lower_bound_s", "roofline_fraction",
                "chips"} == set(r["roofline"])
        mem = r["memory_analysis"]
        assert 0 < mem["argument_bytes"] <= mem["peak_bytes"]
        assert mem["output_bytes"] is None and mem["null_reasons"]
        assert r["rates"]["name"] == "NVIDIA H100 80GB HBM3"
        assert r["hlo_stats"]["flops"] > 0 and r["hlo_stats"]["hbm_bytes"] > 0


def test_counts_equal_the_reference(records):
    _, recs = records
    for key, r in _ok(recs).items():
        jcfg = jget_config(r["arch"])
        shape = JSHAPES[r["shape"].replace("(partitioned)", "")]
        total, active = jroofline.count_params(jcfg)
        assert r["params"] == {"total": total, "active": active}
        assert r["model_flops"] == jroofline.model_flops(jcfg, shape)


def test_train_cells_count_the_backward_and_the_collectives(records):
    _, recs = records
    sm = recs["smollm-360m", "train_4k", "single"]
    k = sm["hlo_stats"]["kernels"]
    assert k["flash_attention_bwd"]["calls"] == 2 * 32
    # "full" remat: each unit's forward twice a microstep
    assert k["flash_attention"]["calls"] == 2 * 2 * 32
    coll = sm["hlo_stats"]["collective_counts"]
    assert coll["all-gather"] > 0 and coll["reduce-scatter"] > 0
    assert coll["all-reduce"] > 0
    assert sm["roofline"]["chips"] == 256
    # the MLP's columns and the vocab on their TP rank, SmolLM's 15
    # attention heads replicated at tp 16 (ROADMAP 12f): above the 1/12
    # of every head and column on every rank
    assert sm["meta"]["replicated"] == ["attn"]
    assert 1 / 12 < sm["useful_flops_ratio"] < 0.5
    qw = recs["qwen3-8b", "train_4k", "single"]
    assert qw["meta"]["replicated"] == [] and qw["useful_flops_ratio"] >= 0.5
    ds = recs["deepseek-v2-lite-16b", "train_4k", "multi"]
    # the batch over both axes of the multi-pod mesh, as the reference's
    # build_cell shards it (ROADMAP 12g)
    assert ds["roofline"]["chips"] == 512 and ds["meta"]["batch_axes"] == [
        "pod", "data"]
    assert ds["hlo_stats"]["dcn_bytes"] > 0
    part = recs["partitioned"]
    assert part["shape"] == "train_4k(partitioned)"
    assert part["meta"]["k_pods"] == [4, 4]


def test_decode_cells(records):
    _, recs = records
    qd = recs["qwen3-8b", "decode_32k", "single"]
    assert qd["meta"]["cache_len"] == 32768
    assert qd["hlo_stats"]["kernels"]["flash_decode"]["calls"] == 36
    mb = recs["mamba2-2.7b", "long_500k", "multi"]
    assert not mb["meta"]["batch_shardable"]
    assert mb["meta"]["batch_axes"] == []


def test_not_ported_and_skipped(records):
    _, recs = records
    # since 12f the encoder-decoder runs on a mesh: no cell is not_ported
    for key in (("whisper-large-v3", "train_4k", "single"),
                ("whisper-large-v3", "decode_32k", "multi")):
        assert recs[key]["status"] == "ok"
        # 20 heads at tp 16: attention replicated, as the reference's rule
        assert recs[key]["meta"]["replicated"] == ["attn"]
    assert recs["whisper-large-v3", "train_4k", "single"]["hlo_stats"][
        "kernels"]["flash_attention_bwd"]["calls"] > 0
    sk = recs["qwen3-8b", "long_500k", "single"]
    assert sk["status"] == "skipped" and "full-attention" in sk["reason"]


def test_roofline_table_gate(records, tmp_path, monkeypatch):
    out, _ = records
    monkeypatch.setattr(common, "RESULTS_DIR", str(tmp_path))
    res = roofline_table.run(directory=out)
    assert (res["ok"], res["skipped"], res["not_ported"], res["failed"]) \
        == (8, 1, 0, 0)
    lines = open(res["table"]).read().splitlines()
    assert lines[0].startswith("arch,shape,mesh,status,compute_s")
    bad = tmp_path / "bad"
    bad.mkdir()
    (bad / "x.json").write_text(json.dumps(
        {"arch": "a", "shape": "s", "mesh": "m", "status": "error",
         "error": "boom"}))
    with pytest.raises(AssertionError, match="1 dry-run cells failed"):
        roofline_table.run(directory=str(bad))


def _cli(*args, **kw):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun",
                           *args], capture_output=True, text=True, env=env,
                          cwd=ROOT, timeout=300, **kw)


def test_cli_one_cell_and_seq_parallel(tmp_path, records):
    r = _cli("--arch", "qwen3-8b", "--shape", "decode_32k", "--out",
             str(tmp_path))
    assert r.returncode == 0, r.stderr[-2000:]
    assert "[OK] qwen3-8b decode_32k pod16x16" in r.stdout
    rec = json.loads((tmp_path / "qwen3-8b__decode_32k__pod16x16.json")
                     .read_text())
    assert rec["status"] == "ok"
    # since 12g --seq-parallel counts the cell with seq_axis="model": its
    # train_4k peak below the record without the flag (the same 2
    # microsteps), the per-chip FLOPs within 1%
    r = _cli("--arch", "qwen3-8b", "--seq-parallel", "--accum", "2",
             "--out", str(tmp_path))
    assert r.returncode == 0, r.stderr[-2000:]
    sp = json.loads((tmp_path / "qwen3-8b__train_4k__pod16x16.json")
                    .read_text())
    base = records[1]["qwen3-8b", "train_4k", "single"]
    assert sp["status"] == "ok" and sp["meta"]["seq_axis"] == "model"
    assert base["meta"]["seq_axis"] is None
    assert sp["memory_analysis"]["peak_bytes"] < base["memory_analysis"][
        "peak_bytes"]
    assert sp["hlo_stats"]["flops"] <= 1.01 * base["hlo_stats"]["flops"]


def test_prefill_cache_spec_counts_no_global_entry():
    """A prefill places each cache entry at ``cache_specs`` from the
    global entry's shape alone: the count sees no tensor of the whole
    batch's (B, Hkv, S, hd), which it once took for a live one and added
    to every prefill's peak (ROADMAP §3 item 36)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import roofline
    from repro_torch.models import ShardCtx, build_model
    cfg = get_config("qwen3-8b").tiny()
    with dryrun.fake_world(False) as mesh:
        model = build_model(cfg, device="meta", seed=0,
                            ctx=ShardCtx(mesh=mesh, batch_axes=("data",)))
        entry = {k: torch.empty((2, cfg.num_kv_heads, 64, cfg.head_dim),
                                device="meta") for k in ("k", "v")}
        with roofline.counting() as cnt:
            placed = model._store(entry, False)
        assert tuple(placed["k"].shape) == (32, cfg.num_kv_heads, 64,
                                             cfg.head_dim)
    # the two entries themselves (the DTensors' local parts); the whole
    # batch's k alone is 16 times one of them
    one = entry["k"].numel() * entry["k"].element_size()
    assert cnt.peak_bytes <= 2 * one


def test_missing_fake_pg_raises(monkeypatch):
    monkeypatch.setitem(sys.modules,
                        "torch.testing._internal.distributed.fake_pg", None)
    with pytest.raises(RuntimeError, match="fake_pg"):
        with dryrun.fake_world(False):
            pass
    assert not dist.is_initialized()
