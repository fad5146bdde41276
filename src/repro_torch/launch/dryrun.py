"""Multi-pod dry run without storage: count every (arch x shape x mesh)
cell's step (the JAX package's ``launch/dryrun.py``).

The reference lowers and compiles each cell's step on 256 or 512 fake
devices and reads the compiled HLO. Here each cell runs its step once, as
rank 0 of a fake process group of the production mesh's size
(``torch.testing._internal.distributed.fake_pg``: collectives return at
once), on ``meta`` tensors (shapes, no storage), under
``launch.roofline.counting``: the model is built at the cell's placements,
and the train step (with its AdamW update), the prefill or the decode step
against a ``cache_len`` cache runs through the model kernels' meta
branches, which record their work, and ``launch/collectives.py``, which
records each collective's bytes. The record's ``roofline`` terms are these
counts times the H100's datasheet rates (``launch.roofline.HW``): bounds,
not measurements.

  single-pod : (16, 16)       256 ranks, axes ("data", "model")
  multi-pod  : (2, 16, 16)    512 ranks, axes ("pod", "data", "model")

Every cell shards its batch over the mesh's batch axes, "pod" and "data"
on the multi-pod mesh, where they divide it, as the reference's
``build_cell`` does: each rank takes the block of rows at its pod-major
index, and in training the weights' gradients are reduce-scattered over
"data" and summed over "pod" (the context's ``row_axes``); the
partitioned cell's context shards it over "data", its step joining the
pods. The decode cells shard the cache's sequence over "data" where the
batch does not split and the arch is a hybrid, as the reference does.
With ``--seq-parallel`` every cell's context takes ``seq_axis="model"``,
as the reference's ``build_cell`` and ``build_partitioned_cell`` do:
between blocks each TP rank holds its block of the residual stream's
sequence (``models/transformer.py``). Each TP rank computes its heads, FFN
columns, SSD heads and vocab shard (``models/tp.py``), and a block whose
heads do not divide the TP size runs replicated, as the reference's rule
replicates it: each record names those blocks (``meta.replicated``), and
``useful_flops_ratio`` reports the count as it is. The encoder-decoder
(Whisper) takes its frames as the reference's cells give them, (B,
encoder_seq, d) in the activation dtype. ``skipped`` is the reference's
``shape_applicable`` reason. A missing ``fake_pg`` raises.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-8b \\
        --shape train_4k --mesh single            # one cell
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both

Records go to ``experiments/torch/dryrun/<arch>__<shape>__<mesh>.json``;
``python -m repro_torch.bench.roofline_table`` turns them into its table.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import time
import traceback

import torch

from ..bench.common import RESULTS_DIR
from ..configs import ARCHS, SHAPES, get_config, shape_applicable
from ..models import ShardCtx, build_model
from ..optim.adamw import cosine_schedule
from ..train.step import (init_state, make_partitioned_train_step,
                          make_train_step)
from ..models import tp as tp_lib
from . import roofline
from .mesh import axis_size, batch_axes, make_production_mesh
from .shardings import local

__all__ = ["fake_world", "run_cell", "build_cell", "main"]

DEFAULT_OUT = os.path.join(RESULTS_DIR, "dryrun")
MESH_TAGS = {"single": "pod16x16", "multi": "pod2x16x16"}


@contextlib.contextmanager
def fake_world(multi_pod: bool):
    """A fake default process group of the production mesh's size and
    that mesh over it ("cpu" device type), destroyed on exit."""
    import torch.distributed as dist
    try:
        from torch.testing._internal.distributed.fake_pg import FakeStore
    except ImportError as e:
        raise RuntimeError(
            "the dry run needs torch.testing._internal.distributed.fake_pg "
            "(a fake process group): this torch has none") from e
    size = 512 if multi_pod else 256
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=size)
    try:
        yield make_production_mesh(multi_pod=multi_pod, device_type="cpu")
    finally:
        dist.destroy_process_group()


def _meta(shape, dtype=torch.long):
    return torch.empty(shape, dtype=dtype, device="meta")


def _state_bytes(tree) -> int:
    """Bytes this rank holds of a tree's tensors (its shards)."""
    from torch.utils._pytree import tree_flatten
    return sum(local(t).numel() * local(t).element_size()
               for t in tree_flatten(tree)[0]
               if isinstance(t, torch.Tensor))


def _chips(mesh) -> int:
    n = 1
    for v in mesh.shape:
        n *= v
    return n


def build_cell(arch: str, shape_name: str, mesh, *, accum: int = 8,
               seq_parallel: bool = False, remat: bool = True,
               capacity_factor=None, remat_policy: str = "full",
               accum_dtype: str = "float32", partitioned: bool = False,
               compress: bool = False, max_micro: int = 8):
    """(run, state, meta): ``run()`` runs the cell's step once on meta
    tensors; ``state`` is what the step starts from (its bytes are the
    record's ``argument_bytes``)."""
    cfg = get_config(arch).replace(remat=remat, remat_policy=remat_policy)
    if capacity_factor is not None:
        cfg = cfg.replace(capacity_factor=capacity_factor)
    shape = SHAPES["train_4k" if partitioned else shape_name]
    names = tuple(mesh.mesh_dim_names)
    npods = axis_size(mesh, "pod")
    B, S = shape.global_batch, shape.seq_len
    ba = batch_axes(mesh)
    prod = 1
    for a in ba:
        prod *= axis_size(mesh, a)
    shardable = B % prod == 0
    train = shape.kind == "train"
    seq_axes = (("data",) if shape.kind == "decode" and not shardable
                and cfg.family in ("hybrid",) else None)
    # the partitioned step's pods run their own microsteps and join
    ctx = ShardCtx(mesh=mesh,
                   batch_axes=(("data",) if partitioned else ba)
                   if shardable else (),
                   decode_seq_axes=seq_axes,
                   seq_axis="model" if seq_parallel else None)
    meta = {"arch": arch, "shape": shape.name + ("(partitioned)"
                                                 if partitioned else ""),
            "kind": shape.kind, "global_batch": B, "seq_len": S,
            "mesh": dict(zip(names, mesh.shape)),
            "batch_shardable": shardable,
            "batch_axes": list(ctx.batch_axes), "seq_axis": ctx.seq_axis,
            "cache_seq_axes": list(seq_axes) if seq_axes else None,
            "replicated": tp_lib.replicated_blocks(
                cfg, axis_size(mesh, "model"))}
    model = build_model(cfg, device="meta", seed=0, ctx=ctx,
                        trainable=train)
    lr = cosine_schedule(3e-4, 100, 10_000)
    n_text = S - cfg.num_patches
    # the VLM's patches or the encoder-decoder's frames
    n_extra = cfg.num_patches or (cfg.encoder_seq
                                  if cfg.is_encoder_decoder else 0)
    extra = (_meta((B, n_extra, cfg.d_model), torch.bfloat16)
             if n_extra else None)

    if partitioned:
        if "pod" not in names:
            raise ValueError("the partitioned step needs the pod axis "
                             "(--mesh multi)")
        mb = B // max_micro
        step = make_partitioned_train_step(model, cfg, mesh, lr,
                                           max_micro=max_micro,
                                           compress_pod_reduce=compress)
        state = init_state(model)
        # the trainer's total, split evenly: max_micro * pods / 2
        k_pods = [max_micro // 2] * npods
        meta.update(max_micro=max_micro, compress_pod_reduce=compress,
                    k_pods=k_pods)
        toks = _meta((max_micro, mb, S))
        return (lambda: step(state, toks, toks, k_pods)), state, meta

    if train:
        accum = min(accum, B)
        step = make_train_step(model, cfg, lr, accum=accum,
                               accum_dtype=getattr(torch, accum_dtype))
        state = init_state(model)
        meta.update(accum=accum, accum_dtype=accum_dtype)
        toks = _meta((B, n_text))
        labels = _meta((B, S))
        return (lambda: step(state, toks, labels, extra)), state, meta

    params = dict(model.named_parameters())
    toks = _meta((B, n_text))
    if shape.kind == "prefill":
        def run():
            with torch.no_grad():
                if extra is not None:
                    return model.prefill(toks, extra)
                return model.prefill(toks)
        return run, params, meta
    cache_len = min(S, cfg.window) if cfg.window else S
    meta["cache_len"] = cache_len
    cache = (model.cache_init(B, cache_len, cfg.encoder_seq)
             if cfg.is_encoder_decoder else model.cache_init(B, cache_len))
    tok = _meta((B, 1))

    def run():
        with torch.no_grad():
            return model.decode_step(cache, tok)
    return run, (params, cache), meta


def run_cell(arch: str, shape_name: str, mesh_kind: str, mesh=None,
             out_dir: str = DEFAULT_OUT, partitioned: bool = False,
             tag: str = "", **opts) -> dict:
    """Count one cell on ``mesh`` (a fake world's production mesh of
    ``mesh_kind``) and write its record."""
    cfg = get_config(arch)
    shape = SHAPES["train_4k" if partitioned else shape_name]
    record = {"arch": arch,
              "shape": shape_name if not partitioned
              else "train_4k(partitioned)",
              "mesh": MESH_TAGS[mesh_kind], "tag": tag}
    ok, why = shape_applicable(cfg, shape)
    if not ok:
        record.update(status="skipped", reason=why)
        return _dump(record, out_dir)
    chips = _chips(mesh)
    try:
        t0 = time.perf_counter()
        run, state, meta = build_cell(arch, shape_name, mesh,
                                      partitioned=partitioned, **opts)
        meta["tag"] = tag
        t_build = time.perf_counter() - t0
        with roofline.counting() as cnt:
            roofline.track(state)
            run()
        t_count = time.perf_counter() - t0 - t_build
        terms = roofline.roofline_terms(cnt, chips)
        total_p, active_p = roofline.count_params(cfg)
        mf = roofline.model_flops(cfg, shape)
        flops_global = cnt.flops * chips
        arg = _state_bytes(state)
        record.update(
            status="ok", meta=meta, build_s=round(t_build, 1),
            count_s=round(t_count, 1),
            memory_analysis={
                "argument_bytes": arg,
                "peak_bytes": cnt.peak_bytes,
                "temp_bytes": cnt.peak_bytes - arg,
                "output_bytes": None, "code_bytes": None,
                "null_reasons": {
                    "output_bytes": "the step's outputs are counted in "
                                    "peak_bytes, not apart",
                    "code_bytes": "no compiled program: eager ops and "
                                  "prebuilt kernels"},
                "source": "argument_bytes: the state's shards at the "
                          "specs; peak_bytes: live tensors in the counted "
                          "step (launch.roofline.counting)"},
            hlo_stats=cnt.to_dict(), roofline=terms,
            rates={k: roofline.HW[k] for k in
                   ("name", "power_limit_w", "source", "peak_flops",
                    "hbm_bw", "ici_bw", "dcn_bw")},
            params={"total": total_p, "active": active_p},
            model_flops=mf,
            useful_flops_ratio=(mf / flops_global) if flops_global else None,
        )
        print(f"[OK] {arch} {record['shape']} {record['mesh']}: count "
              f"{t_count:.1f}s dominant={terms['dominant']} "
              f"bound={terms['step_lower_bound_s'] * 1e3:.1f}ms "
              f"frac={terms['roofline_fraction']:.3f} "
              f"useful={record['useful_flops_ratio']:.3f}")
    except Exception as e:  # noqa: BLE001 — a failed cell is a bug to record
        record.update(status="error", error=f"{type(e).__name__}: {e}",
                      traceback=traceback.format_exc()[-4000:])
        print(f"[FAIL] {arch} {record['shape']} {record['mesh']}: {e}")
    return _dump(record, out_dir)


def _dump(record: dict, out_dir: str) -> dict:
    os.makedirs(out_dir, exist_ok=True)
    suffix = f"__{record['tag']}" if record.get("tag") else ""
    path = os.path.join(
        out_dir, f"{record['arch']}__{record['shape']}__{record['mesh']}"
                 f"{suffix}.json")
    with open(path, "w") as f:
        json.dump(record, f, indent=1, default=str)
    return record


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", choices=ARCHS)
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--mesh", choices=("single", "multi", "both"),
                    default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--accum", type=int, default=8)
    ap.add_argument("--seq-parallel", action="store_true")
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--partitioned", action="store_true",
                    help="count the paper's per-pod partitioned train step")
    ap.add_argument("--compress", action="store_true",
                    help="int8 error-free cross-pod gradient reduction")
    ap.add_argument("--capacity-factor", type=float, default=None)
    ap.add_argument("--remat-policy", default="full", choices=("full", "dots"))
    ap.add_argument("--accum-dtype", default="float32",
                    choices=("float32", "bfloat16"))
    ap.add_argument("--tag", default="", help="suffix for the output filename")
    args = ap.parse_args(argv)
    if not args.all and args.arch is None:
        ap.error("give --arch (and --shape), or --all")
    meshes = ("single", "multi") if args.mesh == "both" else (args.mesh,)
    cells = ([(a, s) for a in ARCHS for s in SHAPES]
             if args.all else [(args.arch, args.shape or "train_4k")])
    failures = 0
    t0 = time.perf_counter()
    for mk in meshes:
        with fake_world(mk == "multi") as mesh:
            for arch, shape in cells:
                rec = run_cell(arch, shape, mk, mesh, out_dir=args.out,
                               accum=args.accum,
                               seq_parallel=args.seq_parallel,
                               remat=not args.no_remat,
                               partitioned=args.partitioned,
                               compress=args.compress,
                               capacity_factor=args.capacity_factor,
                               remat_policy=args.remat_policy,
                               accum_dtype=args.accum_dtype, tag=args.tag)
                failures += rec["status"] == "error"
    print(f"dry run: {len(cells) * len(meshes)} cells in "
          f"{time.perf_counter() - t0:.1f} s, {failures} failed")
    raise SystemExit(1 if failures else 0)


if __name__ == "__main__":
    main()
