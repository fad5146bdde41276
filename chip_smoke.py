#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py                 # every phase, a few minutes
    python3 chip_smoke.py --phases card,build,check
    python3 chip_smoke.py --phases card,build,lmcheck,serve,lmtick

Phases, in order:

1. ``card``   — the card's name and power limit (nvidia-smi), torch and CUDA.
2. ``build``  — nvcc builds each library of ``csrc/`` into
   ``build/repro_torch/`` (frontier_grid, its float32-sum variant
   ``-DFG_ACC=float``, rmsnorm, attention), all four at once.
3. ``check``  — each CUDA kernel against its plain PyTorch version on the
   card: 5 families x {shared, per-row statistics} x {fwd, grad, pgrad} at
   F=256, K=128, T=256 with edge rows (a zero weight, a zero sigma, p=0, an
   argmax tie), one case at T=2048, and the launch shapes of one balancer
   refresh at K=1024 (``MAIN_PATH``), each also timed.
4. ``tick``   — the fleet tick, K=1024 channels, F=4096 candidates, T=256:
   kernel against plain, and their times, for fwd, grad and pgrad, three
   families.
5. ``acc32``  — what the float64 sums cost: the shipped kernels against the
   float32-sum build, interleaved, at the fleet tick and at a refresh's
   launch shapes, each also held against the plain version (reported, not
   asserted: the float32 sums are the reference's arithmetic).
6. ``loop``   — the main path: ``UncertaintyAwareBalancer(1024, lam=0.02,
   refresh_every=10, pgd_steps=60)`` against
   ``ClusterSim.heterogeneous(1024, seed=0)`` for 40 ticks, channel 0 slowed
   3x at tick 20, with policy "frontier", "equal", and "frontier" with
   adaptive refresh and risk_lam=0.5. Launch counters are zeroed before and
   read after; every mode must have launched.
7. ``profile`` — one warm balancer refresh at K=1024 on the host clock and
   under torch.profiler: device time by kernel and the busy share.
8. ``twoch``  — the two-channel quickstart through ``optimize_2ch``, on the
   card and on the CPU plain path.
9. ``lmcheck`` — the model kernels (rmsnorm, flash_attention, flash_decode)
   against their plain versions on the card, float32 and bf16, run twice
   (bitwise-equal): causal, window, GQA, rectangular, ragged and Qwen3-8B's
   own shapes; dead rows give 0; the tiny Qwen3 config on the card against
   the same weights on the CPU (prefill logits and greedy tokens).
10. ``serve`` — the model-serving path: full-width Qwen3-8B (36 layers,
   bf16, seeded weights drawn on the card) shared by two ReplicaGroups
   behind a PartitionedBatcher (policy frontier) on ClusterSim([Channel(20,
   2), Channel(14, 5)]); 5 batches of 64 prompts of 16 tokens, max_new 8.
   First the full-width prefill through the kernels against the plain
   versions. Launch counters are zeroed before the batches and read after;
   every model kernel and the frontier grad kernel must have launched; two
   generate calls on one batch must agree.
11. ``lmtick`` — each model kernel's time at the path's shapes and at the
   serving shapes cut to one layer (prefill_32k at B=1, decode_32k at B=32,
   32768 x 4096 norms), beside its bound, its plain version (where it fits)
   and the yardstick PyTorch call (scaled_dot_product_attention, rms_norm),
   which the port never calls.

Tolerances (kernel against plain, both on the card): mu rtol = atol = 1e-4;
var rtol 1e-2, atol 1e-3; every adjoint relative L2 <= 1e-4. Model kernels:
atol = rtol = 2e-4 in float32 and 1e-2 in bf16; the tiny model on the card
against the CPU at atol 2e-4 / rtol 2e-3; the full-width bf16 prefill
through the kernels against the plain versions at relative L2 < 0.1.

Any failure exits non-zero. Without a card, or without the repository's
``src/`` beside this script, it fails before printing a result. The line
before the last is a JSON object of per-kernel numbers; the last line is
``{"ok": true, "device": {...}}``. Details go to ``chiprun_out/``.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(HERE, "chiprun_out")

PHASES = ("card", "build", "check", "tick", "acc32", "loop", "profile",
          "twoch", "lmcheck", "serve", "lmtick")

# nvcc defines of the float32-sum variant of csrc/frontier_grid.cu
ACC32 = ("FG_ACC=float",)

# H100 SXM peaks (NVIDIA data sheet; 1.98 GHz boost): device memory, FP32
# outside the tensor cores, and the special function units (16 results per
# clock per SM on compute capability 9.0, x 132 SMs).
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
SFU_OPS_PER_S = 132 * 16 * 1.98e9

# Work per CDF evaluation C_k(t_j), counted from csrc/frontier_grid.cu.
# Pass 1 (every mode): erf and log are the special functions; the z-score,
# Phi's affine form, the clamp and the log-sum add are FP32 operations.
# Pass 2 (grad, pgrad): erf and exp (the pdf), and the gate, the ratio and
# up to six accumulator updates.
PASS1 = {"special": 2, "fp32": 8}
PASS2 = {"special": 2, "fp32": 16}

TOL_MU = 1e-4
TOL_VAR = (1e-2, 1e-3)
TOL_ADJ = 1e-4

KERNELS = {
    "fwd": ("frontier_grid", "src/repro/kernels/frontier_grid.py:245"),
    "grad": ("frontier_grid_with_grads", "src/repro/kernels/frontier_grid.py:419"),
    "pgrad": ("frontier_grid_with_grads[param_grads]",
              "src/repro/kernels/frontier_grid.py:419"),
}
SOURCE = "src/repro_torch/csrc/frontier_grid.cu"
MODES = tuple(KERNELS)


def log(*a):
    print(*a, flush=True)


def phase_card(ctx):
    import torch
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    ctx["smi"] = smi.stdout.strip().splitlines()[0]
    log(f"[card] {ctx['smi']}")
    log(f"[card] torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} devices {torch.cuda.device_count()}")


def phase_build(ctx):
    """Every library at once, one nvcc each: the frontier kernels, their
    float32-sum variant, RMSNorm, and attention (prefill and decode)."""
    from concurrent.futures import ThreadPoolExecutor
    from repro_torch.kernels import _cuda
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import frontier_grid as fg
    from repro_torch.kernels import rmsnorm as rn
    t0 = time.perf_counter()
    jobs = (lambda: fg.build(), lambda: fg.build(ACC32), rn.build, fa.build)
    with ThreadPoolExecutor(len(jobs)) as pool:
        for f in [pool.submit(job) for job in jobs]:
            f.result()
    ctx["build_s"] = time.perf_counter() - t0
    log(f"[build] {len(jobs)} libraries in {ctx['build_s']:.1f} s")
    for stem, info in sorted(_cuda.BUILD_INFO.items()):
        log(f"[build] {stem}: {info['path']} ({info['seconds']:.1f} s)")
        for line in info.get("log", "").splitlines():
            if "entry function" in line or "Used" in line or "spill" in line:
                log(f"[build]   {line.strip()}")


def _case(fam, F, K, per_row, seed, device):
    """Inputs with edge rows: row 0 has a zero weight, channel 3 a zero
    sigma, channel 5 p = 0 (defective), rows 2 and 3 an argmax tie between
    channels 0 and 1."""
    import numpy as np
    import torch
    from repro_torch.core import distributions as dists
    rng = np.random.default_rng(seed)
    W = rng.dirichlet(np.ones(K), F)
    W[0, 7] = 0.0
    shape = (F, K) if per_row else (K,)
    mus = rng.uniform(10.0, 40.0, shape)
    sgs = mus * rng.uniform(0.02, 0.3, shape)
    sgs[..., 3] = 0.0
    mus[..., 1] = mus[..., 0]
    sgs[..., 1] = sgs[..., 0]
    W[2:4, 0] = W[2:4, 1] = 0.5
    W[2:4, 2:] = 0.0
    W = W / W.sum(1, keepdims=True)
    ex_shape = shape
    if fam == "drift":
        ex = rng.uniform(0.0, 0.8, (1,) + ex_shape)
        ex[:, ..., 1] = ex[:, ..., 0]
    elif fam == "defective":
        ex = np.stack([rng.uniform(0.02, 0.3, ex_shape),
                       np.full(ex_shape, 1.0)])
        ex[0, ..., 5] = 0.0
        ex[0, ..., 1] = ex[0, ..., 0]
    elif fam == "empirical":
        pis = rng.dirichlet(np.ones(3), ex_shape)
        pis = np.moveaxis(pis, -1, 0)
        ms = mus[None] * rng.uniform(0.7, 1.3, (3,) + ex_shape)
        ss = np.maximum(sgs[None], 0.5) * rng.uniform(0.3, 1.0,
                                                      (3,) + ex_shape)
        ss[2, ..., 6] = 0.0
        ex = np.concatenate([pis, ms, ss])
        ex[:, ..., 1] = ex[:, ..., 0]
    else:
        ex = np.zeros((dists.extra_rows(fam),) + ex_shape)

    def t(x):
        return torch.tensor(np.asarray(x, np.float32), device=device)

    return t(W), t(mus), t(sgs), t(ex)


def _rel_l2(a, b):
    import torch
    den = torch.linalg.norm(b.double())
    num = torch.linalg.norm((a - b).double())
    return float(num / den) if float(den) > 0 else float(num)


def _compare(got, want):
    """(max |err| per output, relative L2 per adjoint, within tolerance)."""
    import torch
    errs = [float((g - w).abs().max()) for g, w in zip(got, want)]
    ok = bool(torch.allclose(got[0], want[0], rtol=TOL_MU, atol=TOL_MU))
    ok &= bool(torch.allclose(got[1], want[1], rtol=TOL_VAR[0],
                              atol=TOL_VAR[1]))
    rel = [_rel_l2(g, w) for g, w in zip(got[2:], want[2:])]
    ok &= all(r <= TOL_ADJ for r in rel)
    ok &= all(bool(torch.isfinite(g).all()) for g in got)
    return errs, rel, ok


def _report(phase, tag, errs, rel, ok):
    log(f"[{phase}] {tag} max|err| "
        + " ".join(f"{e:.2e}" for e in errs)
        + ("" if not rel else
           "  relL2(adj) " + " ".join(f"{r:.1e}" for r in rel))
        + ("  ok" if ok else "  FAIL"))


# The launches of one balancer refresh at K=1024 (sched/balancer.py with
# core/partitioner.py): the PGD steps (grad) over the warm, equal and
# inverse-mu starts at num_t=1024, the finalists (fwd) at eval_num_t=2048,
# and under risk_lam / adaptive_refresh the sensitivity launches (pgrad).
MAIN_PATH = (("grad", 3, 1024, 1024), ("fwd", 3, 1024, 2048),
             ("pgrad", 3, 1024, 1024), ("pgrad", 1, 1024, 1024))


def phase_check(ctx):
    import torch
    from repro_torch.core.distributions import FAMILIES
    from repro_torch.kernels import frontier_grid as fg, ref
    dev = torch.device("cuda")
    worst = {m: 0.0 for m in KERNELS}
    fails = []
    cases = [(fam, per_row, 256, 128, 256, MODES) for fam in FAMILIES
             for per_row in (False, True)]
    cases.append(("normal", False, 64, 128, 2048, MODES))
    cases += [("normal", False, F, K, T, (mode,))
              for mode, F, K, T in MAIN_PATH]
    main_ms = []
    for i, (fam, per_row, F, K, T, modes) in enumerate(cases):
        W, mus, sgs, ex = _case(fam, F, K, per_row, 100 + i, dev)
        for mode in modes:
            if mode == "fwd":
                def kern():
                    return fg.frontier_grid(W, mus, sgs, ex, num_t=T,
                                            dist_id=fam)
                want = ref.frontier_grid_ref(W, mus, sgs, num_t=T,
                                             dist_id=fam, extra=ex)
            else:
                def kern(pg=(mode == "pgrad")):
                    return fg.frontier_grid_with_grads(
                        W, mus, sgs, ex, num_t=T, dist_id=fam,
                        param_grads=pg)
                want = ref.frontier_grid_with_grads_ref(
                    W, mus, sgs, num_t=T, dist_id=fam, extra=ex,
                    param_grads=(mode == "pgrad"))
            got = kern()
            torch.cuda.synchronize()
            errs, rel, ok = _compare(got, want)
            worst[mode] = max(worst[mode], max(errs))
            tag = f"{fam:9s} {'per-row' if per_row else 'shared ':7s} " \
                  f"F={F} K={K} T={T} {mode:5s}"
            _report("check", tag, errs, rel, ok)
            if not ok:
                fails.append(tag)
            if len(modes) == 1:
                # a main-path launch: its time on the card at that shape
                ms = _time_cuda(kern, reps=9)
                bound_ms, by = _bound(mode, F, K, T, ex.shape[0], per_row)
                main_ms.append({"mode": mode, "F": F, "K": K, "T": T,
                                "ms": ms, "bound_ms": bound_ms,
                                "bound_by": by})
                log(f"[check] {tag} kernel {ms:.3f} ms  bound "
                    f"{bound_ms:.4f} ms ({by})")
    ctx["max_abs_err"] = worst
    ctx["main_path_ms"] = main_ms
    if fails:
        raise AssertionError(f"kernel/plain disagreement: {fails}")


def _time_cuda(fn, reps=7, warm=2):
    """Median milliseconds of ``fn`` over ``reps`` runs, CUDA events."""
    import torch
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def _bound(mode, F, K, T, E, per_row):
    """(bound_ms, bound_by): the larger of the bytes over the memory rate
    and the operations over their peak rates."""
    evals = F * T * K
    special = evals * PASS1["special"]
    fp32 = evals * PASS1["fp32"]
    if mode != "fwd":
        special += evals * PASS2["special"]
        fp32 += evals * PASS2["fp32"]
    stat = F * K if per_row else K
    n_fk = {"fwd": 0, "grad": 2, "pgrad": 8}[mode]
    nbytes = 4 * (F * K + (2 + E) * stat + 2 * F + n_fk * F * K)
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = max(special / SFU_OPS_PER_S, fp32 / FP32_OPS_PER_S)
    if t_bytes > t_ops:
        return 1e3 * t_bytes, "bytes"
    return 1e3 * t_ops, "operations"


def phase_tick(ctx):
    import numpy as np
    import torch
    from repro_torch.core.distributions import extra_rows
    from repro_torch.kernels import ops
    F, K, T = 4096, 1024, 256
    rng = np.random.default_rng(0)
    dev = "cuda"
    W = torch.tensor(rng.dirichlet(np.ones(K), F).astype(np.float32),
                     device=dev)
    mus = rng.uniform(10.0, 40.0, K).astype(np.float32)
    sgs = (mus * rng.uniform(0.02, 0.3, K)).astype(np.float32)
    fams = {"normal": "normal", "lognormal": "lognormal",
            "drift": ("drift", rng.uniform(0.1, 0.8, (1, K)).astype(
                np.float32))}
    mus_t = torch.tensor(mus, device=dev)
    sgs_t = torch.tensor(sgs, device=dev)
    rows, fails = [], []
    for name, fam in fams.items():
        dist_id, ex = ops._resolve_family(fam, K, torch.device(dev))
        for mode in ("fwd", "grad", "pgrad"):
            if mode == "fwd":
                def kern():
                    return ops.frontier_moments(W, mus_t, sgs_t, num_t=T,
                                                device=dev, family=fam)
            else:
                def kern(pg=(mode == "pgrad")):
                    return ops.frontier_moments_with_grads(
                        W, mus_t, sgs_t, num_t=T, device=dev, family=fam,
                        param_grads=pg)

            def plain(mode=mode):
                return ops.plain_moments(W, mus_t, sgs_t, ex, num_t=T,
                                         dist_id=dist_id, mode=mode)

            errs, rel, ok = _compare(kern(), plain())
            tag = f"{name:9s} {mode:5s} F={F} K={K} T={T}"
            _report("tick", tag, errs, rel, ok)
            if not ok:
                fails.append(tag)
            ms = _time_cuda(kern, reps=7)
            plain_ms = _time_cuda(plain, reps=3, warm=1)
            bound_ms, by = _bound(mode, F, K, T, extra_rows(dist_id), False)
            rows.append({"family": name, "mode": mode, "ms": ms,
                         "plain_ms": plain_ms, "bound_ms": bound_ms,
                         "bound_by": by, "max_abs_err": max(errs)})
            log(f"[tick] {tag} kernel {ms:.3f} ms  plain {plain_ms:.1f} ms  "
                f"bound {bound_ms:.3f} ms ({by})  kernel/bound "
                f"{ms / bound_ms:.1f}x")
            torch.cuda.empty_cache()
    ctx["tick"] = rows
    if fails:
        raise AssertionError(f"kernel/plain disagreement: {fails}")


# (family, mode, F, K, T, per-row statistics): the fleet tick, a refresh's
# launches at K=1024, and the shape where float32 sums missed the plain
# version most (ROADMAP section 3 item 3)
ACC32_CASES = (("normal", "fwd", 4096, 1024, 256, False),
               ("normal", "grad", 4096, 1024, 256, False),
               ("normal", "pgrad", 4096, 1024, 256, False),
               ("drift", "grad", 4096, 1024, 256, False),
               ("normal", "fwd", 3, 1024, 2048, False),
               ("normal", "grad", 3, 1024, 1024, False),
               ("normal", "pgrad", 3, 1024, 1024, False),
               ("drift", "pgrad", 256, 128, 256, True))


def phase_acc32(ctx):
    import torch
    from repro_torch.kernels import frontier_grid as fg, ops
    dev = torch.device("cuda")
    libs = {"f64": fg.build(), "f32": fg.build(ACC32)}
    rows = []
    for i, (fam, mode, F, K, T, per_row) in enumerate(ACC32_CASES):
        W, mus, sgs, ex = _case(fam, F, K, per_row, 300 + i, dev)

        def run(lib, mode=mode):
            if mode == "fwd":
                return fg.launch_fwd(lib, W, mus, sgs, ex, per_row, num_t=T,
                                     z=10.0, dist_id=fam)
            return fg.launch_grad(lib, W, mus, sgs, ex, per_row, num_t=T,
                                  z=10.0, dist_id=fam,
                                  param_grads=(mode == "pgrad"))

        want = ops.plain_moments(W, mus, sgs, ex, num_t=T, dist_id=fam,
                                 mode=mode)
        row = {"family": fam, "mode": mode, "F": F, "K": K, "T": T,
               "per_row": per_row}
        for name, lib in libs.items():
            got = run(lib)
            if not all(bool(torch.isfinite(g).all()) for g in got):
                raise AssertionError(f"{name} build gave non-finite output")
            errs, rel, _ = _compare(got, want)
            row[f"{name}_max_abs_err"] = max(errs)
            row[f"{name}_max_rel_l2_adj"] = max(rel) if rel else None
        # f64, f32, f32, f64: each build's time is the mean of its two
        times = {"f64": [], "f32": []}
        for name in ("f64", "f32", "f32", "f64"):
            times[name].append(_time_cuda(lambda: run(libs[name]), reps=7))
        for name, ts in times.items():
            row[f"{name}_ms"] = sum(ts) / len(ts)
        row["f64_over_f32"] = row["f64_ms"] / row["f32_ms"]
        rows.append(row)
        adj = ("" if row["f32_max_rel_l2_adj"] is None else
               f"  relL2(adj) f64 {row['f64_max_rel_l2_adj']:.1e} "
               f"f32 {row['f32_max_rel_l2_adj']:.1e}")
        log(f"[acc32] {fam:9s} {mode:5s} F={F} K={K} T={T}"
            f"{' per-row' if per_row else ''}: float64 sums "
            f"{row['f64_ms']:.3f} ms, float32 sums {row['f32_ms']:.3f} ms, "
            f"ratio {row['f64_over_f32']:.3f}; max|err| f64 "
            f"{row['f64_max_abs_err']:.1e} f32 {row['f32_max_abs_err']:.1e}"
            + adj)
        torch.cuda.empty_cache()
    ctx["acc32"] = rows


def _closed_loop(policy, device, ticks=40, K=1024, slow_at=20, **kw):
    import numpy as np
    import torch
    from repro_torch.sched import UncertaintyAwareBalancer
    from repro_torch.sim import ClusterSim
    bal = UncertaintyAwareBalancer(K, lam=0.02, refresh_every=10,
                                   pgd_steps=60, policy=policy,
                                   device=device, **kw)
    sim = ClusterSim.heterogeneous(K, seed=0)
    joins, tick_s, ws = [], [], []
    for t in range(ticks):
        if t == slow_at:
            sim.inject_slowdown(0, 3.0)
        t0 = time.perf_counter()
        w = bal.weights()
        if device != "cpu":
            torch.cuda.synchronize()
        tick_s.append(time.perf_counter() - t0)
        join, durs = sim.run_step(w)
        bal.observe(durs, w)
        joins.append(join)
        ws.append(w)
        if not (np.all(np.isfinite(w)) and w.shape == (K,)
                and abs(w.sum() - 1.0) < 1e-4 and w.min() >= 0.0):
            raise AssertionError(f"bad split at tick {t}: {w}")
    return np.asarray(joins), np.asarray(tick_s), np.asarray(ws)


def phase_loop(ctx):
    import numpy as np
    import torch
    from repro_torch.kernels import frontier_grid as fg
    # the closed loop agrees with the CPU plain path on a small fleet
    _, _, w_gpu = _closed_loop("frontier", "cuda", ticks=6, K=8, slow_at=3)
    _, _, w_cpu = _closed_loop("frontier", "cpu", ticks=6, K=8, slow_at=3)
    diff = float(np.abs(w_gpu - w_cpu).max())
    log(f"[loop] K=8 6 ticks cuda vs cpu plain: max |w diff| {diff:.2e}")
    if diff > 1e-3:
        raise AssertionError(f"cuda and cpu closed loops disagree: {diff}")

    torch.cuda.synchronize()
    fg.reset_launches()
    stats = {}
    for name, policy, kw in (("frontier", "frontier", {}),
                             ("equal", "equal", {}),
                             ("frontier+adaptive+risk", "frontier",
                              {"adaptive_refresh": True, "risk_lam": 0.5})):
        joins, tick_s, _ = _closed_loop(policy, "cuda", **kw)
        stats[name] = {"join_mean": float(joins.mean()),
                       "join_p99": float(np.percentile(joins, 99)),
                       "tick_mean_s": float(tick_s.mean()),
                       "tick_max_s": float(tick_s.max())}
        log(f"[loop] {name:23s} join mean {joins.mean():.4f} p99 "
            f"{np.percentile(joins, 99):.4f}  tick mean "
            f"{1e3 * tick_s.mean():.2f} ms max {1e3 * tick_s.max():.1f} ms")
    torch.cuda.synchronize()
    counts = dict(fg.LAUNCHES)
    ctx["launches"] = counts
    ctx["loop"] = stats
    log(f"[loop] launches {counts}")
    if min(counts.values()) <= 0:
        raise AssertionError(f"a kernel mode never launched: {counts}")
    if stats["frontier"]["join_mean"] >= stats["equal"]["join_mean"]:
        raise AssertionError("the frontier policy did not beat equal split")


def phase_profile(ctx):
    """Where one balancer refresh at K=1024 spends its time: a warm-started
    solve timed on the host clock, then the same solve under torch.profiler
    for the device time by kernel; busy share = device time / untraced
    wall time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.sched import UncertaintyAwareBalancer
    from repro_torch.sim import ClusterSim
    K = 1024
    bal = UncertaintyAwareBalancer(K, lam=0.02, refresh_every=1,
                                   pgd_steps=60, device="cuda")
    sim = ClusterSim.heterogeneous(K, seed=0)

    def refresh():
        w = bal.weights()
        torch.cuda.synchronize()
        _, d = sim.run_step(w)
        bal.observe(d, w)

    refresh()   # cold solve: no warm start yet
    t0 = time.perf_counter()
    refresh()
    wall_ms = 1e3 * (time.perf_counter() - t0)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        refresh()
        traced_ms = 1e3 * (time.perf_counter() - t0)
    by_name = {}
    for e in prof.key_averages():
        # device events only: a host op's self device time repeats its
        # kernels' time
        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0:
            by_name[e.key] = (by_name.get(e.key, 0.0)
                              + e.self_device_time_total / 1e3)
    dev_ms = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    prof.export_chrome_trace(os.path.join(OUT_DIR, "refresh_trace.json"))
    busy = dev_ms / wall_ms if dev_ms > 0 else None
    ctx["profile"] = {"wall_ms": wall_ms, "traced_wall_ms": traced_ms,
                      "device_ms": dev_ms if dev_ms > 0 else None,
                      "busy_share": busy,
                      "top": [{"name": n, "ms": ms} for n, ms in top]}
    log(f"[profile] one refresh at K={K}: wall {wall_ms:.2f} ms (traced "
        f"{traced_ms:.2f} ms), device "
        + (f"{dev_ms:.2f} ms, busy share {busy:.3f}" if busy is not None
           else "time not measured (the profiler saw no device time)"))
    for n, ms in top:
        log(f"[profile]   {ms:8.3f} ms  {n[:90]}")


def phase_twoch(ctx):
    import numpy as np
    from repro_torch.core import optimize_2ch
    # the paper's Fig. 1 parameters
    got = optimize_2ch(30.0, 2.0, 20.0, 6.0, lam=0.0, device="cuda")
    want = optimize_2ch(30.0, 2.0, 20.0, 6.0, lam=0.0, device="cpu")
    log(f"[twoch] cuda w={np.round(got.weights, 4)} mu={got.mu:.4f} "
        f"var={got.var:.4f}; cpu plain w={np.round(want.weights, 4)} "
        f"mu={want.mu:.4f}")
    if np.abs(got.weights - want.weights).max() > 1e-3 or \
            abs(got.mu - want.mu) > 1e-3 * abs(want.mu):
        raise AssertionError("two-channel split differs from the plain path")


# ---------------------------------------------------------------- model zoo
# Model kernels: JSON name, source, the Pallas kernel each replaces.
LM_KERNELS = {
    "rmsnorm": ("rmsnorm", "src/repro_torch/csrc/rmsnorm.cu",
                "src/repro/kernels/rmsnorm.py:21"),
    "flash_attention": ("flash_attention", "src/repro_torch/csrc/attention.cu",
                        "src/repro/kernels/flash_attention.py:83"),
    "flash_decode": ("flash_decode", "src/repro_torch/csrc/attention.cu",
                     "src/repro/kernels/flash_decode.py:68"),
}

# kernel against plain version on the card, per dtype (atol = rtol)
LM_TOL = {"float32": 2e-4, "bfloat16": 1e-2}
# the tiny model on the card against the same model on the CPU
MODEL_TOL = dict(atol=2e-4, rtol=2e-3)

BF16_OPS_PER_S = 989e12

# Qwen3-8B's serving path: 5 batches of 64 prompts of 16 tokens, max_new 8,
# split across two replica groups (about 32 prompts each)
SERVE_BATCHES, SERVE_REQUESTS, SERVE_PROMPT, SERVE_NEW = 5, 64, 16, 8

# (name, B, Hq, Hkv, Sq, Sk, D, causal, window)
ATTN_CASES = (
    ("causal", 2, 4, 4, 256, 256, 128, True, None),
    ("window64-ragged", 2, 4, 2, 300, 300, 64, True, 64),
    ("gqa4", 1, 8, 2, 200, 200, 128, True, None),
    ("rect-noncausal", 2, 4, 2, 100, 260, 64, False, None),
    ("noncausal-d80", 1, 4, 1, 128, 128, 80, False, None),
    ("qwen3-8b prefill", 32, 32, 8, 16, 16, 128, True, None),
    ("tiny prefill", 2, 4, 2, 16, 16, 16, True, None),
)
# (name, B, Hkv, G, S, D, valid slots)
DECODE_CASES = (
    ("qwen3-8b decode", 32, 8, 4, 24, 128, 17),
    ("qwen3-8b last step", 32, 8, 4, 24, 128, 24),
    ("g1-ragged", 2, 2, 1, 200, 64, 150),
    ("g8", 1, 1, 8, 256, 128, 256),
    ("tiny decode", 2, 2, 2, 20, 16, 17),
)
# (name, rows, D): Qwen3-8B's norms at the serving path's prefill (32 x 16
# tokens: ln1/ln2/final_norm, q_norm over 32 heads, k_norm over 8) and
# decode shapes, a ragged count and the tiny config
NORM_CASES = (("ln prefill", 512, 4096), ("q_norm prefill", 16384, 128),
              ("k_norm prefill", 4096, 128), ("ln decode", 32, 4096),
              ("ragged", 21, 4096), ("tiny", 7, 16))


def _lm_modules():
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import rmsnorm as rn
    return rn, fa, fd


def _reset_all():
    from repro_torch.kernels import frontier_grid as fg
    for mod in (fg, *_lm_modules()):
        mod.reset_launches()


def _lm_launches():
    out = {}
    for mod in _lm_modules():
        out.update(mod.LAUNCHES)
    return out


def _gen(seed):
    import torch
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    return g


def _randn(gen, shape, dtype):
    import torch
    return torch.randn(shape, generator=gen, device="cuda").to(dtype)


def _attn_inputs(case, dtype, seed):
    _, B, Hq, Hkv, Sq, Sk, D, _, _ = case
    g = _gen(seed)
    return (_randn(g, (B, Hq, Sq, D), dtype), _randn(g, (B, Hkv, Sk, D), dtype),
            _randn(g, (B, Hkv, Sk, D), dtype))


def _decode_inputs(case, dtype, seed):
    import torch
    _, B, Hkv, G, S, D, n_valid = case
    g = _gen(seed)
    valid = torch.zeros(S, dtype=torch.bool, device="cuda")
    valid[torch.randperm(S, generator=g, device="cuda")[:n_valid]] = True
    return (_randn(g, (B, Hkv, G, D), dtype), _randn(g, (B, Hkv, S, D), dtype),
            _randn(g, (B, Hkv, S, D), dtype), valid)


def _norm_inputs(rows, D, dtype, seed):
    g = _gen(seed)
    x = 3.0 * _randn(g, (rows, D), dtype)
    w = (1.0 + 0.1 * _randn(g, (D,), dtype).float()).to(dtype)
    return x, w


def phase_lmcheck(ctx):
    """Each model kernel against its plain version on the card, in float32
    and bf16, twice (bitwise-equal runs), plus the dead-row rule; then the
    tiny Qwen3 model on the card against itself on the CPU."""
    import torch
    from repro_torch.kernels import ops, ref
    fails, worst = [], {k: 0.0 for k in LM_KERNELS}

    def hold(kernel, tag, run, plain):
        got = run()
        again = run()
        want = plain()
        torch.cuda.synchronize()
        tol = LM_TOL[str(got.dtype).split(".")[-1]]
        err = float((got.float() - want.float()).abs().max())
        ok = bool(torch.allclose(got.float(), want.float(), atol=tol,
                                 rtol=tol))
        ok = ok and bool(torch.isfinite(got).all()) and torch.equal(got, again)
        worst[kernel] = max(worst[kernel], err)
        log(f"[lmcheck] {kernel:15s} {tag:40s} max|err| {err:.2e} "
            f"(tol {tol:g}) {'ok' if ok else 'FAIL'}")
        if not ok:
            fails.append(f"{kernel} {tag}")

    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[-1]
        for i, case in enumerate(ATTN_CASES):
            name, *_, causal, window = case
            q, k, v = _attn_inputs(case, dtype, 10 + i)
            hold("flash_attention", f"{name} {dn} {tuple(q.shape)}",
                 lambda: ops.attention(q, k, v, causal=causal, window=window),
                 lambda: ref.flash_attention_ref(q, k, v, causal=causal,
                                                 window=window))
        for i, case in enumerate(DECODE_CASES):
            q, k, v, valid = _decode_inputs(case, dtype, 30 + i)
            hold("flash_decode", f"{case[0]} {dn} S={case[4]}",
                 lambda: ops.decode_attention(q, k, v, valid),
                 lambda: ref.decode_attention_ref(q, k, v, valid))
        for i, (name, rows, D) in enumerate(NORM_CASES):
            x, w = _norm_inputs(rows, D, dtype, 50 + i)
            hold("rmsnorm", f"{name} {dn} ({rows}, {D})",
                 lambda: ops.rmsnorm(x, w, eps=1e-6),
                 lambda: ref.rmsnorm_ref(x, w, eps=1e-6))
    # dead rows: the kernels give 0 where the plain versions give NaN
    q, k, v = _attn_inputs(ATTN_CASES[0], torch.float32, 70)
    dead_fa = ops.attention(q, k, v, causal=True, window=0)
    qd, kd, vd, _ = _decode_inputs(DECODE_CASES[0], torch.float32, 71)
    none = torch.zeros(kd.shape[2], dtype=torch.bool, device="cuda")
    dead_fd = ops.decode_attention(qd, kd, vd, none)
    torch.cuda.synchronize()
    dead_ok = bool((dead_fa == 0).all()) and bool((dead_fd == 0).all())
    log(f"[lmcheck] dead rows (window=0; no valid slot) give 0: {dead_ok}")
    if not dead_ok:
        fails.append("dead rows")
    ctx["lm_max_abs_err"] = worst
    ctx["lmcheck_model"] = _tiny_model_check()
    if not ctx["lmcheck_model"]["ok"]:
        fails.append("tiny model cuda vs cpu")
    if fails:
        raise AssertionError(f"model kernel/plain disagreement: {fails}")


def _tiny_model_check():
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.serve import ServeEngine
    cfg = get_config("qwen3-8b").tiny()
    cpu = build_model(cfg, device="cpu", seed=0)
    gpu = build_model(cfg, device="cuda", seed=1)
    gpu.load_state_dict(cpu.state_dict())
    prompts = np.random.default_rng(0).integers(0, cfg.vocab_size, (4, 16))
    with torch.inference_mode():
        lc, _ = cpu.prefill(torch.as_tensor(prompts), cache_len=24)
        lg, _ = gpu.prefill(torch.as_tensor(prompts, device="cuda"),
                            cache_len=24)
    err = float((lg.cpu() - lc).abs().max())
    close = bool(torch.allclose(lg.cpu(), lc, **MODEL_TOL))
    tc = ServeEngine(cpu, cfg, device="cpu").generate(prompts, 8)
    tg = ServeEngine(gpu, cfg, device="cuda").generate(prompts, 8).cpu()
    same = bool(torch.equal(tc, tg))
    log(f"[lmcheck] tiny qwen3-8b f32 prefill logits cuda vs cpu max|err| "
        f"{err:.2e} ({'ok' if close else 'FAIL'}); greedy tokens equal: "
        f"{same}")
    return {"prefill_max_abs_err": err, "tokens_equal": same,
            "ok": close and same}


class _TimedEngine:
    """A ServeEngine whose generate calls are timed on the host clock,
    synchronized (the per-group generation wall time of a batch)."""

    def __init__(self, engine):
        self.engine, self.seconds = engine, []

    def generate(self, prompts, max_new):
        import torch
        t0 = time.perf_counter()
        out = self.engine.generate(prompts, max_new)
        torch.cuda.synchronize()
        self.seconds.append(time.perf_counter() - t0)
        return out


def _plain_ops():
    """The model's ops swapped for their plain versions (a comparison
    path, restored on exit)."""
    import contextlib
    from repro_torch.kernels import ops, ref

    @contextlib.contextmanager
    def swapped():
        saved = ops.attention, ops.decode_attention, ops.rmsnorm
        ops.attention = ref.flash_attention_ref
        ops.decode_attention = ref.decode_attention_ref
        ops.rmsnorm = ref.rmsnorm_ref
        try:
            yield
        finally:
            ops.attention, ops.decode_attention, ops.rmsnorm = saved
    return swapped()


def phase_serve(ctx):
    """The main path at full width: Qwen3-8B (36 layers, bf16, weights from
    a seeded generator on the card) shared by two replica groups behind a
    PartitionedBatcher (policy frontier) on ClusterSim([Channel(20, 2),
    Channel(14, 5)]), as ``launch/serve.py`` sets it up."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import frontier_grid as fg
    from repro_torch.models import build_model
    from repro_torch.serve import PartitionedBatcher, ReplicaGroup, ServeEngine
    from repro_torch.sim import Channel, ClusterSim
    cfg = get_config("qwen3-8b")
    t0 = time.perf_counter()
    model = build_model(cfg, device="cuda", seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    log(f"[serve] {cfg.name}: {cfg.num_layers} layers, d_model {cfg.d_model}"
        f", {n_params / 1e9:.3f} B parameters in {cfg.param_dtype}, drawn on "
        f"the card in {init_s:.1f} s; {torch.cuda.memory_allocated() / 1e9:.1f}"
        f" GB allocated")

    # full width, on a small input: the kernels' path against the same
    # model with the plain versions swapped in, both on the card
    rng = np.random.default_rng(0)
    small = torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, 16)),
                            device="cuda")
    with torch.inference_mode():
        lk, _ = model.prefill(small, cache_len=24)
        with _plain_ops():
            lp, _ = model.prefill(small, cache_len=24)
    lk, lp = lk[..., :cfg.vocab_size].float(), lp[..., :cfg.vocab_size].float()
    rel = float(torch.linalg.norm(lk - lp) / torch.linalg.norm(lp))
    agree = float((lk.argmax(-1) == lp.argmax(-1)).float().mean())
    finite = bool(torch.isfinite(lk).all())
    log(f"[serve] full-width prefill (2 x 16), kernels vs plain on the card: "
        f"relative L2 {rel:.2e}, argmax agreement {agree:.3f}, finite "
        f"{finite}")
    if not (rel < 0.1 and finite):
        raise AssertionError(f"full-width prefill disagrees: rel L2 {rel}")

    engine = ServeEngine(model, cfg)
    timed = [_TimedEngine(engine), _TimedEngine(engine)]
    groups = [ReplicaGroup("fast", timed[0]), ReplicaGroup("slow", timed[1])]
    sim = ClusterSim([Channel(mu=20.0, sigma=2.0), Channel(mu=14.0, sigma=5.0)])
    batcher = PartitionedBatcher(groups, policy="frontier", sim=sim)
    batches = []
    torch.cuda.synchronize()
    _reset_all()
    for i in range(SERVE_BATCHES):
        prompts = rng.integers(0, cfg.vocab_size,
                               (SERVE_REQUESTS, SERVE_PROMPT)).astype(np.int32)
        t0 = time.perf_counter()
        join, counts, resp = batcher.run_batch(prompts, max_new=SERVE_NEW,
                                               execute=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        gen_s = [t.seconds[-1] if c else 0.0 for t, c in zip(timed, counts)]
        for c, r in zip(counts, resp):
            if c and not (r.shape == (c, SERVE_NEW) and r.min() >= 0
                          and r.max() < cfg.vocab_size):
                raise AssertionError(f"bad response {r.shape} for {c}")
        tokens = int(counts.sum()) * SERVE_NEW
        batches.append({"split": counts.tolist(), "join_latency": join,
                        "generate_s": gen_s, "wall_s": wall,
                        "tokens_per_s": tokens / wall})
        log(f"[serve] batch {i}: split {counts.tolist()} join {join:.3f} s "
            f"(sim); generate {gen_s[0]:.3f} / {gen_s[1]:.3f} s; batch wall "
            f"{wall:.3f} s, {tokens / wall:.1f} tokens/s")
    torch.cuda.synchronize()
    counts = {**dict(fg.LAUNCHES), **_lm_launches()}
    log(f"[serve] launches {counts}")
    ctx["serve_launches"] = counts
    # the batcher's balancer solves its two-channel split on the card
    # through the frontier kernels (forward moments at K=2)
    frontier = sum(counts[m] for m in MODES)
    missing = [k for k in LM_KERNELS if counts[k] <= 0]
    if missing or frontier <= 0:
        raise AssertionError(f"the serving path never launched {missing} "
                             f"(frontier kernels: {frontier})")
    a = engine.generate(prompts, SERVE_NEW)
    b = engine.generate(prompts, SERVE_NEW)
    same = bool(torch.equal(a, b))
    log(f"[serve] two generate calls on one batch of {len(prompts)}: "
        f"identical tokens {same}")
    if not same:
        raise AssertionError("generate is not deterministic")
    prof = _profile_generate(engine, prompts[:SERVE_REQUESTS // 2])
    steady = batches[1:]
    ctx["serve"] = {
        "model": cfg.name, "params": n_params, "init_s": init_s,
        "full_width_rel_l2": rel, "full_width_argmax_agreement": agree,
        "batches": batches, "deterministic": same, "profile": prof,
        "tokens_per_s_steady": (sum(x["tokens_per_s"] for x in steady)
                                / len(steady)),
        "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    del model, engine, timed, groups, batcher
    torch.cuda.empty_cache()


def _profile_generate(engine, prompts):
    """One group's generate (prefill + decode steps) on the host clock and
    under torch.profiler: device time by kernel and the busy share."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine.generate(prompts, SERVE_NEW)
    torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        engine.generate(prompts, SERVE_NEW)
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0:
            by_name[e.key] = (by_name.get(e.key, 0.0)
                              + e.self_device_time_total / 1e3)
    dev_ms = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    busy = dev_ms / wall_ms if dev_ms > 0 else None
    log(f"[serve] one group's generate ({len(prompts)} prompts, {SERVE_NEW} "
        f"tokens): wall {wall_ms:.2f} ms, device "
        + (f"{dev_ms:.2f} ms, busy share {busy:.3f}" if busy is not None
           else "time not measured (the profiler saw no device time)"))
    for n, ms in top:
        log(f"[serve]   {ms:8.3f} ms  {n[:90]}")
    return {"wall_ms": wall_ms, "device_ms": dev_ms if dev_ms > 0 else None,
            "busy_share": busy,
            "top": [{"name": n, "ms": ms} for n, ms in top]}


def _roof(nbytes, t_ops):
    """(bound_ms, bound_by): the larger of the bytes over the memory rate
    and ``t_ops``, the operations over their peak rate (seconds)."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    if t_bytes >= t_ops:
        return 1e3 * t_bytes, "bytes"
    return 1e3 * t_ops, "operations"


def _fits(nbytes):
    import torch
    free, _ = torch.cuda.mem_get_info()
    return nbytes < 0.8 * free


def phase_lmtick(ctx):
    """Each model kernel's time at the serving path's shapes and at the
    repository's serving shapes cut to one layer, beside its bound, its
    plain version and the yardstick library call (timed here only)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref
    bf = torch.bfloat16
    rows = []

    def tick(kernel, shape, run, plain, library, bound, plain_bytes):
        ms = _time_cuda(run, reps=7)
        plain_ms = (_time_cuda(plain, reps=5, warm=1)
                    if _fits(plain_bytes) else None)
        lib_ms = _time_cuda(library, reps=7)
        bound_ms, by = bound
        rows.append({"kernel": kernel, "shape": shape, "ms": ms,
                     "plain_ms": plain_ms, "library_ms": lib_ms,
                     "bound_ms": bound_ms, "bound_by": by})
        log(f"[lmtick] {kernel:15s} {shape:46s} kernel {ms:9.4f} ms  plain "
            + (f"{plain_ms:9.4f}" if plain_ms is not None else "  no room")
            + f" ms  library {lib_ms:9.4f} ms  bound {bound_ms:.4f} ms ({by})"
            f"  kernel/bound {ms / bound_ms:.1f}x")
        torch.cuda.empty_cache()

    # flash_attention: the path (one group's prefill), then prefill_32k's
    # S = 32768 with B cut from 32 to 1
    for tag, B, S in (("path", 32, 16), ("serving prefill_32k B=1", 1, 32768)):
        Hq, Hkv, D = 32, 8, 128
        q, k, v = _attn_inputs(("", B, Hq, Hkv, S, S, D, True, None), bf, 90)
        nbytes = 2 * (2 * B * Hq * S * D + 2 * B * Hkv * S * D)
        flops = 4 * B * Hq * S * S * D / 2       # causal
        tick("flash_attention", f"{tag} (B={B}, Hq={Hq}, Hkv={Hkv}, S={S})",
             lambda: ops.attention(q, k, v, causal=True),
             lambda: ref.flash_attention_ref(q, k, v, causal=True),
             lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                    enable_gqa=True),
             _roof(nbytes, flops / BF16_OPS_PER_S),
             plain_bytes=4 * 3 * B * Hq * S * S)
        del q, k, v
    # flash_decode: the path's last step (cache of 24, all valid), then
    # decode_32k's S = 32768 with B cut from 128 to 32
    for tag, B, S in (("path", 32, 24), ("serving decode_32k B=32", 32, 32768)):
        Hkv, G, D = 8, 4, 128
        q, k, v, valid = _decode_inputs(("", B, Hkv, G, S, D, S), bf, 91)
        nbytes = 2 * (2 * B * Hkv * G * D + 2 * B * Hkv * S * D) + S
        tick("flash_decode", f"{tag} (B={B}, Hkv={Hkv}, G={G}, S={S})",
             lambda: ops.decode_attention(q, k, v, valid),
             lambda: ref.decode_attention_ref(q, k, v, valid),
             lambda: F.scaled_dot_product_attention(
                 q.reshape(B, Hkv * G, 1, D), k, v,
                 attn_mask=valid[None, None, None, :], enable_gqa=True),
             _roof(nbytes, 4 * B * Hkv * G * S * D / BF16_OPS_PER_S),
             plain_bytes=4 * 2 * B * Hkv * S * D)
        del q, k, v
    # rmsnorm: the path's residual-stream and per-head norms, then 32768
    # rows of 4096
    for tag, R, D in (("path ln (32 x 16 tokens)", 512, 4096),
                      ("path q_norm (32 x 16 x 32 heads)", 16384, 128),
                      ("serving 32768 x 4096", 32768, 4096)):
        x, w = _norm_inputs(R, D, bf, 92)
        tick("rmsnorm", f"{tag} ({R}, {D})",
             lambda: ops.rmsnorm(x, w, eps=1e-6),
             lambda: ref.rmsnorm_ref(x, w, eps=1e-6),
             lambda: F.rms_norm(x, (D,), w, 1e-6),
             _roof(2 * (2 * R * D + D), 4 * R * D / FP32_OPS_PER_S),
             plain_bytes=4 * 3 * R * D)
    ctx["lmtick"] = rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help=f"comma-separated subset of {PHASES}")
    args = ap.parse_args(argv)
    phases = [p for p in args.phases.split(",") if p]
    unknown = set(phases) - set(PHASES)
    if unknown:
        ap.error(f"unknown phases {sorted(unknown)}")

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    src = os.path.join(HERE, "src")
    if not os.path.isdir(os.path.join(src, "repro_torch")):
        print(f"chip_smoke: {src}/repro_torch not found: run from a checkout",
              file=sys.stderr)
        return 2
    sys.path.insert(0, src)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    ctx = {}
    t_start = time.perf_counter()
    os.makedirs(OUT_DIR, exist_ok=True)
    fns = {"card": phase_card, "build": phase_build, "check": phase_check,
           "tick": phase_tick, "acc32": phase_acc32, "loop": phase_loop,
           "profile": phase_profile, "twoch": phase_twoch,
           "lmcheck": phase_lmcheck, "serve": phase_serve,
           "lmtick": phase_lmtick}
    for p in PHASES:
        if p in phases:
            t0 = time.perf_counter()
            fns[p](ctx)
            log(f"[{p}] done in {time.perf_counter() - t0:.1f} s")

    kernels = []
    tick = {(r["family"], r["mode"]): r for r in ctx.get("tick", [])}
    for mode, (name, replaces) in KERNELS.items():
        r = tick.get(("normal", mode), {})
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": replaces,
            "launches": ctx.get("launches", {}).get(mode),
            "max_abs_err": ctx.get("max_abs_err", {}).get(mode),
            "ms": r.get("ms"), "plain_ms": r.get("plain_ms"),
            "bound_ms": r.get("bound_ms"), "bound_by": r.get("bound_by"),
            "library_ms": None})
    # the model kernels: times at the serving path's first shape of each
    path = {}
    for r in ctx.get("lmtick", []):
        if r["shape"].startswith("path"):
            path.setdefault(r["kernel"], r)
    for key, (name, source, replaces) in LM_KERNELS.items():
        r = path.get(key, {})
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": ctx.get("serve_launches", {}).get(key),
            "max_abs_err": ctx.get("lm_max_abs_err", {}).get(key),
            "ms": r.get("ms"), "plain_ms": r.get("plain_ms"),
            "bound_ms": r.get("bound_ms"), "bound_by": r.get("bound_by"),
            "library_ms": r.get("library_ms")})
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as fh:
        json.dump({"smi": ctx.get("smi"), "kernels": kernels,
                   "main_path_ms": ctx.get("main_path_ms"),
                   "tick": ctx.get("tick"), "acc32": ctx.get("acc32"),
                   "loop": ctx.get("loop"),
                   "launches": ctx.get("launches"),
                   "profile": ctx.get("profile"),
                   "lm_max_abs_err": ctx.get("lm_max_abs_err"),
                   "lmcheck_model": ctx.get("lmcheck_model"),
                   "serve": ctx.get("serve"),
                   "serve_launches": ctx.get("serve_launches"),
                   "lmtick": ctx.get("lmtick"),
                   "build_s": ctx.get("build_s"),
                   "seconds": time.perf_counter() - t_start}, fh, indent=1)
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(ctx.get("smi", ""))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
