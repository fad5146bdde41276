#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py                 # every phase, about a minute
    python3 chip_smoke.py --phases card,build,check

Phases, in order:

1. ``card``   — the card's name and power limit (nvidia-smi), torch and CUDA.
2. ``build``  — nvcc builds ``csrc/`` into ``build/repro_torch/``, and
   beside it a variant with float32 sums (``-DFG_ACC=float``), both at once.
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

Tolerances (kernel against plain, both on the card): mu rtol = atol = 1e-4;
var rtol 1e-2, atol 1e-3; every adjoint relative L2 <= 1e-4.

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
          "twoch")

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
    from concurrent.futures import ThreadPoolExecutor
    from repro_torch.kernels import frontier_grid as fg
    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:
        for f in [pool.submit(fg.build, d) for d in ((), ACC32)]:
            f.result()
    ctx["build_s"] = time.perf_counter() - t0
    log(f"[build] {fg.BUILD_INFO['path']} in {ctx['build_s']:.1f} s")
    for line in fg.BUILD_INFO.get("log", "").splitlines():
        if "entry function" in line or "Used" in line or "spill" in line:
            log(f"[build] {line.strip()}")


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
           "profile": phase_profile,
           "twoch": phase_twoch}
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
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as fh:
        json.dump({"smi": ctx.get("smi"), "kernels": kernels,
                   "main_path_ms": ctx.get("main_path_ms"),
                   "tick": ctx.get("tick"), "acc32": ctx.get("acc32"),
                   "loop": ctx.get("loop"),
                   "launches": ctx.get("launches"),
                   "profile": ctx.get("profile"),
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
