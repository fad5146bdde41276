"""K-channel partitioning at fleet scale (64 / 256 / 1024 channels) with
online Bayesian estimation, a mid-run hotspot and the fleet's rebalance
ticks, on the port: the experiment of the repository's
``benchmarks/cluster_scale.py``.

1. Policy comparison on realized join-time mean / variance / p99, with
   channel 0 slowed 3x halfway:
     equal       — uniform split (the paper's foil),
     inverse_mu  — deterministic load balance (ignores variance),
     frontier    — the paper's mean-variance partitioner (K-channel PGD,
                   warm-started between refresh ticks),
   at 64, 256 and 1024 channels, plus lognormal and drift fleets at 64
   channels (the frontier solving under the fleet's family). Also the
   scheduler tick cost (posterior update + re-partition) at each size.
   Asserted: frontier beats equal on mean and p99 at every size.
2. The rebalance tick's FORWARD candidate sweep at K=1024 channels x
   F=4096 splits x T=256: the kernel (``ops.frontier_moments``) against
   the plain version over the same rows in chunks of 512 (the counterpart
   of the JAX package's chunked vmap over the quadrature oracle).
3. The PGD tick (forward + gradient) at the same scale: the fused adjoint
   launch (``frontier_moments_with_grads``) against ``torch.autograd``
   through the plain forward in the same chunks (the counterpart of
   autodiff through the chunked quadrature). Asserted: gradient parity,
   relative L2 <= 1e-4; ``pgd_speedup_vs_autodiff`` is recorded.
4. Family ticks: forward and fused launches under ``lognormal`` and
   ``drift`` (rhos on ~3% of the fleet), each with a gradient-parity
   spot check against autograd on 64 rows.
5. The auto-family tick: BIC-score a (rate, work) history of all K
   channels (``core.bayes.score_families``, batch EM included), instantiate
   the winner, run the fused launch under it, against the same launch with
   the family fixed up front (``auto_family_tick_overhead``; ``main`` holds
   it to 1.2x at full scale, last).
6. The timed autotune sweep of the fused tick (``autotune.sweep``, last,
   so no tick above runs a swept launch): on the card the model's split and
   its neighbours, on the CPU the plain path's rows per chunk, each held
   against the plain version before it is timed; the winner goes to the
   cache file and the in-process cache (``autotune_fused_<impl>_F..``).

Not ported: the JAX package's interpreted-kernel entries (the Pallas
interpreter has no torch twin); the JSON lists them under ``skipped`` with
the reason.

    PYTHONPATH=src python -m repro_torch.bench.cluster_scale --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.bench.cluster_scale --json   # the card

``--json`` writes ``experiments/torch/cluster_scale.json`` (``_smoke`` for
the smoke run), never a repository-root ``BENCH_*.json``.
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from ..core import Drift
from ..core.bayes import fit_selected_family, score_families
from ..core.distributions import lognormal_shape_np, resolve_family
from ..device import resolve_device
from ..kernels import autotune, ops, ref
from ..sched import UncertaintyAwareBalancer
from ..sim import ClusterSim
from .common import RESULTS_DIR, emit, save_table, timeit_stats

TICK_K = 1024      # channels per rebalance tick (fleet size)
TICK_F = 4096      # candidate splits per tick
TICK_T = 256       # survival-integral points per candidate
PLAIN_CHUNK = 512  # rows per chunk of the plain foil
PGD_LAM = 0.05     # scalarization weight in the PGD-tick objective
TICK_FAMILIES = ("lognormal", "drift")  # non-normal fleet-tick regimes
FLEETS = (64, 256, 1024)
POLICIES = ("equal", "inverse_mu", "frontier")

SCHEMA_KEYS = ("bench", "smoke", "device", "card", "pgd_speedup_vs_autodiff",
               "auto_family_tick_overhead", "entries", "skipped")
ENTRY_KEYS = ("name", "impl", "K", "F", "num_t", "family", "median_us",
              "p90_us", "repeats")

SKIPPED = (
    {"name": "fwd_tick_pallas_interpret",
     "reason": "the Pallas interpreter has no torch counterpart; the card "
               "runs the CUDA kernel, the CPU its plain version"},
    {"name": "pgd_tick_fused_pallas_interpret",
     "reason": "the Pallas interpreter has no torch counterpart"},
)


def _make_bench(entries, rows, prefix, emit_prefix, num_k, num_f, num_t,
                device, family="normal"):
    """Timing closure of the tick sections: times a thunk (each call
    synchronized on ``device``; one warm-up, the median of three, where the
    JAX package's benchmark took the upper of two), appends the CSV row and
    the JSON entry, emits the line and returns the last timed output."""
    impl = "cuda" if torch.device(device).type == "cuda" else "plain"

    def bench(name, fn, repeats=3):
        result = {}

        def once():
            result["v"] = fn()

        med, p90 = timeit_stats(once, repeats=repeats, warmup=1,
                                device=device)
        rows.append((num_k, num_f, num_t, f"{prefix}{name}", med))
        entries.append({"name": f"{prefix}{name}", "impl": impl, "K": num_k,
                        "F": num_f, "num_t": num_t, "family": family,
                        "median_us": med, "p90_us": p90, "repeats": repeats})
        emit(f"{emit_prefix}{num_k}ch_{num_f}cand_{name}", med)
        return result["v"]

    return bench


def _run_policy(n, policy, steps=120, seed=0, inject=True, dist="normal",
                family="normal", device="cuda"):
    """(join mean, join var, join p99, mean tick us) of one policy on
    ``ClusterSim.heterogeneous(n, seed, dist)``; joins after step 30."""
    sim = ClusterSim.heterogeneous(n, seed=seed, dist=dist)
    bal = UncertaintyAwareBalancer(n, lam=0.02, policy=policy, family=family,
                                   refresh_every=(1 if n <= 64 else 10),
                                   pgd_steps=(150 if n <= 256 else 60),
                                   device=device)
    times = []
    tick_costs = []
    for i in range(steps):
        t0 = time.perf_counter()
        w = bal.weights()
        tick_costs.append(time.perf_counter() - t0)
        t, durs = sim.run_step(w)
        bal.observe(durs, w)
        if inject and i == steps // 2:
            sim.inject_slowdown(0, 3.0)   # mid-run hotspot on channel 0
        if i >= 30:
            times.append(t)
    times = np.asarray(times)
    return (times.mean(), times.var(), np.percentile(times, 99),
            np.mean(tick_costs) * 1e6)


def policy_compare(device="cuda"):
    """Section 1: (CSV rows, {(n, policy): (mean, var, p99)})."""
    rows, out = [], {}
    for n in FLEETS:
        for policy in POLICIES:
            steps = 120 if n <= 256 else 60
            mu, var, p99, tick_us = _run_policy(n, policy, steps=steps,
                                                device=device)
            rows.append((n, policy, mu, var, p99, tick_us))
            out[(n, policy)] = (mu, var, p99)
            emit(f"cluster_{n}ch_{policy}", tick_us,
                 f"join_mu={mu:.3f};join_var={var:.4f};p99={p99:.3f}")
    # family-matched fleets: the sim draws lognormal / drifting ground
    # truth and the frontier solves under the same family; the drift
    # fleet's rates are unknown to the scheduler, so the solve takes the
    # rho_range midpoint as a drift-aware prior
    fam_for = {"lognormal": "lognormal", "drift": Drift(0.45)}
    for dist in ("lognormal", "drift"):
        for policy in ("equal", "frontier"):
            mu, var, p99, tick_us = _run_policy(
                64, policy, steps=100, dist=dist,
                family=(fam_for[dist] if policy == "frontier" else "normal"),
                device=device)
            rows.append((64, f"{dist}_{policy}", mu, var, p99, tick_us))
            out[(64, f"{dist}_{policy}")] = (mu, var, p99)
            emit(f"cluster_64ch_{dist}_{policy}", tick_us,
                 f"join_mu={mu:.3f};join_var={var:.4f};p99={p99:.3f}")
    return rows, out


def _tick_problem(num_k, num_f, seed=0, device="cuda"):
    """(W, mus, sigmas) of a fleet tick on ``device``: exponential rows
    normalized, mus U(10, 40), sigmas mus U(0.02, 0.3)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    e = rng.exponential(size=(num_f, num_k))
    W = torch.tensor(e / e.sum(1, keepdims=True), dtype=torch.float32,
                     device=dev)
    mus = rng.uniform(10, 40, num_k)
    sgs = mus * rng.uniform(0.02, 0.3, num_k)
    return (W, torch.tensor(mus, dtype=torch.float32, device=dev),
            torch.tensor(sgs, dtype=torch.float32, device=dev))


def _plain_chunked(W, mus, sigmas, num_t, dist_id="normal", extra=None):
    """The plain forward over W's rows in chunks of PLAIN_CHUNK."""
    outs = [ref.frontier_grid_ref(W[s:s + PLAIN_CHUNK], mus, sigmas,
                                  num_t=num_t, dist_id=dist_id, extra=extra)
            for s in range(0, W.shape[0], PLAIN_CHUNK)]
    return torch.cat([o[0] for o in outs]), torch.cat([o[1] for o in outs])


def _autodiff_chunked(W, mus, sigmas, num_t, lam, dist_id="normal",
                      extra=None):
    """d/dW of sum(mu + lam var) by ``torch.autograd`` through the plain
    forward, chunk by chunk (rows are independent, so the gradient of the
    sum is the per-row gradients)."""
    grads = []
    for s in range(0, W.shape[0], PLAIN_CHUNK):
        Wc = W[s:s + PLAIN_CHUNK].detach().requires_grad_(True)
        mu, var = ref.frontier_grid_ref(Wc, mus, sigmas, num_t=num_t,
                                        dist_id=dist_id, extra=extra)
        (g,) = torch.autograd.grad(torch.sum(mu + lam * var), Wc)
        grads.append(g)
    return torch.cat(grads)


def _rel(a, b) -> float:
    a, b = a.double(), b.double()
    return float(torch.linalg.norm(a - b) / torch.linalg.norm(b))


def tick_kernel_compare(entries, num_k=TICK_K, num_f=TICK_F, num_t=TICK_T,
                        device="cuda"):
    """Section 2: the forward candidate sweep, plain chunks against the
    kernel on the same grid: mu rtol = atol = 1e-4, var rtol 1e-2 and atol
    1e-3 (the kernels' tolerances against their plain version)."""
    W, mus, sgs = _tick_problem(num_k, num_f, device=device)
    rows = []
    bench = _make_bench(entries, rows, "fwd_tick_", "tick_", num_k, num_f,
                        num_t, device)
    mu_ref, var_ref = bench(f"plain_chunked{PLAIN_CHUNK}",
                            lambda: _plain_chunked(W, mus, sgs, num_t))
    mu_k, var_k = bench("kernel", lambda: ops.frontier_moments(
        W, mus, sgs, num_t=num_t, device=device))
    np.testing.assert_allclose(mu_k.cpu().numpy(), mu_ref.cpu().numpy(),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(var_k.cpu().numpy(), var_ref.cpu().numpy(),
                               rtol=1e-2, atol=1e-3)
    return rows


def tick_pgd_compare(entries, num_k=TICK_K, num_f=TICK_F, num_t=TICK_T,
                     device="cuda"):
    """Section 3: one PGD tick, ``torch.autograd`` through the plain
    forward against the fused adjoint launch; returns (rows, speedup,
    gradient relative L2)."""
    W, mus, sgs = _tick_problem(num_k, num_f, device=device)
    rows = []
    bench = _make_bench(entries, rows, "pgd_tick_", "pgd_tick_", num_k,
                        num_f, num_t, device)
    g_auto = bench("autodiff_plain",
                   lambda: _autodiff_chunked(W, mus, sgs, num_t, PGD_LAM))
    auto_med = rows[-1][4]
    outs = bench("fused", lambda: ops.frontier_moments_with_grads(
        W, mus, sgs, num_t=num_t, device=device))
    fused_med = rows[-1][4]
    g_fused = outs[2] + PGD_LAM * outs[3]
    # the speedup must not come from computing a different gradient
    rel = _rel(g_fused, g_auto)
    emit("pgd_tick_grad_parity", rel * 1e6, "norm_rel_x1e6")
    assert rel <= 1e-4, f"gradient parity broke: {rel}"
    speedup = auto_med / fused_med
    emit(f"pgd_tick_{num_k}ch_{num_f}cand_speedup", speedup,
         "fused_vs_autodiff")
    return rows, speedup, rel


def tick_family_compare(entries, num_k=TICK_K, num_f=TICK_F, num_t=TICK_T,
                        families=TICK_FAMILIES, device="cuda"):
    """Section 4: forward and fused launches under the non-normal
    families, each fused gradient held against autograd on 64 rows."""
    W, mus, sgs = _tick_problem(num_k, num_f, device=device)
    rng = np.random.default_rng(11)
    rows, parity = [], {}
    for fam_name in families:
        if fam_name == "drift":
            rho = np.where(rng.random(num_k) < 0.03,
                           rng.uniform(0.5, 2.0, num_k), 0.0)
            family = Drift(rho.astype(np.float32))
        else:
            family = fam_name
        dist_id, extra = resolve_family(family, num_k)
        extra = torch.as_tensor(np.asarray(extra), dtype=torch.float32,
                                device=W.device)
        bench = _make_bench(entries, rows, f"{fam_name}_tick_", "fam_tick_",
                            num_k, num_f, num_t, device, family=fam_name)
        bench("fwd", lambda: ops.frontier_moments(
            W, mus, sgs, num_t=num_t, device=device,
            family=(dist_id, extra)))
        outs = bench("fused", lambda: ops.frontier_moments_with_grads(
            W, mus, sgs, num_t=num_t, device=device,
            family=(dist_id, extra)))
        # parity spot check on a candidate slice (the normal section times
        # the full-batch autodiff)
        ns = min(num_f, 64)
        dmu_a = _autodiff_chunked(W[:ns], mus, sgs, num_t, 0.0,
                                  dist_id=dist_id, extra=extra)
        rel = _rel(outs[2][:ns], dmu_a)
        parity[fam_name] = rel
        emit(f"fam_tick_grad_parity_{fam_name}", rel * 1e6, "norm_rel_x1e6")
        assert rel <= 1e-4, f"family gradient parity broke on {fam_name}: {rel}"
    return rows, parity


def tick_auto_family_compare(entries, num_k=TICK_K, num_f=TICK_F,
                             num_t=TICK_T, window=96, device="cuda"):
    """Section 5: one ``family="auto"`` tick (score, instantiate, fused
    launch) against the fused launch with the family fixed up front;
    returns (rows, overhead ratio, the winning family)."""
    W, mus, sgs = _tick_problem(num_k, num_f, device=device)
    rng = np.random.default_rng(7)
    # a lognormal history: the selector has a real family to find, so the
    # scoring pass does its full work
    mu_h = mus.cpu().numpy().astype(np.float64)
    sg_h = mu_h * rng.uniform(0.25, 0.5, num_k)
    s_l, base = lognormal_shape_np(mu_h, sg_h)
    rates = rng.lognormal(base, s_l, size=(window, num_k)).astype(np.float32)
    works = rng.uniform(0.5 / num_k, 2.0 / num_k,
                        size=(window, num_k)).astype(np.float32)
    mask = np.ones((window, num_k), np.float32)

    rows = []
    bench = _make_bench(entries, rows, "auto_tick_", "auto_tick_", num_k,
                        num_f, num_t, device, family="auto")
    fixed_fam = fit_selected_family(score_families(rates, works, mask))
    dist_id, extra = resolve_family(fixed_fam, num_k)
    extra_t = torch.as_tensor(np.asarray(extra), dtype=torch.float32,
                              device=W.device)

    def fused(ex):
        return ops.frontier_moments_with_grads(
            W, mus, sgs, num_t=num_t, device=device, family=(dist_id, ex))

    bench(f"fixed_{dist_id}_fused", lambda: fused(extra_t))
    fixed_med = rows[-1][4]

    def auto_tick():
        fam = fit_selected_family(score_families(rates, works, mask))
        d_id, ex = resolve_family(fam, num_k)
        assert d_id == dist_id  # the same winner: the same kernel
        return fused(torch.as_tensor(np.asarray(ex), dtype=torch.float32,
                                     device=W.device))

    bench("score_plus_fused", auto_tick)
    ratio = rows[-1][4] / fixed_med
    emit(f"auto_tick_{num_k}ch_{num_f}cand_overhead", ratio,
         f"auto_vs_fixed_{dist_id};accept<=1.2")
    return rows, ratio, dist_id


def tick_sweep(entries, num_k, num_f, num_t, device, cache_path=None,
               repeats: int = 3) -> dict:
    """The timed autotune sweep of the fused (grad) tick at (num_k, num_f,
    num_t) on ``device`` (``kernels.autotune.sweep``): emits and records
    the winner and returns its cache entry."""
    impl = "cuda" if torch.device(device).type == "cuda" else "plain"
    entry = autotune.sweep(num_f, num_k, num_t, mode="grad",
                           dist_id="normal", repeats=repeats,
                           cache_path=cache_path, device=device)
    name = f"autotune_fused_{impl}_F{num_f}_K{num_k}_T{num_t}"
    plan = (f"threads={entry['threads']};split={entry['value']}"
            if impl == "cuda" else f"block_rows={entry['value']}")
    emit(name, entry["us"], f"{plan};model={entry['model']}")
    entries.append({"name": name, "impl": impl, "K": num_k, "F": num_f,
                    "num_t": num_t, "family": "normal",
                    "median_us": entry["us"], "p90_us": None,
                    "repeats": repeats, "plan": entry["value"],
                    "timings": entry["timings"], "model": entry["model"]})
    return entry


def run(smoke=False, ticks_only=False, device="cuda", sweep=True) -> dict:
    """The experiment on ``device``; asserts the policy checks and the
    gradient parities, returns the results (``entries`` for the JSON).
    ``sweep`` runs the timed autotune sweep last, into
    ``autotune.default_cache_path()``."""
    dev = resolve_device(device)
    out = {}
    if not ticks_only:
        rows, out = policy_compare(dev)
        save_table("cluster_scale.csv",
                   "n,policy,join_mu,join_var,p99,tick_us", rows)

    if smoke:
        num_k, num_f, num_t = 64, 256, 128
    else:
        num_k, num_f, num_t = TICK_K, TICK_F, TICK_T
    entries = []
    for s in SKIPPED:
        emit(s["name"], 0.0, "SKIPPED: " + s["reason"])
    tick_rows = tick_kernel_compare(entries, num_k, num_f, num_t, dev)
    pgd_rows, speedup, grad_rel = tick_pgd_compare(entries, num_k, num_f,
                                                   num_t, dev)
    if dev.type == "cuda":
        torch.cuda.empty_cache()   # the autograd foil's saved tensors
    fam_rows, fam_rel = tick_family_compare(entries, num_k, num_f, num_t,
                                            device=dev)
    auto_rows, auto_ratio, auto_family = tick_auto_family_compare(
        entries, num_k, num_f, num_t, device=dev)
    if sweep:
        tick_sweep(entries, num_k, num_f, num_t, dev)
    # smoke rows go to their own table
    save_table("cluster_tick_kernel_smoke.csv" if smoke
               else "cluster_tick_kernel.csv", "K,F,num_t,path,us_per_tick",
               tick_rows + pgd_rows + fam_rows + auto_rows)

    if not ticks_only:
        for n in FLEETS:
            eq, fr = out[(n, "equal")], out[(n, "frontier")]
            assert fr[0] < eq[0], f"frontier should beat equal mean at n={n}"
            assert fr[2] < eq[2], f"frontier should beat equal p99 at n={n}"
    return {"policies": {f"{n}:{p}": list(map(float, v))
                         for (n, p), v in out.items()},
            "pgd_speedup_vs_autodiff": speedup, "grad_rel_l2": grad_rel,
            "family_grad_rel_l2": fam_rel,
            "auto_family_tick_overhead": auto_ratio,
            "auto_family": auto_family, "entries": entries,
            "skipped": list(SKIPPED), "device": str(dev),
            "card": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                     else None), "K": num_k, "F": num_f, "num_t": num_t}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--json", action="store_true",
                    help="write experiments/torch/cluster_scale[_smoke].json")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced tick scale (K=64, F=256, T=128)")
    ap.add_argument("--ticks-only", action="store_true",
                    help="skip the (slow) policy comparison")
    ap.add_argument("--out", default=None, help="JSON output path")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    args = ap.parse_args(argv)

    res = run(smoke=args.smoke, ticks_only=args.ticks_only,
              device=args.device)
    if args.json:
        path = args.out or os.path.join(
            RESULTS_DIR, "cluster_scale_smoke.json" if args.smoke
            else "cluster_scale.json")
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as fh:
            json.dump({"bench": "cluster_scale", "smoke": args.smoke, **{
                k: res[k] for k in SCHEMA_KEYS if k in res}}, fh, indent=1,
                sort_keys=True)
        print(f"wrote {path}")
    print({k: v for k, v in res.items() if k not in ("entries", "skipped")})
    if not args.smoke:
        # the acceptance gate last, after every artifact is on disk: model
        # selection must ride the tick, not dominate it
        ratio = res["auto_family_tick_overhead"]
        assert ratio <= 1.2, \
            f"auto-family tick overhead {ratio:.3f}x exceeds the 1.2x bound"
    return res


if __name__ == "__main__":
    main()
