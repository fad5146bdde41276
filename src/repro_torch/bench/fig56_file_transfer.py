"""Paper Figures 5 and 6: dual-path file transmission (NY->SG direct
against NY->London->SG overlay), 20 024 trials with randomized f, on the
port.

The two WAN paths are simulated channels with normal per-unit transfer
times (``ClusterSim(seed=42)``; f drawn from ``default_rng(7)``): the
draws are the JAX package's, so the empirical columns are its columns bit
for bit. Per trial f is drawn from {0, 0.1, ..., 1}, the two shards
transfer in parallel and the join time is recorded; then

* Fig 5: the f = 0.5 histogram is approximately normal (skew, kurtosis),
* Fig 6: empirical mu(f), sigma^2(f) against the theory curves of
  ``core.curve_2ch`` (one forward call on ``device``).

    PYTHONPATH=src python -m repro_torch.bench.fig56_file_transfer --device cpu
"""
from __future__ import annotations

import argparse

import numpy as np

from ..core import curve_2ch
from ..device import resolve_device
from ..sim import Channel, ClusterSim
from .common import emit, save_table, timeit

# path stats (s per file): the direct Pacific path is faster but jittery at
# peak hours, the Europe overlay slower but steadier; at f = 0.5 one path
# clearly bottlenecks, the regime in which the paper's Fig 5 observed
# normal join times
MU_I, SG_I = 26.0, 1.6    # NY -> London -> SG overlay
MU_J, SG_J = 16.0, 3.0    # NY -> SG via Pacific
TRIALS = 20_024           # the paper's trial count
NUM_T = 2048


def run(device="cuda") -> dict:
    """The experiment, its theory curve on ``device``; returns the Fig 6
    table, the f = 0.5 histogram and the summary."""
    dev = resolve_device(device)
    sim = ClusterSim([Channel(MU_I, SG_I), Channel(MU_J, SG_J)], seed=42)

    fs = np.round(np.arange(0.0, 1.01, 0.1), 2)
    rng = np.random.default_rng(7)
    samples = {f: [] for f in fs}
    for _ in range(TRIALS):
        f = fs[rng.integers(0, len(fs))]
        t, _ = sim.run_step([f, 1 - f])
        samples[f].append(t)

    # Fig 5: f = 0.5 completion times approximately normal
    h = np.asarray(samples[0.5])
    skew = float(np.mean(((h - h.mean()) / h.std()) ** 3))
    kurt = float(np.mean(((h - h.mean()) / h.std()) ** 4) - 3.0)
    assert abs(skew) < 0.35 and abs(kurt) < 0.6, (skew, kurt)
    save_table("fig5_hist_f05.csv", "t", [(x,) for x in h])

    # Fig 6: empirical against theoretical moments
    _, th_mu, th_var = curve_2ch(MU_I, SG_I, MU_J, SG_J, num_f=len(fs),
                                 num_t=NUM_T, device=dev)
    th_mu, th_var = th_mu.cpu().numpy(), th_var.cpu().numpy()
    rows = []
    max_rel_mu = 0.0
    for i, f in enumerate(fs):
        e_mu, e_var = np.mean(samples[f]), np.var(samples[f])
        t_mu, t_var = float(th_mu[i]), float(th_var[i])
        rows.append((f, e_mu, e_var, t_mu, t_var, len(samples[f])))
        if t_mu > 0:
            max_rel_mu = max(max_rel_mu, abs(e_mu - t_mu) / t_mu)
    save_table("fig6_file_transfer.csv",
               "f,emp_mu,emp_var,theory_mu,theory_var,n", rows)
    assert max_rel_mu < 0.05, \
        f"empirical mu deviates {max_rel_mu:.1%} from theory"

    e_mus = np.array([r[1] for r in rows])
    e_vars = np.array([r[2] for r in rows])
    assert e_mus.min() < min(e_mus[0], e_mus[-1])    # the paper's headline
    assert e_vars.min() < min(e_vars[0], e_vars[-1])

    us = timeit(lambda: [sim.run_step([0.5, 0.5]) for _ in range(100)],
                repeats=3)
    emit("fig56_transfer_100trials", us,
         f"skew={skew:.3f};kurt={kurt:.3f};max_rel_mu_err={max_rel_mu:.3f}")
    return {"skew": skew, "kurt": kurt, "max_rel_mu_err": max_rel_mu,
            "rows": rows, "hist_f05": h}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    res = run(device=ap.parse_args(argv).device)
    print({k: res[k] for k in ("skew", "kurt", "max_rel_mu_err")})
    return res


if __name__ == "__main__":
    main()
