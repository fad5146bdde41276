"""Paper Figure 2: the parametric (mu, sigma^2) curve and its efficient
frontier, on the port.

401 values of f at the Fig 1 parameters (one forward call on the card).
Asserted: the curve folds (some mu values are attained at two f), the
efficient set is a proper arc, and the scalarized picks move along the
frontier monotonically in lambda. It also times the whole frontier
extraction on ``device``.

    PYTHONPATH=src python -m repro_torch.bench.fig2_frontier --device cpu
"""
from __future__ import annotations

import argparse

import numpy as np

from ..core import frontier_2ch, select_on_frontier
from ..device import resolve_device
from .common import emit, save_table, timeit
from .fig1_theory import MU_I, MU_J, NUM_T, SG_I, SG_J

NUM_F = 401
LAMS = (0.0, 0.5, 5.0)


def run(device="cuda") -> dict:
    """The figure on ``device``; returns the table, the picks and the
    summary."""
    dev = resolve_device(device)
    res = frontier_2ch(MU_I, SG_I, MU_J, SG_J, num_f=NUM_F, num_t=NUM_T,
                       device=dev)
    save_table("fig2_frontier.csv", "f,mu,var,efficient",
               zip(res.f, res.mu, res.var, res.efficient))

    # the curve folds back: mu values between the minimum and the lower
    # endpoint are attained at two different f (paper Fig 2)
    mu_mid = (res.mu.min() + min(res.mu[0], res.mu[-1])) / 2
    crossings = np.sum(np.diff(np.sign(res.mu - mu_mid)) != 0)
    assert crossings >= 2, "parametric curve should fold (paper Fig 2)"

    n_eff = int(res.efficient.sum())
    assert 2 <= n_eff < len(res.f), "frontier is a proper arc"

    # scalarized picks move along the frontier monotonically with lambda
    picks = [select_on_frontier(res, lam)[1] for lam in LAMS]
    mus = [p[1] for p in picks]
    vars_ = [p[2] for p in picks]
    assert mus == sorted(mus) and vars_ == sorted(vars_, reverse=True)

    us = timeit(lambda: frontier_2ch(MU_I, SG_I, MU_J, SG_J, num_f=NUM_F,
                                     num_t=NUM_T, device=dev),
                repeats=3, device=dev)
    emit("fig2_frontier_401f", us, f"n_efficient={n_eff}")
    return {"n_efficient": n_eff, "picks": picks, "frontier_us": us,
            "table": res}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    res = run(device=ap.parse_args(argv).device)
    print({k: v for k, v in res.items() if k != "table"})
    return res


if __name__ == "__main__":
    main()
