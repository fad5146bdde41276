"""Paper Figure 1 (a, b): the theoretical mu(f) and sigma^2(f) curves, on
the port.

The paper's parameterization mu_i = 30, sigma_i = 2, mu_j = 20, sigma_j = 6
at 201 values of f and 2048 quadrature points (one ``frontier_2ch`` call:
the forward frontier kernel on the card), with the paper's claims asserted:

* both minima lie far below the best single channel,
* the minima occur at different f (an efficient range, not a point).

It also times the 201-row forward call on ``device``.

    PYTHONPATH=src python -m repro_torch.bench.fig1_theory --device cpu
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from ..core import frontier_2ch
from ..device import resolve_device
from ..kernels import ops
from .common import emit, save_table, timeit

MU_I, SG_I, MU_J, SG_J = 30.0, 2.0, 20.0, 6.0   # the paper's Fig 1
NUM_F = 201
NUM_T = 2048


def curve_inputs(device="cuda"):
    """(W, mus, sigmas) of the figure's curve on ``device``: the rows
    (f, 1 - f) for NUM_F values of f, the two channels' statistics."""
    dev = resolve_device(device)
    fs = torch.linspace(0.0, 1.0, NUM_F, device=dev)
    return (torch.stack([fs, 1.0 - fs], -1),
            torch.tensor([MU_I, MU_J], device=dev),
            torch.tensor([SG_I, SG_J], device=dev))


def curve_call(device="cuda"):
    """The timed call: one forward moments call over the figure's rows;
    returns a thunk giving (mu, var) on ``device``."""
    dev = resolve_device(device)
    W, mus, sgs = curve_inputs(dev)

    def call():
        # repro: allow[RPA070] paper Fig 1 reproduction — the figure's
        # quadrature is part of what is being reproduced, not a solve knob
        return ops.frontier_moments(W, mus, sgs, num_t=NUM_T, device=dev)

    return call


def run(device="cuda") -> dict:
    """The figure on ``device``; returns the table and the summary."""
    dev = resolve_device(device)
    res = frontier_2ch(MU_I, SG_I, MU_J, SG_J, num_f=NUM_F, num_t=NUM_T,
                       device=dev)
    i_mu, i_var = int(np.argmin(res.mu)), int(np.argmin(res.var))
    save_table("fig1_theory.csv", "f,mu,var,efficient",
               zip(res.f, res.mu, res.var, res.efficient))

    # the paper's claims
    assert res.mu[i_mu] < 20.0, "partition must beat the fastest channel"
    assert res.var[i_var] < 4.0, "partition must beat the most stable channel"
    assert i_mu != i_var, "mu and var minima at different f (paper Fig 1)"

    us = timeit(curve_call(dev), repeats=3, warmup=1, device=dev)
    emit("fig1_theory_curve_201f", us,
         f"f*mu={res.f[i_mu]:.2f};mu_min={res.mu[i_mu]:.2f};"
         f"f*var={res.f[i_var]:.2f};var_min={res.var[i_var]:.3f}")
    return {"f_mu": float(res.f[i_mu]), "mu_min": float(res.mu[i_mu]),
            "f_var": float(res.f[i_var]), "var_min": float(res.var[i_var]),
            "curve_us": us, "table": res}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    res = run(device=ap.parse_args(argv).device)
    print({k: v for k, v in res.items() if k != "table"})
    return res


if __name__ == "__main__":
    main()
