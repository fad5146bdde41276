"""The host's time a decode step at full width: a prefill of ``--batch`` x
``--prompt`` tokens, then ``--steps`` greedy ``decode_step`` calls, timed
on the host clock (the card synchronized before and after each round), for
each ``--arch``. A step's dispatch time (the host returning from
``decode_step`` before the card has finished) is timed apart. Prints one
JSON line an arch, with a checksum of the last step's logits so that two
trees' runs can be seen to compute the same thing.

Its imports are absolute, so the same file times another checkout's
package on the same card:

    PYTHONPATH=src python src/repro_torch/bench/decode_host.py
    PYTHONPATH=<other checkout>/src python src/repro_torch/bench/decode_host.py

Weights come from ``--seed``; nothing is written.
"""
from __future__ import annotations

import argparse
import gc
import json
import statistics
import time

import torch

from repro_torch.configs import get_config
from repro_torch.models import build_model

ARCHS = ("qwen3-8b", "mamba2-2.7b", "deepseek-v2-lite-16b")


def time_decode(arch: str, batch: int, prompt: int, steps: int, rounds: int,
                seed: int, device: str, tiny: bool = False) -> dict:
    cfg = get_config(arch)
    cfg = cfg.tiny() if tiny else cfg
    model = build_model(cfg, device=device, seed=seed)
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    toks = torch.randint(0, cfg.vocab_size, (batch, prompt), generator=g,
                         device=device)
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    step_ms, dispatch_ms = [], []
    with torch.no_grad():
        for _ in range(rounds + 1):          # the first round warms up
            logits, cache = model.prefill(toks, cache_len=prompt + steps)
            nxt = logits[:, -1:].argmax(-1)
            sync()
            calls = []
            t0 = time.perf_counter()
            for _ in range(steps):
                c0 = time.perf_counter()
                logits, cache = model.decode_step(cache, nxt)
                calls.append(time.perf_counter() - c0)
                nxt = logits.argmax(-1)
            sync()
            step_ms.append(1e3 * (time.perf_counter() - t0) / steps)
            dispatch_ms.append(1e3 * statistics.median(calls))
    out = {"arch": cfg.name, "batch": batch, "prompt": prompt, "steps": steps,
           "step_ms": step_ms[1:], "dispatch_ms": dispatch_ms[1:],
           "step_ms_median": statistics.median(step_ms[1:]),
           "dispatch_ms_median": statistics.median(dispatch_ms[1:]),
           "tokens_per_s": 1e3 * batch / statistics.median(step_ms[1:]),
           "logits_sum": float(logits.float().sum())}
    del model, cache, logits
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", nargs="+", default=list(ARCHS))
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--prompt", type=int, default=16)
    ap.add_argument("--steps", type=int, default=32)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--tiny", action="store_true",
                    help="the archs' reduced configs (for the CPU)")
    args = ap.parse_args(argv)
    for arch in args.arch:
        print(json.dumps(time_decode(arch, args.batch, args.prompt,
                                     args.steps, args.rounds, args.seed,
                                     args.device, args.tiny)), flush=True)


if __name__ == "__main__":
    main()
