"""The partitioned train step on a world of 2 over gloo, on the CPU.

Two spawned processes, one pod each, on a ``("pod", "data", "model")``
mesh of shape (2, 1, 1) (``launch.mesh.make_mesh``): pod p takes its two
rows of a (3, 4, 16) slab and runs ``k[p]`` of the split k = [2, 1]; one
``all_reduce`` joins gradients, loss and tokens (or, with
``compress_pod_reduce``, an ``all_gather`` of int8 blocks and scales and a
dequantized sum in pod order). Held against one process that computes both
pods' slabs with the same loss and sums them (the same dequantization when
compressed): tokens equal, loss and every updated parameter bit for bit
(each pod's sums run in its own process exactly as in the single one, and
a sum of two terms does not depend on their order). The processes have a
60 s timeout of their own. This file imports no JAX.
"""
import functools
import os
import socket
from datetime import timedelta

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from repro_torch.configs import get_config
from repro_torch.models import build_model
from repro_torch.optim import adamw
from repro_torch.optim.compress import dequantize_int8, quantize_int8
from repro_torch.train import step as tstep

K_PODS = (2, 1)
MAX_MICRO = 3
TIMEOUT_S = 60


def _setup():
    cfg = get_config("smollm-360m").tiny()
    model = build_model(cfg, device="cpu", seed=0, trainable=True)
    tokens = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (MAX_MICRO, 4, 16)).astype(np.int64)
    labels = np.roll(tokens, -1, axis=2)
    labels[:, 0, :2] = -1
    return cfg, model, torch.as_tensor(tokens), torch.as_tensor(labels)


def _lr():
    return adamw.cosine_schedule(1e-3, 2, 10)


def _worker(rank, port, compress, out_dir):
    torch.set_num_threads(1)
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=2,
                            timeout=timedelta(seconds=TIMEOUT_S))
    try:
        mesh = make_mesh((2, 1, 1), ("pod", "data", "model"), "cpu")
        cfg, model, tokens, labels = _setup()
        step = tstep.make_partitioned_train_step(
            model, cfg, mesh, _lr(), max_micro=MAX_MICRO,
            compress_pod_reduce=compress)
        state, metrics = step(tstep.init_state(model), tokens, labels,
                              np.asarray(K_PODS))
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"),
                 loss=metrics["loss"].numpy(),
                 tokens=metrics["tokens"].numpy(),
                 **{f"p/{k}": v.detach().numpy()
                    for k, v in state.params.items()})
    finally:
        dist.destroy_process_group()


def _one_process(compress):
    """Both pods' slabs in this process, summed."""
    cfg, model, tokens, labels = _setup()
    state = tstep.init_state(model)
    grad_fn = tstep.value_and_grad(tstep.make_loss_fn(model, cfg,
                                                      reduce="sum"))
    parts, loss, toks = [], 0.0, 0.0
    for p, k in enumerate(K_PODS):
        rows = slice(2 * p, 2 * p + 2)
        g = {n: torch.zeros(t.shape) for n, t in state.params.items()}
        lsum = torch.zeros(())
        tsum = torch.zeros(())
        for i in range(k):
            (li, m), gi = grad_fn(state.params, tokens[i, rows],
                                  labels[i, rows], None)
            g = {n: a + gi[n].float() for n, a in g.items()}
            lsum, tsum = lsum + li, tsum + m["tokens"]
        if compress:
            g = {n: dequantize_int8(*quantize_int8(a), a.shape, torch.float32)
                 for n, a in g.items()}
        parts.append(g)
        loss, toks = loss + lsum, toks + tsum
    total = {n: functools.reduce(torch.add, [q[n] for q in parts])
             for n in parts[0]}
    denom = torch.clamp(toks, min=1.0)
    params, _, _ = adamw.adamw_update(
        state.params, {n: g / denom for n, g in total.items()}, state.opt,
        _lr())
    return loss / denom, toks, params


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("compress", [False, True],
                         ids=["all_reduce", "int8_all_gather"])
def test_partitioned_step_world_of_two(compress, tmp_path):
    ctx = mp.get_context("spawn")
    port = _free_port()
    procs = [ctx.Process(target=_worker,
                         args=(r, port, compress, str(tmp_path)))
             for r in range(2)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=TIMEOUT_S)
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.terminate()
        p.join()
    assert not alive, "a rank did not finish within its timeout"
    assert all(p.exitcode == 0 for p in procs), [p.exitcode for p in procs]
    threads = torch.get_num_threads()
    torch.set_num_threads(1)   # as in the ranks
    try:
        loss, toks, params = _one_process(compress)
    finally:
        torch.set_num_threads(threads)
    runs = [np.load(tmp_path / f"rank{r}.npz") for r in range(2)]
    for run in runs:
        assert float(run["tokens"]) == float(toks) == 2 * (32 - 2) + 32
        np.testing.assert_array_equal(run["loss"], loss.numpy())
        for k, v in params.items():
            np.testing.assert_array_equal(run[f"p/{k}"], v.detach().numpy())
