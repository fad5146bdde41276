"""Megatron sequence parallelism on the residual stream
(``ShardCtx(seq_axis="model")``) and a batch over the pod and data axes
(``ShardCtx(batch_axes=("pod", "data"))``) on gloo worlds of 2 and 4, on
the CPU, against the JAX package's own sharded programs.

The reference runs once, in a subprocess with four fake CPU devices
(``XLA_FLAGS=--xla_force_host_platform_device_count=4``, set only there),
on ``AxisType.Auto`` meshes: for each case a prefill plus STEPS greedy
decode steps and one step of its ``make_train_step``. The sequence cases
take ``ShardCtx(batch_axes=("data",), seq_axis="model")`` on (data, model)
meshes (1, 2) and (1, 4): the tiny Qwen3 with its KV heads on their rank
(1, 2) and each rank's KV head sliced (1, 4); the tiny SmolLM with 3
attention heads and an FFN of 90 columns, whose attention (and at (1, 4)
its MLP) runs replicated; Mamba2; DeepSeek-V2-Lite (MLA, the MoE with a
shared expert); Whisper with 3 heads (its encoder's and decoder's
attention replicated) and 25 frames. Sequence lengths that divide the TP
size and lengths that do not (the stream padded to ``seq_block`` rows a
rank, ROADMAP §3 item 35). The batch cases take
``ShardCtx(batch_axes=("pod", "data"))`` on (pod, data, model) meshes
(2, 2, 1) and (2, 1, 2). It writes each case's initial state first, then
its outputs.

The port runs the same cases on spawned gloo worlds (one process per
device, ``tcp://127.0.0.1:<free port>``, one torch thread, 60 s
timeouts), from the reference's weights (``convert``). Held: the logits
of ``apply`` and of the prefill (against the reference's prefill, the same
forward) at ``APPLY_TOL``, each decode step's at ``DECODE_TOL``, the
greedy tokens equal; the loss at 1e-5 relative and every updated
parameter and AdamW moment at 1e-4 relative L2
(``tests/test_torch_train_shard_dist.py``'s tolerances).

Against one process: on a world of 2 each layer of the tiny Qwen3, Mamba2
and DeepSeek-V2-Lite on its rank's block of the stream is bit for bit
``tp.layer_ranks(..., seq=True)`` (the partials summed in rank order: a
sum of two terms does not depend on their order), and in one process the
sequence mode's forward is bit for bit ``layer_ranks``' and its gradient
within 1e-5 relative L2 (the norms' scale gradients summed by block). The
world of 2 also takes the Whisper gradient again with ``collectives.split``
replaced by a plain slice, whose adjoint zero-fills the other ranks'
rows: a replicated block's weights then see only the rank's rows, and the
gradient must then miss the held tolerance.
"""
import os
import socket
import subprocess
import sys
import time
import zlib
from datetime import timedelta

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

TIMEOUT_S = 60
APPLY_TOL = dict(atol=2e-4, rtol=2e-3)
DECODE_TOL = dict(atol=5e-4, rtol=5e-3)
LOSS_TOL, LEAF_TOL = 1e-5, 1e-4
B, STEPS = 4, 4
LR = (1e-3, 2, 10)    # cosine_schedule(base, warmup, total)
# SmolLM with 3 heads (1 KV head) and 90 FFN columns: attention replicated
# at tp 2 and 4, the MLP at tp 4; Whisper with 3 heads and 25 frames
REPLICATED = {"num_heads": 3, "num_kv_heads": 1, "d_ff": 90}
WHISPER_REP = {"num_heads": 3, "num_kv_heads": 3, "encoder_seq": 25}
# (name, arch, mesh shape, S, config overrides); a 3-dim mesh is (pod,
# data, model) with the batch over ("pod", "data"), a 2-dim one (data,
# model) with the residual stream's sequence over "model"
CASES = [
    ("qwen3_12", "qwen3-8b", (1, 2), 16, {}),
    ("qwen3_14", "qwen3-8b", (1, 4), 10, {}),
    ("smollm_12", "smollm-360m", (1, 2), 8, REPLICATED),
    ("smollm_14", "smollm-360m", (1, 4), 9, REPLICATED),
    ("mamba2_12", "mamba2-2.7b", (1, 2), 9, {}),
    ("deepseek_14", "deepseek-v2-lite-16b", (1, 4), 12, {}),
    ("whisper_12", "whisper-large-v3", (1, 2), 9, WHISPER_REP),
    ("qwen3_b221", "qwen3-8b", (2, 2, 1), 8, {}),
    ("deepseek_b212", "deepseek-v2-lite-16b", (2, 1, 2), 8, {}),
]
# each layer on its rank's block against tp.layer_ranks(seq=True)
LAYER_ARCHS = ("qwen3-8b", "mamba2-2.7b", "deepseek-v2-lite-16b")
LAYER_B, LAYER_S = 2, 9
HAZARD = "whisper_12"


def _world(shape) -> int:
    return int(np.prod(shape))


def _names(shape):
    return ("pod", "data", "model") if len(shape) == 3 else ("data", "model")


def _fields(shape) -> dict:
    if len(shape) == 3:
        return {"batch_axes": ("pod", "data")}
    return {"batch_axes": ("data",), "seq_axis": "model"}


def _batch(name, cfg, S):
    """(tokens (B, S), labels (B, S + patches), frames or None)."""
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    tokens = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    labels[0, :2] = -1
    frames = None
    if cfg.is_encoder_decoder:
        frames = rng.standard_normal((B, cfg.encoder_seq, cfg.d_model)
                                     ).astype(np.float32)
    return tokens, labels, frames


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _nested(flat, prefix):
    tree = {}
    for key, v in flat.items():
        if not key.startswith(prefix):
            continue
        node = tree
        *path, leaf = key[len(prefix):].split("/")
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = v
    return tree


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


# ----------------------------------------------------------- the reference
def _reference(init_path, out_path):
    """Runs the reference's sharded programs on 4 fake devices; writes
    every case's initial parameters to ``init_path`` first, then its
    outputs."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import AxisType, NamedSharding, PartitionSpec as P
    from repro.configs import get_config
    from repro.launch.shardings import named, state_specs
    from repro.models import build_model
    from repro.models.transformer import ShardCtx
    from repro.optim.adamw import cosine_schedule
    from repro.train import step as jstep
    assert jax.device_count() == 4, jax.devices()
    devs = jax.devices()

    def mesh_of(shape):
        return jax.sharding.Mesh(
            np.array(devs[:_world(shape)]).reshape(shape), _names(shape),
            axis_types=(AxisType.Auto,) * len(shape))

    runs, init = [], {}
    for name, arch, shape, S, over in CASES:
        cfg = get_config(arch).tiny().replace(**over)
        mesh = mesh_of(shape)
        model = build_model(cfg, ShardCtx(mesh=mesh, **_fields(shape)))
        state = jstep.init_state(model, jax.random.PRNGKey(0))
        init.update(_flat(jax.tree.map(np.asarray, state.params),
                          f"{name}/p/"))
        runs.append((name, cfg, mesh, model, state, S))
    np.savez(init_path, **init)
    print("weights written", flush=True)

    out = {}
    lr = cosine_schedule(*LR)
    for name, cfg, mesh, model, state, S in runs:
        tokens, labels, frames = _batch(name, cfg, S)
        extra = () if frames is None else (jnp.asarray(frames),)
        params = state.params
        logits, cache = jax.jit(lambda p, t: model.prefill(
            p, t, *extra, cache_len=S + STEPS))(params, jnp.asarray(tokens))
        out[f"{name}/logits0"] = np.asarray(logits)
        step = jax.jit(model.decode_step)
        nxt = np.asarray(jnp.argmax(logits[:, -1:], -1)).astype(np.int32)
        greedy = []
        for t in range(STEPS):
            greedy.append(nxt)
            logits, cache = step(params, cache, jnp.asarray(nxt))
            out[f"{name}/logits{t + 1}"] = np.asarray(logits)
            nxt = np.asarray(jnp.argmax(logits, -1)).astype(np.int32)
        out[f"{name}/greedy"] = np.concatenate(greedy, 1)

        sspec = state_specs(state, mesh, cfg)
        state = jax.device_put(state, named(mesh, sspec))
        rows = _fields(mesh.devices.shape)["batch_axes"]
        bspec = NamedSharding(mesh, P(rows, None))
        args = (jax.device_put(jnp.asarray(tokens), bspec),
                jax.device_put(jnp.asarray(labels), bspec))
        if frames is not None:
            args += (jax.device_put(jnp.asarray(frames), NamedSharding(
                mesh, P(rows, None, None))),)
        train = jax.jit(jstep.make_train_step(model, cfg, lr))
        with jax.set_mesh(mesh):
            state, m = train(state, *args)
        out[f"{name}/loss"] = np.asarray(m["loss"])
        host = jax.tree.map(np.asarray, state)
        out.update(_flat(host.params, f"{name}/p/"))
        out.update(_flat(host.opt.m, f"{name}/m/"))
        out.update(_flat(host.opt.v, f"{name}/v/"))
    np.savez(out_path, **out)


# ------------------------------------------------------------- the port
def _port_case(name, arch, shape, S, over, init, mesh_of):
    """The port's serving and one train step of a case on this rank."""
    from repro_torch import convert
    from repro_torch.configs import get_config
    from repro_torch.launch import shardings
    from repro_torch.models import ShardCtx
    from repro_torch.optim.adamw import cosine_schedule
    from repro_torch.train import step as tstep
    cfg = get_config(arch).tiny().replace(**over)
    ctx = ShardCtx(mesh=mesh_of(shape), **_fields(shape))
    model = convert.model_from_reference(_nested(init, f"{name}/p/"), cfg,
                                         device="cpu", ctx=ctx)
    tokens, labels, frames = _batch(name, cfg, S)
    tokens, labels = (torch.from_numpy(a).long() for a in (tokens, labels))
    extra = () if frames is None else (torch.from_numpy(frames),)
    out = {}
    with torch.no_grad():
        out[f"{name}/apply"] = model.apply(tokens, *extra).full_tensor()\
            .numpy()
        logits, cache = model.prefill(tokens, *extra, cache_len=S + STEPS)
        logits = logits.full_tensor()
        out[f"{name}/logits0"] = logits.numpy()
        nxt = logits[:, -1:].argmax(-1)
        greedy = []
        for t in range(STEPS):
            greedy.append(nxt)
            logits, cache = model.decode_step(cache, nxt)
            logits = logits.full_tensor()
            out[f"{name}/logits{t + 1}"] = logits.numpy()
            nxt = logits.argmax(-1)
        out[f"{name}/greedy"] = torch.cat(greedy, 1).numpy()
    state = tstep.init_state(model)
    step = tstep.make_train_step(model, cfg, cosine_schedule(*LR))
    new, m = step(state, tokens, labels, *extra)
    out[f"{name}/loss"] = np.array(float(m["loss"]))
    for kind, tree in (("p", new.params), ("m", new.opt.m),
                       ("v", new.opt.v)):
        out.update({f"{name}/{kind}/{k}": shardings.gather(v).detach()
                    .numpy() for k, v in tree.items()})
    if name == HAZARD:
        out.update(_hazard(model, cfg, state, tokens, labels, extra))
    return out


def _hazard(model, cfg, state, tokens, labels, extra):
    """The gradient of the loss with ``collectives.split`` (the rank's
    block of an output every rank computed whole) replaced by a plain
    slice, and without: each leaf's gradient gathered, under ``hazard/``
    and ``grad/``."""
    from repro_torch.launch import collectives, shardings
    from repro_torch.train import step as tstep
    grad_fn = tstep.value_and_grad(tstep.make_loss_fn(model, cfg))
    saved = collectives.split

    def sliced(t, dim, group):
        if group is None:
            return t
        import torch.distributed as dist
        n, r = dist.get_world_size(group), dist.get_rank(group)
        c = collectives.seq_block(t.shape[dim], n)
        pad = list(t.shape)
        pad[dim] = c * n - t.shape[dim]
        return torch.cat([t, t.new_zeros(pad)], dim).narrow(dim, r * c, c)
    out = {}
    for tag, fn in (("grad", saved), ("hazard", sliced)):
        collectives.split = fn
        try:
            _, grads = grad_fn(state.params, tokens, labels, *extra)
        finally:
            collectives.split = saved
        out.update({f"{tag}/{k}": shardings.gather(g).detach().numpy()
                    for k, g in grads.items()})
    return out


def _layer_blocks(rank, mesh):
    """On (1, 2) under sequence parallelism: each layer of the tiny
    ``LAYER_ARCHS`` (seed 0) on this rank's block of x, the block it
    returns."""
    from repro_torch.configs import get_config
    from repro_torch.models import ShardCtx, build_model
    from repro_torch.models import tp as tp_lib
    out = {}
    for arch in LAYER_ARCHS:
        cfg = get_config(arch).tiny()
        lm = build_model(cfg, device="cpu", seed=0,
                         ctx=ShardCtx(mesh=mesh, seq_axis="model"))
        x = _layer_input(cfg)
        positions = lm._positions(LAYER_B, LAYER_S)
        xb = tp_lib.seq_blocks(x, 2)[rank]
        with torch.no_grad():
            for i, blk in enumerate(lm.layers):
                out[f"layers/{arch}/{i}"] = lm._block_apply(
                    blk, xb, positions)[0].numpy()
    return out


def _layer_input(cfg):
    rng = np.random.default_rng(cfg.d_model + cfg.num_layers)
    return torch.from_numpy(rng.standard_normal(
        (LAYER_B, LAYER_S, cfg.d_model)).astype(np.float32))


def _run_world(rank, world, port, init_path, out_dir):
    torch.set_num_threads(1)
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world,
                            timeout=timedelta(seconds=TIMEOUT_S))
    try:
        with np.load(init_path) as f:
            init = {k: f[k] for k in f.files}
        meshes = {}

        def mesh_of(shape):
            if shape not in meshes:
                meshes[shape] = make_mesh(shape, _names(shape), "cpu")
            return meshes[shape]

        out = {}
        for name, arch, shape, S, over in CASES:
            if _world(shape) == world:
                out.update(_port_case(name, arch, shape, S, over, init,
                                      mesh_of))
        if world == 2:
            out.update(_layer_blocks(rank, mesh_of((1, 2))))
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()


def _free_ports(n: int):
    socks = [socket.socket() for _ in range(n)]
    try:
        for s in socks:
            s.bind(("127.0.0.1", 0))
        return [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the reference's outputs and initial parameters, {world size: [each
    rank's outputs]}). The gloo worlds start once the reference has
    written its initial parameters, and run while it computes."""
    d = tmp_path_factory.mktemp("seq")
    init, ref_path = str(d / "init.npz"), str(d / "ref.npz")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    proc = subprocess.Popen([sys.executable, os.path.abspath(__file__),
                             "--reference", init, ref_path], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    spawned = {}
    try:
        if "weights written" not in proc.stdout.readline():
            _, err = proc.communicate(timeout=TIMEOUT_S)
            pytest.fail(f"the reference failed: {err[-4000:]}")
        for world, port in zip((2, 4), _free_ports(2)):
            (d / f"w{world}").mkdir()
            spawned[world] = mp.spawn(_run_world, args=(
                world, port, init, str(d / f"w{world}")),
                nprocs=world, join=False)
        deadline = time.monotonic() + 4 * TIMEOUT_S
        for ctx in spawned.values():
            while not ctx.join(timeout=max(1.0, deadline - time.monotonic())):
                if time.monotonic() > deadline:
                    pytest.fail("a gloo world ran past its time")
        _, err = proc.communicate(timeout=4 * TIMEOUT_S)
        assert proc.returncode == 0, err[-4000:]
    finally:
        for ctx in spawned.values():
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
        if proc.poll() is None:
            proc.kill()
    ref = {}
    for path in (init, ref_path):
        with np.load(path) as f:
            ref.update({f"init/{k}" if path == init else k: f[k]
                        for k in f.files})
    worlds = {}
    for world in (2, 4):
        worlds[world] = []
        for r in range(world):
            with np.load(d / f"w{world}" / f"rank{r}.npz") as f:
                worlds[world].append({k: f[k] for k in f.files})
    return ref, worlds


# ------------------------------------------------------------------ tests
IDS = [c[0] for c in CASES]


@pytest.mark.parametrize("name,arch,shape,S,over", CASES, ids=IDS)
def test_serving_matches_reference(runs, name, arch, shape, S, over):
    ref, worlds = runs
    for rank_out in worlds[_world(shape)]:
        for key in ("apply", "logits0"):
            np.testing.assert_allclose(rank_out[f"{name}/{key}"],
                                       ref[f"{name}/logits0"],
                                       err_msg=key, **APPLY_TOL)
        for t in range(1, STEPS + 1):
            np.testing.assert_allclose(rank_out[f"{name}/logits{t}"],
                                       ref[f"{name}/logits{t}"],
                                       err_msg=f"step {t}", **DECODE_TOL)
        np.testing.assert_array_equal(rank_out[f"{name}/greedy"],
                                      ref[f"{name}/greedy"])


def _train_errors(got, ref, name, cfg):
    from repro_torch import convert
    errs = {}
    for kind in ("p", "m", "v"):
        want = convert._model_state(_nested(ref, f"{name}/{kind}/"), cfg)
        for k, w in want.items():
            errs[f"{kind}/{k}"] = _rel(got[f"{name}/{kind}/{k}"], w)
    return errs


@pytest.mark.parametrize("name,arch,shape,S,over", CASES, ids=IDS)
def test_train_step_matches_reference(runs, name, arch, shape, S, over):
    from repro_torch.configs import get_config
    ref, worlds = runs
    cfg = get_config(arch).tiny().replace(**over)
    ranks = worlds[_world(shape)]
    want = float(ref[f"{name}/loss"])
    for r in ranks:   # every rank reports the same loss
        assert float(r[f"{name}/loss"]) == float(ranks[0][f"{name}/loss"])
    got = float(ranks[0][f"{name}/loss"])
    assert abs(got - want) <= LOSS_TOL * abs(want), (got, want)
    for r in ranks:
        errs = _train_errors(r, ref, name, cfg)
        worst = max(errs, key=errs.get)
        assert errs[worst] < LEAF_TOL, (worst, errs[worst])


def test_cases_cover_the_layouts():
    """The cases run what they are meant to: replicated attention (and a
    replicated MLP), the KV slice, lengths that do not divide the TP
    size."""
    from repro_torch.configs import get_config
    from repro_torch.models import tp as tp_lib
    modes = {}
    for name, arch, shape, S, over in CASES:
        cfg = get_config(arch).tiny().replace(**over)
        tp = shape[-1]
        modes[name] = (tp_lib.plan(cfg, cfg.pattern[0], tp), S % tp)
    assert modes["smollm_12"][0].mixer is None and modes["smollm_12"][0].mlp
    assert modes["smollm_14"][0] == tp_lib.Plan(None, False)
    assert modes["qwen3_14"][0].mixer == "kv_slice"
    assert modes["whisper_12"][0].mixer is None
    assert modes["qwen3_12"][1] == 0 and modes["qwen3_14"][1] != 0
    assert modes["mamba2_12"][1] != 0 and modes["smollm_14"][1] != 0


@pytest.mark.parametrize("arch", LAYER_ARCHS)
def test_world_of_two_is_the_sequence_mode(runs, arch):
    """On (1, 2) each layer's blocks, joined, are bit for bit
    ``layer_ranks(..., seq=True)`` on the whole x."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model, remat
    from repro_torch.models import tp as tp_lib
    _, worlds = runs
    cfg = get_config(arch).tiny()
    lm = build_model(cfg, device="cpu", seed=0)
    x = _layer_input(cfg)
    positions = lm._positions(LAYER_B, LAYER_S)
    with torch.no_grad():
        for i, blk in enumerate(lm.layers):
            want = tp_lib.layer_ranks(blk.spec, remat.unit_params(blk), x,
                                      cfg, positions, 2, seq=True).numpy()
            got = np.concatenate([w[f"layers/{arch}/{i}"]
                                  for w in worlds[2]], 1)[:, :LAYER_S]
            np.testing.assert_array_equal(got, want, err_msg=f"layer {i}")


@pytest.mark.parametrize("arch,tp", [(a, t) for a in LAYER_ARCHS
                                     for t in (2, 4)])
def test_sequence_mode_against_layer_ranks(arch, tp):
    """In float32 on the CPU the sequence mode's forward is bit for bit
    ``layer_ranks``' and its gradient within 1e-5 relative L2."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model, remat
    from repro_torch.models import tp as tp_lib
    cfg = get_config(arch).tiny()
    lm = build_model(cfg, device="cpu", seed=0)
    positions = lm._positions(LAYER_B, LAYER_S)
    for blk in lm.layers:
        p = {k: {kk: vv.detach().requires_grad_(True) for kk, vv in v.items()}
             if isinstance(v, dict) else v.detach().requires_grad_(True)
             for k, v in remat.unit_params(blk).items()}
        x = _layer_input(cfg).requires_grad_(True)
        dy = torch.randn(x.shape, generator=torch.Generator().manual_seed(3))
        leaves = [x] + [t for v in p.values() for t in (
            v.values() if isinstance(v, dict) else [v])]
        outs = []
        for seq in (False, True):
            y = tp_lib.layer_ranks(blk.spec, p, x, cfg, positions, tp,
                                   seq=seq)
            outs.append((y.detach(), torch.autograd.grad(
                y, leaves, dy, allow_unused=True)))
        assert torch.equal(outs[0][0], outs[1][0])
        for a, b in zip(outs[0][1], outs[1][1]):
            if a is not None:
                assert _rel(b, a) < 1e-5


def test_replicated_block_slice_adjoint_is_caught(runs):
    """The Whisper world's gradient with ``collectives.split`` swapped for
    a plain slice (a replicated block's output whose adjoint zero-fills
    the other ranks' rows) misses the held 1e-4 against the real one,
    which the reference holds."""
    _, worlds = runs
    for rank_out in worlds[2]:
        keys = [k[5:] for k in rank_out if k.startswith("grad/")]
        errs = {k: _rel(rank_out[f"hazard/{k}"], rank_out[f"grad/{k}"])
                for k in keys}
        worst = max(errs, key=errs.get)
        assert errs[worst] > 100 * LEAF_TOL, (worst, errs[worst])


if __name__ == "__main__":
    if sys.argv[1:2] == ["--reference"]:
        _reference(sys.argv[2], sys.argv[3])
