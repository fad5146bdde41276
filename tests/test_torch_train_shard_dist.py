"""Training on a sharded mesh on gloo worlds of 2 and 4, on the CPU,
against the JAX package's own sharded train steps.

The reference runs once, in a subprocess with four fake CPU devices
(``XLA_FLAGS=--xla_force_host_platform_device_count=4``, set only there),
on meshes whose axes are ``AxisType.Auto`` (``jax.make_mesh``'s default
``Explicit`` axes trip the model's sharding constraints), its state and
batch ``device_put`` at ``state_specs`` and the batch spec: two steps of
its ``make_train_step`` for the tiny SmolLM-360M and DeepSeek-V2-Lite on
(data, model) meshes (2, 1), (1, 2), (2, 2) and (1, 4), the tiny Qwen3-8B
and Mamba2-2.7B on (1, 2), (2, 2) and (1, 4) and the tiny Whisper on
(1, 2) (where the port runs each rank's heads, FFN columns, SSD heads and
vocab shard: ``models/tp.py``), and two steps of its
``make_partitioned_train_step`` for the tiny SmolLM on a (pod, data,
model) mesh (2, 2, 1), pods taking 3 and 2 microsteps. It writes each
case's initial state first, then the losses and the updated parameters
and moments.

The port runs the same cases on spawned gloo worlds (one process per
device, ``tcp://127.0.0.1:<free port>``, one torch thread, 60 s
timeouts): the model placed at ``param_specs``' placements from the
reference's initial weights (``convert``), AdamW's moments at the same
placements, the global batch on every rank. Held, on the same mesh as the
reference (the MoE's capacity is counted per token shard, so a split
changes DeepSeek's loss): the loss at 1e-5 relative and every parameter
and moment at 1e-4 relative L2 (``tests/test_torch_train_archs.py``'s
tolerances). Each world also records the shape of the logits its
differentiated forward gives a rank: its rows of the batch and its vocab
columns (B / data, S, Vp / tp), never the (B, S, Vp) logits. A sharded
``Trainer`` killed after its step-2 checkpoint and restored from it steps
on bitwise, on every rank.
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
LOSS_TOL, LEAF_TOL = 1e-5, 1e-4
STEPS, B, S = 2, 4, 16
# (name, arch, mesh shape); the partitioned case's mesh is (pod, data,
# model)
CASES = [(f"{arch.split('-')[0]}_{m[0]}{m[1]}", arch, m)
         for arch in ("smollm-360m", "deepseek-v2-lite-16b")
         for m in ((2, 1), (1, 2), (2, 2), (1, 4))] + [
    (f"{arch.split('-')[0]}_{m[0]}{m[1]}", arch, m)
    for arch in ("qwen3-8b", "mamba2-2.7b")
    for m in ((1, 2), (2, 2), (1, 4))] + [
    ("whisper_12", "whisper-large-v3", (1, 2))]
PART = ("part_221", "smollm-360m", (2, 2, 1))
MAX_MICRO, K_PODS, MB = 4, (3, 2), 4
ALL = CASES + [PART]
LR = (1e-3, 2, 10)    # cosine_schedule(base, warmup, total)


def _world(shape) -> int:
    return int(np.prod(shape))


def _names(shape):
    return ("pod", "data", "model") if len(shape) == 3 else ("data", "model")


def _batch(name, vocab):
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    if name == PART[0]:
        shape = (MAX_MICRO, MB, S)
    else:
        shape = (B, S)
    tokens = rng.integers(0, vocab, shape).astype(np.int32)
    labels = rng.integers(0, vocab, shape).astype(np.int32)
    labels[..., 0, :2] = -1
    return tokens, labels


def _frames(name, cfg):
    """The encoder-decoder's frames (B, encoder_seq, d) float32, or
    None."""
    if not cfg.is_encoder_decoder:
        return None
    rng = np.random.default_rng(zlib.crc32(name.encode()) + 1)
    return rng.standard_normal((B, cfg.encoder_seq, cfg.d_model)).astype(
        np.float32)


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


# ----------------------------------------------------------- the reference
def _reference(init_path, out_path):
    """Runs the reference's sharded steps on 4 fake devices; writes every
    case's initial state to ``init_path`` first, then its outputs."""
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
        n = _world(shape)
        return jax.sharding.Mesh(np.array(devs[:n]).reshape(shape),
                                 _names(shape),
                                 axis_types=(AxisType.Auto,) * len(shape))

    runs, init = [], {}
    for name, arch, shape in ALL:
        cfg = get_config(arch).tiny()
        mesh = mesh_of(shape)
        model = build_model(cfg, ShardCtx(mesh=mesh, batch_axes=("data",)))
        state = jstep.init_state(model, jax.random.PRNGKey(0))
        init.update(_flat(jax.tree.map(np.asarray, state.params),
                          f"{name}/p/"))
        runs.append((name, cfg, mesh, model, state))
    np.savez(init_path, **init)
    print("weights written", flush=True)

    out = {}
    lr = cosine_schedule(*LR)
    for name, cfg, mesh, model, state in runs:
        sspec = state_specs(state, mesh, cfg)
        state = jax.device_put(state, named(mesh, sspec))
        tokens, labels = _batch(name, cfg.vocab_size)
        if name == PART[0]:
            step = jax.jit(jstep.make_partitioned_train_step(
                model, cfg, mesh, lr, max_micro=MAX_MICRO,
                grad_specs=sspec.params))
            dspec = NamedSharding(mesh, P(None, ("pod", "data"), None))
            args = (jax.device_put(jnp.asarray(tokens), dspec),
                    jax.device_put(jnp.asarray(labels), dspec),
                    jax.device_put(jnp.asarray(K_PODS, jnp.int32),
                                   NamedSharding(mesh, P("pod"))))
        else:
            step = jax.jit(jstep.make_train_step(model, cfg, lr))
            bspec = NamedSharding(mesh, P("data", None))
            args = (jax.device_put(jnp.asarray(tokens), bspec),
                    jax.device_put(jnp.asarray(labels), bspec))
            frames = _frames(name, cfg)
            if frames is not None:
                args += (jax.device_put(jnp.asarray(frames), NamedSharding(
                    mesh, P("data", None, None))),)
        with jax.set_mesh(mesh):
            for i in range(STEPS):
                state, m = step(state, *args)
                out[f"{name}/loss{i}"] = np.asarray(m["loss"])
        host = jax.tree.map(np.asarray, state)
        out.update(_flat(host.params, f"{name}/p/"))
        out.update(_flat(host.opt.m, f"{name}/m/"))
        out.update(_flat(host.opt.v, f"{name}/v/"))
    np.savez(out_path, **out)


# ------------------------------------------------------------- the port
def _port_case(name, arch, shape, init, make_mesh_of):
    """Two steps of the port's sharded step on this rank: (losses, the
    final state gathered to full under the port's names)."""
    from repro_torch import convert
    from repro_torch.configs import get_config
    from repro_torch.launch import shardings
    from repro_torch.models import ShardCtx
    from repro_torch.optim.adamw import cosine_schedule
    from repro_torch.train import step as tstep
    cfg = get_config(arch).tiny()
    mesh = make_mesh_of(shape)
    ctx = ShardCtx(mesh=mesh, batch_axes=("data",))
    model = convert.model_from_reference(_nested(init, f"{name}/p/"), cfg,
                                         device="cpu", ctx=ctx)
    state = tstep.init_state(model)
    lr = cosine_schedule(*LR)
    tokens, labels = (torch.from_numpy(a).long()
                      for a in _batch(name, cfg.vocab_size))
    if name == PART[0]:
        step = tstep.make_partitioned_train_step(model, cfg, mesh, lr,
                                                 max_micro=MAX_MICRO)
        args = (tokens, labels, list(K_PODS))
    else:
        step = tstep.make_train_step(model, cfg, lr)
        frames = _frames(name, cfg)
        args = (tokens, labels) + (
            () if frames is None else (torch.from_numpy(frames),))
        # the logits a rank's differentiated forward gives
        shape = np.array(tstep.forward(model, cfg, state.params, *args[:1],
                                       *args[2:]).shape)
    losses = []
    for _ in range(STEPS):
        state, m = step(state, *args)
        losses.append(float(m["loss"]))
    full = {f"{kind}/{k}": shardings.gather(v).detach().numpy()
            for kind, tree in (("p", state.params), ("m", state.opt.m),
                               ("v", state.opt.v))
            for k, v in tree.items()}
    if name != PART[0]:
        full["logits_shape"] = shape
    return losses, full


def _trainer_restore(rank, make_mesh_of, ckpt_dir):
    """A sharded Trainer killed after its step-2 checkpoint and restored:
    whether steps 2 and 3 and the final state repeat bitwise."""
    from repro_torch.configs import get_config
    from repro_torch.launch import shardings
    from repro_torch.models import ShardCtx, build_model
    from repro_torch.train import Trainer, TrainerConfig
    cfg = get_config("smollm-360m").tiny()
    ctx = ShardCtx(mesh=make_mesh_of((2, 2)), batch_axes=("data",))

    def trainer(steps, d):
        model = build_model(cfg, device="cpu", seed=0, ctx=ctx,
                            trainable=True)
        return Trainer(model, cfg, TrainerConfig(
            steps=steps, batch=4, seq=16, ckpt_dir=d, ckpt_interval=2,
            log_every=100))

    whole, h_whole = trainer(4, os.path.join(ckpt_dir, "whole")).run()
    killed = os.path.join(ckpt_dir, "killed")
    trainer(2, killed).run()
    resumed, h_res = trainer(4, killed).run()
    same = ([h["loss"] for h in h_whole[2:]] == [h["loss"] for h in h_res]
            and h_res[0]["step"] == 2)
    for a, b in ((whole.params, resumed.params),
                 (whole.opt.m, resumed.opt.m), (whole.opt.v, resumed.opt.v)):
        same &= all(torch.equal(shardings.local(a[k]),
                                shardings.local(b[k])) for k in a)
    placed = all(shardings.local(p).numel() < p.numel()
                 for k, p in whole.params.items() if k.endswith("wq"))
    return np.array([same, placed])


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
        for name, arch, shape in ALL:
            if _world(shape) != world:
                continue
            losses, full = _port_case(name, arch, shape, init, mesh_of)
            out[f"{name}/losses"] = np.array(losses)
            out.update({f"{name}/{k}": v for k, v in full.items()})
        if world == 4:
            out["trainer"] = _trainer_restore(
                rank, mesh_of, os.path.join(out_dir, f"ckpt{world}"))
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
    """(the reference's outputs, {world size: [each rank's outputs]}). The
    gloo worlds start once the reference has written its initial states,
    and run while it computes."""
    d = tmp_path_factory.mktemp("train_shard")
    init, ref_path = str(d / "init.npz"), str(d / "ref.npz")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    proc = subprocess.Popen(
        [sys.executable, __file__, "--reference", init, ref_path], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    deadline = time.time() + 300
    while not os.path.exists(init) and proc.poll() is None:
        if time.time() > deadline:
            proc.kill()
            pytest.fail("the reference wrote no initial state")
        time.sleep(0.2)
    if not os.path.exists(init):
        pytest.fail(f"the reference failed: {proc.stderr.read()[-3000:]}")
    time.sleep(0.5)   # np.savez has returned: the print follows it
    worlds = {}
    for world, port in zip((2, 4), _free_ports(2)):
        out = d / f"world{world}"
        out.mkdir()
        mp.spawn(_run_world, args=(world, port, init, str(out)),
                 nprocs=world, join=True)
        worlds[world] = [dict(np.load(out / f"rank{r}.npz"))
                         for r in range(world)]
    _, err = proc.communicate(timeout=600)
    assert proc.returncode == 0, err[-3000:]
    with np.load(ref_path) as f:
        ref = {k: f[k] for k in f.files}
    return ref, worlds


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.mark.parametrize("name,arch,shape", ALL,
                         ids=[c[0] for c in ALL])
def test_sharded_steps_match_the_reference(runs, name, arch, shape):
    from repro_torch import convert
    from repro_torch.configs import get_config
    ref, worlds = runs
    cfg = get_config(arch).tiny()
    ranks = worlds[_world(shape)]
    got = ranks[0]
    want_loss = [float(ref[f"{name}/loss{i}"]) for i in range(STEPS)]
    for r in ranks:   # every rank reports the same loss
        np.testing.assert_array_equal(r[f"{name}/losses"],
                                      got[f"{name}/losses"])
    for g, w in zip(got[f"{name}/losses"], want_loss):
        assert abs(g - w) <= LOSS_TOL * abs(w), (g, w)
    errs = {}
    for kind in ("p", "m", "v"):
        want = convert._model_state(_nested(ref, f"{name}/{kind}/"), cfg)
        for k, w in want.items():
            errs[f"{kind}/{k}"] = _rel(got[f"{name}/{kind}/{k}"], w)
    worst = max(errs, key=errs.get)
    assert errs[worst] < LEAF_TOL, (worst, errs[worst])
    if name != PART[0]:   # the rank's rows and vocab columns of the logits
        tp = shape[1] if cfg.padded_vocab % shape[1] == 0 else 1
        np.testing.assert_array_equal(
            got[f"{name}/logits_shape"],
            [B // shape[0], S, cfg.padded_vocab // tp])


def test_sharded_trainer_restores_bitwise(runs):
    _, worlds = runs
    for r, out in enumerate(worlds[4]):
        same, placed = out["trainer"]
        assert same, f"rank {r}: the restored trainer's steps differ"
        assert placed


if __name__ == "__main__":
    if sys.argv[1:2] == ["--reference"]:
        _reference(sys.argv[2], sys.argv[3])
