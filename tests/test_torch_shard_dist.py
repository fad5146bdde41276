"""Sharded serving on gloo worlds of 2 and 4, on the CPU, against the JAX
package's own sharded code.

The reference runs once, in a subprocess with four fake CPU devices
(``XLA_FLAGS=--xla_force_host_platform_device_count=4``, set only there):
its ``shard_map`` MoE (``moe_apply``) for the tiny DeepSeek-V2-Lite (a
shared expert) and the tiny Qwen3-MoE on (data, model) meshes (1, 2),
(2, 2) and (1, 4), with B x S divisible by the token split and not; its
``sharded_lse_decode`` over 2 and 4 shards, with an empty shard and with
every valid logit below -100; and a prefill plus 4 greedy decode steps of
the tiny Qwen3, DeepSeek-V2-Lite and Jamba under a sharded ``ShardCtx``,
and under a TP context, where the port runs each rank's heads, columns
and vocab shard (``models/tp.py``), the tiny Qwen3 at (1, 2) (its KV heads
on their rank) and (1, 4) (each rank's KV head sliced), Mamba2 at (1, 2)
and (2, 2) (the split-row gated norm), DeepSeek-V2-Lite at (1, 2) (MLA,
the shared expert), SmolLM at (1, 2) and Whisper at (1, 2) and (2, 2).
It writes its inputs, weights and outputs to one ``.npz``.

The port runs the same cases on spawned gloo worlds (one process per
device, ``tcp://127.0.0.1:<free port>``, one torch thread, 60 s timeouts):
weights at ``launch.shardings`` placements, the expert-parallel MoE, the
decode's partials combined by ``all_reduce``. The MoE layer and the decode
attention are held at float32 atol 1e-5 / rtol 1e-5, the logits at
``tests/test_torch_models.py``'s tolerances, the greedy tokens equal.
Against one process: a world of 2 is bit for bit ``moe.moe_ranks`` and
``attention.lse_ranks`` (each rank's body in one process, the partials
summed in rank order: a sum of two terms does not depend on their order);
a world of 4 is held at the float32 tolerance (gloo's ring sums in no
fixed order). The same holds each layer of the tiny Qwen3, Mamba2 and
DeepSeek-V2-Lite and the vocab-parallel head and loss against
``models.tp``'s rank bodies in one process. On (1, 2) the worlds also
record the shapes that reach ``ops.attention``, ``ops.decode_attention``
and ``ops.ssd`` (the rank's heads) and the collectives of a decode step
(no cache entry gathered over "model").
"""
import functools
import os
import socket
import subprocess
import sys
import time
from datetime import timedelta

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.kernels import ref
from repro_torch.models import ShardCtx, attention, build_model, moe

TIMEOUT_S = 60
MOE_TOL = dict(atol=1e-5, rtol=1e-5)
APPLY_TOL = dict(atol=2e-4, rtol=2e-3)
DECODE_TOL = dict(atol=5e-4, rtol=5e-3)

# (arch, (data, model), (B, S)): B x S = 16 splits over "data", 7 does not
MOE_CASES = [(arch, mesh, bs)
             for arch in ("deepseek-v2-lite-16b", "qwen3-moe-235b-a22b")
             for mesh in ((1, 2), (2, 2), (1, 4))
             for bs in ((2, 8), (1, 7))]
# (shards, case): random masks, shard 1 empty, and every valid logit of
# the one shard that has any far below 0 (the others empty)
LSE_CASES = [(n, case) for n in (2, 4) for case in ("mask", "empty", "neg")]
# (name, arch, (data, model), ShardCtx fields)
MODEL_CASES = [
    ("qwen3_seq22", "qwen3-8b", (2, 2), {"decode_seq_axes": ("data",)}),
    ("deepseek_batch22", "deepseek-v2-lite-16b", (2, 2),
     {"batch_axes": ("data",)}),
    ("deepseek_seq21", "deepseek-v2-lite-16b", (2, 1),
     {"decode_seq_axes": ("data",)}),
    ("jamba_tp12", "jamba-1.5-large-398b", (1, 2), {}),
    ("qwen3_tp12", "qwen3-8b", (1, 2), {}),
    ("qwen3_tp14", "qwen3-8b", (1, 4), {}),
    ("mamba2_tp12", "mamba2-2.7b", (1, 2), {}),
    ("mamba2_tp22", "mamba2-2.7b", (2, 2), {"batch_axes": ("data",)}),
    ("deepseek_tp12", "deepseek-v2-lite-16b", (1, 2), {}),
    ("smollm_tp12", "smollm-360m", (1, 2), {}),
    ("whisper_tp12", "whisper-large-v3", (1, 2), {}),
    ("whisper_tp22", "whisper-large-v3", (2, 2), {"batch_axes": ("data",)}),
]
PROMPT, STEPS, CACHE_LEN = 16, 4, 20
# (arch, tp): every layer and the vocab-parallel head and loss on a (1, tp)
# world against the rank bodies in one process
RANK_CASES = [(arch, tp) for arch in ("qwen3-8b", "mamba2-2.7b",
                                      "deepseek-v2-lite-16b")
              for tp in (2, 4)]
RANK_B, RANK_S = 2, 8


def _world(mesh) -> int:
    return mesh[0] * mesh[1]


def _moe_key(arch, mesh, bs):
    return f"moe/{arch}/{mesh[0]}x{mesh[1]}/{bs[0]}x{bs[1]}"


def _lse_key(n, case):
    return f"lse/{n}/{case}"


# ----------------------------------------------------------- the reference
def _lse_inputs(n, case):
    """q (B, Hkv, G, D), k, v (B, Hkv, S, D) float32 and valid (S,)."""
    rng = np.random.default_rng(7 * n + len(case))
    B, Hkv, G, D, S = 2, 2, 2, 16, 32
    q = rng.standard_normal((B, Hkv, G, D)).astype(np.float32)
    k = rng.standard_normal((B, Hkv, S, D)).astype(np.float32)
    v = rng.standard_normal((B, Hkv, S, D)).astype(np.float32)
    valid = rng.random(S) < 0.7
    per = S // n
    if case == "empty":
        valid[per:2 * per] = False
    elif case == "neg":
        q = np.abs(q) + 0.5
        k = -(np.abs(k) + 30.0)
        valid[:] = False
        valid[:per] = rng.random(per) < 0.8
        valid[0] = True
    return q, k, v, valid


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


def _moe_input(bs, d):
    return np.random.default_rng(bs[0] * 31 + bs[1]).standard_normal(
        (*bs, d)).astype(np.float32)


def _model_tokens(vocab):
    return np.random.default_rng(1).integers(0, vocab, (2, PROMPT)).astype(
        np.int32)


def _frames(cfg):
    """The encoder-decoder's frames (2, encoder_seq, d) float32."""
    return np.random.default_rng(2).standard_normal(
        (2, cfg.encoder_seq, cfg.d_model)).astype(np.float32)


def _rank_key(arch, tp):
    return f"ranks/{arch}/{tp}"


def _rank_inputs(cfg):
    """x (B, S, d) float32 and labels (B, S) of the rank-body cases."""
    rng = np.random.default_rng(cfg.d_model + cfg.num_layers)
    x = rng.standard_normal((RANK_B, RANK_S, cfg.d_model)).astype(np.float32)
    labels = rng.integers(0, cfg.vocab_size, (RANK_B, RANK_S))
    labels[0, :2] = -1
    return x, labels


def _reference(params_path, out_path):
    """Runs the reference's sharded code on 4 fake devices. Writes the
    weights to ``params_path`` first (and says so on stdout), then every
    output to ``out_path``."""
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config as jget_config
    from repro.models import build_model as jbuild_model
    from repro.models import moe as jmoe
    from repro.models.attention import sharded_lse_decode
    from repro.models.transformer import ShardCtx as JShardCtx
    assert jax.device_count() == 4, jax.devices()
    devs = jax.devices()

    def mesh_of(shape, names=("data", "model")):
        n = int(np.prod(shape))
        return jax.sharding.Mesh(np.array(devs[:n]).reshape(shape), names)

    moe_p, models, weights = {}, {}, {}
    for arch in ("deepseek-v2-lite-16b", "qwen3-moe-235b-a22b"):
        moe_p[arch] = jmoe.moe_init(jax.random.PRNGKey(3),
                                    jget_config(arch).tiny())
        weights.update(_flat(moe_p[arch], f"moe/{arch}/p/"))
    for name, arch, mesh, fields in MODEL_CASES:
        jm = jbuild_model(jget_config(arch).tiny(),
                          JShardCtx(mesh=mesh_of(mesh), **fields))
        models[name] = (jm, jm.init(jax.random.PRNGKey(0)))
        weights.update(_flat(models[name][1], f"model/{name}/p/"))
    np.savez(params_path, **weights)
    print("weights written", flush=True)

    out = {}
    for arch, p in moe_p.items():
        cfg = jget_config(arch).tiny()
        local = jax.jit(functools.partial(jmoe.moe_apply, cfg=cfg))
        for mesh, bs in [(m, b) for (a, m, b) in MOE_CASES if a == arch]:
            key = _moe_key(arch, mesh, bs)
            x = _moe_input(bs, cfg.d_model)
            f = jax.jit(functools.partial(
                jmoe.moe_apply, cfg=cfg, mesh=mesh_of(mesh),
                tp_axis="model", fsdp_axis="data"))
            out[f"{key}/y"] = np.asarray(f(p, jnp.asarray(x)))
            out[f"{key}/y_local"] = np.asarray(local(p, jnp.asarray(x)))
            if mesh[0] > 1 and (bs[0] * bs[1]) % mesh[0] == 0:
                rows = x.reshape(mesh[0], -1, cfg.d_model)
                out[f"{key}/y_shards"] = np.concatenate([np.asarray(
                    local(p, jnp.asarray(r[None])))[0] for r in rows])

    for n in sorted({n for n, _ in LSE_CASES}):
        f = None
        for case in [c for m, c in LSE_CASES if m == n]:
            q, k, v, valid = _lse_inputs(n, case)
            B, Hkv, G, D = q.shape
            if f is None:
                f = jax.jit(functools.partial(
                    sharded_lse_decode, group=G, axes=("data",),
                    mesh=mesh_of((n,), ("data",))))
            y = f(jnp.asarray(q.reshape(B, Hkv * G, D)), jnp.asarray(k),
                  jnp.asarray(v), jnp.asarray(valid))
            out[f"{_lse_key(n, case)}/y"] = np.asarray(y).reshape(
                B, Hkv, G, D)

    for name, (jm, params) in models.items():
        toks = _model_tokens(jm.cfg.vocab_size)
        if jm.cfg.is_encoder_decoder:
            frames = jnp.asarray(_frames(jm.cfg))
            logits, cache = jax.jit(lambda p, t: jm.prefill(
                p, t, frames, cache_len=CACHE_LEN))(params, jnp.asarray(toks))
        else:
            logits, cache = jax.jit(lambda p, t: jm.prefill(
                p, t, cache_len=CACHE_LEN))(params, jnp.asarray(toks))
        out[f"model/{name}/logits0"] = np.asarray(logits)
        step = jax.jit(jm.decode_step)
        nxt = np.asarray(jnp.argmax(logits[:, -1:], -1)).astype(np.int32)
        greedy = []
        for t in range(STEPS):
            greedy.append(nxt)
            logits, cache = step(params, cache, jnp.asarray(nxt))
            out[f"model/{name}/logits{t + 1}"] = np.asarray(logits)
            nxt = np.asarray(jnp.argmax(logits, -1)).astype(np.int32)
        out[f"model/{name}/greedy"] = np.concatenate(greedy, 1)
    np.savez(out_path, **out)


# ------------------------------------------------------------- the port
def _params(ref_out, prefix):
    return {k: torch.from_numpy(np.array(v))
            for k, v in _nested(ref_out, prefix).items()}


def _placed_moe(p, mesh):
    """A MoE layer's weights as a model layer hands them to moe_apply: the
    expert banks at their placements, the rest gathered."""
    from repro_torch.launch import shardings
    return {k: (shardings.distribute(v, mesh, shardings.leaf_spec(
                k, v.shape, mesh)) if k.startswith("moe_") else v)
            for k, v in p.items()}


def _run_world(rank, world, port, weights_path, out_dir):
    torch.set_num_threads(1)
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world,
                            timeout=timedelta(seconds=TIMEOUT_S))
    try:
        with np.load(weights_path) as f:
            ref_out = {k: f[k] for k in f.files}
        out = {}
        meshes = {}

        def mesh_of(shape, names=("data", "model")):
            if (shape, names) not in meshes:
                meshes[shape, names] = make_mesh(shape, names, "cpu")
            return meshes[shape, names]

        with torch.no_grad():
            for arch, shape, bs in MOE_CASES:
                if _world(shape) != world:
                    continue
                key = _moe_key(arch, shape, bs)
                cfg = get_config(arch).tiny()
                mesh = mesh_of(shape)
                p = _placed_moe(_params(ref_out, f"moe/{arch}/p/"), mesh)
                x = torch.from_numpy(_moe_input(bs, cfg.d_model))
                out[key] = moe.moe_apply(p, x, cfg,
                                         ShardCtx(mesh=mesh)).numpy()
            for n, case in LSE_CASES:
                if n != world:
                    continue
                from repro_torch.launch.mesh import axis_group
                mesh = mesh_of((n,), ("data",))
                q, k, v, valid = (torch.from_numpy(a)
                                  for a in _lse_inputs(n, case))
                B, Hkv, G, D = q.shape
                per = k.shape[2] // n
                sl = slice(rank * per, (rank + 1) * per)
                y = attention.sharded_lse_decode(
                    q.reshape(B, Hkv * G, D), k[:, :, sl].contiguous(),
                    v[:, :, sl].contiguous(), valid[sl].contiguous(), G,
                    group=axis_group(mesh, "data"))
                out[_lse_key(n, case)] = y.reshape(B, Hkv, G, D).numpy()
            for name, arch, shape, fields in MODEL_CASES:
                if _world(shape) != world:
                    continue
                cfg = get_config(arch).tiny()
                ctx = ShardCtx(mesh=mesh_of(shape), **fields)
                params = _nested(ref_out, f"model/{name}/p/")
                lm = convert.model_from_reference(params, cfg, device="cpu",
                                                  ctx=ctx)
                if cfg.is_encoder_decoder:   # each shard gathers back whole
                    from repro_torch.launch import shardings
                    want = convert._encdec_state(params, cfg)
                    out[f"model/{name}/round_trip"] = np.array(all(
                        np.array_equal(shardings.gather(p).numpy(), want[k])
                        for k, p in lm.named_parameters())
                        and len(want) == len(dict(lm.named_parameters()))
                        and any(shardings.local(p).numel() < p.numel()
                                for p in lm.parameters()))
                toks = torch.from_numpy(_model_tokens(cfg.vocab_size)).long()
                extra = ((torch.from_numpy(_frames(cfg)),)
                         if cfg.is_encoder_decoder else ())
                logits, cache = lm.prefill(toks, *extra, cache_len=CACHE_LEN)
                logits = logits.full_tensor()
                out[f"model/{name}/logits0"] = logits.numpy()
                nxt = logits[:, -1:].argmax(-1)
                greedy = []
                for t in range(STEPS):
                    greedy.append(nxt)
                    logits, cache = lm.decode_step(cache, nxt)
                    logits = logits.full_tensor()
                    out[f"model/{name}/logits{t + 1}"] = logits.numpy()
                    nxt = logits.argmax(-1)
                out[f"model/{name}/greedy"] = torch.cat(greedy, 1).numpy()
            for arch, tp in RANK_CASES:
                if tp == world:
                    out.update(_rank_world(arch, tp, mesh_of((1, tp))))
            if world == 2:
                out.update(_local_heads(mesh_of((1, 2))))
            if world == 4:
                out.update(_cache_round_trip(mesh_of((2, 2))))
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()


def _rank_world(arch, tp, mesh):
    """Each layer's output on x, the rank's vocab shard of the logits and
    the vocab-parallel loss of the tiny ``arch`` (seed 0) on a (1, tp)
    world."""
    from repro_torch.train.loss import softmax_xent
    cfg = get_config(arch).tiny()
    lm = build_model(cfg, device="cpu", seed=0,
                     ctx=ShardCtx(mesh=mesh))
    x, labels = (torch.from_numpy(a) for a in _rank_inputs(cfg))
    positions = lm._positions(RANK_B, RANK_S)
    key = _rank_key(arch, tp)
    out = {f"{key}/layer{i}": lm._block_apply(blk, x, positions)[0].numpy()
           for i, blk in enumerate(lm.layers)}
    emb, _ = lm._top()
    logits = lm._head(emb, x)
    loss, _ = softmax_xent(logits, labels, cfg.vocab_size,
                           vocab=lm.logits_shard())
    out[f"{key}/logits"] = logits.numpy()
    out[f"{key}/loss"] = loss.numpy()
    out[f"{key}/embed"] = lm._lookup(emb, labels.clamp(min=0)).numpy()
    return out


def _local_heads(mesh):
    """On (1, 2): the shapes reaching the attention, decode and SSD
    wrappers in a prefill and decode step of the tiny Qwen3, Mamba2,
    DeepSeek-V2-Lite (MLA) and Whisper, and the all-gathers over "model"
    in a decode step of each."""
    import torch.distributed as dist
    from repro_torch.kernels import ops
    from repro_torch.launch import roofline
    from repro_torch.launch.mesh import axis_group
    seen = []

    def recorder(name, fn):
        def wrapped(*args, **kw):
            seen.append((name, tuple(args[0].shape)))
            return fn(*args, **kw)
        return wrapped

    saved = {n: getattr(ops, n) for n in ("attention", "decode_attention",
                                          "ssd")}
    model_ranks = tuple(dist.get_process_group_ranks(axis_group(mesh,
                                                                "model")))
    out = {}
    try:
        for n, fn in saved.items():
            setattr(ops, n, recorder(n, fn))
        for arch in ("qwen3-8b", "mamba2-2.7b", "deepseek-v2-lite-16b",
                     "whisper-large-v3"):
            cfg = get_config(arch).tiny()
            lm = build_model(cfg, device="cpu", seed=0,
                             ctx=ShardCtx(mesh=mesh))
            toks = torch.from_numpy(_model_tokens(cfg.vocab_size)).long()
            extra = ((torch.from_numpy(_frames(cfg)),)
                     if cfg.is_encoder_decoder else ())
            del seen[:]
            logits, cache = lm.prefill(toks, *extra, cache_len=CACHE_LEN)
            nxt = logits.full_tensor()[:, -1:].argmax(-1)
            with roofline.counting() as cnt:
                lm.decode_step(cache, nxt)
            out[f"heads/{arch}/shapes"] = np.array(
                [[["attention", "decode_attention", "ssd"].index(n), *shape]
                 for n, shape in seen])
            out[f"heads/{arch}/gathers"] = np.array(sum(
                kind == "all-gather" and ranks == model_ranks
                for kind, _, ranks in cnt.log))
            out[f"heads/{arch}/collectives"] = np.array(len(cnt.log))
    finally:
        for n, fn in saved.items():
            setattr(ops, n, fn)
    return out


def _cache_round_trip(mesh):
    """A cache dict put at ``cache_specs``' placements (``place_cache``)
    and gathered back, with and without a sharded sequence: whether every
    entry comes back whole and what share of it the rank holds."""
    from repro_torch.launch import shardings
    g = torch.Generator().manual_seed(5)
    cache = {"layers": [{"k": torch.randn(4, 4, 8, 16, generator=g),
                         "v": torch.randn(4, 4, 8, 16, generator=g)},
                        {"c": torch.randn(4, 8, 32, generator=g),
                         "rope": torch.randn(4, 8, 8, generator=g)},
                        {"ssm": torch.randn(4, 4, 8, 16, generator=g),
                         "conv": torch.randn(4, 3, 64, generator=g)}],
             "slot_pos": torch.arange(8, dtype=torch.int32), "pos": 8}
    out = {}
    for tag, seq in (("batch", None), ("seq", ("data",))):
        placed = shardings.place_cache(
            cache, mesh, shardings.cache_specs(cache, mesh, seq_axes=seq))
        whole = [torch.equal(shardings.gather(placed["layers"][i][k]),
                             cache["layers"][i][k])
                 for i, entry in enumerate(cache["layers"]) for k in entry]
        whole.append(torch.equal(shardings.gather(placed["slot_pos"]),
                                 cache["slot_pos"]))
        out[f"cache/{tag}/whole"] = np.array(all(whole) and
                                             placed["pos"] == 8)
        out[f"cache/{tag}/k_share"] = np.array(
            placed["layers"][0]["k"].to_local().numel()
            / cache["layers"][0]["k"].numel())
    return out


def _free_ports(n: int):
    """n distinct free local ports (their sockets held open together)."""
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
    """(the reference's weights and outputs, {world size: [each rank's
    outputs]}). The gloo worlds start once the reference has written its
    weights, and run while it computes."""
    d = tmp_path_factory.mktemp("shard")
    weights, ref_path = str(d / "weights.npz"), str(d / "ref.npz")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    proc = subprocess.Popen([sys.executable, os.path.abspath(__file__),
                             "--reference", weights, ref_path], env=env,
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
                world, port, weights, str(d / f"w{world}")),
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
    ref_out = {}
    for path in (weights, ref_path):
        with np.load(path) as f:
            ref_out.update({k: f[k] for k in f.files})
    worlds = {}
    for world in (2, 4):
        worlds[world] = []
        for r in range(world):
            with np.load(d / f"w{world}" / f"rank{r}.npz") as f:
                worlds[world].append({k: f[k] for k in f.files})
    return ref_out, worlds


# ------------------------------------------------------------------ tests
@pytest.mark.parametrize("arch,mesh,bs", MOE_CASES)
def test_moe_world_matches_reference(runs, arch, mesh, bs):
    ref_out, worlds = runs
    key = _moe_key(arch, mesh, bs)
    want = ref_out[f"{key}/y"]
    for rank_out in worlds[_world(mesh)]:
        np.testing.assert_allclose(rank_out[key], want, **MOE_TOL)
    if f"{key}/y_shards" in ref_out:
        # per-shard capacity: the reference's split run is its unsharded
        # layer on each data shard's tokens, and differs from the whole
        np.testing.assert_allclose(
            want.reshape(-1, want.shape[-1]), ref_out[f"{key}/y_shards"],
            **MOE_TOL)
        if mesh == (2, 2) and bs == (2, 8):
            assert np.abs(want - ref_out[f"{key}/y_local"]).max() > 1e-2


@pytest.mark.parametrize("arch,mesh,bs", MOE_CASES)
def test_moe_world_against_one_process(runs, arch, mesh, bs):
    """World 2 bit for bit; world 4 at the float32 tolerance."""
    ref_out, worlds = runs
    key = _moe_key(arch, mesh, bs)
    cfg = get_config(arch).tiny()
    p = _params(ref_out, f"moe/{arch}/p/")
    with torch.no_grad():
        one = moe.moe_ranks(p, torch.from_numpy(_moe_input(bs, cfg.d_model)),
                            cfg,
                            tp=mesh[1], data=mesh[0]).numpy()
    got = worlds[_world(mesh)][0][key]
    if _world(mesh) == 2:
        np.testing.assert_array_equal(got, one)
    else:
        np.testing.assert_allclose(got, one, **MOE_TOL)


@pytest.mark.parametrize("n,case", LSE_CASES)
def test_lse_decode_world_matches_reference(runs, n, case):
    ref_out, worlds = runs
    key = _lse_key(n, case)
    for rank_out in worlds[n]:
        np.testing.assert_allclose(rank_out[key], ref_out[f"{key}/y"],
                                   **MOE_TOL)
    q, k, v, valid = (torch.from_numpy(a) for a in _lse_inputs(n, case))
    one = attention.lse_ranks(q, attention.seq_shards(k, v, valid,
                                                      n)).numpy()
    if n == 2:
        np.testing.assert_array_equal(worlds[n][0][key], one)
    else:
        np.testing.assert_allclose(worlds[n][0][key], one, **MOE_TOL)
    if case == "neg":
        # the reference's rule: an empty shard's m = 0 joins the max, so
        # logits far below 0 weigh nothing, unlike the unsharded decode
        whole = ref.decode_attention_ref(q, k, v, valid).numpy()
        assert np.abs(whole).max() > 0.1
        assert np.abs(one).max() < 1e-10


@pytest.mark.parametrize("arch,tp", RANK_CASES)
def test_rank_bodies_match_one_process(runs, arch, tp):
    """Every layer, the vocab shards of the logits and the loss of a
    (1, tp) world against ``models.tp``'s rank bodies in one process: bit
    for bit on 2 ranks, at the float32 tolerance on 4."""
    from repro_torch.models import remat, tp as tp_lib
    _, worlds = runs
    cfg = get_config(arch).tiny()
    lm = build_model(cfg, device="cpu", seed=0)
    x, labels = (torch.from_numpy(a) for a in _rank_inputs(cfg))
    positions = lm._positions(RANK_B, RANK_S)
    key = _rank_key(arch, tp)
    check = (np.testing.assert_array_equal if tp == 2 else
             functools.partial(np.testing.assert_allclose, **MOE_TOL))
    with torch.no_grad():
        for i, blk in enumerate(lm.layers):
            want = tp_lib.layer_ranks(blk.spec, remat.unit_params(blk), x,
                                      cfg, positions, tp).numpy()
            for rank_out in worlds[tp]:
                check(rank_out[f"{key}/layer{i}"], want, err_msg=f"layer {i}")
        parts = tp_lib.head_ranks(lm.embed, x, cfg, tp)
        loss, _ = tp_lib.xent_ranks(parts, labels, cfg)
        whole = torch.nn.functional.embedding(labels.clamp(min=0),
                                              lm.embed["embedding"])
    for r, rank_out in enumerate(worlds[tp]):
        np.testing.assert_array_equal(rank_out[f"{key}/logits"],
                                      parts[r].numpy())
        check(rank_out[f"{key}/loss"], loss.numpy())
        # a vocab-parallel lookup adds zeros to the token's row: exact
        np.testing.assert_array_equal(rank_out[f"{key}/embed"],
                                      whole.numpy())


def test_heads_run_on_their_rank(runs):
    """On (1, 2) each rank's attention, decode and SSD calls take its
    heads (tiny Qwen3: 2 of 4 query heads, 1 of 2 KV heads; Mamba2: 8 of
    16 SSD heads; DeepSeek's MLA prefill and Whisper: 2 of 4 heads), and
    a decode step all-gathers nothing over "model"."""
    _, worlds = runs
    for rank_out in worlds[2]:
        q = rank_out["heads/qwen3-8b/shapes"]
        att = q[q[:, 0] == 0]
        dec = q[q[:, 0] == 1]
        assert len(att) == 2 and (att[:, 2] == 2).all()   # (B, Hq/2, S, D)
        assert len(dec) == 2 and (dec[:, 2:4] == [1, 2]).all()
        m = rank_out["heads/mamba2-2.7b/shapes"]
        assert len(m) == 2 and (m[:, 3] == 8).all()        # (B, S, H/2, P)
        for arch in ("deepseek-v2-lite-16b", "whisper-large-v3"):
            w = rank_out[f"heads/{arch}/shapes"]
            att = w[w[:, 0] == 0]
            assert len(att) > 0 and (att[:, 2] == 2).all(), arch
        for arch in ("qwen3-8b", "mamba2-2.7b", "deepseek-v2-lite-16b",
                     "whisper-large-v3"):
            assert int(rank_out[f"heads/{arch}/gathers"]) == 0, arch
            assert int(rank_out[f"heads/{arch}/collectives"]) > 0, arch


@pytest.mark.parametrize("name,arch,mesh,fields", MODEL_CASES,
                         ids=[c[0] for c in MODEL_CASES])
def test_model_world_matches_reference(runs, name, arch, mesh, fields):
    ref_out, worlds = runs
    for rank_out in worlds[_world(mesh)]:
        np.testing.assert_allclose(rank_out[f"model/{name}/logits0"],
                                   ref_out[f"model/{name}/logits0"],
                                   **APPLY_TOL)
        for t in range(1, STEPS + 1):
            np.testing.assert_allclose(rank_out[f"model/{name}/logits{t}"],
                                       ref_out[f"model/{name}/logits{t}"],
                                       err_msg=f"step {t}", **DECODE_TOL)
        np.testing.assert_array_equal(rank_out[f"model/{name}/greedy"],
                                      ref_out[f"model/{name}/greedy"])


@pytest.mark.parametrize("name", [c[0] for c in MODEL_CASES
                                  if c[1] == "whisper-large-v3"])
def test_encdec_weights_round_trip(runs, name):
    """The reference's tiny Whisper weights placed at their shards
    (``convert.model_from_reference`` under a context) gather back bit
    for bit on every rank, and some rank holds only a shard."""
    _, worlds = runs
    shape = dict((c[0], c[2]) for c in MODEL_CASES)[name]
    for rank_out in worlds[_world(shape)]:
        assert bool(rank_out[f"model/{name}/round_trip"])


def test_place_cache_round_trip(runs):
    """On (2, 2): k's batch over "data" and heads over "model" (a quarter
    a rank), or with a sharded sequence its heads over "model" and its
    slots over "data" (a quarter); every entry gathers back whole."""
    _, worlds = runs
    for rank_out in worlds[4]:
        for tag in ("batch", "seq"):
            assert bool(rank_out[f"cache/{tag}/whole"])
            assert float(rank_out[f"cache/{tag}/k_share"]) == 0.25


def test_partial_plain_matches_reference_body():
    """The partial's plain version against the reference's own body: its
    ``sharded_lse_decode`` on one device, whose one shard is the whole
    cache; the port combines one partial."""
    import jax
    import jax.numpy as jnp
    from repro.models.attention import sharded_lse_decode
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]), ("data",))
    body = None
    # (every valid logit near -150 makes the output ill-conditioned in
    # float32; the worlds hold that case, where an empty shard zeroes it)
    for case in ("mask", "empty"):
        q, k, v, valid = _lse_inputs(2, case)
        B, Hkv, G, D = q.shape
        if body is None:
            body = jax.jit(functools.partial(
                sharded_lse_decode, group=G, axes=("data",), mesh=mesh))
        want = np.asarray(body(
            jnp.asarray(q.reshape(B, Hkv * G, D)), jnp.asarray(k),
            jnp.asarray(v), jnp.asarray(valid))).reshape(B, Hkv, G, D)
        part = ref.decode_attention_partial_ref(
            *(torch.from_numpy(a) for a in (q, k, v, valid)))
        got = attention.lse_combine([part], torch.float32).numpy()
        np.testing.assert_allclose(got, want, **MOE_TOL)
        # the split plain version merges to the same partial
        m, l, acc = part
        m3, l3, acc3 = ref.decode_attention_partial_ref(
            *(torch.from_numpy(a) for a in (q, k, v, valid)), splits=3)
        np.testing.assert_allclose(
            (acc3 / l3.clamp(min=1e-30)).numpy(),
            (acc / l.clamp(min=1e-30)).numpy(), **MOE_TOL)


def test_sharded_ctx_refuses_grad_and_shared_axis():
    from repro_torch.launch.mesh import MeshShape
    cfg = get_config("qwen3-8b").tiny()
    with pytest.raises(ValueError, match="share"):
        ShardCtx(mesh=MeshShape(("data", "model"), (2, 1)),
                 batch_axes=("data",),
                 decode_seq_axes=("data",)).check_local()
    # since 12g the batch may split over "pod" (and "data"): checked, and
    # off a DeviceMesh the model is the unsharded one
    pod = ShardCtx(mesh=MeshShape(("pod", "data", "model"), (2, 1, 1)),
                   batch_axes=("pod",))
    pod.check_local()
    one = build_model(cfg, device="cpu")
    toks = torch.zeros((2, 4), dtype=torch.long)
    with torch.no_grad():
        assert torch.equal(build_model(cfg, device="cpu", ctx=pod).apply(
            toks), one.apply(toks))
    # the residual stream's sequence splits over the TP axis only
    with pytest.raises(ValueError, match="seq_axis"):
        ShardCtx(mesh=MeshShape(("data", "model"), (2, 2)),
                 seq_axis="data").check_local()
    with pytest.raises(ValueError, match="mesh's order"):
        ShardCtx(mesh=MeshShape(("pod", "data", "model"), (2, 2, 1)),
                 batch_axes=("data", "pod")).check_local()
    ctx = ShardCtx(mesh=MeshShape(("data", "model"), (1, 2)))
    # since 12f the encoder-decoder takes a sharded context too; off a
    # DeviceMesh it is the unsharded model's
    wcfg = get_config("whisper-large-v3").tiny()
    frames = torch.zeros((1, wcfg.encoder_seq, wcfg.d_model))
    toks = torch.zeros((1, 4), dtype=torch.long)
    with torch.no_grad():
        want = build_model(wcfg, device="cpu").apply(toks, frames)
        got = build_model(wcfg, device="cpu", ctx=ctx).apply(toks, frames)
    assert torch.equal(got, want)
    # since 12e a differentiated forward under a context with an axis
    # above 1 runs, and off a DeviceMesh it is the unsharded model's
    lm = build_model(cfg, device="cpu", trainable=True)
    toks = torch.zeros((1, 4), dtype=torch.long)
    want = lm.apply(toks)
    lm.ctx = ctx
    got = lm.apply(toks)
    assert got.requires_grad and torch.equal(got, want)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--reference"]:
        _reference(sys.argv[2], sys.argv[3])
