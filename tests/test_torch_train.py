"""The port's training path against the JAX package, on the CPU.

Tiny configs (float32), inputs from numpy seeds, weights and optimizer
states carried across by ``convert``:

* ``SyntheticStream`` batches bitwise (tokens, labels, patches, frames);
  ``cosine_schedule`` to 1e-7; ``quantize_int8``: q equal, scales 1e-7
  relative; ``softmax_xent``: loss and accuracy 1e-6 with masked labels and
  a padded vocab; ``adamw_update`` fed the reference's own gradients:
  params, m and v 1e-6 relative.
* One ``make_train_step`` for every arch: ``tests/test_torch_train_archs.py``.
* ``make_partitioned_train_step`` on a world of 1 against the reference on
  its 1-device mesh (k = [2], max_micro 3): tokens equal, loss 1e-5.
* ``Trainer`` for 5 steps, plain and partitioned: losses 1e-4 relative,
  ``k_pods`` equal; resume from a checkpoint continues at its step; the
  CLI ``launch.train --tiny --device cpu`` prints the reference CLI's
  losses to 1e-4 (started from the reference's initial state through a
  step-0 checkpoint in ``--ckpt-dir``).

The world of 2 over gloo is ``tests/test_torch_train_dist.py``.
"""
import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.data import SyntheticStream as JStream
from repro.launch.mesh import make_local_mesh as jlocal_mesh
from repro.models import build_model as jbuild_model
from repro.models.transformer import ShardCtx as JShardCtx
from repro.optim import adamw as jadamw
from repro.optim import compress as jcompress
from repro.train import Trainer as JTrainer
from repro.train import TrainerConfig as JTrainerConfig
from repro.train import loss as jloss
from repro.train import step as jstep
from repro_torch import convert
from repro_torch.ckpt import store
from repro_torch.configs import get_config
from repro_torch.data import SyntheticStream
from repro_torch.launch import train as train_cli
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models import ShardCtx, build_model
from repro_torch.optim import adamw, compress
from repro_torch.train import Trainer, TrainerConfig, loss as tloss
from repro_torch.train import step as tstep

DEV = "cpu"
KEY = jax.random.PRNGKey(0)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _port(cfg_ref):
    return convert.config_from_reference(dataclasses.asdict(cfg_ref))


def _pair(arch):
    """(JAX cfg, model, state) and the port's (cfg, model, state) on the
    same weights."""
    jcfg = jget_config(arch).tiny()
    jm = jbuild_model(jcfg)
    jst = jstep.init_state(jm, KEY)
    cfg = _port(jcfg)
    host = _np(jst)
    model = convert.model_from_reference(host.params, cfg, device=DEV)
    st = convert.train_state_from_reference(host, cfg, device=DEV)
    return (jcfg, jm, jst), (cfg, model, st)


# ---------------------------------------------------------------- the data
@pytest.mark.parametrize("arch", ["smollm-360m", "internvl2-76b",
                                  "whisper-large-v3"])
def test_synthetic_stream_bitwise(arch):
    jcfg = jget_config(arch).tiny()
    cfg = _port(jcfg)
    for seed, host, hosts in ((0, 0, 1), (3, 1, 2)):
        js = JStream(jcfg, 40, 4, seed=seed, host_id=host, num_hosts=hosts)
        ps = SyntheticStream(cfg, 40, 4, seed=seed, host_id=host,
                             num_hosts=hosts)
        for step in (0, 7, 123):
            a, b = js.batch_at(step), ps.batch_at(step)
            np.testing.assert_array_equal(a.tokens, b.tokens)
            np.testing.assert_array_equal(a.labels, b.labels)
            if a.extra_embeds is None:
                assert b.extra_embeds is None
            else:
                np.testing.assert_array_equal(a.extra_embeds, b.extra_embeds)


# ----------------------------------------------------------- the optimizer
def test_cosine_schedule_matches():
    jlr = jadamw.cosine_schedule(1.0, 5, 40)
    plr = adamw.cosine_schedule(1.0, 5, 40)
    steps = np.arange(0, 48)
    want = np.asarray(jlr(jnp.asarray(steps, jnp.int32)))
    got = plr(torch.as_tensor(steps, dtype=torch.int32)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-7)


@pytest.mark.parametrize("shape", [(1000,), (3, 700), (2, 5, 256), ()])
def test_quantize_int8_matches(shape):
    x = (np.random.default_rng(1).standard_normal(shape) * 3).astype(
        np.float32)
    jq, js = jcompress.quantize_int8(jnp.asarray(x))
    q, s = compress.quantize_int8(torch.as_tensor(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-7, atol=0)
    jd = jcompress.dequantize_int8(jq, js, shape, jnp.float32)
    d = compress.dequantize_int8(q, s, shape, torch.float32)
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=1e-7, atol=0)
    # error feedback: one compress step from a zero residual
    jqs, jef = jcompress.ef_compress({"g": jnp.asarray(x)},
                                     jcompress.ef_init({"g": jnp.asarray(x)}))
    g = {"g": torch.as_tensor(x)}
    qs, ef = compress.ef_compress(g, compress.ef_init(g))
    np.testing.assert_array_equal(qs["g"][0].numpy(), np.asarray(jqs["g"][0]))
    np.testing.assert_allclose(ef.residual["g"].numpy(),
                               np.asarray(jef.residual["g"]), rtol=1e-6,
                               atol=1e-7)


def test_softmax_xent_matches_with_masks_and_padding():
    rng = np.random.default_rng(2)
    logits = rng.standard_normal((3, 9, 24)).astype(np.float32)
    labels = rng.integers(0, 20, (3, 9)).astype(np.int32)
    labels[0, :4] = -1
    labels[2, 5] = -1
    jl, jm = jloss.softmax_xent(jnp.asarray(logits), jnp.asarray(labels), 20)
    lt = torch.as_tensor(logits, dtype=torch.float32).requires_grad_(True)
    pl, pm = tloss.softmax_xent(lt, torch.as_tensor(labels), 20)
    np.testing.assert_allclose(float(pl.detach()), float(jl), rtol=1e-6)
    np.testing.assert_allclose(float(pm["accuracy"]), float(jm["accuracy"]),
                               rtol=1e-6, atol=1e-7)
    assert int(pm["tokens"]) == int(jm["tokens"]) == 22
    jg = jax.grad(lambda z: jloss.softmax_xent(z, jnp.asarray(labels),
                                               20)[0])(jnp.asarray(logits))
    pl.backward()
    np.testing.assert_allclose(lt.grad.numpy(), np.asarray(jg), rtol=1e-5,
                               atol=1e-7)


def _torch_leaf(a):
    """A numpy leaf as a tensor of its dtype (ml_dtypes bf16 as bf16)."""
    dt = torch.bfloat16 if a.dtype.name == "bfloat16" else None
    return convert._tensor(a).to(dt) if dt else convert._tensor(a)


def _adamw_pair(params_np, grads_np):
    """Three AdamW steps on both sides from the same params and the
    reference's gradients (scaled per step)."""
    jp = jax.tree.map(jnp.asarray, params_np)
    jo = jadamw.adamw_init(jp)
    pp = {k: _torch_leaf(v) for k, v in params_np.items()}
    po = adamw.adamw_init(pp)
    jlr = jadamw.cosine_schedule(1e-2, 1, 10)
    plr = adamw.cosine_schedule(1e-2, 1, 10)
    jupdate = jax.jit(lambda p, g, o: jadamw.adamw_update(p, g, o, jlr))
    for i in range(3):
        jg = {k: jnp.asarray(g) * (i + 1) for k, g in grads_np.items()}
        pg = {k: _torch_leaf(g) * (i + 1)
              for k, g in grads_np.items()}
        jp, jo, jom = jupdate(jp, jg, jo)
        pp, po, pom = adamw.adamw_update(pp, pg, po, plr)
        np.testing.assert_allclose(float(pom["grad_norm"]),
                                   float(jom["grad_norm"]), rtol=1e-6)
    return (jp, jo), (pp, po)


def test_adamw_update_matches_with_reference_gradients():
    (jcfg, jm, jst), (cfg, model, st) = _pair("smollm-360m")
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, jcfg.vocab_size, (2, 16)).astype(np.int32)
    loss_fn = jstep.make_loss_fn(jm, jcfg)
    jgrads = jax.jit(jax.grad(lambda p: loss_fn(
        p, jnp.asarray(tokens), jnp.asarray(tokens))[0]))(jst.params)
    params = convert._model_state(_np(jst.params), cfg)
    grads = convert._model_state(_np(jgrads), cfg)
    (jp, jo), (pp, po) = _adamw_pair(params, grads)
    jp, jm_, jv = (_np(t) for t in (jp, jo.m, jo.v))
    assert int(po.step) == int(jo.step) == 3
    for k in params:
        assert _rel(pp[k].numpy(), jp[k]) < 1e-6, k
        assert _rel(po.m[k].numpy(), jm_[k]) < 1e-6, k
        assert _rel(po.v[k].numpy(), jv[k]) < 1e-6, k


def test_adamw_bf16_params_update_in_float32_without_a_master_copy():
    rng = np.random.default_rng(4)
    import ml_dtypes
    params = {"w": rng.standard_normal((8, 16)).astype(ml_dtypes.bfloat16),
              "b": rng.standard_normal((16,)).astype(ml_dtypes.bfloat16)}
    grads = {k: rng.standard_normal(v.shape).astype(ml_dtypes.bfloat16)
             for k, v in params.items()}
    (jp, jo), (pp, po) = _adamw_pair(params, grads)
    for k in params:
        assert pp[k].dtype == torch.bfloat16 and po.m[k].dtype == torch.float32
        np.testing.assert_array_equal(
            pp[k].float().numpy(), np.asarray(jp[k]).astype(np.float32))
        assert _rel(po.v[k].numpy(), np.asarray(jo.v[k])) < 1e-6


# ------------------------------------------------------------- train steps
def test_partitioned_step_world_of_one_matches_reference():
    jcfg = jget_config("smollm-360m").tiny()
    jmesh = jlocal_mesh(("pod", "data", "model"))
    jm = jbuild_model(jcfg, JShardCtx(mesh=jmesh, batch_axes=("data",)))
    jst = jstep.init_state(jm, KEY)
    cfg = _port(jcfg)
    host = _np(jst)
    mesh = make_local_mesh(("pod", "data", "model"))
    model = convert.model_from_reference(host.params, cfg, device=DEV)
    st = convert.train_state_from_reference(host, cfg, device=DEV)
    tokens = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (3, 2, 16)).astype(np.int32)
    for compress_join in (False, True):
        jfn = jax.jit(jstep.make_partitioned_train_step(
            jm, jcfg, jmesh, jadamw.cosine_schedule(1e-3, 2, 10),
            max_micro=3, compress_pod_reduce=compress_join))
        _, jmet = jfn(jst, jnp.asarray(tokens), jnp.asarray(tokens),
                      jnp.array([2], jnp.int32))
        pfn = tstep.make_partitioned_train_step(
            model, cfg, mesh, adamw.cosine_schedule(1e-3, 2, 10), max_micro=3,
            compress_pod_reduce=compress_join)
        _, pmet = pfn(st, torch.as_tensor(tokens), torch.as_tensor(tokens),
                      np.array([2]))
        assert float(pmet["tokens"]) == float(jmet["tokens"]) == 2 * 2 * 16
        np.testing.assert_allclose(float(pmet["loss"]), float(jmet["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(pmet["grad_norm"]),
                                   float(jmet["grad_norm"]), rtol=1e-4)


# ----------------------------------------------------------------- trainer
def _trainers(partitioned, steps=5, **kw):
    jcfg = jget_config("smollm-360m").tiny()
    cfg = _port(jcfg)
    tk = dict(steps=steps, batch=4, seq=16, log_every=100,
              partitioned=partitioned, max_micro=3, microbatch=1, **kw)
    jmesh = mesh = jctx = None
    if partitioned:
        jmesh = jlocal_mesh(("pod", "data", "model"))
        jctx = JShardCtx(mesh=jmesh, batch_axes=("data",))
        mesh = make_local_mesh(("pod", "data", "model"))
    jm = jbuild_model(jcfg, jctx)
    model = convert.model_from_reference(_np(jm.init(KEY)), cfg, device=DEV)
    jt = JTrainer(jm, jcfg, JTrainerConfig(**tk), mesh=jmesh)
    pt = Trainer(model, cfg, TrainerConfig(**tk), mesh=mesh)
    return jt, pt


@pytest.mark.parametrize("partitioned", [False, True],
                         ids=["plain", "partitioned"])
def test_trainer_matches(partitioned):
    jt, pt = _trainers(partitioned)
    _, jh = jt.run()
    _, ph = pt.run()
    assert [h["step"] for h in ph] == [h["step"] for h in jh] == list(range(5))
    np.testing.assert_allclose([h["loss"] for h in ph],
                               [h["loss"] for h in jh], rtol=1e-4)
    if partitioned:
        assert [h["k_pods"] for h in ph] == [h["k_pods"] for h in jh]
        np.testing.assert_allclose([h["sim_join_time"] for h in ph],
                                   [h["sim_join_time"] for h in jh],
                                   rtol=1e-9)


def test_trainer_resume_continues_at_step(tmp_path):
    cfg = get_config("smollm-360m").tiny()
    mesh = make_local_mesh(("pod", "data", "model"))
    model = build_model(cfg, device=DEV, seed=0, trainable=True,
                        ctx=ShardCtx(mesh=mesh, batch_axes=("data",)))
    t1 = TrainerConfig(steps=4, batch=2, seq=16, ckpt_dir=str(tmp_path),
                       ckpt_interval=2, log_every=100)
    s4, h4 = Trainer(model, cfg, t1).run()
    t2 = TrainerConfig(steps=6, batch=2, seq=16, ckpt_dir=str(tmp_path),
                       ckpt_interval=2, log_every=100)
    _, hist = Trainer(model, cfg, t2).run()
    assert hist[0]["step"] == 4  # resumed, not restarted
    # the restored state is the saved one, bit for bit
    restored, meta = store.restore(str(tmp_path), s4, step=4)
    assert meta["step"] == 4 and int(restored.opt.step) == 4
    for k, p in s4.params.items():
        assert torch.equal(restored.params[k], p.detach())
        assert torch.equal(restored.opt.m[k], s4.opt.m[k])


def _printed_losses(text):
    return [float(m) for m in re.findall(r"^step\s+\d+ loss ([0-9.]+)", text,
                                         flags=re.M)]


def test_cli_prints_the_reference_losses(tmp_path, capsys, monkeypatch):
    from repro.launch import train as jcli
    argv = ["--arch", "smollm-360m", "--tiny", "--steps", "21", "--batch",
            "4", "--seq", "16"]
    monkeypatch.setattr("sys.argv", ["train"] + argv)
    jcli.main()
    want = _printed_losses(capsys.readouterr().out)
    # the reference CLI's initial state, as a step-0 checkpoint
    jcfg = jget_config("smollm-360m").tiny()
    jm = jbuild_model(jcfg)
    host = _np(jstep.init_state(jm, KEY))
    st = convert.train_state_from_reference(host, _port(jcfg), device=DEV)
    store.save(str(tmp_path), 0, st)
    train_cli.main(argv + ["--device", "cpu", "--ckpt-dir", str(tmp_path)])
    got = _printed_losses(capsys.readouterr().out)
    assert len(got) == len(want) == 3
    np.testing.assert_allclose(got, want, rtol=1e-4)
