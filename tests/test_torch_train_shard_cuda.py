"""The dry run's meta branches and a sharded train step on the card.

* Each model kernel's meta branch returns the shapes and dtypes its CUDA
  launch returns, on the same arguments, forward and backward, and
  launches nothing; the CUDA call records nothing in an active count.
* A CUDA tensor never takes the meta or the plain route: with the plain
  versions made to raise, every kernel still runs, and its launch count
  moves.
* A world of one over NCCL: the tiny SmolLM placed on a (1, 1)
  ``DeviceMesh`` takes one ``make_train_step``, bit for bit the unplaced
  model's step on the same weights (loss, every parameter and moment).

Marked ``cuda``: each test skips without an NVIDIA GPU. This file imports
no JAX. On the card::

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_train_shard_cuda.py
"""
import socket

import pytest
import torch

from repro_torch.kernels import (flash_attention as fa, flash_decode as fd,
                                 ref, rmsnorm as rn, ssd_scan as ssd)
from repro_torch.launch import roofline

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; chip_smoke.py's shard and train "
                    "phases run these checks on the card")
    return torch.device("cuda")


def _pair(shape, dtype, dev, grad=False, gen=None):
    """The same (uninitialised on meta, random on the card) tensor on
    both devices."""
    t = torch.randn(shape, generator=gen, device=dev).to(dtype)
    m = torch.empty(shape, dtype=dtype, device="meta")
    return (t.requires_grad_(grad), m.requires_grad_(grad))


def _sig(x):
    if isinstance(x, (tuple, list)):
        return [_sig(t) for t in x]
    return (tuple(x.shape), x.dtype)


def _cases(dev):
    g = torch.Generator(device=dev).manual_seed(0)
    bf, f32 = torch.bfloat16, torch.float32
    x, xm = _pair((4, 96, 256), bf, dev, True, g)
    w, wm = _pair((256,), bf, dev, True, g)
    yield "rmsnorm", (lambda a, b: rn.rmsnorm(a, b)), (x, w), (xm, wm)
    q, qm = _pair((2, 8, 128, 128), bf, dev, True, g)
    k, km = _pair((2, 2, 128, 128), bf, dev, True, g)
    v, vm = _pair((2, 2, 128, 128), bf, dev, True, g)
    yield ("flash_attention",
           (lambda a, b, c: fa.flash_attention(a, b, c, causal=True)),
           (q, k, v), (qm, km, vm))
    qd, qdm = _pair((2, 2, 4, 128), bf, dev, False, g)
    kd, kdm = _pair((2, 2, 512, 128), bf, dev, False, g)
    valid = torch.ones(512, dtype=torch.bool, device=dev)
    vm_ = torch.empty(512, dtype=torch.bool, device="meta")
    yield ("flash_decode", fd.flash_decode, (qd, kd, kd, valid),
           (qdm, kdm, kdm, vm_))
    yield ("flash_decode_partial", fd.flash_decode_partial,
           (qd, kd, kd, valid), (qdm, kdm, kdm, vm_))
    B, S, H, P, G, N = 1, 256, 4, 64, 1, 128
    xs, xsm = _pair((B, S, H, P), bf, dev, True, g)
    dt = torch.rand((B, S, H), generator=g, device=dev).mul(0.1) \
        .requires_grad_(True)
    dtm = torch.empty((B, S, H), dtype=f32, device="meta",
                      requires_grad=True)
    A = (-torch.rand((H,), generator=g, device=dev)).requires_grad_(True)
    Am = torch.empty((H,), dtype=f32, device="meta", requires_grad=True)
    Bm_, Bmm = _pair((B, S, G, N), bf, dev, True, g)
    Cm_, Cmm = _pair((B, S, G, N), bf, dev, True, g)
    Dk, Dkm = _pair((H,), f32, dev, True, g)
    yield ("ssd_scan", (lambda *a: ssd.ssd_scan(*a, chunk=128)),
           (xs, dt, A, Bm_, Cm_, Dk), (xsm, dtm, Am, Bmm, Cmm, Dkm))


def test_meta_branches_match_the_kernels_shapes(card):
    for name, fn, cuda_args, meta_args in _cases(card):
        grads_on = any(t.requires_grad for t in cuda_args)
        with roofline.counting() as cnt:
            got = fn(*cuda_args)
        assert cnt.kernels == {}, name   # the card records nothing
        with roofline.counting() as cnt:
            want = fn(*meta_args)
        assert cnt.kernels[name]["calls"] == 1, name
        assert _sig(got) == _sig(want), name
        if grads_on:
            ins = [t for t in cuda_args if t.requires_grad]
            mins = [t for t in meta_args if t.requires_grad]
            g_card = torch.autograd.grad(got, ins, torch.ones_like(got))
            with roofline.counting() as cnt:
                g_meta = torch.autograd.grad(want, mins,
                                             torch.empty_like(want))
            assert cnt.kernels[f"{name}_bwd"]["calls"] == 1, name
            assert _sig(g_card) == _sig(g_meta), name


def test_cuda_never_takes_the_meta_or_plain_route(card, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a CUDA tensor took the plain route")
    for fn in ("rmsnorm_ref", "rmsnorm_bwd_ref", "flash_attention_ref",
               "flash_attention_lse_ref", "flash_attention_bwd_ref",
               "decode_attention_ref", "decode_attention_partial_ref",
               "ssd_chunked_ref", "ssd_chunked_bwd_ref"):
        monkeypatch.setattr(ref, fn, refuse)
    for mod in (rn, fa, fd, ssd):
        mod.reset_launches()
    for name, fn, cuda_args, _ in _cases(card):
        out = fn(*cuda_args)
        ins = [t for t in cuda_args if t.requires_grad]
        if ins:
            torch.autograd.grad(out, ins, torch.ones_like(out))
    torch.cuda.synchronize()
    assert rn.LAUNCHES["rmsnorm"] == 1 and rn.LAUNCHES["rmsnorm_bwd"] == 1
    assert fa.LAUNCHES["flash_attention"] == 1
    assert fa.LAUNCHES["flash_attention_bwd"] == 1
    assert fd.LAUNCHES["flash_decode"] == 1
    assert fd.LAUNCHES["flash_decode_partial"] == 1
    assert ssd.LAUNCHES["ssd_scan"] == 1 and ssd.LAUNCHES["ssd_scan_bwd"] == 1


def test_world_of_one_step_is_bitwise_the_unsharded_step(card):
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor
    from repro_torch.configs import get_config
    from repro_torch.launch import shardings
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import ShardCtx, build_model
    from repro_torch.optim.adamw import cosine_schedule
    from repro_torch.train.step import init_state, make_train_step
    cfg = get_config("smollm-360m").tiny()
    g = torch.Generator(device="cpu").manual_seed(3)
    tokens = torch.randint(0, cfg.vocab_size, (4, 64), generator=g).cuda()
    labels = torch.randint(0, cfg.vocab_size, (4, 64), generator=g).cuda()
    lr = cosine_schedule(1e-3, 2, 10)

    def run(ctx):
        model = build_model(cfg, device="cuda", seed=0, ctx=ctx,
                            trainable=True)
        state = init_state(model)
        state, m = make_train_step(model, cfg, lr)(state, tokens, labels)
        return state, m

    base, bm = run(None)
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                            rank=0, world_size=1)
    try:
        mesh = make_mesh((1, 1), ("data", "model"), "cuda")
        got, gm = run(ShardCtx(mesh=mesh, batch_axes=("data",)))
        assert all(isinstance(p, DTensor) for p in got.params.values())
        assert torch.equal(gm["loss"], bm["loss"])
        for tree_a, tree_b in ((got.params, base.params),
                               (got.opt.m, base.opt.m),
                               (got.opt.v, base.opt.v)):
            for k, a in tree_a.items():
                assert torch.equal(shardings.local(a).detach(),
                                   tree_b[k].detach()), k
    finally:
        dist.destroy_process_group()
