"""The port's roofline (``launch/roofline.py``) against the JAX package's.

``count_params`` and ``model_flops`` are held equal to the reference's for
every arch and shape; ``roofline_terms``, the claimed sizes and the kinds'
order are the cases of ``tests/test_roofline.py``; each model kernel's
meta branch records exactly its formula and returns its plain version's
shapes and dtypes; and a meta train step counts its backward: 2.5x to
3.5x its forward without remat, about one forward more under "full"
remat (each unit's forward runs twice).
"""
import dataclasses

import pytest
import torch

from repro.configs import ARCHS, SHAPES as JSHAPES, get_config as jget_config
from repro.launch import roofline as jroofline
from repro_torch import convert
from repro_torch.configs import SHAPES, get_config
from repro_torch.kernels import (flash_attention as fa, flash_decode as fd,
                                 rmsnorm as rn, ssd_scan as ssd)
from repro_torch.launch import roofline
from repro_torch.models import build_model
from repro_torch.optim.adamw import cosine_schedule
from repro_torch.train.step import init_state, make_train_step

META = "meta"


@pytest.mark.parametrize("shape", list(JSHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_params_and_model_flops_equal_the_reference(arch, shape):
    jcfg = jget_config(arch)
    cfg = convert.config_from_reference(dataclasses.asdict(jcfg))
    assert cfg == get_config(arch)
    assert roofline.count_params(cfg) == jroofline.count_params(jcfg)
    assert (roofline.model_flops(cfg, SHAPES[shape])
            == jroofline.model_flops(jcfg, JSHAPES[shape]))


def test_roofline_terms_dominant():
    hw = roofline.HW
    s = roofline.Count(flops=hw["peak_flops"], hbm_bytes=hw["hbm_bw"] * 2)
    t = roofline.roofline_terms(s, 4)
    assert t["dominant"] == "memory_s"
    assert abs(t["compute_s"] - 1.0) < 1e-6
    assert abs(t["roofline_fraction"] - 0.5) < 1e-6
    assert t["chips"] == 4
    s = roofline.Count(ici_bytes=hw["ici_bw"] * 3, dcn_bytes=hw["dcn_bw"])
    t = roofline.roofline_terms(s, 8)
    assert t["dominant"] == "collective_s"
    assert t["ici_s"] == pytest.approx(3.0) and t["dcn_s"] == pytest.approx(1)
    assert t["roofline_fraction"] == 0.0
    assert set(t) == {"compute_s", "memory_s", "collective_s", "ici_s",
                      "dcn_s", "dominant", "step_lower_bound_s",
                      "roofline_fraction", "chips"}


def test_hw_is_the_h100_datasheet():
    hw = roofline.HW
    assert hw["name"] == "NVIDIA H100 80GB HBM3" and hw["power_limit_w"] == 700
    assert "datasheet" in hw["source"]
    assert hw["peak_flops"] == roofline.BF16_OPS_PER_S == 989e12
    assert hw["hbm_bw"] == roofline.HBM_BYTES_PER_S == 3.35e12
    assert roofline.F32_SPLIT_OPS_PER_S == roofline.BF16_OPS_PER_S / 3
    assert hw["ici_bw"] > hw["dcn_bw"] > 0


def test_groups_cross_nodes_and_the_ring_model():
    assert not roofline.crosses_nodes(range(8))
    assert roofline.crosses_nodes(range(16))
    assert roofline.crosses_nodes([0, 16, 32])
    assert not roofline.crosses_nodes([3])
    assert roofline.wire_bytes("all-reduce", 100, 4) == 150
    assert roofline.wire_bytes("all-gather", 100, 4) == 75
    assert roofline.wire_bytes("reduce-scatter", 100, 4) == 75
    assert roofline.wire_bytes("collective-permute", 100, 4) == 100
    assert roofline.wire_bytes("all-reduce", 100, 1) == 0
    with roofline.counting() as cnt:
        roofline.record_collective("all-gather", 64, range(16, 24))
        roofline.record_collective("all-reduce", 64, [0, 16])
    assert cnt.ici_bytes == 56 and cnt.dcn_bytes == 64
    assert cnt.collective_counts == {"all-gather": 1, "all-reduce": 1}


def test_count_params_matches_claimed_sizes():
    for arch, lo, hi in [("qwen3-moe-235b-a22b", 220e9, 250e9),
                         ("nemotron-4-340b", 320e9, 360e9),
                         ("qwen3-8b", 7e9, 9e9),
                         ("smollm-360m", 0.3e9, 0.5e9),
                         ("jamba-1.5-large-398b", 370e9, 430e9)]:
        total, active = roofline.count_params(get_config(arch))
        assert lo < total < hi, (arch, total)
        assert active <= total


def test_model_flops_kinds_ordering():
    cfg = get_config("qwen3-8b")
    train = roofline.model_flops(cfg, SHAPES["train_4k"])
    prefill = roofline.model_flops(cfg, SHAPES["prefill_32k"])
    decode = roofline.model_flops(cfg, SHAPES["decode_32k"])
    assert train > prefill > decode > 0


def test_attention_pairs_counts_the_masks():
    def brute(Sq, Sk, causal, window):
        if not causal:
            return Sq * Sk
        w = window if window is not None else Sk
        return sum(min(q + 1, w) for q in range(Sq))
    for args in ((7, 7, True, None), (7, 7, True, 3), (5, 9, False, None),
                 (300, 300, True, 256), (4, 4, True, 10)):
        assert roofline.attention_pairs(*args) == brute(*args)


# --------------------------------------------------------- kernel counts
def _meta(shape, dtype=torch.bfloat16, grad=False):
    return torch.empty(shape, dtype=dtype, device=META, requires_grad=grad)


def _shapes(x):
    if isinstance(x, (tuple, list)):
        return [_shapes(t) for t in x]
    return (tuple(x.shape), x.dtype)


def _plain_like(fn, *args, **kw):
    """``fn`` on zeros of the meta arguments' shapes on the CPU (float32
    for bf16: the shapes and the dtypes it maps to are what is held)."""
    def cpu(t):
        if not isinstance(t, torch.Tensor):
            return t
        dt = torch.float32 if t.dtype == torch.bfloat16 else t.dtype
        return torch.zeros(t.shape, dtype=dt)
    return fn(*[cpu(a) for a in args], **kw)


def _dtypes_match(meta_out, cpu_out):
    m, c = _shapes(meta_out), _shapes(cpu_out)
    flat_m = m if isinstance(m, list) else [m]
    flat_c = c if isinstance(c, list) else [c]
    assert [s for s, _ in flat_m] == [s for s, _ in flat_c]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_rmsnorm_meta_counts_its_formula(dtype):
    x, w = _meta((3, 5, 64), dtype, True), _meta((64,), dtype, True)
    with roofline.counting() as cnt:
        y = rn.rmsnorm(x, w)
        dx, dw = torch.autograd.grad(y, (x, w), torch.empty_like(y))
    e = x.element_size()
    f, b = roofline.rmsnorm_work(15, 64, e)
    fb, bb = roofline.rmsnorm_bwd_work(15, 64, e)
    assert cnt.kernels["rmsnorm"] == {"calls": 1, "flops": f, "bytes": b}
    assert cnt.kernels["rmsnorm_bwd"] == {"calls": 1, "flops": fb,
                                          "bytes": bb}
    assert (y.shape, y.dtype, y.device.type) == (x.shape, dtype, META)
    assert (dx.shape, dx.dtype, dw.shape, dw.dtype) == (x.shape, dtype,
                                                        w.shape, dtype)
    _dtypes_match(y, _plain_like(rn.rmsnorm, x, w))
    assert rn.LAUNCHES["rmsnorm"] == 0 and rn.LAUNCHES["rmsnorm_bwd"] == 0


@pytest.mark.parametrize("case", [
    # (B, Hq, Hkv, Sq, Sk, D, Dv, causal, window)
    (2, 4, 2, 96, 96, 64, 64, True, None),
    (1, 4, 4, 80, 80, 192, 128, True, 32),
    (2, 2, 1, 8, 40, 64, 64, False, None)])
def test_flash_attention_meta_counts_its_formula(case):
    B, Hq, Hkv, Sq, Sk, D, Dv, causal, window = case
    q = _meta((B, Hq, Sq, D), grad=True)
    k = _meta((B, Hkv, Sk, D), grad=True)
    v = _meta((B, Hkv, Sk, Dv), grad=True)
    with roofline.counting() as cnt:
        o = fa.flash_attention(q, k, v, causal=causal, window=window)
        grads = torch.autograd.grad(o, (q, k, v), torch.empty_like(o))
    f, b = roofline.attention_work(B, Hq, Hkv, Sq, Sk, D, Dv, causal,
                                   window, 2)
    fb, bb = roofline.attention_bwd_work(B, Hq, Hkv, Sq, Sk, D, Dv, causal,
                                         window, 2)
    assert cnt.kernels["flash_attention"] == {"calls": 1, "flops": f,
                                              "bytes": b}
    assert cnt.kernels["flash_attention_bwd"] == {"calls": 1, "flops": fb,
                                                  "bytes": bb}
    assert (o.shape, o.dtype) == ((B, Hq, Sq, Dv), torch.bfloat16)
    assert [g.shape for g in grads] == [q.shape, k.shape, v.shape]
    _dtypes_match(o, _plain_like(fa.flash_attention, q, k, v, causal=causal,
                                 window=window))
    with torch.no_grad(), roofline.counting() as cnt:
        fa.flash_attention(q, k, v, causal=causal, window=window)
    assert set(cnt.kernels) == {"flash_attention"}


def test_flash_attention_meta_keeps_the_cards_refusals():
    q = _meta((1, 2, 8, 256), grad=True)
    with pytest.raises(ValueError, match="head dims up to"):
        fa.flash_attention(q, q, q)
    q = _meta((1, 2, 8, 12))
    with pytest.raises(ValueError, match="bf16 kernel"):
        fa.flash_attention(q, q, q)


@pytest.mark.parametrize("partial", [False, True])
def test_flash_decode_meta_counts_its_formula(partial):
    B, Hkv, G, S, D = 2, 4, 4, 300, 128
    q, k, v = _meta((B, Hkv, G, D)), _meta((B, Hkv, S, D)), \
        _meta((B, Hkv, S, D))
    valid = torch.empty((S,), dtype=torch.bool, device=META)
    fn = fd.flash_decode_partial if partial else fd.flash_decode
    work = roofline.decode_partial_work if partial else roofline.decode_work
    with roofline.counting() as cnt:
        out = fn(q, k, v, valid)
    f, b = work(B, Hkv, G, S, D, 2)
    name = "flash_decode_partial" if partial else "flash_decode"
    assert cnt.kernels[name] == {"calls": 1, "flops": f, "bytes": b}
    _dtypes_match(out, _plain_like(fn, q, k, v, valid))
    if partial:
        assert all(t.dtype == torch.float32 for t in out)
    else:
        assert out.dtype == torch.bfloat16


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_ssd_scan_meta_counts_its_formula(dtype):
    B, S, H, P, G, N, chunk = 2, 200, 4, 64, 1, 128, 128
    x = _meta((B, S, H, P), dtype, True)
    dt = _meta((B, S, H), torch.float32, True)
    A = _meta((H,), torch.float32, True)
    Bm, Cm = _meta((B, S, G, N), dtype, True), _meta((B, S, G, N), dtype,
                                                     True)
    Dk = _meta((H,), torch.float32, True)
    with roofline.counting() as cnt:
        y = ssd.ssd_scan(x, dt, A, Bm, Cm, Dk, chunk=chunk)
        grads = torch.autograd.grad(y, (x, dt, A, Bm, Cm, Dk),
                                    torch.empty_like(y))
    e = x.element_size()
    L = chunk if dtype == torch.bfloat16 else ssd.F32_MAX_CHUNK
    f, b = roofline.ssd_work(B, S, H, P, G, N, L, e)
    fb, bb = roofline.ssd_bwd_work(B, S, H, P, G, N,
                                   ssd.bwd_chunk(S, chunk, dtype), e)
    assert cnt.kernels["ssd_scan"] == {"calls": 1, "flops": f, "bytes": b}
    assert cnt.kernels["ssd_scan_bwd"] == {"calls": 1, "flops": fb,
                                           "bytes": bb}
    assert (y.shape, y.dtype) == (x.shape, dtype)
    assert [(g.shape, g.dtype) for g in grads] == [
        (t.shape, t.dtype) for t in (x, dt, A, Bm, Cm, Dk)]
    with torch.no_grad():
        y2, state = ssd.ssd_scan(x, dt, A, Bm, Cm, Dk, chunk=chunk,
                                 return_final_state=True)
    assert (state.shape, state.dtype) == ((B, H, P, N), torch.float32)


def test_meta_never_takes_a_cpu_tensor():
    x, w = torch.ones(4, 8), torch.ones(8)
    with roofline.counting() as cnt:
        rn.rmsnorm(x, w)
    assert cnt.kernels == {}


# ---------------------------------------------------- a counted train step
def _step_flops(remat):
    cfg = get_config("smollm-360m").tiny(4).replace(remat=remat)
    model = build_model(cfg, device=META, seed=0, trainable=True)
    B, S = 4, 64
    toks = torch.empty((B, S), dtype=torch.long, device=META)
    with roofline.counting() as fwd:
        model.apply(toks)
    state = init_state(model)
    step = make_train_step(model, cfg, cosine_schedule(1e-3, 2, 10))
    with roofline.counting() as train:
        step(state, toks, toks)
    return fwd.flops, train.flops, train


def test_meta_train_step_counts_its_backward():
    f0, t0, cnt = _step_flops(False)
    assert 2.5 <= t0 / f0 <= 3.5, t0 / f0
    assert cnt.kernels["flash_attention_bwd"]["calls"] == 4
    assert cnt.kernels["rmsnorm_bwd"]["calls"] == 9
    f1, t1, cnt = _step_flops(True)
    assert f1 == f0
    # "full" remat runs each unit's forward again: about one forward more
    # (the embedding and the head are outside the units)
    assert 0.6 <= (t1 - t0) / f0 <= 1.0, (t1 - t0) / f0
    assert cnt.kernels["flash_attention"]["calls"] == 8
    assert cnt.peak_bytes > 0
