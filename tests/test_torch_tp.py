"""Head-parallel compute's pieces that need no world (``models/tp.py``,
the split-row RMSNorm of ``kernels/rmsnorm.py``), on the CPU.

The split-row norm's plain version, rows cut into 2 and 4 column blocks
as TP ranks hold them, against the whole-row ``ref.rmsnorm_ref`` and
``ref.rmsnorm_bwd_ref`` at float32 1e-6, and its backward against
``torch.autograd`` of the whole row in float64; the meta branches'
counts; and the plan's rule on the full-size configurations (which
blocks run on their TP rank at tp 2, 4 and 16). The worlds that run the
plan are ``tests/test_torch_shard_dist.py`` and
``tests/test_torch_train_shard_dist.py``.
"""
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import ref
from repro_torch.kernels import rmsnorm as rn
from repro_torch.launch import roofline
from repro_torch.models import tp

TOL = dict(atol=1e-6, rtol=1e-6)


def _inputs(dtype=torch.float32, rows=(3, 5), n=96):
    g = torch.Generator().manual_seed(rows[0] * n)
    x = torch.randn((*rows, n), generator=g, dtype=dtype)
    w = 1 + 0.1 * torch.randn((n,), generator=g, dtype=dtype)
    dy = torch.randn((*rows, n), generator=g, dtype=dtype)
    return x, w, dy


def _split(parts, *ts):
    return [tuple(t.chunk(parts, -1)[r] for t in ts) for r in range(parts)]


@pytest.mark.parametrize("parts", [2, 4])
def test_split_rows_match_the_whole_row(parts):
    x, w, dy = _inputs()
    n, eps = x.shape[-1], 1e-6
    blocks = _split(parts, x, w, dy)
    ss = sum(rn.row_stat(xr) for xr, _, _ in blocks)
    y = torch.cat([rn.rmsnorm_rows(xr, wr, ss, n, eps=eps)
                   for xr, wr, _ in blocks], -1)
    torch.testing.assert_close(y, ref.rmsnorm_ref(x, w, eps), **TOL)
    dot = sum(rn.row_stat(xr, wr, gr) for xr, wr, gr in blocks)
    grads = [rn.rmsnorm_rows_bwd(xr, wr, gr, ss, dot, n, eps=eps)
             for xr, wr, gr in blocks]
    dx_want, dw_want = ref.rmsnorm_bwd_ref(x, w, dy, eps)
    torch.testing.assert_close(torch.cat([g[0] for g in grads], -1),
                               dx_want, **TOL)
    # each rank's dw is its own columns', no sum over the ranks
    torch.testing.assert_close(torch.cat([g[1] for g in grads], -1),
                               dw_want, **TOL)


@pytest.mark.parametrize("parts", [1, 2, 4])
def test_split_rows_backward_is_autograd_in_float64(parts):
    x, w, dy = _inputs(torch.float64, rows=(4,), n=32)
    x.requires_grad_(True)
    w.requires_grad_(True)
    dx_want, dw_want = torch.autograd.grad(ref.rmsnorm_ref(x, w), (x, w),
                                           dy)
    with torch.no_grad():
        blocks = _split(parts, x, w, dy)
        ss = sum(rn.row_stat(xr) for xr, _, _ in blocks)
        dot = sum(rn.row_stat(xr, wr, gr) for xr, wr, gr in blocks)
        grads = [rn.rmsnorm_rows_bwd(xr, wr, gr, ss, dot, 32)
                 for xr, wr, gr in blocks]
    torch.testing.assert_close(torch.cat([g[0] for g in grads], -1),
                               dx_want, atol=1e-12, rtol=1e-12)
    torch.testing.assert_close(torch.cat([g[1] for g in grads], -1),
                               dw_want, atol=1e-12, rtol=1e-12)
    if parts == 1:   # one rank: the Function's own gradient
        assert torch.autograd.gradcheck(
            lambda a, b: rn.rmsnorm_split(a, b, None, 32),
            (x.detach().requires_grad_(True),
             w.detach().requires_grad_(True)))


def test_split_rows_refuse_a_partial_row_without_a_group():
    x, w, _ = _inputs()
    with pytest.raises(ValueError, match="columns"):
        rn.rmsnorm_split(x[..., :48], w[:48], None, 96)


def test_split_rows_on_meta_record_their_work():
    x = torch.empty((4096, 320), dtype=torch.bfloat16, device="meta",
                    requires_grad=True)
    w = torch.empty((320,), dtype=torch.bfloat16, device="meta",
                    requires_grad=True)
    with roofline.counting() as cnt:
        y = rn.rmsnorm_split(x, w, None, 320)
        y.backward(torch.empty_like(y))
    k = cnt.kernels
    assert k["rmsnorm_stat"]["calls"] == 2
    assert k["rmsnorm_split"]["calls"] == 1
    assert k["rmsnorm_split_bwd"]["calls"] == 1
    assert k["rmsnorm_split"]["bytes"] == roofline.rmsnorm_split_work(
        4096, 320, 2)[1]


# (arch, tp): (mixer mode, MLP by rank, vocab by rank)
PLANS = {("qwen3-8b", 2): ("heads", True, True),
         ("qwen3-8b", 16): ("kv_slice", True, True),
         ("smollm-360m", 16): (None, True, True),
         ("whisper-large-v3", 16): (None, True, True),
         ("whisper-large-v3", 4): ("heads", True, True),
         ("mamba2-2.7b", 16): ("heads", False, True),
         ("deepseek-v2-lite-16b", 16): ("heads", True, True),
         ("h2o-danube-1.8b", 16): ("kv_slice", True, True),
         ("qwen3-8b", 1): (None, False, False)}


@pytest.mark.parametrize("arch,size", sorted(PLANS))
def test_plan_rule_on_full_configs(arch, size):
    cfg = get_config(arch)
    pl = tp.plan(cfg, cfg.pattern[0], size)
    mixer, mlp, vocab = PLANS[arch, size]
    assert pl.mixer == mixer
    assert pl.mlp == mlp or cfg.pattern[0].mlp == "none"
    assert tp.vocab_local(cfg, size) == vocab


def test_kv_slice_heads():
    """Qwen3-8B at tp 16: 32 query heads, 8 KV heads; rank r's 2 query
    heads read KV head r // 2."""
    assert [tp.kv_heads(r, 16, 32, 8).start for r in range(16)] == [
        r // 2 for r in range(16)]
    assert tp.kv_cols(5, 16, 32, 8, 128) == slice(256, 384)
