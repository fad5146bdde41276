"""Every arch of the model zoo carries its weights across devices.

A model's ``state_dict`` loads into another model of the same config with
``strict=True`` (a leaf missing on either side raises): a CPU model into a
CPU model drawn from another seed here, and into a card model with ``-m
cuda``, where the card's prefill through the kernels then agrees with the
CPU's plain path at atol 2e-4 / rtol 2e-3 (float32 tiny configs). Jamba's
14 tiny mamba layers grow the float32 scan kernel's split-plane rounding
past that (ROADMAP §3 item 23): each of its layers is held on the CPU
path's own input instead. This file imports neither jax nor the JAX
package:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_zoo_weights.py
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import ARCHS, get_config
from repro_torch.models import build_model

MODEL_TOL = dict(atol=2e-4, rtol=2e-3)
# the archs whose mixers, MLPs or wrappers the zoo's last slice ported
NEW_ARCHS = ("deepseek-v2-lite-16b", "qwen3-moe-235b-a22b",
             "jamba-1.5-large-398b", "whisper-large-v3", "internvl2-76b")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; chip_smoke.py runs these checks "
                    "on the card")
    return torch.device("cuda")


def _layer_updates_agree(cpu, gpu, cfg):
    """Each layer's update on the CPU path's residual stream, card against
    CPU, at MODEL_TOL."""
    from repro_torch.models.layers import embed_lookup
    toks = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 20)))
    pos = cpu._positions(*toks.shape)
    with torch.inference_mode():
        x = embed_lookup(cpu.embed, toks, cfg)
        for bc, bg in zip(cpu.layers, gpu.layers):
            yc, _ = cpu._block_apply(bc, x, pos)
            yg, _ = gpu._block_apply(bg, x.cuda(), pos.cuda())
            torch.testing.assert_close(yg.cpu() - x, yc - x, **MODEL_TOL)
            x = yc


def _prefill(model, cfg, device):
    rng = np.random.default_rng(0)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, 20)),
                           device=device)
    extra = ()
    n = cfg.encoder_seq or cfg.num_patches
    if n:
        extra = (torch.as_tensor(rng.standard_normal(
            (2, n, cfg.d_model)).astype(np.float32), device=device),)
    with torch.inference_mode():
        return model.prefill(toks, *extra, cache_len=24)[0]


@pytest.mark.parametrize("arch", ARCHS)
def test_state_dict_loads_strictly_into_another_draw(arch):
    cfg = get_config(arch).tiny()
    a = build_model(cfg, device="cpu", seed=0)
    b = build_model(cfg, device="cpu", seed=1)
    assert not all(torch.equal(x, y) for x, y in
                   zip(a.state_dict().values(), b.state_dict().values()))
    b.load_state_dict(a.state_dict(), strict=True)
    for (ka, x), (kb, y) in zip(a.state_dict().items(),
                                b.state_dict().items()):
        assert ka == kb and x.dtype == y.dtype and torch.equal(x, y)
    assert torch.equal(_prefill(a, cfg, "cpu"), _prefill(b, cfg, "cpu"))


@pytest.mark.cuda
@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_cpu_weights_load_into_a_card_model(card, arch):
    cfg = get_config(arch).tiny()
    cpu = build_model(cfg, device="cpu", seed=0)
    gpu = build_model(cfg, device=card, seed=1)
    gpu.load_state_dict(cpu.state_dict(), strict=True)
    for (k, x), y in zip(cpu.state_dict().items(),
                         gpu.state_dict().values()):
        assert y.is_cuda and torch.equal(x, y.cpu()), k
    if arch == "jamba-1.5-large-398b":
        _layer_updates_agree(cpu, gpu, cfg)
        return
    got = _prefill(gpu, cfg, card).cpu()
    want = _prefill(cpu, cfg, "cpu")
    torch.testing.assert_close(got, want, **MODEL_TOL)
