"""Model zoo: config-driven families sharing one substrate (the port's copy
of ``models/``).

``build_model(cfg, device=..., seed=...)`` returns the right wrapper with
its weights drawn from a seeded ``torch.Generator`` on the device:

* :class:`LM` — decoder-only (dense, MoE, MLA, SSM, hybrid);
* :class:`EncDec` — the Whisper-style encoder-decoder (audio);
* :class:`VLM` — patch embeddings prepended to the LM backbone (vlm).

All three have ``apply``, ``prefill``, ``decode_step`` and ``cache_init``.
"""
from ..configs.base import ModelConfig
from .transformer import LM
from .vlm import VLM
from .whisper import EncDec

__all__ = ["LM", "EncDec", "VLM", "build_model"]


def build_model(cfg: ModelConfig, device="cuda", seed: int = 0):
    if cfg.is_encoder_decoder:
        return EncDec(cfg, device=device, seed=seed)
    if cfg.num_patches:
        return VLM(cfg, device=device, seed=seed)
    return LM(cfg, device=device, seed=seed)
