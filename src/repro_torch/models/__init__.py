"""Model zoo: config-driven decoder LMs (the port's copy of ``models/``).

``build_model(cfg, device=...)`` returns the decoder :class:`LM` with its
weights drawn from a seeded ``torch.Generator`` on the device. The
encoder-decoder (Whisper) and VLM wrappers wait for their slice (ROADMAP
§1 item 11) and raise.
"""
from ..configs.base import ModelConfig
from .transformer import LM

__all__ = ["LM", "build_model"]


def build_model(cfg: ModelConfig, device="cuda", seed: int = 0) -> LM:
    if cfg.is_encoder_decoder:
        raise NotImplementedError("the encoder-decoder (Whisper) wrapper "
                                  "waits for its slice (ROADMAP §1 item 11)")
    if cfg.num_patches:
        raise NotImplementedError("the VLM wrapper waits for its slice "
                                  "(ROADMAP §1 item 11)")
    return LM(cfg, device=device, seed=seed)
