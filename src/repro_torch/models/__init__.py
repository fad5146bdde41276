"""Model zoo: config-driven families sharing one substrate (the port's copy
of ``models/``).

``build_model(cfg, device=..., seed=..., ctx=None, trainable=False)``
returns the right wrapper with its weights drawn from a seeded
``torch.Generator`` on the device; with ``trainable`` every parameter
requires a gradient (the training path), without it none does (serving,
the default):

* :class:`LM` — decoder-only (dense, MoE, MLA, SSM, hybrid);
* :class:`EncDec` — the Whisper-style encoder-decoder (audio);
* :class:`VLM` — patch embeddings prepended to the LM backbone (vlm).

All three have ``apply``, ``prefill``, ``decode_step`` and ``cache_init``.
"""
from ..configs.base import ModelConfig
from .transformer import LM, ShardCtx
from .vlm import VLM
from .whisper import EncDec

__all__ = ["LM", "EncDec", "VLM", "ShardCtx", "build_model"]


def build_model(cfg: ModelConfig, device="cuda", seed: int = 0,
                ctx: ShardCtx = None, trainable: bool = False):
    if ctx is not None:
        ctx.check_local()
    if cfg.is_encoder_decoder:
        model = EncDec(cfg, device=device, seed=seed)
    elif cfg.num_patches:
        model = VLM(cfg, device=device, seed=seed)
    else:
        model = LM(cfg, device=device, seed=seed)
    if trainable:
        model.requires_grad_(True)
    return model
