"""Model zoo: config-driven families sharing one substrate (the port's copy
of ``models/``).

``build_model(cfg, device=..., seed=..., ctx=None, trainable=False)``
returns the right wrapper with its weights drawn from a seeded
``torch.Generator`` on the device; with ``trainable`` every parameter
requires a gradient (the training path), without it none does (serving,
the default). A ``ShardCtx`` on a ``DeviceMesh`` puts the weights at
``launch.shardings.param_specs``' placements, each rank keeping its shard
of the same seeded draw (:func:`place`; ``models/transformer.py`` and
``models/tp.py`` say how the model then serves and trains, each rank on
its rows of the batch and its heads, columns and vocab shard):

* :class:`LM` — decoder-only (dense, MoE, MLA, SSM, hybrid);
* :class:`EncDec` — the Whisper-style encoder-decoder (audio);
* :class:`VLM` — patch embeddings prepended to the LM backbone (vlm).

All three have ``apply``, ``prefill``, ``decode_step`` and ``cache_init``.
"""
from ..configs.base import ModelConfig
from ..launch import shardings
from .transformer import LM, ShardCtx
from .vlm import VLM
from .whisper import EncDec

__all__ = ["LM", "EncDec", "VLM", "ShardCtx", "build_model", "place"]


def place(model, ctx: ShardCtx):
    """Put ``model``'s weights at the placements of ``param_specs`` over
    ``ctx``'s mesh (in place, a parameter at a time; nothing off a
    ``DeviceMesh``)."""
    specs = shardings.param_specs(model, ctx.mesh, tp=ctx.tp_axis,
                                  fsdp=ctx.fsdp_axis)
    return shardings.place_module(model, ctx.mesh, specs)


def build_model(cfg: ModelConfig, device="cuda", seed: int = 0,
                ctx: ShardCtx = None, trainable: bool = False):
    placed = ctx is not None and shardings.is_device_mesh(ctx.mesh)
    if ctx is not None:
        ctx.check_local()
    if cfg.is_encoder_decoder:
        model = EncDec(cfg, device=device, seed=seed, ctx=ctx)
    elif cfg.num_patches:
        model = VLM(cfg, device=device, seed=seed, ctx=ctx)
    else:
        model = LM(cfg, device=device, seed=seed, ctx=ctx)
    if trainable:
        model.requires_grad_(True)
    if placed:
        place(model, ctx)
    return model
