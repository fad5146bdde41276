"""Device selection for the port's entry points.

Entry points take ``device="cuda"`` by default and run on the card; the
tests pass ``device="cpu"``. Asking for CUDA where no card is present is an
error, never a silent move to the CPU.
"""
from __future__ import annotations

import torch

__all__ = ["resolve_device", "model_device", "seeded_generator"]


def resolve_device(device="cuda") -> torch.device:
    """``torch.device`` for ``device``; raises if it names CUDA and no card
    is available."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() is "
            f"False; pass device='cpu' to run the plain PyTorch path")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device must be 'cuda' or 'cpu', got {str(dev)!r}")
    return dev


def model_device(device) -> torch.device:
    """:func:`resolve_device` for a model's weights, which may also be
    ``"meta"``: shapes without storage (the sharding specs of a full-size
    model)."""
    dev = torch.device(device)
    return dev if dev.type == "meta" else resolve_device(dev)


def seeded_generator(dev: torch.device, seed: int) -> torch.Generator:
    """The generator a model's weights are drawn from on ``dev`` (on the
    CPU for ``"meta"``, whose draws are never made)."""
    gen = torch.Generator(device="cpu" if dev.type == "meta" else dev)
    gen.manual_seed(seed)
    return gen
