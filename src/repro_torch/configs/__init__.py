"""Config registry: one module per assigned architecture (``--arch <id>``)."""
from importlib import import_module

from .base import SHAPES, LayerSpec, ModelConfig, ShapeSpec, shape_applicable

ARCHS = (
    "qwen3-moe-235b-a22b",
    "deepseek-v2-lite-16b",
    "nemotron-4-340b",
    "qwen3-8b",
    "smollm-360m",
    "h2o-danube-1.8b",
    "whisper-large-v3",
    "mamba2-2.7b",
    "jamba-1.5-large-398b",
    "internvl2-76b",
)


def _modname(arch: str) -> str:
    return arch.replace("-", "_").replace(".", "_")


def get_config(arch: str) -> ModelConfig:
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; known: {ARCHS}")
    return import_module(f".{_modname(arch)}", __package__).CONFIG


__all__ = ["ARCHS", "SHAPES", "LayerSpec", "ModelConfig", "ShapeSpec",
           "get_config", "shape_applicable"]
