"""Nemotron-4-340B — 96L, d18432, 96H GQA(kv=8), squared-ReLU MLP.

[arXiv:2402.16819; unverified tier]
"""
from .base import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-340b", family="dense",
    num_layers=96, d_model=18432, num_heads=96, num_kv_heads=8, head_dim=192,
    d_ff=73728, vocab_size=256000,
    pattern=(LayerSpec("attn", "dense"),),
    mlp_act="relu2", rope_theta=1e4,
)
