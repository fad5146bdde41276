"""Qwen3-8B — 36L, d4096, 32H GQA(kv=8), qk_norm. [hf:Qwen/Qwen3-8B; hf]"""
from .base import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="qwen3-8b", family="dense",
    num_layers=36, d_model=4096, num_heads=32, num_kv_heads=8, head_dim=128,
    d_ff=12288, vocab_size=151936,
    pattern=(LayerSpec("attn", "dense"),),
    mlp_act="swiglu", qk_norm=True, rope_theta=1e6,
)
