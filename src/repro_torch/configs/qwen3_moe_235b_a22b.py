"""Qwen3-MoE-235B-A22B — 94L, d4096, 64H GQA(kv=4), 128 experts top-8.

[hf:Qwen/Qwen3-30B-A3B family scaled per assignment; hf-verified tier]
"""
from .base import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b", family="moe",
    num_layers=94, d_model=4096, num_heads=64, num_kv_heads=4, head_dim=128,
    d_ff=1536, moe_d_ff=1536, vocab_size=151936,
    pattern=(LayerSpec("attn", "moe"),),
    num_experts=128, top_k=8, mlp_act="swiglu", qk_norm=True, rope_theta=1e6,
)
