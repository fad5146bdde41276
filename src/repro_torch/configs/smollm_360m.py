"""SmolLM-360M — 32L, d960, 15H GQA(kv=5), llama-arch small.

[hf:HuggingFaceTB/SmolLM-360M; hf]
"""
from .base import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="smollm-360m", family="dense",
    num_layers=32, d_model=960, num_heads=15, num_kv_heads=5, head_dim=64,
    d_ff=2560, vocab_size=49152,
    pattern=(LayerSpec("attn", "dense"),),
    mlp_act="swiglu", rope_theta=1e4,
)
