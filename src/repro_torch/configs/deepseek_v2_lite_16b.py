"""DeepSeek-V2-Lite 16B — 27L, d2048, MLA kv_lora=512, 64 routed + 2 shared, top-6.

[arXiv:2405.04434; hf-verified] Assignment says "64e top-6" and "160 routed";
we implement 64 routed + 2 shared (the primary spec; see DESIGN.md §3).
Layer 0 uses a dense MLP (d_ff=10944), layers 1..26 are MoE.
"""
from .base import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b", family="moe",
    num_layers=27, d_model=2048, num_heads=16, num_kv_heads=16, head_dim=128,
    d_ff=10944, moe_d_ff=1408, vocab_size=102400,
    pattern=(LayerSpec("mla", "moe"),), first_layer_dense=True,
    num_experts=64, num_shared_experts=2, top_k=6,
    kv_lora_rank=512, qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128,
    mlp_act="swiglu", rope_theta=1e4,
)
