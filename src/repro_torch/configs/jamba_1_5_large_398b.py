"""Jamba-1.5-Large 398B — 72L hybrid: 1 attn per 8 layers (1:7), MoE 16e top-2
every other layer. [arXiv:2403.19887; hf]

Mamba layers use our Mamba2/SSD mixer (DESIGN.md §3 notes the mamba1->SSD
substitution; the assignment's ssm entry pins SSD as the house SSM).
"""
from .base import LayerSpec, ModelConfig

# 8-layer repeating unit: attention at position 4, mamba elsewhere;
# MoE replaces the MLP on every other layer (odd positions).
_PATTERN = tuple(
    LayerSpec("attn" if i == 4 else "mamba", "moe" if i % 2 == 1 else "dense")
    for i in range(8)
)

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b", family="hybrid",
    num_layers=72, d_model=8192, num_heads=64, num_kv_heads=8, head_dim=128,
    d_ff=24576, moe_d_ff=24576, vocab_size=65536,
    pattern=_PATTERN,
    num_experts=16, top_k=2,
    ssm_state=128, ssm_head_dim=64, ssm_expand=2, ssm_groups=1,
    mlp_act="swiglu", rope_theta=1e4,
)
