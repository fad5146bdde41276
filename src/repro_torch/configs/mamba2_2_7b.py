"""Mamba2-2.7B — 64L, d2560, attn-free SSD, state=128. [arXiv:2405.21060]"""
from .base import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="mamba2-2.7b", family="ssm",
    num_layers=64, d_model=2560, num_heads=1, num_kv_heads=1, head_dim=64,
    d_ff=0, vocab_size=50280,
    pattern=(LayerSpec("mamba", "none"),),
    ssm_state=128, ssm_head_dim=64, ssm_expand=2, ssm_groups=1,
)
