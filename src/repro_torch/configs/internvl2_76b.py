"""InternVL2-76B backbone (InternLM2/llama-arch 80L LM) + stub ViT frontend.

[arXiv:2404.16821; unverified] input_specs() provides (B, 256, d) patch
embeddings prepended to token embeddings.
"""
from .base import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="internvl2-76b", family="vlm",
    num_layers=80, d_model=8192, num_heads=64, num_kv_heads=8, head_dim=128,
    d_ff=28672, vocab_size=128256, num_patches=256,
    pattern=(LayerSpec("attn", "dense"),),
    mlp_act="swiglu", rope_theta=5e5,
)
