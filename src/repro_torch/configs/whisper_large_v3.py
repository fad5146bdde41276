"""Whisper-large-v3 backbone — 32L enc + 32L dec, d1280, 20H, enc-dec.

[arXiv:2212.04356; unverified] Conv/mel frontend is a STUB: input_specs()
provides (B, 1500, d) precomputed frame embeddings.
"""
from .base import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="whisper-large-v3", family="audio",
    num_layers=32, num_encoder_layers=32, encoder_seq=1500,
    d_model=1280, num_heads=20, num_kv_heads=20, head_dim=64,
    d_ff=5120, vocab_size=51866,
    pattern=(LayerSpec("attn", "dense"),),
    mlp_act="gelu", rope_theta=1e4,
)
