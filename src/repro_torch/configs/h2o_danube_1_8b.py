"""h2o-danube-1.8B — 24L, d2560, 32H GQA(kv=8), sliding-window attention.

[arXiv:2401.16818; hf] SWA window 4096 => the only dense arch eligible for
the long_500k cell (cache is window-sized).
"""
from .base import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="h2o-danube-1.8b", family="dense",
    num_layers=24, d_model=2560, num_heads=32, num_kv_heads=8, head_dim=80,
    d_ff=6912, vocab_size=32000, window=4096,
    pattern=(LayerSpec("attn", "dense"),),
    mlp_act="swiglu", rope_theta=1e4,
)
