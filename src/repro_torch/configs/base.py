"""Model/arch configuration dataclasses and the shape matrix (the port's copy).

Every assigned architecture is expressed as a ModelConfig built from a small
set of orthogonal features (mixer type, mlp type, MoE, MLA, SSD, enc-dec,
modality stub). Layer stacks are described by a repeating ``pattern`` of
LayerSpec entries so heterogeneous stacks (Jamba's 1:7 attn:mamba interleave)
scan cleanly.

``remat`` and ``remat_policy`` are the reference's: a differentiated
forward recomputes each layer unit in its backward (``models/remat.py``),
"full" keeping the unit's inputs only and "dots" also the outputs of its
products without batch dims. The JAX package's two other execution
switches (``attention_impl``, ``ssd_impl``) are not fields here: the port
picks the CUDA kernel or its plain version by the device a tensor lies on.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

__all__ = ["LayerSpec", "ModelConfig", "ShapeSpec", "SHAPES", "REMAT_POLICIES",
           "round_up", "shape_applicable"]

# jax.checkpoint's policies the reference names: None, and
# dots_with_no_batch_dims_saveable
REMAT_POLICIES = ("full", "dots")


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclass(frozen=True)
class LayerSpec:
    """One position in the repeating layer pattern."""

    mixer: str  # "attn" | "mla" | "mamba"
    mlp: str    # "dense" | "moe" | "none"


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 128
    pattern: Tuple[LayerSpec, ...] = (LayerSpec("attn", "dense"),)
    first_layer_dense: bool = False   # deepseek: layer 0 uses dense MLP
    # --- activations / norms ---
    mlp_act: str = "swiglu"           # swiglu | relu2 | gelu
    qk_norm: bool = False
    rope_theta: float = 1e6
    norm_eps: float = 1e-6
    # --- attention ---
    window: Optional[int] = None      # sliding-window attention
    # --- MoE ---
    num_experts: int = 0
    num_shared_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    capacity_factor: float = 1.25
    # --- MLA (DeepSeek) ---
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    # --- SSM (Mamba2 SSD) ---
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_groups: int = 1
    ssm_conv_width: int = 4
    ssd_chunk: int = 128
    # --- encoder-decoder (whisper) ---
    num_encoder_layers: int = 0
    encoder_seq: int = 0              # precomputed frame embeddings (stub frontend)
    # --- vlm ---
    num_patches: int = 0              # prepended patch embeddings (stub frontend)
    # --- numerics / rematerialization ---
    param_dtype: str = "bfloat16"
    activation_dtype: str = "bfloat16"
    remat: bool = True
    remat_policy: str = "full"    # full | dots (save matmul outputs)
    logical_vocab: int = 0            # unpadded vocab (0 = same as vocab_size)

    def __post_init__(self):
        if self.remat_policy not in REMAT_POLICIES:
            raise ValueError(f"remat_policy must be one of {REMAT_POLICIES}, "
                             f"got {self.remat_policy!r}")

    # ------------------------------------------------------------------
    @property
    def pattern_len(self) -> int:
        return len(self.pattern)

    @property
    def num_repeats(self) -> int:
        n = self.num_layers - (1 if self.first_layer_dense else 0)
        assert n % self.pattern_len == 0, (self.name, n, self.pattern_len)
        return n // self.pattern_len

    @property
    def ssm_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.ssm_inner // self.ssm_head_dim

    @property
    def padded_vocab(self) -> int:
        return round_up(self.vocab_size, 256)

    @property
    def is_encoder_decoder(self) -> bool:
        return self.num_encoder_layers > 0

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def tiny(self, repeats: int = 2) -> "ModelConfig":
        """Reduced same-family config for CPU smoke tests."""
        kw = dict(
            num_layers=repeats * self.pattern_len + (1 if self.first_layer_dense else 0),
            d_model=64, num_heads=4, num_kv_heads=2 if self.num_kv_heads > 1 else 1,
            head_dim=16, d_ff=128, vocab_size=512,
            param_dtype="float32", activation_dtype="float32",
            window=min(self.window, 32) if self.window else None,
        )
        if self.num_experts:
            kw.update(num_experts=4, top_k=min(self.top_k, 2), moe_d_ff=64,
                      num_shared_experts=min(self.num_shared_experts, 1))
        if self.kv_lora_rank:
            kw.update(kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=8,
                      v_head_dim=16)
        if self.ssm_state:
            kw.update(ssm_state=16, ssm_head_dim=8, ssd_chunk=16)
        if self.num_encoder_layers:
            kw.update(num_encoder_layers=repeats, encoder_seq=24)
        if self.num_patches:
            kw.update(num_patches=8)
        return self.replace(**kw)


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


def shape_applicable(cfg: ModelConfig, shape: ShapeSpec) -> Tuple[bool, str]:
    """(applies?, reason) — encodes the assignment's skip rules."""
    if shape.name == "long_500k":
        sub_quadratic = (cfg.family in ("ssm", "hybrid")) or (cfg.window is not None)
        if not sub_quadratic:
            return False, "pure full-attention arch: 500k decode needs sub-quadratic attention"
    return True, ""
