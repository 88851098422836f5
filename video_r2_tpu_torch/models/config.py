"""Model configuration for the Qwen2.5-VL family and the Qwen3-MoE judge.

A copy of the fields of ``video_r2_tpu/models/config.py`` that the port
reads (that module's package ``__init__`` imports jax), the Qwen3 / MoE
fields and the judge preset included; the JAX config's training knobs
serve paths not ported yet. tests/test_torch_host.py holds every field here
equal to the original.
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass(frozen=True)
class VisionConfig:
    depth: int = 32
    hidden_size: int = 1280
    intermediate_size: int = 3420
    num_heads: int = 16
    in_channels: int = 3
    patch_size: int = 14
    spatial_merge_size: int = 2
    temporal_patch_size: int = 2
    tokens_per_second: float = 2.0
    window_size: int = 112
    fullatt_block_indexes: tuple[int, ...] = (7, 15, 23, 31)
    out_hidden_size: int = 3584
    rms_norm_eps: float = 1e-6
    rope_theta: float = 10000.0

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def patch_input_dim(self) -> int:
        return self.in_channels * self.temporal_patch_size * self.patch_size ** 2

    @property
    def spatial_merge_unit(self) -> int:
        return self.spatial_merge_size ** 2


@dataclass(frozen=True)
class TextConfig:
    vocab_size: int = 152064
    hidden_size: int = 3584
    intermediate_size: int = 18944
    num_hidden_layers: int = 28
    num_attention_heads: int = 28
    num_key_value_heads: int = 4
    rms_norm_eps: float = 1e-6
    rope_theta: float = 1_000_000.0
    mrope_section: tuple[int, int, int] = (16, 24, 24)
    tie_word_embeddings: bool = False
    # Qwen3 family: explicit head_dim, per-head q/k RMS norm, no q/k/v bias
    head_dim_override: int = 0
    qk_norm: bool = False
    attention_bias: bool = True
    # MoE: num_experts > 0 makes every layer's MLP a sparse MoE block
    # (models/moe.py); the capacity factor and group size serve the grouped
    # einsum (0.0 = full capacity, no drops)
    num_experts: int = 0
    num_experts_per_tok: int = 8
    moe_intermediate_size: int = 0
    norm_topk_prob: bool = True
    moe_capacity_factor: float = 0.0
    moe_group_size: int = 256
    # decode steps of at most 32 tokens read only the routed experts
    # (ops/moe_ragged.py); other steps take the sorted grouped matmul
    # (ops/moe_gmm.py): both exact, both through the grouped FFN kernel
    moe_ragged_decode: bool = False
    moe_gmm_prefill: bool = False

    @property
    def head_dim(self) -> int:
        if self.head_dim_override:
            return self.head_dim_override
        return self.hidden_size // self.num_attention_heads


@dataclass(frozen=True)
class ModelConfig:
    vision: VisionConfig = field(default_factory=VisionConfig)
    text: TextConfig = field(default_factory=TextConfig)
    # Special token ids (Qwen2.5-VL tokenizer).
    image_token_id: int = 151655
    video_token_id: int = 151656
    vision_start_token_id: int = 151652
    vision_end_token_id: int = 151653
    bos_token_id: int = 151643
    eos_token_id: int = 151645   # <|im_end|>
    pad_token_id: int = 151643
    dtype: str = "bfloat16"
    # text-only families (the judge role): no vision tower is built
    has_vision: bool = True


def qwen25vl_7b() -> ModelConfig:
    """Qwen/Qwen2.5-VL-7B-Instruct (the Video-R2 base model)."""
    return ModelConfig()


def qwen25vl_3b() -> ModelConfig:
    """Qwen/Qwen2.5-VL-3B-Instruct."""
    return ModelConfig(
        text=TextConfig(hidden_size=2048, intermediate_size=11008,
                        num_hidden_layers=36, num_attention_heads=16,
                        num_key_value_heads=2, vocab_size=151936,
                        tie_word_embeddings=True),
        vision=VisionConfig(out_hidden_size=2048),
    )


def qwen25vl_72b() -> ModelConfig:
    """Qwen/Qwen2.5-VL-72B-Instruct."""
    return ModelConfig(
        text=TextConfig(hidden_size=8192, intermediate_size=29568,
                        num_hidden_layers=80, num_attention_heads=64,
                        num_key_value_heads=8),
        vision=VisionConfig(out_hidden_size=8192),
    )


def qwen3_moe_30b_a3b() -> ModelConfig:
    """Qwen3-30B-A3B (MoE), the judge model served on one card: 48 layers,
    32 / 4 heads of 128, 128 experts of width 768, top 8, qk-norm, no
    attention bias, text only. Exact MoE (capacity 0) through the ragged
    decode and GMM prefill paths."""
    return ModelConfig(
        text=TextConfig(
            vocab_size=151936, hidden_size=2048, intermediate_size=6144,
            num_hidden_layers=48, num_attention_heads=32,
            num_key_value_heads=4, head_dim_override=128, qk_norm=True,
            attention_bias=False, num_experts=128, num_experts_per_tok=8,
            moe_intermediate_size=768, norm_topk_prob=True,
            moe_capacity_factor=0.0, moe_ragged_decode=True,
            moe_gmm_prefill=True,
            mrope_section=(22, 21, 21),  # text only: plain RoPE (equal positions)
            rope_theta=1_000_000.0,
        ),
        eos_token_id=151645, pad_token_id=151643, has_vision=False,
    )


def tiny_test_config(vocab_size: int = 512) -> ModelConfig:
    """Small config for CPU parity tests (dims aligned to head counts)."""
    return ModelConfig(
        vision=VisionConfig(
            depth=4, hidden_size=64, intermediate_size=128, num_heads=4,
            out_hidden_size=48, fullatt_block_indexes=(2,), window_size=112,
        ),
        text=TextConfig(
            vocab_size=vocab_size, hidden_size=48, intermediate_size=96,
            num_hidden_layers=3, num_attention_heads=4, num_key_value_heads=2,
            mrope_section=(2, 2, 2),  # sums to head_dim/2 = 6
            rope_theta=10000.0, tie_word_embeddings=False,
        ),
        image_token_id=500, video_token_id=501, vision_start_token_id=502,
        vision_end_token_id=503, bos_token_id=0, eos_token_id=1, pad_token_id=0,
        dtype="float32",
    )
