"""Training: LoRA / full-parameter SFT and GRPO (port of video_r2_tpu/train).

The exports keep the JAX package's names. The port's `TrainState` (what
trains, its optimizer and the step) stands for the JAX package's
TrainState, LoRATrainState and GRPOTrainState, and its GroupedAdamW
(train/optim.py) for make_optimizer's optax chain.
"""

from .grpo import (
    GRPOConfig,
    combine_rewards,
    completion_mask_from_ids,
    compute_advantages,
    grpo_loss,
    make_grpo_step,
    per_token_logps,
)
from .grpo_runner import GRPORunner
from .lora import (
    LoRAConfig,
    attach_lora,
    init_lora,
    init_lora_for_quantized,
    make_lora_grpo_step,
    merge_lora,
)
from .optim import OptimConfig
from .sft import (
    SFTConfig,
    TrainState,
    init_train_state,
    make_lora_sft_step,
    make_sft_step,
    sft_loss,
)

__all__ = [
    "LoRAConfig", "attach_lora", "init_lora",
    "init_lora_for_quantized", "make_lora_grpo_step", "make_lora_sft_step",
    "merge_lora",
    "GRPOConfig", "combine_rewards",
    "completion_mask_from_ids", "compute_advantages", "grpo_loss",
    "make_grpo_step", "per_token_logps", "GRPORunner",
    "OptimConfig",
    "SFTConfig", "TrainState", "init_train_state", "make_sft_step", "sft_loss",
]
