"""SFT: masked next-token cross-entropy over the model, one optimizer step
at a time.

Port of ``video_r2_tpu/train/sft.py`` (single device): the loss embeds the
tokens (video features merged in through the ViT), runs the decoder
without a cache and with per-layer recompute, and takes the chunked fused
CE (ops/fused_ce.py) of shift-by-one labels. attn_impl "flash" runs the
decoder's attention through ops/flash.py (kv lengths from the attention
mask, causal), whose backward is the flash backward kernels on the card;
"xla" names the plain masked path. The ViT picks its kernels by
``vit_attn_impl`` ("auto": the kernels on a CUDA device).

A step zeroes the gradients of what the state trains, back-propagates the
loss, reports the global norm of those gradients (before clipping, as the
JAX step reports ``optax.global_norm(grads)``) and takes one optimizer step.
"""

from __future__ import annotations

from contextlib import contextmanager, nullcontext
from dataclasses import dataclass

import torch

from ..models.decoder import MoEMLP, causal_mask_bias
from ..models.model import Qwen25VL, embed_inputs, lm_head_weight
from ..models.mrope import mrope_cos_sin
from ..models.vision import VisionLayout
from ..ops.fused_ce import fused_linear_cross_entropy
from .optim import GroupedAdamW, OptimConfig, global_norm


@dataclass(frozen=True)
class SFTConfig:
    ce_chunk_size: int = 1024
    attn_impl: str = "xla"
    gradient_checkpointing: bool = True
    vit_attn_impl: str = "auto"       # ViT attention in the embed path


@dataclass
class TrainState:
    """What trains ({name: parameter}: the adapters for LoRA, the model's
    parameters for full-parameter SFT; the JAX package's TrainState and
    LoRATrainState in one), its optimizer, and the step."""

    params: dict[str, torch.nn.Parameter]
    optimizer: GroupedAdamW
    step: int = 0


def init_train_state(params: dict[str, torch.nn.Parameter],
                     optim_cfg: OptimConfig) -> TrainState:
    return TrainState(params, GroupedAdamW(optim_cfg, params.items()), 0)


def sft_loss(model: Qwen25VL, batch: dict[str, torch.Tensor], scfg: SFTConfig,
             video_layout: VisionLayout | None = None) -> torch.Tensor:
    """batch (tensors on the model's device): input_ids [B, S], labels
    [B, S] (IGNORE_INDEX-masked), position_ids [3, B, S], attention_mask
    [B, S], optional video_patches. Returns the mean CE (fp32 scalar)."""
    cfg = model.cfg
    ids = batch["input_ids"].long()
    h = embed_inputs(model, ids, batch.get("video_patches"), video_layout,
                     scfg.vit_attn_impl)
    cos, sin = mrope_cos_sin(batch["position_ids"].long(), cfg, dtype=h.dtype)
    mask = batch.get("attention_mask")
    if scfg.attn_impl == "flash":
        bias = None
        kv_lengths = (mask.sum(-1).int() if mask is not None else
                      torch.full((ids.shape[0],), ids.shape[1], dtype=torch.int32,
                                 device=ids.device))
    else:
        bias = causal_mask_bias(ids.shape[1], mask, ids.device)
        kv_lengths = None
    hidden = model.model(h, cos, sin, bias, attn_impl=scfg.attn_impl,
                         kv_lengths=kv_lengths, causal=True,
                         remat=scfg.gradient_checkpointing)
    # predict token t + 1 from hidden t
    hs = hidden[:, :-1].reshape(-1, hidden.shape[-1])
    labels = batch["labels"][:, 1:].reshape(-1)
    return fused_linear_cross_entropy(hs, lm_head_weight(model), labels,
                                      scfg.ce_chunk_size)


@contextmanager
def _moe_einsum(model: Qwen25VL):
    """Every MoE block of the model through the grouped einsum inside the
    `with` (gmm_prefill off, restored after)."""
    moes = [m for m in model.modules() if isinstance(m, MoEMLP)]
    flags = [m.gmm_prefill for m in moes]
    for m in moes:
        m.gmm_prefill = False
    try:
        yield
    finally:
        for m, flag in zip(moes, flags):
            m.gmm_prefill = flag


def _make_step(model: Qwen25VL, scfg: SFTConfig, video_layout, moe_einsum: bool):
    def step(state: TrainState, batch: dict[str, torch.Tensor]):
        state.optimizer.zero_grad()
        # the backward recomputes layers (remat): the MoE path holds through it
        with _moe_einsum(model) if moe_einsum else nullcontext():
            loss = sft_loss(model, batch, scfg, video_layout)
            loss.backward()
        grad_norm = global_norm(p.grad for p in state.params.values()
                                if p.grad is not None)
        state.optimizer.step()
        state.step += 1
        return state, {"loss": loss.detach(), "grad_norm": grad_norm}

    return step


def make_sft_step(model: Qwen25VL, scfg: SFTConfig,
                  video_layout: VisionLayout | None = None):
    """step(state, batch) -> (state, {"loss", "grad_norm"}) for whatever
    `state.params` holds; the model's other parameters stay frozen. A MoE
    model trains through the grouped einsum, as the reference's full-parameter
    step does (video_r2_tpu/train/sft.py turns moe_gmm_prefill off): the
    step sets each MoE block's switch while it runs, and the model's config
    stays as it is."""
    return _make_step(model, scfg, video_layout, moe_einsum=True)


def make_lora_sft_step(model: Qwen25VL, scfg: SFTConfig,
                       video_layout: VisionLayout | None = None):
    """The SFT step where only the attached adapters train (the reference's
    shipped recipe: LoRA over a frozen base). The base's parameters never
    require gradients, so no base gradient is formed. MoE blocks keep the
    config's path, as the reference's LoRA step does: with moe_gmm_prefill
    the GMM backward forms dX and no expert weight gradient."""
    if not any(n.endswith(".lora_a") for n, _ in model.named_parameters()):
        raise ValueError("no adapters attached (train/lora.py::attach_lora)")
    trains = [n for n, p in model.named_parameters()
              if p.requires_grad and not n.endswith((".lora_a", ".lora_b"))]
    if trains:
        raise ValueError(f"base parameters require grad: {trains[:3]}...")
    return _make_step(model, scfg, video_layout, moe_einsum=False)
