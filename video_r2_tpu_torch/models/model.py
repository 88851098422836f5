"""Full Qwen2.5-VL model: ViT + embedding merge + M-RoPE decoder + LM head.

Port of ``video_r2_tpu/models/model.py`` for video inputs (image inputs come
with the image path of a later slice). Vision embeddings go into their
<|video_pad|> slots by a cumsum-gather, as in the JAX package. Text-only
configs (cfg.has_vision False: the Qwen3-MoE judge) build no vision tower.
"""

from __future__ import annotations

import torch
from torch import nn

from .config import ModelConfig
from .decoder import Decoder, causal_mask_bias
from .layers import Linear
from .mrope import mrope_cos_sin
from .quant import dequantize_kernel, dequantize_kernel_int4
from .vision import VisionLayout, VisionTower, vit_forward


class Qwen25VL(nn.Module):
    """Parameter tree mirrors the JAX package's (``visual``, ``model``,
    ``lm_head``; ``blocks`` / ``layers`` hold one module per layer)."""

    def __init__(self, cfg: ModelConfig, *, dtype, device):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.cfg = cfg
        self.visual = VisionTower(cfg.vision, **kw) if cfg.has_vision else None
        self.model = Decoder(cfg.text, **kw)
        if not cfg.text.tie_word_embeddings:
            self.lm_head = Linear(cfg.text.hidden_size, cfg.text.vocab_size,
                                  False, **kw)

    @property
    def device(self) -> torch.device:
        return self.model.norm.scale.device


def merge_vision_embeddings(input_ids: torch.Tensor, text_embeds: torch.Tensor,
                            vision_embeds: torch.Tensor, token_id: int) -> torch.Tensor:
    """Place vision embeddings [N, H] (batch-flattened scan order) into
    their pad-token slots of text_embeds [B, S, H]."""
    B, S, H = text_embeds.shape
    mask = (input_ids == token_id).reshape(-1)
    pos = torch.cumsum(mask.long(), dim=0) - 1
    pos = pos.clamp(0, vision_embeds.shape[0] - 1)
    gathered = vision_embeds[pos].reshape(B, S, H).to(text_embeds.dtype)
    return torch.where(mask.reshape(B, S, 1), gathered, text_embeds)


def validate_vision_tokens(input_ids, cfg: ModelConfig,
                           n_video_features: int = 0) -> None:
    """Host-side invariant: pad-token count must equal the feature count."""
    n_vid = int((torch.as_tensor(input_ids) == cfg.video_token_id).sum())
    if n_video_features and n_vid != n_video_features:
        raise ValueError(
            f"Video features and video tokens do not match: tokens {n_vid}, "
            f"features {n_video_features}")


def embed_inputs(model: Qwen25VL, input_ids: torch.Tensor,
                 video_patches: torch.Tensor | None = None,
                 video_layout: VisionLayout | None = None,
                 vit_attn_impl: str = "auto") -> torch.Tensor:
    """Token embeddings with video features merged into their pad slots.

    The training embed path too: when the tower has parameters that train
    (adapters, or an unfrozen tower) it runs under autograd with per-block
    recompute; otherwise it runs without autograd, as the JAX step never
    differentiates a tower that holds nothing it trains."""
    h = model.model.embed_tokens(input_ids)
    if video_patches is not None:
        if torch.is_grad_enabled() and any(p.requires_grad
                                           for p in model.visual.parameters()):
            vemb = vit_forward(model.visual, video_patches, video_layout,
                               vit_attn_impl, remat=True)
        else:
            with torch.no_grad():
                vemb = vit_forward(model.visual, video_patches, video_layout,
                                   vit_attn_impl)
        h = merge_vision_embeddings(input_ids, h, vemb, model.cfg.video_token_id)
    return h


def lm_head_weight(model: Qwen25VL) -> torch.Tensor:
    """Dense [H, V] head weight (dequantized to bf16 if the head is int8 or
    int4) for the chunked CE."""
    if model.cfg.text.tie_word_embeddings:
        return model.model.embed_tokens.embedding.T
    head = model.lm_head
    if head.kernel is not None:
        return head.kernel
    if head.kernel_q4 is not None:
        return dequantize_kernel_int4(
            {"kernel_q4": head.kernel_q4, "scale4": head.scale4},
            group_size=2 * head.kernel_q4.shape[0] // head.scale4.shape[0])
    return dequantize_kernel({"kernel_q": head.kernel_q, "scale": head.scale})


def lm_head(model: Qwen25VL, hidden: torch.Tensor,
            act_quant: str | None = None) -> torch.Tensor:
    if model.cfg.text.tie_word_embeddings:
        return hidden @ model.model.embed_tokens.embedding.T
    return model.lm_head(hidden, act_quant)


def forward(model: Qwen25VL, input_ids: torch.Tensor, position_ids: torch.Tensor,
            attention_mask: torch.Tensor | None = None,
            video_patches: torch.Tensor | None = None,
            video_layout: VisionLayout | None = None, attn_impl: str = "xla",
            return_hidden: bool = False) -> torch.Tensor:
    """Full forward without a cache: logits [B, S, V], or with return_hidden
    the final-normed hidden [B, S, H]. position_ids [3, B, S] from
    mrope.get_rope_index, attention_mask [B, S] 1 = valid (right padding).
    attn_impl: the decoder's attention, "xla" (plain, a causal + padding
    bias) or "flash" (the kernel, causal over each row's valid prefix)."""
    cfg = model.cfg
    device = model.device
    input_ids = torch.as_tensor(input_ids, device=device)
    validate_vision_tokens(
        input_ids, cfg,
        n_video_features=(video_layout.seq_len_real // cfg.vision.spatial_merge_unit
                          if video_layout is not None else 0))
    h = embed_inputs(model, input_ids, video_patches, video_layout)
    cos, sin = mrope_cos_sin(torch.as_tensor(position_ids, device=device), cfg,
                             dtype=h.dtype)
    mask = (torch.as_tensor(attention_mask, device=device)
            if attention_mask is not None else None)
    if attn_impl == "flash":
        # the flash kernel masks by causality and the valid prefix itself
        B, S = input_ids.shape
        lengths = (mask.sum(-1).int() if mask is not None
                   else torch.full((B,), S, dtype=torch.int32, device=device))
        h = model.model(h, cos, sin, None, attn_impl=attn_impl, kv_lengths=lengths,
                        causal=True)
    else:
        h = model.model(h, cos, sin, causal_mask_bias(input_ids.shape[1], mask, device))
    if return_hidden:
        return h
    return lm_head(model, h)
