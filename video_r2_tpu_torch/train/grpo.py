"""GRPO: group rollouts -> rewards -> advantages -> PPO-clipped loss.

Port of ``video_r2_tpu/train/grpo.py`` (single device):

- `GRPOConfig` keeps every field and default of the JAX one;
  rollout_spec_decode speculates on both rollout routes (rejection
  sampling: the rollouts are sampled), and a mesh, which the port cannot
  run, raises NotImplementedError naming its ROADMAP item (Queue 1 #8).
- The host functions (`completion_mask_from_ids`, `combine_rewards`,
  `compute_advantages`) are numpy, the JAX package's code line for line
  (tests/test_torch_host.py holds their source equal).
- `per_token_logps` embeds the tokens (or merges precomputed ViT embeds),
  runs the decoder without a cache and with per-layer recompute, and takes
  the chunked token log-probs (ops/logprobs.py) of the completion's hidden
  rows. The ``[prompt_pad | completion]`` gap of the left-padded layout
  goes to "flash" as segment ids (valid 1, pads -1) over the full kv span,
  causal, and to "xla" as the causal + padding mask bias.
- `grpo_loss`: KL estimator exp(d) - d - 1, token or GMPO sequence-
  geometric ratio, PPO clip (eps_low, eps_high), the grpo / bnpo /
  dr_grpo / gmpo / mapo / mapo_bnpo aggregations and the clip-ratio
  metrics.
- `make_grpo_step` trains every parameter of `state.params` (MoE blocks
  through the grouped einsum, as make_sft_step); train/lora.py::
  make_lora_grpo_step trains the attached adapters only.
"""

from __future__ import annotations

from contextlib import nullcontext
from dataclasses import dataclass

import numpy as np
import torch

from ..models.decoder import causal_mask_bias
from ..models.model import Qwen25VL, embed_inputs, lm_head_weight, merge_vision_embeddings
from ..models.mrope import mrope_cos_sin
from ..models.vision import VisionLayout
from ..ops.logprobs import chunked_token_logprobs
from .optim import global_norm
from .sft import TrainState, _moe_einsum


@dataclass(frozen=True)
class GRPOConfig:
    """Every field and default of the JAX package's GRPOConfig (GRPOArguments
    + TRL GRPOConfig parity)."""

    num_generations: int = 8
    beta: float = 0.04
    epsilon_low: float = 0.2
    epsilon_high: float = 0.2
    loss_type: str = "grpo"        # grpo | bnpo | dr_grpo | gmpo | mapo | mapo_bnpo
    scale_rewards: bool = True
    mask_truncated_completions: bool = False
    num_iterations: int = 1        # mu: optimizer steps per generation batch
    temperature: float = 1.0
    top_p: float = 1.0
    top_k: int = 50
    max_completion_length: int = 256
    max_prompt_length: int = 512
    reward_weights: tuple[float, ...] | None = None
    positive_reinforcement: str = ""   # comma-joined reward names gated on accuracy
    length_reinforcement_buffer: int = 0
    buffer_seconds: float = 2.0
    similarity_threshold: float = 0.75
    logp_chunk_size: int = 1024
    pp_microbatches: int = 0       # GPipe microbatches when the mesh has pp>1
                                   # (no mesh in the port: ROADMAP Queue 1 #8)
    # ViT attention in the loss's embed path (mirrors SFTConfig.vit_attn_
    # impl): "auto" = the window / flash kernels on a CUDA device
    vit_attn_impl: str = "auto"
    # rollout infrastructure (TRL's use_vllm analog): "batch" = static batch
    # generate; "paged" = continuous batching over the paged KV pool, so
    # rollouts that hit EOS early free their slot for the next request
    rollout_backend: str = "batch"
    # paged backend: decode tokens per dispatch (multi-step window) —
    # rollouts are throughput-bound, so window freely
    rollout_decode_steps: int = 8
    # "int8": int8 page pool for rollouts (half the KV bytes per token ->
    # ~2x pool capacity; scales applied to both attention products)
    rollout_kv_quant: str | None = None
    # K > 0: speculative SAMPLING for rollouts (batch AND paged backends) — n-gram
    # prompt-lookup drafts verified by rejection sampling (exact target
    # distribution, engine/spec_decode.py). Rollout completions quote the
    # prompt's subtitles/options/format strings, the drafting workload
    rollout_spec_decode: int = 0


# ---------------------------------------------------------------------------
# Host-side: completion masking, rewards -> advantages
# ---------------------------------------------------------------------------

def completion_mask_from_ids(completion_ids: np.ndarray, eos_token_id: int,
                             mask_truncated: bool = False) -> np.ndarray:
    """Mask everything after the first EOS (inclusive); optionally zero
    truncated (no-EOS) completions. Parity: grpo_trainer.py:793-803."""
    is_eos = completion_ids == eos_token_id
    B, L = completion_ids.shape
    eos_idx = np.full((B,), L, np.int64)
    any_eos = is_eos.any(axis=1)
    eos_idx[any_eos] = is_eos.argmax(axis=1)[any_eos]
    mask = (np.arange(L)[None, :] <= eos_idx[:, None]).astype(np.int32)
    if mask_truncated:
        mask = mask * any_eos[:, None].astype(np.int32)
    return mask


def combine_rewards(
    rewards_per_func: np.ndarray,      # [B*G, F] (NaN = reward abstained)
    reward_func_names: list[str],
    cfg: GRPOConfig,
) -> np.ndarray:
    """Positive-reinforcement gating + weighted nansum -> total rewards [B*G].
    Parity: grpo_trainer.py:909-920."""
    r = rewards_per_func.astype(np.float64).copy()
    if cfg.positive_reinforcement:
        gated = [x.strip() for x in cfg.positive_reinforcement.split(",") if x.strip()]
        acc_idx = reward_func_names.index("accuracy_reward")
        ok = r[:, acc_idx] > 0.1
        for j, name in enumerate(reward_func_names):
            if name in gated and name != "accuracy_reward":
                r[:, j] = r[:, j] * ok
    w = (np.asarray(cfg.reward_weights, np.float64)
         if cfg.reward_weights is not None else np.ones(r.shape[1]))
    return np.nansum(r * w[None, :], axis=1)


def compute_advantages(
    rewards: np.ndarray,               # [B*G] combined
    rewards_per_func: np.ndarray,      # [B*G, F] (for MAPO success ratio)
    reward_func_names: list[str],
    cfg: GRPOConfig,
) -> np.ndarray:
    """Group-normalized advantages; MAPO mixed z/percent-deviation variant.
    Parity: grpo_trainer.py:922-974."""
    G = cfg.num_generations
    rg = rewards.reshape(-1, G)
    if cfg.loss_type in ("mapo", "mapo_bnpo"):
        mu = rg.mean(axis=1, keepdims=True)
        sigma = rg.std(axis=1, keepdims=True)          # ddof=0 (unbiased=False)
        eps = np.finfo(rg.dtype).eps
        if "accuracy_reward" in reward_func_names:
            acc = rewards_per_func[:, reward_func_names.index("accuracy_reward")]
            successes = (acc.reshape(-1, G) >= 0.5).sum(axis=1, keepdims=True)
        else:
            successes = (rg >= mu).sum(axis=1, keepdims=True)
        p = successes / G
        lam = np.clip(1.0 - 4.0 * p * (1.0 - p), 0.0, 1.0)
        z = (rg - mu) / (sigma + eps)
        apd = (rg - mu) / (mu + eps)
        return ((1.0 - lam) * z + lam * apd).reshape(-1)
    mean = rg.mean(axis=1, keepdims=True)
    adv = (rg - mean).reshape(-1)
    if cfg.scale_rewards:
        std = rg.std(axis=1, ddof=1, keepdims=True)    # torch.std default ddof=1
        adv = adv / (np.repeat(std, G, axis=1).reshape(-1) + 1e-4)
    return adv


# ---------------------------------------------------------------------------
# Device-side: per-token logps and the GRPO loss
# ---------------------------------------------------------------------------

def per_token_logps(
    model: Qwen25VL, input_ids, position_ids, attention_mask,
    completion_len: int, temperature: float, chunk_size: int = 1024,
    video_patches=None, video_layout: VisionLayout | None = None,
    video_embeds=None, attn_impl: str = "xla", vit_attn_impl: str = "auto",
) -> torch.Tensor:
    """log p(token) for the last `completion_len` tokens: [B, completion_len]
    fp32. Tensors on the model's device: input_ids [B, S], position_ids
    [3, B, S], attention_mask [B, S]. `video_embeds` [N, H] short-circuits
    the ViT with precomputed merged embeddings (rollouts and loss share one
    vision pass per prompt)."""
    if attn_impl not in ("xla", "flash"):
        raise ValueError(f"per_token_logps: attn_impl {attn_impl!r} (the sequence-"
                         f"parallel 'sp' path waits for ROADMAP Queue 1 #8)")
    ids = input_ids.long()
    if video_embeds is not None:
        h = model.model.embed_tokens(ids)
        h = merge_vision_embeddings(ids, h, video_embeds, model.cfg.video_token_id)
    else:
        h = embed_inputs(model, ids, video_patches, video_layout, vit_attn_impl)
    cos, sin = mrope_cos_sin(position_ids.long(), model.cfg, dtype=h.dtype)
    B, S = ids.shape
    if attn_impl == "flash":
        # the mid-sequence gap as segment ids: valid tokens 1, pads -1
        seg = torch.where(attention_mask == 1, 1, -1).int()
        full = torch.full((B,), S, dtype=torch.int32, device=ids.device)
        hidden = model.model(h, cos, sin, None, attn_impl="flash", kv_lengths=full,
                             causal=True, remat=True, segment_ids=seg)
    else:
        bias = causal_mask_bias(S, attention_mask, ids.device)
        hidden = model.model(h, cos, sin, bias, attn_impl="xla", remat=True)
    H = hidden.shape[-1]
    # hidden[t] predicts token[t + 1]; the completion is the last C ids
    hs = hidden[:, S - completion_len - 1: S - 1].reshape(-1, H)
    toks = ids[:, S - completion_len:].reshape(-1)
    lp = chunked_token_logprobs(hs, lm_head_weight(model), toks, temperature, chunk_size)
    return lp.reshape(B, completion_len)


def grpo_loss(model: Qwen25VL, gcfg: GRPOConfig, batch: dict,
              video_layout: VisionLayout | None = None,
              attn_impl: str = "xla") -> tuple[torch.Tensor, dict]:
    """batch keys (tensors on the model's device): input_ids [B, P+C]
    (prompt + completion), position_ids, attention_mask, completion_mask
    [B, C], advantages [B], old_per_token_logps [B, C] | None,
    ref_per_token_logps [B, C] | None, optional video_patches or
    video_embeds. Returns (loss, metrics), fp32 scalars."""
    C = batch["completion_mask"].shape[1]
    lp = per_token_logps(
        model, batch["input_ids"], batch["position_ids"], batch["attention_mask"], C,
        gcfg.temperature, gcfg.logp_chunk_size, batch.get("video_patches"),
        video_layout, batch.get("video_embeds"), attn_impl, gcfg.vit_attn_impl)

    cmask = batch["completion_mask"].float()
    adv = batch["advantages"].float()
    old_lp = batch.get("old_per_token_logps")
    old_lp = lp.detach() if old_lp is None else old_lp

    if gcfg.loss_type == "gmpo":
        delta = lp - old_lp
        tok_counts = torch.clamp(cmask.sum(-1), min=1.0)
        seq_log_ratio = (delta * cmask).sum(-1) / tok_counts
        coef_1 = torch.exp(seq_log_ratio)[:, None] * torch.ones_like(lp)
    else:
        coef_1 = torch.exp(lp - old_lp)
    coef_2 = torch.clamp(coef_1, 1 - gcfg.epsilon_low, 1 + gcfg.epsilon_high)
    pt_loss = -torch.minimum(coef_1 * adv[:, None], coef_2 * adv[:, None])

    metrics = {}
    if gcfg.beta != 0.0:
        ref_lp = batch["ref_per_token_logps"]
        kl = torch.exp(ref_lp - lp) - (ref_lp - lp) - 1
        pt_loss = pt_loss + gcfg.beta * kl
        metrics["kl"] = (kl * cmask).sum() / torch.clamp(cmask.sum(), min=1.0)

    if gcfg.loss_type in ("grpo", "gmpo", "mapo"):
        loss = ((pt_loss * cmask).sum(-1) / torch.clamp(cmask.sum(-1), min=1.0)).mean()
    elif gcfg.loss_type in ("bnpo", "mapo_bnpo"):
        loss = (pt_loss * cmask).sum() / torch.clamp(cmask.sum(), min=1.0)
    elif gcfg.loss_type == "dr_grpo":
        loss = (pt_loss * cmask).sum() / (pt_loss.shape[0] * gcfg.max_completion_length)
    else:
        raise ValueError(f"Unknown loss type: {gcfg.loss_type}")

    low = (coef_1 < 1 - gcfg.epsilon_low) & (adv[:, None] < 0)
    high = (coef_1 > 1 + gcfg.epsilon_high) & (adv[:, None] > 0)
    tot = torch.clamp(cmask.sum(), min=1.0)
    metrics["clip_ratio/low"] = (low * cmask).sum() / tot
    metrics["clip_ratio/high"] = (high * cmask).sum() / tot
    metrics["clip_ratio/region"] = ((low | high) * cmask).sum() / tot
    return loss, metrics


def _make_grpo_step(model: Qwen25VL, gcfg: GRPOConfig, video_layout, attn_impl: str,
                    moe_einsum: bool):
    def step(state: TrainState, batch: dict):
        state.optimizer.zero_grad()
        # the backward recomputes layers (remat): the MoE path holds through it
        with _moe_einsum(model) if moe_einsum else nullcontext():
            loss, metrics = grpo_loss(model, gcfg, batch, video_layout, attn_impl)
            loss.backward()
        grad_norm = global_norm(p.grad for p in state.params.values()
                                if p.grad is not None)
        state.optimizer.step()
        state.step += 1
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics.update(loss=loss.detach(), grad_norm=grad_norm)
        return state, metrics

    return step


def make_grpo_step(model: Qwen25VL, gcfg: GRPOConfig,
                   video_layout: VisionLayout | None = None, attn_impl: str = "xla",
                   mesh=None):
    """step(state, batch) -> (state, metrics with "loss" and "grad_norm") for
    whatever `state.params` holds (full-parameter GRPO: the model's
    parameters). MoE blocks train through the grouped einsum while the step
    runs, as the reference's make_grpo_step turns moe_gmm_prefill off."""
    if mesh is not None:
        raise NotImplementedError("a sharded GRPO step waits for the parallelism "
                                  "port (ROADMAP Queue 1 #8)")
    return _make_grpo_step(model, gcfg, video_layout, attn_impl, moe_einsum=True)
