"""GRPO runner: host orchestration of one generation -> score -> train cycle.

Port of ``video_r2_tpu/train/grpo_runner.py``:

  sample B prompts -> the ViT once per prompt -> repeat G x
  -> rollouts on the policy (batch `generate` or the paged engine)
  -> EOS masking -> reward functions (host python; the judge over HTTP)
  -> group advantages -> ref / old logps (no grad) -> mu train steps on
  the buffered batch.

The runner works on the ``nn.Module`` itself, where the JAX runner swaps
parameter trees: LoRA adapters are attached to the module in place and a
full-parameter step updates its parameters in place, so the rollouts of
every cycle see the current weights with no ``params_from_state``. The
reference policy is `ref_model`: the policy module itself means its base
with the adapters removed for the pass (train/lora.py::adapters_disabled,
LoRA-GRPO, as JAX's ``ref_params = base``); any other module is a frozen
copy (full-parameter GRPO, as JAX's copied ``ref_params``).

The paged rollout engine is reused across cycles, as in the JAX runner,
but it is built with ``prefix_cache=False``. The engine's automatic prefix
cache keys pages by token hashes alone, and the weights change at every
cycle: after an optimizer step a prompt whose first full page precedes its
first vision token would reuse KV computed under the old weights, and the
rollouts would no longer sample the current policy (a fault of the JAX
runner, which keeps the cache across cycles). The G rollouts of a prompt
share its pages through `fork`, which needs no cache.

Not ported: image prompts (ROADMAP Queue 1, image inputs), a mesh (Queue 1 #8).
"""

from __future__ import annotations

import logging
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Any, Callable

import numpy as np
import torch

from ..engine.chat import expand_vision_placeholders, pack_prompts, render_messages
from ..engine.generate import generate
from ..engine.sampling import SamplingParams
from ..models.mrope import get_rope_index
from ..models.vision import plan_vision_layout, vit_forward
from ..rewards.embedding import embedder_tag as _embedder_tag
from ..utils.profiling import PhaseTimer, profiling_phase
from ..video.api import fetch_video
from .grpo import (
    GRPOConfig,
    combine_rewards,
    completion_mask_from_ids,
    compute_advantages,
    per_token_logps,
)
from .lora import adapters_disabled


@dataclass
class PreparedPrompt:
    messages: list[dict]
    input_ids: np.ndarray            # [S] unpadded
    video_embeds: Any | None         # [N, H] on the model's device (merged ViT out)
    video_grid_thw: list[tuple[int, int, int]]
    second_per_grid_ts: list[float]
    sample: dict                     # original dataset record fields


class GRPORunner:
    def __init__(self, model, gcfg: GRPOConfig, tokenizer,
                 reward_funcs: list[Callable], reward_func_names: list[str],
                 step_fn, ref_model=None, judge=None, embedder=None,
                 attn_impl: str = "xla", seed: int = 0, mesh=None,
                 metrics_logger=None):
        """attn_impl: the rollouts' prefill and the ref / old logps ("flash",
        "xla", or "auto": flash on a CUDA device). The JAX runner's
        video_cfg, act_quant and kv_quant have no caller and are not kept:
        prompts go through video/api.py::fetch_video's defaults, rollouts
        in the weights' precision."""
        if mesh is not None:
            raise NotImplementedError("sharded GRPO rollouts wait for the parallelism "
                                      "port (ROADMAP Queue 1 #8)")
        self.model = model
        self.cfg = model.cfg
        self.ref_model = ref_model
        self.gcfg = gcfg
        self.tok = tokenizer
        self.reward_funcs = reward_funcs
        self.reward_func_names = reward_func_names
        self.step_fn = step_fn
        self.judge = judge
        self.embedder = embedder
        if attn_impl == "auto":
            attn_impl = "flash" if model.device.type == "cuda" else "xla"
        self.attn_impl = attn_impl
        self._seed = seed
        self.timer = PhaseTimer()
        self.metrics_logger = metrics_logger
        self._rollout_eng = None   # lazy PagedContinuousEngine ("paged" backend)

    # ------------------------------------------------------------------
    def prepare_prompt(self, sample: dict) -> PreparedPrompt:
        """Render messages, run the ViT once (no grad), tokenize. The embeds
        are formed under torch.no_grad, not inference_mode: they enter the
        loss's autograd graph as constants, and an inference tensor cannot
        be saved for backward."""
        messages = sample["prompt"]
        text = render_messages(messages, add_generation_prompt=True,
                               default_system=None)
        feats = []
        for m in messages:
            if isinstance(m.get("content"), list):
                for ele in m["content"]:
                    if ele.get("type") == "video" or "video" in ele:
                        feats.append(fetch_video(ele))
                    elif ele.get("type") == "image" or "image" in ele:
                        raise NotImplementedError(
                            "image prompts into the model are not ported yet "
                            "(ROADMAP Queue 1, image inputs)")
        embeds = None
        grids = [f.grid_thw for f in feats]
        spgs = [f.second_per_grid_t for f in feats]
        if feats:
            patches = np.concatenate([f.patches for f in feats])
            layout = plan_vision_layout(grids, self.cfg.vision)
            with torch.no_grad():
                embeds = vit_forward(self.model.visual, torch.as_tensor(patches), layout)
            text = expand_vision_placeholders(
                text, [f.patches.shape[0] // 4 for f in feats], [])
        ids = np.asarray(self.tok.encode(text), np.int32)
        if ids.shape[0] > self.gcfg.max_prompt_length:
            if feats:
                # left truncation would cut vision tokens, and their features
                # would then merge into the wrong slots
                raise ValueError(f"multimodal prompt of {ids.shape[0]} tokens exceeds "
                                 f"max_prompt_length {self.gcfg.max_prompt_length}")
            ids = ids[-self.gcfg.max_prompt_length:]  # left truncation (TRL parity)
        return PreparedPrompt(messages, ids, embeds, grids, spgs, sample)

    def _t(self, x, dtype=None) -> torch.Tensor:
        return torch.as_tensor(x, dtype=dtype, device=self.model.device)

    def _sync(self) -> None:
        """End a timed phase with the device's work in it."""
        if self.model.device.type == "cuda":
            torch.cuda.synchronize(self.model.device)

    @contextmanager
    def _ref_policy(self):
        """The reference policy's module for a no-grad pass."""
        if self.ref_model is None:
            raise ValueError("beta != 0 requires a reference policy (ref_model)")
        if self.ref_model is self.model:
            with adapters_disabled(self.model):
                yield self.model
        else:
            yield self.ref_model

    def rollout_and_score(self, samples: list[dict]):
        """One generation batch: returns (batch of tensors on the model's
        device, metrics dict)."""
        G = self.gcfg.num_generations
        cfg = self.cfg
        prepared = [self.prepare_prompt(s) for s in samples]

        # repeat each prompt G times, consecutive (RepeatSampler layout)
        token_lists = [list(p.input_ids) for p in prepared for _ in range(G)]
        packed = pack_prompts(token_lists, pad_id=cfg.pad_token_id)
        B = packed.input_ids.shape[0]

        vid_grids = [g for p in prepared for _ in range(G) for g in p.video_grid_thw]
        spg = [s for p in prepared for _ in range(G) for s in p.second_per_grid_ts]
        mask = (np.arange(packed.input_ids.shape[1])[None, :]
                < packed.lengths[:, None]).astype(np.int64)
        pos, deltas = get_rope_index(
            packed.input_ids, cfg,
            video_grid_thw=np.asarray(vid_grids) if vid_grids else None,
            second_per_grid_ts=np.asarray(spg) if spg else None,
            attention_mask=mask)

        embeds = None
        if any(p.video_embeds is not None for p in prepared):
            embeds = torch.cat([p.video_embeds for p in prepared for _ in range(G)
                                if p.video_embeds is not None])

        sp = SamplingParams(
            do_sample=True, temperature=self.gcfg.temperature,
            top_p=self.gcfg.top_p, top_k=self.gcfg.top_k,
            max_new_tokens=self.gcfg.max_completion_length,
            eos_token_ids=(cfg.eos_token_id,),
            pad_token_id=cfg.pad_token_id)
        self._seed += 1
        with profiling_phase(self.timer, "rollout_generate"):
            if self.gcfg.rollout_backend == "paged":
                completion_ids, gen_lengths = self._rollout_continuous(
                    token_lists, prepared, G, sp)
            else:
                res = generate(self.model, packed.input_ids, packed.lengths, sp,
                               position_ids=pos, rope_deltas=deltas[:, 0],
                               vision_embeds=embeds,
                               vision_token_id=cfg.video_token_id, seed=self._seed,
                               attn_impl=self.attn_impl,
                               spec_decode=self.gcfg.rollout_spec_decode)
                completion_ids, gen_lengths = res.sequences, res.lengths

        cmask = completion_mask_from_ids(
            completion_ids, cfg.eos_token_id, self.gcfg.mask_truncated_completions)
        completions_text = [
            self.tok.decode(completion_ids[b][: gen_lengths[b]], skip_special_tokens=True)
            for b in range(B)]
        completions = [[{"role": "assistant", "content": t}] for t in completions_text]

        # rewards (host)
        reward_kwargs = {
            "prompts": [p.messages for p in prepared for _ in range(G)],
            "assistant": [{"content": p.sample.get("assistant", "")}
                          for p in prepared for _ in range(G)],
            "temporal_grounding": [p.sample.get("temporal_grounding", {})
                                   for p in prepared for _ in range(G)],
            "temporal_captions": [p.sample.get("temporal_captions", {})
                                  for p in prepared for _ in range(G)],
            "judge": self.judge,
            "embedder": self.embedder,
            "buffer_seconds": self.gcfg.buffer_seconds,
            "similarity_threshold": self.gcfg.similarity_threshold,
            "length_reinforcement_buffer": self.gcfg.length_reinforcement_buffer,
        }
        F = len(self.reward_funcs)
        rewards_per_func = np.full((B, F), np.nan)
        for i, (fn, name) in enumerate(zip(self.reward_funcs, self.reward_func_names)):
            with profiling_phase(self.timer, f"reward/{name}"):
                out = fn(completions=completions, **reward_kwargs)
            rewards_per_func[:, i] = [np.nan if r is None else r for r in out]

        # all-NaN reward warning: a row no reward function scored contributes
        # 0 via nansum; surface it loudly
        all_nan = np.isnan(rewards_per_func).all(axis=1)
        if all_nan.any():
            logging.getLogger(__name__).warning(
                "All reward functions returned None for %d/%d completions "
                "(rows %s) — they contribute zero reward",
                int(all_nan.sum()), len(all_nan), np.nonzero(all_nan)[0][:8].tolist())

        rewards = combine_rewards(rewards_per_func, self.reward_func_names, self.gcfg)
        advantages = compute_advantages(rewards, rewards_per_func,
                                        self.reward_func_names, self.gcfg)

        # Loss layout: LEFT-padded prompt + completion (TRL parity). The
        # engine right-pads for generation, but the loss reads the hidden at
        # column P-1 to predict the first completion token; left padding
        # makes [.. pad | prompt | completion] contiguous for every row.
        P = packed.input_ids.shape[1]
        C = completion_ids.shape[1]
        left_ids = np.full_like(packed.input_ids, cfg.pad_token_id)
        left_mask = np.zeros((B, P), np.int32)
        for b in range(B):
            L = int(packed.lengths[b])
            left_ids[b, P - L:] = packed.input_ids[b, :L]
            left_mask[b, P - L:] = 1
        left_pos, left_deltas = get_rope_index(
            left_ids, cfg,
            video_grid_thw=np.asarray(vid_grids) if vid_grids else None,
            second_per_grid_ts=np.asarray(spg) if spg else None,
            attention_mask=left_mask)
        full_ids = np.concatenate([left_ids, completion_ids], axis=1)
        full_mask = np.concatenate([left_mask, cmask], axis=1)
        # completion positions: P + step + delta (delta accounts for padding)
        comp_pos = (P + np.arange(C)[None, :] + left_deltas)  # [B, C]
        full_pos = np.concatenate(
            [left_pos, np.broadcast_to(comp_pos[None], (3, B, C))], axis=2)

        batch = {
            "input_ids": self._t(full_ids.astype(np.int64)),
            "position_ids": self._t(full_pos.astype(np.int64)),
            "attention_mask": self._t(full_mask.astype(np.int32)),
            "completion_mask": self._t(cmask),
            "advantages": self._t(advantages, torch.float32),
        }
        if embeds is not None:
            batch["video_embeds"] = embeds

        # ref / old logps (no grad)
        if self.gcfg.beta != 0.0:
            with profiling_phase(self.timer, "ref_logps"), self._ref_policy() as ref:
                batch["ref_per_token_logps"] = self._logps(ref, batch, C)
                self._sync()
        if self.gcfg.num_iterations > 1:
            with profiling_phase(self.timer, "old_logps"):
                batch["old_per_token_logps"] = self._logps(self.model, batch, C)
                self._sync()

        metrics = {
            "reward_mean": float(np.mean(rewards)),
            "reward_std": float(np.std(rewards)),
            # provenance: TAR similarity via MiniLM vs the offline hashing
            # fallback; the two are NOT comparable (rewards/embedding.py)
            "embedder": _embedder_tag(self.embedder) if self.embedder else "none",
            "completion_len_mean": float(cmask.sum(1).mean()),
            "completion_len_min": float(cmask.sum(1).min()),
            "completion_len_max": float(cmask.sum(1).max()),
            "clipped_ratio": float(
                1 - (completion_ids == cfg.eos_token_id).any(1).mean()),
        }
        for i, name in enumerate(self.reward_func_names):
            metrics[f"rewards/{name}/mean"] = float(np.nanmean(rewards_per_func[:, i]))
            metrics[f"rewards/{name}/std"] = float(np.nanstd(rewards_per_func[:, i]))
        if self.metrics_logger is not None:
            self.metrics_logger.log_completions(
                int(self._seed),
                [str(p.messages) for p in prepared for _ in range(G)],
                completions_text,
                {name: list(rewards_per_func[:, i])
                 for i, name in enumerate(self.reward_func_names)})
        return batch, metrics

    # ------------------------------------------------------------------
    def _get_rollout_engine(self, max_prompt: int, num_requests: int):
        from ..engine.continuous import PagedContinuousEngine

        # decode-window margin: without it the multi-step window clamps
        # (w -> w/2 -> ...) as slots near max_len
        need = (max_prompt + self.gcfg.max_completion_length + 1
                + 2 * self.gcfg.rollout_decode_steps)
        page = 128
        need = -(-need // page) * page
        if self._rollout_eng is not None and self._rollout_eng.max_len >= need:
            return self._rollout_eng
        buckets, b = [], page
        while b < need:
            buckets.append(b)
            b *= 2
        buckets.append(need)
        self._rollout_eng = PagedContinuousEngine(
            self.model, num_slots=min(num_requests, 32), max_len=need,
            sp=SamplingParams(eos_token_ids=(self.cfg.eos_token_id,),
                              pad_token_id=self.cfg.pad_token_id),
            attn_impl=self.attn_impl, prompt_buckets=tuple(buckets),
            page_size=page, seed=self._seed, kv_quant=self.gcfg.rollout_kv_quant,
            prefix_cache=False, spec_decode=self.gcfg.rollout_spec_decode)
        return self._rollout_eng

    def _rollout_continuous(self, token_lists, prepared, G, sp):
        """Rollouts on the paged continuous engine: each of the B x G
        requests streams independently, and early-EOS rollouts free pages
        for the rest. Returns (completion_ids [B, C], lengths)."""
        B = len(token_lists)
        C = self.gcfg.max_completion_length
        eng = self._get_rollout_engine(max(len(t) for t in token_lists), B)
        out_tokens: list = [None] * B
        pending = list(range(B))[::-1]
        rid_to_b: dict[int, int] = {}
        while pending or eng.num_active:
            while pending:
                bi = pending[-1]
                p = prepared[bi // G]
                rid = eng.submit(
                    token_lists[bi], max_new_tokens=C, sp=sp,
                    vision_embeds=p.video_embeds,
                    video_grid_thw=p.video_grid_thw or None,
                    second_per_grid_ts=(p.second_per_grid_ts
                                        if p.video_grid_thw else None))
                if rid is None:
                    break
                pending.pop()
                rid_to_b[rid] = bi
                # the group's other rollouts share this prompt: FORK them off
                # the fresh prefill (shared pages + copy-on-write), one
                # prefill per prompt instead of per rollout
                sibs = [x for x in reversed(pending) if x // G == bi // G]
                if sibs:
                    for frid in eng.fork(rid, n=len(sibs)):
                        sb = sibs.pop(0)
                        pending.remove(sb)
                        rid_to_b[frid] = sb
            if eng.num_active:
                for rid, toks in eng.step(steps=self.gcfg.rollout_decode_steps):
                    out_tokens[rid_to_b[rid]] = toks
        completion_ids = np.full((B, C), self.cfg.pad_token_id, np.int64)
        lengths = np.zeros((B,), np.int64)
        for bi, toks in enumerate(out_tokens):
            completion_ids[bi, : len(toks)] = toks
            lengths[bi] = len(toks)
        return completion_ids, lengths

    def _logps(self, model, batch, C):
        with torch.no_grad():
            return per_token_logps(
                model, batch["input_ids"], batch["position_ids"],
                batch["attention_mask"], C, self.gcfg.temperature,
                self.gcfg.logp_chunk_size, video_embeds=batch.get("video_embeds"),
                attn_impl=self.attn_impl)

    # ------------------------------------------------------------------
    def train_cycle(self, state, samples: list[dict]):
        """One full GRPO cycle: rollout once, mu optimizer steps. Returns
        (state, metrics): the rollout batch's, the last step's and the
        phase timer's."""
        with profiling_phase(self.timer, "generate_and_score"):
            batch, gen_metrics = self.rollout_and_score(samples)
        metrics = dict(gen_metrics)
        with profiling_phase(self.timer, "optimize"):
            for _ in range(self.gcfg.num_iterations):
                state, step_metrics = self.step_fn(state, batch)
            # reading the metrics waits for the steps' device work
            metrics.update({k: float(v) for k, v in step_metrics.items()})
        metrics.update(self.timer.metrics())
        return state, metrics
