"""Batched autoregressive generation: prefill + a Python decode loop.

Port of ``video_r2_tpu/engine/generate.py``:

- right-padded prompts with per-sample lengths; the KV cache is addressed by
  true position and decode step t writes the fixed slot S + t for the whole
  batch (S = padded prompt width), so the write is one slice assignment;
- prefill fills the cache in place and gathers each sample's last-valid-token
  logits; `prefill_chunk` runs it in batch chunks on views of one cache;
- the decode loop is a Python loop over single-token forwards (the JAX
  package's lax.scan); finished samples emit pad, and the loop stops once
  every sample has finished (the JAX loop runs on and emits pad);
- M-RoPE decode positions use the cached rope delta: pos = length + step + delta;
  text-only prompts get equal positions from get_rope_index;
- act_quant="int8" runs prefill W8A8 on int8 weights (models/quant.py) and
  decode_act_quant="auto" runs decode W8A8 only from B >= 192, where decode
  turns compute-bound, as the reference chooses; otherwise decode stays
  int8 weight-only. int4 weights (quantize_params(bits=4)) run through the
  int4 kernel wherever a linear sees at most 1024 rows;
- decode_impl="kernel" runs the decode through the head-major decode
  kernel (ops/decode_attention.py): a DecodeKVCache of width
  ceil((S + T) / BLOCK_S) * BLOCK_S, filled head-major by prefill, and
  Decoder.decode_step per token (its linears take no act_quant; the head
  does). "xla" keeps the seq-major cache and the plain decode attention;
  "auto" picks "xla", as the reference does (its kernel is the opt-in
  long-context small-batch decode). The kernel cannot take prefill_chunk;
- kv_quant="int8" keeps the seq-major cache in int8 with per-(token, head)
  scales (models/decoder.py::QuantKVCache): prefill attends over its local
  bf16 k / v, decode over the int8 cache (ops/attention.py::
  quant_dot_product_attention). It composes with act_quant, prefill_chunk
  and attn_impl="flash", not with decode_impl="kernel" (a bf16 head-major
  cache), as in the reference;
- spec_decode=K > 0 decodes by speculative decoding (engine/spec_decode.py:
  K n-gram drafts verified a pass; greedy gives plain greedy's tokens,
  sampled a sample of its distribution) over the seq-major cache, bf16 or
  int8 (kv_quant), widened to S + T + K + 1 for the last verify chunk;
  decode_impl is then "xla", as in the reference.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..models.decoder import DecodeKVCache, KVCache, QuantKVCache
from ..models.model import Qwen25VL, lm_head, merge_vision_embeddings
from ..models.mrope import get_rope_index, mrope_cos_sin
from ..ops.decode_attention import BLOCK_S
from .sampling import SamplingParams, sample_token
from .spec_decode import spec_decode as spec_decode_loop

NEG_INF = -1e30


@dataclass
class GenerationResult:
    sequences: np.ndarray      # [B, max_new_tokens] generated ids (pad-filled)
    lengths: np.ndarray        # [B] number of generated tokens (incl. eos)
    logprobs: np.ndarray       # [B, max_new_tokens] chosen-token logprobs


@torch.inference_mode()
def prefill(model: Qwen25VL, input_ids: torch.Tensor, position_ids: torch.Tensor,
            lengths: torch.Tensor, cache: KVCache | DecodeKVCache | QuantKVCache,
            vision_embeds: torch.Tensor | None = None,
            vision_token_id: int | None = None,
            attn_impl: str = "xla", act_quant: str | None = None) -> torch.Tensor:
    """Run the prompt [B, S] and fill rows [0, S) of `cache` in place (a
    DecodeKVCache by the head-major fill, a QuantKVCache by the quantized
    fill). Returns the last valid token's logits [B, V] in fp32 (the head is
    not W8A8 in prefill, as in the reference)."""
    cfg = model.cfg
    B, S = input_ids.shape
    h = model.model.embed_tokens(input_ids)
    if vision_embeds is not None:
        h = merge_vision_embeddings(
            input_ids, h, vision_embeds,
            cfg.video_token_id if vision_token_id is None else vision_token_id)
    cos, sin = mrope_cos_sin(position_ids, cfg, dtype=h.dtype)
    if attn_impl == "flash" or isinstance(cache, (DecodeKVCache, QuantKVCache)):
        # the flash kernel masks by kv_lengths and causality itself; the
        # head-major and quantized fills attend over the local prompt-width
        # k / v, whose prefix-causal bias dot_product_attention builds from
        # kv_lengths
        bias = None
    else:
        # bias spans the whole cache width: causal over the prompt, -inf beyond
        i = torch.arange(S, device=h.device)[:, None]
        j = torch.arange(cache.k.shape[2], device=h.device)[None, :]
        allowed = (j <= i) & (j[None] < lengths[:, None, None])
        bias = torch.where(allowed[:, None], 0.0, NEG_INF)
    hidden = model.model(h, cos, sin, bias, cache=cache, cache_position=0,
                         attn_impl=attn_impl, kv_lengths=lengths, causal=True,
                         act_quant=act_quant)
    last = hidden[torch.arange(B, device=h.device), lengths.long() - 1]
    return lm_head(model, last).float()


@torch.inference_mode()
def decode_step_logits(model: Qwen25VL, tok: torch.Tensor, pos: torch.Tensor,
                       cache: KVCache | DecodeKVCache | QuantKVCache,
                       lengths: torch.Tensor, s_pad: int, t: int, attn_impl: str = "xla",
                       act_quant: str | None = None) -> torch.Tensor:
    """Forward decode token t: tok [B] at rope positions pos [B], its k / v
    written at slot s_pad + t of `cache` in place. A DecodeKVCache runs the
    decode kernel's step (its linears without act_quant; attn_impl does not
    apply to it); a KVCache the masked attention over the cache by
    attn_impl, a QuantKVCache the masked int8 attention. Returns the next
    logits [B, V] in fp32 (act_quant: a W8A8 head)."""
    cfg = model.cfg
    B = tok.shape[0]
    emb = model.model.embed_tokens(tok)[:, None]
    cos, sin = mrope_cos_sin(pos.reshape(1, B, 1).expand(3, B, 1), cfg, dtype=emb.dtype)
    if isinstance(cache, DecodeKVCache):
        hidden = model.model.decode_step(emb, cos, sin, cache, lengths, s_pad, t)
    else:
        j = torch.arange(cache.k.shape[2], device=tok.device)[None, :]
        allowed = (j < lengths[:, None]) | ((j >= s_pad) & (j <= s_pad + t))
        bias = torch.where(allowed[:, None, None], 0.0, NEG_INF)
        hidden = model.model(emb, cos, sin, bias, cache=cache, cache_position=s_pad + t,
                             attn_impl=attn_impl, act_quant=act_quant)
    return lm_head(model, hidden[:, 0], act_quant).float()


@torch.inference_mode()
def decode(model: Qwen25VL, sp: SamplingParams, first_logits: torch.Tensor,
           cache: KVCache | DecodeKVCache | QuantKVCache, lengths: torch.Tensor,
           rope_deltas: torch.Tensor, generator: torch.Generator | None, s_pad: int,
           attn_impl: str = "xla",
           act_quant: str | None = None) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Up to `sp.max_new_tokens` decode steps over `cache` (a DecodeKVCache
    through the decode kernel). Returns (tokens [B, T], logprobs [B, T],
    generated lengths [B]). act_quant: W8A8 decode matmuls and head (the
    head only, under the decode kernel)."""
    B = first_logits.shape[0]
    T = sp.max_new_tokens
    device = first_logits.device
    toks = torch.full((B, T), sp.pad_token_id, dtype=torch.long, device=device)
    logps = torch.zeros((B, T), dtype=torch.float32, device=device)
    eos = torch.as_tensor(sp.eos_token_ids, dtype=torch.long, device=device)
    logits = first_logits
    cur_len = lengths.long().clone()
    done = torch.zeros(B, dtype=torch.bool, device=device)
    for t in range(T):
        tok = sample_token(logits, generator, sp)
        tok = torch.where(done, sp.pad_token_id, tok)
        logp = logits[torch.arange(B, device=device), tok] - torch.logsumexp(logits, -1)
        toks[:, t] = tok
        logps[:, t] = torch.where(done, 0.0, logp)
        new_done = done
        if eos.numel():
            new_done = done | (tok[:, None] == eos[None, :]).any(dim=-1)
        if t == T - 1 or bool(new_done.all()):
            break   # the next logits would be unused
        logits = decode_step_logits(model, tok, cur_len + rope_deltas, cache, lengths,
                                    s_pad, t, attn_impl, act_quant)
        cur_len = torch.where(done, cur_len, cur_len + 1)
        done = new_done
    gen_len = (toks != sp.pad_token_id).sum(dim=-1)
    return toks, logps, gen_len


@torch.inference_mode()
def generate(model: Qwen25VL, input_ids: np.ndarray, lengths: np.ndarray,
             sp: SamplingParams, position_ids: np.ndarray | None = None,
             rope_deltas: np.ndarray | None = None,
             vision_embeds: torch.Tensor | None = None,
             vision_token_id: int | None = None, seed: int = 0,
             attn_impl: str = "xla",
             prefill_chunk: int | None = None,
             act_quant: str | None = None, decode_impl: str = "auto",
             decode_act_quant: str | None = "auto",
             kv_quant: str | None = None, spec_decode: int = 0) -> GenerationResult:
    """Host-orchestrated batched generation on the model's device.
    attn_impl="flash" runs prefill attention through the flash kernel;
    act_quant="int8": W8A8 prefill; decode_act_quant "auto": int8 iff
    act_quant is int8 and B >= 192. decode_impl: "kernel" (the head-major
    decode kernel), "xla" (the plain decode), "auto" ("xla").
    kv_quant="int8": the int8 KV cache. spec_decode=K: speculative
    decoding with K drafts a verify pass (decode_impl then "xla")."""
    if decode_impl not in ("auto", "xla", "kernel"):
        raise ValueError(f"unknown decode_impl {decode_impl!r}")
    if kv_quant not in (None, "int8"):
        raise ValueError(f"unknown kv_quant {kv_quant!r}")
    if spec_decode:
        decode_impl = "xla"    # verify chunks scatter into the seq-major cache
    if kv_quant and decode_impl == "kernel":
        raise ValueError("kv_quant='int8' keeps the seq-major int8 cache; "
                         "decode_impl='kernel' reads a bf16 head-major one")
    cfg = model.cfg
    device = model.device
    input_ids = np.asarray(input_ids)
    lengths = np.asarray(lengths)
    B, S = input_ids.shape
    if decode_act_quant == "auto":
        decode_act_quant = "int8" if (act_quant == "int8" and B >= 192) else None
    if position_ids is None:
        mask = (np.arange(S)[None, :] < lengths[:, None]).astype(np.int64)
        position_ids, deltas = get_rope_index(input_ids, cfg, attention_mask=mask)
        if rope_deltas is None:
            rope_deltas = deltas[:, 0]
    if rope_deltas is None:
        raise ValueError("rope_deltas are required with explicit position_ids")
    # get_rope_index deltas are relative to the padded width S; the decode
    # loop counts from the true length, so shift by S - length
    rope_deltas = np.asarray(rope_deltas) + (S - lengths)
    dtype = model.model.embed_tokens.embedding.dtype
    if decode_impl == "kernel":
        if prefill_chunk and B > prefill_chunk:
            raise ValueError("prefill_chunk is incompatible with decode_impl='kernel' "
                             "(chunked prefill fills the seq-major cache; the kernel "
                             "reads the head-major one)")
        # the kernel reads whole blocks of BLOCK_S rows; decode slots start at S
        max_cache = -(-(S + sp.max_new_tokens) // BLOCK_S) * BLOCK_S
        cache = DecodeKVCache.init(cfg.text, B, max_cache, dtype, device)
    else:
        # spec decode's last verify chunk can reach S + T + K
        width = S + sp.max_new_tokens + (spec_decode + 1 if spec_decode else 0)
        cache = (QuantKVCache.init(cfg.text, B, width, device) if kv_quant
                 else KVCache.init(cfg.text, B, width, dtype, device))
    ids_t = torch.as_tensor(input_ids, dtype=torch.long, device=device)
    pos_t = torch.as_tensor(position_ids, dtype=torch.long, device=device)
    len_t = torch.as_tensor(lengths, dtype=torch.int32, device=device)
    if vision_embeds is not None:
        vision_embeds = vision_embeds.to(device)

    if prefill_chunk and B > prefill_chunk:
        if B % prefill_chunk:
            raise ValueError(f"batch {B} not a multiple of prefill_chunk "
                             f"{prefill_chunk}")
        emb_off = None
        if vision_embeds is not None:
            vtok = cfg.video_token_id if vision_token_id is None else vision_token_id
            counts = (input_ids == vtok).sum(axis=1)
            emb_off = np.concatenate([[0], np.cumsum(counts)])
        parts = []
        for s in range(0, B, prefill_chunk):
            e = s + prefill_chunk
            emb_c = None
            if emb_off is not None and emb_off[e] > emb_off[s]:
                emb_c = vision_embeds[int(emb_off[s]):int(emb_off[e])]
            parts.append(prefill(model, ids_t[s:e], pos_t[:, s:e], len_t[s:e],
                                 cache.batch_slice(s, e), emb_c,
                                 vision_token_id, attn_impl, act_quant))
        logits = torch.cat(parts, dim=0)
    else:
        logits = prefill(model, ids_t, pos_t, len_t, cache, vision_embeds,
                         vision_token_id, attn_impl, act_quant)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    deltas_t = torch.as_tensor(rope_deltas, dtype=torch.long, device=device)
    if spec_decode:
        toks, logps, gen_len, _ = spec_decode_loop(
            model, sp, logits, cache, len_t, deltas_t, ids_t, s_pad=S, spec_k=spec_decode,
            act_quant=decode_act_quant, generator=gen)
        return GenerationResult(toks.cpu().numpy(), gen_len.cpu().numpy(),
                                logps.cpu().numpy())
    toks, logps, gen_len = decode(
        model, sp, logits, cache, len_t, deltas_t, gen, s_pad=S, attn_impl=attn_impl, act_quant=decode_act_quant)
    return GenerationResult(toks.cpu().numpy(), gen_len.cpu().numpy(),
                            logps.cpu().numpy())
