"""Speculative decoding: n-gram prompt-lookup drafting + batched verify.

Port of ``video_r2_tpu/engine/spec_decode.py``. Greedy decode emits one
token per decoder pass; speculative decoding emits 1 + a, where a is the
number of draft tokens the model confirms. The drafts cost nothing to make
("prompt lookup decoding", vLLM's ``[ngram]`` speculator): the K tokens that
followed the latest earlier occurrence of the running sequence's last
bigram, in the prompt or in the tokens generated so far. Video QA answers
quote subtitles and options, the TAC / VAS judge's outputs echo the
prompt's format strings, and <think> reasoning repeats itself, so the
drafts are often right.

Exactness, both modes:
- greedy: a draft is kept only where it equals the argmax the model gives
  at that position, and the pending token is always the model's own
  argmax, so the tokens are plain greedy decode's. On the CPU in float32
  they are, token for token; on the card in bf16 a K+1-row verify and a
  1-row step round differently (the kernels' splits and tiles, the MoE
  route), so two near-tied logits may order differently;
- sampled: rejection sampling (Leviathan and Chen's speculative sampling,
  for the deterministic n-gram proposal): draft d is accepted with
  probability p(d) under the request's filtered target distribution, and on
  rejection the next pending token is drawn from the residual (p with d's
  mass masked, after the filters). The stream is a sample of plain
  sampling's distribution, not its bits (the draws differ).

The loop is a Python loop of verify rounds, each one decoder pass over a
[B, K+1] chunk written at each row's own frontier s_pad + gen_len_b
(models/decoder.py's per-row writes; rejected drafts leave rows past the
frontier that the bias masks until they are written again). Tokens,
history and bookkeeping stay on the device; a round syncs once, for the
loop's condition. Draws come from the caller's torch.Generator.

A round's pieces (_spec_tok0, draft_tokens, _spec_accept, reject_mask)
are the continuous engines' too (engine/continuous.py); spec_decode adds
generate's padded-prompt history, the EOS and budget cut and the logprobs.
"""

from __future__ import annotations

import torch

from ..models.decoder import KVCache, QuantKVCache
from ..models.model import lm_head
from ..models.mrope import mrope_cos_sin
from .sampling import NEG_INF, SamplingParams, filter_logits_per_slot


def draft_tokens(hist, tok0, prev, valid, K: int, _reject_all: bool = False):
    """Last-bigram prompt lookup over the history hist [B, Lh]: the latest
    position p with hist[p] == prev, hist[p + 1] == tok0 and valid[:, p]
    (the caller's rule: the K tokens after the bigram lie in written
    history); propose those K, or tok0 repeated where nothing matches
    (verify rejects them). _reject_all proposes -2, which matches no token
    (the zero-acceptance verify floor, for profiling). Returns [B, K]."""
    B, Lh = hist.shape
    m = (hist[:, :-1] == prev[:, None]) & (hist[:, 1:] == tok0[:, None]) & valid
    has = m.any(dim=1)
    last = (Lh - 2) - m.flip(1).int().argmax(dim=1)
    src = (last[:, None] + 2 + torch.arange(K, device=hist.device)).clamp(max=Lh - 1)
    drafts = torch.where(has[:, None], hist.gather(1, src), tok0[:, None])
    if _reject_all:
        drafts = torch.full_like(drafts, -2)
    return drafts


def embed_chunk(model, chunk: torch.Tensor) -> torch.Tensor:
    """Embeddings of a verify chunk; the -2 sentinel of _reject_all takes
    row V - 2, as JAX's wrapped gather does."""
    V = model.model.embed_tokens.embedding.shape[0]
    return model.model.embed_tokens(torch.where(chunk < 0, chunk + V, chunk))


def reject_mask(logits: torch.Tensor, rej: torch.Tensor) -> torch.Tensor:
    """Mask each row's rejected draft (rej >= 0) out of its filtered logits:
    the residual distribution after a rejection."""
    V = logits.shape[-1]
    hit = (torch.arange(V, device=logits.device)[None, :] == rej[:, None]) & (rej[:, None] >= 0)
    return logits.masked_fill(hit, float("-inf"))


def _spec_tok0(logits, generator, samp, active, pad_id: int, rej, greedy_only: bool):
    """The pending token of each slot: greedy argmax, or (sampled slots)
    drawn from its filtered target distribution with a rejected draft's
    mass masked (the exact residual). greedy_only skips the filter's sort."""
    greedy = torch.argmax(logits, dim=-1)
    if greedy_only:
        tok0 = greedy
    else:
        temperature, top_p, top_k, do_sample = samp
        filtered = reject_mask(filter_logits_per_slot(logits, temperature, top_p, top_k), rej)
        sampled = torch.multinomial(torch.softmax(filtered, dim=-1), 1,
                                    generator=generator)[:, 0]
        tok0 = torch.where(do_sample, sampled, greedy)
    return torch.where(active, tok0, pad_id)


def _spec_draft(hist, tok0, cur_len, K: int, _reject_all: bool):
    """n-gram prompt lookup against the history [N, Lh] (prompt and tokens,
    contiguous in [0, cur_len)): the K tokens after the latest occurrence of
    the (last token, pending token) bigram. Returns (chunk [N, K + 1],
    drafts [N, K])."""
    N, Lh = hist.shape
    rows = torch.arange(N, device=hist.device)
    prev = hist[rows, (cur_len - 1).clamp(min=0)]
    valid = torch.arange(Lh - 1, device=hist.device)[None, :] + 2 + K <= cur_len[:, None]
    drafts = draft_tokens(hist, tok0, prev, valid, K, _reject_all)
    return torch.cat([tok0[:, None], drafts], dim=1), drafts


def _spec_accept(logits_w, drafts, logits, active, K: int, samp, generator,
                 greedy_only: bool):
    """Per-slot acceptance of the verify logits [N, K + 1, V]: greedy slots
    keep a draft where it equals the argmax at its position, sampled slots
    by rejection sampling under their filtered target distribution; both
    need every earlier draft kept. Returns (n_commit [N], the next pending
    logits [N, V], the rejected draft [N] or -1)."""
    N, _, V = logits_w.shape
    rows = torch.arange(N, device=logits_w.device)
    match = drafts == logits_w.argmax(dim=-1)[:, :K]
    if not greedy_only:
        temperature, top_p, top_k, do_sample = samp
        pf = filter_logits_per_slot(logits_w[:, :K], temperature, top_p, top_k)
        dsafe = drafts.clamp(0, V - 1)
        ld = pf.gather(-1, dsafe[..., None])[..., 0] - torch.logsumexp(pf, dim=-1)
        ld = torch.where(drafts == dsafe, ld, float("-inf"))     # _reject_all's -2
        u = torch.rand(drafts.shape, generator=generator, device=drafts.device)
        match = torch.where(do_sample[:, None], torch.log(u) < ld, match)
    a = torch.cumprod(match.long(), dim=1).sum(dim=1)
    n_commit = torch.where(active, 1 + a, 0)
    sel = (n_commit - 1).clamp(0, K)
    new_logits = torch.where(active[:, None], logits_w[rows, sel], logits)
    if greedy_only:
        new_rej = torch.full_like(a, -1)
    else:
        rejected = active & do_sample & (a < K)
        new_rej = torch.where(rejected, drafts[rows, a.clamp(max=K - 1)].clamp(-1, V - 1), -1)
    return n_commit, new_logits, new_rej


def _spec_hist_update(hist, chunk, cur_len, n_commit) -> None:
    """The committed chunk tokens extend each slot's history at its
    frontier, in place (uncommitted positions keep what they held)."""
    W, Lh = chunk.shape[1], hist.shape[1]
    idxs = (cur_len[:, None] + torch.arange(W, device=hist.device)).clamp(max=Lh - 1)
    keep = torch.arange(W, device=hist.device)[None, :] < n_commit[:, None]
    hist.scatter_(1, idxs, torch.where(keep, chunk, hist.gather(1, idxs)))


@torch.inference_mode()
def spec_decode(model, sp: SamplingParams, first_logits: torch.Tensor,
                cache: KVCache | QuantKVCache, lengths: torch.Tensor,
                rope_deltas: torch.Tensor, input_ids: torch.Tensor, s_pad: int,
                spec_k: int = 4, act_quant: str | None = None,
                _reject_all: bool = False, generator: torch.Generator | None = None):
    """Speculative decode of up to sp.max_new_tokens tokens, greedy or sampled.

    first_logits [B, V] from prefill; cache seq-major (a KVCache, or a
    QuantKVCache whose verify chunks quantize per token) of width at least
    s_pad + T + K + 1; lengths [B] prompt lengths; rope_deltas [B] shifted
    as in generate(); input_ids [B, S] the right-padded prompt (the draft
    source); decode slots start at s_pad. Returns (tokens [B, T], logprobs
    [B, T], generated lengths [B], verify rounds)."""
    B, V = first_logits.shape
    T, K = sp.max_new_tokens, spec_k
    W = K + 1
    dev = first_logits.device
    S_in = input_ids.shape[1]
    max_len = cache.k.shape[2]
    if max_len < s_pad + T + W:
        raise ValueError(f"spec_decode: cache width {max_len} < s_pad + T + K + 1 = "
                         f"{s_pad + T + W}")
    b_idx = torch.arange(B, device=dev)
    lengths = lengths.to(dev).long()
    rope_deltas = rope_deltas.to(dev).long()
    eos = torch.as_tensor(sp.eos_token_ids, dtype=torch.long, device=dev)
    # history = [prompt | generated] with a W-token tail, so frontier writes
    # never fall off its end
    Lh = S_in + T + W
    hist = torch.zeros((B, Lh), dtype=torch.long, device=dev)
    hist[:, :S_in] = input_ids.to(dev).long()
    p = torch.arange(Lh - 1, device=dev)[None, :]
    emit_i = torch.arange(W, device=dev)[None, :]
    j = torch.arange(max_len, device=dev)[None, None, :]
    i = torch.arange(W, device=dev)[None, :, None]

    logits = first_logits.float()
    gen_len = torch.zeros(B, dtype=torch.long, device=dev)
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    out = torch.full((B, T + W), sp.pad_token_id, dtype=torch.long, device=dev)
    outlp = torch.zeros((B, T + W), dtype=torch.float32, device=dev)
    rej = torch.full((B,), -1, dtype=torch.long, device=dev)
    # the engines' per-slot sampling tensors, every row with sp's
    samp = (torch.full((B,), sp.temperature, dtype=torch.float32, device=dev),
            torch.full((B,), sp.top_p, dtype=torch.float32, device=dev),
            torch.full((B,), sp.top_k, dtype=torch.long, device=dev),
            torch.full((B,), sp.do_sample, dtype=torch.bool, device=dev))
    greedy_only = not sp.do_sample
    it = 0
    while it < T and bool((~done & (gen_len < T)).any()):
        active = ~done
        tok0 = _spec_tok0(logits, generator, samp, active, sp.pad_token_id, rej, greedy_only)
        lp0 = logits[b_idx, tok0] - torch.logsumexp(logits, dim=-1)
        # the history is the padded prompt, then the tokens from S_in: a
        # bigram and its K followers lie in one of the two
        prev = hist[b_idx, torch.where(gen_len > 0, S_in + gen_len - 1, lengths - 1)]
        in_prompt = p + 2 + K <= lengths[:, None]
        in_gen = (p >= S_in) & (p + 2 + K <= S_in + gen_len[:, None])
        drafts = draft_tokens(hist, tok0, prev, in_prompt | in_gen, K, _reject_all)
        chunk = torch.cat([tok0[:, None], drafts], dim=1)               # [B, W]

        # one verify pass over the chunk at each row's frontier
        emb = embed_chunk(model, chunk)
        pos = (lengths + gen_len + rope_deltas)[:, None] + emit_i
        cos, sin = mrope_cos_sin(pos[None].expand(3, B, W), model.cfg, dtype=emb.dtype)
        allowed = (j < lengths[:, None, None]) | (
            (j >= s_pad) & (j < s_pad + gen_len[:, None, None] + i + 1))
        bias = torch.where(allowed[:, None], 0.0, NEG_INF)
        hidden = model.model(emb, cos, sin, bias, cache=cache,
                             cache_position=s_pad + gen_len, attn_impl="xla",
                             act_quant=act_quant)
        logits_w = lm_head(model, hidden, act_quant).float()             # [B, W, V]
        # the next pending logits and rejected draft are the engines' too: a
        # row that stays live emitted its whole commit (a cut by EOS or the
        # budget ends the row)
        n_commit, logits, rej = _spec_accept(logits_w, drafts, logits, active, K, samp,
                                             generator, greedy_only)

        # EOS inside the committed prefix truncates it; the budget caps it
        n_emit = torch.minimum(n_commit, T - gen_len)
        hit = (chunk[..., None] == eos).any(-1) & (emit_i < n_emit[:, None]) & active[:, None]
        eos_emitted = hit.any(dim=1)
        n_emit = torch.where(eos_emitted, hit.int().argmax(dim=1) + 1, n_emit)
        emit_mask = emit_i < n_emit[:, None]
        # logprobs: tok0 under the carried logits, draft i under position i - 1's
        dsafe = drafts.clamp(0, V - 1)
        lp_d = (logits_w[:, :K].gather(-1, dsafe[..., None])[..., 0]
                - torch.logsumexp(logits_w[:, :K], dim=-1))
        lp_chunk = torch.cat([lp0[:, None], lp_d], dim=1)
        idxs = gen_len[:, None] + emit_i
        out.scatter_(1, idxs, torch.where(emit_mask, chunk, out.gather(1, idxs)))
        outlp.scatter_(1, idxs, torch.where(emit_mask, lp_chunk, outlp.gather(1, idxs)))
        hidx = S_in + idxs
        hist.scatter_(1, hidx, torch.where(emit_mask, chunk, hist.gather(1, hidx)))

        gen_len = gen_len + n_emit
        done = done | eos_emitted | (gen_len >= T)
        it += 1
    return out[:, :T], outlp[:, :T], gen_len, it
