"""Continuous-batching generation engines: a slot pool and a paged pool.

Port of ``video_r2_tpu/engine/continuous.py``. A fixed pool of decode slots
shares one KV store and one decode step: requests are admitted into free
slots by prefill, every step advances all active slots, and a finished slot
frees at once, so short requests do not wait for long ones.

- `ContinuousEngine` keeps a contiguous per-slot cache [L, slots, max_len]
  and attends with the plain path (small; the tests hold it against the
  paged engine and `generate`).
- `PagedContinuousEngine` keeps the paged pool of ops/paged_attention.py:
  pages are allocated at admission and on demand while decoding, returned
  when a request finishes, shared with copy-on-write by `fork`, and kept
  content-addressed by the automatic prefix cache. Prefill goes through
  the flash kernel (attn_impl "flash"), decode through the paged kernel,
  over bf16 pages or int8 pages with per-(token, head) scales
  (kv_quant="int8"). `submit_batch` prefills same-bucket bursts in one
  decoder pass each, multimodal ones with their ViT embeds concatenated in
  row order (the eval backend's admission path); `submit_packed` packs
  short text prompts into shared rows, kept apart by segment ids, and
  prefills the whole burst in one pass (the judge's admission path).

`run_loop` is the threaded server loop (engine/server.py's continuous
mode): it pulls requests from a queue, admits them (an idle burst packed
or batched, else a budgeted trickle between decode windows) and decodes
`decode_window` tokens a step until stopped. Only the loop's thread
touches the device; callers only enqueue.

`spec_decode=K` speculates inside the loop (engine/spec_decode.py's n-gram
drafts): a dispatch runs `steps` verify rounds, each one decoder pass over a
[slots, K + 1] chunk written at every slot's own frontier (the slot engine's
cache by per-row writes, the paged pool at per-token (page, offset), read by
the paged kernel's multi-query chunk), drafting from a device-side history
of each slot's prompt and tokens. Greedy slots accept a draft where it
equals the argmax, sampled slots by rejection sampling under their own
filters, in one pool; a sampled slot's rejected draft is masked from its
next pending token, also across a plain-decode fallback.
`prefill_chunk_tokens=C` prefills a longer prompt (text on the slot
engine, text or video on the paged one) a chunk of C tokens per step(),
between decode windows: the slot engine's chunks attend over the slot's
cache with an offset-causal bias (plain attention), the paged engine's
first chunk goes through the flash prefill and each later one through the
suffix prefill over the pages written so far.

The JAX package's jitted steps become plain functions that update the KV
store in place; a decode window (`step(steps=n)`) is a Python loop of n
decode bodies (or n verify rounds) that keeps its tokens on the device and
synchronises once. Sampling draws from the engine's seeded
torch.Generator. A mesh raises NotImplementedError (ROADMAP Queue 1 #8).
"""

from __future__ import annotations

import hashlib
import logging
import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..models.decoder import KVCache, quantize_kv
from ..models.model import lm_head, merge_vision_embeddings
from ..models.mrope import get_rope_index, mrope_cos_sin
from ..ops.attention import plain_attention
from ..ops.paged_attention import (
    PagedKVCache,
    check_kernel_sizes,
    paged_decode_attention_stacked,
)
from .sampling import SamplingParams, sample_token_per_slot
from .spec_decode import (
    _spec_accept,
    _spec_draft,
    _spec_hist_update,
    _spec_tok0,
    embed_chunk,
    reject_mask,
)

NEG_INF = -1e30
_log = logging.getLogger(__name__)


# ---------------------------------------------------------------------------
# Device functions (the JAX package's jitted steps)
# ---------------------------------------------------------------------------

def _embed(model, ids, vision_embeds=None):
    h = model.model.embed_tokens(ids)
    if vision_embeds is not None:
        h = merge_vision_embeddings(ids, h, vision_embeds, model.cfg.video_token_id)
    return h


def _prefill_rows(model, ids, position_ids, lengths, vision_embeds, attn_impl):
    """K prompts [K, S] from position 0 into a fresh [L, K, S] cache, causal,
    keys past each row's length masked. Returns (hidden [K, S, H], cache)."""
    h = _embed(model, ids, vision_embeds)
    cos, sin = mrope_cos_sin(position_ids, model.cfg, dtype=h.dtype)
    K, S = ids.shape
    tmp = KVCache.init(model.cfg.text, K, S, h.dtype, h.device)
    bias = None   # the flash kernel masks by lengths and causality itself
    if attn_impl != "flash":
        i = torch.arange(S, device=h.device)[:, None]
        j = torch.arange(S, device=h.device)[None, :]
        allowed = (j <= i)[None] & (j[None] < lengths[:, None, None])
        bias = torch.where(allowed[:, None], 0.0, NEG_INF)
    hidden = model.model(h, cos, sin, bias, cache=tmp, cache_position=0,
                         attn_impl=attn_impl, kv_lengths=lengths, causal=True)
    return hidden, tmp


def _last_logits(model, hidden, lengths):
    """fp32 logits [K, V] of each row's last valid token."""
    rows = torch.arange(hidden.shape[0], device=hidden.device)
    return lm_head(model, hidden[rows, lengths.long() - 1]).float()


def _prefill_into_slot(model, cache: KVCache, slot: int, ids, position_ids, length,
                       vision_embeds=None, attn_impl: str = "xla"):
    """One prompt ([1, S]) prefilled, its KV written into row `slot` of the
    contiguous cache (the rest of the row zeroed). Returns logits [V]."""
    hidden, tmp = _prefill_rows(model, ids, position_ids, length, vision_embeds,
                                attn_impl)
    S = ids.shape[1]
    for dst, src in ((cache.k, tmp.k), (cache.v, tmp.v)):
        dst[:, slot] = 0
        dst[:, slot, :S] = src[:, 0]
    return _last_logits(model, hidden, length)[0]


def _prefill_slot_chunk(model, cache: KVCache, slot: int, ids, position_ids, start: int,
                        valid: int):
    """One chunk of a slot's prompt ([1, C] at token offset `start`) into
    row `slot` of the contiguous cache, in place: the chunk attends over the
    row's rows [0, start) and itself causally (an offset-causal bias over
    the whole row, so the plain attention), its KV written at [start,
    start + C). Returns the logits [V] of the prompt's last valid token
    (`valid` tokens in all), meaningful on the last chunk."""
    h = _embed(model, ids)
    cos, sin = mrope_cos_sin(position_ids, model.cfg, dtype=h.dtype)
    C = ids.shape[1]
    tmp = KVCache(cache.k[:, slot:slot + 1], cache.v[:, slot:slot + 1])   # views
    i = torch.arange(C, device=h.device)[:, None]
    j = torch.arange(cache.k.shape[2], device=h.device)[None, :]
    bias = torch.where((j <= start + i)[None, None], 0.0, NEG_INF)
    hidden = model.model(h, cos, sin, bias, cache=tmp, cache_position=start,
                         attn_impl="xla")
    return lm_head(model, hidden[0, min(max(valid - start - 1, 0), C - 1)]).float()


def _scatter_pages(kv, kk, vv, flat) -> None:
    """Write prefilled KV rows ([L, kh, n_chunks, ps, hd]) into the pool at
    page ids `flat`, in place. For int8 pools ((k, v, k_scale, v_scale)) the
    rows quantize per (token, head) on the way in (models/decoder.quantize_kv)."""
    if len(kv) == 4:
        kq, ks = quantize_kv(kk)
        vq, vs = quantize_kv(vv)
        for pool, x in zip(kv, (kq, vq, ks, vs)):
            pool[:, :, flat] = x
    else:
        kv[0][:, :, flat] = kk.to(kv[0].dtype)
        kv[1][:, :, flat] = vv.to(kv[1].dtype)


def _prefill_into_pages_batch(model, kv, pids, ids, position_ids, lengths,
                              vision_embeds=None, attn_impl: str = "xla",
                              page_size: int = 128):
    """Batched admission prefill: K same-bucket prompts (ids [K, bucket]) in
    one decoder pass, their KV scattered into pids [K, bucket / page_size].
    Multimodal bursts pass every row's ViT embeds concatenated in row order
    (the cumsum-gather merge maps each row's <|video_pad|> run onto its own
    slice). Returns last-token logits [K, V]."""
    hidden, tmp = _prefill_rows(model, ids, position_ids, lengths, vision_embeds,
                                attn_impl)
    _scatter_pages(kv, _rows_to_pages(tmp.k, page_size),
                   _rows_to_pages(tmp.v, page_size), pids.reshape(-1))
    return _last_logits(model, hidden, lengths)


def _rows_to_pages(x, page_size: int):
    """Cache rows [L, K, S, kh, hd] -> pages [L, kh, K * S / ps, ps, hd]."""
    L, K, S, kh, hd = x.shape
    npb = S // page_size
    return (x.reshape(L, K, npb, page_size, kh, hd).permute(0, 4, 1, 2, 3, 5)
            .reshape(L, kh, K * npb, page_size, hd))


def _prefill_into_pages(model, kv, pids, ids, position_ids, length,
                        vision_embeds=None, attn_impl: str = "xla",
                        page_size: int = 128):
    """One prompt ([1, bucket]) into its pages pids [bucket / page_size]."""
    return _prefill_into_pages_batch(model, kv, pids[None], ids, position_ids, length,
                                     vision_embeds, attn_impl, page_size)[0]


def _prefill_packed_into_pages(model, kv, pids, ids, position_ids, seg_ids, last_rc,
                               attn_impl: str = "xla", page_size: int = 128):
    """Sequence-packed admission prefill: many short prompts share each row
    of ids [R, S] in page-aligned spans, kept apart by seg_ids [R, S]
    (request ordinal + 1, pads -2) through the flash kernel's segment
    masking (or the plain path's equal mask), one decoder pass for the
    whole burst. pids [R, S / page_size]: page destinations (the trash page
    for unowned chunks); last_rc [n, 2]: (row, col) of each request's last
    token. seg_ids None drops the masking: each prompt then attends to the
    prompts before it in its row (the fault the tests' control shows).
    Returns last-token logits [n, V]."""
    h = _embed(model, ids)
    cos, sin = mrope_cos_sin(position_ids, model.cfg, dtype=h.dtype)
    R, S = ids.shape
    tmp = KVCache.init(model.cfg.text, R, S, h.dtype, h.device)
    lengths = torch.full((R,), S, dtype=torch.int32, device=h.device)
    hidden = model.model(h, cos, sin, None, cache=tmp, cache_position=0,
                         attn_impl=attn_impl, kv_lengths=lengths, causal=True,
                         segment_ids=seg_ids)
    _scatter_pages(kv, _rows_to_pages(tmp.k, page_size),
                   _rows_to_pages(tmp.v, page_size), pids.reshape(-1))
    return lm_head(model, hidden[last_rc[:, 0], last_rc[:, 1]]).float()


def _prefix_page_hashes(ids: np.ndarray, page_size: int,
                        vision_token_ids: tuple[int, ...], media_key) -> list[bytes]:
    """Chain hashes for the FULL pages of a prompt: h_p = sha256(h_{p-1} ||
    page tokens [|| media_key if the page holds vision tokens]). Without a
    media_key the chain stops at the first vision-bearing page: identical
    <|video_pad|> runs with different pixels must never collide."""
    out: list[bytes] = []
    h = b""
    for p in range(len(ids) // page_size):
        page = ids[p * page_size:(p + 1) * page_size]
        has_vision = bool(np.isin(page, vision_token_ids).any())
        if has_vision and media_key is None:
            break
        hh = hashlib.sha256(h)
        hh.update(page.tobytes())
        if has_vision:
            hh.update(repr(media_key).encode())
        h = hh.digest()
        out.append(h)
    return out


def _prefill_suffix_into_pages(model, kv, prefix_pids, new_pids, ids, position_ids,
                               prefix_len, suffix_len, vision_embeds=None,
                               page_size: int = 128):
    """Prefill only the SUFFIX of a prompt whose page-aligned prefix KV is
    pooled (a prefix-cache hit): gather the prefix pages (trash-padded to a
    power of two, masked by prefix_len) into a dense history, run the suffix
    tokens over [history | suffix] and scatter the suffix KV into new_pids.
    The gap between valid history and the suffix needs an explicit bias, so
    this runs the plain attention path. Returns logits [V]."""
    h = _embed(model, ids, vision_embeds)
    cos, sin = mrope_cos_sin(position_ids, model.cfg, dtype=h.dtype)
    S_suf = ids.shape[1]
    K_pref = prefix_pids.shape[0] * page_size
    L, kh, _, _, hd = kv[0].shape

    def history(pool, scale):   # -> [L, 1, K_pref + S_suf, kh, hd] in h's dtype
        # a layer at a time, so an int8 pool's fp32 dequantisation stays one
        # layer's (a whole judge prefix in fp32 would be GBs)
        out = torch.zeros((L, 1, K_pref + S_suf, kh, hd), dtype=h.dtype, device=h.device)
        for l in range(L):
            x = pool[l][:, prefix_pids]                        # [kh, m, ps, hd]
            if scale is not None:
                x = x.float() * scale[l][:, prefix_pids][..., None]
            out[l, 0, :K_pref] = x.reshape(kh, K_pref, hd).transpose(0, 1).to(h.dtype)
        return out

    quant = len(kv) == 4
    tmp = KVCache(history(kv[0], kv[2] if quant else None),
                  history(kv[1], kv[3] if quant else None))
    i = torch.arange(S_suf, device=h.device)[:, None]
    j = torch.arange(K_pref + S_suf, device=h.device)[None, :]
    allowed = ((j < prefix_len[:, None, None])
               | ((j >= K_pref) & ((j - K_pref) <= i)
                  & ((j - K_pref) < suffix_len[:, None, None])))
    bias = torch.where(allowed[:, None], 0.0, NEG_INF)
    hidden = model.model(h, cos, sin, bias, cache=tmp, cache_position=K_pref,
                         attn_impl="xla")
    npb = S_suf // page_size

    def to_pages(x):   # suffix rows -> [L, kh, npb, ps, hd]
        return x[:, 0, K_pref:].reshape(L, npb, page_size, kh, hd).permute(0, 3, 1, 2, 4)

    _scatter_pages(kv, to_pages(tmp.k), to_pages(tmp.v), new_pids)
    return _last_logits(model, hidden, suffix_len)[0]


def _decoder_pass(model, x, cos, sin, attend):
    """The decoder layers over x [N, S, H], through each DecoderLayer's own
    qkv / finish helpers (qk-norm and the MoE block included), each layer's
    attention done by attend(layer, q, k, v), which also stores k and v.
    Returns the final-normed hidden."""
    for l, layer in enumerate(model.model.layers):
        x = layer.finish(x, attend(l, *layer.qkv(x, cos, sin)))
    return model.model.norm(x)


def _paged_decoder_pass(model, kv, emb, cos, sin, pid, off, page_tables, cur_len,
                        page_size: int):
    """The decoder over [N, S] tokens whose KV goes into the pool at per-token
    (pid, off) ([N, S] each), attending through the paged kernel (S > 1 is a
    verify chunk, masked causally inside the kernel). Returns hidden."""
    quant = len(kv) == 4
    lengths = (cur_len + 1).to(torch.int32)

    def attend(l, q, k, v):
        if quant:
            kq, ks = quantize_kv(k)
            vq, vs = quantize_kv(v)
            for pool, x in zip(kv, (kq, vq, ks, vs)):   # [kh, N, S(, hd)]
                pool[l][:, pid, off] = x.movedim(2, 0)
        else:
            kv[0][l][:, pid, off] = k.movedim(2, 0).to(kv[0].dtype)
            kv[1][l][:, pid, off] = v.movedim(2, 0).to(kv[1].dtype)
        out = paged_decode_attention_stacked(
            q if q.shape[1] > 1 else q[:, 0], kv[0], kv[1], page_tables, lengths, l,
            page_size, *(kv[2:] if quant else ()))
        return out.reshape(q.shape)

    return _decoder_pass(model, emb, cos, sin, attend)


def _next_token(logits, samp, generator, greedy_only: bool):
    if greedy_only:
        return torch.argmax(logits, dim=-1)
    return sample_token_per_slot(logits, generator, *samp)


def _token_embed_rope(model, sp, last_logits, cur_len, pos_base, active, samp,
                      generator, greedy_only):
    """(token [N], its embedding [N, 1, H], cos, sin) of one decode step;
    inactive slots take the pad token."""
    tok = _next_token(last_logits, samp, generator, greedy_only)
    tok = torch.where(active, tok, sp.pad_token_id)
    emb = model.model.embed_tokens(tok)[:, None]
    N = tok.shape[0]
    pos3 = (pos_base + cur_len).reshape(1, N, 1).expand(3, N, 1)
    cos, sin = mrope_cos_sin(pos3, model.cfg, dtype=emb.dtype)
    return tok, emb, cos, sin


def _paged_decode_body(model, kv, sp: SamplingParams, last_logits, cur_len, pos_base,
                       active, page_tables, trash_page: int, samp, generator,
                       page_size: int = 128, greedy_only: bool = False):
    """One token for every slot, KV appended into pages, attention through
    the paged kernel. page_tables must be sanitised: no -1 entries (inactive
    and unallocated entries point at the trash page). Returns (tokens [N],
    next logits [N, V], new cur_len)."""
    tok, emb, cos, sin = _token_embed_rope(model, sp, last_logits, cur_len, pos_base,
                                           active, samp, generator, greedy_only)
    rows = torch.arange(tok.shape[0], device=tok.device)
    pid = page_tables[rows, cur_len // page_size].long()
    pid = torch.where(active, pid, trash_page)[:, None]
    off = (cur_len % page_size)[:, None]
    x = _paged_decoder_pass(model, kv, emb, cos, sin, pid, off, page_tables, cur_len,
                            page_size)
    next_logits = lm_head(model, x[:, 0]).float()
    return tok, next_logits, torch.where(active, cur_len + 1, cur_len)


def _paged_decode_multi(model, kv, sp, last_logits, cur_len, pos_base, active,
                        page_tables, trash_page, samp, generator, page_size: int = 128,
                        n_steps: int = 8, greedy_only: bool = False):
    """`n_steps` decode bodies, tokens kept on the device. The caller has
    allocated pages for the whole window. Returns (tokens [n_steps, N],
    logits, cur_len)."""
    toks = []
    for _ in range(n_steps):
        tok, last_logits, cur_len = _paged_decode_body(
            model, kv, sp, last_logits, cur_len, pos_base, active, page_tables,
            trash_page, samp, generator, page_size, greedy_only)
        toks.append(tok)
    return torch.stack(toks), last_logits, cur_len


def _decode_body(model, cache: KVCache, sp: SamplingParams, last_logits, cur_len,
                 pos_base, active, samp, generator, greedy_only: bool = False):
    """One token for every slot of the contiguous cache: each slot's KV is
    written at its own position cur_len, keys <= cur_len attended."""
    tok, emb, cos, sin = _token_embed_rope(model, sp, last_logits, cur_len, pos_base,
                                           active, samp, generator, greedy_only)
    rows = torch.arange(tok.shape[0], device=tok.device)
    keys = torch.arange(cache.k.shape[2], device=tok.device)
    bias = torch.where((keys[None, :] <= cur_len[:, None])[:, None, None], 0.0, NEG_INF)

    def attend(l, q, k, v):
        cache.k[l][rows, cur_len] = k[:, 0]
        cache.v[l][rows, cur_len] = v[:, 0]
        return plain_attention(q, cache.k[l], cache.v[l], bias)

    x = _decoder_pass(model, emb, cos, sin, attend)
    next_logits = lm_head(model, x[:, 0]).float()
    return tok, next_logits, torch.where(active, cur_len + 1, cur_len)


def _decode_multi(model, cache, sp, last_logits, cur_len, pos_base, active, samp,
                  generator, n_steps: int, greedy_only: bool = False):
    toks = []
    for _ in range(n_steps):
        tok, last_logits, cur_len = _decode_body(model, cache, sp, last_logits,
                                                 cur_len, pos_base, active, samp,
                                                 generator, greedy_only)
        toks.append(tok)
    return torch.stack(toks), last_logits, cur_len


def _spec_rounds(model, verify, last_logits, cur_len, pos_base, active, pad_id, hist,
                 rej, samp, generator, K: int, rounds: int, greedy_only: bool,
                 _reject_all: bool):
    """`rounds` speculative rounds for every slot: pending token, drafts,
    one verify pass verify(emb [N, K + 1, H], cos, sin, cur_len) -> hidden,
    acceptance, history. hist is updated in place. Returns (chunks [R, N,
    K + 1], commits [R, N], next pending logits, rejected drafts, cur_len),
    all on the device."""
    N = last_logits.shape[0]
    W = K + 1
    ar = torch.arange(W, device=last_logits.device)
    chunks, commits = [], []
    logits = last_logits
    for _ in range(rounds):
        tok0 = _spec_tok0(logits, generator, samp, active, pad_id, rej, greedy_only)
        chunk, drafts = _spec_draft(hist, tok0, cur_len, K, _reject_all)
        emb = embed_chunk(model, chunk)
        pos = (pos_base + cur_len)[:, None] + ar
        cos, sin = mrope_cos_sin(pos[None].expand(3, N, W), model.cfg, dtype=emb.dtype)
        logits_w = lm_head(model, verify(emb, cos, sin, cur_len)).float()   # [N, W, V]
        n_commit, logits, rej = _spec_accept(logits_w, drafts, logits, active, K, samp,
                                             generator, greedy_only)
        _spec_hist_update(hist, chunk, cur_len, n_commit)
        cur_len = cur_len + n_commit
        chunks.append(chunk)
        commits.append(n_commit)
    return torch.stack(chunks), torch.stack(commits), logits, rej, cur_len


def _decode_spec(model, cache: KVCache, last_logits, cur_len, pos_base, active, pad_id,
                 hist, rej, samp, generator, K: int, rounds: int = 1,
                 greedy_only: bool = False, _reject_all: bool = False):
    """Speculative rounds over the contiguous slot cache: each round's
    [N, K + 1] chunk is written at every slot's frontier (per-row writes)
    and attends over keys <= its position (plain attention). The caller
    guarantees cur_len + rounds (K + 1) fits the cache."""
    max_len = cache.k.shape[2]
    W = K + 1

    def verify(emb, cos, sin, cur):
        # an idle slot's junk chunk stays inside its row (its stale frontier
        # may sit within K + 1 of the end)
        cur = torch.where(active, cur, cur.clamp(max=max_len - W))
        j = torch.arange(max_len, device=emb.device)[None, None, :]
        i = torch.arange(W, device=emb.device)[None, :, None]
        bias = torch.where((j <= cur[:, None, None] + i)[:, None], 0.0, NEG_INF)
        return model.model(emb, cos, sin, bias, cache=cache, cache_position=cur,
                           attn_impl="xla")

    return _spec_rounds(model, verify, last_logits, cur_len, pos_base, active, pad_id, hist,
                        rej, samp, generator, K, rounds, greedy_only, _reject_all)


def _paged_decode_spec(model, kv, last_logits, cur_len, pos_base, active, pad_id, hist,
                       rej, samp, generator, page_tables, trash_page: int, K: int,
                       rounds: int = 1, page_size: int = 128, greedy_only: bool = False,
                       _reject_all: bool = False):
    """Speculative rounds over the paged pool: each round's chunk KV goes
    into the slots' pages at per-token (page, offset) coordinates (chunks
    may cross a page boundary; the caller allocates pages for the whole
    window), and one multi-query call of the paged kernel a layer verifies
    every chunk, causal within the chunk. page_tables sanitised as for
    _paged_decode_body."""
    W = K + 1
    max_pages = page_tables.shape[1]
    rows = torch.arange(last_logits.shape[0], device=last_logits.device)[:, None]

    def verify(emb, cos, sin, cur):
        tokpos = cur[:, None] + torch.arange(W, device=cur.device)
        pid = page_tables[rows, (tokpos // page_size).clamp(max=max_pages - 1)].long()
        pid = torch.where(active[:, None], pid, trash_page)
        return _paged_decoder_pass(model, kv, emb, cos, sin, pid, tokpos % page_size,
                                   page_tables, cur, page_size)

    return _spec_rounds(model, verify, last_logits, cur_len, pos_base, active, pad_id, hist,
                        rej, samp, generator, K, rounds, greedy_only, _reject_all)


def _copy_page(kv, src: int, dst: int) -> None:
    """Copy one page across the layer stack (copy-on-write of a forked
    prompt's partial last page); int8 pools copy their scale pages too."""
    for a in kv:
        a[:, :, dst] = a[:, :, src]


def _copy_slot_kv(cache: KVCache, src: int, dst: int) -> None:
    cache.k[:, dst] = cache.k[:, src]
    cache.v[:, dst] = cache.v[:, src]


@dataclass
class _Request:
    rid: int
    prompt_ids: np.ndarray
    position_ids: np.ndarray      # [3, 1, S]
    rope_delta: int               # max_pos + 1 - true_len
    max_new_tokens: int
    done_cb: Optional[Callable] = None
    tokens: list = field(default_factory=list)
    sp: Optional[SamplingParams] = None   # per-request sampling override
    tok_cb: Optional[Callable] = None     # streaming: called per (rid, token)


# ---------------------------------------------------------------------------
# Engines
# ---------------------------------------------------------------------------

class ContinuousEngine:
    """Slot-pool continuous batching over one model (contiguous KV)."""

    @torch.inference_mode()
    def __init__(self, model, num_slots: int = 8, max_len: int = 2048,
                 sp: SamplingParams | None = None, attn_impl: str = "xla",
                 prompt_buckets: tuple[int, ...] = (128, 256, 512, 1024, 2048),
                 embed_bucket: int = 256, seed: int = 0, spec_decode: int = 0,
                 prefill_chunk_tokens: int = 0, mesh=None, decode_window: int = 1):
        """The device is the model's. attn_impl: prefill attention, "flash",
        "xla" (plain) or "auto" (flash on a CUDA device). decode_window:
        tokens a step of `run_loop` decodes (`step(steps=decode_window)`;
        with spec_decode, verify rounds). spec_decode=K: K n-gram drafts a
        verify round. prefill_chunk_tokens=C: prompts longer than C prefill
        a chunk of C a step() (0: off)."""
        if mesh is not None:
            raise NotImplementedError("a mesh (sharded serving) is not ported to the "
                                      "PyTorch engine yet (ROADMAP Queue 1 #8)")
        if attn_impl not in ("xla", "flash", "auto"):
            raise ValueError(f"unknown attn_impl {attn_impl!r}")
        self.model = model
        self.cfg = cfg = model.cfg
        self.device = model.device
        if attn_impl == "auto":
            attn_impl = "flash" if self.device.type == "cuda" else "xla"
        self.attn_impl = attn_impl
        self.num_slots = num_slots
        self.max_len = max_len
        self.decode_window = decode_window
        self.spec_decode = spec_decode
        self.prefill_chunk_tokens = prefill_chunk_tokens
        self._pending_prefill: list[dict] = []   # chunked prefills, oldest first
        self.embed_bucket = embed_bucket   # vision embeds pad to multiples of this
        self.sp = sp or SamplingParams(
            max_new_tokens=max_len, eos_token_ids=(cfg.eos_token_id,),
            pad_token_id=cfg.pad_token_id)
        self.prompt_buckets = tuple(sorted(b for b in prompt_buckets if b <= max_len))
        self._init_cache(model.model.embed_tokens.embedding.dtype)
        self.hist = self._spec_rej = None
        if spec_decode:
            # each slot's [prompt | tokens] (drafting reads it on the device),
            # over self.max_len (the paged engine rounds it to pages)
            self.hist = torch.full((num_slots, self.max_len + spec_decode + 2),
                                   self.sp.pad_token_id, dtype=torch.long,
                                   device=self.device)
            # a sampled slot's draft rejected at its frontier (-1: none): its
            # next pending token samples from the residual without it
            self._spec_rej = torch.full((num_slots,), -1, dtype=torch.long,
                                        device=self.device)
        # committed tokens against verify rounds (acceptance = tokens a
        # round a slot - 1) and spec against plain dispatches: K's tuning signal
        self.spec_stats = {"spec_dispatches": 0, "spec_rounds": 0, "spec_tokens": 0,
                           "plain_dispatches": 0}
        self._spec_reject_all = False   # profiling: the zero-acceptance verify floor
        self.last_logits = torch.zeros((num_slots, cfg.text.vocab_size),
                                       dtype=torch.float32, device=self.device)
        self.cur_len = np.zeros((num_slots,), np.int32)
        self.pos_base = np.zeros((num_slots,), np.int32)
        self.budget = np.zeros((num_slots,), np.int32)   # remaining new tokens
        self.slot_temp = np.ones((num_slots,), np.float32)
        self.slot_top_p = np.ones((num_slots,), np.float32)
        self.slot_top_k = np.zeros((num_slots,), np.int32)
        self.slot_do_sample = np.zeros((num_slots,), bool)
        self.slot_req: list[Optional[_Request]] = [None] * num_slots
        self.prefilling = np.zeros((num_slots,), bool)   # chunked prefill in flight
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        self._next_rid = 0
        # rids whose callers gave up; step() finishes them with their tokens
        self._cancel_rids: set[int] = set()
        # run_loop's admissions by route, and the requests it answered empty
        # because their admission raised
        self.loop_stats = {"packed": 0, "batch": 0, "single": 0, "failed": 0}

    def _t(self, x, dtype=torch.long) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=self.device)

    def _pad_embeds(self, embeds) -> torch.Tensor:
        """Vision embeds [n, H] on the device, padded to the embed bucket."""
        embeds = torch.as_tensor(embeds, device=self.device)
        n = embeds.shape[0]
        nb = -(-n // self.embed_bucket) * self.embed_bucket
        return F.pad(embeds, (0, 0, 0, nb - n))

    def _prompt_plan(self, prompt_ids, max_new_tokens, multimodal: bool) -> np.ndarray:
        """Prompt ids, left-truncated so prompt + generation fit a slot."""
        ids = np.asarray(prompt_ids, np.int32)
        room = max(self.max_len - max_new_tokens - 1, 8)
        if ids.shape[0] > room:
            if multimodal:
                # truncation would sever the token/feature invariant
                raise ValueError(
                    f"multimodal prompt of {ids.shape[0]} tokens exceeds slot "
                    f"room {room}; raise max_len or reduce frames")
            ids = ids[-room:]
        return ids

    def _bucket(self, n: int) -> int:
        return next((b for b in self.prompt_buckets if b >= n), self.max_len)

    def _rope(self, padded, lens, video_grid_thw=None, second_per_grid_ts=None):
        mask = (np.arange(padded.shape[1])[None, :] < np.asarray(lens)[:, None])
        return get_rope_index(
            padded, self.cfg,
            video_grid_thw=(np.asarray(video_grid_thw)
                            if video_grid_thw is not None else None),
            second_per_grid_ts=(np.asarray(second_per_grid_ts)
                                if second_per_grid_ts is not None else None),
            attention_mask=mask.astype(np.int64))

    def _occupy(self, slot: int, req: _Request, true_len: int, logits=None) -> None:
        """Bind an admitted request to its slot."""
        if logits is not None:
            self.last_logits[slot] = logits
        self.cur_len[slot] = true_len
        # decode position = cur_len + pos_base = max_pos + 1 + step
        self.pos_base[slot] = req.rope_delta
        self.budget[slot] = req.max_new_tokens
        rsp = req.sp or self.sp
        self.slot_temp[slot] = max(rsp.temperature, 1e-6)
        self.slot_top_p[slot] = rsp.top_p
        self.slot_top_k[slot] = rsp.top_k
        self.slot_do_sample[slot] = rsp.do_sample
        self.slot_req[slot] = req
        if self.hist is not None:
            # the slot's drafting history starts as [prompt | pad ...] (every
            # admission comes here, so drafting never reads an earlier
            # occupant's tokens); its tokens extend it at the frontier
            self.hist[slot] = self.sp.pad_token_id
            self.hist[slot, :true_len] = self._t(np.asarray(req.prompt_ids)[0, :true_len])
            self._spec_rej[slot] = -1

    def _new_rid(self) -> int:
        rid = self._next_rid
        self._next_rid += 1
        return rid

    # -- request lifecycle -------------------------------------------------
    @torch.inference_mode()
    def submit(self, prompt_ids: list[int], max_new_tokens: int = 128,
               done_cb: Callable | None = None, sp: SamplingParams | None = None,
               vision_embeds=None, video_grid_thw=None, second_per_grid_ts=None,
               tok_cb: Callable | None = None) -> Optional[int]:
        """Admit into a free slot; returns the request id, or None when the
        pool is full. Multimodal requests pass merged ViT outputs as
        vision_embeds [N, H] plus the video grids for M-RoPE (the prompt
        already holds the matching <|video_pad|> run)."""
        slot = next((i for i, r in enumerate(self.slot_req) if r is None), None)
        if slot is None:
            return None
        ids = self._prompt_plan(prompt_ids, max_new_tokens, vision_embeds is not None)
        true_len = ids.shape[0]
        bucket = self._bucket(true_len)
        padded = np.full((1, bucket), self.cfg.pad_token_id, np.int32)
        padded[0, :true_len] = ids
        pos, deltas = self._rope(padded, [true_len], video_grid_thw, second_per_grid_ts)
        embeds = self._pad_embeds(vision_embeds) if vision_embeds is not None else None
        req = _Request(self._new_rid(), padded, pos, int(deltas[0, 0]) + bucket - true_len,
                       max_new_tokens, done_cb, sp=sp, tok_cb=tok_cb)
        logits = self._prefill_slot(slot, padded, pos, true_len, embeds)
        self._occupy(slot, req, true_len, logits)
        return req.rid

    @property
    def num_active(self) -> int:
        return sum(r is not None for r in self.slot_req)

    @torch.inference_mode()
    def fork(self, rid: int, n: int = 1) -> list[int]:
        """Clone a just-prefilled request into up to `n` free slots, reusing
        its prompt KV (the paged engine shares the prompt pages with
        copy-on-write on the partial last page; the contiguous engine copies
        the slot rows). GRPO's G rollouts per prompt prefill once. Only valid
        before the source decodes its first token."""
        src = next((i for i, r in enumerate(self.slot_req)
                    if r is not None and r.rid == rid), None)
        if src is None:
            raise ValueError(f"unknown or finished request {rid}")
        req = self.slot_req[src]
        if req.tokens:
            raise ValueError("fork requires an un-decoded source request")
        if self.prefilling[src]:
            raise ValueError("cannot fork a request whose chunked prefill is still in "
                             "flight (partial KV); wait for admission to complete")
        out = []
        for _ in range(n):
            slot = next((i for i, r in enumerate(self.slot_req) if r is None), None)
            if slot is None:
                break
            self._fork_kv(src, slot)
            self.slot_req[slot] = _Request(
                self._new_rid(), req.prompt_ids, req.position_ids, req.rope_delta,
                req.max_new_tokens, None, sp=req.sp)
            self.last_logits[slot] = self.last_logits[src]
            if self.hist is not None:
                self.hist[slot] = self.hist[src]
                self._spec_rej[slot] = self._spec_rej[src]
            for arr in (self.cur_len, self.pos_base, self.budget, self.slot_temp,
                        self.slot_top_p, self.slot_top_k, self.slot_do_sample):
                arr[slot] = arr[src]
            out.append(self.slot_req[slot].rid)
        return out

    @torch.inference_mode()
    def step(self, steps: int = 1) -> list[tuple[int, list[int]]]:
        """Decode a window of up to `steps` tokens for all active slots;
        returns the finished (rid, tokens) pairs. The window is clamped to a
        power of two that fits every active slot's remaining room; tokens a
        slot generates past its EOS or budget inside the window are
        discarded."""
        if self.num_active == 0:
            return []
        finished_early = self._apply_cancels()
        self._advance_prefill()          # chunked prefill: one chunk a step()
        active = np.asarray([r is not None for r in self.slot_req]) & ~self.prefilling
        if not active.any():
            return finished_early
        start_len = self.cur_len.copy()
        room = int(min(self.max_len - 1 - self.cur_len[s]
                       for s in range(self.num_slots) if active[s]))
        K = self.spec_decode
        # spec only while a full window of rounds fits every slot's room
        if K and (room - 1) // (K + 1) >= steps and self._spec_ready(active, steps):
            return finished_early + self._step_spec(active, steps)
        if K and bool((self._spec_rej[self._t(active, torch.bool)] >= 0).any()):
            # a sampled slot's rejected draft is pending from the last spec
            # dispatch, and the plain sampler would ignore the residual mask:
            # consume it by one verify round, or (no room or no pages, only
            # within K + 1 tokens of the cap) mask the token in the raw
            # pending logits and clear the state
            if room > K + 1 and self._spec_ready(active, 1):
                return finished_early + self._step_spec(active, 1)
            self.last_logits = reject_mask(self.last_logits, self._spec_rej)
            self._spec_rej.fill_(-1)
        w = 1
        while w * 2 <= min(steps, max(room, 1)):
            w *= 2
        if K:
            self.spec_stats["plain_dispatches"] += 1
        toks = self._decode_all(active, w)                  # [w, N] on the host
        self.cur_len = np.where(active, start_len + w, start_len).astype(np.int32)

        finished = []
        done = [False] * self.num_slots
        for si in range(toks.shape[0]):
            for slot, req in enumerate(self.slot_req):
                if req is None or done[slot] or not active[slot]:
                    continue        # inactive: mid-chunked-prefill, its tokens are pad
                t = int(toks[si, slot])
                req.tokens.append(t)
                if req.tok_cb:
                    req.tok_cb(req.rid, t)
                self.budget[slot] -= 1
                hit_eos = t in (req.sp or self.sp).eos_token_ids
                out_of_room = start_len[slot] + si + 1 >= self.max_len - 1
                if hit_eos or self.budget[slot] <= 0 or out_of_room:
                    finished.append((req.rid, list(req.tokens)))
                    if req.done_cb:
                        req.done_cb(req.rid, list(req.tokens))
                    done[slot] = True
        for slot, d in enumerate(done):
            if d:
                self.slot_req[slot] = None
                self._release_slot(slot)
        return finished_early + finished

    def _step_spec(self, active, steps: int) -> list[tuple[int, list[int]]]:
        """One dispatch of `steps` verify rounds for the active slots; each
        round commits 1 + accepted tokens a slot. The caller guarantees the
        whole window fits every slot's room. Same finish bookkeeping as
        step()."""
        chunks, commits = self._spec_dispatch(active, steps)   # [R, N, W], [R, N]
        self.spec_stats["spec_dispatches"] += 1
        self.spec_stats["spec_rounds"] += int(commits.shape[0])
        self.spec_stats["spec_tokens"] += int(commits.sum())
        finished = []
        done = [False] * self.num_slots
        for ri in range(chunks.shape[0]):
            for slot, req in enumerate(self.slot_req):
                if req is None or done[slot] or not active[slot]:
                    continue
                rsp = req.sp or self.sp
                for i in range(int(commits[ri, slot])):
                    t = int(chunks[ri, slot, i])
                    req.tokens.append(t)
                    if req.tok_cb:
                        req.tok_cb(req.rid, t)
                    self.budget[slot] -= 1
                    out_of_room = self.cur_len[slot] >= self.max_len - 1
                    if t in rsp.eos_token_ids or self.budget[slot] <= 0 or out_of_room:
                        finished.append((req.rid, list(req.tokens)))
                        if req.done_cb:
                            req.done_cb(req.rid, list(req.tokens))
                        done[slot] = True
                        break       # later tokens and rounds past the end: dropped
        for slot, d in enumerate(done):
            if d:
                self.slot_req[slot] = None
                self._release_slot(slot)
        return finished

    def _spec_args(self, active) -> tuple:
        """The dispatch's device state: (last logits, cur_len, pos_base,
        active, pad id, history, rejected drafts, sampling, generator)."""
        samp, _ = self._sampling(active)
        return (self.last_logits, self._t(self.cur_len), self._t(self.pos_base),
                self._t(active, torch.bool), self.sp.pad_token_id, self.hist,
                self._spec_rej, samp, self._gen)

    def _spec_finish(self, out) -> tuple[np.ndarray, np.ndarray]:
        """Keep a dispatch's device state; its chunks and commits to the host
        (the dispatch's one sync)."""
        chunks, commits, self.last_logits, self._spec_rej, new_len = out
        self.cur_len = new_len.cpu().numpy().astype(np.int32)
        return chunks.cpu().numpy(), commits.cpu().numpy()

    def request_cancel(self, rid: int) -> None:
        """Mark a request for cancellation (client disconnect, stop string):
        the next step() finishes it with its tokens so far and frees its slot."""
        self._cancel_rids.add(rid)

    def _apply_cancels(self) -> list[tuple[int, list[int]]]:
        """Finish cancelled slots; a slot still in its chunked prefill is
        deferred (its rid stays marked) until the prefill completes."""
        if not self._cancel_rids:
            return []
        # self-clean: requests that already finished normally
        self._cancel_rids &= {r.rid for r in self.slot_req if r is not None}
        finished = []
        for slot, req in enumerate(self.slot_req):
            if req is None or req.rid not in self._cancel_rids or self.prefilling[slot]:
                continue
            self._cancel_rids.discard(req.rid)
            finished.append((req.rid, list(req.tokens)))
            if req.done_cb:
                req.done_cb(req.rid, list(req.tokens))
            self.slot_req[slot] = None
            self._release_slot(slot)
        return finished

    @torch.inference_mode()
    def run_loop(self, request_queue: "queue.Queue", stop: threading.Event,
                 idle_sleep: float = 0.005, admit_per_step: int = 1):
        """The server loop (run it on its own thread): admit and decode
        until `stop` is set. Grad mode is thread-local, so the loop enters
        inference mode itself."""
        return _run_loop_impl(self, request_queue, stop, idle_sleep,
                              admit_per_step=admit_per_step)

    # -- KV-layout hooks (contiguous implementation) ------------------------
    def _init_cache(self, dtype) -> None:
        self.cache = KVCache.init(self.cfg.text, self.num_slots, self.max_len, dtype,
                                  self.device)

    def _prefill_slot(self, slot, padded, pos, true_len, vision_embeds=None):
        ck = self.prefill_chunk_tokens
        if ck and vision_embeds is None and true_len > ck:
            # chunked: step() prefills a chunk a call, between decode windows
            self._defer_prefill(slot, padded, pos, true_len)
            return None
        return _prefill_into_slot(self.model, self.cache, slot, self._t(padded),
                                  self._t(pos), self._t([true_len], torch.int32),
                                  vision_embeds, self.attn_impl)

    def _defer_prefill(self, slot, padded, pos, true_len, **extra) -> None:
        self._pending_prefill.append({"slot": slot, "padded": np.asarray(padded),
                                      "pos": np.asarray(pos), "true_len": int(true_len),
                                      "done": 0, **extra})
        self.prefilling[slot] = True

    def _advance_prefill(self) -> None:
        """Chunked prefill: the oldest pending prompt by one chunk."""
        if not self._pending_prefill:
            return
        st = self._pending_prefill[0]
        start = st["done"]
        end = min(start + self.prefill_chunk_tokens, st["padded"].shape[1])
        logits = _prefill_slot_chunk(self.model, self.cache, st["slot"],
                                     self._t(st["padded"][:, start:end]),
                                     self._t(st["pos"][:, :, start:end]), start,
                                     st["true_len"])
        self._chunk_done(st, end, logits)

    def _chunk_done(self, st, end: int, logits) -> None:
        st["done"] = end
        if end >= st["true_len"]:      # what is left of the bucket is pad
            self.last_logits[st["slot"]] = logits
            self.prefilling[st["slot"]] = False
            self._pending_prefill.pop(0)

    def _spec_ready(self, active, steps: int) -> bool:
        return True      # the contiguous cache holds max_len for every slot

    def _spec_dispatch(self, active, rounds: int):
        return self._spec_finish(_decode_spec(
            self.model, self.cache, *self._spec_args(active), self.spec_decode, rounds,
            greedy_only=not self.slot_do_sample[active].any(),
            _reject_all=self._spec_reject_all))

    def _sampling(self, active):
        """(per-slot sampling tensors or None, greedy_only) for a decode window."""
        if not self.slot_do_sample[active].any():
            return None, True
        return (self._t(self.slot_temp, torch.float32), self._t(self.slot_top_p,
                                                                torch.float32),
                self._t(self.slot_top_k), self._t(self.slot_do_sample, torch.bool)), False

    def _decode_all(self, active, steps: int) -> np.ndarray:
        samp, greedy_only = self._sampling(active)
        toks, self.last_logits, _ = _decode_multi(
            self.model, self.cache, self.sp, self.last_logits, self._t(self.cur_len),
            self._t(self.pos_base), self._t(active, torch.bool), samp, self._gen,
            steps, greedy_only)
        return toks.cpu().numpy()

    def _release_slot(self, slot: int) -> None:
        pass

    def _fork_kv(self, src: int, dst: int) -> None:
        _copy_slot_kv(self.cache, src, dst)


class PagedContinuousEngine(ContinuousEngine):
    """Continuous batching over the paged KV pool: pages are allocated at
    admission and on demand while decoding, and finished slots return
    theirs at once (to the free list, or to the prefix cache's LRU pool)."""

    def __init__(self, model, *args, page_size: int = 128,
                 num_pages: int | None = None, prefill_token_budget: int = 8192,
                 kv_quant: str | None = None, prefix_cache: bool = True, **kwargs):
        """page_size: tokens per page (the CUDA kernel takes 64 and 128).
        num_pages: pool size, default every slot at max_len plus the trash
        page. prefill_token_budget: tokens prefilled per batched admission
        pass. kv_quant="int8": int8 pages with per-(token, head) scales.
        prefix_cache: the automatic prefix cache of full prompt pages."""
        if kv_quant not in (None, "int8"):
            raise ValueError(f"kv_quant must be None or 'int8', got {kv_quant!r}")
        self._page_size = page_size
        self._num_pages = num_pages
        self.kv_quant = kv_quant
        self.prefix_cache = prefix_cache
        self._media_key = None   # threaded from submit() into _prefill_slot
        self.prefill_token_budget = prefill_token_budget
        super().__init__(model, *args, **kwargs)
        # page-aligned chunks: later chunks ride the suffix prefill, whose KV
        # scatter is a page at a time
        if self.prefill_chunk_tokens:
            self.prefill_chunk_tokens = -(-self.prefill_chunk_tokens // page_size) * page_size
        # buckets must be page-aligned for the prompt scatter
        self.prompt_buckets = tuple(b for b in self.prompt_buckets
                                    if b % page_size == 0) or (self.max_len,)

    def _init_cache(self, dtype) -> None:
        ps = self._page_size
        if self.device.type == "cuda":
            check_kernel_sizes(self.cfg.text.head_dim, ps, dtype)
        # page-align max_len: the bucket fallback and the prompt scatter need it
        self.max_len = -(-self.max_len // ps) * ps
        max_pages = self.max_len // ps
        num_pages = self._num_pages or self.num_slots * max_pages + 1
        self.pcache = PagedKVCache.create(
            self.cfg.text.num_hidden_layers, num_pages, ps,
            self.cfg.text.num_key_value_heads, self.cfg.text.head_dim,
            self.num_slots, max_pages, dtype=dtype,
            quantized=self.kv_quant == "int8", device=self.device)
        # one page is the write sink of inactive slots
        self.trash_page = self.pcache.free_pages.pop()

    def _kv(self) -> tuple:
        pc = self.pcache
        return ((pc.k, pc.v, pc.k_scale, pc.v_scale) if pc.quantized
                else (pc.k, pc.v))

    def _vision_ids(self) -> tuple[int, int]:
        return (self.cfg.image_token_id, self.cfg.video_token_id)

    def _free(self, pages) -> None:
        """Return pages that no slot references to the free list."""
        for pg in pages:
            self.pcache.refcount[int(pg)] = 0
            self.pcache.free_pages.append(int(pg))

    def prefix_match_len(self, prompt_ids, media_key=None) -> int:
        """Peek (no acquisition): how many prompt TOKENS are prefix-cached."""
        if not self.prefix_cache:
            return 0
        ids = np.asarray(prompt_ids, np.int32)
        hashes = _prefix_page_hashes(ids, self._page_size, self._vision_ids(),
                                     media_key)
        m = 0
        for h in hashes[:max(0, (ids.shape[0] - 1) // self._page_size)]:
            if h not in self.pcache.hash_to_page:
                break
            m += 1
        return m * self._page_size

    def _register_prefix(self, ids: np.ndarray, pids, media_key=None) -> None:
        """Register a just-prefilled prompt's FULL pages in the prefix cache.
        ids: the true (unpadded) prompt tokens; pids: its page ids in order."""
        if not self.prefix_cache:
            return
        ps = self._page_size
        hashes = _prefix_page_hashes(np.asarray(ids, np.int32), ps, self._vision_ids(),
                                     media_key)
        n_full = min(len(hashes), len(ids) // ps)
        self.pcache.cache_pages(hashes[:n_full], [int(p) for p in pids[:n_full]])

    @torch.inference_mode()
    def submit(self, prompt_ids, max_new_tokens: int = 128,
               done_cb: Callable | None = None, sp: SamplingParams | None = None,
               vision_embeds=None, video_grid_thw=None, second_per_grid_ts=None,
               tok_cb: Callable | None = None, media_key=None) -> Optional[int]:
        """Tries the prefix cache first (prefill only the un-cached suffix),
        then falls through to the whole-prompt prefill. `media_key`
        identifies vision CONTENT so multimodal prefixes can share; without
        it sharing stops at the first vision token."""
        if self.prefix_cache:
            rid = self._try_prefix_admit(
                prompt_ids, max_new_tokens, done_cb, sp, tok_cb,
                vision_embeds=vision_embeds, video_grid_thw=video_grid_thw,
                second_per_grid_ts=second_per_grid_ts, media_key=media_key)
            if rid is not None:
                return rid
        self._media_key = media_key
        try:
            return super().submit(prompt_ids, max_new_tokens, done_cb, sp=sp,
                                  vision_embeds=vision_embeds,
                                  video_grid_thw=video_grid_thw,
                                  second_per_grid_ts=second_per_grid_ts, tok_cb=tok_cb)
        finally:
            self._media_key = None

    def _try_prefix_admit(self, prompt_ids, max_new_tokens, done_cb, sp, tok_cb,
                          vision_embeds=None, video_grid_thw=None,
                          second_per_grid_ts=None, media_key=None) -> Optional[int]:
        """Admit through the prefix cache when at least one full page of the
        prompt's KV is pooled: acquire the cached run, prefill only the
        suffix, extend the cached chain with the newly full pages. Returns
        None (nothing acquired) when there is no slot, no match or no room."""
        slot = next((i for i, r in enumerate(self.slot_req) if r is None), None)
        if slot is None:
            return None
        pc, ps = self.pcache, self._page_size
        ids = self._prompt_plan(prompt_ids, max_new_tokens, vision_embeds is not None)
        true_len = ids.shape[0]
        hashes = _prefix_page_hashes(ids, ps, self._vision_ids(), media_key)
        matched = pc.match_pages(hashes[:(true_len - 1) // ps])
        m = len(matched)
        if m == 0:
            return None
        k = m * ps
        suf_bucket = self._bucket(true_len - k)   # the dispatch covers the tail only
        bucket = max(self._bucket(true_len), k + suf_bucket)
        n_new = suf_bucket // ps
        if pc.available_pages() < n_new:
            pc.release_pages([int(p) for p in matched])
            return None
        padded = np.full((1, bucket), self.cfg.pad_token_id, np.int32)
        padded[0, :true_len] = ids
        pos, deltas = self._rope(padded, [true_len], video_grid_thw, second_per_grid_ts)
        embeds = None
        if vision_embeds is not None and bool(np.isin(ids[k:], self._vision_ids()).any()):
            # suffix rows of the merge = embeds past the prefix's vision run
            n_pre = int(np.isin(ids[:k], self._vision_ids()).sum())
            embeds = self._pad_embeds(torch.as_tensor(vision_embeds)[n_pre:])
        new_pids = [pc._alloc() for _ in range(n_new)]
        m_pad = 1
        while m_pad < m:
            m_pad *= 2
        pref = np.full((m_pad,), self.trash_page, np.int32)
        pref[:m] = matched
        try:
            logits = _prefill_suffix_into_pages(
                self.model, self._kv(), self._t(pref), self._t(new_pids),
                self._t(padded[:, k:k + suf_bucket]), self._t(pos[:, :, k:k + suf_bucket]),
                self._t([k]), self._t([true_len - k]), embeds, ps)
        except Exception:
            pc.release_pages([int(p) for p in matched])
            self._free(new_pids)
            raise
        np_used = -(-true_len // ps)
        pc.page_tables[slot] = -1
        pc.page_tables[slot, :m] = matched
        pc.page_tables[slot, m:np_used] = new_pids[:np_used - m]
        self._free(new_pids[np_used - m:])
        pc.lengths[slot] = true_len
        self._register_prefix(ids, list(matched) + [int(p) for p in new_pids],
                              media_key=media_key)
        req = _Request(self._new_rid(), padded, pos, int(deltas[0, 0]) + bucket - true_len,
                       max_new_tokens, done_cb, sp=sp, tok_cb=tok_cb)
        self._occupy(slot, req, true_len, logits)
        return req.rid

    def _prefill_slot(self, slot, padded, pos, true_len, vision_embeds=None):
        pc, ps = self.pcache, self._page_size
        np_all = padded.shape[1] // ps
        if pc.available_pages() < np_all:
            raise RuntimeError("paged KV cache out of pages")
        pids = [pc._alloc() for _ in range(np_all)]  # refcount 1 each
        ck = self.prefill_chunk_tokens
        if ck and true_len > ck:
            # chunked: every page now, the prefill a chunk a step(); a video
            # prompt's chunks take their slices of the merged embeds
            self._defer_prefill(slot, padded, pos, true_len, pids=pids,
                                embeds=vision_embeds, media_key=self._media_key)
            return None
        logits = _prefill_into_pages(
            self.model, self._kv(), self._t(pids), self._t(padded), self._t(pos),
            self._t([true_len], torch.int32), vision_embeds, self.attn_impl, ps)
        self._finish_prompt_pages(slot, pids, true_len, np.asarray(padded)[0, :true_len],
                                  media_key=self._media_key)
        return logits

    def _finish_prompt_pages(self, slot, pids, true_len, ids, media_key=None) -> None:
        """Point the slot at its prompt's pages, return the surplus to the
        free list, and register the prompt in the prefix cache."""
        pc, ps = self.pcache, self._page_size
        np_used = -(-int(true_len) // ps)
        pc.page_tables[slot] = -1
        pc.page_tables[slot, :np_used] = pids[:np_used]
        self._free(pids[np_used:])
        pc.lengths[slot] = true_len
        self._register_prefix(ids, pids[:np_used], media_key=media_key)

    def _advance_prefill(self) -> None:
        """The oldest pending prompt by one page-aligned chunk: the first
        through the whole-prompt prefill (flash), each later one through the
        suffix prefill over the pages written so far."""
        if not self._pending_prefill:
            return
        st = self._pending_prefill[0]
        ps, pids = self._page_size, st["pids"]
        start, true_len = st["done"], st["true_len"]
        end = min(start + self.prefill_chunk_tokens, st["padded"].shape[1])
        new = self._t(pids[start // ps:-(-end // ps)])
        ids_c = self._t(st["padded"][:, start:end])
        pos_c = self._t(st["pos"][:, :, start:end])
        embeds_c = None
        if st["embeds"] is not None:
            vis = np.isin(st["padded"][0], self._vision_ids())
            n_pre, n_in = int(vis[:start].sum()), int(vis[start:end].sum())
            if n_in:
                embeds_c = self._pad_embeds(st["embeds"][n_pre:n_pre + n_in])
        if start == 0:
            logits = _prefill_into_pages(
                self.model, self._kv(), new, ids_c, pos_c,
                self._t([min(true_len, end)], torch.int32), embeds_c, self.attn_impl, ps)
        else:
            m = start // ps
            m_pad = 1
            while m_pad < m:
                m_pad *= 2
            pref = np.full((m_pad,), self.trash_page, np.int32)
            pref[:m] = pids[:m]
            logits = _prefill_suffix_into_pages(
                self.model, self._kv(), self._t(pref), new, ids_c, pos_c, self._t([start]),
                self._t([min(true_len, end) - start]), embeds_c, ps)
        if end >= true_len:
            self._finish_prompt_pages(st["slot"], pids, true_len,
                                      st["padded"][0, :true_len], media_key=st["media_key"])
        self._chunk_done(st, end, logits)

    def _spec_ready(self, active, steps: int) -> bool:
        """Pages for the whole verify window (rounds x (K + 1) tokens an
        active slot) must be there up front; else plain decode."""
        pc, ps = self.pcache, self._page_size
        span = steps * (self.spec_decode + 1)
        need = sum(max(0, -(-(int(self.cur_len[s]) + span) // ps)
                       - int((pc.page_tables[s] >= 0).sum()))
                   for s in np.flatnonzero(active))
        return pc.available_pages() >= need

    def _spec_dispatch(self, active, rounds: int):
        pc = self.pcache
        pc.lengths[:] = self.cur_len
        for slot in np.flatnonzero(active):
            pc.ensure_capacity(int(slot), rounds * (self.spec_decode + 1))
        tables = np.where(pc.page_tables >= 0, pc.page_tables, self.trash_page)
        return self._spec_finish(_paged_decode_spec(
            self.model, self._kv(), *self._spec_args(active), self._t(tables, torch.int32),
            self.trash_page, self.spec_decode, rounds, self._page_size,
            greedy_only=not self.slot_do_sample[active].any(),
            _reject_all=self._spec_reject_all))

    def _decode_all(self, active, steps: int) -> np.ndarray:
        pc = self.pcache
        pc.lengths[:] = self.cur_len
        for slot in np.flatnonzero(active):
            pc.ensure_capacity(int(slot), steps)
        tables = np.where(pc.page_tables >= 0, pc.page_tables, self.trash_page)
        samp, greedy_only = self._sampling(active)
        toks, self.last_logits, _ = _paged_decode_multi(
            self.model, self._kv(), self.sp, self.last_logits, self._t(self.cur_len),
            self._t(self.pos_base), self._t(active, torch.bool),
            self._t(tables, torch.int32), self.trash_page, samp, self._gen,
            self._page_size, steps, greedy_only)
        return toks.cpu().numpy()

    @torch.inference_mode()
    def submit_batch(self, items: list) -> list:
        """Admit a BURST of requests, prefilling same-bucket groups in one
        pass each. items: (prompt_ids, max_new_tokens[, done_cb[, sp[,
        tok_cb[, vision]]]]) tuples, where `vision` is an optional
        (vision_embeds, video_grid_thw, second_per_grid_ts) triple. Returns
        rids aligned with items (None = no slot or no pages)."""
        rids: list = [None] * len(items)
        groups: dict[int, list] = {}
        for n, it in enumerate(items):
            prompt_ids, mnt = it[0], it[1]
            cb, spr, tok_cb, vision = (tuple(it[2:6]) + (None,) * 4)[:4]
            if self.prefix_cache and self.prefix_match_len(prompt_ids) > 0:
                # prefix-cache hit: the per-item suffix prefill recomputes
                # less than the batched whole prefill saves in passes
                ve, gr, spg = vision if vision is not None else (None,) * 3
                rid = self._try_prefix_admit(prompt_ids, mnt, cb, spr, tok_cb,
                                             vision_embeds=ve, video_grid_thw=gr,
                                             second_per_grid_ts=spg)
                if rid is not None:
                    rids[n] = rid
                    continue
            ids = self._prompt_plan(prompt_ids, mnt, vision is not None)
            groups.setdefault(self._bucket(ids.shape[0]), []).append(
                (n, ids, mnt, cb, spr, tok_cb, vision))

        pc, ps = self.pcache, self._page_size
        for bucket, rows in groups.items():
            # rows per pass: free slots and the prefill token budget
            max_rows = max(1, self.prefill_token_budget // max(bucket, 1))
            while rows:
                free = [i for i, r in enumerate(self.slot_req) if r is None]
                if not free:
                    break
                take = min(len(free), max_rows)
                chunk, rows = rows[:take], rows[take:]
                K = len(chunk)
                # K padded to a power of two with trash-page rows (the JAX
                # package's compile granularity, kept for like-for-like passes)
                Kp = 1
                while Kp < K:
                    Kp *= 2
                padded = np.full((Kp, bucket), self.cfg.pad_token_id, np.int32)
                lens = np.ones(Kp, np.int32)
                for r, (_, ids, *_rest) in enumerate(chunk):
                    padded[r, :ids.shape[0]] = ids
                    lens[r] = ids.shape[0]
                # multimodal rows: grids / spg consumed row by row by M-RoPE,
                # embeds concatenated in the same row order for the merge
                grids, spgs, embs = [], [], []
                for *_head, vision in chunk:
                    if vision is None:
                        continue
                    vemb, vgrids, vspg = vision
                    embs.append(torch.as_tensor(vemb, device=self.device))
                    grids.extend(vgrids)
                    spgs.extend(vspg if vspg is not None else [1.0] * len(vgrids))
                embeds = self._pad_embeds(torch.cat(embs)) if embs else None
                pos, deltas = self._rope(padded, lens, grids or None, spgs or None)
                np_all = bucket // ps
                if pc.available_pages() < K * np_all:
                    # no pages for this bucket's chunk: a smaller bucket may fit
                    break
                pids = np.full((Kp, np_all), self.trash_page, np.int32)
                for r in range(K):
                    for c in range(np_all):
                        pids[r, c] = pc._alloc()
                try:
                    logits = _prefill_into_pages_batch(
                        self.model, self._kv(), self._t(pids), self._t(padded),
                        self._t(pos), self._t(lens, torch.int32), embeds,
                        self.attn_impl, ps)
                except Exception:
                    # unwind this chunk's pages (no slot references them yet);
                    # when earlier chunks are committed to slots, return the
                    # partial result (raising would lose their rids)
                    self._free(pids[:K].reshape(-1))
                    if all(r is None for r in rids):
                        raise
                    _log.exception("submit_batch: a prefill pass failed; returning "
                                   "the requests admitted before it")
                    return rids
                for r, (n, ids, mnt, cb, spr, tok_cb, _vis) in enumerate(chunk):
                    slot = free[r]
                    true_len = int(lens[r])
                    np_used = -(-true_len // ps)
                    pc.page_tables[slot] = -1
                    pc.page_tables[slot, :np_used] = pids[r, :np_used]
                    self._free(pids[r, np_used:])
                    pc.lengths[slot] = true_len
                    self._register_prefix(ids, pids[r, :np_used])
                    req = _Request(self._new_rid(), padded[r:r + 1], pos[:, r:r + 1],
                                   int(deltas[r, 0]) + bucket - true_len, mnt, cb,
                                   sp=spr, tok_cb=tok_cb)
                    self._occupy(slot, req, true_len)
                    rids[n] = req.rid
                self.last_logits[self._t(free[:K])] = logits[:K]
        return rids

    @torch.inference_mode()
    def submit_packed(self, items: list, row_width: int | None = None) -> list:
        """Admit a burst of SHORT TEXT prompts with sequence-packed prefill:
        each prompt takes a page-aligned span inside shared rows of
        `row_width` (default the top prompt bucket), masked from its
        neighbours by segment ids, and the whole burst prefills in one pass.

        items: (prompt_ids, max_new_tokens[, done_cb[, sp[, tok_cb]]]).
        Returns rids aligned with items (None = too long to pack, or no free
        slot, budget or pages: the caller retries or routes it through
        submit_batch). A failed prefill returns the burst's pages and raises."""
        rids: list = [None] * len(items)
        pc, ps = self.pcache, self._page_size
        width = row_width or max(self.prompt_buckets)
        entries = []
        for n, it in enumerate(items):
            if len(it) > 5 and it[5] is not None:
                # packing is text-only: dropping the vision triple would
                # prefill <|video_pad|> runs as raw pad embeddings
                raise ValueError("submit_packed is text-only; route multimodal items "
                                 "through submit_batch")
            ids = self._prompt_plan(it[0], it[1], multimodal=False)
            span = -(-ids.shape[0] // ps) * ps
            if span > width:
                continue
            cb, spr, tok_cb = (tuple(it[2:5]) + (None,) * 3)[:3]
            entries.append((n, ids, it[1], cb, spr, tok_cb, span))
        free = [i for i, r in enumerate(self.slot_req) if r is None]
        entries = entries[:len(free)]
        # the prefill token budget: drop trailing entries until the packed
        # rows fit one pass; callers retry the Nones
        while entries and sum(e[6] for e in entries) + width > self.prefill_token_budget:
            entries.pop()
        need_pages = sum(e[6] // ps for e in entries)
        while entries and pc.available_pages() < need_pages:
            need_pages -= entries.pop()[6] // ps
        if not entries:
            return rids

        placements, row_fill = [], []        # first-fit spans into rows
        for e in entries:
            row = next((r for r, f in enumerate(row_fill) if f + e[6] <= width), None)
            if row is None:
                row_fill.append(0)
                row = len(row_fill) - 1
            placements.append((e, row, row_fill[row]))
            row_fill[row] += e[6]
        R = len(row_fill)
        ids_p = np.full((R, width), self.cfg.pad_token_id, np.int32)
        seg = np.full((R, width), -2, np.int32)
        pos = np.zeros((3, R, width), np.int64)
        pids = np.full((R, width // ps), self.trash_page, np.int32)
        last_rc = np.zeros((len(placements), 2), np.int64)
        page_lists = []
        for q, ((_, ids, *_rest, span), row, col) in enumerate(placements):
            L = ids.shape[0]
            ids_p[row, col:col + L] = ids
            seg[row, col:col + span][:L] = q + 1
            pos[:, row, col:col + L] = np.arange(L)[None]   # text positions restart
            pages = [pc._alloc() for _ in range(span // ps)]
            page_lists.append(pages)
            pids[row, col // ps:col // ps + len(pages)] = pages
            last_rc[q] = (row, col + L - 1)
        try:
            logits = _prefill_packed_into_pages(
                self.model, self._kv(), self._t(pids), self._t(ids_p), self._t(pos),
                self._t(seg, torch.int32), self._t(last_rc), self.attn_impl, ps)
        except Exception:
            self._free([pg for pages in page_lists for pg in pages])
            raise
        for q, ((n, ids, mnt, cb, spr, tok_cb, span), row, col) in enumerate(placements):
            slot = free[q]
            true_len = ids.shape[0]
            np_used = -(-true_len // ps)
            pc.page_tables[slot] = -1
            pc.page_tables[slot, :np_used] = page_lists[q][:np_used]
            self._free(page_lists[q][np_used:])
            pc.lengths[slot] = true_len
            # a packed prompt's KV equals its standalone prefill's (positions
            # restart, segments masked), so its full pages join the prefix cache
            self._register_prefix(ids, page_lists[q][:np_used])
            req = _Request(self._new_rid(), ids_p[row:row + 1, col:col + true_len],
                           pos[:, row:row + 1, col:col + true_len], 0, mnt, cb, sp=spr,
                           tok_cb=tok_cb)
            self._occupy(slot, req, true_len)
            rids[n] = req.rid
        self.last_logits[self._t(free[:len(placements)])] = logits
        return rids

    def _release_slot(self, slot: int) -> None:
        self.pcache.release(slot)

    def _fork_kv(self, src: int, dst: int) -> None:
        cow = self.pcache.share_prefix(
            src, dst, cow_last=self.cur_len[src] % self._page_size != 0)
        if cow is not None:
            _copy_page(self._kv(), *cow)


def _run_loop_impl(engine, request_queue: "queue.Queue", stop: threading.Event,
                   idle_sleep: float = 0.005, admit_per_step: int = 1) -> None:
    """Pull (prompt_ids, max_new_tokens, done_cb[, sp[, tok_cb]]) items;
    admit and decode until stopped.

    Admission is budgeted: while any slot decodes, at most `admit_per_step`
    prefills run between decode windows, so a burst of arrivals cannot
    stall every active stream for the whole burst's prefill. An idle engine
    with more than one request queued admits the burst at once: short
    prompts (a span of at most half the top bucket, no prefix-cache hit)
    packed into shared rows, the rest through same-bucket batched prefill;
    a request that finds no slot goes back on the queue. A request whose
    admission raises is answered done_cb(-1, []) (an empty completion) and
    counted in engine.loop_stats["failed"], with the error logged."""
    stats = engine.loop_stats

    def failed(group, what):
        _log.exception("run_loop: %s failed for %d request(s)", what, len(group))
        stats["failed"] += len(group)
        for it in group:
            if len(it) > 2 and it[2]:
                it[2](-1, [])

    while not stop.is_set():
        admitted = 0
        budget = engine.num_slots if engine.num_active == 0 else admit_per_step
        if (engine.num_active == 0 and hasattr(engine, "submit_batch")
                and request_queue.qsize() > 1):
            burst = []
            while len(burst) < engine.num_slots:
                try:
                    burst.append(request_queue.get_nowait())
                except queue.Empty:
                    break
            ps = getattr(engine, "_page_size", None)
            width = max(engine.prompt_buckets)
            match_len = getattr(engine, "prefix_match_len", None)
            packable, rest = [], []
            for it in burst:
                span = (-(-len(it[0]) // ps) * ps) if ps else None
                # a prefix-cache hit skips packing: packed rows restart
                # positions and cannot attend cached history
                hit = bool(match_len and match_len(it[0]))
                (packable if ps and span * 2 <= width and not hit else rest).append(it)
            if len(packable) < 2:
                rest, packable = packable + rest, []
            for route, submit, group in (("packed", getattr(engine, "submit_packed", None),
                                          packable),
                                         ("batch", engine.submit_batch, rest)):
                if not group:
                    continue
                try:
                    rids = submit(group)
                except Exception:
                    failed(group, f"{route} admission")
                    continue
                for it, rid in zip(group, rids):
                    if rid is None:
                        request_queue.put(it)   # retried when slots free up
                    else:
                        stats[route] += 1
                        admitted += 1
        while engine.num_active < engine.num_slots and admitted < budget:
            try:
                item = request_queue.get_nowait()
            except queue.Empty:
                break
            prompt_ids, mnt, cb = item[:3]
            sp = item[3] if len(item) > 3 else None
            tok_cb = item[4] if len(item) > 4 else None
            try:
                engine.submit(prompt_ids, mnt, cb, sp=sp, tok_cb=tok_cb)
            except Exception:   # one bad request must not end the loop
                failed([item], "admission")
                continue
            stats["single"] += 1
            admitted += 1       # only admissions that succeed take budget
        if engine.num_active:
            engine.step(engine.decode_window)
        elif not admitted:
            time.sleep(idle_sleep)
