"""Continuous batching for the Qwen3-Next hybrid judge.

Port of ``video_r2_tpu/engine/next_continuous.py``: N decode slots share one
hybrid cache (models/qwen3_next.py's layout) and one decode step; requests
are admitted into free slots by a single-prompt prefill at a bucketed length
whose states are copied into the slot. A slot engine, not a paged one: three
layers in four carry a constant-size recurrent state ([nv, dk, dv] and a
conv tail a slot), so only one layer in four keeps a per-slot KV strip.

- Every slot decodes every step (a fixed shape); an idle slot's frontier is
  clamped below its strip so an idle engine can run on. Emission, EOS,
  budgets, per-token callbacks and cancellation are host-side; per-slot
  sampling parameters let greedy and sampled requests share a step.
- `prefill_chunk_tokens=C`: a longer prompt prefills a chunk of C tokens a
  step(), between decode windows, into a B = 1 accumulator cache
  (`_extend_forward` runs the chunk at the accumulator's frontier and
  `_commit` advances the DeltaNet states through its valid tokens only), and
  is copied into its slot when done, so decode steps in between never see a
  half-built state.
- `spec_decode=K`: each dispatch runs verify rounds for all slots: the
  transformer engines' per-slot drafting and acceptance
  (engine/spec_decode.py) around the hybrid model's verify / commit split;
  an inactive slot commits 0 tokens, and a frontier clamps at Smax - W.

The protocol is engine/continuous.py's (submit / step / num_active /
num_slots / request_cancel / loop_stats), so `run_loop` is its loop and
ChatEngine(continuous=True) hosts this engine behind the same server.
`request_cancel` takes no lock: ChatEngine's stop watcher calls it from a
token callback inside step(). The JAX package's jitted steps become
functions that update the cache in place; a decode window (`step(steps=n)`)
decodes n tokens on the device and synchronises once (`_decode_all`), a spec
dispatch n verify rounds (`_spec_dispatch`). A mesh raises
NotImplementedError (ROADMAP Queue 1 #8).
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np
import torch

from ..models.qwen3_next import (
    Qwen3NextConfig,
    _commit,
    _extend_forward,
    decode_step,
    empty_cache,
    prefill,
)
from .continuous import _next_token, _run_loop_impl
from .sampling import SamplingParams
from .spec_decode import _spec_accept, _spec_draft, _spec_hist_update, _spec_tok0


@dataclass
class _Req:
    rid: int
    budget: int
    done_cb: Optional[Callable]
    tok_cb: Optional[Callable]
    eos: tuple
    prompt_ids: np.ndarray
    toks: list = field(default_factory=list)


class Qwen3NextContinuousEngine:
    @torch.inference_mode()
    def __init__(self, model, cfg: Qwen3NextConfig | None = None, num_slots: int = 8,
                 max_len: int = 4096, sp: SamplingParams | None = None,
                 prompt_buckets=(128, 256, 512, 1024, 2048), seed: int = 0,
                 spec_decode: int = 0, prefill_chunk_tokens: int = 0,
                 decode_window: int = 1, mesh=None):
        """The device is the model's; cfg (default model.cfg) may carry
        serving switches (attn_impl, act_quant). decode_window: tokens a
        step of run_loop decodes (verify rounds under spec_decode)."""
        cfg = cfg or model.cfg
        if cfg.kv_quant:
            raise ValueError(
                "Qwen3NextContinuousEngine carries a contiguous bf16 hybrid cache; "
                "cfg.kv_quant is batch-mode only (ChatEngine guards this - a direct "
                "construction must pass a bf16 cfg)")
        if mesh is not None:
            raise NotImplementedError("a mesh (sharded serving) is not ported to the "
                                      "PyTorch engine yet (ROADMAP Queue 1 #8)")
        self.model = model
        self.cfg = cfg
        self.device = model.device
        self.num_slots = N = num_slots
        self.max_len = max_len
        self.decode_window = decode_window
        self.sp = sp or SamplingParams(eos_token_ids=(cfg.eos_token_id,),
                                       pad_token_id=cfg.pad_token_id)
        self.prompt_buckets = tuple(b for b in sorted(prompt_buckets)
                                    if b <= max_len) or (max_len,)
        self.spec_decode = spec_decode
        # a verify window writes W tokens at the frontier before acceptance:
        # the strips (and history rows) carry W of slack
        W = spec_decode + 1 if spec_decode else 0
        self.cache = empty_cache(cfg, N, max_len + W, model.dtype, self.device)
        self.last_logits = torch.zeros((N, cfg.vocab_size), dtype=torch.float32,
                                       device=self.device)
        self.hist = (torch.full((N, max_len + W), self.sp.pad_token_id, dtype=torch.long,
                                device=self.device) if spec_decode else None)
        self._spec_rej = (torch.full((N,), -1, dtype=torch.long, device=self.device)
                          if spec_decode else None)
        self.spec_stats = {"spec_dispatches": 0, "spec_rounds": 0, "spec_tokens": 0,
                           "plain_dispatches": 0}
        # run_loop's admissions by route, and the requests it answered empty
        self.loop_stats = {"packed": 0, "batch": 0, "single": 0, "failed": 0}
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        self.prefill_chunk_tokens = prefill_chunk_tokens
        self.prefilling = np.zeros((N,), bool)
        self._pending_prefill: list[dict] = []
        self.slot_req: list[Optional[_Req]] = [None] * N
        self.slot_temp = np.full((N,), 1.0, np.float32)
        self.slot_top_p = np.ones((N,), np.float32)
        self.slot_top_k = np.zeros((N,), np.int64)
        self.slot_do_sample = np.zeros((N,), bool)
        self._next_rid = 0
        self._lock = threading.Lock()
        # lock-free cancellation (a GIL-atomic set add): a locked cancel
        # called from a tok_cb inside step() would deadlock the loop
        self._cancelled: set[int] = set()

    @property
    def num_active(self) -> int:
        return sum(r is not None for r in self.slot_req)

    def _t(self, x, dtype=torch.long) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=self.device)

    @torch.inference_mode()
    def submit(self, prompt_ids, max_new_tokens: int = 128, done_cb: Callable | None = None,
               sp: SamplingParams | None = None, tok_cb: Callable | None = None,
               **_) -> Optional[int]:
        """Admit into a free slot; the request id, or None when the pool is
        full. A prompt longer than the slot's room keeps its recent end; the
        budget is clamped to what is left of the slot."""
        with self._lock:
            slot = next((i for i, r in enumerate(self.slot_req) if r is None), None)
            if slot is None:
                return None
            ids = np.asarray(prompt_ids, np.int64)
            room = max(self.max_len - max_new_tokens - 1, 8)
            if ids.shape[0] > room:
                ids = ids[-room:]
            true_len = int(ids.shape[0])
            # without the clamp an over-budget request would reach the idle
            # slots' frontier clamp and stream from a frozen position
            max_new_tokens = max(min(max_new_tokens, self.max_len - true_len - 1), 1)
            bucket = next((b for b in self.prompt_buckets if b >= true_len), self.max_len)
            ck = self.prefill_chunk_tokens
            if ck and true_len > ck:
                # chunked: step() prefills a chunk a call into a B = 1
                # accumulator; the slot stays out of decode until installed
                width = -(-bucket // ck) * ck
                rows = np.full((1, width), self.cfg.pad_token_id, np.int64)
                rows[0, :true_len] = ids
                self._pending_prefill.append({
                    "slot": slot, "rows": rows, "true_len": true_len,
                    "bucket": min(bucket, width), "done": 0, "ids": ids,
                    "sub": empty_cache(self.cfg, 1, width, self.model.dtype, self.device)})
                self.prefilling[slot] = True
            else:
                padded = np.full((1, bucket), self.cfg.pad_token_id, np.int64)
                padded[0, :true_len] = ids
                logits, pc = prefill(self.model, self.cfg, padded, np.array([true_len]),
                                     bucket)
                self._install(slot, pc, true_len, bucket)
                self.last_logits[slot] = logits[0].float()
                self._write_hist_row(slot, ids, true_len)
            rsp = sp or self.sp
            self.slot_temp[slot] = max(rsp.temperature, 1e-6)
            self.slot_top_p[slot] = rsp.top_p
            self.slot_top_k[slot] = rsp.top_k
            self.slot_do_sample[slot] = rsp.do_sample
            rid = self._next_rid
            self._next_rid += 1
            self.slot_req[slot] = _Req(rid, max_new_tokens, done_cb, tok_cb,
                                       tuple(rsp.eos_token_ids), ids)
            return rid

    def request_cancel(self, rid: int) -> None:
        # no lock: called from tok_cb inside step()'s locked region
        self._cancelled.add(rid)

    def _install(self, slot: int, sub, true_len: int, bucket: int) -> None:
        """Copy a B = 1 prompt cache (a prefill's or a chunked prefill's
        accumulator) into `slot`."""
        c = self.cache
        c.conv[:, :, slot] = sub.conv[:, :, 0]
        c.rec[:, :, slot] = sub.rec[:, :, 0]
        c.k[:, slot, :bucket] = sub.k[:, 0, :bucket]
        c.v[:, slot, :bucket] = sub.v[:, 0, :bucket]
        c.length[slot] = true_len

    def _write_hist_row(self, slot: int, ids, true_len: int) -> None:
        """Reset a newly admitted slot's drafting history to [prompt | pad]
        (every admission path, or drafting reads the last occupant's tokens)."""
        if self.hist is None:
            return
        self.hist[slot] = self.sp.pad_token_id
        self.hist[slot, :true_len] = self._t(ids[:true_len])
        self._spec_rej[slot] = -1

    def _advance_prefill(self) -> None:
        """Chunked prefill: the oldest pending prompt by one chunk (once a
        step() call, between decode windows)."""
        if not self._pending_prefill:
            return
        st = self._pending_prefill[0]
        ck = self.prefill_chunk_tokens
        start = st["done"]
        sub = st["sub"]
        chunk = self._t(st["rows"][:, start:start + ck])
        logits_w, saved = _extend_forward(self.model, self.cfg, chunk, sub, prefill_chunk=True)
        n_valid = min(max(st["true_len"] - start, 0), ck)
        _commit(self.cfg, sub, saved, self._t([n_valid]))
        st["done"] = start + ck
        if st["done"] >= st["true_len"]:
            slot = st["slot"]
            self._install(slot, sub, st["true_len"], st["bucket"])
            last = min(max(st["true_len"] - 1 - start, 0), ck - 1)
            self.last_logits[slot] = logits_w[0, last].float()
            self._write_hist_row(slot, st["ids"], st["true_len"])
            self.prefilling[slot] = False
            self._pending_prefill.pop(0)

    def _sampling(self, active):
        """(per-slot sampling tensors or None, greedy_only)."""
        if not self.slot_do_sample[active].any():
            return None, True
        return (self._t(self.slot_temp, torch.float32), self._t(self.slot_top_p, torch.float32),
                self._t(self.slot_top_k), self._t(self.slot_do_sample, torch.bool)), False

    def _decode_all(self, active, steps: int) -> np.ndarray:
        """`steps` decode steps of every slot on the device (the idle ones
        too, their frontiers clamped below the strip); the tokens [steps, N]
        to the host in one sync."""
        samp, greedy_only = self._sampling(active)
        smax = self.cache.k.shape[2]
        toks = []
        for _ in range(steps):
            tok = _next_token(self.last_logits, samp, self._gen, greedy_only)
            logits, _ = decode_step(self.model, self.cfg, tok, self.cache)
            self.cache.length = self.cache.length.clamp(max=smax - 2)
            self.last_logits = logits.float()
            toks.append(tok)
        return torch.stack(toks).cpu().numpy()

    def _emit(self, req: _Req, t: int) -> None:
        req.toks.append(t)
        req.budget -= 1
        if req.tok_cb:
            req.tok_cb(req.rid, t)
        if t in req.eos:
            req.budget = 0

    def _finish(self, i: int, req: _Req, finished: list) -> None:
        finished.append((req.rid, req.toks))
        if req.done_cb:
            req.done_cb(req.rid, req.toks)
        self.slot_req[i] = None

    def _active(self) -> np.ndarray:
        return np.asarray([r is not None for r in self.slot_req]) & ~self.prefilling

    @torch.inference_mode()
    def step(self, steps: int = 1) -> list[tuple[int, list[int]]]:
        """Advance every slot a window of `steps` tokens (verify rounds
        under spec_decode), after one chunk of a pending chunked prefill;
        returns the finished (rid, tokens). Tokens a slot generates past its
        EOS or budget inside the window are dropped."""
        if self.spec_decode:
            return self._step_spec(max(steps, 1))
        if not self.num_active:
            return []
        finished: list[tuple[int, list[int]]] = []
        with self._lock:
            self._advance_prefill()
            active = self._active()
            if not active.any():
                return []       # every admitted slot is still mid-prefill
            toks = self._decode_all(active, max(steps, 1))
            for si in range(toks.shape[0]):
                for i, req in enumerate(self.slot_req):
                    if req is None or not active[i]:
                        continue
                    if req.rid in self._cancelled:
                        self._cancelled.discard(req.rid)
                        req.budget = 0
                    if req.budget > 0:
                        self._emit(req, int(toks[si, i]))
                    if req.budget <= 0:
                        self._finish(i, req, finished)
        return finished

    def _spec_dispatch(self, active, rounds: int) -> tuple[np.ndarray, np.ndarray]:
        """`rounds` verify rounds for every slot: each drafts K tokens from
        its history, verifies [pending | drafts] in one window and commits
        1 + accepted tokens (0 for an inactive slot). Returns (chunks
        [R, N, K + 1], commits [R, N]) on the host, in one sync."""
        K = self.spec_decode
        W = K + 1
        smax = self.cache.k.shape[2]
        samp, greedy_only = self._sampling(active)
        act = self._t(active, torch.bool)
        logits = self.last_logits
        chunks, commits = [], []
        for _ in range(rounds):
            tok0 = _spec_tok0(logits, self._gen, samp, act, self.sp.pad_token_id,
                              self._spec_rej, greedy_only)
            chunk, drafts = _spec_draft(self.hist, tok0, self.cache.length, K, False)
            logits_w, saved = _extend_forward(self.model, self.cfg, chunk, self.cache)
            n_commit, logits, self._spec_rej = _spec_accept(
                logits_w.float(), drafts, logits, act, K, samp, self._gen, greedy_only)
            _spec_hist_update(self.hist, chunk, self.cache.length, n_commit)
            _commit(self.cfg, self.cache, saved, n_commit)
            self.cache.length = self.cache.length.clamp(max=smax - W)
            chunks.append(chunk)
            commits.append(n_commit)
        self.last_logits = logits
        return torch.stack(chunks).cpu().numpy(), torch.stack(commits).cpu().numpy()

    def _step_spec(self, rounds: int) -> list[tuple[int, list[int]]]:
        """One dispatch of `rounds` verify rounds; the plain loop's
        bookkeeping over each round's committed tokens."""
        if not self.num_active:
            return []
        finished: list[tuple[int, list[int]]] = []
        with self._lock:
            self._advance_prefill()
            active = self._active()
            if not active.any():
                return []
            chunks, commits = self._spec_dispatch(active, rounds)
            self.spec_stats["spec_dispatches"] += 1
            self.spec_stats["spec_rounds"] += int(commits.shape[0])
            self.spec_stats["spec_tokens"] += int(commits.sum())
            for r in range(chunks.shape[0]):
                for i, req in enumerate(self.slot_req):
                    if req is None or not active[i]:
                        continue
                    if req.rid in self._cancelled:
                        self._cancelled.discard(req.rid)
                        req.budget = 0
                    for j in range(int(commits[r, i])):
                        if req.budget <= 0:
                            break
                        self._emit(req, int(chunks[r, i, j]))
                    if req.budget <= 0:
                        self._finish(i, req, finished)
        return finished

    @torch.inference_mode()
    def run_loop(self, request_queue: "queue.Queue", stop: threading.Event,
                 idle_sleep: float = 0.005, admit_per_step: int = 1):
        """The server loop (engine/continuous.py's), on its own thread."""
        return _run_loop_impl(self, request_queue, stop, idle_sleep,
                              admit_per_step=admit_per_step)
