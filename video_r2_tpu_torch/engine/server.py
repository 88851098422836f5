"""OpenAI-compatible chat server on the port's engine (the judge role).

Port of ``video_r2_tpu/engine/server.py``: `ChatEngine` renders chats and
tokenizes them; `make_handler` / `serve` put it behind a stdlib HTTP server
with /v1/chat/completions (stop strings, n, stream) and /metrics.

- Batch mode (continuous=False) runs one batched `generate` per call (a
  burst of judge requests is one batch, `chat_batch`), behind a lock;
  kv_quant="int8" runs each batch on the int8 KV cache.
- Continuous mode (continuous=True) runs the slot engine or, with
  engine_kind="paged", the paged engine (kv_quant="int8" pages there) on a
  loop thread (`run_loop`): concurrent HTTP requests share one decode loop,
  an idle burst of short judge prompts is admitted packed. The loop's
  thread is the only one that touches the device; the handler threads
  enqueue and wait. `chat_stream` streams per token, and a stop string
  cancels its request on the engine.
- spec_decode=K speculates with K n-gram drafts a verify round: batch mode
  through generate(spec_decode=K), continuous mode inside either engine's
  loop (its spec_stats in /metrics); prefill_chunk_tokens=C prefills a
  continuous engine's longer prompts a chunk of C a step.

- A Qwen3-Next config (models/qwen3_next.py, the reference's judge) serves
  in batch mode through generate_packed (generate_spec under spec_decode;
  kv_quant / act_quant ride its config), with NextPrefixStore reusing a
  burst's shared prefix across calls unless prefix_cache=False, and in
  continuous mode on engine/next_continuous.py's slot engine; the paged
  engine and continuous kv_quant are refused for it, as in the reference.

A mesh (ROADMAP Queue 1 #8) raises NotImplementedError.
"""

from __future__ import annotations

import json
import queue as queue_mod
import threading
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from ..models.config import ModelConfig
from ..models.qwen3_next import is_qwen3_next_config
from .chat import pack_prompts, render_messages
from .generate import generate
from .sampling import SamplingParams


def _norm_stop(stop) -> list[str]:
    """OpenAI `stop` field: None | str | [str] -> list of stop strings."""
    if not stop:
        return []
    return [stop] if isinstance(stop, str) else [s for s in stop if s]


def _apply_stop(text: str, stops: list[str]) -> str:
    """Truncate at the earliest stop-string occurrence (exclusive — the
    stop string itself is not returned, the OpenAI/vLLM contract)."""
    cut = len(text)
    for s in stops:
        i = text.find(s)
        if i >= 0:
            cut = min(cut, i)
    return text[:cut]


class ChatEngine:
    """Thread-safe text-only chat generation on a model (judge role). attn_impl
    "flash" runs prefill attention through the flash kernel; act_quant="int8"
    runs batch-mode prefill W8A8 on an int8 model (models/quant.py);
    kv_quant="int8" keeps the KV cache in int8 (batch mode, or the paged
    engine's pages). continuous=True serves from one decode loop on a
    background thread: num_slots requests decode together, max_len tokens a
    request; engine_kind "slots" (contiguous cache) or "paged" (page_size);
    decode_window tokens a loop step (verify rounds under spec_decode).
    spec_decode=K: speculative decoding, K drafts a round, in both modes;
    prefill_chunk_tokens: chunked prefill in continuous mode."""

    def __init__(self, model, cfg, tokenizer, model_name: str = "video-r2-tpu",
                 max_new_tokens: int = 1024, attn_impl: str = "xla",
                 act_quant: str | None = None, continuous: bool = False,
                 num_slots: int = 8, max_len: int = 4096, mesh=None,
                 engine_kind: str = "slots", page_size: int = 128,
                 kv_quant: str | None = None, spec_decode: int = 0,
                 decode_window: int = 1, prefill_chunk_tokens: int = 0,
                 prefix_cache: bool = True):
        if mesh is not None:
            raise NotImplementedError("sharded serving (mesh) is not ported to the "
                                      "PyTorch ChatEngine yet (ROADMAP Queue 1 #8)")
        self._next = is_qwen3_next_config(cfg)
        if not (self._next or isinstance(cfg, ModelConfig)):
            raise NotImplementedError(f"ChatEngine serves a ModelConfig or a "
                                      f"Qwen3NextConfig; {type(cfg).__name__} is no "
                                      f"family the port has")
        if self._next:
            # the paged engine and the slot engine's int8 cache serve the
            # homogeneous-KV family only (the hybrid slot cache is bf16)
            unsupported = [n for n, v in (
                ("engine_kind=paged", continuous and engine_kind == "paged"),
                ("continuous+kv_quant", continuous and kv_quant)) if v]
            if unsupported:
                raise ValueError(
                    "Qwen3-Next serving supports batch mode (spec + kv/act quant + "
                    "the prefix store) and slot-continuous mode (spec + chunked "
                    f"prefill): unsupported option(s) {unsupported}")
            # serving quantization rides the model config: int8 KV strips for
            # the full-attention layers, W8A8 prefill linears on int8 weights
            if kv_quant or act_quant:
                cfg = cfg.replace(kv_quant=kv_quant, act_quant=act_quant)
        if engine_kind != "slots" and not continuous:
            raise ValueError(
                f"engine_kind={engine_kind!r} requires continuous=True "
                "(non-continuous mode serializes whole generate() calls)")
        if continuous and engine_kind == "slots" and kv_quant:
            raise ValueError(
                "kv_quant with continuous=True requires the paged engine "
                "(--paged): the slot engine's contiguous cache is bf16-only")
        self.model = model
        self.cfg = cfg
        self.tok = tokenizer
        self.model_name = model_name
        self.max_new_tokens = max_new_tokens
        self.attn_impl = attn_impl
        self.act_quant = act_quant
        self.spec_decode = spec_decode
        self.kv_quant = kv_quant
        self.mesh = None
        self._lock = threading.Lock()
        self._seed = 0
        self._queue = None
        # Qwen3-Next bursts share a system + rubric prefix: its hybrid state
        # is kept across calls and only the suffixes prefill (exact; with
        # kv_quant the finished prompt cache quantizes as the packed path's)
        self._prefix_store = None
        if self._next and prefix_cache and not continuous:
            from ..models.qwen3_next import NextPrefixStore

            self._prefix_store = NextPrefixStore()
        if continuous and self._next:
            from .next_continuous import Qwen3NextContinuousEngine

            self._cont = Qwen3NextContinuousEngine(
                model, cfg, num_slots=num_slots, max_len=max_len,
                sp=SamplingParams(eos_token_ids=(cfg.eos_token_id,),
                                  pad_token_id=cfg.pad_token_id),
                spec_decode=spec_decode, prefill_chunk_tokens=prefill_chunk_tokens,
                decode_window=max(decode_window, 1))
        elif continuous:
            from .continuous import ContinuousEngine, PagedContinuousEngine

            # the paged engine keeps its automatic prefix cache on, as in the
            # reference, where prefix_cache switches only the Qwen3-Next store
            kw = ({"page_size": page_size, "kv_quant": kv_quant}
                  if engine_kind == "paged" else {})
            eng_cls = PagedContinuousEngine if engine_kind == "paged" else ContinuousEngine
            self._cont = eng_cls(
                model, num_slots=num_slots, max_len=max_len,
                sp=SamplingParams(eos_token_ids=(cfg.eos_token_id,),
                                  pad_token_id=cfg.pad_token_id),
                attn_impl=attn_impl, decode_window=max(decode_window, 1),
                spec_decode=spec_decode, prefill_chunk_tokens=prefill_chunk_tokens, **kw)
        if continuous:
            self._queue = queue_mod.Queue()
            self._stop = threading.Event()
            self._thread = threading.Thread(
                target=self._cont.run_loop, args=(self._queue, self._stop),
                daemon=True)
            self._thread.start()

    def shutdown(self):
        """Stop the loop thread (continuous mode) and wait for it."""
        if self._queue is not None:
            self._stop.set()
            self._thread.join(timeout=60)

    def _sampling(self, temperature, top_p, top_k, max_tokens) -> SamplingParams:
        return SamplingParams(
            do_sample=temperature > 0, temperature=max(temperature, 1e-6),
            top_p=top_p, top_k=top_k, max_new_tokens=max_tokens or self.max_new_tokens,
            eos_token_ids=(self.cfg.eos_token_id,), pad_token_id=self.cfg.pad_token_id)

    def _encode(self, messages: list[dict]) -> list[int]:
        return self.tok.encode(render_messages(messages, add_generation_prompt=True,
                                               default_system=None))

    def _enqueue(self, ids, sp: SamplingParams, done_cb, tok_cb) -> None:
        if not self._thread.is_alive():
            raise RuntimeError("the serving loop has stopped")
        self._queue.put((ids, sp.max_new_tokens, done_cb, sp, tok_cb))

    def _wait(self, done: threading.Event) -> None:
        """Wait for the loop to answer; raise if its thread dies first (an
        error on the device ends the loop, and no answer would come)."""
        while not done.wait(1.0):
            if not self._thread.is_alive():
                raise RuntimeError("the serving loop stopped before answering")

    def chat_stream(self, messages: list[dict], temperature: float = 0.0,
                    top_p: float = 1.0, top_k: int = 0,
                    max_tokens: int | None = None, stop=None):
        """Yield text deltas as tokens arrive (OpenAI stream=true).

        Continuous mode streams per decoded token (window granularity);
        batch mode sends the whole answer as one chunk. With `stop` strings,
        emission holds back max(len(stop))-1 chars so a stop string never
        partially reaches the client, and a hit cancels the request on the
        engine (the slot frees instead of burning its remaining budget)."""
        stops = _norm_stop(stop)
        if self._queue is None:
            yield self.chat(messages, temperature, top_p, top_k, max_tokens, stop=stop)
            return
        sp = self._sampling(temperature, top_p, top_k, max_tokens)
        q: queue_mod.Queue = queue_mod.Queue()
        state = {"rid": None}

        def tok_cb(rid, t):
            state["rid"] = rid
            q.put(t)

        self._enqueue(self._encode(messages), sp, lambda rid, toks: q.put(None), tok_cb)
        hold = max((len(s) for s in stops), default=1) - 1
        toks: list[int] = []
        emitted = ""
        cur = ""
        stopped = False
        while True:
            try:
                t = q.get(timeout=1.0)
            except queue_mod.Empty:
                if not self._thread.is_alive():
                    raise RuntimeError("the serving loop stopped before answering")
                continue
            if t is None:
                break
            toks.append(t)
            cur = self.tok.decode(toks, skip_special_tokens=True)
            if cur.endswith("\ufffd"):
                continue  # mid-UTF-8 token boundary: hold until complete
            if stops and any(s in cur for s in stops):
                cur = _apply_stop(cur, stops)
                if cur.startswith(emitted) and len(cur) > len(emitted):
                    yield cur[len(emitted):]
                emitted = cur
                stopped = True
                if state["rid"] is not None:
                    self._cont.request_cancel(state["rid"])
                break
            safe = cur[:max(len(emitted), len(cur) - hold)] if stops else cur
            if safe.startswith(emitted) and len(safe) > len(emitted):
                delta = safe[len(emitted):]
                emitted = safe
                yield delta
        # flush what a trailing hold-back kept; if decoding went
        # non-monotonic there is no unsent suffix to recover
        if not stopped:
            if stops:
                cur = _apply_stop(cur, stops)
            if cur != emitted and cur.startswith(emitted):
                yield cur[len(emitted):]

    def _stop_watcher(self, stops: list[str]):
        """tok_cb that cancels a continuous request as soon as its decoded
        text holds a stop string (without it the slot would burn its whole
        budget and only the truncation would hide it). It decodes a tail
        window of tokens, long enough for the longest stop string, so the
        loop thread does no work quadratic in the answer's length."""
        if not stops or self._queue is None:
            return None
        acc: list[int] = []
        w_tok = max(len(s) for s in stops) + 32

        def watch(rid, t):
            acc.append(t)
            txt = self.tok.decode(acc[-w_tok:], skip_special_tokens=True)
            if any(s in txt for s in stops):
                self._cont.request_cancel(rid)

        return watch

    def chat(self, messages: list[dict], temperature: float = 0.0,
             top_p: float = 1.0, top_k: int = 0,
             max_tokens: int | None = None, stop=None) -> str:
        return self.chat_batch([messages], temperature, top_p, top_k, max_tokens,
                               stop=stop)[0]

    def _batch_generate(self, packed, sp):
        """One batched generate (callers hold the lock)."""
        if self._next:
            from ..models.qwen3_next import generate_packed, generate_spec

            if self.spec_decode:
                return generate_spec(self.model, self.cfg, packed.input_ids, packed.lengths,
                                     sp, spec_k=self.spec_decode, seed=self._seed)
            return generate_packed(self.model, self.cfg, packed.input_ids, packed.lengths,
                                   sp, seed=self._seed)
        return generate(self.model, packed.input_ids, packed.lengths, sp,
                        seed=self._seed, attn_impl=self.attn_impl,
                        act_quant=self.act_quant, kv_quant=self.kv_quant,
                        spec_decode=self.spec_decode)

    def chat_batch(self, messages_list: list[list[dict]],
                   temperature: float = 0.0, top_p: float = 1.0,
                   top_k: int = 0, max_tokens: int | None = None,
                   stop=None) -> list[str]:
        """A burst of chats (the TAC/VAS judge pattern: many same-shape
        prompts at temperature 0). Continuous mode submits them all to the
        shared loop and waits; batch mode runs one batched generate. A
        request whose admission failed comes back as "" (the loop counts
        it in the engine's loop_stats)."""
        sp = self._sampling(temperature, top_p, top_k, max_tokens)
        stops = _norm_stop(stop)
        ids_list = [self._encode(m) for m in messages_list]
        if self._queue is not None:
            boxes = []
            for ids in ids_list:
                done = threading.Event()
                box = {}

                def cb(rid, toks, box=box, done=done):
                    box["tokens"] = toks
                    done.set()

                self._enqueue(ids, sp, cb, self._stop_watcher(stops))
                boxes.append((box, done))
            for _, done in boxes:
                self._wait(done)
            return [_apply_stop(self.tok.decode(b["tokens"], skip_special_tokens=True),
                                stops) for b, _ in boxes]
        with self._lock:
            self._seed += 1
            if self._prefix_store is not None and len(ids_list) > 1:
                res = self._prefix_store.generate(self.model, self.cfg, ids_list, sp,
                                                  seed=self._seed, spec_k=self.spec_decode)
            else:
                res = self._batch_generate(
                    pack_prompts(ids_list, pad_id=self.cfg.pad_token_id), sp)
        return [_apply_stop(self.tok.decode(res.sequences[i][: res.lengths[i]],
                                            skip_special_tokens=True), stops)
                for i in range(len(ids_list))]

    def stats(self) -> dict:
        """Operator telemetry for /metrics: slot and page occupancy and the
        speculative-decoding counters in continuous mode."""
        s = {"model": self.model_name, "continuous": self._queue is not None,
             "spec_decode": self.spec_decode, "kv_quant": self.kv_quant,
             "mesh": None}
        if self._prefix_store is not None:
            s.update(prefix_cache_hits=self._prefix_store.hits,
                     prefix_cache_misses=self._prefix_store.misses)
        if self._queue is not None:
            eng = self._cont
            s.update(active_requests=eng.num_active, num_slots=eng.num_slots,
                     spec_stats=dict(eng.spec_stats))
            pc = getattr(eng, "pcache", None)
            if pc is not None:
                s.update(pages_total=int(pc.k.shape[2]),
                         pages_free=len(pc.free_pages),
                         pages_cached=len(pc.evictable))
        return s


def make_handler(engine: ChatEngine):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *args):
            pass

        def _send(self, code: int, payload: dict):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _send_stream(self, req):
            """OpenAI SSE streaming: data:-framed chat.completion.chunk
            deltas, terminated by data: [DONE]."""
            self.send_response(200)
            self.send_header("Content-Type", "text/event-stream")
            self.send_header("Cache-Control", "no-cache")
            self.send_header("Connection", "close")
            self.end_headers()
            rid = f"chatcmpl-{uuid.uuid4().hex[:12]}"
            model = req.get("model", engine.model_name)

            def chunk(delta: dict, finish=None):
                payload = {"id": rid, "object": "chat.completion.chunk",
                           "created": int(time.time()), "model": model,
                           "choices": [{"index": 0, "delta": delta,
                                        "finish_reason": finish}]}
                self.wfile.write(f"data: {json.dumps(payload)}\n\n".encode())
                self.wfile.flush()

            # headers are on the wire: a failure ends the stream in band
            try:
                chunk({"role": "assistant", "content": ""})
                for delta in engine.chat_stream(
                        req["messages"],
                        temperature=float(req.get("temperature", 0.0)),
                        top_p=float(req.get("top_p", 1.0)),
                        top_k=int(req.get("top_k", 0)),
                        max_tokens=req.get("max_tokens"),
                        stop=req.get("stop")):
                    chunk({"content": delta})
                chunk({}, finish="stop")
                self.wfile.write(b"data: [DONE]\n\n")
                self.wfile.flush()
            except (BrokenPipeError, ConnectionError):
                pass
            except Exception as e:  # noqa: BLE001
                try:
                    err = json.dumps({"error": str(e)})
                    self.wfile.write(f"data: {err}\n\ndata: [DONE]\n\n".encode())
                    self.wfile.flush()
                except OSError:
                    pass

        def do_GET(self):
            if self.path == "/v1/models":
                self._send(200, {"object": "list", "data": [
                    {"id": engine.model_name, "object": "model"}]})
            elif self.path == "/metrics":
                self._send(200, engine.stats())
            elif self.path in ("/health", "/"):
                self._send(200, {"status": "ok"})
            else:
                self._send(404, {"error": "not found"})

        def do_POST(self):
            if self.path != "/v1/chat/completions":
                self._send(404, {"error": "not found"})
                return
            try:
                length = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(length))
                n = int(req.get("n", 1))
                if req.get("stream"):
                    if n > 1:
                        self._send(400, {"error": "stream with n>1 is unsupported"})
                        return
                    self._send_stream(req)
                    return
                kw = dict(temperature=float(req.get("temperature", 0.0)),
                          top_p=float(req.get("top_p", 1.0)),
                          top_k=int(req.get("top_k", 0)),
                          max_tokens=req.get("max_tokens"),
                          stop=req.get("stop"))
                if n > 1:
                    contents = engine.chat_batch([req["messages"]] * n, **kw)
                else:
                    contents = [engine.chat(req["messages"], **kw)]
                self._send(200, {
                    "id": f"chatcmpl-{uuid.uuid4().hex[:12]}",
                    "object": "chat.completion",
                    "created": int(time.time()),
                    "model": req.get("model", engine.model_name),
                    "choices": [{
                        "index": i,
                        "message": {"role": "assistant", "content": c},
                        "finish_reason": "stop",
                    } for i, c in enumerate(contents)],
                })
            except Exception as e:  # noqa: BLE001
                self._send(500, {"error": str(e)})

    return Handler


def serve(engine: ChatEngine, host: str = "0.0.0.0", port: int = 8000,
          background: bool = False) -> ThreadingHTTPServer:
    server = ThreadingHTTPServer((host, port), make_handler(engine))
    if background:
        t = threading.Thread(target=server.serve_forever, daemon=True)
        t.start()
        return server
    server.serve_forever()
    return server
