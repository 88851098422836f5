"""OpenAI-compatible chat server on the port's engine (the judge role).

Port of the batch mode of ``video_r2_tpu/engine/server.py``: `ChatEngine`
renders chats, tokenizes them and runs one batched `generate` per call
(a burst of judge requests is one batch, `chat_batch`), behind a lock;
`make_handler` / `serve` put it behind a stdlib HTTP server with
/v1/chat/completions (stop strings, n, stream) and /metrics. Not ported
yet, and raising NotImplementedError when asked for: the continuous
serving loop (continuous=True needs run_loop; the continuous engine's
options, num_slots to prefix_cache, come with it), speculative decoding,
meshes and the Qwen3-Next family. kv_quant="int8" runs each batch on the
int8 KV cache (engine/generate.py).
"""

from __future__ import annotations

import json
import threading
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from ..models.config import ModelConfig
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
    """Thread-safe text-only chat generation on a model (judge role), one
    batched generate per call. attn_impl "flash" runs prefill attention
    through the flash kernel; act_quant="int8" runs prefill W8A8 on an int8
    model (models/quant.py); kv_quant="int8" keeps the KV cache in int8."""

    def __init__(self, model, cfg, tokenizer, model_name: str = "video-r2-tpu",
                 max_new_tokens: int = 1024, attn_impl: str = "xla",
                 act_quant: str | None = None, continuous: bool = False,
                 mesh=None, kv_quant: str | None = None, spec_decode: int = 0):
        if not isinstance(cfg, ModelConfig):
            raise NotImplementedError(f"{type(cfg).__name__} (the Qwen3-Next family) is "
                                      f"not ported to the PyTorch package yet")
        for name, asked in (("continuous serving (continuous=True)", continuous),
                            ("speculative decoding (spec_decode)", spec_decode),
                            ("sharded serving (mesh)", mesh is not None)):
            if asked:
                raise NotImplementedError(f"{name} is not ported to the PyTorch "
                                          f"ChatEngine yet")
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

    def shutdown(self):
        pass

    def _sampling(self, temperature, top_p, top_k, max_tokens) -> SamplingParams:
        return SamplingParams(
            do_sample=temperature > 0, temperature=max(temperature, 1e-6),
            top_p=top_p, top_k=top_k, max_new_tokens=max_tokens or self.max_new_tokens,
            eos_token_ids=(self.cfg.eos_token_id,), pad_token_id=self.cfg.pad_token_id)

    def chat_stream(self, messages: list[dict], temperature: float = 0.0,
                    top_p: float = 1.0, top_k: int = 0,
                    max_tokens: int | None = None, stop=None):
        """Yield text deltas (OpenAI stream=true): batch mode sends the
        whole answer as one chunk."""
        yield self.chat(messages, temperature, top_p, top_k, max_tokens, stop=stop)

    def chat(self, messages: list[dict], temperature: float = 0.0,
             top_p: float = 1.0, top_k: int = 0,
             max_tokens: int | None = None, stop=None) -> str:
        return self.chat_batch([messages], temperature, top_p, top_k, max_tokens,
                               stop=stop)[0]

    def _batch_generate(self, packed, sp):
        """One batched generate (callers hold the lock)."""
        return generate(self.model, packed.input_ids, packed.lengths, sp,
                        seed=self._seed, attn_impl=self.attn_impl,
                        act_quant=self.act_quant, kv_quant=self.kv_quant)

    def chat_batch(self, messages_list: list[list[dict]],
                   temperature: float = 0.0, top_p: float = 1.0,
                   top_k: int = 0, max_tokens: int | None = None,
                   stop=None) -> list[str]:
        """A burst of chats in one batched generate (the TAC/VAS judge
        pattern: many same-shape prompts at temperature 0)."""
        sp = self._sampling(temperature, top_p, top_k, max_tokens)
        stops = _norm_stop(stop)
        ids_list = [self.tok.encode(render_messages(
            m, add_generation_prompt=True, default_system=None))
            for m in messages_list]
        packed = pack_prompts(ids_list, pad_id=self.cfg.pad_token_id)
        with self._lock:
            self._seed += 1
            res = self._batch_generate(packed, sp)
        return [_apply_stop(self.tok.decode(res.sequences[i][: res.lengths[i]],
                                            skip_special_tokens=True), stops)
                for i in range(len(ids_list))]

    def stats(self) -> dict:
        """Operator telemetry for /metrics."""
        return {"model": self.model_name, "continuous": False,
                "spec_decode": self.spec_decode, "kv_quant": self.kv_quant,
                "mesh": None}


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
