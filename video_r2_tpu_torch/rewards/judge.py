"""Judge LLM client: OpenAI-compatible chat over HTTP (stdlib only).

A copy of ``video_r2_tpu/rewards/judge.py`` (its package ``__init__``
imports jax): the injectable client protocol, the HTTP client, the batched
`chat_many`, the in-process `EngineJudge` over a ChatEngine
(engine/server.py) and the `StaticJudge` fake. tests/test_torch_host.py
holds every function and class here equal to the original's source.
"""

from __future__ import annotations

import json
import os
import urllib.request
from typing import Protocol


class JudgeClient(Protocol):
    def chat(self, system: str, user: str) -> str: ...


class OpenAICompatClient:
    def __init__(self, base_url: str | None = None, model: str | None = None,
                 api_key: str | None = None, timeout: float = 10.0):
        self.base_url = (base_url or os.environ.get(
            "OPENAI_API_BASE", "http://localhost:8000/v1")).rstrip("/")
        self.model = model or os.environ.get("SERVED_MODEL")
        self.api_key = api_key or os.environ.get("OPENAI_API_KEY", "EMPTY")
        self.timeout = timeout

    def chat(self, system: str, user: str) -> str:
        payload = json.dumps({
            "model": self.model,
            "messages": [{"role": "system", "content": system},
                         {"role": "user", "content": user}],
            "stream": False,
        }).encode()
        req = urllib.request.Request(
            f"{self.base_url}/chat/completions", data=payload,
            headers={"Content-Type": "application/json",
                     "Authorization": f"Bearer {self.api_key}"})
        with urllib.request.urlopen(req, timeout=self.timeout) as resp:
            data = json.loads(resp.read())
        return (data["choices"][0]["message"]["content"] or "").strip()


def chat_many(judge: JudgeClient, requests: list[tuple[str, str]],
              max_workers: int = 16, on_error: str = "raise") -> list[str]:
    """Batched judge execution: the reference runs its TAC/VAS judges as
    single-batch vLLM generates (tac/vsibench.py run_llm_simple,
    evaluate_vas.py); here, a judge with a native `chat_many` uses it, and
    any other client fans out over a thread pool — against our continuous
    engine server the concurrent requests share one decode loop (packed
    admission for the short judge prompts), which is the same effect.

    Serial fallback (max_workers<=1 or a fake) preserves call order.
    on_error="empty": a failed request yields "" instead of raising (the
    reward path degrades per row like the reference's try/except-0)."""

    def one(req):
        try:
            return judge.chat(*req)
        except Exception:
            if on_error == "empty":
                return ""
            raise

    native = getattr(judge, "chat_many", None)
    if callable(native):
        import inspect

        try:
            takes_on_error = "on_error" in inspect.signature(native).parameters
        except (TypeError, ValueError):
            takes_on_error = False
        if takes_on_error:
            return native(requests, on_error=on_error)
        if on_error != "empty":
            return native(requests)
        # native path can't guarantee per-request isolation: fall through to
        # the wrapped fan-out so one failed call degrades only its row
    if max_workers <= 1 or isinstance(judge, StaticJudge):
        return [one(r) for r in requests]
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(max_workers=max_workers) as ex:
        return list(ex.map(one, requests))


class EngineJudge:
    """In-process judge on a ChatEngine (continuous mode recommended): the
    co-located TAC/VAS/TAR judge with no HTTP hop (serve_qwen3.sh role,
    served by our own engine instead of vLLM)."""

    def __init__(self, engine, temperature: float = 0.0,
                 max_tokens: int = 64, max_workers: int = 16):
        self.engine = engine
        self.temperature = temperature
        self.max_tokens = max_tokens
        self.max_workers = max_workers

    def chat(self, system: str, user: str) -> str:
        return self.engine.chat(
            [{"role": "system", "content": system},
             {"role": "user", "content": user}],
            temperature=self.temperature, max_tokens=self.max_tokens)

    def chat_many(self, requests: list[tuple[str, str]],
                  on_error: str = "raise") -> list[str]:
        # a non-continuous engine with chat_batch runs the whole burst as
        # ONE batched (speculative) generate; otherwise concurrent
        # submissions drain through the engine's continuous loop
        # (batched/packed admission); order restored by index.
        # on_error="empty": per-request isolation (a failed call yields "")
        batch = getattr(self.engine, "chat_batch", None)
        if batch is not None and getattr(self.engine, "_queue", None) is None:
            msgs = [[{"role": "system", "content": s},
                     {"role": "user", "content": u}] for s, u in requests]
            try:
                return batch(msgs, temperature=self.temperature,
                             max_tokens=self.max_tokens)
            except Exception:
                if on_error != "empty":
                    raise
                # fall through to per-request isolation
        from concurrent.futures import ThreadPoolExecutor

        def one(r):
            try:
                return self.chat(*r)
            except Exception:
                if on_error == "empty":
                    return ""
                raise

        with ThreadPoolExecutor(max_workers=self.max_workers) as ex:
            return list(ex.map(one, requests))


class StaticJudge:
    """Deterministic fake for tests: returns canned responses in order, or a
    constant."""

    def __init__(self, responses):
        self.responses = list(responses) if isinstance(responses, (list, tuple)) \
            else [responses]
        self.calls: list[tuple[str, str]] = []

    def chat(self, system: str, user: str) -> str:
        self.calls.append((system, user))
        idx = min(len(self.calls) - 1, len(self.responses) - 1)
        return self.responses[idx]
