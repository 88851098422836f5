"""Judge serving on the PyTorch port: segment ids through the cache fill,
packed admission, the threaded server loop, ChatEngine's continuous mode,
apps/serve and the post-hoc apps against a live server, against the JAX
package where it has the same function.

CPU only, tiny config in float32 with the JAX weights (load_jax_params); the
port's wrappers run their kernels' plain versions on CPU tensors, the JAX
paged engine its Pallas kernel in interpret mode. Tolerance: 1e-5 absolute
and relative on logits and hidden states (float32 sums in other orders);
greedy tokens, texts and files exactly equal.
"""

import json
import queue
import socket
import subprocess
import sys
import threading
import time
import urllib.request
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from video_r2_tpu.apps import postprocess as j_postprocess_app
from video_r2_tpu.engine import sampling as jsampling
from video_r2_tpu.engine.continuous import ContinuousEngine as JContinuous
from video_r2_tpu.engine.continuous import PagedContinuousEngine as JPaged
from video_r2_tpu.models.config import tiny_test_config as j_tiny
from video_r2_tpu.models.loader import init_params as j_init
from video_r2_tpu_torch.apps import postprocess as postprocess_app
from video_r2_tpu_torch.apps import serve as serve_app
from video_r2_tpu_torch.apps import test_judge
from video_r2_tpu_torch.config import AppConfig, RunConfig
from video_r2_tpu_torch.engine import continuous
from video_r2_tpu_torch.engine.chat import ByteTokenizer
from video_r2_tpu_torch.engine.continuous import ContinuousEngine, PagedContinuousEngine
from video_r2_tpu_torch.engine.generate import generate
from video_r2_tpu_torch.engine.sampling import SamplingParams
from video_r2_tpu_torch.engine.server import ChatEngine, serve
from video_r2_tpu_torch.models.config import tiny_test_config
from video_r2_tpu_torch.models.convert import load_jax_params
from video_r2_tpu_torch.models.decoder import KVCache, QuantKVCache
from video_r2_tpu_torch.models.loader import init_params
from video_r2_tpu_torch.models.mrope import mrope_cos_sin

REPO = Path(__file__).resolve().parent.parent
TOL = dict(rtol=1e-5, atol=1e-5)
PS = 16
ENGINE_KW = dict(max_len=64, prompt_buckets=(16, 32), page_size=PS)
# ByteTokenizer with the tiny config's special ids (apps/common.build_tokenizer's)
SPECIALS = {"<|endoftext|>": 0, "<|im_start|>": 256, "<|im_end|>": 1,
            "<|vision_start|>": 502, "<|vision_end|>": 503,
            "<|image_pad|>": 500, "<|video_pad|>": 501}


@pytest.fixture(scope="module")
def models():
    jparams = j_init(j_tiny(), seed=11)
    model = init_params(tiny_test_config(), seed=0, device="cpu")
    load_jax_params(model, jax.tree.map(np.asarray, jparams))
    return jparams, model


def _prompts(seed=5, lens=(5, 9, 14, 3, 11)):
    rng = np.random.default_rng(seed)
    return [list(map(int, rng.integers(2, 250, size=n))) for n in lens]


def _sp(cfg):
    return SamplingParams(pad_token_id=cfg.pad_token_id, eos_token_ids=())


# ---------------------------------------------------------------------------
# segment ids through the cache fill, packed admission
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cache", ["kv", "quant"])
def test_segment_ids_reach_the_cache_fill(models, cache):
    """A causal fill from position 0 with segment ids (a KVCache wider than
    the prompt, or the int8 QuantKVCache) gives the hidden states of the
    decoder without a cache under the same ids; without the ids the fill
    lets the second segment attend to the first."""
    _, model = models
    cfg = model.cfg
    B, S = 2, 24
    h = torch.from_numpy(np.random.default_rng(0).normal(
        size=(B, S, cfg.text.hidden_size)).astype(np.float32))
    seg = torch.tensor([[1] * 10 + [2] * 14, [1] * 16 + [-2] * 8], dtype=torch.int32)
    pos = torch.cat([torch.arange(10), torch.arange(14)])
    pos = torch.stack([pos, torch.arange(S)])[None].expand(3, B, S)
    cos, sin = mrope_cos_sin(pos, cfg, dtype=h.dtype)
    lengths = torch.full((B,), S, dtype=torch.int32)
    kw = dict(kv_lengths=lengths, causal=True)
    with torch.no_grad():
        want = model.model(h, cos, sin, None, segment_ids=seg, **kw)

        def fill(segment_ids):
            c = (KVCache.init(cfg.text, B, S + 8, h.dtype, h.device) if cache == "kv"
                 else QuantKVCache.init(cfg.text, B, S, h.device))
            return model.model(h, cos, sin, None, cache=c, segment_ids=segment_ids, **kw)

        np.testing.assert_allclose(fill(seg).numpy(), want.numpy(), **TOL)
        dropped = fill(None)
    assert not np.allclose(dropped[0, 10:].numpy(), want[0, 10:].numpy(), atol=1e-3)
    np.testing.assert_allclose(dropped[0, :10].numpy(), want[0, :10].numpy(), **TOL)


def _packed_logits(eng, prompts):
    rids = eng.submit_packed([(p, 6) for p in prompts])
    slots = [next(i for i, r in enumerate(eng.slot_req) if r is not None and r.rid == rid)
             for rid in rids]
    return rids, np.asarray(eng.last_logits)[slots]


@pytest.mark.parametrize("attn_impl", ["xla", "flash"])
def test_packed_prefill_keeps_prompts_apart(models, attn_impl, monkeypatch):
    """submit_packed: five prompts in three shared rows. Each prompt's
    last-token logits equal its solo prefill's and the JAX engine's
    submit_packed (_prefill_packed_into_pages); the greedy tokens decoded
    after it equal the JAX engine's; every page comes back. A control that
    drops the segment ids changes the logits of every prompt that is not
    first in its row."""
    jparams, model = models
    cfg = model.cfg
    prompts = _prompts()
    eng = PagedContinuousEngine(model, num_slots=6, sp=_sp(cfg), attn_impl=attn_impl,
                                **ENGINE_KW)
    avail0 = eng.pcache.available_pages()
    rids, logits = _packed_logits(eng, prompts)
    assert None not in rids
    solo = []
    for p in prompts:
        padded = np.zeros((1, 16), np.int64)
        padded[0, :len(p)] = p
        pos = torch.from_numpy(np.broadcast_to(np.arange(16), (3, 1, 16)).copy())
        hidden, _ = continuous._prefill_rows(model, torch.from_numpy(padded), pos,
                                             torch.tensor([len(p)], dtype=torch.int32),
                                             None, attn_impl)
        solo.append(continuous._last_logits(model, hidden,
                                            torch.tensor([len(p)]))[0].numpy())
    np.testing.assert_allclose(logits, np.stack(solo), **TOL)
    jeng = JPaged(jparams, j_tiny(), num_slots=6, sp=jsampling.SamplingParams(
        pad_token_id=cfg.pad_token_id, eos_token_ids=()), **ENGINE_KW)
    jrids, jlogits = _packed_logits(jeng, prompts)
    np.testing.assert_allclose(logits, jlogits, **TOL)

    def drain(e, order):
        out = {}
        while e.num_active:
            for rid, toks in e.step(2):
                out[rid] = toks
        return [out[r] for r in order]

    assert drain(eng, rids) == drain(jeng, jrids)
    assert eng.pcache.available_pages() == avail0

    real = continuous._prefill_packed_into_pages
    monkeypatch.setattr(continuous, "_prefill_packed_into_pages",
                        lambda *a, **k: real(*a[:5], None, *a[6:], **k))
    ctrl = PagedContinuousEngine(model, num_slots=6, sp=_sp(cfg), attn_impl=attn_impl,
                                 **ENGINE_KW)
    _, bad = _packed_logits(ctrl, prompts)
    # spans of 16 in rows of 32: prompts 0 / 1, 2 / 3 and 4 share rows
    for q in range(5):
        apart = np.allclose(bad[q], logits[q], **TOL)
        assert apart == (q in (0, 2, 4)), q


def test_submit_packed_refuses_vision_and_skips_long_prompts(models):
    _, model = models
    eng = PagedContinuousEngine(model, num_slots=4, sp=_sp(model.cfg), **ENGINE_KW)
    with pytest.raises(ValueError, match="text-only"):
        eng.submit_packed([([5, 6], 2, None, None, None, (np.zeros((4, 48)), [], None))])
    rids = eng.submit_packed([(list(range(2, 42)), 4), ([7, 8, 9], 4)])
    assert rids[0] is None and rids[1] is not None     # 40 tokens: a span past 32


# ---------------------------------------------------------------------------
# the server loop
# ---------------------------------------------------------------------------

def _run_loop(eng, items, decode_window=1, thread=True):
    """Queue every item, then run the loop until each has called back (on
    its own thread, or with thread=False on this one, stopped by the last
    callback); returns (tokens by item, streamed tokens by item)."""
    q, stop = queue.Queue(), threading.Event()
    done = [threading.Event() for _ in items]
    out, streamed = [None] * len(items), [[] for _ in items]
    for n, (ids, mnt) in enumerate(items):
        def cb(rid, toks, n=n):
            out[n] = toks
            done[n].set()
            if all(d.is_set() for d in done):
                stop.set()
        q.put((ids, mnt, cb, None, lambda rid, t, n=n: streamed[n].append(t)))
    eng.decode_window = decode_window
    if not thread:
        eng.run_loop(q, stop)
        return out, streamed
    t = threading.Thread(target=eng.run_loop, args=(q, stop), daemon=True)
    t.start()
    for d in done:
        assert d.wait(120)
    stop.set()
    t.join(10)
    return out, streamed


def _admissions(eng, n_items):
    """Counts the engine's admissions by the loop's route, as the port's
    loop_stats does: admitted rids of submit_packed and submit_batch, the
    rest single."""
    routes = {"packed": 0, "batch": 0}
    for route, name in (("packed", "submit_packed"), ("batch", "submit_batch")):
        real = getattr(eng, name, None)
        if real is not None:
            def call(items, *a, real=real, route=route, **k):
                rids = real(items, *a, **k)
                routes[route] += sum(r is not None for r in rids)
                return rids
            setattr(eng, name, call)
    return lambda: {**routes, "single": n_items - sum(routes.values()), "failed": 0}


@pytest.mark.parametrize("kind", ["slots", "paged"])
def test_run_loop_matches_generate(models, kind):
    """run_loop on both engines: a burst of seven requests (short ones
    packed, the 20- and 30-token ones batched on the paged engine; one at a
    time, budgeted, on the slot engine) with budgets of their own gives the
    JAX engine's run_loop's tokens, streamed tokens and admission routes,
    and each prompt the greedy tokens of the port's generate."""
    jparams, model = models
    cfg = model.cfg
    prompts = _prompts(lens=(5, 9, 20, 7, 13, 30, 4))
    budgets = [6, 3, 5, 6, 2, 4, 6]
    items = list(zip(prompts, budgets))
    window = 4 if kind == "paged" else 1
    eng = (ContinuousEngine(model, num_slots=3, sp=_sp(cfg), max_len=64,
                            prompt_buckets=(16, 32)) if kind == "slots"
           else PagedContinuousEngine(model, num_slots=8, sp=_sp(cfg), **ENGINE_KW))
    out, streamed = _run_loop(eng, items, decode_window=window)
    jsp = jsampling.SamplingParams(pad_token_id=cfg.pad_token_id, eos_token_ids=())
    jeng = (JContinuous(jparams, j_tiny(), num_slots=3, sp=jsp, max_len=64,
                        prompt_buckets=(16, 32)) if kind == "slots"
            else JPaged(jparams, j_tiny(), num_slots=8, sp=jsp, **ENGINE_KW))
    jroutes = _admissions(jeng, len(items))
    jout, jstreamed = _run_loop(jeng, items, decode_window=window, thread=False)
    assert out == jout and streamed == jstreamed
    assert eng.loop_stats == jroutes()
    want = [list(generate(model, np.asarray([p]), np.asarray([len(p)]),
                          SamplingParams(max_new_tokens=n, pad_token_id=cfg.pad_token_id,
                                         eos_token_ids=())).sequences[0][:n])
            for p, n in zip(prompts, budgets)]
    assert out == want and streamed == want
    if kind == "paged":
        assert eng.loop_stats["packed"] == 5 and eng.loop_stats["batch"] == 2
    else:
        assert eng.loop_stats["single"] == len(prompts)


def test_run_loop_answers_a_failed_admission_empty(models, monkeypatch):
    """An admission that raises answers its request with no tokens and
    counts it; the loop serves the next request."""
    _, model = models
    eng = PagedContinuousEngine(model, num_slots=2, sp=_sp(model.cfg), **ENGINE_KW)
    real = eng.submit
    calls = []

    def flaky(*a, **k):
        calls.append(1)
        if len(calls) == 1:
            raise RuntimeError("no pages")
        return real(*a, **k)

    monkeypatch.setattr(eng, "submit", flaky)
    out, _ = _run_loop(eng, [([5, 6, 7], 3)])
    out2, _ = _run_loop(eng, [([5, 6, 7], 3)])
    assert out == [[]] and len(out2[0]) == 3
    assert eng.loop_stats["failed"] == 1 and eng.loop_stats["single"] == 1


# ---------------------------------------------------------------------------
# ChatEngine(continuous=True)
# ---------------------------------------------------------------------------

def _chat_engine(model, **kw):
    return ChatEngine(model, model.cfg, ByteTokenizer(SPECIALS), max_new_tokens=16,
                      continuous=True, engine_kind="paged", num_slots=4, max_len=64,
                      page_size=PS, **kw)


@pytest.mark.parametrize("kv_quant", [None, "int8"])
def test_chat_stop_truncates_and_matches_batch_mode(models, kv_quant):
    """Continuous mode answers as batch mode does (greedy) and truncates at
    stop strings in chat, chat_stream and chat_batch alike."""
    _, model = models
    msgs = [{"role": "user", "content": "hi"}]
    batch = ChatEngine(model, model.cfg, ByteTokenizer(SPECIALS), max_new_tokens=16,
                       kv_quant=kv_quant)
    eng = _chat_engine(model, kv_quant=kv_quant)
    try:
        full = eng.chat(msgs)
        assert full == batch.chat(msgs) and len(full) > 3
        stop = full[2:4]
        out = eng.chat(msgs, stop=stop)
        assert out == full[:full.find(stop)]
        assert "".join(eng.chat_stream(msgs, stop=stop)) == out
        assert "".join(eng.chat_stream(msgs)) == full
        assert eng.chat_batch([msgs, msgs], stop=stop) == [out, out]
    finally:
        eng.shutdown()
    assert not eng._thread.is_alive()


def test_stop_string_cancels_and_frees_the_slot(models):
    """request_cancel finishes a request with its tokens so far at the next
    step and frees its slot; the stop watcher cancels on a stop string."""
    _, model = models
    eng = PagedContinuousEngine(model, num_slots=1, sp=_sp(model.cfg), **ENGINE_KW)
    rid = eng.submit([5, 6, 7], max_new_tokens=30)
    assert eng.step() == []
    eng.request_cancel(rid)
    done = eng.step()
    assert [r for r, _ in done] == [rid] and 1 <= len(done[0][1]) < 30
    assert eng.num_active == 0 and eng.submit([8, 9], max_new_tokens=2) is not None

    chat = _chat_engine(model)
    try:
        cancelled = []
        real = chat._cont.request_cancel
        chat._cont.request_cancel = lambda r: (cancelled.append(r), real(r))
        msgs = [{"role": "user", "content": "hi"}]
        full = chat.chat(msgs, max_tokens=20)
        chat.chat(msgs, max_tokens=20, stop=full[1:3])
        assert len(cancelled) == 1
    finally:
        chat.shutdown()


def _post(url, payload):
    req = urllib.request.Request(f"{url}/v1/chat/completions",
                                 data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())


def test_http_n_choices_stop_and_metrics(models):
    _, model = models
    engine = _chat_engine(model, kv_quant="int8")
    server = serve(engine, host="127.0.0.1", port=0, background=True)
    url = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        msgs = [{"role": "user", "content": "hi"}]
        out = _post(url, {"messages": msgs, "n": 3, "temperature": 0.0})
        assert [c["index"] for c in out["choices"]] == [0, 1, 2]
        texts = [c["message"]["content"] for c in out["choices"]]
        assert texts[0] == texts[1] == texts[2]
        stop = texts[0][1:3]
        out2 = _post(url, {"messages": msgs, "stop": stop})
        assert out2["choices"][0]["message"]["content"] == texts[0][:texts[0].find(stop)]
        with urllib.request.urlopen(f"{url}/metrics", timeout=30) as r:
            m = json.loads(r.read())
        assert set(m) == {"model", "continuous", "spec_decode", "kv_quant", "mesh",
                          "active_requests", "num_slots", "spec_stats", "pages_total",
                          "pages_free", "pages_cached"}
        assert m["continuous"] and m["num_slots"] == 4 and m["kv_quant"] == "int8"
    finally:
        server.shutdown()
        engine.shutdown()


# ---------------------------------------------------------------------------
# apps/serve, apps/test_judge, apps/postprocess
# ---------------------------------------------------------------------------

def test_serve_args_become_engine_keywords(models):
    app, opts, port, device = serve_app.parse_args(
        ["--run.model_preset", "tiny-test", "--port", "8123", "--paged", "--kv-quant",
         "int8", "--decode-window", "8", "--max-len", "2048", "--device", "cpu"])
    assert (app.run.model_preset, port, device) == ("tiny-test", 8123, "cpu")
    assert opts == {"continuous": True, "engine_kind": "paged", "spec_decode": 0,
                    "kv_quant": "int8", "decode_window": 8, "prefill_chunk_tokens": 0,
                    "max_len": 2048}
    _, opts2, port2, device2 = serve_app.parse_args(["--continuous"])
    assert (opts2["continuous"], opts2["engine_kind"], port2, device2) == (
        True, "slots", 8000, "cuda")
    _, model = models
    tok = ByteTokenizer(SPECIALS)
    eng = serve_app.build_engine(app, model, tok, **opts)
    try:
        assert eng.attn_impl == "xla" and eng._cont.decode_window == 8
        assert eng._cont.kv_quant == "int8" and eng._cont.max_len == 2048
    finally:
        eng.shutdown()
    # serve_judge.sh's --spec-decode / --prefill-chunk reach the engine
    _, o, _, _ = serve_app.parse_args(["--paged", "--spec-decode", "8", "--prefill-chunk",
                                       "2048", "--max-len", "4096", "--device", "cpu"])
    assert (o["spec_decode"], o["prefill_chunk_tokens"]) == (8, 2048)
    eng = serve_app.build_engine(app, model, tok, **o)
    try:
        assert (eng._cont.spec_decode, eng._cont.prefill_chunk_tokens) == (8, 2048)
        assert eng.stats()["spec_stats"] == {"spec_dispatches": 0, "spec_rounds": 0,
                                             "spec_tokens": 0, "plain_dispatches": 0}
    finally:
        eng.shutdown()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_serve_cli_serves_on_the_cpu(capsys):
    """`python -m video_r2_tpu_torch.apps.serve --run.model_preset tiny-test
    --paged --kv-quant int8 --device cpu` serves; apps/test_judge gets an
    answer from it (--max-len 128 keeps the answer to the room a slot has
    left: the CLI's default budget is 1024 tokens)."""
    port = _free_port()
    proc = subprocess.Popen(
        [sys.executable, "-m", "video_r2_tpu_torch.apps.serve", "--run.model_preset",
         "tiny-test", "--paged", "--kv-quant", "int8", "--decode-window", "8",
         "--max-len", "128", "--device", "cpu", "--port", str(port)], cwd=REPO,
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
    url = f"http://127.0.0.1:{port}"
    try:
        for _ in range(240):
            try:
                with urllib.request.urlopen(f"{url}/health", timeout=5) as r:
                    assert json.loads(r.read()) == {"status": "ok"}
                break
            except OSError:
                assert proc.poll() is None, proc.stderr.read()
                time.sleep(0.25)
        out = test_judge.main(["--base", f"{url}/v1"])
        assert isinstance(out, str)
        assert "responded in" in capsys.readouterr().out
        with urllib.request.urlopen(f"{url}/metrics", timeout=30) as r:
            m = json.loads(r.read())
        assert m["continuous"] and m["kv_quant"] == "int8" and m["active_requests"] == 0
    finally:
        proc.terminate()
        proc.wait(30)


def _tree(root):
    return {str(p.relative_to(root)): p.read_text().replace(str(root), "<root>")
            for p in sorted(root.rglob("*")) if p.is_file()}


def test_postprocess_against_a_live_server(models, tmp_path, capsys):
    """apps/test_judge and apps/postprocess tac, vas and summarize against a
    live server built by apps/serve (paged engine, int8 pages, decode window
    8, 8 tokens an answer) write what the JAX package's apps/postprocess
    writes against the same server, and no admission failed."""
    _, model = models
    app = AppConfig(run=RunConfig(model_preset="tiny-test"))
    _, opts, _, _ = serve_app.parse_args(["--paged", "--kv-quant", "int8",
                                          "--decode-window", "8"])
    engine = serve_app.build_engine(app, model, ByteTokenizer(SPECIALS), max_new_tokens=8,
                                    **opts)
    server = serve(engine, host="127.0.0.1", port=0, background=True)
    base = f"http://127.0.0.1:{server.server_address[1]}/v1"
    preds = tmp_path / "preds"
    think = "<think>so {a}</think><answer>{a}</answer>"
    for name, rows in (("mvbench_action_count", 2), ("videomme_think", 2)):
        preds.mkdir(exist_ok=True)
        (preds / f"samples_{name}.jsonl").write_text("".join(json.dumps(
            {"doc_id": j, "accuracy": j % 2, "input": f"Question {j}?",
             "filtered_resps": [think.format(a="AB"[j % 2])],
             "doc": {"candidates": ["x", "y"], "answer": "y",
                     "options": ["A. x", "B. y"]}}) + "\n" for j in range(rows)))
    try:
        assert isinstance(test_judge.main(["--base", base]), str)
        outs = {}
        for pkg, mod in (("port", postprocess_app), ("jax", j_postprocess_app)):
            root = tmp_path / pkg
            judge = ["--judge-base", base]
            mod.main(["tac", "--predictions", str(preds), "--out", str(root / "tac"), *judge])
            mod.main(["vas", "--predictions", str(preds), "--out", str(root / "vas"), *judge])
            summary = mod.main(["summarize", "--tac", str(root / "tac"),
                                "--vas", str(root / "vas")])
            outs[pkg] = (_tree(root), summary)
        stats = dict(engine._cont.loop_stats)
    finally:
        server.shutdown()
        engine.shutdown()
    capsys.readouterr()
    assert outs["port"][0] == outs["jax"][0]
    assert outs["port"][1] == outs["jax"][1]
    tree = outs["port"][0]
    assert {"tac/all_summaries.json", "vas/vas_summaries.json",
            "vas/mvbench/per_sample_mvbench.jsonl"} <= set(tree)
    assert set(outs["port"][1]) == {"tac", "vas"} and outs["port"][1]["vas"]
    assert stats["failed"] == 0 and stats["packed"] + stats["batch"] + stats["single"] > 8
