"""Serving the port's Qwen3-Next judge against the JAX package, on the CPU.

The slot engine (engine/next_continuous.py: admission, chunked prefill,
speculative rounds, cancel, the budget clamp), ChatEngine in batch and
continuous modes, the HTTP server, apps/common.build_model's Next branch and
the refusals, on tests/test_torch_qwen3_next.py's tiny fp32 config. Greedy
tokens and the texts decoded from them must equal the JAX package's
exactly.
"""

import json
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from tests.test_torch_qwen3_next import TINY, jax_tree, pair  # noqa: E402
from video_r2_tpu.engine.chat import ByteTokenizer as JByteTokenizer  # noqa: E402
from video_r2_tpu.engine.next_continuous import (  # noqa: E402
    Qwen3NextContinuousEngine as JEngine,
)
from video_r2_tpu.engine.sampling import SamplingParams as JSP  # noqa: E402
from video_r2_tpu.engine.server import ChatEngine as JChatEngine  # noqa: E402
from video_r2_tpu.models import qwen3_next as J  # noqa: E402
from video_r2_tpu_torch.engine.chat import ByteTokenizer  # noqa: E402
from video_r2_tpu_torch.engine.next_continuous import Qwen3NextContinuousEngine  # noqa: E402
from video_r2_tpu_torch.engine.sampling import SamplingParams  # noqa: E402
from video_r2_tpu_torch.engine.server import ChatEngine, serve  # noqa: E402
from video_r2_tpu_torch.models import qwen3_next as P  # noqa: E402

SPECIALS = {"<|im_start|>": 2, "<|im_end|>": 1, "<|endoftext|>": 0}


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two intra-op threads: the tiny model's ops gain nothing from more, and
    the suite's parallel workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tiny():
    return pair(jax_tree(J.Qwen3NextConfig(**TINY)))


@pytest.fixture(scope="module")
def chat_pair():
    """The tiny config with a vocabulary over the bytes (the byte
    tokenizer's ids, the specials at 0-2)."""
    return pair(jax_tree(J.Qwen3NextConfig(**TINY).replace(vocab_size=260), seed=9),
                vocab_size=260)


def sp_pair(**kw):
    kw = {"max_new_tokens": 6, "eos_token_ids": (), "pad_token_id": 0, **kw}
    return SamplingParams(**kw), JSP(**kw)


def drive(eng, prompts, T: int, steps: int = 1) -> list:
    """prompts[0:2] admitted, prompts[2] once one finishes (mid-stream), then
    drained; the answers in submission order."""
    rids = [eng.submit(p, T) for p in prompts[:2]]
    done, mid = {}, False
    while eng.num_active or not mid:
        for rid, toks in eng.step(steps):
            done[rid] = list(toks)
        if not mid and done:
            rids.append(eng.submit(prompts[2], T))
            assert rids[-1] is not None
            mid = True
    return [done[r] for r in rids]


def packed_ref(model, cfg, p, sp) -> list:
    return P.generate_packed(model, cfg, np.asarray(p)[None], np.array([len(p)]),
                             sp).sequences[0].tolist()


@pytest.mark.parametrize("spec,steps", [(0, 4), (3, 2)])
def test_slot_engine_matches_jax_engine(tiny, spec, steps):
    """Admission, a full pool, mid-stream admission: greedy tokens equal to
    the JAX slot engine's and to generate_packed's, for plain decode windows
    and speculative rounds (K = 3; repetitive prompts, so drafts land)."""
    jp, jcfg, model, cfg = tiny
    rng = np.random.default_rng(spec + steps)
    prompts = [np.tile(rng.integers(2, 127, 4), 5)[:n].tolist() for n in (9, 14, 5)]
    sp, jsp = sp_pair()
    kw = dict(num_slots=2, max_len=64, prompt_buckets=(16, 32), spec_decode=spec)
    eng = Qwen3NextContinuousEngine(model, cfg, sp=sp, **kw)
    ours = drive(eng, prompts, 6, steps)
    assert eng.submit(prompts[0], 6) is not None
    assert ours == drive(JEngine(jp, jcfg, sp=jsp, **kw), prompts, 6)
    assert ours == [packed_ref(model, cfg, p, sp) for p in prompts]
    if spec:
        st = eng.spec_stats
        assert st["spec_dispatches"] > 0 and st["spec_tokens"] >= st["spec_rounds"]


@pytest.mark.parametrize("spec", [0, 3])
def test_chunked_prefill_matches_jax(tiny, spec):
    """prefill_chunk_tokens=8: a 27-token prompt prefills a chunk a step()
    (a partial last chunk) while a short one decodes; both answers equal the
    un-chunked path's (and, speculating, the JAX chunked engine's). A
    sampled request in the pool keeps the greedy ones exact."""
    jp, jcfg, model, cfg = tiny
    rng = np.random.default_rng(3)
    short, long_p = rng.integers(2, 127, 7).tolist(), rng.integers(2, 127, 27).tolist()
    sp, jsp = sp_pair()
    kw = dict(num_slots=3, max_len=64, prompt_buckets=(8, 32), prefill_chunk_tokens=8,
              spec_decode=spec)

    def run(eng, sampled_sp):
        r0, r1 = eng.submit(short, 6), eng.submit(long_p, 6)
        assert eng.prefilling[1] and not eng.prefilling[0]
        eng.submit(short, 6, sp=sampled_sp)
        done = {}
        while eng.num_active:
            done.update(eng.step())
        return [list(done[r0]), list(done[r1])]

    ours = run(Qwen3NextContinuousEngine(model, cfg, sp=sp, **kw),
               SamplingParams(do_sample=True, temperature=0.9, max_new_tokens=6,
                              pad_token_id=0))
    assert ours == [packed_ref(model, cfg, p, sp) for p in (short, long_p)]
    if spec:
        assert ours == run(JEngine(jp, jcfg, sp=jsp, **kw),
                           JSP(do_sample=True, temperature=0.9, max_new_tokens=6,
                               pad_token_id=0))


def test_cancel_and_budget_clamp(tiny):
    """An over-budget request is clamped to its slot's room; a cancel from
    inside a token callback (lock-free) ends its request after that token."""
    _, _, model, cfg = tiny
    sp, _ = sp_pair(max_new_tokens=8)
    eng = Qwen3NextContinuousEngine(model, cfg, num_slots=2, max_len=32, sp=sp,
                                    prompt_buckets=(16,))
    prompt = np.random.default_rng(0).integers(2, 127, 10).tolist()
    got = {}
    rid = eng.submit(prompt, 100, done_cb=lambda r, t: got.update({r: t}))
    while eng.num_active:
        eng.step(4)
    assert 0 < len(got[rid]) <= 32 - 8 - 1

    def tok_cb(r, t):
        eng.request_cancel(r)

    rid2 = eng.submit(prompt, 8, done_cb=lambda r, t: got.update({r: t}), tok_cb=tok_cb)
    while eng.num_active:
        eng.step()
    assert len(got[rid2]) == 1


def _msgs(n: int, system: str = "You are a strict video-QA judge. " * 4):
    return [[{"role": "system", "content": system},
             {"role": "user", "content": f"rate answer {i}"}] for i in range(n)]


@pytest.mark.parametrize("kw", [{"spec_decode": 3}, {"prefix_cache": False, "kv_quant": "int8"}],
                         ids=["store_spec", "no_store_kv8"])
def test_chat_engine_batch_matches_jax(chat_pair, kw):
    """Batch mode: a judge burst with a shared system prompt gives the JAX
    ChatEngine's texts (the prefix store on with spec decoding; off, over
    int8 KV strips); a repeat burst hits the store."""
    jp, jcfg, model, cfg = chat_pair
    ours = ChatEngine(model, cfg, ByteTokenizer(SPECIALS), max_new_tokens=5, **kw)
    ref = JChatEngine(jp, jcfg, JByteTokenizer(specials=SPECIALS), max_new_tokens=5, **kw)
    msgs = _msgs(3)
    assert ours.chat_batch(msgs) == ref.chat_batch(msgs)
    ours.chat_batch(msgs)
    stats = ours.stats()
    if kw.get("prefix_cache", True):
        assert stats["prefix_cache_hits"] >= 1
    else:
        assert "prefix_cache_hits" not in stats and ours._prefix_store is None


def test_chat_engine_continuous_and_http(chat_pair):
    """Continuous mode (slot engine, spec rounds, chunked prefill) behind
    the HTTP server: concurrent chats give batch mode's greedy texts, a
    stream gives the same text, /metrics shows the slots and spec counters."""
    jp, jcfg, model, cfg = chat_pair
    batch = ChatEngine(model, cfg, ByteTokenizer(SPECIALS), max_new_tokens=5,
                       prefix_cache=False)
    eng = ChatEngine(model, cfg, ByteTokenizer(SPECIALS), max_new_tokens=5, continuous=True,
                     num_slots=2, max_len=512, spec_decode=2, prefill_chunk_tokens=64,
                     decode_window=2)
    srv = serve(eng, host="127.0.0.1", port=0, background=True)
    url = f"http://127.0.0.1:{srv.server_address[1]}"
    try:
        msgs = _msgs(4)
        with ThreadPoolExecutor(max_workers=4) as ex:
            outs = list(ex.map(lambda m: eng.chat(m, max_tokens=5), msgs))
        assert outs == batch.chat_batch(msgs)
        assert "".join(eng.chat_stream(msgs[1], max_tokens=5)) == outs[1]
        body = json.dumps({"messages": msgs[0], "max_tokens": 5, "temperature": 0}).encode()
        req = urllib.request.Request(f"{url}/v1/chat/completions", data=body,
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as r:
            assert json.loads(r.read())["choices"][0]["message"]["content"] == outs[0]
        with urllib.request.urlopen(f"{url}/metrics", timeout=30) as r:
            metrics = json.loads(r.read())
        assert metrics["num_slots"] == 2 and metrics["spec_stats"]["spec_dispatches"] > 0
        assert eng._cont.loop_stats["failed"] == 0
    finally:
        srv.shutdown()
        srv.server_close()
        eng.shutdown()


def test_refusals_name_what_is_not_served(chat_pair):
    """A mesh (Queue 1 #8) raises NotImplementedError; the paged engine and
    continuous kv_quant raise the JAX package's ValueError."""
    _, _, model, cfg = chat_pair
    tok = ByteTokenizer(SPECIALS)
    with pytest.raises(NotImplementedError, match="#8"):
        ChatEngine(model, cfg, tok, mesh=object())
    with pytest.raises(NotImplementedError, match="#8"):
        Qwen3NextContinuousEngine(model, cfg, mesh=object())
    with pytest.raises(ValueError, match="paged"):
        ChatEngine(model, cfg, tok, continuous=True, engine_kind="paged")
    with pytest.raises(ValueError, match="kv_quant"):
        ChatEngine(model, cfg, tok, continuous=True, kv_quant="int8")
    with pytest.raises(ValueError, match="kv_quant"):
        Qwen3NextContinuousEngine(model, cfg.replace(kv_quant="int8"))


def test_presets_and_build_model_next_branch(monkeypatch):
    """The port's MODEL_PRESETS hold the JAX package's keys (the Next preset
    at the 80B's widths); build_model's Next branch builds a seeded
    Qwen3Next on the CPU and quantizes it for weight_quant; a checkpoint
    raises naming Queue 1 #9; apps/serve's engine serves it."""
    from video_r2_tpu import config as jconfig
    from video_r2_tpu_torch import config as pconfig
    from video_r2_tpu_torch.apps import common, serve as serve_app

    assert pconfig.MODEL_PRESETS.keys() == jconfig.MODEL_PRESETS.keys()
    for name in pconfig.MODEL_PRESETS:
        ours, ref = pconfig.MODEL_PRESETS[name](), jconfig.MODEL_PRESETS[name]()
        if name == "qwen3-next-80b-a3b":
            assert ours == P.qwen3_next_80b_a3b()
            assert {f: getattr(ours, f) for f in ours.__dataclass_fields__} == \
                   {f: getattr(ref, f) for f in ref.__dataclass_fields__}
        else:
            assert ours.text.hidden_size == ref.text.hidden_size
            assert ours.text.num_hidden_layers == ref.text.num_hidden_layers
    app = pconfig.parse_config(["--run.model_preset", "qwen3-next-80b-a3b"])
    assert isinstance(app.model_config(), P.Qwen3NextConfig)
    monkeypatch.setitem(pconfig.MODEL_PRESETS, "qwen3-next-80b-a3b",
                        lambda: P.Qwen3NextConfig(**TINY).replace(vocab_size=260))
    app, opts, _, device = serve_app.parse_args([
        "--run.model_preset", "qwen3-next-80b-a3b", "--run.dtype", "float32",
        "--run.weight_quant", "int8", "--continuous", "--spec-decode", "2",
        "--prefill-chunk", "64", "--decode-window", "2", "--max-len", "512",
        "--device", "cpu"])
    model = common.build_model(app, device)
    assert isinstance(model, P.Qwen3Next) and model.device.type == "cpu"
    assert model.groups[0].full.q.kernel_q is not None
    chat = serve_app.build_engine(app, model, ByteTokenizer(SPECIALS), max_new_tokens=4,
                                  num_slots=2, **opts)
    try:
        assert isinstance(chat._cont, Qwen3NextContinuousEngine)
        assert isinstance(chat.chat(_msgs(1)[0]), str)
    finally:
        chat.shutdown()
    assert isinstance(common.build_tokenizer(app), ByteTokenizer)
    with pytest.raises(NotImplementedError, match="#9"):
        common.build_model(pconfig.parse_config(
            ["--run.model_preset", "qwen3-next-80b-a3b", "--run.checkpoint", "/x"]), "cpu")
