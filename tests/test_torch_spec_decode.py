"""Speculative decoding in the PyTorch port, against the JAX package.

CPU only, the tiny config in float32 with the JAX weights carried across
(load_jax_params); the JAX paged engine runs its Pallas kernel in interpret
mode, the port's wrappers their plain versions. Greedy spec tokens (and
generated lengths) are exactly the JAX package's spec tokens and plain
greedy's, in generate (bf16-layout and int8 KV caches), the slot engine and
the paged engine (bf16 and int8 pages), with EOS inside a chunk, budgets
and mid-stream admission; logprobs within 1e-5 (float32 softmaxes summed in
another order). Sampled spec cannot equal JAX's draws (torch.Generator vs
jax.random): it is held to plain sampling's distribution by the JAX suite's
calibrated total-variation test (margin 0.06 over the plain-vs-plain
floor), on the port alone.
"""

import jax
import numpy as np
import pytest
import torch

from video_r2_tpu.engine import sampling as jsampling
from video_r2_tpu.engine.continuous import ContinuousEngine as JContinuous
from video_r2_tpu.engine.continuous import PagedContinuousEngine as JPaged
from video_r2_tpu.engine.generate import generate as j_generate
from video_r2_tpu.models.config import tiny_test_config as j_tiny
from video_r2_tpu.models.loader import init_params as j_init
from video_r2_tpu_torch.engine import sampling
from video_r2_tpu_torch.engine.chat import ByteTokenizer
from video_r2_tpu_torch.engine.continuous import ContinuousEngine, PagedContinuousEngine
from video_r2_tpu_torch.engine.generate import generate
from video_r2_tpu_torch.engine.server import ChatEngine
from video_r2_tpu_torch.models.config import tiny_test_config
from video_r2_tpu_torch.models.convert import load_jax_params
from video_r2_tpu_torch.models.loader import init_params
from video_r2_tpu_torch.ops import paged_attention as paged

PS = 16
SPECIALS = {"<|endoftext|>": 0, "<|im_start|>": 300, "<|im_end|>": 1,
            "<|vision_start|>": 502, "<|vision_end|>": 503,
            "<|image_pad|>": 500, "<|video_pad|>": 501}


@pytest.fixture(scope="module")
def models():
    jparams = j_init(j_tiny(), seed=11)
    model = init_params(tiny_test_config(), seed=0, device="cpu")
    load_jax_params(model, jax.tree.map(np.asarray, jparams))
    return jparams, model


def _prompts():
    """A lookup-friendly prompt (a repeated 5-gram: drafts fire) and two
    random ones."""
    rng = np.random.default_rng(4)
    rep = list(map(int, np.tile(rng.integers(2, 400, size=5), 4)))
    return [rep] + [list(map(int, rng.integers(2, 400, size=n))) for n in (9, 7)]


def _eos(model):
    """An EOS id that plain greedy emits mid-answer for prompt 1."""
    p = _prompts()[1]
    res = generate(model, np.asarray([p]), np.asarray([len(p)]),
                   sampling.SamplingParams(max_new_tokens=12, pad_token_id=0))
    return int(res.sequences[0, 4])


@pytest.mark.parametrize("K,kv_quant", [(2, None), (4, None), (2, "int8"), (4, "int8")])
def test_generate_spec_matches_jax_and_plain(models, K, kv_quant):
    """Ragged right-padded prompts, one row stopping at an EOS inside a
    chunk, the others at the budget: the port's spec tokens are plain
    greedy's for both K over both caches, and the JAX package's (its
    compile is most of the time) for K = 2 over the bf16-layout cache and
    K = 4 over the int8 one."""
    jparams, model = models
    prompts = _prompts()
    S = max(map(len, prompts))
    ids = np.zeros((3, S), np.int32)
    for b, p in enumerate(prompts):
        ids[b, :len(p)] = p
    lens = np.asarray([len(p) for p in prompts])
    eos = (_eos(model),)
    sp = sampling.SamplingParams(max_new_tokens=12, pad_token_id=0, eos_token_ids=eos)
    ours = generate(model, ids, lens, sp, spec_decode=K, kv_quant=kv_quant)
    plain = generate(model, ids, lens, sp, kv_quant=kv_quant)
    np.testing.assert_array_equal(ours.sequences, plain.sequences)
    assert ours.lengths.tolist() == plain.lengths.tolist() and min(ours.lengths) < 12
    np.testing.assert_allclose(ours.logprobs, plain.logprobs, rtol=1e-5, atol=1e-5)
    if (K == 4) == (kv_quant == "int8"):
        ref = j_generate(jparams, j_tiny(), ids, lens,
                         jsampling.SamplingParams(max_new_tokens=12, pad_token_id=0,
                                                  eos_token_ids=eos),
                         spec_decode=K, kv_quant=kv_quant)
        np.testing.assert_array_equal(ours.sequences, np.asarray(ref.sequences))
        np.testing.assert_array_equal(ours.lengths, np.asarray(ref.lengths))
        np.testing.assert_allclose(ours.logprobs, np.asarray(ref.logprobs), rtol=1e-5,
                                   atol=1e-5)


def _drive(eng, prompts, T, steps):
    """Two prompts admitted, the third mid-stream as a slot frees."""
    rids = [eng.submit(p, max_new_tokens=T) for p in prompts[:2]]
    out, admitted = {}, 2
    while eng.num_active or admitted < len(prompts):
        for rid, toks in eng.step(steps):
            out[rid] = [int(t) for t in toks]
        if admitted < len(prompts):
            r = eng.submit(prompts[admitted], max_new_tokens=T)
            if r is not None:
                rids.append(r)
                admitted += 1
    return [out[r] for r in rids]


@pytest.mark.parametrize("engine", ["slots", "paged", "paged-int8"])
def test_engine_spec_matches_jax_and_plain(models, engine):
    """The engines' greedy spec streams equal the JAX engines' spec streams
    and the port's plain engine's, EOS inside a committed chunk included;
    the spec counters equal JAX's."""
    jparams, model = models
    eos = (_eos(model),)
    kw = dict(num_slots=2, max_len=64, prompt_buckets=(32,), spec_decode=3)
    steps = 1
    if engine != "slots":
        kw.update(page_size=PS, kv_quant="int8" if engine == "paged-int8" else None)
        steps = 2
    ours_cls, ref_cls = ((ContinuousEngine, JContinuous) if engine == "slots"
                         else (PagedContinuousEngine, JPaged))
    sp = sampling.SamplingParams(pad_token_id=0, eos_token_ids=eos)
    eng = ours_cls(model, sp=sp, **kw)
    got = _drive(eng, _prompts(), 10, steps)
    plain = _drive(ours_cls(model, sp=sp, **{**kw, "spec_decode": 0}), _prompts(), 10, steps)
    jeng = ref_cls(jparams, j_tiny(), sp=jsampling.SamplingParams(pad_token_id=0,
                                                                  eos_token_ids=eos), **kw)
    ref = _drive(jeng, _prompts(), 10, steps)
    assert got == ref == plain
    assert any(eos[0] in t for t in got) and any(len(t) == 10 for t in got)
    assert eng.spec_stats == jeng.spec_stats and eng.spec_stats["spec_dispatches"] > 0
    if engine != "slots":
        assert eng.pcache.available_pages() == eng.pcache.k.shape[2] - 1   # all returned


def test_reject_all_floor_keeps_tokens(models):
    """_reject_all (the zero-acceptance verify floor): every round commits
    exactly the pending token, and the stream is still plain greedy's."""
    _, model = models
    sp = sampling.SamplingParams(pad_token_id=0, eos_token_ids=())
    kw = dict(num_slots=2, max_len=64, prompt_buckets=(32,), page_size=PS)
    eng = PagedContinuousEngine(model, sp=sp, spec_decode=3, **kw)
    eng._spec_reject_all = True
    commits, dispatch = [], eng._spec_dispatch

    def recorded(active, rounds):
        out = dispatch(active, rounds)
        commits.append(out[1][:, active])
        return out

    eng._spec_dispatch = recorded
    got = _drive(eng, _prompts(), 8, 2)
    assert got == _drive(PagedContinuousEngine(model, sp=sp, **kw), _prompts(), 8, 2)
    assert commits and all((c == 1).all() for c in commits)


def test_mixed_pool_greedy_slot_stays_exact(models):
    """A sampled request and a greedy one speculate together: the greedy
    stream is plain greedy's whatever its neighbour draws."""
    _, model = models
    prompt = _prompts()[2]
    T = 6
    ref = generate(model, np.asarray([prompt]), np.asarray([len(prompt)]),
                   sampling.SamplingParams(max_new_tokens=T, pad_token_id=0))
    for cls, extra in ((ContinuousEngine, {}), (PagedContinuousEngine, {"page_size": PS})):
        eng = cls(model, num_slots=2, max_len=64, prompt_buckets=(16,), spec_decode=3,
                  sp=sampling.SamplingParams(pad_token_id=0, eos_token_ids=()), **extra)
        rid = eng.submit(prompt, max_new_tokens=T)
        hot = eng.submit(_prompts()[1][:5], max_new_tokens=T,
                         sp=sampling.SamplingParams(do_sample=True, temperature=5.0,
                                                    pad_token_id=0, eos_token_ids=()))
        out = {}
        while eng.num_active:
            for r, toks in eng.step(2):
                out[r] = toks
        assert out[rid] == list(ref.sequences[0][:T]) and len(out[hot]) == T, cls


def test_page_exhaustion_falls_back_to_plain(models):
    """A pool too small for the verify window: the engine decodes plain
    (counted) instead of raising, with plain greedy's tokens."""
    _, model = models
    sp = sampling.SamplingParams(pad_token_id=0, eos_token_ids=())
    # the trash page and 3 more: every request fits plain decode's window of
    # 4, no slot's 4 x (K + 1) verify window fits beside the other's
    kw = dict(num_slots=2, max_len=48, sp=sp, page_size=PS, num_pages=4, prompt_buckets=(16,))
    prompts = _prompts()[1:]

    def drain(e):
        rids = [e.submit(p, max_new_tokens=8) for p in prompts]
        out = {}
        while e.num_active:
            for rid, toks in e.step(steps=4):
                out[rid] = toks
        return [out[r] for r in rids]

    eng = PagedContinuousEngine(model, spec_decode=4, **kw)
    assert drain(eng) == drain(PagedContinuousEngine(model, **kw))
    assert eng.spec_stats["plain_dispatches"] > 0


def test_spec_stats_telemetry(models):
    """spec_stats counts dispatches, rounds and committed tokens (JAX's
    test_spec_stats_telemetry)."""
    _, model = models
    eng = ContinuousEngine(model, num_slots=1, max_len=64, prompt_buckets=(16,), spec_decode=3,
                           sp=sampling.SamplingParams(pad_token_id=0, eos_token_ids=()))
    eng.submit(_prompts()[1][:6], max_new_tokens=8)
    while eng.num_active:
        eng.step(steps=2)
    st = eng.spec_stats
    assert st["spec_dispatches"] > 0
    assert st["spec_tokens"] >= 8
    assert st["spec_rounds"] >= st["spec_dispatches"]


def _tv(a, b, t):
    vals = np.union1d(a[:, t], b[:, t])
    pa = np.array([(a[:, t] == v).mean() for v in vals])
    pb = np.array([(b[:, t] == v).mean() for v in vals])
    return 0.5 * np.abs(pa - pb).sum()


def test_spec_sampling_matches_plain_distribution(models):
    """Rejection-sampling verification samples plain sampling's
    distribution: per-position marginals over 1024 rows of one repetitive
    prompt (drafts fire) sit within 0.06 of the plain-vs-plain TV floor;
    at temperature ~0 the sampled spec stream is plain greedy's."""
    _, model = models
    B, T = 1024, 3
    row = np.asarray(_prompts()[0][:20])
    ids, lens = np.tile(row[None], (B, 1)), np.full((B,), 20)
    sp = sampling.SamplingParams(do_sample=True, temperature=0.8, top_k=8, max_new_tokens=T,
                                 pad_token_id=0, eos_token_ids=())
    plain = generate(model, ids, lens, sp, seed=11).sequences
    plain2 = generate(model, ids, lens, sp, seed=77).sequences
    spec = generate(model, ids, lens, sp, seed=23, spec_decode=3).sequences
    for t in range(T):
        floor = _tv(plain, plain2, t)
        assert _tv(spec, plain, t) < floor + 0.06, (t, _tv(spec, plain, t), floor)
    assert len(np.unique(plain[:, 0])) >= 3
    cold = sampling.SamplingParams(do_sample=True, temperature=1e-6, max_new_tokens=8,
                                   pad_token_id=0, eos_token_ids=())
    greedy = generate(model, ids[:2], lens[:2], sampling.SamplingParams(
        max_new_tokens=8, pad_token_id=0, eos_token_ids=()))
    np.testing.assert_array_equal(
        generate(model, ids[:2], lens[:2], cold, spec_decode=4).sequences, greedy.sequences)


def test_paged_kernel_row_limit():
    """The paged kernel's wrapper takes W * (nh / kh) up to 128 query rows
    (the judge's verify chunk at K = 8: 9 x 8 = 72; K = 15 is the last) and
    refuses more by name, before anything reaches the card."""
    assert paged.KERNEL_MAX_ROWS == 128
    paged.check_query_rows(9, 32, 4)        # judge, K = 8
    paged.check_query_rows(9, 28, 4)        # 7B, K = 8: 63 rows
    paged.check_query_rows(16, 32, 4)       # K = 15: 128 rows
    assert [paged.row_groups(r) for r in (7, 63, 64, 65, 72, 128)] == [1, 1, 1, 2, 2, 2]
    with pytest.raises(ValueError, match="136 query rows.*KERNEL_MAX_ROWS = 128"):
        paged.check_query_rows(17, 32, 4)
    with pytest.raises(ValueError, match="do not divide"):
        paged.check_query_rows(1, 28, 3)


def test_chat_engine_spec_modes_match_plain(models):
    """ChatEngine(spec_decode=4) in batch mode and in continuous mode on both
    engine kinds answers as the plain engine does; /metrics' spec_stats
    come from the engine."""
    _, model = models
    tok = ByteTokenizer(SPECIALS)
    msgs = [[{"role": "user", "content": "abcabcabcabc" * k}] for k in (1, 2)]
    want = ChatEngine(model, model.cfg, tok, max_new_tokens=8).chat_batch(msgs)
    for kw in ({}, {"continuous": True}, {"continuous": True, "engine_kind": "paged",
                                          "page_size": PS, "kv_quant": "int8"}):
        eng = ChatEngine(model, model.cfg, tok, max_new_tokens=8, max_len=256, num_slots=2,
                         spec_decode=4, **kw)
        try:
            ref = want
            if kw.get("kv_quant"):
                plain = ChatEngine(model, model.cfg, tok, max_new_tokens=8, max_len=256,
                                   num_slots=2, **kw)
                ref = plain.chat_batch(msgs)
                plain.shutdown()
            assert eng.chat_batch(msgs) == ref, kw
            if kw:
                assert eng.stats()["spec_stats"]["spec_dispatches"] > 0
        finally:
            eng.shutdown()


@pytest.mark.parametrize("backend", ["batch", "paged"])
def test_grpo_rollouts_spec(models, backend):
    """A GRPO cycle with rollout_spec_decode = 4 on each rollout route runs,
    and at top_k = 1 (a one-token target: rejection sampling accepts exactly
    the argmax) its rollouts equal the plain cycle's."""
    from video_r2_tpu_torch.rewards.format import format_reward
    from video_r2_tpu_torch.train import grpo
    from video_r2_tpu_torch.train.grpo_runner import GRPORunner
    from video_r2_tpu_torch.train.lora import (LoRAConfig, attach_lora, detach_lora, init_lora,
                                              make_lora_grpo_step)
    from video_r2_tpu_torch.train.optim import OptimConfig
    from video_r2_tpu_torch.train.sft import init_train_state

    _, model = models
    samples = [{"prompt": [{"role": "user", "content": "abcabcabc what next? abcabc"}],
                "assistant": "<answer>A</answer>", "temporal_grounding": {},
                "temporal_captions": {}}]
    batches = []
    for K in (0, 4):
        gcfg = grpo.GRPOConfig(num_generations=2, max_completion_length=6,
                               max_prompt_length=128, logp_chunk_size=16, top_k=1,
                               rollout_backend=backend, rollout_spec_decode=K)
        lcfg = LoRAConfig(r=2, alpha=4)
        params = attach_lora(model, init_lora(model, lcfg), lcfg)
        run = GRPORunner(model, gcfg, ByteTokenizer(SPECIALS), [format_reward],
                         ["format_reward"], make_lora_grpo_step(model, gcfg), ref_model=model)
        try:
            batch, _ = run.rollout_and_score(samples)
            state, metrics = run.train_cycle(init_train_state(params, OptimConfig()), samples)
            assert np.isfinite(metrics["loss"])
            batches.append(batch["input_ids"].numpy())
        finally:
            detach_lora(model)
    np.testing.assert_array_equal(batches[0], batches[1])


def test_eval_backend_spec_matches_plain(models, tmp_path, monkeypatch):
    """EngineModel(spec_decode=4) in batch and paged mode gives the plain
    backend's rows (eval generation is greedy), and apps/run_eval takes
    --eval.spec_decode."""
    import json

    from tests.test_torch_eval import EVAL_KW, NEW_TOKENS, _docs, _rows
    from tests.test_torch_video import _write_mp4
    from video_r2_tpu_torch.apps import run_eval
    from video_r2_tpu_torch.evalharness import EngineModel, evaluate, get_task

    _, model = models
    tok = ByteTokenizer(SPECIALS)
    for kw in ({"engine_mode": "batch"}, {"engine_mode": "paged", "page_size": PS,
                                          "decode_steps": 2}):
        rows = []
        for K in (0, 4):
            task = get_task("mvbench_think", docs=_docs(n=2))
            task.config.generation_kwargs["max_new_tokens"] = NEW_TOKENS
            rows.append(_rows(evaluate(EngineModel(model, tok, spec_decode=K, **EVAL_KW, **kw),
                                       [task]), "mvbench_think"))
        assert rows[0] == rows[1], kw
    _write_mp4(tmp_path / "v0.mp4", n=8, hw=(56, 56))
    (tmp_path / "docs.json").write_text(json.dumps([{
        "video": "v0.mp4", "question": "What is in the video?", "candidates": ["a", "b"],
        "answer": "a"}]))
    monkeypatch.setenv("VIDEO_EVAL_ROOT", str(tmp_path))
    a, tasks, docs_arg, limit = run_eval.parse_args([
        "--tasks", "mvbench_think", "--docs", str(tmp_path / "docs.json"),
        "--run.model_preset", "tiny-test", "--run.output_dir", str(tmp_path / "out"),
        "--eval.max_num_frames", "4", "--eval.max_pixels", str(56 * 56),
        "--eval.min_pixels", str(4 * 28 * 28), "--eval.spec_decode", "4"])
    assert a.eval.spec_decode == 4
    out = run_eval.run_eval(a, model, tok, tasks, docs_arg, limit)
    assert out["results"]["mvbench_think"]["samples"] == 1
