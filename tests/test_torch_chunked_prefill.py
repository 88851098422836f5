"""Chunked prefill in the PyTorch port's engines, against the JAX package.

CPU only, the tiny config in float32 with the JAX weights carried across
(load_jax_params). A prompt longer than prefill_chunk_tokens is prefilled
a chunk a step(), between decode windows: on the slot engine over the
slot's cache with an offset-causal bias, on the paged engine (bf16 and int8
pages) the first chunk through the whole-prompt prefill and the later ones
through the suffix prefill over the pages written so far, a video prompt's
chunks each with its slice of the merged ViT embeds. Greedy tokens equal
the JAX engines' chunked ones exactly, and the logits after the last chunk
theirs within 1e-4 (float32, sums in another order). Over the slot cache
and bf16-layout pages they also equal the whole prompt's prefill (tokens
exactly, logits within 1e-4). Over int8 pages they cannot: a later chunk
attends over the int8-rounded pages of the earlier ones, where the whole
prefill attends over its own unrounded k / v, so the two differ by the
pages' rounding (here from the sixth token on, as in the JAX package,
whose chunked int8 engine gives the port's tokens).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_r2_tpu.engine import sampling as jsampling
from video_r2_tpu.engine.continuous import ContinuousEngine as JContinuous
from video_r2_tpu.engine.continuous import PagedContinuousEngine as JPaged
from video_r2_tpu.models.config import tiny_test_config as j_tiny
from video_r2_tpu.models.loader import init_params as j_init
from video_r2_tpu.models.vision import plan_vision_layout as j_plan
from video_r2_tpu.models.vision import vit_forward as j_vit
from video_r2_tpu_torch.engine import sampling
from video_r2_tpu_torch.engine.continuous import ContinuousEngine, PagedContinuousEngine
from video_r2_tpu_torch.models.config import tiny_test_config
from video_r2_tpu_torch.models.convert import load_jax_params
from video_r2_tpu_torch.models.loader import init_params

PS = 16
LOGITS_TOL = dict(rtol=1e-4, atol=1e-4)
KW = dict(num_slots=2, max_len=96, prompt_buckets=(16, 32, 64))


@pytest.fixture(scope="module")
def models():
    jparams = j_init(j_tiny(), seed=11)
    model = init_params(tiny_test_config(), seed=0, device="cpu")
    load_jax_params(model, jax.tree.map(np.asarray, jparams))
    return jparams, model


def _prompts():
    rng = np.random.default_rng(6)
    return [list(map(int, rng.integers(2, 400, size=n))) for n in (57, 7)]


def _engine(cls, params, engine, chunk, jax_side=False, **extra):
    kw = dict(KW, prefill_chunk_tokens=chunk, **extra)
    if engine != "slots":
        kw.update(page_size=PS, kv_quant="int8" if engine == "paged-int8" else None)
    sp = (jsampling if jax_side else sampling).SamplingParams(pad_token_id=0, eos_token_ids=())
    return cls(*((params, j_tiny()) if jax_side else (params,)), sp=sp, **kw)


def _drain(eng, rids, steps=2):
    out = {}
    while eng.num_active:
        for rid, toks in eng.step(steps):
            out[rid] = [int(t) for t in toks]
    return [out[r] for r in rids]


def _prefilled_logits(eng, prompt, **submit_kw):
    """The pending logits of `prompt` once its prefill (all chunks) is done,
    as numpy (either package's engine)."""
    rid = eng.submit(prompt, max_new_tokens=4, **submit_kw)
    slot = next(i for i, r in enumerate(eng.slot_req) if r is not None and r.rid == rid)
    with torch.inference_mode():     # as step() runs it
        while eng.prefilling[slot]:
            eng._advance_prefill()
    return np.array(eng.last_logits[slot])


@pytest.mark.parametrize("engine", ["slots", "paged", "paged-int8"])
def test_chunked_matches_whole_and_jax(models, engine):
    """A 57-token prompt in chunks of 16 beside a short unchunked one: the
    tokens and the logits after the last chunk of the JAX engine's chunked
    run, and (slots, bf16-layout pages) of the whole prefill."""
    jparams, model = models
    ours_cls, ref_cls = ((ContinuousEngine, JContinuous) if engine == "slots"
                         else (PagedContinuousEngine, JPaged))
    prompts = _prompts()

    def run(eng):
        return _drain(eng, [eng.submit(p, max_new_tokens=6) for p in prompts])

    eng = _engine(ours_cls, model, engine, 16)
    got = run(eng)
    assert got == run(_engine(ref_cls, jparams, engine, 16, jax_side=True))
    if engine != "slots":
        assert eng.pcache.available_pages() == eng.pcache.k.shape[2] - 1
    chunked = _prefilled_logits(_engine(ours_cls, model, engine, 16), prompts[0])
    np.testing.assert_allclose(chunked, _prefilled_logits(
        _engine(ref_cls, jparams, engine, 16, jax_side=True), prompts[0]), **LOGITS_TOL)
    whole = run(_engine(ours_cls, model, engine, 0))
    if engine == "paged-int8":      # the int8 rounding of the earlier chunks' pages
        assert got != whole and got[1] == whole[1]
        return
    assert got == whole
    np.testing.assert_allclose(chunked, _prefilled_logits(_engine(ours_cls, model, engine, 0),
                                                          prompts[0]), **LOGITS_TOL)


def test_chunked_multimodal_matches_whole_and_jax(models):
    """A video prompt whose <|video_pad|> run crosses chunk boundaries: each
    chunk takes its own slice of the embeds; tokens as the whole prefill's
    and the JAX engine's, logits within 1e-4."""
    jparams, model = models
    cfg = model.cfg
    rng = np.random.default_rng(7)
    grid = (6, 4, 4)
    patches = rng.normal(size=(96, cfg.vision.patch_input_dim)).astype(np.float32)
    embeds = np.asarray(j_vit(jparams["visual"], j_tiny().vision, jnp.asarray(patches),
                              j_plan([grid], j_tiny().vision)))
    ids = list(map(int, np.concatenate([[5, 6], [cfg.vision_start_token_id],
                                        [cfg.video_token_id] * 24,
                                        [cfg.vision_end_token_id], [7, 8, 9]])))
    vision = dict(video_grid_thw=[grid], second_per_grid_ts=[1.0])

    def run(eng, emb):
        return _drain(eng, [eng.submit(ids, max_new_tokens=6, vision_embeds=emb, **vision)], 1)

    ours = lambda chunk: _engine(PagedContinuousEngine, model, "paged", chunk,  # noqa: E731
                                 embed_bucket=8)
    got = run(ours(16), torch.from_numpy(embeds.copy()))
    assert got == run(ours(0), torch.from_numpy(embeds.copy()))
    assert got == run(_engine(JPaged, jparams, "paged", 16, jax_side=True, embed_bucket=8),
                      jnp.asarray(embeds))
    logits = [_prefilled_logits(ours(c), ids, vision_embeds=torch.from_numpy(embeds.copy()),
                                **vision) for c in (16, 0)]
    np.testing.assert_allclose(logits[0], logits[1], **LOGITS_TOL)


@pytest.mark.parametrize("engine", ["slots", "paged"])
def test_chunked_prefill_interleaves_decode(models, engine):
    """A decoding stream keeps emitting while a long prompt prefills (the
    admission stalls it one chunk a step, not the whole prompt), and the
    long prompt's answer is the unchunked engine's."""
    _, model = models
    cls = ContinuousEngine if engine == "slots" else PagedContinuousEngine
    short, long_p = _prompts()[1], _prompts()[0]
    eng = _engine(cls, model, engine, 16)
    ra = eng.submit(short, max_new_tokens=12)
    eng.step()
    rb = eng.submit(long_p, max_new_tokens=4)
    assert eng.prefilling.any()
    grew, out = False, {}
    while eng.num_active:
        before = len(eng.slot_req[0].tokens) if eng.slot_req[0] else 0
        prefilling = bool(eng.prefilling.any())
        for rid, toks in eng.step():
            out[rid] = toks
        if prefilling and eng.slot_req[0] is not None and len(eng.slot_req[0].tokens) > before:
            grew = True
    assert grew and len(out[ra]) == 12 and len(out[rb]) == 4
    ref = _engine(cls, model, engine, 0)
    assert out[rb] == _drain(ref, [ref.submit(long_p, max_new_tokens=4)], 1)[0]


def test_chunked_cancel_and_fork_wait_for_the_prefill(models):
    """A cancel of a request still prefilling is deferred until its prefill
    completes (then it finishes with what it has, its pages returned);
    fork refuses it meanwhile."""
    _, model = models
    eng = _engine(PagedContinuousEngine, model, "paged", 16)
    rid = eng.submit(_prompts()[0], max_new_tokens=8)
    with pytest.raises(ValueError, match="chunked prefill"):
        eng.fork(rid, 1)
    eng.request_cancel(rid)
    finished, steps = [], 0
    while eng.num_active:
        was_prefilling = bool(eng.prefilling.any())
        done = eng.step(2)
        steps += 1
        assert not (was_prefilling and done and eng.prefilling.any())
        finished += done
    assert [r for r, _ in finished] == [rid] and steps >= 4      # 4 chunks of 16
    assert eng.pcache.available_pages() == eng.pcache.k.shape[2] - 1


@pytest.mark.parametrize("engine", ["paged", "paged-int8"])
def test_chunked_prefill_with_spec_decode(models, engine):
    """scripts/serve_judge.sh's pairing, small: chunked prefill and
    speculative decoding in one paged engine give the chunked engine's
    plain greedy tokens (bf16-layout pages: the whole prefill's too)."""
    _, model = models
    prompts = _prompts()

    def run(**kw):
        eng = _engine(PagedContinuousEngine, model, engine, **kw)
        return _drain(eng, [eng.submit(p, max_new_tokens=8) for p in prompts])

    got = run(chunk=16, spec_decode=4)
    assert got == run(chunk=16)
    if engine == "paged":
        assert got == run(chunk=0)
