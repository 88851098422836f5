"""Greedy generation and the demo runner against the JAX package.

Tiny config in float32 on the CPU, the same weights in both packages
(load_jax_params). The JAX side runs attn_impl="flash" (its Pallas flash
kernel in interpret mode); the port runs its flash op, whose CPU path is
the plain version. Greedy tokens must be exactly equal; chosen-token
logprobs agree to 1e-4 (float32, another summation order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_r2_tpu.apps import demo as jdemo
from video_r2_tpu.engine import sampling as jsampling
from video_r2_tpu.engine.generate import generate as j_generate
from video_r2_tpu.models.config import tiny_test_config as j_tiny
from video_r2_tpu.models.loader import init_params as j_init
from video_r2_tpu.models.vision import plan_vision_layout as j_plan
from video_r2_tpu.models.vision import vit_forward as j_vit
from video_r2_tpu_torch.apps import demo
from video_r2_tpu_torch.apps.demo import DemoRunner
from video_r2_tpu_torch.engine import sampling
from video_r2_tpu_torch.engine.chat import (
    ByteTokenizer,
    expand_vision_placeholders,
    pack_prompts,
    render_messages,
)
from video_r2_tpu_torch.engine.generate import generate
from video_r2_tpu_torch.models.config import tiny_test_config
from video_r2_tpu_torch.models.convert import load_jax_params
from video_r2_tpu_torch.models.loader import init_params
from video_r2_tpu_torch.models.mrope import get_rope_index
from video_r2_tpu_torch.video.api import video_features

# ByteTokenizer with the tiny config's special ids (all below its vocab of 512)
SPECIALS = {"<|endoftext|>": 0, "<|im_start|>": 300, "<|im_end|>": 1,
            "<|vision_start|>": 502, "<|vision_end|>": 503,
            "<|image_pad|>": 500, "<|video_pad|>": 501}


@pytest.fixture(scope="module")
def models():
    jparams = j_init(j_tiny(), seed=11)
    model = init_params(tiny_test_config(), seed=0, device="cpu")
    load_jax_params(model, jax.tree.map(np.asarray, jparams))
    return jparams, model


def _prompts(cfg, grids, questions):
    tok = ByteTokenizer(SPECIALS)
    lists = []
    for grid, q in zip(grids, questions):
        content = ([{"type": "video", "video": "v"}] if grid else []) + [
            {"type": "text", "text": q}]
        text = render_messages([{"role": "user", "content": content}])
        if grid:
            text = expand_vision_placeholders(text, [np.prod(grid) // 4], [])
        lists.append(tok.encode(text))
    return pack_prompts(lists, cfg.pad_token_id, pad_to_multiple=16)


@pytest.mark.parametrize("video", [False, True], ids=["text", "video"])
@pytest.mark.parametrize("chunk", [None, 1], ids=["whole", "chunked"])
def test_greedy_generate_token_exact(models, rng, video, chunk):
    jparams, model = models
    cfg = model.cfg
    grids = [(2, 8, 12), (1, 4, 8)] if video else [None, None]
    packed = _prompts(cfg, grids, ["What happens here?", "Why?"])
    S = packed.input_ids.shape[1]
    mask = (np.arange(S)[None] < packed.lengths[:, None]).astype(np.int64)
    kw, jkw = {}, {}
    if video:
        pos, deltas = get_rope_index(
            packed.input_ids, cfg, video_grid_thw=np.array(grids),
            second_per_grid_ts=np.array([1.0, 0.5]), attention_mask=mask)
        n = sum(int(np.prod(g)) for g in grids)
        patches = rng.normal(size=(n, cfg.vision.patch_input_dim)).astype(np.float32)
        vemb = np.asarray(j_vit(jparams["visual"], j_tiny().vision,
                                jnp.asarray(patches), j_plan(grids, j_tiny().vision)))
        common = dict(position_ids=pos, rope_deltas=deltas[:, 0],
                      vision_token_id=cfg.video_token_id)
        kw = dict(common, vision_embeds=torch.from_numpy(vemb.copy()))
        jkw = dict(common, vision_embeds=jnp.asarray(vemb))
    T = 6
    sp = sampling.SamplingParams(max_new_tokens=T, eos_token_ids=(1,),
                                 pad_token_id=cfg.pad_token_id)
    jsp = jsampling.SamplingParams(max_new_tokens=T, eos_token_ids=(1,),
                                   pad_token_id=cfg.pad_token_id)
    ref = j_generate(jparams, j_tiny(), packed.input_ids, packed.lengths, jsp,
                     attn_impl="flash", prefill_chunk=chunk, **jkw)
    ours = generate(model, packed.input_ids, packed.lengths, sp,
                    attn_impl="flash", prefill_chunk=chunk, **kw)
    np.testing.assert_array_equal(ours.sequences, ref.sequences)
    np.testing.assert_array_equal(ours.lengths, ref.lengths)
    np.testing.assert_allclose(ours.logprobs, ref.logprobs, rtol=1e-4, atol=1e-4)


def test_demo_runner_token_exact(models, monkeypatch):
    """End to end from decoded frames: both DemoRunners get the same
    VideoFeatures in place of their file reader (fetch_video)."""
    jparams, model = models
    frames = np.random.default_rng(3).integers(0, 256, (4, 112, 168, 3), np.uint8)
    feats = video_features(frames, 112, 168, sample_fps=1.5)
    monkeypatch.setattr(jdemo, "fetch_video", lambda ele, cfg: feats)
    monkeypatch.setattr(demo, "fetch_video", lambda ele, cfg: feats)
    seen = []
    j_gen = jdemo.generate
    monkeypatch.setattr(jdemo, "generate",
                        lambda *a, **k: seen.append(j_gen(*a, **k)) or seen[-1])
    tok = ByteTokenizer(SPECIALS)
    question = "What is moving?"
    ref = jdemo.DemoRunner(jparams, j_tiny(), tok, impl="flash").answer(
        "clip.mp4", question, max_new_tokens=8)
    runner = DemoRunner(model, tok, impl="flash")
    assert runner.answer("clip.mp4", question, max_new_tokens=8) == ref
    req = runner.prepare(feats, question)
    flash = runner.generate(req, 8)
    np.testing.assert_array_equal(flash.sequences, seen[0].sequences)
    # the same tokens through the plain decoder path
    runner.impl = "xla"
    np.testing.assert_array_equal(runner.generate(req, 8).sequences,
                                  flash.sequences)


def test_sampling_filters_match(rng):
    logits = rng.normal(size=(3, 50)).astype(np.float32) * 3
    for k in (0, 1, 7):
        np.testing.assert_array_equal(
            sampling.apply_top_k(torch.from_numpy(logits), k).numpy(),
            np.asarray(jsampling.apply_top_k(jnp.asarray(logits), k)))
    for p in (1.0, 0.9, 0.3):
        np.testing.assert_array_equal(
            sampling.apply_top_p(torch.from_numpy(logits), p).numpy(),
            np.asarray(jsampling.apply_top_p(jnp.asarray(logits), p)))
    sp = sampling.SamplingParams(do_sample=True, temperature=0.7, top_k=5,
                                 top_p=0.9)
    draws = []
    for _ in range(2):
        g = torch.Generator().manual_seed(4)
        draws.append(torch.stack([sampling.sample_token(torch.from_numpy(logits),
                                                        g, sp) for _ in range(20)]))
    assert torch.equal(draws[0], draws[1])            # seeded
    top5 = np.argsort(-logits, axis=-1)[:, :5]
    for row in range(3):
        assert set(draws[0][:, row].tolist()) <= set(top5[row].tolist())
