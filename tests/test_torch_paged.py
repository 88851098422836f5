"""Paged decode attention, the paged KV cache and the continuous-batching
engines of the PyTorch port, against the JAX package.

CPU only. The JAX side runs its Pallas paged kernels in interpret mode
(as its own tests do, picked by the engine off the TPU); the port's wrappers
run their plain versions on CPU tensors. Same numpy inputs, tiny config in
float32 with the same weights (load_jax_params). Tolerance: 1e-5 absolute
and relative on attention outputs and logits (two float32 softmaxes summed
in different orders); integers, tables and greedy tokens exactly equal.
"""

import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_r2_tpu.engine import sampling as jsampling
from video_r2_tpu.engine.continuous import PagedContinuousEngine as JPaged
from video_r2_tpu.models.config import tiny_test_config as j_tiny
from video_r2_tpu.models.decoder import quantize_kv as j_quantize_kv
from video_r2_tpu.models.loader import init_params as j_init
from video_r2_tpu.models.vision import plan_vision_layout as j_plan
from video_r2_tpu.models.vision import vit_forward as j_vit
from video_r2_tpu.ops import paged_attention as jpaged
from video_r2_tpu_torch.engine import sampling
from video_r2_tpu_torch.engine.continuous import ContinuousEngine, PagedContinuousEngine
from video_r2_tpu_torch.engine.generate import generate
from video_r2_tpu_torch.models.config import tiny_test_config
from video_r2_tpu_torch.models.convert import load_jax_params
from video_r2_tpu_torch.models.decoder import quantize_kv
from video_r2_tpu_torch.models.loader import init_params
from video_r2_tpu_torch.ops import paged_attention as paged

TOL = dict(rtol=1e-5, atol=1e-5)
T = torch.from_numpy
PS = 16                     # page size of every case here


# ---------------------------------------------------------------------------
# ops
# ---------------------------------------------------------------------------

def _tables(rng, lengths, W, n_pages, max_pages):
    """Shuffled distinct pages for each row's keys; unread entries -> page 0."""
    ids = rng.permutation(np.arange(1, n_pages))
    tables = np.zeros((len(lengths), max_pages), np.int32)
    used = 0
    for b, L in enumerate(lengths):
        n = -(-(int(L) + W - 1) // PS)
        tables[b, :n] = ids[used:used + n]
        used += n
    return tables


@pytest.mark.parametrize("case", ["bf16_w1", "page_boundary", "w3", "int8", "one_layer",
                                  "fp32_pages"])
def test_paged_attention_matches_jax(rng, case):
    _paged_case(rng, case, 16)


@pytest.mark.parametrize("case", ["fp32_pages", "w3", "int8", "page_boundary"])
def test_paged_attention_at_head_dim_12_matches_jax(rng, case):
    """The tiny config's head dim 12, fp32 q over fp32 (or int8) pages: the
    shapes the fp32 instance of the paged kernel runs on the card (a row of
    12 elements, padded there to the instance's width of 32)."""
    _paged_case(rng, case, 12)


def _paged_case(rng, case, hd):
    Lyr, kh, nh, n_pages, max_pages = 2, 2, 6, 40, 8
    W = 3 if case == "w3" else 1
    lengths = np.array({"page_boundary": [16, 32, 48]}.get(case, [37, 5, 70]), np.int32)
    tables = _tables(rng, lengths, W, n_pages, max_pages)
    q = rng.normal(size=(3, W, nh, hd) if W > 1 else (3, nh, hd)).astype(np.float32)
    shape = (Lyr, kh, n_pages, PS, hd)
    layer = 1
    if case == "int8":
        k = rng.integers(-127, 128, shape).astype(np.int8)
        v = rng.integers(-127, 128, shape).astype(np.int8)
        ks, vs = (rng.uniform(0.001, 0.05, shape[:-1]).astype(np.float32) for _ in range(2))
        ours = paged.paged_decode_attention_stacked(
            T(q), T(k), T(v), T(tables), T(lengths), layer, PS, T(ks), T(vs))
        ref = jpaged.paged_decode_attention_stacked(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(tables),
            jnp.asarray(lengths), jnp.int32(layer), page_size=PS, interpret=True,
            k_scales=jnp.asarray(ks), v_scales=jnp.asarray(vs))
    elif case == "fp32_pages":
        # float32 queries and pages, as the kernel on the card takes them
        k, v = (rng.normal(size=shape).astype(np.float32) for _ in range(2))
        ours = paged.paged_decode_attention_stacked(
            T(q), T(k), T(v), T(tables), T(lengths), layer, PS)
        ref = jpaged.paged_decode_attention_stacked(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(tables),
            jnp.asarray(lengths), jnp.int32(layer), page_size=PS, interpret=True)
    else:
        # bf16 pages (rounded alike on both sides), float32 queries
        k, v = (rng.normal(size=shape).astype(np.float32) for _ in range(2))
        kt, vt = T(k).to(torch.bfloat16), T(v).to(torch.bfloat16)
        kj, vj = jnp.asarray(k).astype(jnp.bfloat16), jnp.asarray(v).astype(jnp.bfloat16)
        if case == "one_layer":
            before = paged.paged_decode_attention.launches
            ours = paged.paged_decode_attention(T(q), kt[layer], vt[layer], T(tables),
                                                T(lengths), PS)
            assert paged.paged_decode_attention.launches == before  # plain on CPU
            ref = jpaged.paged_decode_attention(
                jnp.asarray(q), kj[layer], vj[layer], jnp.asarray(tables),
                jnp.asarray(lengths), page_size=PS, interpret=True)
        else:
            before = paged.paged_decode_attention_stacked.launches
            ours = paged.paged_decode_attention_stacked(
                T(q), kt, vt, T(tables), T(lengths), layer, PS)
            assert paged.paged_decode_attention_stacked.launches == before
            ref = jpaged.paged_decode_attention_stacked(
                jnp.asarray(q), kj, vj, jnp.asarray(tables), jnp.asarray(lengths),
                jnp.int32(layer), page_size=PS, interpret=True)
    assert ours.shape == q.shape and ours.dtype == torch.float32
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), **TOL)


def test_quantize_kv_matches_jax(rng):
    x = rng.normal(size=(3, 5, 2, 16)).astype(np.float32) * 3
    x[0, 0, 0, :4] = [127.0, 2.5, -3.5, 0.5]        # ties round half to even
    x[1, 1, 1] = 0.0                                # all-zero row: floored scale
    q, s = quantize_kv(T(x))
    jq, js = j_quantize_kv(jnp.asarray(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    assert q[0, 0, 0, :4].tolist() == [127, 2, -4, 0]


def test_filter_logits_per_slot_matches_jax(rng):
    temp = np.array([0.7, 1.0, 2.0], np.float32)
    top_p = np.array([0.9, 1.0, 0.3], np.float32)
    top_k = np.array([5, 0, 1], np.int32)
    for shape in ((3, 64), (3, 2, 64)):
        logits = (rng.normal(size=shape) * 3).astype(np.float32)
        ours = sampling.filter_logits_per_slot(T(logits), T(temp), T(top_p), T(top_k))
        ref = np.asarray(jsampling.filter_logits_per_slot(
            jnp.asarray(logits), jnp.asarray(temp), jnp.asarray(top_p), jnp.asarray(top_k)))
        np.testing.assert_array_equal(ours.numpy() <= -1e29, ref <= -1e29)
        np.testing.assert_allclose(ours.numpy(), ref, **TOL)
    # per-slot sampling: greedy slots take the argmax, sampled ones stay in
    # their filtered support, and a seeded generator repeats its draws
    logits = T((rng.normal(size=(3, 64)) * 3).astype(np.float32))
    do_sample = torch.tensor([True, False, True])
    draws = [torch.stack([sampling.sample_token_per_slot(
        logits, gen, T(temp), T(top_p), T(top_k), do_sample) for _ in range(20)])
        for gen in (torch.Generator().manual_seed(3), torch.Generator().manual_seed(3))]
    assert torch.equal(draws[0], draws[1])
    assert (draws[0][:, 1] == logits[1].argmax()).all()
    kept = sampling.filter_logits_per_slot(logits, T(temp), T(top_p), T(top_k)) > -1e29
    for row in (0, 2):
        assert kept[row, draws[0][:, row]].all()


def _cache_state(c):
    return (c.page_tables.tolist(), c.lengths.tolist(), list(c.free_pages),
            c.refcount.tolist(), list(c.evictable), dict(c.hash_to_page),
            dict(c.page_hash))


@pytest.mark.parametrize("quantized", [False, True], ids=["float", "int8"])
def test_paged_kv_cache_matches_jax(rng, quantized):
    """The same calls (alloc, prefix register / match, copy-on-write share,
    release, LRU eviction, token appends) leave both classes in the same
    state: tables, lengths, free list, refcounts, prefix maps and pools."""
    args = (2, 8, 4, 2, 8, 3, 8)    # layers, pages, page size, kv heads, hd, seqs, max pages
    ours = paged.PagedKVCache.create(*args, dtype=torch.float32, quantized=quantized,
                                     device="cpu")
    ref = jpaged.PagedKVCache.create(*args, dtype=jnp.float32, quantized=quantized)
    hashes = [hashlib.sha256(bytes([i])).digest() for i in range(3)]
    kv_new = [rng.normal(size=(2, 2, 2, 8)).astype(np.float32) for _ in range(6)]

    def script(c, to_arr):
        c.ensure_capacity(0, 9)                       # 3 pages
        c.lengths[0] = 9
        c.cache_pages(hashes[:2], c.page_tables[0, :2].tolist())
        yield c.share_prefix(0, 1, cow_last=True)     # CoW of the partial page
        c.append_token(np.array([0, 1]), to_arr(kv_new[0]), to_arr(kv_new[1]))
        c.release(0)                                  # cached pages -> evictable
        yield c.available_pages()
        hit = c.match_pages(hashes)                   # hits stop at the first miss
        yield hit
        c.release_pages(hit)
        c.release(1)                                  # both cached pages evictable
        yield c.available_pages()
        c.ensure_capacity(2, 28)                      # drains the free list, evicts LRU
        yield c.available_pages()
        c.append_token(np.array([2]), to_arr(kv_new[2][:, :1]), to_arr(kv_new[3][:, :1]))
        with pytest.raises(RuntimeError, match="out of pages"):
            c.ensure_capacity(0, 16)

    got = list(script(ours, T))
    want = list(script(ref, jnp.asarray))
    assert got == want
    assert _cache_state(ours) == _cache_state(ref)
    names = ("k", "v", "k_scale", "v_scale") if quantized else ("k", "v")
    for name in names:
        np.testing.assert_array_equal(getattr(ours, name).numpy(),
                                      np.asarray(getattr(ref, name)))


# ---------------------------------------------------------------------------
# engines
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def models():
    jparams = j_init(j_tiny(), seed=11)
    model = init_params(tiny_test_config(), seed=0, device="cpu")
    load_jax_params(model, jax.tree.map(np.asarray, jparams))
    return jparams, model


ENGINE_KW = dict(num_slots=4, max_len=64, prompt_buckets=(16, 32), page_size=PS,
                 embed_bucket=8)


def _video_item(jparams, seed, budget):
    """A prompt with one 8-token video run and its ViT embeds (numpy)."""
    cfg = j_tiny()
    r = np.random.default_rng(seed)
    grid = (2, 4, 4)
    patches = r.normal(size=(32, cfg.vision.patch_input_dim)).astype(np.float32)
    embeds = np.asarray(j_vit(jparams["visual"], cfg.vision, jnp.asarray(patches),
                              j_plan([grid], cfg.vision)))
    ids = np.concatenate([r.integers(2, 400, 3), [cfg.vision_start_token_id],
                          [cfg.video_token_id] * 8, [cfg.vision_end_token_id],
                          r.integers(2, 400, 4)]).astype(np.int32)
    return list(ids), budget, embeds, [grid], [1.0]


def _scenario(name, eng, emb, steps, jparams):
    """Drive one engine; returns ({submission index: tokens}, logits of the
    active slots after the first step, pages available at start and end).
    emb converts numpy vision embeds to the engine's array type."""
    rng = np.random.default_rng(5)
    prompts = [list(map(int, rng.integers(2, 400, size=n))) for n in (5, 9, 20, 7, 40)]
    avail0 = eng.pcache.available_pages()
    order, out, first = [], {}, None

    def drain(pending=()):
        nonlocal first
        pending = list(pending)
        while eng.num_active or pending:
            for rid, toks in eng.step(steps):
                out[rid] = toks
            if first is None:
                active = [i for i, r in enumerate(eng.slot_req) if r is not None]
                first = np.asarray(eng.last_logits)[active]
            if pending and eng.num_active < eng.num_slots:
                order.append(eng.submit(*pending.pop(0)))

    if name in ("submit", "int8"):
        order += [eng.submit(p, max_new_tokens=n)
                  for p, n in zip(prompts[:3], (3, 10, 6))]
        order.append(eng.submit(prompts[3], max_new_tokens=4))
        assert eng.submit(prompts[4], 2) is None              # pool full
        drain([(prompts[4], 5)])                              # admitted mid-stream
    elif name == "batch_video":
        items = [_video_item(jparams, s, n) for s, n in ((1, 6), (2, 4))]
        batch = [(ids, n, None, None, None, (emb(e), g, s)) for ids, n, e, g, s in items]
        batch.append((prompts[1], 5))
        order += eng.submit_batch(batch)
        drain()
    elif name == "fork":
        for p in (prompts[1], prompts[4][:16]):               # CoW, then page-aligned
            rid = eng.submit(p, max_new_tokens=5)
            order += [rid] + eng.fork(rid, n=2)
            drain()
    elif name == "prefix_hit":
        order.append(eng.submit(prompts[4], max_new_tokens=4))
        drain()
        hit = prompts[4][:35] + prompts[2][:10]
        assert eng.prefix_match_len(hit) == 32                # two full pages cached
        order.append(eng.submit(hit, max_new_tokens=6))
        drain()
    assert None not in order
    return [out[r] for r in order], first, (avail0, eng.pcache.available_pages())


@pytest.mark.parametrize("name", ["submit", "batch_video", "int8", "fork", "prefix_hit"])
def test_paged_engine_matches_jax(models, name):
    """Greedy tokens exactly the JAX paged engine's (its interpret-mode
    kernel), logits after the first step to 1e-5, every page returned; the
    port's window of 4 steps gives the tokens of single steps."""
    jparams, model = models
    cfg = tiny_test_config()
    kv_quant = "int8" if name == "int8" else None
    jeng = JPaged(jparams, j_tiny(), sp=jsampling.SamplingParams(
        pad_token_id=cfg.pad_token_id, eos_token_ids=()), kv_quant=kv_quant, **ENGINE_KW)
    ref, ref_logits, ref_pages = _scenario(name, jeng, jnp.asarray, 1, jparams)
    sp = sampling.SamplingParams(pad_token_id=cfg.pad_token_id, eos_token_ids=())
    for steps in (1, 4):
        eng = PagedContinuousEngine(model, sp=sp, kv_quant=kv_quant, **ENGINE_KW)
        got, logits, pages = _scenario(name, eng, lambda e: T(e.copy()), steps,
                                        jparams)
        assert got == ref, steps
        assert pages[0] == pages[1] == ref_pages[0] == ref_pages[1]
        if steps == 1:
            np.testing.assert_allclose(logits, ref_logits, **TOL)
    if name == "fork":
        assert got[0] == got[1] == got[2] and got[3] == got[4] == got[5]


def test_slot_paged_and_generate_agree(models):
    """The contiguous slot engine, the paged engine and batch generate give
    the same greedy tokens (mid-stream admission included)."""
    _, model = models
    cfg = model.cfg
    rng = np.random.default_rng(8)
    prompts = [list(map(int, rng.integers(2, 400, size=n))) for n in (5, 9, 20, 7)]
    sp = sampling.SamplingParams(pad_token_id=cfg.pad_token_id, eos_token_ids=())
    results = []
    for eng in (ContinuousEngine(model, num_slots=3, max_len=64, sp=sp,
                                 prompt_buckets=(16, 32)),
                PagedContinuousEngine(model, num_slots=3, sp=sp, **{
                    k: v for k, v in ENGINE_KW.items() if k != "num_slots"})):
        rids = [eng.submit(p, max_new_tokens=6) for p in prompts[:3]]
        out = {}
        while eng.num_active or len(rids) < 4:
            for rid, toks in eng.step(steps=2):
                out[rid] = toks
            if len(rids) < 4 and eng.num_active < 3:
                rids.append(eng.submit(prompts[3], max_new_tokens=6))
        results.append([out[r] for r in rids])
    gen = [list(generate(model, np.asarray([p]), np.asarray([len(p)]),
                         sampling.SamplingParams(max_new_tokens=6,
                                                 pad_token_id=cfg.pad_token_id)
                         ).sequences[0]) for p in prompts]
    assert results[0] == results[1] == gen


def test_engine_options_not_ported_raise(models):
    _, model = models
    with pytest.raises(NotImplementedError, match="Queue 1 #8"):
        PagedContinuousEngine(model, page_size=PS, mesh=object())
    # speculative decoding and chunked prefill are ported: taken (the chunk
    # rounded up to a page)
    eng = PagedContinuousEngine(model, page_size=PS, spec_decode=2, prefill_chunk_tokens=20)
    assert (eng.spec_decode, eng.prefill_chunk_tokens) == (2, 2 * PS)
    with pytest.raises(ValueError):
        PagedContinuousEngine(model, page_size=PS, kv_quant="int4")
