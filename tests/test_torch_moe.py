"""The MoE judge slice of the PyTorch port against the JAX package.

CPU only, float32, the tiny MoE config of tests/test_moe.py (H 32, E 8,
top-2, I 16, qk-norm, no attention bias). Inputs come from numpy seeds and
go through both packages; the JAX Pallas grouped FFN runs in interpret mode
(as its own tests run it) and the port's wrapper runs its plain version on
CPU tensors. Tolerances:
- routing weights, MoE outputs and logits: 1e-5 absolute and relative
  (float32 sums in other orders);
- W8A8 outputs: 1e-4: the int8 products are exact on both sides, but a
  rounded activation may land on the other side of a half-step where the
  float scales differ in their last bit;
- integers (expert ids, tables, layouts, int8 weights) and greedy tokens
  and answers exactly equal.
"""

import json
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_r2_tpu.engine import sampling as jsampling
from video_r2_tpu.engine.chat import ByteTokenizer as JByteTokenizer
from video_r2_tpu.engine.continuous import PagedContinuousEngine as JPaged
from video_r2_tpu.engine.generate import generate as j_generate
from video_r2_tpu.engine.server import ChatEngine as JChatEngine
from video_r2_tpu.models import config as jconfig
from video_r2_tpu.models import layers as jlayers
from video_r2_tpu.models import moe as jmoe
from video_r2_tpu.models.loader import init_params as j_init
from video_r2_tpu.models.model import forward as j_forward
from video_r2_tpu.models.quant import quantize_kernel as j_quantize_kernel
from video_r2_tpu.models.quant import quantize_params as j_quantize_params
from video_r2_tpu.ops import moe_gmm as jgmm
from video_r2_tpu.ops import moe_ragged as jragged
from video_r2_tpu_torch.engine import sampling
from video_r2_tpu_torch.engine.chat import IM_END, IM_START, ByteTokenizer
from video_r2_tpu_torch.engine.continuous import PagedContinuousEngine
from video_r2_tpu_torch.engine.generate import generate
from video_r2_tpu_torch.engine.server import ChatEngine, serve
from video_r2_tpu_torch.models import config
from video_r2_tpu_torch.models import layers
from video_r2_tpu_torch.models import moe
from video_r2_tpu_torch.models.convert import flatten_jax_tree, load_jax_params
from video_r2_tpu_torch.models.loader import init_params
from video_r2_tpu_torch.models.model import forward
from video_r2_tpu_torch.models.mrope import get_rope_index
from video_r2_tpu_torch.models.quant import quantize_params
from video_r2_tpu_torch.ops import moe_gmm, moe_ragged
from video_r2_tpu_torch.rewards.judge import EngineJudge, chat_many

TOL = dict(rtol=1e-5, atol=1e-5)
W8A8_TOL = dict(rtol=1e-4, atol=1e-4)
T = torch.from_numpy
H, E, I, K = 32, 8, 16, 2
# ByteTokenizer specials inside the tiny vocab
SPECIALS = {"<|endoftext|>": 256, IM_START: 257, IM_END: 258}


def _configs():
    """The tiny MoE judge in both packages (ours, JAX's), the fast-path
    flags on, the vocabulary holding the byte tokenizer's ids."""
    text = dict(vocab_size=264, hidden_size=H, intermediate_size=64,
                num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
                head_dim_override=16, qk_norm=True, attention_bias=False,
                num_experts=E, num_experts_per_tok=K, moe_intermediate_size=I,
                norm_topk_prob=True, mrope_section=(4, 2, 2), rope_theta=10000.0,
                moe_ragged_decode=True, moe_gmm_prefill=True)
    kw = dict(has_vision=False, bos_token_id=0, eos_token_id=SPECIALS[IM_END],
              pad_token_id=0, dtype="float32")
    return (config.ModelConfig(text=config.TextConfig(**text), **kw),
            jconfig.ModelConfig(text=jconfig.TextConfig(**text), **kw))


def _moe_params(rng):
    return {"router": {"kernel": rng.normal(0, 0.5, (H, E)).astype(np.float32)},
            "experts": {"gate": {"kernel": rng.normal(0, 0.1, (E, H, I)).astype(np.float32)},
                        "up": {"kernel": rng.normal(0, 0.1, (E, H, I)).astype(np.float32)},
                        "down": {"kernel": rng.normal(0, 0.1, (E, I, H)).astype(np.float32)}}}


def _to(tree, fn):
    return {k: _to(v, fn) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


def _quantized(p):
    """Both packages' int8 expert leaves (the JAX quantizer's, as numpy)."""
    q = {"router": p["router"], "experts": {
        n: {k: np.array(v) for k, v in j_quantize_kernel(jnp.asarray(leaf["kernel"])).items()}
        for n, leaf in p["experts"].items()}}
    return _to(q, T), _to(q, jnp.asarray)


# ---------------------------------------------------------------------------
# ops
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("norm", [True, False])
def test_route_matches_jax(rng, norm):
    x = rng.normal(size=(13, H)).astype(np.float32)
    w = rng.normal(0, 0.5, (H, E)).astype(np.float32)
    topv, topi = moe.route(T(w), T(x), 3, norm)
    jv, ji = jmoe.route(jnp.asarray(w), jnp.asarray(x), 3, norm)
    np.testing.assert_array_equal(topi.numpy(), np.asarray(ji))
    np.testing.assert_allclose(topv.numpy(), np.asarray(jv), **TOL)


@pytest.mark.parametrize("cf,group", [(0.0, 64), (1.25, 64), (0.0, 1024)])
def test_grouped_moe_matches_jax(rng, cf, group):
    """The grouped einsum, B*S = 100 tokens (a padded tail group at 64):
    equal to the JAX one, and to the dense oracle at full capacity; the
    drop statistics equal too."""
    p = _moe_params(rng)
    x = rng.normal(size=(2, 50, H)).astype(np.float32)
    ours = moe.moe_mlp(_to(p, T), T(x), K, True, capacity_factor=cf, group_size=group)
    ref = jmoe.moe_mlp(_to(p, jnp.asarray), jnp.asarray(x), K, True,
                       capacity_factor=cf, group_size=group)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), **TOL)
    if cf == 0.0:
        oracle = moe.moe_mlp_dense_oracle(_to(p, T), T(x), K, True)
        np.testing.assert_allclose(ours.numpy(), oracle.numpy(), **TOL)
    stats = moe.capacity_drop_stats(_to(p, T), T(x), K, True, cf, group)
    jstats = jmoe.capacity_drop_stats(_to(p, jnp.asarray), jnp.asarray(x), K, True, cf,
                                      group)
    assert stats.keys() == jstats.keys()
    for key in stats:
        assert stats[key] == pytest.approx(jstats[key], abs=1e-6), key
    lb = moe.load_balancing_loss(T(p["router"]["kernel"]), T(x), K)
    jlb = jmoe.load_balancing_loss(jnp.asarray(p["router"]["kernel"]), jnp.asarray(x), K)
    assert float(lb) == pytest.approx(float(jlb), rel=1e-5)


def test_active_expert_table_matches_jax(rng):
    topi = rng.integers(0, E, (5, K))
    topi[1, 0] = topi[3, 1] = E                     # sentinels: "not routed here"
    ids, a_idx = moe_ragged.active_expert_table(T(topi), E)
    jids, ja = jragged.active_expert_table(jnp.asarray(topi), E)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    np.testing.assert_array_equal(a_idx.numpy(), np.asarray(ja))
    assert (a_idx.numpy()[[1, 3], [0, 1]] == ids.shape[0]).all()
    # no local token at all: in-range ids
    ids, _ = moe_ragged.active_expert_table(T(np.full((2, K), E)), E)
    np.testing.assert_array_equal(ids.numpy(), np.full(4, E - 1))


@pytest.mark.parametrize("variant", ["float", "int8", "w8a8"])
def test_ragged_expert_ffn_matches_jax(rng, variant):
    """The grouped FFN's plain version (the wrapper on CPU tensors) against
    the JAX kernel in interpret mode: slack blocks write zeros, and
    block_i=16 cuts I=32 into two tiles (W8A8 re-quantises h per tile)."""
    Iw, A, C = 32, 6, 8
    p = {"gate": rng.normal(0, 0.1, (E, H, Iw)), "up": rng.normal(0, 0.1, (E, H, Iw)),
         "down": rng.normal(0, 0.1, (E, Iw, H))}
    p = {n: {"kernel": w.astype(np.float32)} for n, w in p.items()}
    ids = np.array([0, 3, 3, 5, 7, 7], np.int32)
    valid = np.array([1, 1, 1, 1, 0, 0], np.int32)
    x = rng.normal(size=(A, C, H)).astype(np.float32)
    kw, jkw = {}, {}
    if variant != "float":
        p = {n: {k: np.array(v) for k, v in j_quantize_kernel(jnp.asarray(l["kernel"])).items()}
             for n, l in p.items()}
    if variant == "w8a8":
        xq, ax = jragged.quantize_rows(jnp.asarray(x))
        oq, oa = moe_ragged.quantize_rows(T(x))
        np.testing.assert_array_equal(oq.numpy(), np.asarray(xq))
        np.testing.assert_array_equal(oa.numpy(), np.asarray(ax))
        x = np.array(xq)
        kw, jkw = dict(x_scales=oa), dict(x_scales=ax)
    before = dict(moe_ragged.ragged_expert_ffn.launches)
    ours = moe_ragged.ragged_expert_ffn(
        T(x), T(ids), *(_to(p[n], T) for n in ("gate", "up", "down")), block_i=16,
        blk_valid=T(valid), **kw)
    ref = jragged.ragged_expert_ffn(
        jnp.asarray(x), jnp.asarray(ids), *(_to(p[n], jnp.asarray) for n in ("gate", "up", "down")),
        block_i=16, interpret=True, blk_valid=jnp.asarray(valid), **jkw)
    assert ours.dtype == torch.float32 and ours.shape == (A, C, H)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref),
                               **(W8A8_TOL if variant == "w8a8" else TOL))
    assert not ours[4:].any()                        # slack blocks: zeros
    assert moe_ragged.ragged_expert_ffn.launches == before   # CPU: plain version
    assert moe_ragged._fit_block_i(512, 16, 2048, 768, 2, 2, 2) == 384   # the judge's bi


@pytest.mark.parametrize("variant", ["float", "int8", "w8a8"])
def test_moe_paths_match_jax(rng, variant):
    """moe_mlp_ragged (T = 5 decode tokens) and moe_mlp_gmm (T = 40 prefill
    tokens, block_rows 8: padded runs and slack blocks) against JAX, and
    both paths through moe_mlp's dispatch with the config flags."""
    p = _moe_params(rng)
    pt, pj = (_to(p, T), _to(p, jnp.asarray)) if variant == "float" else _quantized(p)
    aq = "int8" if variant == "w8a8" else None
    for n in (5, 40):
        x = rng.normal(size=(n, H)).astype(np.float32)
        if n == 5:
            ours = moe_ragged.moe_mlp_ragged(pt, T(x), K, True, act_quant=aq)
            ref = jragged.moe_mlp_ragged(pj, jnp.asarray(x), K, True, interpret=True,
                                         act_quant=aq)
        else:
            ours = moe_gmm.moe_mlp_gmm(pt, T(x), K, True, block_rows=8, act_quant=aq)
            ref = jgmm.moe_mlp_gmm(pj, jnp.asarray(x), K, True, block_rows=8,
                                   interpret=True, act_quant=aq)
        tol = W8A8_TOL if aq else TOL
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), **tol)
        via = moe.moe_mlp(pt, T(x[None]), K, True, act_quant=aq, ragged_decode=True,
                          gmm_prefill=True)
        jvia = jmoe.moe_mlp(pj, jnp.asarray(x[None]), K, True, act_quant=aq,
                            ragged_decode=True, gmm_prefill=True)
        np.testing.assert_allclose(via.numpy(), np.asarray(jvia), **tol)
    if variant == "float":   # exact MoE: the fast paths equal the dense oracle
        np.testing.assert_allclose(
            via.numpy(), moe.moe_mlp_dense_oracle(pt, T(x[None]), K, True).numpy(), **TOL)


@pytest.mark.parametrize("mode,C,H,I,tiles", [
    (0, 128, 2048, 768, (128, 128, 256)),   # the judge's GMM prefill blocks
    (0, 64, 2048, 768, (64, 128, 256)),
    (0, 192, 2048, 768, (64, 128, 256)),    # three 64-row tiles a block
    (0, 256, 2048, 768, (128, 128, 256)),
    (0, 128, 320, 192, (128, 64, 64)),      # widths 128 / 256 do not divide
    (0, 16, 2048, 768, None),               # ragged decode: mma.sync
    (0, 8, 2048, 768, None),
    (0, 40, 2048, 768, None),
    (0, 200, 2048, 768, None),
    (1, 128, 2048, 768, None),              # int8 weights
    (2, 128, 2048, 768, None),              # W8A8
    (1, 64, 2048, 768, None)])
def test_ffn_kernel_dispatch_rule(mode, C, H, I, tiles):
    """Which calls of the grouped FFN take the wgmma kernels, and their tiles
    (rows, gate / up columns, down columns): bf16 blocks of a multiple of
    64 rows."""
    assert moe_ragged.ffn_wgmma_tiles(mode, C, H, I) == tiles


@pytest.mark.parametrize("T", [2048, 4096, 17408])
def test_judge_gmm_prefill_takes_the_wgmma_kernels(T):
    """The judge's GMM prefill (top 8 over 128 experts: the LoRA step's
    2 x 1024 tokens, the table's 4096, a 16-request burst) gets 128-row
    blocks, and so the wgmma path."""
    bm = moe_gmm.auto_block_rows(T * 8, 128)
    assert bm == 128 and moe_ragged.ffn_wgmma_tiles(0, bm, 2048, 768) == (128, 128, 256)


def test_sorted_expert_layout_matches_jax(rng):
    topi = rng.integers(0, E, (11, K))
    topi[4, 1] = E                                   # a sentinel: the trash row
    for bm in (8, 16):
        ours = moe_gmm.sorted_expert_layout(T(topi), E, bm)
        ref = jgmm.sorted_expert_layout(jnp.asarray(topi), E, bm)
        for a, b in zip(ours[:3], ref[:3]):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        assert ours[3] == ref[3]
    for tk in (8, 300, 5000, 40000):
        assert moe_gmm.auto_block_rows(tk, 128) == jgmm.auto_block_rows(tk, 128)


def test_w8a8_linear_matches_jax(rng):
    w = rng.normal(size=(48, 24)).astype(np.float32)
    x = rng.normal(size=(2, 5, 48)).astype(np.float32)
    leaf = {k: np.array(v) for k, v in j_quantize_kernel(jnp.asarray(w)).items()}
    xq, a = layers.quantize_act(T(x))
    jxq, ja = jlayers.quantize_act(jnp.asarray(x))
    np.testing.assert_array_equal(xq.numpy(), np.asarray(jxq))
    np.testing.assert_array_equal(a.numpy(), np.asarray(ja))
    ours = layers._w8a8_linear(T(leaf["kernel_q"]), T(leaf["scale"]), T(x))
    ref = jlayers._w8a8_linear(_to(leaf, jnp.asarray), jnp.asarray(x))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), **TOL)


def test_gmm_under_autograd_and_mesh_raise(rng):
    """The float GMM path differentiates (its backward, the GMM backward
    kernels' plain versions on the CPU, gives every weight a gradient, and
    the same forward as without autograd); a mesh still raises."""
    p = _to(_moe_params(rng), lambda a: T(a).requires_grad_())
    x = T(rng.normal(size=(1, 40, H)).astype(np.float32)).requires_grad_()
    out = moe.moe_mlp(p, x, K, True, gmm_prefill=True)
    out.square().sum().backward()
    assert x.grad is not None and x.grad.abs().sum() > 0
    for leaf in (p["router"], *p["experts"].values()):
        assert leaf["kernel"].grad is not None and leaf["kernel"].grad.abs().sum() > 0
    with torch.no_grad():
        torch.testing.assert_close(moe.moe_mlp(p, x, K, True, gmm_prefill=True), out,
                                   rtol=0, atol=0)
    with pytest.raises(NotImplementedError):
        moe.moe_mlp(p, x, K, True, mesh=object())


# ---------------------------------------------------------------------------
# the tiny judge
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def judge():
    """(our model, JAX params, our config, JAX config): the tiny MoE judge
    with the fast-path flags on, both packages on the same weights."""
    cfg, jcfg = _configs()
    jparams = j_init(jcfg, seed=3)
    model = init_params(cfg, seed=0, device="cpu")
    load_jax_params(model, jax.tree.map(np.asarray, jparams))
    return model, jparams, cfg, jcfg


def test_quantize_params_matches_jax(judge):
    """quantize_params in place gives the JAX quantizer's tree leaf by leaf
    (int8 kernels exactly, their scales, the router and norms kept float),
    and a quantized model loads the quantized JAX tree."""
    _, jparams, cfg, _ = judge
    ours = init_params(cfg, seed=1, device="cpu")
    load_jax_params(ours, jax.tree.map(np.asarray, jparams))
    quantize_params(ours)
    qtree = jax.tree.map(np.asarray, j_quantize_params(jparams))
    flat = flatten_jax_tree(qtree)
    params = dict(ours.named_parameters())
    assert params.keys() == flat.keys()
    assert params["model.layers.1.mlp.experts.down.kernel_q"].dtype == torch.int8
    assert params["model.layers.0.mlp.router.kernel"].dtype == torch.float32
    for name, arr in flat.items():
        if arr.dtype == np.int8:
            np.testing.assert_array_equal(params[name].numpy(), arr, err_msg=name)
        else:
            np.testing.assert_allclose(params[name].numpy(), arr.astype(np.float32),
                                       rtol=1e-6, atol=0, err_msg=name)
    loaded = load_jax_params(quantize_params(init_params(cfg, seed=2, device="cpu")), qtree)
    for name, p in loaded.named_parameters():
        assert p.dtype == params[name].dtype and torch.equal(p, params[name]), name


def _quantized_judge(judge):
    """The judge's weights quantized in both packages."""
    _, jparams, cfg, _ = judge
    ours = init_params(cfg, seed=1, device="cpu")
    load_jax_params(ours, jax.tree.map(np.asarray, jparams))
    return quantize_params(ours), j_quantize_params(jparams)


@pytest.mark.parametrize("S", [5, 24])      # B*S = 10 tokens: ragged; 48: GMM
def test_tiny_judge_logits_match_jax(judge, rng, S):
    model, jparams, cfg, jcfg = judge
    ids = rng.integers(2, 256, (2, S))
    mask = np.ones((2, S), np.int64)
    mask[1, S - 2:] = 0
    pos, _ = get_rope_index(ids, cfg, attention_mask=mask)
    ours = forward(model, ids, pos, mask)
    ref, _ = j_forward(jparams, jcfg, jnp.asarray(ids), jnp.asarray(pos), jnp.asarray(mask))
    keep = mask == 1
    np.testing.assert_allclose(ours.numpy()[keep], np.asarray(ref)[keep], **TOL)


@pytest.mark.parametrize("quant", [False, True], ids=["float", "int8_w8a8"])
def test_tiny_judge_generate_matches_jax(judge, rng, quant):
    """Greedy tokens exactly the JAX generate's: prefill of 3 x 16 tokens
    through the GMM path, decode steps of 3 tokens through the ragged path;
    quantized: W8A8 prefill, int8-weight decode."""
    model, jparams, cfg, jcfg = judge
    if quant:
        model, jparams = _quantized_judge(judge)
    lengths = np.array([9, 16, 6])
    ids = rng.integers(2, 256, (3, 16))
    ids[np.arange(16)[None, :] >= lengths[:, None]] = 0
    aq = "int8" if quant else None
    ours = generate(model, ids, lengths, sampling.SamplingParams(
        max_new_tokens=6, pad_token_id=0, eos_token_ids=()), act_quant=aq)
    ref = j_generate(jparams, jcfg, ids, lengths, jsampling.SamplingParams(
        max_new_tokens=6, pad_token_id=0, eos_token_ids=()), act_quant=aq)
    np.testing.assert_array_equal(ours.sequences, np.asarray(ref.sequences))
    np.testing.assert_allclose(ours.logprobs, np.asarray(ref.logprobs),
                               **(W8A8_TOL if quant else TOL))


def test_chat_batch_matches_jax(judge):
    """ChatEngine.chat_batch answers exactly the JAX ChatEngine's; the judge
    client, chat_many and the HTTP endpoint give the same answers."""
    model, jparams, cfg, jcfg = judge
    msgs = [[{"role": "system", "content": "You judge answers."},
             {"role": "user", "content": f"Question {i}: is 2 + {i} = {2 + i}? yes"}]
            for i in range(3)]
    eng = ChatEngine(model, cfg, ByteTokenizer(SPECIALS), max_new_tokens=5)
    ours = eng.chat_batch(msgs)
    ref = JChatEngine(jparams, jcfg, JByteTokenizer(SPECIALS),
                      max_new_tokens=5).chat_batch(msgs)
    assert ours == ref
    reqs = [(m[0]["content"], m[1]["content"]) for m in msgs]
    assert chat_many(EngineJudge(eng, max_tokens=5), reqs) == ours
    server = serve(eng, host="127.0.0.1", port=0, background=True)
    url = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        req = urllib.request.Request(
            f"{url}/v1/chat/completions", headers={"Content-Type": "application/json"},
            data=json.dumps({"messages": msgs[0], "n": 2, "max_tokens": 5}).encode())
        with urllib.request.urlopen(req, timeout=60) as r:
            out = json.loads(r.read())
        assert [c["message"]["content"] for c in out["choices"]] == [ours[0]] * 2
        with urllib.request.urlopen(f"{url}/metrics", timeout=60) as r:
            assert json.loads(r.read())["continuous"] is False
    finally:
        server.shutdown()


def _drive(eng, prompts, steps):
    """submit, a submit_batch pair, then mid-stream admission; returns the
    tokens in submission order."""
    order = [eng.submit(prompts[0], max_new_tokens=6)]
    order += eng.submit_batch([(prompts[1], 4), (prompts[2], 8)])
    pending, out = [(prompts[3], 5)], {}
    while eng.num_active or pending:
        for rid, toks in eng.step(steps):
            out[rid] = toks
        if pending and eng.num_active < eng.num_slots:
            order.append(eng.submit(*pending.pop(0)))
    assert None not in order
    return [out[r] for r in order]


def test_paged_engine_moe_matches_jax(judge):
    """PagedContinuousEngine serves the MoE judge (qk-norm, ragged decode
    windows, GMM prefill) with greedy tokens exactly the JAX paged engine's;
    a window of 4 steps gives the tokens of single steps."""
    model, jparams, cfg, jcfg = judge
    rng = np.random.default_rng(5)
    prompts = [list(map(int, rng.integers(2, 256, size=n))) for n in (5, 9, 20, 7)]
    kw = dict(num_slots=3, max_len=64, prompt_buckets=(16, 32), page_size=16)
    ref = _drive(JPaged(jparams, jcfg, sp=jsampling.SamplingParams(
        pad_token_id=0, eos_token_ids=()), **kw), prompts, 1)
    sp = sampling.SamplingParams(pad_token_id=0, eos_token_ids=())
    for steps in (1, 4):
        assert _drive(PagedContinuousEngine(model, sp=sp, **kw), prompts, steps) == ref


def test_options_not_ported_raise(judge):
    model, _, cfg, _ = judge
    for kw in ({"continuous": True}, {"spec_decode": 2}, {"mesh": object()},
               {"continuous": True, "kv_quant": "int8"}):
        with pytest.raises(NotImplementedError):
            ChatEngine(model, cfg, ByteTokenizer(SPECIALS), **kw)
    with pytest.raises(NotImplementedError):
        ChatEngine(model, object(), ByteTokenizer(SPECIALS))
