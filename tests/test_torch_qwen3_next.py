"""The port's Qwen3-Next judge model against the JAX package, on the CPU.

The JAX suite's tiny config (tests/test_qwen3_next.py's tiny_next_config),
fp32, with weights made by init_qwen3_next_params (its norms perturbed, so
the zero-centred scales are not all 1) and carried across by
models/convert.py::load_jax_next_params. Tolerances:
- the delta rule and the triangular inverse: 1e-5 (fp32, the same products
  in other orders);
- logits: relative 1e-4 of the logits' scale, at valid positions only
  (right padding leaves the pad rows' values undefined);
- greedy tokens: exactly equal; sampled paths: the JAX suite's TV-distance
  check (the two packages' random draws differ).
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from video_r2_tpu.engine.sampling import SamplingParams as JSP  # noqa: E402
from video_r2_tpu.models import qwen3_next as J  # noqa: E402
from video_r2_tpu_torch.engine.sampling import SamplingParams  # noqa: E402
from video_r2_tpu_torch.models import qwen3_next as P  # noqa: E402
from video_r2_tpu_torch.models.convert import load_jax_next_params  # noqa: E402

TOL = 1e-5
LOGITS_RTOL = 1e-4

TINY = dict(
    vocab_size=128, hidden_size=32, intermediate_size=64,
    num_hidden_layers=8, full_attention_interval=4,
    num_attention_heads=4, num_key_value_heads=2, head_dim=16,
    partial_rotary_factor=0.25, rope_theta=10000.0,
    linear_num_key_heads=2, linear_num_value_heads=4,
    linear_key_head_dim=8, linear_value_head_dim=8, linear_conv_kernel_dim=4,
    num_experts=8, num_experts_per_tok=2, moe_intermediate_size=16,
    shared_expert_intermediate_size=16, norm_topk_prob=True,
    moe_ragged_decode=False, moe_gmm_prefill=False,
    tie_word_embeddings=False, eos_token_id=1, pad_token_id=0, dtype="float32")


def jax_tree(cfg, seed: int = 0) -> dict:
    """init_qwen3_next_params as numpy, every norm perturbed."""
    tree = jax.tree.map(np.asarray, J.init_qwen3_next_params(cfg, seed=seed))
    rng = np.random.default_rng(seed + 1)

    def perturb(node, name=""):
        if isinstance(node, dict):
            return {k: perturb(v, k) for k, v in node.items()}
        if name in ("in_norm", "post_norm", "q_norm", "k_norm", "final_norm", "norm"):
            return (node + rng.normal(0, 0.1, node.shape)).astype(node.dtype)
        return node
    return perturb(tree)


def pair(tree, **kw):
    """(JAX params, JAX cfg, port model, port cfg) of the tiny config."""
    jcfg, pcfg = J.Qwen3NextConfig(**TINY).replace(**kw), P.Qwen3NextConfig(**TINY).replace(**kw)
    model = P.Qwen3Next(pcfg, dtype=torch.float32, device="cpu")
    load_jax_next_params(model, tree)
    return jax.tree.map(jnp.asarray, tree), jcfg, model, pcfg


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
    cfg = J.Qwen3NextConfig(**TINY)
    return pair(jax_tree(cfg))


@pytest.fixture(scope="module")
def prompts():
    rng = np.random.default_rng(7)
    ids = rng.integers(2, 127, (3, 24))
    lens = np.array([24, 15, 9])
    for b, n in enumerate(lens):
        ids[b, n:] = 0
    return ids, lens


def assert_logits(ours, ref, lens=None):
    ours, ref = np.asarray(ours, np.float32), np.asarray(ref, np.float32)
    scale = np.abs(ref).max()
    if lens is None:
        np.testing.assert_allclose(ours, ref, rtol=0, atol=LOGITS_RTOL * scale)
        return
    for b, n in enumerate(lens):
        np.testing.assert_allclose(ours[b, :n], ref[b, :n], rtol=0, atol=LOGITS_RTOL * scale)


def test_tri_inverse_matches_jax():
    m = np.tril(np.random.default_rng(0).normal(0, 0.5, (3, 16, 16)), -1).astype(np.float32)
    ours = P._tri_inverse(torch.tensor(m)).numpy()
    np.testing.assert_allclose(ours, np.asarray(J._tri_inverse(jnp.asarray(m))), atol=TOL)
    np.testing.assert_allclose(ours @ (np.eye(16) - m), np.broadcast_to(np.eye(16), m.shape),
                               atol=1e-4)


@pytest.mark.parametrize("chunk", [4, 8, 64])
def test_chunk_rule_matches_jax_and_the_recurrence(chunk):
    """The chunked rule equals the JAX one and the port's token-by-token
    recurrence, outputs and final state, from a nonzero initial state."""
    rng = np.random.default_rng(chunk)
    B, S, H, dk, dv = 2, 21, 3, 8, 8
    q, k = (rng.normal(0, 1, (B, S, H, dk)).astype(np.float32) for _ in range(2))
    v = rng.normal(0, 1, (B, S, H, dv)).astype(np.float32)
    g = -np.abs(rng.normal(0, 0.5, (B, S, H))).astype(np.float32)
    beta = rng.uniform(0, 1, (B, S, H)).astype(np.float32)
    s0 = rng.normal(0, 0.3, (B, H, dk, dv)).astype(np.float32)
    T = torch.tensor
    out, st = P.chunk_gated_delta_rule(T(q), T(k), T(v), T(g), T(beta), chunk, T(s0))
    jout, jst = J.chunk_gated_delta_rule(*(jnp.asarray(x) for x in (q, k, v, g, beta)),
                                         chunk_size=chunk, initial_state=jnp.asarray(s0))
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=TOL)
    np.testing.assert_allclose(st.numpy(), np.asarray(jst), atol=TOL)
    state, outs = T(s0), []
    for t in range(S):
        o, state = P.recurrent_gated_delta_step(T(q[:, t]), T(k[:, t]), T(v[:, t]),
                                                T(g[:, t]), T(beta[:, t]), state)
        outs.append(o)
    np.testing.assert_allclose(out.numpy(), torch.stack(outs, 1).numpy(), atol=2e-4)
    np.testing.assert_allclose(st.numpy(), state.numpy(), atol=2e-4)


@pytest.mark.parametrize("chunk", [8, 64])
def test_forward_logits_match_jax(tiny, prompts, chunk):
    """Right-padded logits at valid positions, at two chunk sizes of the
    delta rule (the chunked rule is exact for any chunking)."""
    jp, jcfg, model, cfg = tiny
    ids, lens = prompts
    ref = J.forward(jp, jcfg, jnp.asarray(ids), lengths=jnp.asarray(lens))
    assert_logits(P.forward(model, cfg, ids, lens, chunk_size=chunk), ref, lens)


@pytest.mark.parametrize("kw", [dict(moe_ragged_decode=True, moe_gmm_prefill=True),
                                dict(moe_gmm_decode=True, moe_gmm_prefill=True)],
                         ids=["ragged_decode", "gmm_decode"])
def test_moe_kernel_routes_match_jax(tiny, prompts, kw):
    """The ragged-decode and GMM-prefill routes, and moe_gmm_decode's GMM
    at decode (their kernels' plain versions here) against the JAX
    package's, prefill logits and greedy decode tokens."""
    jp, jcfg, model, cfg = tiny
    ids, lens = prompts
    jk, pk = jcfg.replace(**kw), cfg.replace(**kw)
    if "moe_ragged_decode" in kw:      # the prefill route is the same in both cases
        ref = J.forward(jp, jk, jnp.asarray(ids), lengths=jnp.asarray(lens))
        assert_logits(P.forward(model, pk, ids, lens), ref, lens)
    sp = SamplingParams(max_new_tokens=5)
    np.testing.assert_array_equal(
        P.generate_packed(model, pk, ids, lens, sp).sequences,
        J.generate_packed(jp, jk, ids, lens, JSP(max_new_tokens=5)).sequences)


def test_decode_step_matches_jax(tiny, prompts):
    """prefill then two decode steps: logits and the hybrid cache."""
    jp, jcfg, model, cfg = tiny
    ids, lens = prompts
    jl, jc = J.prefill(jp, jcfg, jnp.asarray(ids), jnp.asarray(lens), 32)
    pl, pc = P.prefill(model, cfg, ids, lens, 32)
    assert_logits(pl, jl)
    tok = np.array([5, 9, 77])
    for _ in range(2):
        jl, jc = J.decode_step(jp, jcfg, jnp.asarray(tok), jc)
        pl, pc = P.decode_step(model, cfg, torch.tensor(tok), pc)
        assert_logits(pl, jl)
        tok = np.asarray(jl).argmax(-1)
    np.testing.assert_allclose(pc.rec.numpy(), np.asarray(jc.rec), atol=1e-4)
    np.testing.assert_allclose(pc.conv.numpy(), np.asarray(jc.conv), atol=1e-5)
    np.testing.assert_array_equal(pc.length.numpy(), np.asarray(jc.length))


def test_generate_packed_greedy_equals_jax(tiny, prompts):
    jp, jcfg, model, cfg = tiny
    ids, lens = prompts
    sp, jsp = (cls(max_new_tokens=8, eos_token_ids=(1,)) for cls in (SamplingParams, JSP))
    ours = P.generate_packed(model, cfg, ids, lens, sp)
    ref = J.generate_packed(jp, jcfg, ids, lens, jsp)
    np.testing.assert_array_equal(ours.sequences, ref.sequences)
    np.testing.assert_array_equal(ours.lengths, ref.lengths)
    np.testing.assert_array_equal(P.generate(model, cfg, ids, lens, 8), ref.sequences)


@pytest.mark.parametrize("bits", [8, 4])
def test_quantized_weights_match_jax(bits, prompts):
    """quantize_qwen3_next_params on both sides (the tiny widths take int8
    everywhere at bits 4 too: no K is a multiple of 2 x 128; the experts are
    int8 whatever the bits), then the same logits and greedy tokens."""
    cfg = J.Qwen3NextConfig(**TINY)
    tree = jax_tree(cfg, seed=3)
    jp, jcfg, model, pcfg = pair(tree)
    jq = J.quantize_qwen3_next_params(jp, bits=bits)
    P.quantize_qwen3_next_params(model, bits=bits)
    assert model.groups[0].lin[0].qkvz.kernel_q is not None
    assert model.groups[0].lin[0].experts.gate.kernel_q is not None
    assert model.groups[0].lin[0].router.kernel is not None         # routing stays float
    ids, lens = prompts
    ref = J.forward(jq, jcfg, jnp.asarray(ids), lengths=jnp.asarray(lens))
    assert_logits(P.forward(model, pcfg, ids, lens), ref, lens)
    np.testing.assert_array_equal(
        P.generate_packed(model, pcfg, ids, lens, SamplingParams(max_new_tokens=5)).sequences,
        J.generate_packed(jq, jcfg, ids, lens, JSP(max_new_tokens=5)).sequences)


def test_serving_quant_matches_jax(prompts):
    """int8 KV strips (the prefill's last logits and its int8 strips, then
    greedy tokens over the quantized cache) with W8A8 prefill linears on
    int8 weights."""
    kw = {"kv_quant": "int8", "act_quant": "int8"}
    cfg = J.Qwen3NextConfig(**TINY)
    jp, jcfg, model, pcfg = pair(jax_tree(cfg, seed=5))
    jq = J.quantize_qwen3_next_params(jp)
    P.quantize_qwen3_next_params(model)
    jcfg, pcfg = jcfg.replace(**kw), pcfg.replace(**kw)
    ids, lens = prompts
    jl, jc = J.prefill(jq, jcfg, jnp.asarray(ids), jnp.asarray(lens), 32)
    pl, pc = P.prefill(model, pcfg, ids, lens, 32)
    assert_logits(pl, jl)
    assert pc.k.dtype == torch.int8
    np.testing.assert_array_equal(pc.k.numpy(), np.asarray(jc.k))
    np.testing.assert_array_equal(
        P.generate_packed(model, pcfg, ids, lens, SamplingParams(max_new_tokens=6)).sequences,
        J.generate_packed(jq, jcfg, ids, lens, JSP(max_new_tokens=6)).sequences)


def test_flash_attn_impl_matches_jax(tiny, prompts):
    """attn_impl="flash": the port's flash wrapper (its plain version on CPU
    tensors) against the JAX Pallas kernel in interpret mode, and greedy
    tokens equal to the dense path's."""
    jp, jcfg, model, cfg = tiny
    ids, lens = prompts
    fj, fp = jcfg.replace(attn_impl="flash"), cfg.replace(attn_impl="flash")
    ref = J.forward(jp, fj, jnp.asarray(ids), lengths=jnp.asarray(lens))
    assert_logits(P.forward(model, fp, ids, lens), ref, lens)
    sp = SamplingParams(max_new_tokens=6)
    np.testing.assert_array_equal(P.generate_packed(model, fp, ids, lens, sp).sequences,
                                  P.generate_packed(model, cfg, ids, lens, sp).sequences)


def test_prefix_store_matches_jax_and_the_packed_path(tiny):
    """NextPrefixStore bursts: greedy tokens equal to generate_packed over
    the whole prompts and to the JAX store's (plain, speculative, and with
    the flash continuation at q_offset); a repeat burst hits; a burst with
    no common prefix falls back to the packed path."""
    from video_r2_tpu.engine.chat import pack_prompts

    jp, jcfg, model, cfg = tiny
    rng = np.random.default_rng(11)
    prefix = rng.integers(2, 127, 64).tolist()
    full = [prefix + rng.integers(2, 127, n).tolist() for n in (7, 12, 3)]
    sp, jsp = SamplingParams(max_new_tokens=6), JSP(max_new_tokens=6)
    store, jstore = P.NextPrefixStore(), J.NextPrefixStore()
    assert store.split(full) == 64
    packed = pack_prompts(full, pad_id=0)
    whole = P.generate_packed(model, cfg, packed.input_ids, packed.lengths, sp)
    ref = jstore.generate(jp, jcfg, full, jsp)
    for spec_k, c in ((0, cfg), (0, cfg.replace(attn_impl="flash")), (4, cfg)):
        got = store.generate(model, c, full, sp, spec_k=spec_k)
        np.testing.assert_array_equal(got.sequences, whole.sequences)
        np.testing.assert_array_equal(got.sequences, ref.sequences)
    assert (store.misses, store.hits) == (1, 2)   # the key is (model, prefix)
    mixed = [rng.integers(2, 127, 20).tolist() for _ in range(2)]
    packed = pack_prompts(mixed, pad_id=0)
    np.testing.assert_array_equal(
        store.generate(model, cfg, mixed, sp).sequences,
        P.generate_packed(model, cfg, packed.input_ids, packed.lengths, sp).sequences)


def test_generate_spec_greedy_equals_jax(tiny):
    """Speculative decoding (K = 3) on repetitive prompts: greedy tokens
    equal to plain greedy's and to the JAX generate_spec's, with EOS cut."""
    jp, jcfg, model, cfg = tiny
    rng = np.random.default_rng(2)
    ids = np.stack([np.tile(rng.integers(2, 127, 4), 6)[:20] for _ in range(2)])
    lens = np.array([20, 17])
    ids[1, 17:] = 0
    sp, jsp = (cls(max_new_tokens=10, eos_token_ids=(1,)) for cls in (SamplingParams, JSP))
    ours = P.generate_spec(model, cfg, ids, lens, sp, spec_k=3)
    plain = P.generate_packed(model, cfg, ids, lens, sp)
    np.testing.assert_array_equal(ours.lengths, plain.lengths)
    for b, n in enumerate(ours.lengths):          # spec pads past EOS
        np.testing.assert_array_equal(ours.sequences[b, :n], plain.sequences[b, :n])
    ref = J.generate_spec(jp, jcfg, ids, lens, jsp, spec_k=3)
    np.testing.assert_array_equal(ours.sequences, ref.sequences)
    np.testing.assert_array_equal(ours.lengths, ref.lengths)


def test_spec_sampled_matches_plain_distribution(tiny):
    """Rejection-sampling spec samples plain sampling's distribution: the
    per-position marginals over many rows agree within the plain-vs-plain
    noise floor (the JAX suite's TV-distance check)."""
    _, _, model, cfg = tiny
    B, T = 256, 3
    row = np.tile(np.random.default_rng(4).integers(2, 127, 5), 4)[:18]
    ids = np.tile(row[None, :], (B, 1))
    lens = np.full((B,), 18)
    kw = dict(do_sample=True, temperature=0.8, top_k=8, max_new_tokens=T)
    sp = SamplingParams(**kw)
    plain = P.generate_packed(model, cfg, ids, lens, sp, seed=11).sequences
    plain2 = P.generate_packed(model, cfg, ids, lens, sp, seed=77).sequences
    spec = P.generate_spec(model, cfg, ids, lens, sp, seed=23, spec_k=3).sequences

    def tv(a, b, t):
        vals = np.union1d(a[:, t], b[:, t])
        return 0.5 * sum(abs((a[:, t] == v).mean() - (b[:, t] == v).mean()) for v in vals)

    for t in range(T):
        floor = tv(plain, plain2, t)
        assert tv(spec, plain, t) < floor + 0.08, t
    assert len(np.unique(plain[:, 0])) >= 3


def test_init_builds_the_jax_tree_shapes():
    """init_qwen3_next_params (torch.Generator on the device) gives every
    leaf of the JAX tree, at its shape, with the initialiser's norms."""
    from video_r2_tpu_torch.models.convert import flatten_next_tree

    cfg = J.Qwen3NextConfig(**TINY)
    flat = flatten_next_tree(jax.tree.map(np.asarray, J.init_qwen3_next_params(cfg)))
    model = P.init_qwen3_next_params(P.Qwen3NextConfig(**TINY), seed=1, device="cpu")
    params = dict(model.named_parameters())
    assert params.keys() == flat.keys()
    for name, arr in flat.items():
        assert tuple(params[name].shape) == arr.shape, name
    assert not model.groups[0].full.q_norm.any() and bool((model.groups[1].lin[2].norm == 1).all())
    assert bool((model.groups[0].lin[0].A_log.exp() >= 0.5).all())
