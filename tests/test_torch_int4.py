"""Int4 weight-only serving in the PyTorch port against the JAX package.

CPU only, float32, the tiny config (and the tiny Qwen3-MoE judge of
tests/test_torch_moe.py). Inputs come from numpy seeds and go through both
packages; the JAX package's int4 Pallas kernel runs in interpret mode, as
tests/test_quant.py runs it, and the port's wrapper runs its plain version
on CPU tensors. Tolerances:
- packed nibbles, int8 leaves and greedy tokens exactly equal;
- scales 1e-6 relative (the same float32 division);
- the int4 matmul 1e-5 relative / 1e-4 absolute (tests/test_quant.py's
  bound: float32 sums in another order over K = 512);
- logits 1e-5 and chosen-token logprobs 1e-4 (float32 sums in other orders
  over the layers and the decode steps).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_r2_tpu.engine import sampling as jsampling
from video_r2_tpu.engine.generate import generate as j_generate
from video_r2_tpu.models.config import tiny_test_config as j_tiny
from video_r2_tpu.models.loader import init_params as j_init
from video_r2_tpu.models.model import forward as j_forward
from video_r2_tpu.models.quant import dequantize_kernel_int4 as j_dequant4
from video_r2_tpu.models.quant import quantize_kernel_int4 as j_quant4
from video_r2_tpu.models.quant import quantize_params as j_quantize_params
from video_r2_tpu.ops import int4_matmul as jint4
from video_r2_tpu_torch.engine import sampling
from video_r2_tpu_torch.engine.generate import generate
from video_r2_tpu_torch.models.config import tiny_test_config
from video_r2_tpu_torch.models.convert import flatten_jax_tree, load_jax_params
from video_r2_tpu_torch.models.loader import init_params
from video_r2_tpu_torch.models.model import forward, lm_head_weight
from video_r2_tpu_torch.models.mrope import get_rope_index
from video_r2_tpu_torch.models.quant import (
    dequantize_kernel_int4,
    quantize_kernel_int4,
    quantize_params,
)
from video_r2_tpu_torch.ops import int4_matmul

T = torch.from_numpy


def _np_tree(params):
    return jax.tree.map(np.asarray, params)


def _int4_models(seed: int = 7, group_size: int = 8):
    """The tiny model's weights quantized with bits=4 in both packages:
    (our model, the JAX tree)."""
    jparams = j_init(j_tiny(), seed=seed)
    model = init_params(tiny_test_config(), seed=0, device="cpu")
    load_jax_params(model, _np_tree(jparams))
    quantize_params(model, bits=4, group_size=group_size)
    return model, j_quantize_params(jparams, bits=4, group_size=group_size)


@pytest.fixture(scope="module")
def int4_models():
    return _int4_models()


def test_pack_unpack_match_jax(rng):
    q = rng.integers(-7, 8, size=(2, 64, 24)).astype(np.int8)
    ours = int4_matmul.pack_int4_halves(T(q))
    ref = np.array(jint4.pack_int4_halves(jnp.asarray(q)))
    assert ours.dtype == torch.int8
    np.testing.assert_array_equal(ours.numpy(), ref)
    back = int4_matmul.unpack_int4_halves(T(ref))
    np.testing.assert_array_equal(back.numpy(), np.asarray(jint4.unpack_int4_halves(
        jnp.asarray(ref))))
    np.testing.assert_array_equal(back.numpy(), q)


def test_quantize_kernel_int4_matches_jax(rng):
    w = rng.normal(size=(2, 512, 48)).astype(np.float32)
    ours = quantize_kernel_int4(T(w), group_size=128)
    ref = {k: np.asarray(v) for k, v in j_quant4(jnp.asarray(w), group_size=128).items()}
    np.testing.assert_array_equal(ours["kernel_q4"].numpy(), ref["kernel_q4"])
    np.testing.assert_allclose(ours["scale4"].numpy(), ref["scale4"], rtol=1e-6, atol=0)
    deq = dequantize_kernel_int4(ours, torch.float32, group_size=128)
    np.testing.assert_array_equal(deq.numpy(), np.asarray(j_dequant4(
        {k: jnp.asarray(v) for k, v in ref.items()}, jnp.float32, group_size=128)))
    with pytest.raises(ValueError):                 # K not a multiple of 2 g
        quantize_kernel_int4(T(w[:, :384]), group_size=128)


def test_int4_matmul_plain_matches_jax_kernel(rng):
    """The wrapper's CPU path, layer by layer, against the stacked Pallas
    kernel in interpret mode (tests/test_quant.py's shapes)."""
    L, M, K, N, g = 2, 16, 512, 384, 128
    x = rng.normal(size=(M, K)).astype(np.float32)
    w = rng.normal(size=(L, K, N)).astype(np.float32)
    leaf = j_quant4(jnp.asarray(w), group_size=g)
    before = int4_matmul.int4_matmul.launches
    for layer in range(L):
        ref = jint4.int4_matmul_stacked(jnp.asarray(x), leaf["kernel_q4"], leaf["scale4"],
                                        layer, group_size=g, block_kp=128, block_n=128,
                                        interpret=True)
        ours = int4_matmul.int4_matmul(T(x), T(np.asarray(leaf["kernel_q4"][layer])),
                                       T(np.asarray(leaf["scale4"][layer])))
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-4)
    assert int4_matmul.int4_matmul.launches == before   # CPU tensors launch nothing


def test_int4_matmul_plain_matches_jax_kernel_at_a_tail_width(rng):
    """A width that no 64-column tile divides (as the ViT's gate / up,
    N = 3420): the JAX kernel takes the whole width as its one block."""
    M, K, N, g = 8, 512, 220, 128
    x = rng.normal(size=(M, K)).astype(np.float32)
    leaf = j_quant4(jnp.asarray(rng.normal(size=(1, K, N)).astype(np.float32)), group_size=g)
    ref = jint4.int4_matmul_stacked(jnp.asarray(x), leaf["kernel_q4"], leaf["scale4"], 0,
                                    group_size=g, interpret=True)
    ours = int4_matmul.int4_matmul(T(x), T(np.asarray(leaf["kernel_q4"][0])),
                                   T(np.asarray(leaf["scale4"][0])))
    assert ours.shape == (M, N)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-4)


def test_plain_impl_switches_bypass_the_wrappers(int4_models, monkeypatch):
    """int4_impl="plain" on the linears and decode_attn_impl="plain" on the
    decoder never reach the kernels' wrappers (raising stand-ins here), and
    give the kernel choice's tokens."""
    from video_r2_tpu_torch.models import decoder, layers

    model, _ = int4_models
    ids, lengths = np.arange(2, 26).reshape(2, 12), np.array([12, 9])
    sp = sampling.SamplingParams(max_new_tokens=4, pad_token_id=0, eos_token_ids=())
    ref = generate(model, ids, lengths, sp, decode_impl="kernel")

    def refuse(*a, **k):
        raise AssertionError("a kernel wrapper was called")

    monkeypatch.setattr(layers, "int4_matmul", refuse)
    monkeypatch.setattr(decoder, "decode_attention_stacked", refuse)
    with pytest.raises(AssertionError, match="wrapper was called"):
        generate(model, ids, lengths, sp, decode_impl="kernel")
    try:
        for mod in model.modules():
            if hasattr(mod, "int4_impl"):
                mod.int4_impl = "plain"
        model.model.decode_attn_impl = "plain"
        got = generate(model, ids, lengths, sp, decode_impl="kernel")
    finally:
        for mod in model.modules():
            if hasattr(mod, "int4_impl"):
                mod.int4_impl = "kernel"
        model.model.decode_attn_impl = "kernel"
    np.testing.assert_array_equal(got.sequences, ref.sequences)
    np.testing.assert_allclose(got.logprobs, ref.logprobs, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("group_size", [8, 24])
def test_quantize_params_int4_matches_jax(group_size):
    """bits=4 in place gives the JAX tree leaf by leaf: int4 where K is a
    multiple of 2 g (every linear at g = 8; only the decoder and head at
    g = 24, the ViT and merger staying int8), int8 elsewhere; and a model
    quantized alike loads the quantized JAX tree."""
    model, jq = _int4_models(group_size=group_size)
    flat = flatten_jax_tree(_np_tree(jq))
    params = dict(model.named_parameters())
    assert params.keys() == flat.keys()
    assert params["lm_head.kernel_q4"].dtype == torch.int8
    assert params["lm_head.scale4"].dtype == torch.float32
    vit_int4 = "visual.blocks.0.mlp.down.kernel_q4" in params
    assert vit_int4 == (group_size == 8)
    for name, arr in flat.items():
        if arr.dtype == np.int8:
            np.testing.assert_array_equal(params[name].numpy(), arr, err_msg=name)
        else:
            np.testing.assert_allclose(params[name].numpy(), arr.astype(np.float32),
                                       rtol=1e-6, atol=0, err_msg=name)
    loaded = init_params(tiny_test_config(), seed=4, device="cpu")
    load_jax_params(quantize_params(loaded, bits=4, group_size=group_size), _np_tree(jq))
    for name, p in loaded.named_parameters():
        assert p.dtype == params[name].dtype and torch.equal(p, params[name]), name


def test_int4_forward_matches_jax(int4_models, rng):
    model, jq = int4_models
    ids = rng.integers(2, 400, (2, 11))
    mask = np.ones((2, 11), np.int64)
    mask[1, 8:] = 0
    pos, _ = get_rope_index(ids, model.cfg, attention_mask=mask)
    ours = forward(model, T(ids), T(pos), T(mask))
    ref, _ = j_forward(jq, j_tiny(), jnp.asarray(ids), jnp.asarray(pos), jnp.asarray(mask))
    keep = mask == 1
    np.testing.assert_allclose(ours.numpy()[keep], np.asarray(ref)[keep],
                               rtol=1e-5, atol=1e-5)


def test_lm_head_weight_dequantizes_int4(int4_models):
    """The dense head of an int4 model (the chunked CE's weight) is the JAX
    dequantisation of the same leaf, in bf16."""
    model, jq = int4_models
    ref = j_dequant4(jq["lm_head"], jnp.bfloat16, group_size=8)
    ours = lm_head_weight(model)
    assert ours.dtype == torch.bfloat16
    np.testing.assert_array_equal(ours.float().numpy(), np.asarray(ref, np.float32))


def test_int4_generate_kernel_decode_matches_jax(int4_models, rng):
    """generate(decode_impl="kernel") on the int4 model: the head-major
    cache and the decode kernel's plain version against the JAX package's
    (its Pallas decode kernel in interpret mode), ragged prompts."""
    model, jq = int4_models
    lengths = np.array([13, 9, 11])
    ids = np.zeros((3, 13), np.int64)
    for b, n in enumerate(lengths):
        ids[b, :n] = rng.integers(2, 400, n)
    sp = sampling.SamplingParams(max_new_tokens=7, pad_token_id=0, eos_token_ids=())
    jsp = jsampling.SamplingParams(max_new_tokens=7, pad_token_id=0, eos_token_ids=())
    ours = generate(model, ids, lengths, sp, decode_impl="kernel")
    ref = j_generate(jq, j_tiny(), ids, lengths, jsp, decode_impl="kernel")
    np.testing.assert_array_equal(ours.sequences, np.asarray(ref.sequences))
    np.testing.assert_allclose(ours.logprobs, np.asarray(ref.logprobs), rtol=1e-4, atol=1e-4)
