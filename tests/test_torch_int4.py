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

import types

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


# (M, K, N, S on an H100's 132 SMs): the 7B's int4 linears at decode B = 4
# (k / v, q / o, down, gate / up, the head), B = 1 and the merger and ViT
# shapes of a 784-patch clip
SPLIT_CASES = [(4, 3584, 512, 14), (4, 3584, 3584, 8), (4, 18944, 3584, 8),
               (4, 3584, 18944, 1), (4, 3584, 152064, 1), (1, 3584, 18944, 1),
               (1, 3584, 152064, 1), (784, 5120, 5120, 1), (784, 5120, 3584, 1),
               (784, 1280, 3840, 1), (784, 1280, 1280, 1), (784, 1280, 3420, 1)]


@pytest.mark.parametrize("M,K,N,S", SPLIT_CASES)
def test_int4_split_plan_at_the_7b_shapes(M, K, N, S):
    """Split-K where the grid leaves the card idle (k / v: 8 column blocks,
    q / o and down: 56) and one split where it fills the card."""
    assert int4_matmul.int4_split_plan(M, K, N, 132)[0] == S


@pytest.mark.parametrize("M,K,N,sms", [
    (1, 3584, 512, 132), (4, 3584, 3584, 132), (4, 18944, 3584, 132),
    (16, 1280, 3420, 132), (40, 3584, 512, 132), (4, 448, 64, 132), (4, 128, 64, 132),
    (4, 3584, 512, 8), (4, 18944, 3584, 114), (1024, 3584, 64, 132), (1, 18944, 64, 132),
    (40, 18944, 64, 132)])
def test_int4_split_plan_covers_every_stage_once(M, K, N, sms):
    """The splits are consecutive stage ranges over all K / 64 stages, their
    lengths within one stage of each other and at least SPLIT_MIN_STAGES
    when there are several; one split exactly where the grid fills the card
    or K is too short to split; at most SPLIT_MAX (a one-tile matrix at K
    18944 would take 74)."""
    S, ranges = int4_matmul.int4_split_plan(M, K, N, sms)
    stages = K // 64
    assert len(ranges) == S and ranges[0][0] == 0 and ranges[-1][1] == stages
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    lengths = [end - begin for begin, end in ranges]
    assert max(lengths) - min(lengths) <= 1
    assert min(lengths) >= (int4_matmul.SPLIT_MIN_STAGES if S > 1 else 1)
    assert S <= int4_matmul.SPLIT_MAX
    blocks = -(-N // 64) * -(-M // (16 if M <= 16 else 32 if M <= 32 else 64))
    assert int4_matmul.int4_tiles(M, N) == blocks
    assert (S == 1) == (blocks >= sms or stages < 2 * int4_matmul.SPLIT_MIN_STAGES)


# (M, K, N, blocks on an H100's 132 SMs): the 7B's int4 gate / up, down
# and head at decode B = 4 and B = 1 reach the decode kernel, 3 blocks an
# SM; with the size floor lifted, k / v (112 steps: one a block) and a
# 2-step matrix too
DECODE_CASES = [(4, 3584, 18944, 396, None), (4, 18944, 3584, 396, None),
                (4, 3584, 152064, 396, None), (1, 3584, 18944, 396, None),
                (1, 3584, 152064, 396, None), (16, 18944, 3584, 396, None),
                (4, 3584, 3584, 396, 0), (4, 3584, 512, 112, 0), (16, 3584, 512, 112, 0),
                (8, 256, 128, 2, 0)]


@pytest.mark.parametrize("M,K,N,blocks,floor", DECODE_CASES)
def test_int4_decode_plan_at_the_7b_shapes(M, K, N, blocks, floor, monkeypatch):
    """The 7B's large decode linears go to the decode kernel on a grid of 3
    blocks an SM (the kernel's resident count on an H100), or fewer where
    there are too few steps."""
    if floor is not None:
        monkeypatch.setattr(int4_matmul, "DECODE_MIN_BYTES", floor)
    plan = int4_matmul.int4_decode_plan(M, K, N, 128, 132, 3)
    assert plan is not None and plan[0] == blocks
    assert plan[1] == -(-N // 128) and plan[2] == plan[1] * K // 128


@pytest.mark.parametrize("resident", [1, 2, 3, 4])
def test_int4_decode_plan_takes_the_resident_count(resident, monkeypatch):
    """The grid is the kernel's resident blocks an SM times the SMs (gate /
    up: 4144 steps), capped at one step a block (k / v with the size floor
    lifted: 112 steps)."""
    assert int4_matmul.int4_decode_plan(4, 3584, 18944, 128, 132, resident)[0] == 132 * resident
    monkeypatch.setattr(int4_matmul, "DECODE_MIN_BYTES", 0)
    assert int4_matmul.int4_decode_plan(4, 3584, 512, 128, 132, resident)[0] == \
        min(132 * resident, 112)


@pytest.mark.parametrize("M,blocks", [(1, 396), (8, 396), (9, 264), (16, 264), (17, 0)])
def test_int4_launch_plan_takes_the_resident_count_by_rows(M, blocks, monkeypatch):
    """The wrapper's launch plan asks the kernel how many decode blocks an
    SM keeps, for x of up to 8 rows (one x tile) or up to 16 (two: here 3
    and 2 a stand-in reports), and sends more than 16 rows to the staged
    kernel (no decode blocks, its split plan, no tile counters)."""
    monkeypatch.setattr(int4_matmul, "int4_decode_resident", lambda index: (3, 2))
    monkeypatch.setattr(int4_matmul.torch.cuda, "get_device_properties",
                        lambda index: types.SimpleNamespace(multi_processor_count=132))
    int4_matmul._launch_plan.cache_clear()
    try:
        got = int4_matmul._launch_plan(M, 3584, 18944, 128, 0)
    finally:
        int4_matmul._launch_plan.cache_clear()
    assert got == (blocks, 1 if blocks else int4_matmul.int4_split_plan(M, 3584, 18944, 132)[0],
                   148 if blocks else 0)


@pytest.mark.parametrize("M,K,N,g", [(17, 3584, 18944, 128), (784, 5120, 5120, 128),
                                     (4, 3584, 3584, 128), (4, 3584, 512, 128),
                                     (4, 9472, 3420, 128), (4, 9472, 3584, 24),
                                     (4, 9472, 3584, 32), (4, 18944, 3584 + 8, 128)])
def test_int4_decode_plan_leaves_the_rest_to_the_staged_kernel(M, K, N, g):
    """More than 16 rows, fewer than DECODE_MIN_BYTES packed bytes (the
    7B's q / o and k / v), N not a multiple of 16, g not a multiple of a
    step's 64 packed rows: the staged kernel."""
    assert int4_matmul.int4_decode_plan(M, K, N, g, 132, 3) is None


def test_int4_decode_plan_needs_k_in_whole_steps(monkeypatch):
    """K/2 a multiple of 64 packed rows: K = 192 (96 packed rows) is not."""
    monkeypatch.setattr(int4_matmul, "DECODE_MIN_BYTES", 0)
    assert int4_matmul.int4_decode_plan(4, 192, 128, 32, 132, 3) is None
    assert int4_matmul.int4_decode_plan(4, 256, 128, 64, 132, 3) is not None


@pytest.mark.parametrize("M,K,N,g,sms", [(4, 3584, 18944, 128, 132), (4, 18944, 3584, 128, 132),
                                         (4, 3584, 512, 128, 132), (1, 3584, 152064, 128, 114),
                                         (16, 3584, 3584, 64, 132), (4, 256, 96, 64, 132),
                                         (4, 3584, 18944, 256, 7)])
def test_int4_decode_ranges_cover_every_step_once(M, K, N, g, sms, monkeypatch):
    """The blocks' step ranges are consecutive and cover every step once,
    their lengths within one step of each other and at least one step long
    (the size floor lifted for the small shapes)."""
    monkeypatch.setattr(int4_matmul, "DECODE_MIN_BYTES", 0)
    blocks, tiles, steps = int4_matmul.int4_decode_plan(M, K, N, g, sms, 3)
    ranges = int4_matmul.int4_decode_ranges(steps, blocks)
    assert len(ranges) == blocks and ranges[0][0] == 0 and ranges[-1][1] == steps
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    lengths = [end - begin for begin, end in ranges]
    assert max(lengths) - min(lengths) <= 1 and min(lengths) >= 1


@pytest.mark.parametrize("M,K,N", [(4, 3584, 18944), (4, 18944, 3584), (1, 3584, 18944),
                                   (1, 3584, 152064)])
def test_int4_decode_plan_balances_the_sms(M, K, N):
    """At the 7B's shapes every SM reads the same bytes to within a step a
    block: the grid is 3 blocks an SM, and the most steps an SM's three
    blocks can take is within 3 of the mean (8 KB of nibbles a step), where
    the staged kernel's 296 gate / up blocks of 64 columns put 3 on some
    SMs and 2 on the others."""
    blocks, _, steps = int4_matmul.int4_decode_plan(M, K, N, 128, 132, 3)
    assert blocks == 3 * 132
    lengths = sorted(end - begin for begin, end in int4_matmul.int4_decode_ranges(steps, blocks))
    assert sum(lengths[-3:]) <= steps / 132 + 3


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
