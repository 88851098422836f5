"""The head-major decode path of the PyTorch port against the JAX package.

CPU only, float32: the decode kernel's plain version against the JAX
``decode_attention_stacked`` in interpret mode (as tests/test_engine.py
runs it), then generate(decode_impl="kernel") (the head-major fill and
Decoder.decode_step) against the JAX generate on the tiny config, with
video embeds through DemoRunner, and on the tiny Qwen3-MoE judge quantized
with bits=4 (attention int4, experts int8). Tolerances: attention outputs
1e-5 (float32 sums in other orders; the kernel's online softmax against one
softmax); greedy tokens exactly equal; chosen-token logprobs 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_generate import SPECIALS, models  # noqa: F401 (fixture)
from tests.test_torch_moe import _configs as moe_configs
from video_r2_tpu.engine import sampling as jsampling
from video_r2_tpu.engine.generate import generate as j_generate
from video_r2_tpu.models.config import tiny_test_config as j_tiny
from video_r2_tpu.models.loader import init_params as j_init
from video_r2_tpu.models.quant import quantize_params as j_quantize_params
from video_r2_tpu.models.vision import plan_vision_layout as j_plan
from video_r2_tpu.models.vision import vit_forward as j_vit
from video_r2_tpu.ops import decode_attention as jdecode
from video_r2_tpu_torch.apps.demo import DemoRunner
from video_r2_tpu_torch.engine import sampling
from video_r2_tpu_torch.engine.chat import ByteTokenizer, pack_prompts
from video_r2_tpu_torch.engine.generate import generate
from video_r2_tpu_torch.models.config import tiny_test_config
from video_r2_tpu_torch.models.convert import load_jax_params
from video_r2_tpu_torch.models.loader import init_params
from video_r2_tpu_torch.models.mrope import get_rope_index
from video_r2_tpu_torch.models.quant import quantize_params
from video_r2_tpu_torch.ops import decode_attention, split
from video_r2_tpu_torch.video.api import video_features

T = torch.from_numpy


def _sps(T_new):
    kw = dict(max_new_tokens=T_new, pad_token_id=0, eos_token_ids=())
    return sampling.SamplingParams(**kw), jsampling.SamplingParams(**kw)


@pytest.mark.parametrize("g", [2, 7])
@pytest.mark.parametrize("window", ["on", "off"])
@pytest.mark.parametrize("layer", [0, 2])
def test_decode_attention_matches_jax_kernel(rng, g, window, layer):
    """Ragged prompt lengths (one reaching into the second block, one past
    s_pad's block start), decode slots [s_pad, slot_end] or none."""
    _decode_case(rng, g, window, layer, 16)


@pytest.mark.parametrize("g", [2, 7])
@pytest.mark.parametrize("window", ["on", "off"])
def test_decode_attention_at_head_dim_12_matches_jax_kernel(rng, g, window):
    """The tiny config's head dim 12 in fp32, as the fp32 instance of the
    decode kernel takes it on the card (padded there to its width of 32)."""
    _decode_case(rng, g, window, 1, 12)


@pytest.mark.parametrize("dtype,hd,want", [
    (torch.bfloat16, 64, "bf16"), (torch.bfloat16, 128, "bf16"),
    (torch.bfloat16, 12, ValueError), (torch.bfloat16, 80, ValueError),
    (torch.bfloat16, 96, ValueError), (torch.bfloat16, 129, ValueError),
    (torch.float32, 1, "fp32"), (torch.float32, 12, "fp32"), (torch.float32, 33, "fp32"),
    (torch.float32, 96, "fp32"), (torch.float32, 128, "fp32"),
    (torch.float32, 0, ValueError), (torch.float32, 129, ValueError),
    (torch.float16, 64, TypeError), (torch.int8, 128, TypeError)])
def test_decode_kernel_instance_routes_by_dtype_and_head_dim(dtype, hd, want):
    """The routing of both decode-attention wrappers (the head-major decode
    and the paged decode) on the card: bf16 to the tensor-core instances at
    head dims 64 / 128, fp32 to the CUDA-core instances at any head dim from
    1 to 128 (padded to a width of 32, 64 or 128), every other dtype
    refused; the paged engine's cache set-up asks the same."""
    from video_r2_tpu_torch.ops.paged_attention import check_kernel_sizes

    if isinstance(want, str):
        assert split.decode_kernel_instance(dtype, hd) == want
        check_kernel_sizes(hd, 128, dtype)
        width = split.split_width(hd)
        assert width in split.DECODE_FP32_WIDTHS and hd <= width   # the smallest that holds hd
        assert all(w < hd for w in split.DECODE_FP32_WIDTHS if w < width)
    else:
        with pytest.raises(want):
            split.decode_kernel_instance(dtype, hd)
        with pytest.raises(want):
            check_kernel_sizes(hd, 128, dtype)


def _decode_case(rng, g, window, layer, hd):
    L, B, kh, smax = 3, 3, 2, 256
    s_pad = 140
    slot_end = s_pad + 5 if window == "on" else s_pad - 1
    lengths = np.array([137, 9, 140], np.int32)
    q = rng.normal(size=(B, kh * g, hd)).astype(np.float32)
    k, v = (rng.normal(size=(L, B, kh, smax, hd)).astype(np.float32) for _ in range(2))
    ref = jdecode.decode_attention_stacked(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(lengths), slot_end,
        layer, s_pad_static=s_pad, interpret=True)
    before = decode_attention.decode_attention_stacked.launches
    ours = decode_attention.decode_attention_stacked(T(q), T(k), T(v), T(lengths),
                                                     slot_end, layer, s_pad)
    assert decode_attention.decode_attention_stacked.launches == before
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


# (blocks = B kh, tiles of 64 keys, S on an H100's 132 SMs): the decode
# kernel at the 7B's B = 4 (kh 4, Smax 1536) and B = 1, and at a 16k cache;
# the paged kernel at the batched slice's B = 8 (12 pages of 128), its
# 48-page view and a chunk's 13 pages; full cards
SPLIT_PATH_CASES = [(16, 24, 8), (4, 24, 8), (16, 256, 24), (32, 24, 8), (32, 96, 12),
                    (32, 26, 8), (8, 8, 2), (132, 24, 1), (256, 40, 1)]


@pytest.mark.parametrize("blocks,tiles,S", SPLIT_PATH_CASES)
def test_decode_split_plan_at_the_path_shapes(blocks, tiles, S):
    """Splits of at least 3 tiles, up to 3 blocks an SM, where B kh leaves
    the card idle; one split where B kh fills it."""
    assert split.decode_split_plan(blocks, tiles, 132)[0] == S


@pytest.mark.parametrize("blocks,tiles,sms", [
    (16, 24, 132), (32, 24, 132), (4, 1, 132), (1, 512, 132), (1, 7, 132), (8, 100, 114),
    (131, 5, 132), (132, 5, 132), (500, 64, 132), (3, 40, 8), (16, 24, 16), (2, 2000, 132)])
def test_decode_split_plan_covers_every_tile_once(blocks, tiles, sms):
    """The splits are consecutive tile ranges over all tiles, their lengths
    within one tile of each other and never empty; S = 1 exactly where the
    blocks fill the card (or too few tiles to split), else the largest S
    that keeps the grid within SPLIT_BLOCKS_PER_SM blocks an SM, splits of
    SPLIT_MIN_TILES tiles and SPLIT_MAX splits."""
    S, ranges = split.decode_split_plan(blocks, tiles, sms)
    assert len(ranges) == S and ranges[0][0] == 0 and ranges[-1][1] == tiles
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    lengths = [end - begin for begin, end in ranges]
    assert max(lengths) - min(lengths) <= 1 and min(lengths) >= 1
    assert 1 <= S <= min(tiles, split.SPLIT_MAX)
    if S > 1:
        assert S * blocks <= split.SPLIT_BLOCKS_PER_SM * sms
        assert min(lengths) >= split.SPLIT_MIN_TILES
    if blocks >= sms or tiles < 2 * split.SPLIT_MIN_TILES:
        assert S == 1
    else:
        assert S == min(split.SPLIT_BLOCKS_PER_SM * sms // blocks,
                        tiles // split.SPLIT_MIN_TILES, split.SPLIT_MAX)


def test_generate_kernel_decode_matches_jax(models, rng):
    """bf16-family weights (the tiny config in float32): decode_impl="kernel"
    gives the JAX kernel path's tokens and logprobs, and the port's own
    "xla" decode's tokens."""
    jparams, model = models
    lengths = np.array([13, 9, 11])
    ids = np.zeros((3, 13), np.int64)
    for b, n in enumerate(lengths):
        ids[b, :n] = rng.integers(2, 400, n)
    sp, jsp = _sps(7)
    ours = generate(model, ids, lengths, sp, decode_impl="kernel")
    ref = j_generate(jparams, j_tiny(), ids, lengths, jsp, decode_impl="kernel")
    np.testing.assert_array_equal(ours.sequences, np.asarray(ref.sequences))
    np.testing.assert_allclose(ours.logprobs, np.asarray(ref.logprobs), rtol=1e-4, atol=1e-4)
    xla = generate(model, ids, lengths, sp, decode_impl="xla")
    np.testing.assert_array_equal(xla.sequences, ours.sequences)


@pytest.mark.parametrize("bits", [None, 4], ids=["float", "int4"])
def test_generate_kernel_decode_with_video_matches_jax(models, bits):
    """Two videos prepared one at a time through DemoRunner (its prompt,
    layout and ViT embeds), right-padded into one generate(decode_impl=
    "kernel", attn_impl="flash") call, against the JAX generate on the JAX
    ViT's embeds of the same patches."""
    jparams, model = models
    if bits:
        model = init_params(tiny_test_config(), seed=0, device="cpu")
        load_jax_params(model, jax.tree.map(np.asarray, jparams))
        quantize_params(model, bits=4, group_size=8)
        jparams = j_quantize_params(jparams, bits=4, group_size=8)
    cfg = model.cfg
    runner = DemoRunner(model, ByteTokenizer(SPECIALS), impl="flash")
    feats = [video_features(np.random.default_rng(20 + i).integers(
        0, 256, (n, 112, 168, 3), np.uint8), 112, 168, sample_fps=1.5)
        for i, n in enumerate((4, 2))]
    reqs = [runner.prepare(f, q) for f, q in zip(feats, ("What moves?", "Why?"))]
    packed = pack_prompts([list(r.input_ids[0, :int(r.lengths[0])]) for r in reqs],
                          cfg.pad_token_id)
    S = packed.input_ids.shape[1]
    mask = (np.arange(S)[None] < packed.lengths[:, None]).astype(np.int64)
    pos, deltas = get_rope_index(
        packed.input_ids, cfg, video_grid_thw=np.array([f.grid_thw for f in feats]),
        second_per_grid_ts=np.array([f.second_per_grid_t for f in feats]),
        attention_mask=mask)
    vemb = torch.cat([runner.vision_embeds(r) for r in reqs])
    jemb = jnp.concatenate([j_vit(jparams["visual"], j_tiny().vision, jnp.asarray(f.patches),
                                  j_plan([f.grid_thw], j_tiny().vision)) for f in feats])
    common = dict(position_ids=pos, rope_deltas=deltas[:, 0], attn_impl="flash",
                  vision_token_id=cfg.video_token_id, decode_impl="kernel")
    sp, jsp = _sps(6)
    ours = generate(model, packed.input_ids, packed.lengths, sp, vision_embeds=vemb,
                    **common)
    ref = j_generate(jparams, j_tiny(), packed.input_ids, packed.lengths, jsp,
                     vision_embeds=jemb, **common)
    np.testing.assert_array_equal(ours.sequences, np.asarray(ref.sequences))
    np.testing.assert_allclose(ours.logprobs, np.asarray(ref.logprobs), rtol=1e-4, atol=1e-4)


def test_moe_judge_int4_kernel_decode_matches_jax(rng):
    """The tiny Qwen3-MoE judge quantized with bits=4 (attention and head
    int4, experts int8): qk-norm, ragged MoE decode and the decode kernel's
    step, against the JAX package's."""
    cfg, jcfg = moe_configs()
    jparams = j_init(jcfg, seed=3)
    model = init_params(cfg, seed=0, device="cpu")
    load_jax_params(model, jax.tree.map(np.asarray, jparams))
    quantize_params(model, bits=4, group_size=8)
    jq = j_quantize_params(jparams, bits=4, group_size=8)
    assert model.model.layers[0].attn.q.kernel_q4 is not None
    assert model.model.layers[0].mlp.experts.gate.kernel_q is not None
    lengths = np.array([9, 16, 6])
    ids = rng.integers(2, 256, (3, 16))
    ids[np.arange(16)[None, :] >= lengths[:, None]] = 0
    sp, jsp = _sps(6)
    ours = generate(model, ids, lengths, sp, decode_impl="kernel")
    ref = j_generate(jq, jcfg, ids, lengths, jsp, decode_impl="kernel")
    np.testing.assert_array_equal(ours.sequences, np.asarray(ref.sequences))
    np.testing.assert_allclose(ours.logprobs, np.asarray(ref.logprobs), rtol=1e-4, atol=1e-4)


def test_kernel_decode_refuses_prefill_chunk(models):
    _, model = models
    sp, _ = _sps(2)
    with pytest.raises(ValueError):
        generate(model, np.ones((2, 4), np.int64), np.array([4, 3]), sp,
                 decode_impl="kernel", prefill_chunk=1)
    with pytest.raises(ValueError):
        generate(model, np.ones((1, 4), np.int64), np.array([4]), sp, decode_impl="pallas")
