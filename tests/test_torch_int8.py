"""Int8 serving in the PyTorch port against the JAX package.

CPU only, the tiny config in float32 (the int8 matmuls also in bf16).
Inputs come from numpy seeds and go through both packages; the JAX
package's int8 Pallas kernels run in interpret mode, as tests/test_quant.py
runs them (the microbench's all-layers kernel under
force_tpu_interpret_mode, which its pallas_call needs on the CPU), and the
port's wrappers run their plain versions on CPU tensors. Tolerances:
- the int8 matmuls in float32: 1e-5 relative / 1e-4 absolute
  (tests/test_quant.py's bound: float32 sums in another order over K);
  in bf16: 1e-2 (both round the fp32 result to bf16 once, and a sum that
  differs in its last fp32 bits may round to the neighbouring bf16);
- greedy tokens exactly equal; cache scales and logits 1e-5, chosen-token
  logprobs 1e-4 (float32 sums in other orders over the layers and the
  decode steps); int8 cache values within 1, on under 1% of them (a k or v
  that differs in its last float32 bits may round to the neighbouring
  int8 value); W8A8 logprobs 1e-3 (so may a per-token activation value).
"""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from video_r2_tpu.engine import sampling as jsampling
from video_r2_tpu.engine.chat import ByteTokenizer as JByteTokenizer
from video_r2_tpu.engine.generate import generate as j_generate
from video_r2_tpu.engine.generate import prefill as j_prefill
from video_r2_tpu.engine.server import ChatEngine as JChatEngine
from video_r2_tpu.models.config import tiny_test_config as j_tiny
from video_r2_tpu.models.loader import init_params as j_init
from video_r2_tpu.models.quant import init_params_quantized_zeros as j_zeros
from video_r2_tpu.models.quant import quantize_params as j_quantize_params
from video_r2_tpu.models.vision import plan_vision_layout as j_plan
from video_r2_tpu.models.vision import vit_forward as j_vit
from video_r2_tpu.ops import attention as jattn
from video_r2_tpu.ops import int8_matmul as jint8
from video_r2_tpu_torch.apps.demo import DemoRunner
from video_r2_tpu_torch.engine import sampling
from video_r2_tpu_torch.engine.chat import ByteTokenizer
from video_r2_tpu_torch.engine.generate import generate, prefill
from video_r2_tpu_torch.engine.server import ChatEngine
from video_r2_tpu_torch.models.config import tiny_test_config
from video_r2_tpu_torch.models.convert import flatten_jax_tree, load_jax_params
from video_r2_tpu_torch.models.decoder import QuantKVCache
from video_r2_tpu_torch.models.loader import init_params
from video_r2_tpu_torch.models.mrope import get_rope_index
from video_r2_tpu_torch.models.quant import init_params_quantized_zeros, quantize_params
from video_r2_tpu_torch.ops import attention, int8_matmul
from video_r2_tpu_torch.video.api import video_features

T = torch.from_numpy
SPECIALS = {"<|endoftext|>": 0, "<|im_start|>": 300, "<|im_end|>": 1,
            "<|vision_start|>": 502, "<|vision_end|>": 503,
            "<|image_pad|>": 500, "<|video_pad|>": 501}
MICROBENCH = Path(__file__).resolve().parent.parent / "scripts" / "microbench_int8.py"


def _np_tree(params):
    return jax.tree.map(np.asarray, params)


@pytest.fixture(scope="module")
def int8_models():
    """The tiny model's weights quantized with bits=8 in both packages:
    (our model, the JAX tree)."""
    jparams = j_init(j_tiny(), seed=5)
    model = init_params(tiny_test_config(), seed=0, device="cpu")
    load_jax_params(model, _np_tree(jparams))
    quantize_params(model)
    return model, j_quantize_params(jparams)


def _int8_leaf(rng, *shape):
    w = rng.normal(size=shape).astype(np.float32)
    scale = np.maximum(np.abs(w).max(axis=-2), 1e-8) / 127.0
    wq = np.clip(np.round(w / scale[..., None, :]), -127, 127).astype(np.int8)
    return wq, scale.astype(np.float32)


@pytest.mark.parametrize("dtype,rtol,atol", [("float32", 1e-5, 1e-4),
                                             ("bfloat16", 1e-2, 1e-2)])
def test_int8_matmul_plain_matches_jax_kernel(rng, dtype, rtol, atol):
    """tests/test_quant.py's ragged shapes (K 300, N 500: the JAX wrapper
    pads both to its blocks)."""
    M, K, N = 32, 300, 500
    x = T(rng.normal(size=(M, K)).astype(np.float32)).to(getattr(torch, dtype))
    wq, scale = _int8_leaf(rng, K, N)
    ref = jint8.int8_matmul(jnp.asarray(x.float().numpy(), dtype), jnp.asarray(wq),
                            jnp.asarray(scale), interpret=True)
    before = int8_matmul.int8_matmul.launches
    ours = int8_matmul.int8_matmul(x, T(wq), T(scale))
    assert int8_matmul.int8_matmul.launches == before       # CPU tensors launch nothing
    assert ours.dtype == x.dtype and ours.shape == (M, N)
    np.testing.assert_allclose(ours.float().numpy(), np.asarray(ref, np.float32),
                               rtol=rtol, atol=atol)


@pytest.mark.parametrize("M", [8, 17, 64])
def test_int8_matmul_stacked_plain_matches_jax_kernel(rng, M):
    """Every layer of a stack, read in place by the JAX kernel's scalar
    prefetch; M 17 and 64: rows of the wide kernel's 32- and 64-row tiles,
    which the card's stacked entry takes."""
    L, K, N = 3, 256, 384
    x = rng.normal(size=(M, K)).astype(np.float32)
    wq, scale = _int8_leaf(rng, L, K, N)
    for layer in range(L):
        ref = jint8.int8_matmul_stacked(jnp.asarray(x), jnp.asarray(wq), jnp.asarray(scale),
                                        layer, interpret=True)
        ours = int8_matmul.int8_matmul_stacked(T(x), T(wq), T(scale), layer)
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("M", [8, 17, 64])
def test_int8_matmul_all_layers_plain_matches_the_microbench_kernel(rng, M):
    """The all-layers plain version against scripts/microbench_int8.py's
    one-launch kernel (grid (L, N / 512, K / 512)); M 64 is the
    microbench's own row count."""
    spec = importlib.util.spec_from_file_location("microbench_int8", MICROBENCH)
    bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench)
    L, K, N = 2, 512, 512
    x = rng.normal(size=(M, K)).astype(np.float32)
    wq, scale = _int8_leaf(rng, L, K, N)
    with pltpu.force_tpu_interpret_mode():
        ref = bench.all_layers_matmul(jnp.asarray(x), jnp.asarray(wq), jnp.asarray(scale))
    ours = int8_matmul.int8_matmul_all_layers(T(x), T(wq), T(scale))
    assert ours.shape == (L, M, N)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-4)


# the decode kernel's plan on an H100 (132 SMs, 3 blocks an SM) whose
# clusters of S blocks the card holds at once are its slots over S
def _clusters(resident=3, sms=132):
    return tuple(resident * sms // S for S in range(1, 17))


@pytest.mark.parametrize("M", [1, 16])
@pytest.mark.parametrize("K,N,plan", [
    (3584, 3584, (392, 14)),        # q / o: 28 tiles, 14 splits of 4 steps
    (3584, 512, (64, 16)),          # k / v: 4 tiles, the most splits a cluster holds
    (3584, 18944, (296, 2)),        # gate / up: 148 tiles, 2 splits fill 296 of 396 slots
    (18944, 3584, (392, 14)),       # down: 296 steps a tile
    (3584, 152064, (1188, 1))])     # the head: 1188 tiles fill every slot, no split
def test_int8_decode_plan_at_the_7b_shapes(M, K, N, plan):
    """int8_decode_plan at the 7B's decode linears, B = 16 and B = 1
    (blocks, splits): a tile's K split over a cluster where the tiles leave
    slots idle (the grid within one wave of the resident slots), unsplit
    where they fill every slot."""
    S = int8_matmul.int8_decode_plan(M, K, N, 132, 3, _clusters())
    assert (N // int8_matmul.DECODE_COLUMNS * S, S) == plan


@pytest.mark.parametrize("M,K,N", [(17, 3584, 3584),   # more rows than the decode kernel's
                                   (0, 3584, 3584),    # no rows
                                   (4, 3584, 3420),    # N not a multiple of the tile (128)
                                   (4, 1280, 500),
                                   (4, 300, 512),      # K not in whole steps of 64
                                   (4, 192, 512)])     # small K: 3 steps
def test_int8_decode_plan_refuses(M, K, N):
    """What the decode kernel does not take stays on the staged kernel."""
    assert int8_matmul.int8_decode_plan(M, K, N, 132, 3, _clusters()) is None


@pytest.mark.parametrize("K,N", [(3584, 3584), (3584, 512), (3584, 18944), (18944, 3584),
                                 (3584, 152064), (256, 128)])
@pytest.mark.parametrize("sms,resident", [(132, 3), (132, 2), (114, 3), (8, 1)])
def test_int8_decode_plan_keeps_one_wave(K, N, sms, resident):
    """The plan never asks for more blocks than the resident slots hold
    unless the tiles alone do, keeps DECODE_SPLIT_MIN_STEPS steps a split
    and every cluster resident at once, and takes the most splits that
    allows."""
    m = int8_matmul
    clusters = _clusters(resident, sms)
    S = m.int8_decode_plan(4, K, N, sms, resident, clusters)
    tiles, ks = N // m.DECODE_COLUMNS, K // m.DECODE_STEP_K
    assert 1 <= S <= m.DECODE_MAX_SPLITS
    assert S == 1 or (tiles * S <= resident * sms and tiles <= clusters[S - 1]
                      and ks // S >= m.DECODE_SPLIT_MIN_STEPS)
    assert S == m.DECODE_MAX_SPLITS or tiles * (S + 1) > resident * sms \
        or ks // (S + 1) < m.DECODE_SPLIT_MIN_STEPS or tiles > clusters[S]


# the wide kernel's residency on an H100 (132 SMs), as its layout entry
# reads it: two blocks an SM of the 32- and 64-row instances, one of the
# 128-row instance, and the clusters of S = 1 .. 16 blocks each holds at once
H100_WIDE_LAYOUT = ((2, 2, 1), (
    (264, 132, 79, 62, 47, 39, 32, 30, 23, 21, 16, 16, 14, 14, 14, 14),
    (264, 132, 79, 62, 47, 39, 32, 30, 23, 21, 16, 16, 14, 14, 14, 14),
    (132, 66, 39, 30, 22, 17, 15, 15, 9, 7, 7, 7, 7, 7, 7, 7)))


@pytest.mark.parametrize("M,K,N,layers,plan", [
    (17, 3584, 3584, 1, (32, 4)),       # q / o: 28 tiles, one block an SM
    (64, 3584, 3584, 1, (64, 4)),
    (128, 3584, 3584, 1, (128, 4)),
    (256, 3584, 3584, 1, (128, 2)),     # two row tiles of 128
    (64, 3584, 512, 1, (64, 16)),       # k / v: 4 tiles, the most splits a cluster holds
    (256, 3584, 512, 1, (128, 9)),      # 8 tiles: 9 clusters of 9 resident, 7 of 10
    (64, 3584, 18944, 1, (64, 1)),      # gate / up: 148 tiles, more than the SMs
    (256, 3584, 18944, 1, (128, 1)),
    (64, 18944, 3584, 1, (64, 4)),      # down: 296 steps a tile
    (64, 3584, 152064, 1, (64, 1)),     # the bench's prefill head: 1188 tiles
    (64, 3584, 18944, 28, (64, 1)),     # the microbench's all-layers launch
    (784, 5120, 5120, 1, (128, 1)),     # 7 row tiles of the merger's 40 column tiles
    (16, 192, 512, 1, (32, 1)),         # 3 steps: a split would keep 1
    (40, 2400, 1024, 1, (64, 16))])     # a K tail (37.5 steps): 8 tiles
def test_int8_wide_plan_at_the_7b_shapes(M, K, N, layers, plan):
    """int8_wide_plan on an H100's counts: the row tile (the smallest
    instance that holds M, 128-row tiles past it), and a tile's K split
    over a cluster where the tiles leave SMs idle, at most one block an SM,
    unsplit where the tiles fill them."""
    assert int8_matmul.int8_wide_plan(M, K, N, layers, 132, H100_WIDE_LAYOUT[1]) == plan


@pytest.mark.parametrize("M,K,N", [(64, 3420, 1280),   # K % 8: x's rows not 16-byte pitched
                                   (64, 1280, 3420),   # N % 16: the weights' rows
                                   (32, 300, 500), (4, 301, 197), (17, 64, 1),
                                   (0, 3584, 3584)])   # no rows
def test_int8_wide_plan_refuses(M, K, N):
    """What TMA cannot map goes to the element-load kernel."""
    assert int8_matmul.int8_wide_plan(M, K, N, 1, 132, H100_WIDE_LAYOUT[1]) is None


@pytest.mark.parametrize("M", [17, 64, 128, 256])
@pytest.mark.parametrize("K,N,layers", [(3584, 3584, 1), (3584, 512, 1), (3584, 18944, 1),
                                        (18944, 3584, 1), (3584, 152064, 1), (256, 128, 1),
                                        (3584, 18944, 28)])
@pytest.mark.parametrize("sms,resident", [(132, (2, 2, 1)), (132, (1, 1, 1)), (114, (2, 2, 1)),
                                          (8, (1, 1, 1))])
def test_int8_wide_plan_keeps_one_wave(M, K, N, layers, sms, resident):
    """A split grid holds at most one block an SM with every cluster
    resident at once, keeps WIDE_SPLIT_MIN_STEPS steps a split, and takes
    the most splits that allows; the row tile is the smallest instance
    that holds M."""
    m = int8_matmul
    clusters = tuple(tuple(r * sms // S for S in range(1, 17)) for r in resident)
    rows, S = m.int8_wide_plan(M, K, N, layers, sms, clusters)
    i = m.WIDE_ROWS.index(rows)
    blocks = -(-M // rows) * -(-N // m.WIDE_COLUMNS) * layers
    ks = -(-K // m.WIDE_STEP_K)
    assert rows == min(r for r in m.WIDE_ROWS if r >= min(M, m.WIDE_ROWS[-1]))
    assert 1 <= S <= m.WIDE_MAX_SPLITS
    assert S == 1 or (blocks * S <= sms and blocks <= clusters[i][S - 1]
                      and ks // S >= m.WIDE_SPLIT_MIN_STEPS)
    assert S == m.WIDE_MAX_SPLITS or blocks * (S + 1) > sms \
        or ks // (S + 1) < m.WIDE_SPLIT_MIN_STEPS or blocks > clusters[i][S]


@pytest.mark.parametrize("rows,K,N,route", [
    (16, 3584, 3584, "decode"),        # the decode kernel's rows
    (17, 3584, 3584, "wide"), (64, 3584, 3584, "wide"), (256, 3584, 3584, "wide"),
    (64, 3584, 152064, "wide"),        # the bench's prefill head
    (257, 3584, 3584, None),           # past INT8_KERNEL_MAX_ROWS: convert + matmul
    (16, 3584, 3420, "element"),       # N % 16: the decode plan and TMA refuse it
    (64, 1280, 3420, "element"), (64, 3420, 1280, "element")])
def test_quantized_linear_auto_routes_by_shape(monkeypatch, rows, K, N, route):
    """The kernel each call takes, chosen by shape before any launch, on an
    H100's counts: the dispatcher's int8 linear over tensors that hold no
    data (the meta device, so the wrapper's CUDA branch runs), the three
    launch functions replaced by recorders."""
    m = int8_matmul
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda index: type("Props", (), {"multi_processor_count": 132}))
    monkeypatch.setattr(m, "int8_decode_layout",
                        lambda index: ((3, 3), (_clusters(), _clusters())))
    monkeypatch.setattr(m, "int8_wide_layout", lambda index: H100_WIDE_LAYOUT)
    m._decode_plan.cache_clear()
    m._wide_plan.cache_clear()
    calls = []

    def launch(x, wq, scale, dims, layer0, layers, all_layers, plan):
        calls.append("element" if plan is None else "wide")
        return torch.empty(((layers,) if all_layers else ()) + (dims[0], dims[3]),
                           dtype=torch.bfloat16, device="meta")

    def launch_decode(x, wq, scale, splits, dims=None):
        calls.append("decode")
        return torch.empty(dims[0], dims[3], dtype=torch.bfloat16, device="meta")

    monkeypatch.setattr(m, "_launch", launch)
    monkeypatch.setattr(m, "_launch_decode", launch_decode)
    try:
        meta = lambda *shape, dtype: torch.empty(*shape, dtype=dtype, device="meta")  # noqa: E731
        x = meta(rows, K, dtype=torch.bfloat16)
        wq, scale = meta(K, N, dtype=torch.int8), meta(N, dtype=torch.float32)
        before = (m.int8_matmul.launches, m.int8_matmul.decode_launches,
                  m.int8_matmul.wide_launches)
        assert m.quantized_linear_auto(x, wq, scale).shape == (rows, N)
        assert calls == ([] if route is None else [route])
        assert (m.int8_matmul.launches, m.int8_matmul.decode_launches,
                m.int8_matmul.wide_launches) == tuple(
            b + d for b, d in zip(before, (route is not None, route == "decode",
                                           route == "wide")))
        # the stacked and all-layers entries never take the decode kernel
        calls.clear()
        wq2, scale2 = meta(2, K, N, dtype=torch.int8), meta(2, N, dtype=torch.float32)
        m.int8_matmul_stacked(x, wq2, scale2, 1)
        assert m.int8_matmul_all_layers(x, wq2, scale2).shape == (2, rows, N)
        assert calls == ["element" if route == "element" else "wide"] * 2
    finally:
        m.int8_matmul.launches, m.int8_matmul.decode_launches, m.int8_matmul.wide_launches = \
            before
        m._decode_plan.cache_clear()
        m._wide_plan.cache_clear()


@pytest.mark.parametrize("rows", [4, 40])
def test_quantized_linear_auto_matches_jax(rng, monkeypatch, rows):
    """float32 x never reaches the int8 kernel's wrapper (the kernel takes
    bf16 only): on both sides of the row limit the port's dispatcher
    converts and multiplies, and gives the JAX dispatcher's result (its XLA
    path on the CPU)."""
    monkeypatch.setattr(int8_matmul, "INT8_KERNEL_MAX_ROWS", 16)
    calls = []
    real = int8_matmul.int8_matmul
    monkeypatch.setattr(int8_matmul, "int8_matmul",
                        lambda *a: calls.append(a[0].shape) or real(*a))
    x = rng.normal(size=(2, rows // 2, 96)).astype(np.float32)
    wq, scale = _int8_leaf(rng, 96, 80)
    ours = int8_matmul.quantized_linear_auto(T(x), T(wq), T(scale))
    ref = jint8.quantized_linear_auto(jnp.asarray(x), jnp.asarray(wq), jnp.asarray(scale))
    assert ours.shape == (2, rows // 2, 80)
    assert calls == []
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("rows", [4, 40])
def test_quantized_linear_auto_sends_bf16_rows_to_the_kernel(rng, monkeypatch, rows):
    """bf16 x: below the row limit the dispatcher calls the int8 kernel's
    wrapper, above it the convert + matmul path; both within bf16 rounding
    (1e-2) of the JAX dispatcher's bf16 result."""
    monkeypatch.setattr(int8_matmul, "INT8_KERNEL_MAX_ROWS", 16)
    calls = []
    real = int8_matmul.int8_matmul
    monkeypatch.setattr(int8_matmul, "int8_matmul",
                        lambda *a: calls.append(a[0].shape) or real(*a))
    x = rng.normal(size=(2, rows // 2, 96)).astype(np.float32)
    wq, scale = _int8_leaf(rng, 96, 80)
    ours = int8_matmul.quantized_linear_auto(T(x).bfloat16(), T(wq), T(scale))
    ref = jint8.quantized_linear_auto(jnp.asarray(x, jnp.bfloat16), jnp.asarray(wq),
                                      jnp.asarray(scale))
    assert ours.shape == (2, rows // 2, 80) and ours.dtype == torch.bfloat16
    assert calls == ([(rows, 96)] if rows <= 16 else [])
    np.testing.assert_allclose(ours.float().numpy(), np.asarray(ref, np.float32),
                               rtol=1e-2, atol=1e-2)


def test_quant_dot_product_attention_matches_jax(rng):
    B, Sq, Sk, nh, kh, hd = 2, 1, 24, 4, 2, 16
    q = rng.normal(size=(B, Sq, nh, hd)).astype(np.float32)
    kq, vq = (rng.integers(-127, 128, (B, Sk, kh, hd)).astype(np.int8) for _ in range(2))
    ks, vs = (rng.uniform(0.001, 0.02, (B, Sk, kh)).astype(np.float32) for _ in range(2))
    bias = np.where(np.arange(Sk)[None, None, None] < np.array([20, 13])[:, None, None, None],
                    0.0, -1e30).astype(np.float32)
    ours = attention.quant_dot_product_attention(T(q), T(kq), T(ks), T(vq), T(vs), T(bias))
    ref = jattn.quant_dot_product_attention(*map(jnp.asarray, (q, kq, ks, vq, vs, bias)))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


def test_quantized_fill_matches_jax(int8_models, rng):
    """prefill(kv_quant="int8") writes the JAX package's QuantKVCache (int8
    values and scales) and gives its logits; the rows past the prompt stay
    zero."""
    model, jq = int8_models
    lengths = np.array([11, 7])
    ids = rng.integers(2, 400, (2, 11))
    ids[1, 7:] = 0
    mask = (np.arange(11)[None] < lengths[:, None]).astype(np.int64)
    pos, _ = get_rope_index(ids, model.cfg, attention_mask=mask)
    cache = QuantKVCache.init(model.cfg.text, 2, 16, "cpu")
    logits = prefill(model, T(ids), T(pos), T(lengths).int(), cache)
    ref_logits, ref = j_prefill(jq, j_tiny(), jnp.asarray(ids), jnp.asarray(pos),
                                jnp.asarray(lengths), 16, kv_quant="int8")
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits), rtol=1e-5, atol=1e-5)
    for name in ("k", "v"):
        ours = getattr(cache, name).numpy()
        assert ours.dtype == np.int8
        diff = np.abs(ours.astype(np.int32) - np.asarray(getattr(ref, name), np.int32))
        assert diff.max() <= 1 and (diff > 0).mean() < 1e-2
        np.testing.assert_allclose(getattr(cache, f"{name}_scale").numpy(),
                                   np.asarray(getattr(ref, f"{name}_scale")), rtol=1e-5, atol=0)
    assert not cache.k[:, :, 11:].any() and not cache.k_scale[:, :, 11:].any()


def _greedy(T_new):
    return (sampling.SamplingParams(max_new_tokens=T_new, pad_token_id=0, eos_token_ids=()),
            jsampling.SamplingParams(max_new_tokens=T_new, pad_token_id=0, eos_token_ids=()))


def _assert_same(ours, ref, act_quant):
    np.testing.assert_array_equal(ours.sequences, np.asarray(ref.sequences))
    np.testing.assert_array_equal(ours.lengths, np.asarray(ref.lengths))
    tol = 1e-3 if act_quant else 1e-4
    np.testing.assert_allclose(ours.logprobs, np.asarray(ref.logprobs), rtol=tol, atol=tol)


@pytest.mark.parametrize("act_quant", [None, "int8"], ids=["weight-only", "w8a8"])
@pytest.mark.parametrize("kv_quant", [None, "int8"], ids=["bf16-kv", "int8-kv"])
def test_int8_generate_token_exact(int8_models, act_quant, kv_quant):
    """generate on the int8 model, ragged prompts, the flash prefill (its
    plain version here; the JAX kernel in interpret mode)."""
    model, jq = int8_models
    rng = np.random.default_rng(17)
    lengths = np.array([13, 6, 10])
    ids = np.zeros((3, 13), np.int64)
    for b, n in enumerate(lengths):
        ids[b, :n] = rng.integers(2, 400, n)
    sp, jsp = _greedy(7)
    kw = dict(attn_impl="flash", act_quant=act_quant, kv_quant=kv_quant)
    _assert_same(generate(model, ids, lengths, sp, **kw),
                 j_generate(jq, j_tiny(), ids, lengths, jsp, **kw), act_quant)


def test_int8_generate_prefill_chunk_token_exact(int8_models):
    """The batch-chunked fill writes views of one QuantKVCache; W8A8
    prefill, int8-weight decode (B < 192)."""
    model, jq = int8_models
    rng = np.random.default_rng(19)
    lengths = np.array([9, 12, 5, 12])
    ids = np.zeros((4, 12), np.int64)
    for b, n in enumerate(lengths):
        ids[b, :n] = rng.integers(2, 400, n)
    sp, jsp = _greedy(6)
    kw = dict(act_quant="int8", kv_quant="int8", prefill_chunk=2)
    _assert_same(generate(model, ids, lengths, sp, **kw),
                 j_generate(jq, j_tiny(), ids, lengths, jsp, **kw), "int8")


def test_int8_generate_video_token_exact(int8_models):
    """A video question prepared by DemoRunner, its ViT on the int8 tower,
    decoded over the int8 cache: the JAX package's ViT and generate on the
    same frames, layout and prompt give the same tokens."""
    model, jq = int8_models
    frames = np.random.default_rng(3).integers(0, 256, (4, 112, 168, 3), np.uint8)
    feats = video_features(frames, 112, 168, sample_fps=1.5)
    runner = DemoRunner(model, ByteTokenizer(SPECIALS), impl="flash")
    req = runner.prepare(feats, "What moves?")
    vemb = runner.vision_embeds(req)
    jvemb = j_vit(jq["visual"], j_tiny().vision, jnp.asarray(req.patches),
                  j_plan([tuple(feats.grid_thw)], j_tiny().vision))
    np.testing.assert_allclose(vemb.numpy(), np.asarray(jvemb), rtol=1e-4, atol=1e-4)
    sp, jsp = _greedy(8)
    common = dict(position_ids=req.position_ids, rope_deltas=req.rope_deltas,
                  vision_token_id=model.cfg.video_token_id, attn_impl="flash",
                  kv_quant="int8")
    ours = generate(model, req.input_ids, req.lengths, sp, vision_embeds=vemb, **common)
    ref = j_generate(jq, j_tiny(), req.input_ids, req.lengths, jsp, vision_embeds=jvemb,
                     **common)
    _assert_same(ours, ref, None)


def test_kv_quant_refuses_the_decode_kernel(int8_models):
    model, _ = int8_models
    sp, _ = _greedy(2)
    with pytest.raises(ValueError, match="head-major"):
        generate(model, np.ones((1, 4), np.int64), np.array([4]), sp, kv_quant="int8",
                 decode_impl="kernel")


def test_chat_batch_kv_quant_matches_jax(int8_models):
    """ChatEngine(kv_quant="int8").chat_batch answers exactly the JAX
    ChatEngine's on the int8 model."""
    model, jq = int8_models
    msgs = [[{"role": "system", "content": "You judge answers."},
             {"role": "user", "content": f"Is {i} + {i} = {2 * i}? Reply yes or no."}]
            for i in range(3)]
    ours = ChatEngine(model, model.cfg, ByteTokenizer(SPECIALS), max_new_tokens=6,
                      kv_quant="int8").chat_batch(msgs)
    ref = JChatEngine(jq, j_tiny(), JByteTokenizer(SPECIALS), max_new_tokens=6,
                      kv_quant="int8").chat_batch(msgs)
    assert ours == ref


@pytest.mark.parametrize("bits", [8, 4])
def test_init_params_quantized_zeros_matches_jax(bits):
    """Every leaf's name, shape, dtype and value equal to the JAX tree's
    (group 8, so the ViT's linears take int4 too at bits=4)."""
    ref = flatten_jax_tree(_np_tree(j_zeros(j_tiny(), bits=bits, group_size=8)))
    model = init_params_quantized_zeros(tiny_test_config(), bits=bits, group_size=8,
                                        device="cpu")
    params = dict(model.named_parameters())
    assert params.keys() == ref.keys()
    assert ("lm_head.kernel_q4" in params) == (bits == 4)
    for name, arr in ref.items():
        p = params[name]
        assert tuple(p.shape) == arr.shape and str(p.dtype) == f"torch.{arr.dtype}", name
        assert not p.requires_grad
        np.testing.assert_array_equal(p.float().numpy(), arr.astype(np.float32), err_msg=name)
