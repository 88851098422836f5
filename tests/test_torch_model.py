"""The port's model modules against the JAX package on the same weights.

Tiny config in float32 on the CPU; the JAX parameters (its own seeded
init_params) are carried into the port with load_jax_params. Tolerances:
layer-level ops 1e-6 (the same float32 arithmetic); the ViT 1e-4 relative to
the output's scale (float32 sums in another order; on this init both
packages' ViTs sit ~2e-5 of scale from a float64 run of the port); the full
forward with video 3e-4 of scale (the decoder carries the ViT's rounding on:
measured 2.3e-4 at most, 1.3e-4 in relative L2; text-only logits agree to
3e-6).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_r2_tpu.models import layers as jlayers
from video_r2_tpu.models.config import tiny_test_config as j_tiny
from video_r2_tpu.models.loader import init_params as j_init
from video_r2_tpu.models.model import forward as j_forward
from video_r2_tpu.models.mrope import get_rope_index as j_rope_index
from video_r2_tpu.models.mrope import mrope_cos_sin as j_mrope
from video_r2_tpu.models.vision import plan_vision_layout as j_plan
from video_r2_tpu.models.vision import vit_forward as j_vit
from video_r2_tpu_torch.models import layers
from video_r2_tpu_torch.models.config import tiny_test_config
from video_r2_tpu_torch.models.convert import flatten_jax_tree, load_jax_params
from video_r2_tpu_torch.models.loader import init_params
from video_r2_tpu_torch.models.model import forward
from video_r2_tpu_torch.models.mrope import mrope_cos_sin
from video_r2_tpu_torch.models.vision import plan_vision_layout, vit_forward

T = torch.from_numpy


def _close(ours, ref, rel):
    ours, ref = np.asarray(ours), np.asarray(ref)
    scale = max(float(np.abs(ref).max()), 1.0)
    np.testing.assert_allclose(ours, ref, rtol=rel, atol=rel * scale)


@pytest.fixture(scope="module")
def models():
    jparams = j_init(j_tiny(), seed=3)
    model = init_params(tiny_test_config(), seed=0, device="cpu")
    load_jax_params(model, jax.tree.map(np.asarray, jparams))
    return jparams, model


def test_init_params_tree_matches_jax():
    """Same names and per-layer shapes as the JAX initialiser, and seeded."""
    cfg = tiny_test_config()
    flat = flatten_jax_tree(jax.tree.map(np.asarray, j_init(j_tiny(), seed=0)))
    model = init_params(cfg, seed=5, device="cpu")
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    assert shapes == {n: a.shape for n, a in flat.items()}
    again = init_params(cfg, seed=5, device="cpu")
    for (n, a), (_, b) in zip(model.named_parameters(), again.named_parameters()):
        assert torch.equal(a, b), n
    assert torch.all(model.model.norm.scale == 1)
    assert torch.all(model.visual.blocks[0].attn.qkv.bias == 0)


def test_load_jax_params_round_trip(models):
    jparams, model = models
    np.testing.assert_array_equal(
        model.model.layers[2].attn.q.kernel.numpy(),
        np.asarray(jparams["model"]["layers"]["attn"]["q"]["kernel"][2]))
    np.testing.assert_array_equal(
        model.visual.blocks[1].mlp.down.bias.numpy(),
        np.asarray(jparams["visual"]["blocks"]["mlp"]["down"]["bias"][1]))
    with pytest.raises(KeyError):
        load_jax_params(model, {"model": {"bogus": np.zeros(2)}})


def test_layers_match(rng):
    x = rng.normal(size=(2, 5, 12)).astype(np.float32)
    scale = rng.normal(size=(12,)).astype(np.float32)
    np.testing.assert_allclose(
        layers.rms_norm(T(scale), T(x), 1e-6).numpy(),
        np.asarray(jlayers.rms_norm(jnp.asarray(scale), jnp.asarray(x), 1e-6)),
        rtol=1e-6, atol=1e-6)
    q = rng.normal(size=(2, 5, 3, 12)).astype(np.float32)
    k = rng.normal(size=(2, 5, 1, 12)).astype(np.float32)
    cos = rng.normal(size=(2, 5, 1, 12)).astype(np.float32)
    sin = rng.normal(size=(2, 5, 1, 12)).astype(np.float32)
    for a, b in zip(layers.apply_rotary(T(q), T(k), T(cos), T(sin)),
                    jlayers.apply_rotary(*map(jnp.asarray, (q, k, cos, sin)))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-6)
    w = {n: rng.normal(size=s).astype(np.float32) * 0.3
         for n, s in (("gate", (12, 20)), ("up", (12, 20)), ("down", (20, 12)))}
    mlp = layers.MLP(12, 20, False, dtype=torch.float32, device="cpu")
    load_jax_params(mlp, {n: {"kernel": a} for n, a in w.items()})
    ref = jlayers.swiglu_mlp({n: {"kernel": jnp.asarray(a)} for n, a in w.items()},
                             jnp.asarray(x))
    with torch.no_grad():
        np.testing.assert_allclose(mlp(T(x)).numpy(), np.asarray(ref),
                                   rtol=1e-5, atol=1e-5)


def test_mrope_cos_sin_matches(rng):
    cfg = tiny_test_config()
    pos = rng.integers(0, 3000, size=(3, 2, 9)).astype(np.int32)
    for a, b in zip(mrope_cos_sin(T(pos), cfg), j_mrope(jnp.asarray(pos), j_tiny())):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("impl", ["kernel", "xla"])
def test_vit_forward_matches_jax_kernel(models, rng, impl):
    """Both port paths against JAX vit_forward on its Pallas kernels
    (interpret mode); two videos, the second with ragged windows."""
    jparams, model = models
    grids = [(2, 8, 12), (1, 10, 6)]
    n = sum(t * h * w for t, h, w in grids)
    patches = rng.normal(size=(n, model.cfg.vision.patch_input_dim)).astype(np.float32)
    ref = j_vit(jparams["visual"], j_tiny().vision, jnp.asarray(patches),
                j_plan(grids, j_tiny().vision), attn_impl="kernel",
                interpret=True)
    ours = vit_forward(model.visual, T(patches),
                       plan_vision_layout(grids, model.cfg.vision), attn_impl=impl)
    assert ours.shape == ref.shape
    _close(ours.numpy(), ref, 1e-4)


def test_forward_logits_with_video_match(models, rng):
    jparams, model = models
    cfg = model.cfg
    grid = (2, 8, 12)
    nv = grid[0] * grid[1] * grid[2] // 4
    ids = np.array([[5, 6, cfg.vision_start_token_id] + [cfg.video_token_id] * nv
                    + [cfg.vision_end_token_id, 7, 8, 9, 0, 0]], np.int32)
    mask = (np.arange(ids.shape[1]) < ids.shape[1] - 2)[None].astype(np.int32)
    pos, _ = j_rope_index(ids, j_tiny(), video_grid_thw=np.array([grid]),
                          second_per_grid_ts=np.array([0.5]), attention_mask=mask)
    patches = rng.normal(size=(nv * 4, cfg.vision.patch_input_dim)).astype(np.float32)
    ref, _ = j_forward(jparams, j_tiny(), jnp.asarray(ids), jnp.asarray(pos),
                       attention_mask=jnp.asarray(mask),
                       video_patches=jnp.asarray(patches),
                       video_layout=j_plan([grid], j_tiny().vision))
    ours = forward(model, T(ids), T(pos), attention_mask=T(mask),
                   video_patches=T(patches),
                   video_layout=plan_vision_layout([grid], cfg.vision))
    rows = mask[0] == 1
    _close(ours.numpy()[0, rows], np.asarray(ref)[0, rows], 3e-4)
