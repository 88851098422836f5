"""The MoE training slice of the PyTorch port against the JAX package.

CPU only, float32. The GMM backward's plain versions (what the port's
wrappers run on CPU tensors) against JAX's custom VJP, whose three Pallas
backward kernels run in interpret mode as the JAX package's own tests run
them, and against the grouped einsum's autograd; then the SFT steps over
the tiny MoE judge of tests/test_torch_moe.py (H 32, E 8, top 2, I 16, 2
layers, the fast-path flags on). Inputs come from numpy seeds. Tolerances:
- MoE gradients (dX, the router's, dWg / dWu / dWd): 2e-4 absolute and
  relative, the JAX suite's bound (tests/test_moe_gmm.py): float32 sums in
  other orders; experts no slot routes to: exactly 0;
- step-1 losses: rtol 2e-5 (float32 over two layers);
- the full-parameter step's gradient norm: rtol 1e-4;
- the LoRA step's adapter gradients, as one vector: relative L2 1e-4, and
  each tensor within 1e-3 relative L2 (float32 sums in other orders over
  two layers and the fused CE's chunks).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_moe import _configs, _moe_params, _to
from video_r2_tpu.models import moe as jmoe
from video_r2_tpu.models.loader import init_params as j_init
from video_r2_tpu.ops import moe_gmm as jgmm
from video_r2_tpu.train import lora as jlora
from video_r2_tpu.train.optim import OptimConfig as JOptimConfig
from video_r2_tpu.train.optim import make_optimizer as j_make_optimizer
from video_r2_tpu.train.sft import SFTConfig as JSFTConfig
from video_r2_tpu.train.sft import init_train_state as j_init_train_state
from video_r2_tpu.train.sft import make_sft_step as j_make_sft_step
from video_r2_tpu.train.sft import sft_loss as j_sft_loss
from video_r2_tpu_torch.models import moe
from video_r2_tpu_torch.models.convert import flatten_jax_tree, load_jax_lora, load_jax_params
from video_r2_tpu_torch.models.decoder import MoEMLP
from video_r2_tpu_torch.models.loader import init_params
from video_r2_tpu_torch.ops import moe_gmm
from video_r2_tpu_torch.train.lora import LoRAConfig, attach_lora, init_lora
from video_r2_tpu_torch.train.optim import OptimConfig
from video_r2_tpu_torch.train.sft import (
    SFTConfig,
    init_train_state,
    make_lora_sft_step,
    make_sft_step,
)

T = torch.from_numpy
GRAD_TOL = dict(rtol=2e-4, atol=2e-4)
H, E, K = 32, 8, 2
PATHS = (("router", "kernel"), ("experts", "gate", "kernel"),
         ("experts", "up", "kernel"), ("experts", "down", "kernel"))


def _leaf(tree, path):
    for key in path:
        tree = tree[key]
    return tree


def _torch_grads(fn, p_np, x_np, cot_np):
    """Gradients of sum(fn(p, x) * cot) w.r.t. every leaf of p and x."""
    p = _to(p_np, lambda a: T(a.copy()).requires_grad_())
    x = T(x_np.copy()).requires_grad_()
    (fn(p, x) * T(cot_np)).sum().backward()
    return _to(p, lambda t: t.grad.numpy()), x.grad.numpy()


@pytest.mark.parametrize("bm", [8, 4])
def test_gmm_diff_grads_match_jax_and_the_einsum(rng, bm):
    """moe_mlp_gmm_diff's gradients (dX, the router's, dWg, dWu, dWd) equal
    JAX's moe_mlp_gmm_diff under jax.grad and the port's grouped einsum at
    capacity 0. bm 4 makes the busiest expert span several row blocks;
    experts that no slot routes to get exactly zero weight gradients."""
    p = _moe_params(rng)
    x = rng.normal(0, 1, (10, H)).astype(np.float32)
    # expert 6 gets no slot: feature 0 is 3 in every token and lifts every
    # other expert's logit by 9 (the random part's scale is ~2.8)
    x[:, 0] = 3.0
    p["router"]["kernel"][:, 6] = 0.0
    p["router"]["kernel"][0, np.arange(E) != 6] += 3.0
    cot = rng.normal(0, 1, (10, H)).astype(np.float32)

    gp, gx = _torch_grads(lambda p, x: moe_gmm.moe_mlp_gmm_diff(p, x, K, True, block_rows=bm),
                          p, x, cot)
    ep, ex = _torch_grads(lambda p, x: moe.moe_mlp(p, x[None], K, True)[0], p, x, cot)
    jp, jx = jax.jit(jax.grad(
        lambda p, x: jnp.sum(jgmm.moe_mlp_gmm_diff(p, x, K, True, block_rows=bm,
                                                   interpret=True) * cot),
        argnums=(0, 1)))(_to(p, jnp.asarray), jnp.asarray(x))
    np.testing.assert_allclose(gx, np.asarray(jx), **GRAD_TOL)
    np.testing.assert_allclose(gx, ex, **GRAD_TOL)
    for path in PATHS:
        np.testing.assert_allclose(_leaf(gp, path), np.asarray(_leaf(jp, path)),
                                   err_msg="/".join(path), **GRAD_TOL)
        np.testing.assert_allclose(_leaf(gp, path), _leaf(ep, path),
                                   err_msg="/".join(path), **GRAD_TOL)
    _, topi = moe.route(T(p["router"]["kernel"]), T(x), K, True)
    counts = np.bincount(topi.numpy().reshape(-1), minlength=E)
    if bm == 4:
        assert counts.max() > bm, "need a multi-block expert run"
    absent = np.flatnonzero(counts == 0)
    assert 6 in absent
    for name in ("gate", "up", "down"):
        g = gp["experts"][name]["kernel"]
        assert not g[absent].any() and g[counts > 0].any(), name


def test_gmm_diff_through_moe_mlp(rng):
    """moe_mlp(gmm_prefill=True) with float weights trains through the GMM
    backward: its gradients equal JAX's moe_mlp(gmm_prefill=True) under
    jax.grad and the port's einsum path (gmm_prefill=False)."""
    p = _moe_params(rng)
    x = rng.normal(0, 1, (1, 40, H)).astype(np.float32)      # past RAGGED_MAX_TOKENS
    cot = rng.normal(0, 1, (1, 40, H)).astype(np.float32)
    kw = dict(capacity_factor=0.0, ragged_decode=True)
    gp, gx = _torch_grads(lambda p, x: moe.moe_mlp(p, x, K, True, gmm_prefill=True, **kw),
                          p, x, cot)
    ep, ex = _torch_grads(lambda p, x: moe.moe_mlp(p, x, K, True, **kw), p, x, cot)
    jp, jx = jax.grad(
        lambda p, x: jnp.sum(jmoe.moe_mlp(p, x, K, True, gmm_prefill=True, **kw) * cot),
        argnums=(0, 1))(_to(p, jnp.asarray), jnp.asarray(x))
    np.testing.assert_allclose(gx, np.asarray(jx), **GRAD_TOL)
    np.testing.assert_allclose(gx, ex, **GRAD_TOL)
    for path in PATHS:
        np.testing.assert_allclose(_leaf(gp, path), np.asarray(_leaf(jp, path)),
                                   err_msg="/".join(path), **GRAD_TOL)
        np.testing.assert_allclose(_leaf(gp, path), _leaf(ep, path),
                                   err_msg="/".join(path), **GRAD_TOL)


def test_gmm_backward_kernels_plain_versions(rng):
    """The three wrappers' plain versions on one sorted layout with slack
    blocks: dX and the SwiGLU terms from gmm_bwd_dx, the per-expert sums of
    gmm_bwd_dw / gmm_bwd_dwd equal the per-row formulas, slack blocks are
    zero, and only asking for h (keep_h) forms it."""
    p = _to(_moe_params(rng), T)
    xt = T(rng.normal(0, 1, (12, H)).astype(np.float32))
    _, topi = moe.route(p["router"]["kernel"], xt, K, True)
    xs, ids, valid, _ = moe_gmm.gmm_layout(xt, topi, E, 4)
    dYs = T(rng.normal(0, 1, xs.shape).astype(np.float32)) * (xs.abs().sum(-1, keepdim=True) > 0)
    wg, wu, wd = (p["experts"][n]["kernel"] for n in ("gate", "up", "down"))
    assert (valid == 0).any()
    dx, dg, du, h = moe_gmm.gmm_bwd_dx(xs, dYs, ids, valid, wg, wu, wd)
    assert h is None
    _, _, _, h = moe_gmm.gmm_bwd_dx(xs, dYs, ids, valid, wg, wu, wd, keep_h=True)
    e = ids.long()[:, None].expand(xs.shape[:2]).reshape(-1)
    xr, dyr = xs.reshape(-1, H), dYs.reshape(-1, H)
    g = torch.einsum("rh,rhi->ri", xr, wg[e])
    u = torch.einsum("rh,rhi->ri", xr, wu[e])
    dh = torch.einsum("rh,rih->ri", dyr, wd[e])
    s = torch.sigmoid(g)
    want_dg, want_du = dh * u * s * (1 + g * (1 - s)), dh * g * s
    live = (valid != 0)[:, None].expand(xs.shape[:2]).reshape(-1, 1)
    for got, want in ((dg, want_dg), (du, want_du), (h, g * s * u)):
        torch.testing.assert_close(got.reshape(-1, want.shape[-1]), want * live,
                                   rtol=1e-5, atol=1e-6)
    want_dx = (torch.einsum("ri,rhi->rh", want_dg, wg[e])
               + torch.einsum("ri,rhi->rh", want_du, wu[e])) * live
    torch.testing.assert_close(dx.reshape(-1, H), want_dx, rtol=1e-5, atol=1e-5)
    dwg, dwu = moe_gmm.gmm_bwd_dw(xs, dg, du, ids, valid, E)
    dwd = moe_gmm.gmm_bwd_dwd(h, dYs, ids, valid, E)
    sel = live.float() * torch.nn.functional.one_hot(e, E).float()     # [rows, E]
    I = wg.shape[-1]
    for got, want in ((dwg, torch.einsum("rh,ri,re->ehi", xr, dg.reshape(-1, I), sel)),
                      (dwu, torch.einsum("rh,ri,re->ehi", xr, du.reshape(-1, I), sel)),
                      (dwd, torch.einsum("ri,rh,re->eih", h.reshape(-1, I), dyr, sel))):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("bm,H,tiles", [
    (128, 2048, (128, 128)),    # the judge (phases 14 and 15: T 4096 and 2048)
    (64, 2048, (64, 128)),
    (32, 2048, (64, 128)),      # one warpgroup, a tile past the block's rows
    (48, 256, (64, 128)),
    (128, 320, (128, 64)),      # dX in 64-column tiles
    (256, 320, (128, 64))])
def test_gmm_bwd_dx_tiles(bm, H, tiles):
    """The bf16 dX kernels' tiles: (rows a block, columns of H a dX block),
    and the judge's training token counts get 128-row blocks."""
    assert moe_gmm.gmm_bwd_dx_tiles(bm, H) == tiles
    for T in (2048, 4096):
        assert moe_gmm.gmm_bwd_dx_tiles(moe_gmm.auto_block_rows(T * 8, 128), 2048) == (128, 128)


def test_fp32_moe_at_kernel_widths_matches_jax(rng):
    """The fp32 MoE path the card's kernels now take (H and I multiples of
    64: H 128, I 64, E 8, top 2) through the port's wrappers against the JAX
    package: the ragged decode (T 5) and GMM prefill (T 24, block_rows 8)
    forwards, and moe_mlp_gmm_diff's gradients under jax.grad (the Pallas
    kernels in interpret mode)."""
    from video_r2_tpu.ops import moe_ragged as jragged
    from video_r2_tpu_torch.ops import moe_ragged

    Hw, Iw = 128, 64
    p = {"router": {"kernel": rng.normal(0, 0.3, (Hw, E)).astype(np.float32)},
         "experts": {n: {"kernel": rng.normal(0, Hw ** -0.5 if n != "down" else Iw ** -0.5,
                                              s).astype(np.float32)}
                     for n, s in (("gate", (E, Hw, Iw)), ("up", (E, Hw, Iw)),
                                  ("down", (E, Iw, Hw)))}}
    for n in (5, 24):
        x = rng.normal(0, 1, (n, Hw)).astype(np.float32)
        if n == 5:
            ours = moe_ragged.moe_mlp_ragged(_to(p, T), T(x), K, True)
            ref = jragged.moe_mlp_ragged(_to(p, jnp.asarray), jnp.asarray(x), K, True,
                                         interpret=True)
        else:
            ours = moe_gmm.moe_mlp_gmm(_to(p, T), T(x), K, True, block_rows=8)
            ref = jgmm.moe_mlp_gmm(_to(p, jnp.asarray), jnp.asarray(x), K, True, block_rows=8,
                                   interpret=True)
        assert ours.dtype == torch.float32
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
    cot = rng.normal(0, 1, x.shape).astype(np.float32)
    gp, gx = _torch_grads(lambda p, x: moe_gmm.moe_mlp_gmm_diff(p, x, K, True, block_rows=8),
                          p, x, cot)
    jp, jx = jax.jit(jax.grad(
        lambda p, x: jnp.sum(jgmm.moe_mlp_gmm_diff(p, x, K, True, block_rows=8,
                                                   interpret=True) * cot),
        argnums=(0, 1)))(_to(p, jnp.asarray), jnp.asarray(x))
    np.testing.assert_allclose(gx, np.asarray(jx), **GRAD_TOL)
    for path in PATHS:
        np.testing.assert_allclose(_leaf(gp, path), np.asarray(_leaf(jp, path)),
                                   err_msg="/".join(path), **GRAD_TOL)


# ---------------------------------------------------------------------------
# the SFT steps over the tiny MoE judge
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def judge():
    """(JAX params as numpy, our config, JAX config), the flags on."""
    cfg, jcfg = _configs()
    return jax.tree.map(np.asarray, j_init(jcfg, seed=5)), cfg, jcfg


def _batch(seed: int):
    """Two text records of 24 tokens (48 > RAGGED_MAX_TOKENS, so the MoE
    blocks take the GMM path), the second padded by 5; the first 6 tokens
    of each masked from the loss."""
    r = np.random.default_rng(seed)
    B, S = 2, 24
    ids = r.integers(2, 256, (B, S))
    mask = np.ones((B, S), np.int32)
    mask[1, S - 5:] = 0
    ids[1, S - 5:] = 0
    labels = np.where(mask == 1, ids, -100)
    labels[:, :6] = -100
    pos = np.broadcast_to(np.arange(S)[None, None], (3, B, S)).copy()
    arrays = {"input_ids": ids, "labels": labels, "position_ids": pos,
              "attention_mask": mask}
    return ({k: jnp.asarray(v) for k, v in arrays.items()},
            {k: T(v) for k, v in arrays.items()})


def _count_gmm_diff(monkeypatch):
    calls = []
    real = moe_gmm.moe_mlp_gmm_diff

    def counted(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(moe_gmm, "moe_mlp_gmm_diff", counted)
    return calls


def test_full_parameter_sft_step_trains_moe_through_the_einsum(judge, monkeypatch):
    """make_sft_step with moe_gmm_prefill on trains through the grouped
    einsum, as the reference's step does: step-1 loss and gradient norm
    equal the JAX step's, no MoE call takes the GMM path during the step,
    and the blocks' switch is restored after it."""
    np_params, cfg, jcfg = judge
    jbatch, batch = _batch(0)
    okw = dict(learning_rate=1e-4, total_steps=4)
    jopt = j_make_optimizer(JOptimConfig(**okw), np_params)
    jstep = j_make_sft_step(jcfg, JSFTConfig(ce_chunk_size=32), jopt, donate=False)
    _, jm = jstep(j_init_train_state(jax.tree.map(jnp.asarray, np_params), jopt), jbatch)

    model = load_jax_params(init_params(cfg, seed=0, device="cpu"), np_params)
    model.requires_grad_(True)
    state = init_train_state(dict(model.named_parameters()), OptimConfig(**okw))
    calls = _count_gmm_diff(monkeypatch)
    _, m = make_sft_step(model, SFTConfig(ce_chunk_size=32))(state, batch)
    assert not calls
    assert all(mod.gmm_prefill for mod in model.modules() if isinstance(mod, MoEMLP))
    assert cfg.text.moe_gmm_prefill
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=2e-5)
    np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]), rtol=1e-4)


def test_lora_sft_step_over_the_moe_judge_matches_jax(judge, monkeypatch):
    """The slice as a whole: make_lora_sft_step over the tiny MoE judge with
    moe_gmm_prefill on (every MoE call through the GMM backward: dX, no
    expert weight gradient) against JAX's make_lora_sft_step on the same
    weights and adapters (B random, so both adapters' gradients are
    nonzero): step-1 loss and every adapter gradient."""
    np_params, cfg, jcfg = judge
    jbatch, batch = _batch(1)
    lkw = dict(r=4, alpha=8)
    jl = jlora.init_lora(jax.tree.map(jnp.asarray, np_params), jlora.LoRAConfig(**lkw), seed=1)
    r = np.random.default_rng(2)
    jl = jax.tree_util.tree_map_with_path(
        lambda path, v: (jnp.asarray(r.normal(0, 0.1, v.shape), v.dtype)
                         if path[-1].key == "b" else v), jl)
    jparams = jax.tree.map(jnp.asarray, np_params)
    jscfg = JSFTConfig(ce_chunk_size=32)
    jgrads = jax.grad(lambda l: j_sft_loss(jlora.attach_lora(jparams, l, jlora.LoRAConfig(**lkw)),
                                           jcfg, jbatch, jscfg))(jl)
    okw = dict(learning_rate=1e-3, total_steps=2)
    jopt = j_make_optimizer(JOptimConfig(**okw), jl)
    jstep = jlora.make_lora_sft_step(jparams, jcfg, jscfg, jlora.LoRAConfig(**lkw), jopt,
                                     donate=False)
    _, jm = jstep(jlora.LoRATrainState(jl, jopt.init(jl), jnp.zeros((), jnp.int32)), jbatch)

    model = load_jax_params(init_params(cfg, seed=0, device="cpu"), np_params)
    lcfg = LoRAConfig(**lkw)
    params = attach_lora(model, init_lora(model, lcfg), lcfg)
    load_jax_lora(model, jax.tree.map(np.asarray, jl))
    state = init_train_state(params, OptimConfig(**okw))
    calls = _count_gmm_diff(monkeypatch)
    step = make_lora_sft_step(model, SFTConfig(ce_chunk_size=32, attn_impl="flash"))
    _, m = step(state, batch)
    # forward, and the recompute of each layer in the backward
    assert len(calls) == 2 * cfg.text.num_hidden_layers
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=2e-5)
    ref = {}
    for name, arr in flatten_jax_tree(jax.tree.map(np.asarray, jgrads)).items():
        kernel, leaf = name.rsplit(".", 1)
        ref[f"{kernel.rsplit('.', 1)[0]}.lora_{leaf}"] = arr
    assert ref.keys() == params.keys()
    for n, p in params.items():
        assert np.linalg.norm(p.grad.numpy() - ref[n]) <= 1e-3 * np.linalg.norm(ref[n]), n
    ours = np.concatenate([p.grad.numpy().ravel() for p in params.values()])
    want = np.concatenate([ref[n].ravel() for n in params])
    assert np.linalg.norm(ours - want) <= 1e-4 * np.linalg.norm(want)


def test_gmm_bwd_dw_plain_rounds_the_fp32_sum_once(rng):
    """The weight-gradient plain versions in bf16 (the card kernel's output
    type): the per-expert fp32 sums of the bf16 operands, rounded to bf16
    once; the default output is the operands' dtype, and out_dtype asks
    for another (float32: the sums unrounded). An expert with no valid
    block is exactly zero."""
    bm, I = 8, 16
    ids = torch.tensor([0, 0, 2, 5, 7], dtype=torch.int32)
    valid = torch.tensor([1, 1, 1, 1, 0], dtype=torch.int32)
    xs, dg, du = (T(rng.normal(0, 1, (5, bm, n)).astype(np.float32)).bfloat16()
                  for n in (H, I, I))
    dys = T(rng.normal(0, 1, (5, bm, H)).astype(np.float32))
    xs[4] = float("nan")                          # the slack block: never read
    want = torch.zeros(E, H, I)
    for blk, e in enumerate(ids[:4].tolist()):
        want[e] += xs[blk].float().T @ dg[blk].float()
    got, got_u = moe_gmm.gmm_bwd_dw_plain(xs, dg, du, ids, valid, E)
    assert got.dtype == got_u.dtype == torch.bfloat16
    assert torch.equal(got, want.bfloat16())
    exact = moe_gmm.gmm_bwd_dw_plain(xs, dg, du, ids, valid, E, torch.float32)[0]
    assert exact.dtype == torch.float32 and torch.allclose(exact, want, rtol=1e-6, atol=1e-5)
    h = dg
    wd_want = torch.zeros(E, I, H)
    for blk, e in enumerate(ids[:4].tolist()):
        wd_want[e] += h[blk].float().T @ dys[blk].bfloat16().float()
    dwd = moe_gmm.gmm_bwd_dwd_plain(h, dys, ids, valid, E)
    assert dwd.dtype == torch.bfloat16 and torch.equal(dwd, wd_want.bfloat16())
    absent = [1, 3, 4, 6]
    assert not got[absent].any() and not dwd[absent].any()


@pytest.mark.parametrize("N,nb,cols", [(768, 2, 128), (192, 2, 64), (64, 2, 64),
                                       (2048, 1, 256), (768, 1, 256), (320, 1, 64),
                                       (128, 1, 64)])
def test_gmm_bwd_dw_tiles(N, nb, cols):
    """The weight-gradient kernel's tile: 128 rows; 128 columns for dWg /
    dWu and 256 for dWd where they divide the width, else 64."""
    assert moe_gmm.gmm_bwd_dw_tiles(N, nb) == (128, cols)


def test_gmm_diff_bf16_expert_grads_match_jax(rng):
    """The MoE backward's expert gradients in bf16 (weights, x and the
    cotangent bf16; the same routing given to both): the port's
    _GmmExpertFFN on the CPU (the kernels' plain versions, which round dY,
    dg / du / h to bf16 where the card kernels do, and each dW's fp32 sum
    once) against JAX's gmm_expert_ffn_diff (its Pallas kernels in
    interpret mode, f32 inside, dwg.astype(bf16) at the end). Both give
    bf16 gradients; relative L2 <= 2e-2 per tensor, the difference of the
    rounding points (bf16 steps are 2**-8 of a value); an expert no slot
    routes to gets exactly 0 in both."""
    p = _moe_params(rng)
    x = rng.normal(0, 1, (24, H)).astype(np.float32)
    # expert 6 gets no slot, as in test_gmm_diff_grads_match_jax_and_the_einsum
    x[:, 0] = 3.0
    p["router"]["kernel"][:, 6] = 0.0
    p["router"]["kernel"][0, np.arange(E) != 6] += 3.0
    cot = rng.normal(0, 1, (24, H)).astype(np.float32)
    topv, topi = moe.route(T(p["router"]["kernel"]), T(x), K, True)
    w = [p["experts"][n]["kernel"] for n in ("gate", "up", "down")]
    bf = lambda a: torch.from_numpy(a).bfloat16()  # noqa: E731

    ws = [bf(a).requires_grad_() for a in w]
    out = moe_gmm._GmmExpertFFN.apply(bf(x), topv, topi, *ws, 4, "kernel")
    ours = torch.autograd.grad((out.float() * T(cot)).sum(), ws)

    jw = tuple(jnp.asarray(a, jnp.bfloat16) for a in w)
    jx, jv, ji = jnp.asarray(x, jnp.bfloat16), jnp.asarray(topv.numpy()), jnp.asarray(topi.numpy())
    ref = jax.grad(lambda ws: jnp.sum(jgmm.gmm_expert_ffn_diff(
        jx, jv, ji, ws, 4, True).astype(jnp.float32) * cot))(jw)
    for name, a, b in zip(("gate", "up", "down"), ours, ref):
        assert a.dtype == torch.bfloat16 and b.dtype == jnp.bfloat16, name
        b = torch.from_numpy(np.array(b.astype(jnp.float32)))
        rel = float((a.float() - b).norm() / b.norm())
        assert rel <= 2e-2, (name, rel)
        assert not a[6].any() and not b[6].any(), name
