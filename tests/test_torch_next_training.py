"""Qwen3-Next training in the port against the JAX package, on the CPU.

tests/test_torch_qwen3_next.py's tiny fp32 config, the JAX weights carried
across by models/convert.py (load_jax_next_params, load_jax_next_lora) and
the port's adapters and gradients stacked back by next_lora_tree, so both
sides compare like with like. Tolerances (fp32 on both sides, the same
products summed in other orders):
- the plain flash forward-with-LSE and backward at head dim 256 against
  the JAX flash_attention VJP (its Pallas kernels in interpret mode): 1e-5;
- next_loss: 1e-5 relative; its gradients, every parameter: within 1e-4 of
  each tensor's largest entry;
- the MoE training route (models/moe.py::moe_mlp_train) against the JAX
  einsum, outputs and gradients: 1e-5 of each tensor's largest entry;
- three Adam steps of make_next_lora_sft_step (bf16-free, fp32): the
  losses 1e-5 relative, the adapters within 1e-4.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from tests.test_torch_qwen3_next import TINY, jax_tree, pair  # noqa: E402
from video_r2_tpu.models import moe as jmoe  # noqa: E402
from video_r2_tpu.models import qwen3_next as J  # noqa: E402
from video_r2_tpu.ops import flash as jflash  # noqa: E402
from video_r2_tpu.train import lora as jlora  # noqa: E402
from video_r2_tpu_torch.models import qwen3_next as P  # noqa: E402
from video_r2_tpu_torch.models.convert import (  # noqa: E402
    flatten_next_tree,
    load_jax_next_lora,
    next_lora_tree,
)
from video_r2_tpu_torch.models.moe import moe_mlp_train  # noqa: E402
from video_r2_tpu_torch.ops.flash import (  # noqa: E402
    flash_attention,
    flash_attention_bwd,
    flash_attention_fwd_lse,
)
from video_r2_tpu_torch.train.lora import (  # noqa: E402
    LoRAConfig,
    attach_lora,
    init_lora,
    init_lora_for_quantized,
)
from video_r2_tpu_torch.train.optim import OptimConfig  # noqa: E402
from video_r2_tpu_torch.train.sft import init_train_state  # noqa: E402

TOL = 1e-5
GRAD_TOL = 1e-4
LR = 1e-3
T = torch.from_numpy


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def assert_scaled(ours, ref, tol, name=""):
    """|ours - ref| <= tol * max |ref| elementwise."""
    ours, ref = np.asarray(ours, np.float32), np.asarray(ref, np.float32)
    assert ours.shape == ref.shape, name
    np.testing.assert_allclose(ours, ref, rtol=0, atol=tol * max(np.abs(ref).max(), 1e-30),
                               err_msg=name)


# (Sq, Sk, q_offset, kv length, causal, segments)
FLASH_CASES = {"causal_lengths": (128, 128, 0, 100, True, False),
               "q_offset": (64, 128, 64, 120, True, False),
               "segments": (96, 96, 0, 96, True, True)}


@pytest.mark.parametrize("case", list(FLASH_CASES))
def test_flash_hd256_plain_matches_jax_vjp(case):
    """The flash forward with LSE and the backward at head dim 256 (the
    judge's gated attention: here 4 / 2 heads, B 1), through the wrappers'
    plain versions and through autograd (_FlashFn), against the JAX
    flash_attention's output and its custom VJP's gradients."""
    Sq, Sk, q_offset, n, causal, segmented = FLASH_CASES[case]
    rng = np.random.default_rng(Sq + q_offset)
    nh, kh, hd = 4, 2, 256
    q, cot = (rng.normal(size=(1, Sq, nh, hd)).astype(np.float32) for _ in range(2))
    k, v = (rng.normal(size=(1, Sk, kh, hd)).astype(np.float32) for _ in range(2))
    lengths = np.array([n], np.int32)
    seg = (np.repeat(np.array([[1, 2, 3]], np.int32), Sq // 3, axis=1) if segmented
           else None)

    def jloss(q, k, v):
        out = jflash.flash_attention(q, k, v, kv_lengths=jnp.asarray(lengths), causal=causal,
                                     q_offset=q_offset,
                                     segment_ids=None if seg is None else jnp.asarray(seg),
                                     block_q=64, block_k=64, interpret=True)
        return jnp.sum(out * cot), out
    jgrads, jout = jax.grad(jloss, argnums=(0, 1, 2), has_aux=True)(q, k, v)
    seg_t = None if seg is None else T(seg)
    out, lse = flash_attention_fwd_lse(T(q), T(k), T(v), T(lengths), causal, q_offset, seg_t)
    assert lse.shape == (1, nh, Sq)
    grads = flash_attention_bwd(T(q), T(k), T(v), out, T(cot), lse, T(lengths), causal,
                                q_offset, seg_t)
    qt, kt, vt = (T(x).requires_grad_() for x in (q, k, v))
    auto_out = flash_attention(qt, kt, vt, kv_lengths=T(lengths), causal=causal,
                               q_offset=q_offset, segment_ids=seg_t)
    auto = torch.autograd.grad((auto_out * T(cot)).sum(), (qt, kt, vt))
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(auto_out.detach().numpy(), np.asarray(jout), rtol=TOL, atol=TOL)
    for name, a, b, ref in zip("qkv", grads, auto, jgrads):
        np.testing.assert_allclose(a.numpy(), np.asarray(ref), rtol=TOL, atol=TOL, err_msg=name)
        np.testing.assert_allclose(b.numpy(), np.asarray(ref), rtol=TOL, atol=TOL, err_msg=name)


@pytest.fixture(scope="module")
def tree():
    return jax_tree(J.Qwen3NextConfig(**TINY), seed=3)


@pytest.fixture(scope="module")
def batch():
    """B 2 x S 12, row 1 right-padded to 8 (lengths), labels shifted by one
    with the first two and the padding at -100."""
    rng = np.random.default_rng(11)
    ids = rng.integers(2, 127, (2, 12))
    lengths = np.array([12, 8])
    ids[1, 8:] = 0
    labels = np.full_like(ids, -100)
    labels[:, :-1] = ids[:, 1:]
    labels[:, :2] = -100
    labels[1, 7:] = -100
    return {"input_ids": ids, "labels": labels, "lengths": lengths}


def test_next_loss_and_every_gradient_match_jax(tree, batch):
    """next_loss and the gradient of every parameter (embedding, norms, the
    DeltaNet's conv / A_log / dt_bias / projections, the gated attention,
    router, routed experts through the GMM route, shared expert, lm_head)
    against jax.value_and_grad(next_loss), with lengths and -100 labels."""
    jp, jcfg, model, cfg = pair(tree)
    jloss, jgrads = jax.value_and_grad(J.next_loss)(
        jp, jcfg, jnp.asarray(batch["input_ids"]), jnp.asarray(batch["labels"]),
        jnp.asarray(batch["lengths"]))
    model.requires_grad_(True)
    loss = P.next_loss(model, cfg, batch["input_ids"], batch["labels"], batch["lengths"])
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=TOL)
    ref = flatten_next_tree(jax.tree.map(np.asarray, jgrads))
    params = dict(model.named_parameters())
    assert ref.keys() == params.keys()
    for name, p in params.items():
        assert p.grad is not None, name
        assert_scaled(p.grad.numpy(), ref[name], GRAD_TOL, name)


@pytest.mark.parametrize("capacity_factor", [0.0, 1.0])
@pytest.mark.parametrize("int8", [False, True], ids=["float", "int8"])
def test_moe_training_route_matches_jax_einsum(capacity_factor, int8):
    """moe_mlp_train against the JAX einsum (the reference's next_loss
    route) on E 8, top 2, groups of 16 tokens: at capacity factor 0 through
    the GMM (the same function), at 1.0 through the einsum, which drops
    over-capacity slots (some do here). Output and the gradients of x and the
    router; float experts also their own."""
    from video_r2_tpu.models.quant import quantize_kernel as jquantize
    from video_r2_tpu_torch.models.moe import capacity_drop_stats

    rng = np.random.default_rng(5)
    E, H, I, k, B, S = 8, 32, 16, 2, 2, 24
    x, cot = (rng.normal(size=(B, S, H)).astype(np.float32) for _ in range(2))
    router = rng.normal(0, 0.5, (H, E)).astype(np.float32)
    w = {n: rng.normal(0, d ** -0.5, (E, d, o)).astype(np.float32)
         for n, (d, o) in (("gate", (H, I)), ("up", (H, I)), ("down", (I, H)))}
    jex = {n: (jax.tree.map(np.asarray, jquantize(jnp.asarray(a))) if int8 else {"kernel": a})
           for n, a in w.items()}
    kw = dict(num_experts_per_tok=k, norm_topk_prob=True, capacity_factor=capacity_factor,
              group_size=16)

    def jfn(x, router, experts):
        p = {"router": {"kernel": router}, "experts": experts}
        out = jmoe.moe_mlp(p, x, **kw)
        return jnp.sum(out * cot), out
    diff = {n: jnp.asarray(leaf["kernel"]) for n, leaf in jex.items() if not int8}
    fixed = {n: {kk: jnp.asarray(vv) for kk, vv in leaf.items()} for n, leaf in jex.items()}

    def jwrap(x, router, diff):
        return jfn(x, router, {n: ({"kernel": diff[n]} if n in diff else fixed[n])
                               for n in fixed})
    (jx, jr, jw), jout = jax.grad(jwrap, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(x), jnp.asarray(router), diff)

    xt, rt = T(x).requires_grad_(), T(router).requires_grad_()
    ex = {n: {kk: T(np.array(vv)) for kk, vv in leaf.items()} for n, leaf in jex.items()}
    if not int8:
        for leaf in ex.values():
            leaf["kernel"].requires_grad_()
    p = {"router": {"kernel": rt}, "experts": ex}
    if capacity_factor > 0:
        assert capacity_drop_stats({"router": {"kernel": T(router)}}, T(x), k, True,
                                   capacity_factor, 16)["slot_drop_rate"] > 0
    out = moe_mlp_train(p, xt, **kw)
    wanted = [xt, rt] + ([] if int8 else [ex[n]["kernel"] for n in ("gate", "up", "down")])
    grads = torch.autograd.grad((out * T(cot)).sum(), wanted)
    assert_scaled(out.detach().numpy(), jout, TOL, "out")
    assert_scaled(grads[0].numpy(), jx, TOL, "dx")
    assert_scaled(grads[1].numpy(), jr, TOL, "d router")
    for n, g in zip(("gate", "up", "down"), grads[2:]):
        assert_scaled(g.numpy(), jw[n], TOL, n)


def _lora_runs(tree, batch, quantized: bool):
    """Three Adam steps of the JAX make_next_lora_sft_step and of the port's
    from the same adapters (B drawn nonzero, so dA is formed): (JAX losses,
    JAX adapters, port losses, port adapters as the JAX tree, adapter
    names)."""
    jp, jcfg, model, cfg = pair(tree)
    model.requires_grad_(False)
    if quantized:
        jp = J.quantize_qwen3_next_params(jp, bits=8)
        P.quantize_qwen3_next_params(model, bits=8)
        from video_r2_tpu_torch.models.convert import load_jax_next_params

        load_jax_next_params(model, jax.tree.map(np.asarray, jp))
    jl_cfg = jlora.LoRAConfig(r=4, alpha=8, targets=J.NEXT_LORA_TARGETS)
    l_cfg = LoRAConfig(r=4, alpha=8, targets=P.NEXT_LORA_TARGETS)
    jl = (jlora.init_lora_for_quantized if quantized else jlora.init_lora)(jp, jl_cfg, seed=0)
    rng = np.random.default_rng(2)
    jl = jax.tree_util.tree_map_with_path(
        lambda path, a: (jnp.asarray(rng.normal(0, 0.05, a.shape), a.dtype)
                         if path[-1].key == "b" else a), jl)
    opt = optax.adam(LR)
    jstep = J.make_next_lora_sft_step(jp, jcfg, jl_cfg, opt, donate=False)
    jstate = jlora.LoRATrainState(jl, opt.init(jl), 0)
    jbatch = {n: jnp.asarray(a) for n, a in batch.items()}
    jlosses = []
    for _ in range(3):
        jstate, m = jstep(jstate, jbatch)
        jlosses.append(float(m["loss"]))

    init = init_lora_for_quantized if quantized else init_lora
    params = attach_lora(model, init(model, l_cfg), l_cfg)
    load_jax_next_lora(model, jax.tree.map(np.asarray, jl))
    state = init_train_state(params, OptimConfig(
        learning_rate=LR, weight_decay=0.0, warmup_ratio=0.0, schedule="constant",
        max_grad_norm=float("inf")))
    step = P.make_next_lora_sft_step(model, cfg)
    losses = []
    for _ in range(3):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
        assert np.isfinite(float(m["grad_norm"]))
    assert state.step == 3
    return (jlosses, jax.tree.map(np.asarray, jstate.lora), losses,
            next_lora_tree({n: p.detach() for n, p in params.items()}), params)


@pytest.mark.parametrize("quantized", [False, True], ids=["bf16_base", "int8_base"])
def test_next_lora_sft_steps_match_jax(tree, batch, quantized):
    """make_next_lora_sft_step over a float base and over an int8 one
    (quantize_qwen3_next_params(bits=8) on both sides, adapters from
    init_lora_for_quantized: QLoRA): every adapter of NEXT_LORA_TARGETS
    (lin qkvz / out, full q / k / v / o, the shared experts; no routed
    expert, no router), three Adam steps from the JAX adapters, the losses
    and the adapters after them against the JAX step's."""
    jlosses, jlora_tree, losses, ours, params = _lora_runs(tree, batch, quantized)
    assert not any(".experts." in n or ".router." in n for n in params)
    assert {n.rsplit(".", 2)[-2] for n in params} == {
        "qkvz", "out", "q", "k", "v", "o", "gate", "up", "down"}
    np.testing.assert_allclose(losses, jlosses, rtol=TOL)
    assert losses[2] < losses[0]
    ref = flatten_next_tree(jlora_tree)
    got = flatten_next_tree(ours)
    assert got.keys() == ref.keys()
    for name in ref:
        np.testing.assert_allclose(got[name], ref[name], rtol=0, atol=GRAD_TOL, err_msg=name)


def test_next_lora_step_refuses_a_trainable_base(tree):
    """No adapters attached, or a base parameter that requires grad: the
    step refuses (ValueError) before any step runs."""
    _, _, model, cfg = pair(tree)
    model.requires_grad_(False)
    with pytest.raises(ValueError, match="no adapters"):
        P.make_next_lora_sft_step(model, cfg)
    l_cfg = LoRAConfig(r=4, alpha=8, targets=P.NEXT_LORA_TARGETS)
    attach_lora(model, init_lora(model, l_cfg), l_cfg)
    model.groups[0].full.q_norm.requires_grad_(True)
    with pytest.raises(ValueError, match="base parameters require grad"):
        P.make_next_lora_sft_step(model, cfg)
