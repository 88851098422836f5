"""The port's GRPO layer against the JAX package, on the CPU.

Tiny config in float32 with the same base weights and adapters in both
packages (load_jax_params, load_jax_lora). The JAX side runs attn_impl
"xla", its CPU route; the port runs "flash" (segment ids for the
[prompt_pad | completion] gap) through its autograd Functions' plain steps,
as tests/test_torch_train.py does, and "xla" where named. Tolerances:

- host functions (masks, combined rewards, advantages) and the dataset:
  exactly equal;
- chunked token log-probs: values, dh and dW rtol 1e-5 (float32 sums of
  the same products in another order);
- the GRPO loss, KL and clip ratios: rtol 1e-5, atol 1e-6; the adapter
  gradients as one vector: relative L2 1e-4 (two float32 decoders, the
  flash path's softmax in another order than the masked one). The JAX
  side takes its grpo_loss over log-probs computed once per batch and its
  gradients by the chain rule through per_token_logps' VJP (what
  jax.value_and_grad of the whole loss computes); the port runs the whole
  loss and its backward in every case;
- the full-parameter step: loss rtol 1e-5, grad_norm rtol 1e-4; the
  update of every parameter (after - before) as one vector within relative
  L2 1e-3 of JAX's and each element within 2 lr (measured 2.2e-4 and
  0.026 lr): Adam's first update moves every element by ~lr whatever its
  gradient's size, so an element whose gradient sits at float32 noise may
  move another way;
- QLoRA over int8: the same loss and adapter-gradient bounds.
The GRPO cycles themselves are in tests/test_torch_grpo_cycle.py.
"""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_r2_tpu.data.config import DataConfig as JDataConfig
from video_r2_tpu.data.grpo import GRPODataset as JGRPODataset
from video_r2_tpu.video.api import fetch_video as j_fetch_video
from video_r2_tpu.models.config import tiny_test_config as j_tiny
from video_r2_tpu.models.loader import init_params as j_init
from video_r2_tpu.models.quant import quantize_params as j_quantize_params
from video_r2_tpu.ops.logprobs import chunked_token_logprobs as j_logprobs
from video_r2_tpu.train import grpo as jgrpo
from video_r2_tpu.train import lora as jlora
from video_r2_tpu.train.optim import OptimConfig as JOptimConfig
from video_r2_tpu.train.optim import make_optimizer as j_make_optimizer
from video_r2_tpu_torch.apps import train_grpo as app_grpo
from video_r2_tpu_torch.config import AppConfig, RunConfig
from video_r2_tpu_torch.data.config import DataConfig
from video_r2_tpu_torch.data.grpo import GRPODataset
from video_r2_tpu_torch.engine.chat import ByteTokenizer
from video_r2_tpu_torch.engine.continuous import PagedContinuousEngine
from video_r2_tpu_torch.engine.sampling import SamplingParams
from video_r2_tpu_torch.models.config import tiny_test_config
from video_r2_tpu_torch.models.convert import flatten_jax_tree, load_jax_lora, load_jax_params
from video_r2_tpu_torch.models.loader import init_params
from video_r2_tpu_torch.models.quant import quantize_params
from video_r2_tpu_torch.ops import int8_matmul
from video_r2_tpu_torch.ops.logprobs import chunked_token_logprobs
from video_r2_tpu_torch.models.mrope import mrope_cos_sin
from video_r2_tpu_torch.rewards.embedding import HashingEmbedder
from video_r2_tpu_torch.rewards.judge import StaticJudge
from video_r2_tpu_torch.train import grpo
from video_r2_tpu_torch.train.grpo_runner import GRPORunner
from video_r2_tpu_torch.train.lora import (
    LoRAConfig,
    adapters_disabled,
    attach_lora,
    init_lora,
    init_lora_for_quantized,
    make_lora_grpo_step,
)
from video_r2_tpu_torch.train.optim import OptimConfig
from video_r2_tpu_torch.train.sft import init_train_state
from video_r2_tpu_torch.video.api import fetch_video

T = torch.from_numpy
LKW = dict(r=4, alpha=8)
# ByteTokenizer with the tiny config's special ids (all below its vocab of 512)
SPECIALS = {"<|endoftext|>": 0, "<|im_start|>": 300, "<|im_end|>": 1,
            "<|vision_start|>": 502, "<|vision_end|>": 503,
            "<|image_pad|>": 500, "<|video_pad|>": 501}


@pytest.fixture(scope="module")
def base():
    jparams = j_init(j_tiny(), seed=3)
    return jparams, jax.tree.map(np.asarray, jparams)


def _port_model(np_params, quantized=False):
    model = init_params(tiny_test_config(), seed=0, device="cpu")
    if quantized:
        quantize_params(model, bits=8)
    return load_jax_params(model, np_params)


def _adapter_names(tree):
    """A JAX adapter tree -> {port adapter name: array}."""
    out = {}
    for name, arr in flatten_jax_tree(jax.tree.map(np.asarray, tree)).items():
        kernel, leaf = name.rsplit(".", 1)
        out[f"{kernel.rsplit('.', 1)[0]}.lora_{leaf}"] = arr
    return out


def _rel_l2(ours, want):
    return float(np.linalg.norm(ours - want) / max(np.linalg.norm(want), 1e-30))


# ---------------------------------------------------------------------------
# host functions
# ---------------------------------------------------------------------------

NAMES = ["accuracy_reward", "format_reward", "tar_reward"]


def _host_case(case, rng):
    """(port result, JAX result) of one host function on the same inputs."""
    if case.startswith("mask"):
        ids = rng.integers(0, 6, (7, 9))
        ids[2] = 3                                      # no EOS
        ids[4, 0] = 1                                   # EOS first
        return [(f(ids, 1, case == "mask_truncated"))
                for f in (grpo.completion_mask_from_ids, jgrpo.completion_mask_from_ids)]
    r = rng.choice([0.0, 0.3, 1.0, np.nan], size=(8, 3), p=[0.3, 0.2, 0.4, 0.1])
    r[:, 0] = rng.choice([0.0, 0.05, 0.5, 1.0], size=8)
    kw = {"combine": dict(positive_reinforcement="format_reward, tar_reward",
                          reward_weights=(1.0, 0.5, 2.0), num_generations=4),
          "adv_grpo_scaled": dict(num_generations=4),
          "adv_grpo_unscaled": dict(num_generations=4, scale_rewards=False),
          "adv_mapo_accuracy": dict(num_generations=4, loss_type="mapo"),
          "adv_mapo_no_accuracy": dict(num_generations=2, loss_type="mapo_bnpo")}[case]
    names = NAMES if case != "adv_mapo_no_accuracy" else ["a_reward", "b_reward", "c_reward"]
    out = []
    for mod in (grpo, jgrpo):
        cfg = mod.GRPOConfig(**kw)
        total = mod.combine_rewards(r, names, cfg)
        out.append(total if case == "combine" else
                   mod.compute_advantages(total, r, names, cfg))
    return out


@pytest.mark.parametrize("case", ["mask", "mask_truncated", "combine", "adv_grpo_scaled",
                                  "adv_grpo_unscaled", "adv_mapo_accuracy",
                                  "adv_mapo_no_accuracy"])
def test_host_functions_match_jax(rng, case):
    ours, ref = _host_case(case, rng)
    assert ours.dtype == ref.dtype
    np.testing.assert_array_equal(ours, ref)


def test_config_refuses_what_the_port_cannot_run():
    assert grpo.GRPOConfig(rollout_spec_decode=2).rollout_spec_decode == 2   # ported
    with pytest.raises(NotImplementedError, match="Queue 1 #8"):
        grpo.make_grpo_step(None, grpo.GRPOConfig(), mesh=object())


# ---------------------------------------------------------------------------
# chunked token log-probs
# ---------------------------------------------------------------------------

def test_chunked_logprobs_match_jax(rng):
    """N = 37 rows in chunks of 8 (the last chunk ragged), temperature 0.7:
    values, dh and dW against the JAX custom VJP."""
    N, H, V = 37, 16, 64
    h = rng.normal(size=(N, H)).astype(np.float32)
    w = rng.normal(size=(H, V)).astype(np.float32) * 0.5
    toks = rng.integers(0, V, N)
    g = rng.normal(size=N).astype(np.float32)
    ref, vjp = jax.vjp(lambda a, b: j_logprobs(a, b, jnp.asarray(toks), 0.7, 8),
                       jnp.asarray(h), jnp.asarray(w))
    dh_ref, dw_ref = vjp(jnp.asarray(g))
    th, tw = T(h).requires_grad_(), T(w).requires_grad_()
    out = chunked_token_logprobs(th, tw, T(toks), 0.7, 8)
    out.backward(T(g))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(th.grad.numpy(), np.asarray(dh_ref), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(dw_ref), rtol=1e-5, atol=1e-6)
    # a frozen head: no weight gradient is formed
    th.grad = None
    chunked_token_logprobs(th, T(w), T(toks), 0.7, 8).backward(T(g))
    np.testing.assert_allclose(th.grad.numpy(), np.asarray(dh_ref), rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# the GRPO loss
# ---------------------------------------------------------------------------

def _loss_batch(rng, B=4, P=10, C=6, V=512):
    """Left-padded prompts (ragged), completions with a masked tail, M-RoPE
    positions counting from each row's first valid token."""
    lens = np.array([10, 7, 9, 4])[:B]
    ids = np.zeros((B, P + C), np.int64)
    mask = np.zeros((B, P + C), np.int32)
    cmask = np.ones((B, C), np.int32)
    cmask[1, 4:] = 0
    cmask[3, 2:] = 0
    for b in range(B):
        ids[b, P - lens[b]:] = rng.integers(2, 256, lens[b] + C)
        mask[b, P - lens[b]:P] = 1
    mask[:, P:] = cmask
    pos = np.broadcast_to(np.maximum(np.arange(P + C)[None] - (P - lens)[:, None], 0),
                          (3, B, P + C)).copy()
    return {"input_ids": ids, "position_ids": pos, "attention_mask": mask,
            "completion_mask": cmask,
            "advantages": rng.normal(size=B).astype(np.float32),
            "old_per_token_logps": (-6.2 + 0.3 * rng.normal(size=(B, C))).astype(np.float32),
            "ref_per_token_logps": (-6.2 + 0.3 * rng.normal(size=(B, C))).astype(np.float32)}


def _lora_with_b(jparams, lcfg, rng, init=jlora.init_lora):
    """JAX adapters with B != 0, so A's gradients are not 0."""
    lora = init(jparams, lcfg, seed=1)
    return jax.tree_util.tree_map_with_path(
        lambda p, x: (jnp.asarray(rng.normal(size=x.shape).astype(np.float32) * 0.05)
                      if p[-1].key == "b" else x), lora)


def _jax_reference(jparams, batch, temperature, chunk, quantized=False):
    """JAX's adapters (B != 0) and the VJP of its per_token_logps with
    respect to them, on the loss batch."""
    jlcfg = jlora.LoRAConfig(**LKW)
    init = jlora.init_lora_for_quantized if quantized else jlora.init_lora
    jl = _lora_with_b(jparams, jlcfg, np.random.default_rng(7), init)
    C = batch["completion_mask"].shape[1]
    lp, vjp = jax.vjp(lambda l: jgrpo.per_token_logps(
        jlora.attach_lora(jparams, l, jlcfg), j_tiny(), jnp.asarray(batch["input_ids"]),
        jnp.asarray(batch["position_ids"]), jnp.asarray(batch["attention_mask"]), C,
        temperature, chunk), jl)
    return jl, lp, vjp


def _jax_loss(ref, batch, gkw):
    """JAX's grpo_loss over the reference's log-probs, and the adapter
    gradients by the chain rule through per_token_logps' VJP: what
    jax.value_and_grad of the whole loss computes, with the decoder's forward
    and backward run once for every case."""
    _, lp0, vjp = ref
    jbatch = {k: jnp.asarray(v) for k, v in batch.items() if v is not None}

    def loss_of(lp):
        real = jgrpo.per_token_logps
        jgrpo.per_token_logps = lambda *a, **k: lp
        try:
            return jgrpo.grpo_loss(None, j_tiny(), jgrpo.GRPOConfig(**gkw), jbatch)
        finally:
            jgrpo.per_token_logps = real

    (loss, m), dlp = jax.value_and_grad(loss_of, has_aux=True)(lp0)
    return loss, m, vjp(dlp)[0]


def _loss_pair(np_params, batch, gkw, attn_impl, ref, quantized=False):
    """(port (loss, metrics, grads vector), JAX (loss, metrics, grads vector))
    of grpo_loss over the same adapters; the port runs the whole loss and
    its backward."""
    lcfg = LoRAConfig(**LKW)
    jloss, jm, jgrads = _jax_loss(ref, batch, gkw)
    model = _port_model(np_params, quantized)
    init_p = init_lora_for_quantized if quantized else init_lora
    params = attach_lora(model, init_p(model, lcfg), lcfg)
    load_jax_lora(model, jax.tree.map(np.asarray, ref[0]))
    loss, m = grpo.grpo_loss(model, grpo.GRPOConfig(**gkw),
                             {k: T(v) for k, v in batch.items() if v is not None},
                             attn_impl=attn_impl)
    loss.backward()
    want_g = _adapter_names(jgrads)
    assert want_g.keys() == params.keys()
    ours = np.concatenate([p.grad.numpy().ravel() for p in params.values()])
    want = np.concatenate([want_g[n].ravel() for n in params])
    return ((loss.detach().item(), {k: float(v.detach()) for k, v in m.items()}, ours),
            (float(jloss), {k: float(v) for k, v in jm.items()}, want))


LOSS_KW = dict(max_completion_length=6, logp_chunk_size=8, epsilon_high=0.28,
               temperature=0.9)


@pytest.fixture(scope="module")
def loss_ref(base):
    """The loss batch and JAX's log-probs / VJP on it, shared by the cases."""
    jparams, _ = base
    batch = _loss_batch(np.random.default_rng(11))
    return batch, _jax_reference(jparams, batch, LOSS_KW["temperature"],
                                 LOSS_KW["logp_chunk_size"])


@pytest.mark.parametrize("old", ["old", "no_old"])
@pytest.mark.parametrize("beta", [0.0, 0.04])
@pytest.mark.parametrize("loss_type", ["grpo", "bnpo", "dr_grpo", "gmpo", "mapo",
                                       "mapo_bnpo"])
def test_grpo_loss_matches_jax(base, loss_ref, loss_type, beta, old):
    """Every loss type x beta x old logps given or not: loss, KL, clip
    ratios and adapter gradients; the port on the flash segment-id path
    (and, for grpo with both, on the xla path too)."""
    _, np_params = base
    batch, ref = loss_ref
    if old == "no_old":
        batch = {**batch, "old_per_token_logps": None}
    gkw = dict(loss_type=loss_type, beta=beta, **LOSS_KW)
    impls = ["flash", "xla"] if (loss_type, beta, old) == ("grpo", 0.04, "old") else ["flash"]
    for impl in impls:
        (loss, m, g), (jloss, jm, jg) = _loss_pair(np_params, batch, gkw, impl, ref)
        np.testing.assert_allclose(loss, jloss, rtol=1e-5, atol=1e-6)
        assert m.keys() == jm.keys()
        for k in jm:
            np.testing.assert_allclose(m[k], jm[k], rtol=1e-5, atol=1e-6, err_msg=k)
        assert _rel_l2(g, jg) <= 1e-4, impl
    if old == "old" and loss_type != "gmpo":   # token ratios off 1: the clip is active
        assert m["clip_ratio/region"] > 0


def test_segment_ids_reach_the_decoder(base):
    """Decoder.forward's segment_ids: the flash path with segments equals the
    masked path with the same mask at every completion token the loss
    reads, and differs without them."""
    _, np_params = base
    model = _port_model(np_params)
    b = _loss_batch(np.random.default_rng(0))
    ids, mask = T(b["input_ids"]), T(b["attention_mask"])
    pos = T(b["position_ids"])
    with torch.no_grad():
        lp = {impl: grpo.per_token_logps(model, ids, pos, mask, 6, 1.0, attn_impl=impl)
              for impl in ("flash", "xla")}
        h = model.model.embed_tokens(ids)
        cos, sin = mrope_cos_sin(pos, model.cfg, dtype=h.dtype)
        full = torch.full((4,), ids.shape[1], dtype=torch.int32)
        no_seg = model.model(h, cos, sin, None, attn_impl="flash", kv_lengths=full,
                             causal=True)
        seg = model.model(h, cos, sin, None, attn_impl="flash", kv_lengths=full,
                          causal=True, segment_ids=torch.where(mask == 1, 1, -1).int())
    keep = b["completion_mask"] == 1    # masked tokens attend differently on the two paths
    np.testing.assert_allclose(lp["flash"].numpy()[keep], lp["xla"].numpy()[keep],
                               rtol=1e-5, atol=1e-5)
    assert not torch.allclose(no_seg[:, -6:], seg[:, -6:], atol=1e-3)


# ---------------------------------------------------------------------------
# the full-parameter step
# ---------------------------------------------------------------------------

def test_full_parameter_step_matches_jax(base, rng):
    jparams, np_params = base
    batch = _loss_batch(rng)
    gkw = dict(beta=0.04, max_completion_length=6, logp_chunk_size=8)
    okw = dict(learning_rate=1e-4, vision_lr=1e-4, merger_lr=1e-4, total_steps=1,
               warmup_ratio=0.0)
    jopt = j_make_optimizer(JOptimConfig(**okw), jparams)
    jstep = jgrpo.make_grpo_step(j_tiny(), jgrpo.GRPOConfig(**gkw), jopt, donate=False)
    jstate = jgrpo.GRPOTrainState(jparams, jopt.init(jparams), jnp.zeros((), jnp.int32))
    jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    jafter = flatten_jax_tree(jax.tree.map(np.asarray, jstate.params))

    model = _port_model(np_params).requires_grad_(True)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    state = init_train_state(dict(model.named_parameters()), OptimConfig(**okw))
    step = grpo.make_grpo_step(model, grpo.GRPOConfig(**gkw), attn_impl="flash")
    state, m = step(state, {k: T(v) for k, v in batch.items()})
    assert state.step == 1
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]), rtol=1e-4)
    np.testing.assert_allclose(float(m["kl"]), float(jm["kl"]), rtol=1e-5, atol=1e-7)
    lr = okw["learning_rate"]
    flat0 = flatten_jax_tree(np_params)
    ours, want = [], []
    for n, p in model.named_parameters():
        ours.append((p.detach() - before[n]).numpy().ravel())
        want.append((jafter[n] - flat0[n]).ravel())
    ours, want = np.concatenate(ours), np.concatenate(want)
    assert np.abs(ours - want).max() <= 2 * lr
    assert _rel_l2(ours, want) <= 1e-3


# ---------------------------------------------------------------------------
# QLoRA over int8
# ---------------------------------------------------------------------------

def test_qlora_over_int8_matches_jax(base, rng):
    """quantize_params(bits=8) + init_lora_for_quantized give JAX's adapter
    shapes; the GRPO loss over the int8 base matches JAX's loss, KL and
    adapter gradients (the int8 linears under adapters take convert +
    matmul, as the reference's XLA path); one make_lora_grpo_step over it
    moves the adapters and leaves the base as it was."""
    jparams, _ = base
    jq = j_quantize_params(jparams, bits=8)
    np_q = jax.tree.map(np.asarray, jq)
    jlcfg, lcfg = jlora.LoRAConfig(**LKW), LoRAConfig(**LKW)
    jl = jlora.init_lora_for_quantized(jq, jlcfg)
    model = _port_model(np_q, quantized=True)
    ours = init_lora_for_quantized(model, lcfg)
    assert {n: tuple(v.shape) for n, v in ours.items()} == {
        n: v.shape for n, v in _adapter_names(jl).items()}

    batch = _loss_batch(rng)
    gkw = dict(beta=0.04, max_completion_length=6, logp_chunk_size=8)
    ref = _jax_reference(jq, batch, 1.0, 8, quantized=True)
    (loss, m, g), (jloss, jm, jg) = _loss_pair(np_q, batch, gkw, "flash", ref, quantized=True)
    np.testing.assert_allclose(loss, jloss, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(m["kl"], jm["kl"], rtol=1e-5, atol=1e-6)
    assert _rel_l2(g, jg) <= 1e-4

    # one step over the int8 base: the adapters move, the base does not
    attach_lora(model, ours, lcfg)
    base_before = {n: p.clone() for n, p in model.named_parameters() if "lora" not in n}
    params = {n: p for n, p in model.named_parameters() if "lora" in n}
    state = init_train_state(params, OptimConfig(learning_rate=1e-3, warmup_ratio=0.0))
    step = make_lora_grpo_step(model, grpo.GRPOConfig(**gkw), attn_impl="flash")
    b0 = {n: p.detach().clone() for n, p in params.items()}
    state, sm = step(state, {k: T(v) for k, v in batch.items()})
    assert np.isfinite(float(sm["loss"]))
    assert any(not torch.equal(p, b0[n]) for n, p in params.items())
    assert all(torch.equal(p, base_before[n]) for n, p in model.named_parameters()
               if "lora" not in n)


def test_quantized_linear_auto_takes_convert_matmul_under_autograd(monkeypatch):
    """64 bf16 rows that need a gradient never reach the int8 kernel's
    wrapper; the same rows without a gradient do."""
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(64, 96, generator=gen).bfloat16()
    wq = torch.randint(-127, 128, (96, 48), generator=gen, dtype=torch.int8)
    scale = torch.rand(48, generator=gen) * 0.01

    def refuse(*a):
        raise AssertionError("int8_matmul called under autograd")

    monkeypatch.setattr(int8_matmul, "int8_matmul", refuse)
    xg = x.clone().requires_grad_()
    y = int8_matmul.quantized_linear_auto(xg, wq, scale)
    y.float().sum().backward()
    want = (torch.ones(64, 48) @ (wq.float() * scale[None]).T).bfloat16()
    torch.testing.assert_close(xg.grad, want, rtol=2e-2, atol=2e-2)
    with torch.no_grad():
        with pytest.raises(AssertionError, match="under autograd"):
            int8_matmul.quantized_linear_auto(xg, wq, scale)


# ---------------------------------------------------------------------------
# the prefix-cache repair, the dataset, the app
# ---------------------------------------------------------------------------

def test_rollout_engine_keeps_no_prefix_cache_across_a_step(base):
    """A paged rollout of a prompt longer than one page after an optimizer
    step gives a fresh engine's tokens: the reused rollout engine has no
    prefix cache, so no page of KV from the old weights serves it."""
    _, np_params = base
    model = _port_model(np_params)
    lcfg = LoRAConfig(**LKW)
    params = attach_lora(model, init_lora(model, lcfg), lcfg)
    gcfg = grpo.GRPOConfig(num_generations=2, beta=0.0, max_completion_length=6,
                           top_k=1, rollout_backend="paged", max_prompt_length=512)
    step = make_lora_grpo_step(model, gcfg, attn_impl="flash")
    state = init_train_state(params, OptimConfig(learning_rate=3e-2, warmup_ratio=0.0))
    runner = GRPORunner(model, gcfg, ByteTokenizer(SPECIALS), [_parity_reward],
                        ["parity_reward"], step, attn_impl="flash")
    text = "Describe every step of the procedure in order. " * 4     # > 128 tokens
    sample = {"prompt": [{"role": "user", "content": [{"type": "text", "text": text}]}]}
    ids = runner.prepare_prompt(sample).input_ids
    assert ids.shape[0] > 128
    batch, _ = runner.rollout_and_score([sample])
    eng = runner._rollout_eng
    assert eng.prefix_match_len(ids) == 0       # no full page is cached
    # one optimizer step (advantages that do not cancel: the two greedy
    # rollouts are the same sequence)
    batch["advantages"] = torch.tensor([1.0, 0.5])
    state, _ = step(state, batch)
    assert state.step == 1 and all(p.abs().max() > 0 for n, p in params.items()
                                   if n.endswith("lora_b"))
    batch, _ = runner.rollout_and_score([sample])
    assert runner._rollout_eng is eng
    fresh = PagedContinuousEngine(model, num_slots=2, max_len=eng.max_len,
                                  sp=SamplingParams(eos_token_ids=(1,)), attn_impl="flash",
                                  prompt_buckets=(128, 256), page_size=128)
    greedy = SamplingParams(do_sample=True, top_k=1, max_new_tokens=6, eos_token_ids=(1,))
    rid = fresh.submit(list(ids), max_new_tokens=6, sp=greedy)
    out = {}
    while fresh.num_active:
        out.update(dict(fresh.step(8)))
    C = 6
    got = batch["input_ids"][0, -C:].numpy()
    n = len(out[rid])
    np.testing.assert_array_equal(got[:n], np.asarray(out[rid]))


def _parity_reward(completions, **kw):
    return [float(i % 2) for i in range(len(completions))]


def _frame_records(rng):
    return [{"video": rng.integers(0, 256, (4, 56, 84, 3), np.uint8), "video_fps": 2.0,
             "conversations": [{"from": "human", "value": "<video>\nWhat moves?"},
                               {"from": "gpt", "value": "<answer>A</answer>"}],
             "temporal_grounding": {"00:01": "a ball rolls"}},
            {"video": [rng.integers(0, 256, (2, 56, 84, 3), np.uint8)],
             "conversations": [{"from": "human", "value": "Count <video> them."}]}]


def test_grpo_dataset_matches_jax(rng, tmp_path):
    records = _frame_records(rng)
    dkw = dict(video_min_pixels=4 * 28 * 28, video_max_pixels=56 * 84, fps=2.0)
    ours = GRPODataset(records, DataConfig(**dkw))
    ref = JGRPODataset(records, JDataConfig(**dkw))
    for i in range(len(records)):
        a, b = ours[i], ref[i]
        assert a.keys() == b.keys()
        for k in ("assistant", "temporal_captions", "temporal_grounding"):
            assert a[k] == b[k], k
        assert len(a["prompt"]) == len(b["prompt"])
        for ma, mb in zip(a["prompt"], b["prompt"]):
            assert ma["role"] == mb["role"]
            if isinstance(mb["content"], str):
                assert ma["content"] == mb["content"]
                continue
            for ea, eb in zip(ma["content"], mb["content"], strict=True):
                assert ea.keys() == eb.keys()
                for k in eb:
                    if k == "video":
                        assert ea[k] is eb[k]
                    else:
                        assert ea[k] == eb[k], k
    # a video file (refused until the video reader was ported) resolves
    # under image_folder with its .srt under video_subtitles_folder, as in
    # the JAX dataset; the runner's fetch_video then decodes it
    from tests.test_torch_video import SRT, _write_mp4

    folder = tmp_path
    _write_mp4(folder / "clip.mp4", n=12, hw=(56, 84))
    (folder / "clip.srt").write_text(SRT)
    rec = {"video": "clip.mp4", "key_frame": "00:01",
           "conversations": [{"from": "human", "value": "<video>\nWhat moves?"},
                             {"from": "gpt", "value": "<answer>A</answer>"}]}
    dkw = dict(dkw, image_folder=str(folder), video_subtitles_folder=str(folder))
    a, b = GRPODataset([rec], DataConfig(**dkw))[0], JGRPODataset([rec], JDataConfig(**dkw))[0]
    assert a == b
    ele = a["prompt"][1]["content"][0]
    assert ele["video"] == str(folder / "clip.mp4")
    assert ele["subtitles"] == str(folder / "clip.srt")
    feats, jfeats = fetch_video(ele), j_fetch_video(ele)
    np.testing.assert_array_equal(feats.patches, jfeats.patches)
    assert feats.grid_thw == jfeats.grid_thw
    with pytest.raises(NotImplementedError, match="image inputs"):
        GRPODataset([{"image": "a.jpg", "conversations": []}], DataConfig())[0]


def test_runner_refuses_to_cut_a_video_prompt(base):
    """A video prompt past max_prompt_length raises (left truncation would
    cut its vision tokens); a text prompt is left-truncated."""
    _, np_params = base
    model = _port_model(np_params)
    gcfg = grpo.GRPOConfig(max_prompt_length=40)
    runner = GRPORunner(model, gcfg, ByteTokenizer(SPECIALS), [], [], None)
    data = DataConfig(video_min_pixels=4 * 28 * 28, video_max_pixels=56 * 84, fps=2.0)
    sample = GRPODataset(_frame_records(np.random.default_rng(0))[:1], data)[0]
    with pytest.raises(ValueError, match="max_prompt_length"):
        runner.prepare_prompt(sample)
    text = {"prompt": [{"role": "user", "content": "x" * 100}]}
    assert runner.prepare_prompt(text).input_ids.shape == (40,)


def test_train_grpo_app_two_cycles_checkpoint_resume(base, tmp_path):
    """apps/train_grpo.train: two LoRA cycles on the tiny config with the
    default rewards (StaticJudge, HashingEmbedder), a checkpoint, then a
    resume that runs the third cycle only."""
    _, np_params = base
    records = _frame_records(np.random.default_rng(1))
    data = DataConfig(video_min_pixels=4 * 28 * 28, video_max_pixels=56 * 84, fps=2.0)
    dataset = GRPODataset(records, data)

    def app(steps):
        return AppConfig(run=RunConfig(output_dir=str(tmp_path), max_steps=steps,
                                       save_steps=1, use_lora=True, model_preset="tiny-test",
                                       dtype="float32", attn_impl="flash"),
                         data=data, lora=LoRAConfig(**LKW),
                         grpo=grpo.GRPOConfig(num_generations=2, max_completion_length=4,
                                              logp_chunk_size=8, rollout_backend="paged"))

    kw = dict(judge=StaticJudge(["TRUE"]), embedder=HashingEmbedder(),
              tokenizer=ByteTokenizer(SPECIALS))
    model = _port_model(np_params)
    state, hist = app_grpo.train(app(2), model, dataset, **kw)
    assert state.step == 2 and [h["cycle"] for h in hist] == [1, 2]
    assert all(np.isfinite(h["loss"]) for h in hist) and hist[0]["kl"] == 0.0
    assert hist[0]["embedder"] == "hashing-fallback"
    assert (tmp_path / "checkpoint-2").exists()
    assert (tmp_path / "metrics.jsonl").read_text().count("\n") == 2
    model2 = _port_model(np_params)
    state2, hist2 = app_grpo.train(app(3), model2, dataset, **kw)
    assert state2.step == 3 and [h["cycle"] for h in hist2] == [3]
    with adapters_disabled(model2):
        assert not any(n.endswith(".lora_a") for n, _ in model2.named_parameters())
    assert any(n.endswith(".lora_a") for n, _ in model2.named_parameters())


# ---------------------------------------------------------------------------
# the apps' refusals over quantized bases, and QLoRA through the app
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["sft_weight_quant", "grpo_int4", "grpo_full_over_int8"])
def test_apps_refuse_quantized_bases_they_cannot_train(base, case, tmp_path):
    """apps/train_sft.main refuses any weight_quant and apps/train_grpo.main
    int4 before building a model (so with no card too); apps/train_grpo.train
    refuses full-parameter GRPO over an int8 base, whose int8 leaves take
    no gradient, before it touches the model."""
    from video_r2_tpu_torch.apps import train_sft as app_sft

    if case == "sft_weight_quant":
        with pytest.raises(NotImplementedError, match="SFT over a quantized base"):
            app_sft.main(app=AppConfig(run=RunConfig(weight_quant="int8")))
    elif case == "grpo_int4":
        with pytest.raises(NotImplementedError, match="int4"):
            app_grpo.main(app=AppConfig(run=RunConfig(weight_quant="int4")))
    else:
        q_tree = jax.tree.map(np.asarray, j_quantize_params(base[0], bits=8))
        model = _port_model(q_tree, quantized=True)
        app = AppConfig(run=RunConfig(output_dir=str(tmp_path), use_lora=False,
                                      model_preset="tiny-test", dtype="float32"))
        with pytest.raises(NotImplementedError, match="full-parameter GRPO over a "
                                                      "quantized base"):
            app_grpo.train(app, model, None, judge=StaticJudge(["TRUE"]),
                           embedder=HashingEmbedder())
        assert not any(p.requires_grad for p in model.parameters()
                       if not p.is_floating_point())


def test_train_grpo_app_qlora_over_int8(base, tmp_path):
    """apps/train_grpo.train over the int8 tiny model (QLoRA): the adapters
    sit on the int8 linears (init_lora_for_quantized: no float kernel left
    there), one cycle is finite, and only the adapters moved."""
    jparams, _ = base
    model = _port_model(jax.tree.map(np.asarray, j_quantize_params(jparams, bits=8)),
                        quantized=True)
    base_before = {n: p.clone() for n, p in model.named_parameters()}
    data = DataConfig(video_min_pixels=4 * 28 * 28, video_max_pixels=56 * 84, fps=2.0)
    app = AppConfig(run=RunConfig(output_dir=str(tmp_path), max_steps=1, save_steps=1,
                                  use_lora=True, model_preset="tiny-test", dtype="float32"),
                    data=data, lora=LoRAConfig(**LKW),
                    grpo=grpo.GRPOConfig(num_generations=2, max_completion_length=4,
                                         logp_chunk_size=8))
    state, hist = app_grpo.train(app, model, GRPODataset(
        _frame_records(np.random.default_rng(2)), data),
        judge=StaticJudge(["TRUE"]), embedder=HashingEmbedder(),
        tokenizer=ByteTokenizer(SPECIALS))
    adapted = {n[:-len(".lora_a")] for n, _ in model.named_parameters()
               if n.endswith(".lora_a")}
    mods = dict(model.named_modules())
    assert adapted and all(mods[n].kernel is None and mods[n].kernel_q is not None
                           for n in adapted)
    assert state.step == 1 and len(hist) == 1
    assert np.isfinite(hist[0]["loss"]) and np.isfinite(hist[0]["grad_norm"])
    assert all(torch.equal(p, base_before[n]) for n, p in model.named_parameters()
               if "lora" not in n)
