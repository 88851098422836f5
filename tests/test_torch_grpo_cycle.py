"""LoRA-GRPO cycles of the port against the JAX package's, on the CPU.

Both packages' GRPORunner.train_cycle on the same tiny float32 base and
adapters (load_jax_params, load_jax_lora), the same two video prompts (4
frames each) and the same rewards: a deterministic row-parity reward and
format_reward, so the advantages are not all 0. GRPOConfig(top_k=1,
num_iterations=2) makes both packages' rollouts greedy, so they are
token-equal whatever their random number generators; the JAX side runs
attn_impl "xla" (its CPU route, the paged engine's Pallas kernel in
interpret mode), the port "flash" through its plain steps. Two cycles on
the "batch" and on the "paged" backend. Tolerances:

- completion ids, rewards, advantages, input_ids / position_ids /
  attention_mask / completion_mask: exactly equal;
- ref log-probs: rtol 1e-5, atol 1e-5 (float32 decoders, the softmax sums
  in another order);
- the adapters after each cycle: relative L2 3e-4 as one vector
  (measured 7.4e-5 and 9.8e-5); the last step's loss and KL: rtol 3e-3
  (measured 3e-4 and 1.1e-3 of values near 3e-4 and 5e-3). These are
  after Adam updates, which divide each gradient element by its own size:
  an element whose gradient is near Adam's eps moves by a share of lr that
  the two packages' float32 rounding sets apart (0.2 lr at most here).
- The adapters start with B != 0, so that the policy differs from its
  base, and the optimizer's eps is 1e-6: greedy rollouts make a group's G
  completions the same sequence and group-normalised advantages sum to 0
  over a group, so the policy term's gradient cancels to float32 noise
  (~1e-9), which Adam with eps 1e-8 would blow up to +-lr on every
  element; the KL term's gradient is real once the policy is not its
  base. The cycle-1 KL of B = 0 (exactly 0) is held by
  tests/test_torch_grpo.py's app test.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from video_r2_tpu.engine.chat import ByteTokenizer as JByteTokenizer
from video_r2_tpu.models.config import tiny_test_config as j_tiny
from video_r2_tpu.models.loader import init_params as j_init
from video_r2_tpu.rewards.format import format_reward as j_format_reward
from video_r2_tpu.train import grpo as jgrpo
from video_r2_tpu.train import grpo_runner as jrunner
from video_r2_tpu.train import lora as jlora
from video_r2_tpu.train.optim import OptimConfig as JOptimConfig
from video_r2_tpu.train.optim import make_optimizer as j_make_optimizer
from video_r2_tpu.video.api import VideoPreprocessConfig as JVideoPreprocessConfig
from video_r2_tpu_torch.engine.chat import ByteTokenizer
from video_r2_tpu_torch.models.config import tiny_test_config
from video_r2_tpu_torch.models.convert import flatten_jax_tree, load_jax_lora, load_jax_params
from video_r2_tpu_torch.models.loader import init_params
from video_r2_tpu_torch.rewards.format import format_reward
from video_r2_tpu_torch.train import grpo
from video_r2_tpu_torch.train.grpo_runner import GRPORunner
from video_r2_tpu_torch.train.lora import LoRAConfig, attach_lora, init_lora, make_lora_grpo_step
from video_r2_tpu_torch.train.optim import OptimConfig
from video_r2_tpu_torch.train.sft import init_train_state

SPECIALS = {"<|endoftext|>": 0, "<|im_start|>": 300, "<|im_end|>": 1,
            "<|vision_start|>": 502, "<|vision_end|>": 503,
            "<|image_pad|>": 500, "<|video_pad|>": 501}
LKW = dict(r=4, alpha=8)
OKW = dict(learning_rate=3e-3, total_steps=10, eps=1e-6)
BATCH_KEYS = ("input_ids", "position_ids", "attention_mask", "completion_mask",
              "advantages")


def parity_reward(completions, **kw):
    return [float(i % 2) for i in range(len(completions))]


def _samples(seed=0):
    rng = np.random.default_rng(seed)
    return [{"prompt": [
                {"role": "system", "content": "You are a helpful assistant."},
                {"role": "user", "content": [
                    {"type": "video", "video": rng.integers(0, 256, (4, 56, 84, 3), np.uint8),
                     "video_fps": 2.0, "min_pixels": 4 * 28 * 28, "max_pixels": 56 * 84},
                    {"type": "text", "text": q}]}],
             "assistant": "<answer>A</answer>", "temporal_grounding": {},
             "temporal_captions": {}}
            for q in ("What moves?", "Which way does it go, and why?")]


def _recorded(runner, out):
    """Keep every (batch, metrics) rollout_and_score returns."""
    orig = runner.rollout_and_score

    def wrapped(samples):
        res = orig(samples)
        out.append(res)
        return res

    runner.rollout_and_score = wrapped


def _adapters(named):
    return np.concatenate([np.asarray(v).ravel() for _, v in sorted(named.items())])


@pytest.mark.parametrize("backend", ["batch", "paged"])
def test_lora_grpo_cycles_match_jax(backend):
    gkw = dict(num_generations=2, beta=0.04, max_completion_length=6, max_prompt_length=256,
               logp_chunk_size=16, num_iterations=2, top_k=1, rollout_backend=backend)
    samples = _samples()

    # JAX: LoRA-GRPO as its app wires it (ref_params = the base)
    jparams = j_init(j_tiny(), seed=3)
    jlcfg = jlora.LoRAConfig(**LKW)
    jl = jax.tree_util.tree_map_with_path(   # B != 0: the policy is not its base
        lambda p, x: (jnp.asarray(np.random.default_rng(2).normal(size=x.shape), jnp.float32)
                      * 0.05 if p[-1].key == "b" else x),
        jlora.init_lora(jparams, jlcfg, seed=1))
    jg = jgrpo.GRPOConfig(**gkw)
    jopt = j_make_optimizer(JOptimConfig(**OKW), jl)
    jstep = jlora.make_lora_grpo_step(jparams, j_tiny(), jg, jlcfg, jopt, donate=False)
    jrun = jrunner.GRPORunner(
        jlora.attach_lora(jparams, jl, jlcfg), j_tiny(), jg, JByteTokenizer(SPECIALS),
        [parity_reward, j_format_reward], ["parity_reward", "format_reward"], jstep,
        ref_params=jparams, video_cfg=JVideoPreprocessConfig(cache_dir=None),
        params_from_state=lambda s: jlora.attach_lora(jparams, s.lora, jlcfg))
    jrec, jmetrics, jlora_after = [], [], []
    _recorded(jrun, jrec)
    jstate = jlora.LoRATrainState(jl, jopt.init(jl), jnp.zeros((), jnp.int32))
    for _ in range(2):
        jstate, m = jrun.train_cycle(jstate, samples)
        jmetrics.append(m)
        jlora_after.append(_adapters(flatten_jax_tree(jax.tree.map(np.asarray, jstate.lora))))

    # the port on the same base and adapters
    model = load_jax_params(init_params(tiny_test_config(), seed=0, device="cpu"),
                            jax.tree.map(np.asarray, jparams))
    lcfg = LoRAConfig(**LKW)
    params = attach_lora(model, init_lora(model, lcfg), lcfg)
    load_jax_lora(model, jax.tree.map(np.asarray, jl))
    gcfg = grpo.GRPOConfig(**gkw)
    state = init_train_state(params, OptimConfig(**OKW))
    step = make_lora_grpo_step(model, gcfg, attn_impl="flash")
    run = GRPORunner(model, gcfg, ByteTokenizer(SPECIALS), [parity_reward, format_reward],
                     ["parity_reward", "format_reward"], step, ref_model=model,
                     attn_impl="flash")
    rec, metrics = [], []
    _recorded(run, rec)
    for c in range(2):
        state, m = run.train_cycle(state, samples)
        metrics.append(m)
        # the JAX tree's names: <module>.kernel.{a, b}
        ours = _adapters({n.replace(".lora_a", ".kernel.a").replace(".lora_b", ".kernel.b"):
                          p.detach().numpy() for n, p in params.items()})
        assert np.linalg.norm(ours - jlora_after[c]) <= 3e-4 * np.linalg.norm(jlora_after[c])

    assert state.step == 4 and int(jstate.step) == 4
    for c in range(2):
        (batch, bm), (jbatch, jbm) = rec[c], jrec[c]
        for k in BATCH_KEYS:
            np.testing.assert_array_equal(batch[k].numpy(), np.asarray(jbatch[k]), err_msg=k)
        for k in ("reward_mean", "reward_std", "rewards/parity_reward/mean",
                  "rewards/format_reward/mean", "completion_len_mean", "clipped_ratio"):
            assert bm[k] == jbm[k], k
        np.testing.assert_allclose(batch["ref_per_token_logps"].numpy(),
                                   np.asarray(jbatch["ref_per_token_logps"]),
                                   rtol=1e-5, atol=1e-5)
        for k in ("loss", "kl", "clip_ratio/region"):
            np.testing.assert_allclose(metrics[c][k], jmetrics[c][k], rtol=3e-3, atol=1e-7,
                                       err_msg=k)
        assert {"profiling/rollout_generate_s", "profiling/optimize_s",
                "profiling/reward/parity_reward_s"} <= metrics[c].keys()
    assert not np.all(rec[0][0]["advantages"].numpy() == 0)
    assert metrics[0]["kl"] > 0 and metrics[1]["kl"] > 0
