"""GRPO training entry point (port of ``video_r2_tpu/apps/train_grpo.py``).

Usage (the card; weights seeded at random until the HF loader is ported):
  python -m video_r2_tpu_torch.apps.train_grpo --data.data_path grpo.json \\
      --run.use_lora true --grpo.num_generations 8 --grpo.beta 0.04 \\
      --grpo.reward_weights 1,1,1 --grpo.rollout_backend paged \\
      --run.max_steps 500 --run.output_dir out/

The dataset's records hold a video file or decoded uint8 frames under
``"video"`` (data/grpo.py; image records raise). `main`
builds the model, the byte tokenizer and the dataset from the config;
`train` is the loop, for any model and dataset (chip_smoke.py hands it the
7B and an in-memory dataset). With ``run.use_lora`` only the adapters train
(over an int8 base, QLoRA, they are shaped by init_lora_for_quantized) and
the reference policy is the same module with its adapters removed;
otherwise every parameter trains and the reference is a frozen copy. The
loss and the rollouts run ``run.attn_impl`` ("auto": the flash kernels on a
CUDA device). Each cycle's metrics go to the log and to
``<output_dir>/metrics.jsonl``, its completions to ``completions.jsonl``;
``checkpoint-<cycle>/`` every ``run.save_steps`` and at the end, and a run
resumes from the latest one. The judge defaults to OpenAICompatClient (an
OpenAI-compatible server at $OPENAI_API_BASE). The merged HF export waits
for the HF loader port (ROADMAP Queue 1 #9).
"""

from __future__ import annotations

import copy
import logging
import time

import numpy as np

from ..config import AppConfig, parse_config, resolve_attn_impl
from ..data.grpo import GRPODataset
from ..engine.chat import ByteTokenizer
from ..models.model import Qwen25VL
from ..rewards.embedding import load_embedder
from ..rewards.judge import OpenAICompatClient
from ..rewards.registry import load_reward_funcs
from ..train.checkpoint import resume_or_none, save_checkpoint
from ..train.grpo import make_grpo_step
from ..train.grpo_runner import GRPORunner
from ..train.lora import (
    attach_lora,
    init_lora,
    init_lora_for_quantized,
    lora_param_count,
    make_lora_grpo_step,
    target_modules,
)
from ..train.sft import TrainState, init_train_state
from ..utils.metrics_log import MetricsLogger
from .common import build_mesh, build_model, build_tokenizer

logger = logging.getLogger("video_r2_tpu_torch.train_grpo")

DEFAULT_REWARDS = ("accuracy_reward", "format_reward",
                   "temporal_grounding_sentence_embedding_consistency_reward")


def train(app: AppConfig, model: Qwen25VL, dataset, batch_size: int = 1,
          reward_names=DEFAULT_REWARDS, judge=None, embedder=None,
          tokenizer=None) -> tuple[TrainState, list[dict]]:
    """Train `model` in place for app.run.max_steps GRPO cycles of
    `batch_size` prompts (from the latest checkpoint when app.run.resume).
    Returns the state and one metrics record per cycle (with "cycle" and
    "s_per_cycle")."""
    run, gcfg = app.run, app.grpo
    if not run.use_lora and any(getattr(m, "kernel_q", None) is not None
                                or getattr(m, "kernel_q4", None) is not None
                                for m in model.modules()):
        raise NotImplementedError("full-parameter GRPO over a quantized base "
                                  "(run.use_lora=False on int8 / int4 weights) is not "
                                  "ported: quantized weights take no gradient (int8 "
                                  "runs QLoRA with run.use_lora=True)")
    impl = resolve_attn_impl(run, model.device)
    reward_names = list(reward_names)
    reward_funcs = load_reward_funcs(reward_names)
    judge = judge or OpenAICompatClient()
    embedder = embedder or load_embedder()
    tok = tokenizer or ByteTokenizer()
    if run.use_lora:
        # LoRA-GRPO: adapters train over the frozen base (int8: QLoRA); the
        # reference policy is the base with the adapters removed for its
        # pass, as the reference's PEFT disable_adapter trick
        quantized = any(m.kernel_q is not None
                        for m in target_modules(model, app.lora).values())
        init = init_lora_for_quantized if quantized else init_lora
        params = attach_lora(model, init(model, app.lora, seed=run.seed), app.lora)
        step = make_lora_grpo_step(model, gcfg, attn_impl=impl)
        ref_model = model if gcfg.beta != 0 else None
        logger.info("LoRA-GRPO: r=%d alpha=%d (%d adapter params%s)", app.lora.r,
                    app.lora.alpha, lora_param_count(params),
                    ", int8 base" if quantized else "")
    else:
        # the reference policy is a real, frozen copy taken before training
        ref_model = (copy.deepcopy(model).requires_grad_(False)
                     if gcfg.beta != 0 else None)
        model.requires_grad_(True)
        params = dict(model.named_parameters())
        step = make_grpo_step(model, gcfg, attn_impl=impl)
    state = init_train_state(params, app.optim)
    start = 0
    if run.resume:
        resumed = resume_or_none(run.output_dir, state)
        if resumed is not None:
            state, start = resumed
            logger.info("resumed from cycle %d", start)

    mlog = MetricsLogger(run.output_dir)
    runner = GRPORunner(model, gcfg, tok, reward_funcs, reward_names, step,
                        ref_model=ref_model, judge=judge, embedder=embedder,
                        attn_impl=impl, seed=run.seed, metrics_logger=mlog)
    rng = np.random.default_rng(run.seed)
    history: list[dict] = []
    try:
        for cycle in range(start, run.max_steps):
            idx = rng.choice(len(dataset), size=batch_size, replace=False)
            samples = [dataset[int(i)] for i in idx]
            t0 = time.perf_counter()
            state, metrics = runner.train_cycle(state, samples)
            metrics.update(cycle=cycle + 1, s_per_cycle=time.perf_counter() - t0)
            history.append(metrics)
            logger.info("cycle %d loss %.4f reward %.3f kl %.5f len %.1f (%.1fs)",
                        cycle + 1, metrics.get("loss", float("nan")),
                        metrics["reward_mean"], metrics.get("kl", 0.0),
                        metrics["completion_len_mean"], metrics["s_per_cycle"])
            mlog.log(cycle + 1, metrics)
            if (cycle + 1) % run.save_steps == 0:
                save_checkpoint(run.output_dir, state, cycle + 1,
                                keep=run.save_total_limit)
    finally:
        mlog.close()
    save_checkpoint(run.output_dir, state, run.max_steps, keep=run.save_total_limit)
    if run.use_lora:
        logger.info("the merged HF export waits for the HF loader port "
                    "(ROADMAP Queue 1 #9); train/lora.py::merge_lora merges in memory")
    return state, history


def main(argv=None, app: AppConfig | None = None, batch_size: int = 1,
         reward_names=DEFAULT_REWARDS, judge=None, embedder=None) -> TrainState:
    """The entry point: seeded random weights on the card, the
    ByteTokenizer, the dataset of ``data.data_path``, then `train`."""
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(levelname)s %(message)s")
    app = app or parse_config(argv)
    if app.run.weight_quant == "int4":
        raise NotImplementedError("run.weight_quant='int4': LoRA over int4 weights is "
                                  "not ported (int8 runs QLoRA)")
    build_mesh(app)
    model = build_model(app)     # weight_quant "int8": QLoRA in `train`
    dataset = GRPODataset(app.data.data_path, app.data)
    state, _ = train(app, model, dataset, batch_size, reward_names, judge, embedder,
                     tokenizer=build_tokenizer(app))
    return state


if __name__ == "__main__":
    main()
