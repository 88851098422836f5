"""SFT training entry point (port of ``video_r2_tpu/apps/train_sft.py``).

Usage (the card; weights seeded at random until the HF loader is ported):
  python -m video_r2_tpu_torch.apps.train_sft --data.data_path data.json \\
      --run.use_lora true --run.max_steps 1000 --run.output_dir out/

`main` builds the model and dataset from the config; `train` is the loop,
for any model and dataset (chip_smoke.py hands it an in-memory dataset of
decoded frames). With ``run.use_lora`` only the adapters train (LoRA r/alpha
from ``--lora.*``, the base frozen: the reference's shipped recipe);
otherwise every parameter does. Each step's loss, grad_norm and seconds go
to the log every ``run.log_steps`` and to ``<output_dir>/metrics.jsonl``;
``checkpoint-<step>/`` every ``run.save_steps`` and at the end, and a run
resumes from the latest one. The merged HF export waits for the HF loader
port (ROADMAP Queue 1 #9).
"""

from __future__ import annotations

import dataclasses
import logging
import time

import numpy as np
import torch

from ..config import AppConfig, parse_config, resolve_attn_impl
from ..data.sft import SFTCollator, SFTDataset
from ..models.model import Qwen25VL
from ..train.checkpoint import resume_or_none, save_checkpoint
from ..train.lora import attach_lora, init_lora, lora_param_count
from ..train.sft import TrainState, init_train_state, make_lora_sft_step, make_sft_step
from ..utils.metrics_log import MetricsLogger
from .common import build_mesh, build_model, build_tokenizer

logger = logging.getLogger("video_r2_tpu_torch.train_sft")


def data_iterator(dataset, collator, batch_size: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    order = rng.permutation(len(dataset))
    i = 0
    while True:
        if i + batch_size > len(order):
            order = rng.permutation(len(dataset))
            i = 0
        yield collator([dataset[int(j)] for j in order[i: i + batch_size]])
        i += batch_size


def train(app: AppConfig, model: Qwen25VL, dataset,
          batch_size: int) -> tuple[TrainState, list[dict]]:
    """Train `model` in place on `dataset` for app.run.max_steps steps (from
    the latest checkpoint when app.run.resume). Returns the state and one
    record per step taken: step, loss, grad_norm, s_per_step (host clock
    around the step, which ends when the loss is read) and tokens (valid
    tokens in the batch)."""
    run = app.run
    collator = SFTCollator(model.cfg, app.data)
    it = data_iterator(dataset, collator, batch_size, run.seed)
    optim_cfg = dataclasses.replace(app.optim, total_steps=run.max_steps)
    if run.use_lora:
        params = attach_lora(model, init_lora(model, app.lora, seed=run.seed), app.lora)
        logger.info("LoRA: r=%d alpha=%d (%d adapter params; base frozen)",
                    app.lora.r, app.lora.alpha, lora_param_count(params))
    else:
        model.requires_grad_(True)
        params = dict(model.named_parameters())
    state = init_train_state(params, optim_cfg)

    start_step = 0
    if run.resume:
        resumed = resume_or_none(run.output_dir, state)
        if resumed is not None:
            state, start_step = resumed
            logger.info("resumed from step %d", start_step)

    sft_cfg = dataclasses.replace(app.sft,
                                  attn_impl=resolve_attn_impl(run, model.device))
    make_step = make_lora_sft_step if run.use_lora else make_sft_step
    step_cache = {}
    history: list[dict] = []
    mlog = MetricsLogger(run.output_dir)
    try:
        for step_no in range(start_step, run.max_steps):
            batch = next(it)
            tensors = {k: torch.as_tensor(v, device=model.device)
                       for k, v in batch.arrays.items()}
            layout_key = (batch.video_layout.s_pad if batch.video_layout else 0,
                          tensors["input_ids"].shape)
            if layout_key not in step_cache:
                step_cache[layout_key] = make_step(model, sft_cfg, batch.video_layout)
            t0 = time.perf_counter()
            state, metrics = step_cache[layout_key](state, tensors)
            metrics = {k: float(v) for k, v in metrics.items()}
            record = {"step": step_no + 1, **metrics,
                      "s_per_step": time.perf_counter() - t0,
                      "tokens": int(batch.arrays["attention_mask"].sum())}
            history.append(record)
            if (step_no + 1) % run.log_steps == 0:
                logger.info("step %d loss %.4f grad_norm %.3f (%.2f s/step)",
                            step_no + 1, record["loss"], record["grad_norm"],
                            record["s_per_step"])
                mlog.log(step_no + 1, record)
            if (step_no + 1) % run.save_steps == 0:
                save_checkpoint(run.output_dir, state, step_no + 1,
                                keep=run.save_total_limit)
                logger.info("saved checkpoint-%d", step_no + 1)
    finally:
        mlog.close()
    save_checkpoint(run.output_dir, state, run.max_steps, keep=run.save_total_limit)
    return state, history


def main(argv=None, app: AppConfig | None = None,
         batch_size: int = 4) -> TrainState:
    """The entry point: seeded random weights on the card, the
    ByteTokenizer, then `train`."""
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(levelname)s %(message)s")
    app = app or parse_config(argv)
    if app.run.weight_quant:
        raise NotImplementedError("run.weight_quant: SFT over a quantized base is "
                                  "not ported (QLoRA runs in apps/train_grpo.py)")
    build_mesh(app)
    model = build_model(app)
    dataset = SFTDataset(app.data.data_path, build_tokenizer(app), model.cfg, app.data)
    state, _ = train(app, model, dataset, batch_size)
    return state


if __name__ == "__main__":
    main()
