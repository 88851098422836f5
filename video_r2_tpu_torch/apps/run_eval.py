"""Accuracy eval entry point (eval/scripts/accuracy/run_all.sh parity).

Port of ``video_r2_tpu/apps/run_eval.py``. Usage (the card; seeded random
weights until the HF loader is ported):
  python -m video_r2_tpu_torch.apps.run_eval --run.model_preset qwen25vl-7b \\
      --tasks mvbench_think,videomme_think --docs path/to/docs.json \\
      --limit 8 --run.output_dir out/ --eval.engine_mode paged

`main` builds the model on the card (it raises where there is none) and
calls `run_eval`, which takes the parsed arguments and a model already
built, on any device (the CPU tests hand it one). `--eval.spec_decode K`
decodes speculatively (K n-gram drafts a verify round). `--run.checkpoint`,
`--run.tokenizer` and a mesh (`--run.tp` etc. past one device) raise until
their ports land (ROADMAP Queue 1).
"""

from __future__ import annotations

import sys

from ..config import AppConfig, parse_config, resolve_attn_impl
from ..evalharness import EngineModel, evaluate, get_task
from .common import (
    build_mesh,
    build_model,
    build_tokenizer,
    logger,
    setup_logging,
)


def parse_args(argv=None) -> tuple[AppConfig, str, str | None, int | None]:
    """(app config, task names, docs path, limit): --tasks / --docs /
    --limit, the rest --section.field flags."""
    argv = list(sys.argv[1:] if argv is None else argv)
    tasks_arg, docs_arg, limit = "mvbench_think", None, None
    rest = []
    i = 0
    while i < len(argv):
        if argv[i] == "--tasks":
            tasks_arg = argv[i + 1]
            i += 2
        elif argv[i] == "--docs":
            docs_arg = argv[i + 1]
            i += 2
        elif argv[i] == "--limit":
            limit = int(argv[i + 1])
            i += 2
        else:
            rest.append(argv[i])
            i += 1
    return parse_config(rest), tasks_arg, docs_arg, limit


def run_eval(app: AppConfig, model, tok, tasks_arg: str, docs_arg: str | None = None,
             limit: int | None = None) -> dict:
    """Evaluate `model` (built, on its device) over the named tasks; writes
    ``samples_<task>.jsonl`` and ``results.json`` under run.output_dir, with
    a resumable response cache under ``<output_dir>/cache``."""
    tasks = [get_task(name, dataset_path=docs_arg)
             for name in tasks_arg.split(",")]
    ev = app.eval
    eval_model = EngineModel(
        model, tok, attn_impl=resolve_attn_impl(app.run, model.device),
        max_num_frames=ev.max_num_frames, max_pixels=ev.max_pixels,
        min_pixels=ev.min_pixels, fps=ev.fps or None,
        batch_size=ev.batch_size, system_prompt=ev.system_prompt,
        engine_mode=ev.engine_mode,
        engine_max_len=ev.engine_max_len or None,
        act_quant=ev.act_quant or None, kv_quant=ev.kv_quant or None,
        vit_act_quant=ev.vit_act_quant or None,
        window_divisible=ev.window_divisible, decode_steps=ev.decode_steps,
        patch_dtype=ev.patch_dtype, spec_decode=ev.spec_decode,
        mesh=build_mesh(app))
    out = evaluate(eval_model, tasks, limit=limit, output_dir=app.run.output_dir,
                   cache_dir=f"{app.run.output_dir}/cache")  # resumable
    for name, res in out["results"].items():
        logger.info("%s: %s", name, res)
    return out


def main(argv=None):
    setup_logging()
    app, tasks_arg, docs_arg, limit = parse_args(argv)
    build_mesh(app)
    model = build_model(app)
    return run_eval(app, model, build_tokenizer(app), tasks_arg, docs_arg, limit)


if __name__ == "__main__":
    main()
