"""Harness orchestrator: build instances -> generate -> filter ->
process_results -> aggregate (+bootstrap stderr) -> persist.

A copy of ``video_r2_tpu/evalharness/runner.py``; tests/test_torch_eval.py holds
the two equal.

Parity surface: eval/lmms-eval/lmms_eval/evaluator.py:315-684 (single
controller — rank sharding/padding/barriers are unnecessary on the JAX
single-controller model) and loggers/evaluation_tracker.py (per-sample JSONL
contract: doc_id, doc, input, resps, filtered_resps, target, metric fields,
doc_hash — what TAC/VAS consume).
"""

from __future__ import annotations

import json
import os
import time
from pathlib import Path
from typing import Any

from .api import Instance, Task, bootstrap_stderr, doc_hash
from .model_api import LMM


class CacheHook:
    """Incremental response persistence: the runner installs this on the
    model as `model.cache_hook`; backends call `add_partial` after each
    engine batch so a crash at sample N-1 of a multi-hour task replays only
    the un-flushed tail, not the whole task (reference: api/model.py
    CacheHook + caching/cache.py:25-59 cache per request)."""

    def __init__(self, path: Path):
        self.path = Path(path)
        self.flushed: set[str] = set()

    def add_partial(self, instances: list[Instance], resps: list[str]) -> None:
        self.path.parent.mkdir(parents=True, exist_ok=True)
        with open(self.path, "a") as f:
            for inst, resp in zip(instances, resps):
                h = doc_hash(_jsonable(inst.doc))
                if h in self.flushed:
                    continue
                self.flushed.add(h)
                f.write(json.dumps({"doc_hash": h, "resp": resp}) + "\n")


def evaluate(
    model: LMM,
    tasks: list[Task],
    limit: int | None = None,
    output_dir: str | Path | None = None,
    log_samples: bool = True,
    cache_dir: str | Path | None = None,
) -> dict[str, Any]:
    """Returns {"results": {task: {metric: value, metric_stderr: ...}},
    "samples": {task: [rows]}}.

    `cache_dir` makes eval resumable: responses are persisted per doc hash and
    reused on re-runs (the reference's LM_HARNESS_CACHE_PATH request cache +
    sqlitedict CacheHook, SURVEY §4)."""
    results: dict[str, Any] = {"results": {}, "samples": {}, "configs": {}}
    for task in tasks:
        cfg = task.config
        instances = task.build_instances(limit=limit)

        cache: dict[str, str] = {}
        cache_path = None
        if cache_dir is not None:
            cache_path = Path(cache_dir) / f"cache_{cfg.task}.jsonl"
            if cache_path.exists():
                for line in open(cache_path):
                    if line.strip():
                        row = json.loads(line)
                        cache[row["doc_hash"]] = row["resp"]

        hashes = [doc_hash(_jsonable(i.doc)) for i in instances]
        missing = [i for i, h in zip(instances, hashes) if h not in cache]
        t0 = time.time()
        if missing:
            hook = CacheHook(cache_path) if cache_path is not None else None
            if hook is not None:
                hook.flushed.update(cache)  # pre-cached rows never re-append
            model.cache_hook = hook
            try:
                # dispatch by the task's output type (evaluator.py:475
                # getattr(lm, reqtype) parity)
                if cfg.output_type == "loglikelihood":
                    conts = [str(cfg.doc_to_target(i.doc)) for i in missing]
                    new_resps = [list(r) for r in
                                 model.loglikelihood(missing, conts)]
                else:
                    new_resps = model.generate_until(missing)
            finally:
                model.cache_hook = None
            for inst, resp in zip(missing, new_resps):
                h = doc_hash(_jsonable(inst.doc))
                cache[h] = resp
            if hook is not None:
                # flush whatever the backend didn't already stream out
                # (models without cache_hook support flush everything here)
                hook.add_partial(missing, new_resps)
        resps = [cache[h] for h in hashes]
        elapsed = time.time() - t0

        rows = []
        metric_values: dict[str, list] = {m.name: [] for m in cfg.metrics}
        for inst, resp in zip(instances, resps):
            filtered = (cfg.filter_fn(resp)
                        if cfg.filter_fn and cfg.output_type == "generate_until"
                        else resp)
            scores = cfg.process_results(inst.doc, [filtered])
            for name, val in scores.items():
                if name in metric_values:
                    metric_values[name].append(val)
            rows.append({
                "doc_id": inst.doc_id,
                "doc": _jsonable(inst.doc),
                "input": inst.text,
                "resps": [[resp]],
                "filtered_resps": [filtered],
                "target": str(cfg.doc_to_target(inst.doc)),
                "doc_hash": doc_hash(_jsonable(inst.doc)),
                **{k: _jsonable(v) for k, v in scores.items()},
            })

        agg = {}
        for m in cfg.metrics:
            vals = metric_values[m.name]
            numeric = [v for v in vals if isinstance(v, (int, float, bool))]
            if numeric and len(numeric) == len(vals):
                agg[m.name] = m.aggregation(vals)
                agg[f"{m.name}_stderr"] = bootstrap_stderr(
                    [float(v) for v in vals])
            else:
                agg[m.name] = m.aggregation(vals)
        agg["samples"] = len(rows)
        agg["time_s"] = round(elapsed, 2)
        results["results"][cfg.task] = agg
        results["samples"][cfg.task] = rows
        results["configs"][cfg.task] = {
            "task": cfg.task, "post_prompt": cfg.post_prompt,
            "generation_kwargs": cfg.generation_kwargs,
        }

        if output_dir is not None and log_samples:
            outdir = Path(output_dir)
            outdir.mkdir(parents=True, exist_ok=True)
            with open(outdir / f"samples_{cfg.task}.jsonl", "w") as f:
                for row in rows:
                    f.write(json.dumps(row, default=str) + "\n")

    if output_dir is not None:
        with open(Path(output_dir) / "results.json", "w") as f:
            json.dump({"results": results["results"],
                       "configs": results["configs"]}, f, indent=2,
                      default=str)
    return results


def _jsonable(x):
    try:
        json.dumps(x)
        return x
    except (TypeError, ValueError):
        if isinstance(x, dict):
            return {k: _jsonable(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return [_jsonable(v) for v in x]
        return str(x)
