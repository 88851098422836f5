"""Eval harness core types.

A copy of ``video_r2_tpu/evalharness/api.py``; tests/test_torch_eval.py holds
the two equal.

A compact, typed re-design of the vendored lmms-eval fork's task system
(eval/lmms-eval/lmms_eval/api/task.py — 1637 lines of YAML-driven config):
tasks are plain Python objects registered in code, docs come from local JSON /
HF datasets, and the per-sample output contract (doc/input/resps/
filtered_resps + metric fields) matches the reference so TAC/VAS tooling
consumes our logs unchanged (SURVEY §5 'load-bearing contract').
"""

from __future__ import annotations

import hashlib
import json
import random
from dataclasses import dataclass, field
from typing import Any, Callable, Iterable

# Exact think-mode post-prompt from the *_think task YAMLs
# (e.g. mvbench_think/mvbench_action_count.yaml:8).
THINK_POST_PROMPT = (
    "\nPlease think about this question as if you were a human pondering "
    "deeply. Engage in an internal dialogue using expressions such as 'let me "
    "think', 'wait', 'Hmm', 'oh, I see', 'let's break it down', etc, or other "
    "natural language thought expressions. It's encouraged to include "
    "self-reflection or verification in the reasoning process. Provide your "
    "detailed reasoning between the <think> and </think> tags, and then give "
    "your final answer between the <answer> and </answer> tags."
)


@dataclass
class MetricSpec:
    name: str
    aggregation: Callable[[list], float]
    higher_is_better: bool = True


def mean(xs: list) -> float:
    return float(sum(xs) / max(len(xs), 1))


@dataclass
class TaskConfig:
    task: str
    doc_to_visual: Callable[[dict], list]          # -> list of video paths/arrays
    doc_to_text: Callable[[dict], str]
    doc_to_target: Callable[[dict], str]
    process_results: Callable[[dict, list[str]], dict[str, Any]]
    metrics: list[MetricSpec]
    generation_kwargs: dict = field(default_factory=lambda: {
        "max_new_tokens": 1024, "temperature": 0.0, "do_sample": False})
    post_prompt: str = ""
    dataset_path: str | None = None                # HF dataset or local json
    dataset_name: str | None = None
    test_split: str = "test"
    filter_fn: Callable[[str], str] | None = None  # resps -> filtered_resps
    # "generate_until" (default) or "loglikelihood" — the model method the
    # runner dispatches to (evaluator.py:475 getattr(lm, reqtype) parity).
    # loglikelihood tasks score doc_to_target as the continuation and their
    # process_results receives [(ll, is_greedy)] instead of [text].
    output_type: str = "generate_until"


@dataclass
class Instance:
    doc_id: int
    doc: dict
    text: str
    visuals: list
    gen_kwargs: dict


class Task:
    def __init__(self, config: TaskConfig, docs: Iterable[dict] | None = None):
        self.config = config
        self._docs = list(docs) if docs is not None else None

    @property
    def docs(self) -> list[dict]:
        if self._docs is None:
            self._docs = load_docs(self.config)
        return self._docs

    def build_instances(self, limit: int | None = None) -> list[Instance]:
        docs = self.docs
        if limit is not None:
            docs = docs[:limit]
        out = []
        for i, doc in enumerate(docs):
            text = self.config.doc_to_text(doc) + self.config.post_prompt
            out.append(Instance(i, doc, text, self.config.doc_to_visual(doc),
                                dict(self.config.generation_kwargs)))
        return out


def load_docs(cfg: TaskConfig) -> list[dict]:
    """Local JSON/JSONL path, a `datasets.save_to_disk` directory, else an
    HF hub dataset (dataset_path/name/split — the lmms-eval task.py:673
    machinery; hub access requires egress)."""
    import os

    p = cfg.dataset_path
    if p is None:
        raise ValueError(f"task {cfg.task}: no dataset_path and no docs given")
    if p.endswith(".json"):
        return json.load(open(p))
    if p.endswith(".jsonl"):
        return [json.loads(l) for l in open(p) if l.strip()]
    import datasets

    if os.path.isdir(p) and (
            os.path.exists(os.path.join(p, "dataset_info.json"))
            or os.path.exists(os.path.join(p, "dataset_dict.json"))):
        ds = datasets.load_from_disk(p)  # offline snapshot
        if isinstance(ds, datasets.DatasetDict):
            ds = ds[cfg.test_split]
        return list(ds)
    ds = datasets.load_dataset(p, cfg.dataset_name, split=cfg.test_split)
    return list(ds)


def doc_hash(doc: dict) -> str:
    return hashlib.sha256(
        json.dumps(doc, sort_keys=True, default=str).encode()).hexdigest()


def bootstrap_stderr(values: list[float], iters: int = 1000,
                     seed: int = 1234) -> float:
    """Bootstrap standard error of the mean (api/metrics.py:505-550 parity)."""
    if len(values) < 2:
        return 0.0
    rng = random.Random(seed)
    n = len(values)
    means = []
    for _ in range(iters):
        sample = [values[rng.randrange(n)] for _ in range(n)]
        means.append(sum(sample) / n)
    mu = sum(means) / iters
    var = sum((m - mu) ** 2 for m in means) / (iters - 1)
    return var ** 0.5
