"""A copy of ``video_r2_tpu/evalharness/regression.py``; tests/test_torch_eval.py holds
the two equal.

Regression comparison of eval runs (tools/regression.py parity, minus the
git-branch checkout orchestration — results.json pairs are compared directly)."""

from __future__ import annotations

import json
from pathlib import Path


def compare_results(baseline_path: str | Path, candidate_path: str | Path,
                    rel_tolerance: float = 0.0) -> dict:
    """Diff two harness results.json files. Returns per-task/metric deltas and
    a `regressions` list of metrics that moved against higher_is_better
    (accuracy-style metrics assumed higher-better)."""
    base = json.load(open(baseline_path))["results"]
    cand = json.load(open(candidate_path))["results"]
    report: dict = {"tasks": {}, "regressions": [], "missing_tasks": []}
    for task, bmetrics in base.items():
        if task not in cand:
            report["missing_tasks"].append(task)
            continue
        deltas = {}
        for metric, bval in bmetrics.items():
            if metric.endswith("_stderr") or metric in ("samples", "time_s"):
                continue
            cval = cand[task].get(metric)
            if not isinstance(bval, (int, float)) or not isinstance(
                    cval, (int, float)):
                continue
            delta = cval - bval
            deltas[metric] = {"baseline": bval, "candidate": cval,
                              "delta": delta}
            threshold = abs(bval) * rel_tolerance
            if delta < -threshold:
                report["regressions"].append(
                    {"task": task, "metric": metric, "delta": delta})
        report["tasks"][task] = deltas
    return report
