"""Training metrics logging: one JSON line per logged step.

Port of ``video_r2_tpu/utils/metrics_log.py`` without the optional
tensorboard writer: every logged step's metrics append to
``<output_dir>/metrics.jsonl``, and each GRPO rollout batch's prompts,
completions and rewards to ``completions.jsonl``.
"""

from __future__ import annotations

import json
import time
from pathlib import Path


class MetricsLogger:
    def __init__(self, output_dir: str | Path):
        self.dir = Path(output_dir)
        self.dir.mkdir(parents=True, exist_ok=True)
        self._f = open(self.dir / "metrics.jsonl", "a")

    def log(self, step: int, metrics: dict) -> None:
        row = {"step": step, "time": time.time()}
        for k, v in metrics.items():
            try:
                row[k] = float(v)
            except (TypeError, ValueError):
                row[k] = str(v)
        self._f.write(json.dumps(row) + "\n")
        self._f.flush()

    def log_completions(self, step: int, prompts: list[str],
                        completions: list[str], rewards: dict[str, list[float]]):
        """GRPO completion-table logging (rich/wandb table equivalent)."""
        with open(self.dir / "completions.jsonl", "a") as f:
            for i, (p, c) in enumerate(zip(prompts, completions)):
                f.write(json.dumps({
                    "step": step, "prompt": p[-500:], "completion": c,
                    **{k: v[i] for k, v in rewards.items()},
                }) + "\n")

    def close(self) -> None:
        self._f.close()
