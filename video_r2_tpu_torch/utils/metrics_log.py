"""Training metrics logging: one JSON line per logged step.

Port of ``video_r2_tpu/utils/metrics_log.py`` without the optional
tensorboard writer and the GRPO completion log: every logged step's metrics
append to ``<output_dir>/metrics.jsonl``.
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

    def close(self) -> None:
        self._f.close()
