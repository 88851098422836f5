"""Checkpoints of a training run: save, rotate, resume from the latest.

Port of the save/resume half of ``video_r2_tpu/train/checkpoint.py``:
``checkpoint-<step>/`` directories under the run's output directory (the
highest step resumes), keeping ``save_total_limit`` of them. Each holds
``state.pt``: the trained parameters (the adapters for LoRA), the optimizer
and schedule state, and the step, via ``torch.save``. The merged HF export
(``export_hf_checkpoint``) waits for the HF loader port (ROADMAP Queue 1 #9).
"""

from __future__ import annotations

import re
import shutil
from pathlib import Path

import torch

from .sft import TrainState


def _ckpt_dirs(root: Path) -> list[tuple[int, Path]]:
    out = []
    for p in root.glob("checkpoint-*"):
        m = re.fullmatch(r"checkpoint-(\d+)", p.name)
        if m and p.is_dir():
            out.append((int(m.group(1)), p))
    return sorted(out)


def latest_checkpoint(root: str | Path) -> Path | None:
    dirs = _ckpt_dirs(Path(root)) if Path(root).exists() else []
    return dirs[-1][1] if dirs else None


def save_checkpoint(root: str | Path, state: TrainState, step: int,
                    keep: int | None = 2) -> Path:
    """Write checkpoint-<step>/state.pt (through a temporary name, so a cut
    run never leaves a half-written checkpoint) and keep the newest `keep`."""
    root = Path(root)
    root.mkdir(parents=True, exist_ok=True)
    path = root / f"checkpoint-{step}"
    tmp = root / f".checkpoint-{step}.tmp"
    shutil.rmtree(tmp, ignore_errors=True)
    tmp.mkdir()
    torch.save({"params": {n: p.detach().cpu() for n, p in state.params.items()},
                "optimizer": state.optimizer.state_dict(),
                "step": state.step}, tmp / "state.pt")
    shutil.rmtree(path, ignore_errors=True)
    tmp.rename(path)
    if keep:
        for _, old in _ckpt_dirs(root)[:-keep]:
            shutil.rmtree(old, ignore_errors=True)
    return path


@torch.no_grad()
def load_checkpoint(path: str | Path, state: TrainState) -> TrainState:
    """Restore a checkpoint into `state` in place (same parameter names)."""
    saved = torch.load(Path(path) / "state.pt", map_location="cpu", weights_only=True)
    if saved["params"].keys() != state.params.keys():
        raise KeyError(f"{path}: the checkpoint trains other parameters")
    for name, p in state.params.items():
        p.copy_(saved["params"][name])
    state.optimizer.load_state_dict(saved["optimizer"])
    state.step = saved["step"]
    return state


def resume_or_none(root: str | Path, state: TrainState) -> tuple[TrainState, int] | None:
    last = latest_checkpoint(root)
    if last is None:
        return None
    state = load_checkpoint(last, state)
    return state, int(re.fullmatch(r"checkpoint-(\d+)", last.name).group(1))
