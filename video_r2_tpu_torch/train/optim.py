"""AdamW with per-component learning rates and per-group clipping.

Port of ``video_r2_tpu/train/optim.py``: six parameter groups, {decoder,
vision tower, merger} x {decay, no-decay}, with their own learning rates
(vision_lr, merger_lr) and a cosine schedule with linear warmup. Numerics
kept from the optax chain there:

- each group is clipped by its own global norm (``clip_by_global_norm``
  sits inside each ``multi_transform`` branch), not by one global norm;
- the schedule is read at the update count *before* the update, so with
  warmup the first update has lr 0 (``LambdaLR`` starts at its factor(0));
- AdamW's decoupled decay equals optax's ``-lr * (adam + wd * p)``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Iterable

import torch

GROUPS = ("base_decay", "base_nodecay", "vision_decay", "vision_nodecay",
          "merger_decay", "merger_nodecay")


@dataclass(frozen=True)
class OptimConfig:
    learning_rate: float = 1e-5
    vision_lr: float | None = 2e-6
    merger_lr: float | None = 1e-5
    weight_decay: float = 0.0
    warmup_ratio: float = 0.03
    total_steps: int = 1000
    schedule: str = "cosine"          # "cosine" | "constant"
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    max_grad_norm: float = 1.0
    # freeze flags (train_sft.sh:42-44 freeze_vision/freeze_llm/freeze_merger)
    freeze_vision: bool = False
    freeze_llm: bool = False
    freeze_merger: bool = False


def classify_param(name: str, param: torch.Tensor) -> str:
    """-> one of base/vision/merger x decay/nodecay (by parameter name)."""
    if name.startswith("visual.merger"):
        comp = "merger"
    elif name.startswith("visual"):
        comp = "vision"
    else:
        comp = "base"
    nodecay = param.ndim <= 1 or "scale" in name or "bias" in name
    return f"{comp}_{'nodecay' if nodecay else 'decay'}"


def schedule_factor(count: int, cfg: OptimConfig) -> float:
    """lr / peak lr at update `count` (0-based): optax's linear warmup from 0,
    then cosine decay to 0 over the remaining steps (or constant)."""
    warmup = max(int(cfg.total_steps * cfg.warmup_ratio), 0)
    if cfg.schedule == "constant":
        return 1.0 if warmup == 0 else min(count / warmup, 1.0)
    if count < warmup:
        return count / warmup
    decay = max(cfg.total_steps, warmup + 1) - warmup
    return 0.5 * (1.0 + math.cos(math.pi * min(count - warmup, decay) / decay))


def global_norm(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element, in fp32."""
    norms = [torch.linalg.vector_norm(t, dtype=torch.float32) for t in tensors]
    if not norms:
        return torch.zeros(())
    return torch.linalg.vector_norm(torch.stack(norms))


class GroupedAdamW:
    """torch.optim.AdamW over the six groups, each clipped by its own norm,
    with the schedule as a LambdaLR. Parameters of a frozen component
    (freeze_* flags) are left out: they never update."""

    def __init__(self, cfg: OptimConfig, named_params: Iterable[tuple[str, torch.Tensor]]):
        lrs = {"base": cfg.learning_rate,
               "vision": cfg.learning_rate if cfg.vision_lr is None else cfg.vision_lr,
               "merger": cfg.learning_rate if cfg.merger_lr is None else cfg.merger_lr}
        frozen = {c for c, f in (("vision", cfg.freeze_vision), ("base", cfg.freeze_llm),
                                 ("merger", cfg.freeze_merger)) if f}
        members: dict[str, list] = {g: [] for g in GROUPS}
        for name, p in named_params:
            label = classify_param(name, p)
            if label.split("_")[0] not in frozen:
                members[label].append(p)
        groups = []
        for label in GROUPS:
            comp, kind = label.split("_")
            if members[label]:
                groups.append({"params": members[label], "lr": lrs[comp], "name": label,
                               "weight_decay": cfg.weight_decay if kind == "decay" else 0.0})
        self.max_grad_norm = cfg.max_grad_norm
        self.optimizer = torch.optim.AdamW(groups, betas=(cfg.b1, cfg.b2), eps=cfg.eps)
        self.scheduler = torch.optim.lr_scheduler.LambdaLR(
            self.optimizer, lambda count: schedule_factor(count, cfg))

    def zero_grad(self) -> None:
        self.optimizer.zero_grad(set_to_none=True)

    @torch.no_grad()
    def step(self) -> None:
        """Clip each group by its own global norm, update, advance the
        schedule."""
        for group in self.optimizer.param_groups:
            grads = [p.grad for p in group["params"] if p.grad is not None]
            norm = global_norm(grads)
            if grads and norm >= self.max_grad_norm:
                for g in grads:
                    g.mul_(self.max_grad_norm / norm)
        self.optimizer.step()
        self.scheduler.step()

    def state_dict(self) -> dict:
        return {"optimizer": self.optimizer.state_dict(),
                "scheduler": self.scheduler.state_dict()}

    def load_state_dict(self, state: dict) -> None:
        self.optimizer.load_state_dict(state["optimizer"])
        self.scheduler.load_state_dict(state["scheduler"])
