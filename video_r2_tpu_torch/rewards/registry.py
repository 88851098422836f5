"""Reward function discovery by name: any `*_reward` function of
accuracy.py, format.py or temporal.py loads by name.

A copy of ``video_r2_tpu/rewards/registry.py`` (its package ``__init__``
imports jax); tests/test_torch_host.py holds every function and class
here equal to the original's source.
"""

from __future__ import annotations

import inspect
from typing import Callable


def _discover() -> dict[str, Callable]:
    from . import accuracy, format as format_mod, temporal

    funcs: dict[str, Callable] = {}
    for mod in (accuracy, format_mod, temporal):
        for name, obj in inspect.getmembers(mod, inspect.isfunction):
            if name.endswith("_reward"):
                funcs[name] = obj
    return funcs


def load_reward_funcs(names: list[str]) -> list[Callable]:
    available = _discover()
    out = []
    for name in names:
        key = name if name.endswith("_reward") else f"{name}_reward"
        if key not in available:
            raise ValueError(
                f"Unknown reward function {name!r}; available: "
                f"{sorted(available)}")
        out.append(available[key])
    return out
