"""Task registry (tasks/__init__.py TaskManager parity, code-first).

A copy of ``video_r2_tpu/evalharness/tasks/__init__.py``; tests/test_torch_eval.py holds
the two equal.
"""

from __future__ import annotations

from typing import Callable

_REGISTRY: dict[str, Callable] = {}


def register_task(name: str, builder: Callable) -> None:
    _REGISTRY[name] = builder


def get_task(name: str, docs=None, dataset_path=None):
    if name not in _REGISTRY:
        raise KeyError(f"unknown task {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name](docs=docs, dataset_path=dataset_path)


def list_tasks() -> list[str]:
    return sorted(_REGISTRY)


from . import benchmarks  # noqa: E402,F401  (registers the 11 benchmarks)
from . import tempcompass  # noqa: E402,F401  (task-type variants)
