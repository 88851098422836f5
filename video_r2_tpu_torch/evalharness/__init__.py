"""Eval harness of the PyTorch port (port of ``video_r2_tpu/evalharness``):
the same exports. Everything but engine_backend.py is a copy of the JAX
package's jax-free modules; the backend runs the port's engines."""

from .api import (
    Instance,
    MetricSpec,
    Task,
    TaskConfig,
    THINK_POST_PROMPT,
    bootstrap_stderr,
    mean,
)
from .model_api import EngineModel, FromLogModel, LMM, StaticModel
from .runner import evaluate
from .tasks import get_task, list_tasks, register_task

__all__ = [
    "Instance", "MetricSpec", "Task", "TaskConfig", "THINK_POST_PROMPT",
    "bootstrap_stderr", "mean",
    "EngineModel", "FromLogModel", "LMM", "StaticModel",
    "evaluate",
    "get_task", "list_tasks", "register_task",
]
