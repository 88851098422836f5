"""Format reward: full-match <think>...</think><answer>...</answer>.

A copy of ``video_r2_tpu/rewards/format.py`` (its package ``__init__``
imports jax); tests/test_torch_host.py holds every function and class
here equal to the original's source.
"""

from __future__ import annotations

import re

_PATTERN = re.compile(r"<think>.*?</think>\s*<answer>.*?</answer>", re.DOTALL)


def format_reward(completions, **kwargs) -> list[float]:
    contents = [c[0]["content"] for c in completions]
    return [1.0 if _PATTERN.fullmatch(c) else 0.0 for c in contents]
