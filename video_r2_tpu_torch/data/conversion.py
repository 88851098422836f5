"""LLaVA-format conversation conversion.

Parity: train/src/dataset/data_utils.py:16-39 (SFT keeps media placeholders as
vision-start/pad/end) and grpo_dataset.py:15-32 (GRPO deletes them — media is
passed structurally).

A copy of ``video_r2_tpu/data/conversion.py`` (that package's ``__init__``
imports jax); tests/test_torch_host.py holds the two equal.
"""

from __future__ import annotations

import re

from .constants import (
    IMAGE_PAD,
    LLAVA_IMAGE_TOKEN,
    LLAVA_VIDEO_TOKEN,
    VIDEO_PAD,
    VISION_END,
    VISION_START,
)

_ROLE_MAP = {"human": "user", "assistant": "assistant", "gpt": "assistant"}


def replace_media_tokens(text: str, is_video: bool = False) -> str:
    """<image>/<video> -> <|vision_start|><|*_pad|><|vision_end|>."""
    token = LLAVA_VIDEO_TOKEN if is_video else LLAVA_IMAGE_TOKEN
    pad = VIDEO_PAD if is_video else IMAGE_PAD
    pattern = r"\n?" + re.escape(token) + r"\n?"
    return re.sub(pattern, f"{VISION_START}{pad}{VISION_END}", text)


def strip_media_tokens(text: str, is_video: bool = False) -> str:
    """Delete the placeholder entirely (GRPO path)."""
    token = LLAVA_VIDEO_TOKEN if is_video else LLAVA_IMAGE_TOKEN
    return re.sub(r"\n?" + re.escape(token) + r"\n?", "", text)


def llava_to_openai(conversations: list[dict], is_video: bool = False,
                    strip_media: bool = False) -> list[dict]:
    """[{"from": "human", "value": ...}] -> [{"role", "content"}]."""
    fn = strip_media_tokens if strip_media else replace_media_tokens
    return [
        {"role": _ROLE_MAP.get(c["from"], c["from"]),
         "content": fn(c["value"], is_video=is_video)}
        for c in conversations
    ]
