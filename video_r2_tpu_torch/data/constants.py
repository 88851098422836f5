"""Data-layer constants (parity: train/src/constants.py).

A copy of ``video_r2_tpu/data/constants.py`` (that package's ``__init__``
imports jax); tests/test_torch_host.py holds the two equal.
"""

IGNORE_INDEX = -100

IM_START = "<|im_start|>"
IM_END = "<|im_end|>"
IMAGE_PAD = "<|image_pad|>"
VIDEO_PAD = "<|video_pad|>"
LLAVA_IMAGE_TOKEN = "<image>"
LLAVA_VIDEO_TOKEN = "<video>"
VISION_START = "<|vision_start|>"
VISION_END = "<|vision_end|>"

DEFAULT_SYSTEM_MESSAGE = "You are a helpful assistant."

MULTIMODAL_KEYS = ("video_patches", "video_grid_thw", "image_patches",
                   "image_grid_thw", "second_per_grid_ts")
