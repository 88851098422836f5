"""Data pipeline configuration (parity: DataArguments, train/src/params.py:203-219).

A copy of ``video_r2_tpu/data/config.py`` (that package's ``__init__``
imports jax); tests/test_torch_host.py holds the two equal.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class DataConfig:
    data_path: str = ""
    image_folder: str = ""                    # base folder for image AND video paths
    video_subtitles_folder: str | None = None
    image_min_pixels: int = 3136              # 4*28*28
    image_max_pixels: int = 12_845_056        # 16384*28*28
    video_min_pixels: int = 100_352           # 128*28*28
    video_max_pixels: int = 602_112           # 768*28*28
    image_resized_width: int | None = None
    image_resized_height: int | None = None
    video_resized_width: int | None = None
    video_resized_height: int | None = None
    fps: float = 1.0
    fps_max_frames: int = 32                  # FPS_MAX_FRAMES env in reference
    write_timestamps: bool = False
    write_subtitles: bool = False
    pad_to_multiple: int = 64                 # static-shape bucketing
    max_seq_length: int = 32768
