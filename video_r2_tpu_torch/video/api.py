"""Model-ready video features from decoded frames.

The JAX package's ``fetch_video`` (``video_r2_tpu/video/api.py``) decodes a
file with cv2 and burns in timestamps and subtitles before patchifying; that
reader is not ported yet, so the port starts from decoded uint8 frames.
`fetch_video` here is the counterpart of its frames branch (an element whose
``"video"`` holds the decoded frames, planned by video/geometry.py as the
JAX frames reader plans them); the SFT dataset and the GRPO runner both
call it. A video file, a list of image files and burn-in raise until the
video reader is ported (ROADMAP Queue 1 #4).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .geometry import DEFAULT_FPS_MAX_FRAMES, DEFAULT_VIDEO_TOTAL_PIXELS, plan_video_geometry
from .preprocess import grid_thw_for, preprocess_frames_host


@dataclass(frozen=True)
class VideoPreprocessConfig:
    """The fields of the JAX package's VideoPreprocessConfig that the frames
    branch reads (same defaults)."""

    fps_max_frames: int = DEFAULT_FPS_MAX_FRAMES
    video_total_pixels: int = DEFAULT_VIDEO_TOTAL_PIXELS
    write_timestamps: bool = False
    write_subtitles: bool = False


@dataclass
class VideoFeatures:
    """Model-ready video features for one clip."""

    patches: np.ndarray            # (gt*gh*gw, C*tps*p*p)
    grid_thw: tuple[int, int, int]
    sample_fps: float              # frames/sec actually sampled
    second_per_grid_t: float       # M-RoPE temporal scale = tps / sample_fps

    @property
    def num_tokens(self) -> int:
        gt, gh, gw = self.grid_thw
        return gt * gh * gw // 4  # after 2x2 spatial merge


def video_features(frames_uint8: np.ndarray, target_h: int, target_w: int,
                   sample_fps: float) -> VideoFeatures:
    """(T, H, W, 3) uint8 frames sampled at `sample_fps` -> float32
    VideoFeatures, with the temporal scale ``fetch_video`` sets
    (2 / sample_fps)."""
    patches = preprocess_frames_host(frames_uint8, target_h, target_w)
    grid = grid_thw_for(frames_uint8.shape[0], target_h, target_w)
    return VideoFeatures(patches, grid, sample_fps,
                         2.0 / max(sample_fps, 1e-6))


def fetch_video(ele: dict, cfg: VideoPreprocessConfig | None = None) -> VideoFeatures:
    """A video element -> features. ``ele["video"]`` holds decoded uint8
    frames ([T, H, W, 3], or a list of [H, W, 3]) at ``ele["video_fps"]``
    (default 1); the element's pixel, fps and frame-range keys plan the
    sampling and the resize, as in the JAX frames reader."""
    cfg = cfg or VideoPreprocessConfig()
    src = ele.get("video")
    if isinstance(src, str):
        raise NotImplementedError(
            f"video file {src!r}: decoding files needs the video reader port "
            "(ROADMAP Queue 1 #4); pass decoded uint8 frames [T, H, W, 3]")
    if isinstance(src, (list, tuple)) and src and not isinstance(src[0], np.ndarray):
        raise NotImplementedError("a video given as image files needs the image "
                                  "reader port (ROADMAP Queue 1 #4)")
    if cfg.write_timestamps or cfg.write_subtitles:
        raise NotImplementedError("timestamp / subtitle burn-in needs the video "
                                  "reader port (ROADMAP Queue 1 #4)")
    arr = np.asarray(np.stack(src) if isinstance(src, (list, tuple)) else src,
                     dtype=np.uint8)
    plan = plan_video_geometry(ele, arr.shape[0], float(ele.get("video_fps", 1.0)),
                               fps_max_frames=cfg.fps_max_frames,
                               video_total_pixels=cfg.video_total_pixels,
                               native_height=arr.shape[1], native_width=arr.shape[2])
    return video_features(arr[list(plan.frame_indices)], plan.resized_height,
                          plan.resized_width, plan.sample_fps)
