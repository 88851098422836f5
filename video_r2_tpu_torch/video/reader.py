"""Host-side video decode backends.

Port of ``video_r2_tpu/video/reader.py``: an explicit registry whose default
backend for a file is OpenCV (its bundled ffmpeg). Decoders return the
sampled frames as numpy uint8 (T, H, W, C) plus metadata; burn-in and the
patchify are separate stages (video/api.py). cv2 is imported inside the
calls that need it, so importing this module needs no cv2; a call without it
raises an ImportError naming the package. Nothing here touches torch.
"""

from __future__ import annotations

import logging
import os
from dataclasses import dataclass
from typing import Callable

import numpy as np

from .geometry import VideoGeometry, plan_video_geometry

logger = logging.getLogger(__name__)


@dataclass
class DecodedVideo:
    frames: np.ndarray          # (T, H, W, C) uint8, already sampled to plan
    geometry: VideoGeometry     # static plan (indices, target size, sample fps)
    video_fps: float            # native fps (for absolute timestamps)
    clip_start: float           # seconds offset of frame index 0 (video_start)


def _cv2(what: str):
    try:
        import cv2
    except ImportError as e:
        raise ImportError(f"{what} needs cv2 (the opencv-python package), which is "
                          "not installed") from e
    return cv2


def _strip_file_uri(path: str) -> str:
    return path[7:] if path.startswith("file://") else path


def probe_video_cv2(path: str) -> tuple[int, float]:
    """(total_frames, fps) via OpenCV metadata."""
    cv2 = _cv2("probing a video file (probe_video_cv2)")
    cap = cv2.VideoCapture(_strip_file_uri(path))
    if not cap.isOpened():
        raise IOError(f"cannot open video: {path}")
    try:
        total = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
        fps = float(cap.get(cv2.CAP_PROP_FPS)) or 30.0
        if total <= 0:
            # some containers don't report frame count; count by scanning
            total = 0
            while cap.grab():
                total += 1
        return total, fps
    finally:
        cap.release()


def _read_frames_seek(path, wanted: list[int],
                      probe_check: bool = True) -> dict[int, np.ndarray]:
    """Seek-based sparse read (ascending indices). Returns {} on any failed
    or inaccurate seek, so the caller falls back to the sequential pass: some
    codec / container backends snap CAP_PROP_POS_FRAMES to the nearest
    keyframe, which would feed other frames than the exact-index sampling.

    The position check alone is not enough: OpenCV derives
    CAP_PROP_POS_FRAMES from the same pts / fps counter the seek used, so for
    VFR or misindexed streams it can report landed == idx while the decoded
    image differs from the sequential pass's frame at that index. So one
    probe index per video (the earliest nonzero wanted one) is checked
    pixel-exact against the sequential grab path."""
    cv2 = _cv2("reading a video file (_read_frames_seek)")
    frames: dict[int, np.ndarray] = {}
    cap = cv2.VideoCapture(path)
    try:
        for idx in wanted:
            cap.set(cv2.CAP_PROP_POS_FRAMES, int(idx))
            landed = cap.get(cv2.CAP_PROP_POS_FRAMES)
            if int(landed) != int(idx):
                return {}  # backend snapped elsewhere: not frame-accurate
            ok, frame = cap.read()
            if not ok:
                return {}
            frames[idx] = cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)
    finally:
        cap.release()

    if probe_check and frames:
        probe = min((i for i in frames if i > 0), default=min(frames))
        cap = cv2.VideoCapture(path)
        try:
            for _ in range(probe):
                if not cap.grab():
                    return {}
            ok, seq_frame = cap.read()
        finally:
            cap.release()
        if not ok or not np.array_equal(
                cv2.cvtColor(seq_frame, cv2.COLOR_BGR2RGB), frames[probe]):
            logger.warning(
                "seek probe mismatch at frame %d of %s (VFR/misindexed "
                "stream?) - falling back to sequential decode", probe, path)
            return {}
    return frames


def read_video_cv2(ele: dict, fps_max_frames: int, video_total_pixels: int) -> DecodedVideo:
    """Decode with OpenCV, sampling only the planned indices.

    Short or densely sampled clips take one sequential grab / retrieve pass.
    Long videos sampled sparsely (average gap above VIDEO_SEEK_GAP_THRESHOLD,
    default 50 frames: one seek costs about a GOP decode) take per-index
    seeks, and fall back to the sequential pass if any seek fails."""
    cv2 = _cv2("decoding a video file (read_video_cv2)")
    path = _strip_file_uri(ele["video"])
    total, fps = probe_video_cv2(path)
    plan = _plan(ele, total, fps, fps_max_frames, video_total_pixels, path)

    wanted = set(plan.frame_indices)
    frames: dict[int, np.ndarray] = {}
    last_wanted = max(wanted)
    avg_gap = (last_wanted + 1) / max(len(wanted), 1)
    gap_threshold = float(os.environ.get("VIDEO_SEEK_GAP_THRESHOLD", 50))
    if avg_gap > gap_threshold:
        frames = _read_frames_seek(path, sorted(wanted))
    if not frames:
        cap = cv2.VideoCapture(path)
        try:
            i = 0
            while i <= last_wanted:
                ok = cap.grab()
                if not ok:
                    break
                if i in wanted:
                    ok, frame = cap.retrieve()
                    if not ok:
                        break
                    frames[i] = cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)
                i += 1
        finally:
            cap.release()

    # per-index fetch honoring duplicates in the plan; pad missing with last good
    out = []
    last_good = None
    for idx in plan.frame_indices:
        f = frames.get(idx, last_good)
        if f is None:
            raise IOError(f"failed to decode any frame <= {idx} from {path}")
        last_good = f
        out.append(f)
    video = np.stack(out, axis=0)
    return DecodedVideo(video, plan, fps, float(ele.get("video_start", 0.0) or 0.0))


def read_video_frames_list(ele: dict, fps_max_frames: int,
                           video_total_pixels: int) -> DecodedVideo:
    """'video' given as decoded frames (a list or array, uint8 [T, H, W, C])
    at ele["video_fps"] (default 1). Mirrors the decode path, so everything
    downstream is the same."""
    arr = ele["video"]
    if isinstance(arr, (list, tuple)):
        arr = np.stack([np.asarray(f) for f in arr], axis=0)
    arr = np.asarray(arr, dtype=np.uint8)
    total = arr.shape[0]
    fps = float(ele.get("video_fps", 1.0))
    plan = _plan(ele, total, fps, fps_max_frames, video_total_pixels, "<frames>")
    video = arr[list(plan.frame_indices)]
    return DecodedVideo(video, plan, fps, float(ele.get("video_start", 0.0) or 0.0))


def _plan(ele, total, fps, fps_max_frames, video_total_pixels, path) -> VideoGeometry:
    # one frame's native size, from the file's metadata or the first frame
    nh, nw = ele.get("_native_hw", (None, None))
    if nh is None and isinstance(ele.get("video"), str):
        cv2 = _cv2("reading a video file's size (_plan)")
        cap = cv2.VideoCapture(_strip_file_uri(path))
        try:
            nh = int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
            nw = int(cap.get(cv2.CAP_PROP_FRAME_WIDTH))
        finally:
            cap.release()
    elif nh is None:
        nh, nw = np.asarray(ele["video"][0]).shape[:2]
    return plan_video_geometry(
        ele, total, fps,
        fps_max_frames=fps_max_frames,
        video_total_pixels=video_total_pixels,
        native_height=nh, native_width=nw,
    )


VIDEO_READER_BACKENDS: dict[str, Callable[..., DecodedVideo]] = {
    "cv2": read_video_cv2,
    "frames": read_video_frames_list,
}


def decode_video(ele: dict, fps_max_frames: int, video_total_pixels: int,
                 backend: str | None = None) -> DecodedVideo:
    if backend is None:
        backend = "cv2" if isinstance(ele.get("video"), str) else "frames"
    return VIDEO_READER_BACKENDS[backend](ele, fps_max_frames, video_total_pixels)
