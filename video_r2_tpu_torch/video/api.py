"""Top-level video / image preprocessing API.

Port of ``video_r2_tpu/video/api.py``: one implementation of the reference's
``qwen_vl_utils`` contract (conversation scanning, image fetch, video fetch
with frame sampling and optional timestamp / subtitle burn-in), with explicit
configuration in place of env vars, and already-patchified model-ready
features plus grid_thw as its output.

A video element holds a file path (decoded with cv2, video/reader.py),
decoded uint8 frames ([T, H, W, 3] or a list of [H, W, 3], at
``ele["video_fps"]``, default 1) or a list of image files / PIL images.
Everything here runs on the host with numpy: cv2 and PIL are imported only by
the calls that need them (a file, burn-in, an image, a resize), and raise an
ImportError naming the package where it is missing. The frames branch, the
one the SFT and GRPO paths take, needs neither when the frames are already
at the planned size. The JAX package's "device" preprocess backend is not
ported and raises (ROADMAP Queue 1).
"""

from __future__ import annotations

import base64
import io
import os
import sys
from dataclasses import dataclass, field

import numpy as np

from . import overlay, srt
from .geometry import (
    DEFAULT_FPS_MAX_FRAMES,
    DEFAULT_VIDEO_TOTAL_PIXELS,
    IMAGE_FACTOR,
    MAX_PIXELS,
    MIN_PIXELS,
    format_hhmmss,
    smart_resize,
    video_frame_pixel_budget,
)
from .preprocess import grid_thw_for, preprocess_frames_host, preprocess_frames_np
from .reader import DecodedVideo, decode_video


@dataclass(frozen=True)
class VideoPreprocessConfig:
    """Replaces the reference's env-var knobs (vision_process.py:40-61); the
    JAX package's fields and defaults."""

    fps_max_frames: int = DEFAULT_FPS_MAX_FRAMES          # FPS_MAX_FRAMES
    video_total_pixels: int = DEFAULT_VIDEO_TOTAL_PIXELS  # VIDEO_MAX_PIXELS env
    write_timestamps: bool = False                        # WRITE_TIMESTAMPS_ON_FRAMES
    write_subtitles: bool = False                         # WRITE_SUBTITLES_ON_FRAMES
    backend: str | None = None                            # decode backend override
    patch_dtype: str = "float32"
    preprocess_backend: str = "host"  # "host" (PIL + numpy); "device" raises
    # persistent preprocessed-feature cache dir (video/cache.py); defaults to
    # $VR2_VIDEO_CACHE so the CLIs opt in by env alone
    cache_dir: str | None = field(
        default_factory=lambda: os.environ.get("VR2_VIDEO_CACHE") or None)


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


@dataclass
class ImageFeatures:
    patches: np.ndarray
    grid_thw: tuple[int, int, int]  # gt == 1


def video_features(frames_uint8: np.ndarray, target_h: int, target_w: int,
                   sample_fps: float) -> VideoFeatures:
    """(T, H, W, 3) uint8 frames sampled at `sample_fps` -> float32
    VideoFeatures, with the temporal scale ``fetch_video`` sets
    (2 / sample_fps)."""
    patches = preprocess_frames_host(frames_uint8, target_h, target_w)
    grid = grid_thw_for(frames_uint8.shape[0], target_h, target_w)
    return VideoFeatures(patches, grid, sample_fps,
                         2.0 / max(sample_fps, 1e-6))


def _pil_image(what: str):
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(f"{what} needs PIL (the Pillow package), which is not "
                          "installed") from e
    return Image


def _is_pil_image(x) -> bool:
    """Whether x is a PIL image (without importing PIL: an image exists only
    where PIL was imported)."""
    mod = sys.modules.get("PIL.Image")
    return mod is not None and isinstance(x, mod.Image)


def to_rgb(img):
    Image = _pil_image("converting an image to RGB (to_rgb)")
    if img.mode == "RGBA":
        bg = Image.new("RGB", img.size, (255, 255, 255))
        bg.paste(img, mask=img.split()[3])
        return bg
    return img.convert("RGB")


def open_image(image):
    """Accepts a PIL image, an array, a local path, file:// or data:image
    base64 (no http fetch: the deployment has no egress)."""
    Image = _pil_image("opening an image (open_image)")
    if isinstance(image, Image.Image):
        return image
    if isinstance(image, np.ndarray):
        return Image.fromarray(image)
    if image.startswith("data:image"):
        _, b64 = image.split("base64,", 1)
        with io.BytesIO(base64.b64decode(b64)) as bio:
            return Image.open(bio).copy()
    if image.startswith("file://"):
        image = image[7:]
    return Image.open(image)


def fetch_image(ele: dict, size_factor: int = IMAGE_FACTOR) -> ImageFeatures:
    """Image -> resized, normalized, patchified features.
    Parity surface: vision_process.py:374-422."""
    img = to_rgb(open_image(ele.get("image", ele.get("image_url"))))
    if "resized_height" in ele and "resized_width" in ele:
        rh, rw = smart_resize(ele["resized_height"], ele["resized_width"], factor=size_factor)
    else:
        w, h = img.size
        rh, rw = smart_resize(
            h, w, factor=size_factor,
            min_pixels=ele.get("min_pixels", MIN_PIXELS),
            max_pixels=ele.get("max_pixels", MAX_PIXELS),
        )
    frame = np.asarray(img, dtype=np.uint8)[None]  # (1, H, W, C)
    patches, grid = preprocess_frames_np(frame, rh, rw)
    return ImageFeatures(patches, grid)


def burn_in(decoded: DecodedVideo, ele: dict, cfg: VideoPreprocessConfig) -> np.ndarray:
    """Apply timestamp / subtitle overlays on decoded frames (host).
    Parity surface: vision_process.py:636-661."""
    frames = decoded.frames
    if not (cfg.write_timestamps or cfg.write_subtitles):
        return frames

    subidx = None
    if cfg.write_subtitles:
        srt_path = ele.get("subtitles")
        if srt_path is None and isinstance(ele.get("video"), str):
            srt_path = srt.resolve_srt_path_for_video(ele["video"])
        if srt_path is not None:
            try:
                cues = srt.parse_srt_file(srt_path)
                subidx = srt.SubtitleIndex(cues) if cues else None
            except Exception:
                subidx = None

    frames = frames.copy()
    last = 0
    for k, src_idx in enumerate(decoded.geometry.frame_indices):
        t_abs = decoded.clip_start + src_idx / decoded.video_fps
        if cfg.write_timestamps:
            frames[k] = overlay.draw_timestamp(frames[k], format_hhmmss(t_abs))
        if subidx is not None:
            text, last = subidx.get(t_abs, last)
            if text:
                frames[k] = overlay.draw_subtitle(frames[k], text)
    return frames


def fetch_video(ele: dict, cfg: VideoPreprocessConfig | None = None) -> VideoFeatures:
    """Video -> sampled, burned-in, resized, normalized, patchified features.
    Parity surface: vision_process.py:771-825 + the HF processor pass."""
    cfg = cfg or VideoPreprocessConfig()
    src = ele.get("video")
    if isinstance(src, (list, tuple)) and src and (
            isinstance(src[0], str) or _is_pil_image(src[0])):
        return _fetch_video_from_images(ele, cfg)
    cache = key = None
    if cfg.cache_dir and isinstance(src, str):
        from .cache import FeatureCache, feature_cache_key

        path = src[7:] if src.startswith("file://") else src
        key = feature_cache_key(ele, cfg, path)
        if key is not None:
            cache = FeatureCache(cfg.cache_dir)
            hit = cache.get(key)
            if hit is not None:
                return hit
    decoded = decode_video(ele, cfg.fps_max_frames, cfg.video_total_pixels,
                           backend=cfg.backend)
    frames = burn_in(decoded, ele, cfg)
    g = decoded.geometry
    patches, grid = preprocess_frames_np(
        frames, g.resized_height, g.resized_width,
        out_dtype=np.dtype(cfg.patch_dtype), backend=cfg.preprocess_backend)
    sample_fps = g.sample_fps
    feat = VideoFeatures(patches, grid, sample_fps, 2.0 / max(sample_fps, 1e-6))
    if cache is not None:
        cache.put(key, feat)
    return feat


def _fetch_video_from_images(ele: dict, cfg: VideoPreprocessConfig) -> VideoFeatures:
    """'video' as a list of image paths / PIL images (vision_process.py:
    811-825): each image fetched with the per-frame budget, padded to
    FRAME_FACTOR."""
    Image = _pil_image("a video given as images (_fetch_video_from_images)")
    imgs = [to_rgb(open_image(v)) for v in ele["video"]]
    n = len(imgs)
    if n % 2:
        imgs.append(imgs[-1])
        n += 1
    # one target size from the first frame, the decode path's budget math
    min_px, max_px = video_frame_pixel_budget(
        n, min_pixels=ele.get("min_pixels"), total_pixels=ele.get("total_pixels"),
        max_pixels=ele.get("max_pixels"), video_total_pixels=cfg.video_total_pixels)
    w, h = imgs[0].size
    rh, rw = smart_resize(h, w, factor=IMAGE_FACTOR, min_pixels=min_px, max_pixels=max_px)
    frames = np.stack(
        [np.asarray(im.resize((rw, rh), Image.BICUBIC), dtype=np.uint8) for im in imgs])
    patches, grid = preprocess_frames_np(frames, rh, rw,
                                         out_dtype=np.dtype(cfg.patch_dtype))
    fps = float(ele.get("fps", 2.0))
    return VideoFeatures(patches, grid, fps, 2.0 / max(fps, 1e-6))


def extract_vision_info(conversations) -> list[dict]:
    """Scan OpenAI-style messages for image / video content elements.
    Parity: vision_process.py:828-843."""
    infos = []
    if conversations and isinstance(conversations[0], dict):
        conversations = [conversations]
    for conv in conversations:
        for message in conv:
            content = message.get("content")
            if isinstance(content, list):
                for ele in content:
                    if (
                        "image" in ele or "image_url" in ele or "video" in ele
                        or ele.get("type", "") in ("image", "image_url", "video")
                    ):
                        infos.append(ele)
    return infos


def process_vision_info(
    conversations,
    cfg: VideoPreprocessConfig | None = None,
) -> tuple[list[ImageFeatures] | None, list[VideoFeatures] | None]:
    """All vision features for a conversation, in content order.
    Parity surface: vision_process.py:846-871 (the `fps` list is carried per
    VideoFeatures.sample_fps instead of a side dict)."""
    cfg = cfg or VideoPreprocessConfig()
    images, videos = [], []
    for info in extract_vision_info(conversations):
        if "image" in info or "image_url" in info:
            images.append(fetch_image(info))
        elif "video" in info:
            videos.append(fetch_video(info, cfg))
        else:
            raise ValueError("content element must contain image, image_url or video")
    return (images or None), (videos or None)
