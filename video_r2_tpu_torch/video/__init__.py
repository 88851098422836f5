"""Host video / image preprocessing of the PyTorch port (see the package
docstring): the same exports as ``video_r2_tpu/video/__init__.py``."""

from .api import (
    ImageFeatures,
    VideoFeatures,
    VideoPreprocessConfig,
    extract_vision_info,
    fetch_image,
    fetch_video,
    process_vision_info,
)
from .geometry import (
    FRAME_FACTOR,
    IMAGE_FACTOR,
    VideoGeometry,
    calculate_video_frame_range,
    format_hhmmss,
    plan_video_geometry,
    sample_frame_indices,
    smart_nframes,
    smart_resize,
)

__all__ = [
    "ImageFeatures", "VideoFeatures", "VideoPreprocessConfig",
    "fetch_image", "fetch_video", "extract_vision_info", "process_vision_info",
    "FRAME_FACTOR", "IMAGE_FACTOR", "VideoGeometry",
    "calculate_video_frame_range", "format_hhmmss", "plan_video_geometry",
    "sample_frame_indices", "smart_nframes", "smart_resize",
]
