"""Persistent preprocessed-video feature cache.

A copy of ``video_r2_tpu/video/cache.py`` (that package's ``__init__``
imports jax); tests/test_torch_video.py holds the keys equal. Re-evaluating a
benchmark with a new checkpoint preprocesses the same videos with the same
geometry every run; the cache keeps each video's features so the host
decodes it once.

Entries are .npz files keyed by a sha256 over (video path, file mtime + size,
every geometry / burn-in knob that affects the features). Writes are a temp
file and an atomic rename (safe under concurrent prefetch threads or
processes); eviction drops the least recently used files (by mtime) past a
byte budget (default 16 GiB, VR2_VIDEO_CACHE_MAX_GB). Enable it with
VideoPreprocessConfig.cache_dir or the VR2_VIDEO_CACHE env var (the config's
default, so the eval CLI needs no flag).
"""

from __future__ import annotations

import hashlib
import json
import os
import tempfile
from pathlib import Path

import numpy as np

_MAX_BYTES = int(float(os.environ.get("VR2_VIDEO_CACHE_MAX_GB", "16"))
                 * (1 << 30))


def feature_cache_key(ele: dict, cfg, path: str) -> str | None:
    """Stable content key for one video's preprocessed features, or None
    when the input isn't cacheable (non-path sources). Includes the source
    file's (mtime_ns, size) so an overwritten video never serves stale
    features, and every knob that changes geometry, sampling, burn-in, or
    the patch payload."""
    try:
        st = os.stat(path)
    except OSError:
        return None
    sub = ele.get("subtitles")
    sub_st = None
    if cfg.write_subtitles:
        from . import srt

        sp = sub if sub is not None else srt.resolve_srt_path_for_video(path)
        if sp is not None and os.path.exists(sp):
            s = os.stat(sp)
            sub_st = (sp, s.st_mtime_ns, s.st_size)
    key = {
        "path": os.path.abspath(path),
        "stat": (st.st_mtime_ns, st.st_size),
        "ele": {k: ele[k] for k in sorted(ele)
                if k not in ("video",) and not callable(ele[k])},
        "cfg": (cfg.fps_max_frames, cfg.video_total_pixels,
                cfg.write_timestamps, cfg.write_subtitles, cfg.backend,
                cfg.patch_dtype, cfg.preprocess_backend),
        "srt": sub_st,
        "v": 1,   # bump on feature-format changes
    }
    blob = json.dumps(key, sort_keys=True, default=repr).encode()
    return hashlib.sha256(blob).hexdigest()


class FeatureCache:
    def __init__(self, cache_dir: str, max_bytes: int | None = None):
        self.dir = Path(cache_dir)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.max_bytes = _MAX_BYTES if max_bytes is None else max_bytes

    def _path(self, key: str) -> Path:
        return self.dir / f"{key}.npz"

    def get(self, key: str):
        """-> VideoFeatures or None. Touches mtime on hit (LRU signal)."""
        p = self._path(key)
        try:
            with np.load(p) as z:
                from .api import VideoFeatures

                feat = VideoFeatures(
                    patches=z["patches"],
                    grid_thw=tuple(int(x) for x in z["grid_thw"]),
                    sample_fps=float(z["sample_fps"]),
                    second_per_grid_t=float(z["second_per_grid_t"]))
            os.utime(p)
            return feat
        except (OSError, KeyError, ValueError, EOFError):
            return None

    def put(self, key: str, feat) -> None:
        fd, tmp = tempfile.mkstemp(dir=self.dir, suffix=".tmp")
        try:
            with os.fdopen(fd, "wb") as f:
                np.savez(f, patches=feat.patches,
                         grid_thw=np.asarray(feat.grid_thw, np.int64),
                         sample_fps=np.float64(feat.sample_fps),
                         second_per_grid_t=np.float64(feat.second_per_grid_t))
            os.replace(tmp, self._path(key))
        except OSError:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            return
        self._evict()

    def _evict(self) -> None:
        """Drop oldest entries until under the byte budget."""
        try:
            entries = [(p.stat().st_mtime_ns, p.stat().st_size, p)
                       for p in self.dir.glob("*.npz")]
        except OSError:
            return
        total = sum(s for _, s, _ in entries)
        if total <= self.max_bytes:
            return
        for _, size, p in sorted(entries):
            try:
                p.unlink()
            except OSError:
                continue
            total -= size
            if total <= self.max_bytes:
                break
