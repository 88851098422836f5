"""SRT subtitle parsing and time-indexed lookup.

A copy of ``video_r2_tpu/video/srt.py`` (that package's ``__init__`` imports
jax); tests/test_torch_video.py holds the two equal. Behavioral spec:
reference vision_process.py:137-212 (parse_srt_cached, SubtitleIndex), with a
(path, mtime) cache in place of a module-level lru_cache.
"""

from __future__ import annotations

import os
import re
from bisect import bisect_right
from pathlib import Path

_TAG_RE = re.compile(r"</?([biu])>", re.IGNORECASE)

Cue = tuple[float, float, list[str]]


def srt_time_to_seconds(ts: str) -> float:
    """'HH:MM:SS,mmm' -> seconds."""
    hh, mm, rest = ts.split(":")
    ss, ms = rest.split(",")
    return int(hh) * 3600 + int(mm) * 60 + int(ss) + int(ms) / 1000.0


def parse_srt_text(raw: str) -> list[Cue]:
    raw = raw.replace("\r\n", "\n").replace("\r", "\n")
    cues: list[Cue] = []
    for block in (b.strip() for b in raw.split("\n\n") if b.strip()):
        lines = block.split("\n")
        timing_idx = next((i for i, ln in enumerate(lines[:3]) if "-->" in ln), -1)
        if timing_idx < 0:
            continue
        try:
            left, right = (x.strip() for x in lines[timing_idx].split("-->"))
            start, end = srt_time_to_seconds(left), srt_time_to_seconds(right)
        except Exception:
            continue
        text = [_TAG_RE.sub("", ln.strip()) for ln in lines[timing_idx + 1:] if ln.strip()]
        if text:
            cues.append((start, end, text))
    cues.sort(key=lambda c: c[0])
    return cues


_CACHE: dict[tuple[str, float], list[Cue]] = {}


def parse_srt_file(path: str | Path) -> list[Cue]:
    path = str(path)
    mtime = os.path.getmtime(path)
    key = (path, mtime)
    if key not in _CACHE:
        try:
            raw = open(path, "r", encoding="utf-8").read()
        except UnicodeDecodeError:
            raw = open(path, "r", encoding="utf-8-sig").read()
        if len(_CACHE) > 256:
            _CACHE.clear()
        _CACHE[key] = parse_srt_text(raw)
    return _CACHE[key]


class SubtitleIndex:
    """Monotonic-time subtitle lookup with 50 ms tolerance.

    Parity: vision_process.py:189-212.
    """

    def __init__(self, cues: list[Cue]):
        self.cues = cues
        self.starts = [c[0] for c in cues]

    def get(self, t: float, last_idx: int = 0, tol: float = 0.05) -> tuple[str | None, int]:
        if not self.cues:
            return None, last_idx
        i = bisect_right(self.starts, t + tol, lo=last_idx) - 1
        if 0 <= i < len(self.cues):
            s, e, lines = self.cues[i]
            if s - tol <= t < e + tol:
                return "\n".join(lines), i
            if t < s:
                j = max(0, i - 1)
                s2, e2, lines2 = self.cues[j]
                if s2 - tol <= t < e2 + tol:
                    return "\n".join(lines2), j
        if i < 0 and (self.cues[0][0] - t) <= tol:
            return "\n".join(self.cues[0][2]), 0
        return None, max(0, i)


def resolve_srt_path_for_video(video_path: str | Path) -> Path | None:
    """Sibling .srt with the same basename. Parity: vision_process.py:312-317."""
    srt = Path(video_path).with_suffix(".srt")
    return srt if srt.exists() else None
