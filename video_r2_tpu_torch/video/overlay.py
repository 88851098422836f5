"""Timestamp and subtitle burn-in on decoded frames (host-side, PIL).

Port of ``video_r2_tpu/video/overlay.py``. Behavioral spec: reference
vision_process.py:73-133 (timestamp, adaptive color + font) and :215-309
(subtitle bottom-center with wrap and translucent box). PIL is imported inside
the functions that draw, so importing this module (and video/api.py) needs no
PIL; a call without it raises an ImportError naming the package. Burn-in runs
on the host before the frames are patchified.
"""

from __future__ import annotations

import numpy as np

# Subtitle style (vision_process.py:50-55)
SUBTITLE_FONT_SCALE = 0.06
SUBTITLE_MIN_PX = 20
SUBTITLE_MAX_PX = 96
SUBTITLE_MAX_WIDTH_FRAC = 0.90
SUBTITLE_BOX_ALPHA = 0.55
SUBTITLE_MARGIN_SCALE = 0.25


def _pil(what: str):
    """(Image, ImageDraw, ImageFont) of PIL, or an ImportError naming it."""
    try:
        from PIL import Image, ImageDraw, ImageFont
    except ImportError as e:
        raise ImportError(f"{what} needs PIL (the Pillow package), which is not "
                          "installed") from e
    return Image, ImageDraw, ImageFont


def _load_font(size: int):
    _, _, ImageFont = _pil("drawing text on frames")
    try:
        return ImageFont.truetype("DejaVuSans.ttf", size)
    except Exception:
        return ImageFont.load_default()


def choose_timestamp_color(frame_hwc: np.ndarray) -> tuple[int, int, int]:
    """White on dark/red backgrounds, red otherwise (vision_process.py:73-95)."""
    h, w = frame_hwc.shape[:2]
    patch = frame_hwc[: min(40, h), : min(200, w), :].astype(np.float32)
    r, g, b = (patch[..., c].mean() for c in range(3))
    luminance = 0.2126 * r + 0.7152 * g + 0.0722 * b
    if luminance < 80.0 or (r > 120.0 and r - max(g, b) > 40.0):
        return (255, 255, 255)
    return (255, 0, 0)


def draw_timestamp(frame_hwc: np.ndarray, text: str) -> np.ndarray:
    """HH:MM:SS top-left with adaptive font (vision_process.py:98-133)."""
    Image, ImageDraw, _ = _pil("timestamp burn-in (draw_timestamp)")
    img = Image.fromarray(frame_hwc, mode="RGB")
    draw = ImageDraw.Draw(img)
    h, w = frame_hwc.shape[:2]
    font_size = max(16, min(72, int(round(min(h, w) * 0.05))))
    font = _load_font(font_size)
    margin = max(5, font_size // 4)
    stroke = max(1, font_size // 12)
    draw.text(
        (margin, margin), text,
        fill=choose_timestamp_color(frame_hwc),
        font=font, stroke_width=stroke, stroke_fill=(0, 0, 0),
    )
    return np.asarray(img)


def _measure(draw, font, text: str) -> tuple[int, int]:
    box = draw.textbbox((0, 0), text, font=font, stroke_width=0)
    return box[2] - box[0], box[3] - box[1]


def _wrap(draw, font, text: str, max_width: int) -> list[str]:
    out: list[str] = []
    for para in text.split("\n"):
        words = para.split()
        if not words:
            out.append("")
            continue
        cur = words[0]
        for w in words[1:]:
            cand = f"{cur} {w}"
            if _measure(draw, font, cand)[0] <= max_width:
                cur = cand
            else:
                out.append(cur)
                cur = w
        out.append(cur)
    return out


def draw_subtitle(frame_hwc: np.ndarray, text: str) -> np.ndarray:
    """Wrapped subtitle bottom-center over a translucent box
    (vision_process.py:257-309)."""
    if not text:
        return frame_hwc
    Image, ImageDraw, _ = _pil("subtitle burn-in (draw_subtitle)")
    img = Image.fromarray(frame_hwc, mode="RGB").convert("RGBA")
    overlay = Image.new("RGBA", img.size, (0, 0, 0, 0))
    odraw = ImageDraw.Draw(overlay)
    draw = ImageDraw.Draw(img)

    h, w = frame_hwc.shape[:2]
    font_size = max(SUBTITLE_MIN_PX, min(SUBTITLE_MAX_PX,
                                         int(round(min(h, w) * SUBTITLE_FONT_SCALE))))
    font = _load_font(font_size)
    margin = max(6, int(font_size * SUBTITLE_MARGIN_SCALE))
    stroke = max(1, font_size // 12)
    W, H = img.size

    wrapped = _wrap(draw, font, text, int(W * SUBTITLE_MAX_WIDTH_FRAC))
    sizes = [_measure(draw, font, ln if ln else " ") for ln in wrapped]
    gap = int(0.2 * font_size)
    text_h = sum(s[1] for s in sizes) + gap * max(0, len(wrapped) - 1)
    text_w = max((s[0] for s in sizes), default=0)

    box_left = max(0, (W - text_w) // 2 - margin)
    box_right = min(W, box_left + text_w + 2 * margin)
    box_bottom = H - margin
    box_top = max(0, box_bottom - text_h - 2 * margin)
    odraw.rectangle([box_left, box_top, box_right, box_bottom],
                    fill=(0, 0, 0, int(255 * SUBTITLE_BOX_ALPHA)))
    img = Image.alpha_composite(img, overlay)
    draw = ImageDraw.Draw(img)

    y = box_top + margin
    for ln, (w_px, h_px) in zip(wrapped, sizes):
        draw.text(((W - w_px) // 2, y), ln, fill=(255, 255, 255), font=font,
                  stroke_width=stroke, stroke_fill=(0, 0, 0))
        y += h_px + gap
    return np.asarray(img.convert("RGB"))
