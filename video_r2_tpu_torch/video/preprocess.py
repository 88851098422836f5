"""Host preprocessing: uint8 frames -> normalized, patchified ViT input.

A copy of the host path of ``video_r2_tpu/video/device_preprocess.py``
(``grid_thw_for``, ``preprocess_frames_host``, ``preprocess_frames_np``);
tests/test_torch_host.py holds the two equal. PIL is imported only when
frames need resizing. The JAX package's "device" backend (its fused jitted
graph) is not ported: ``preprocess_frames_np`` refuses it (ROADMAP Queue 1).

Patch layout (HF Qwen2VLImageProcessor._preprocess): frames padded to a
multiple of temporal_patch_size by repeating the last frame, then
  reshape (gt, tps, C, gh/m, m, p, gw/m, m, p)
  transpose (0, 3, 6, 4, 7, 2, 1, 5, 8)
  reshape (gt*gh*gw, C*tps*p*p)
so each row is one 14x14x2 patch and 2x2 spatial-merge blocks are contiguous.
"""

from __future__ import annotations

import numpy as np

# OPENAI CLIP normalization (HF Qwen2VLImageProcessor defaults).
IMAGE_MEAN = (0.48145466, 0.4578275, 0.40821073)
IMAGE_STD = (0.26862954, 0.26130258, 0.27577711)

PATCH_SIZE = 14
TEMPORAL_PATCH_SIZE = 2
MERGE_SIZE = 2


def grid_thw_for(t: int, target_h: int, target_w: int) -> tuple[int, int, int]:
    gt = (t + TEMPORAL_PATCH_SIZE - 1) // TEMPORAL_PATCH_SIZE
    return (gt, target_h // PATCH_SIZE, target_w // PATCH_SIZE)


def preprocess_frames_np(frames_uint8: np.ndarray, target_h: int, target_w: int,
                         out_dtype=np.float32, backend: str = "host",
                         ) -> tuple[np.ndarray, tuple[int, int, int]]:
    """(patches, grid_thw) as numpy, on the host (backend "host")."""
    if backend == "device":
        raise NotImplementedError(
            "preprocess_backend='device' (video/device_preprocess.py) is not ported "
            "yet (ROADMAP Queue 1); use 'host'")
    return (preprocess_frames_host(frames_uint8, target_h, target_w, out_dtype),
            grid_thw_for(frames_uint8.shape[0], target_h, target_w))


def preprocess_frames_host(frames_uint8: np.ndarray, target_h: int,
                           target_w: int, out_dtype=np.float32) -> np.ndarray:
    """(T, H, W, C) uint8 frames -> (gt*gh*gw, C*tps*p*p) patches: PIL bicubic
    resize when the size differs, then patchify in uint8 and normalize through
    a per-channel lookup table (bit-exact vs (x/255 - mean)/std in f32)."""
    t = frames_uint8.shape[0]
    if frames_uint8.shape[1:3] != (target_h, target_w):
        try:
            from PIL import Image
        except ImportError as e:
            raise ImportError("resizing frames (preprocess_frames_host) needs PIL "
                              "(the Pillow package), which is not installed") from e

        frames_uint8 = np.stack([
            np.asarray(Image.fromarray(f).resize((target_w, target_h),
                                                 Image.BICUBIC))
            for f in frames_uint8])
    x = frames_uint8
    if t % TEMPORAL_PATCH_SIZE:
        pad = TEMPORAL_PATCH_SIZE - t % TEMPORAL_PATCH_SIZE
        x = np.concatenate([x, np.repeat(x[-1:], pad, axis=0)], axis=0)
        t += pad
    gt = t // TEMPORAL_PATCH_SIZE
    gh, gw = target_h // PATCH_SIZE, target_w // PATCH_SIZE
    m, p, c = MERGE_SIZE, PATCH_SIZE, x.shape[-1]
    x = np.transpose(x, (0, 3, 1, 2))
    x = x.reshape(gt, TEMPORAL_PATCH_SIZE, c, gh // m, m, p, gw // m, m, p)
    x = np.transpose(x, (0, 3, 6, 4, 7, 2, 1, 5, 8))
    u8 = np.ascontiguousarray(
        x.reshape(gt * gh * gw, c * TEMPORAL_PATCH_SIZE * p * p))
    lut = np.empty((c, 256), out_dtype)
    for ch in range(c):
        v = ((np.arange(256, dtype=np.float32) / 255.0 - IMAGE_MEAN[ch])
             / IMAGE_STD[ch])
        lut[ch] = v.astype(out_dtype)
    chan = np.repeat(np.arange(c), TEMPORAL_PATCH_SIZE * PATCH_SIZE * PATCH_SIZE)
    return lut[chan[None, :], u8]
