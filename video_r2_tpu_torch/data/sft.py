"""SFT dataset + collator: LLaVA records -> masked-CE batches.

Port of ``video_r2_tpu/data/sft.py`` for video records: ``"video"`` holds
a file (resolved under ``image_folder``, decoded with cv2) or decoded uint8
frames (the JAX frames passthrough, ``data/sft.py:98-99``), each through
video/api.py's ``fetch_video`` with the same frame sampling and resize plan,
the sibling ``.srt`` under ``video_subtitles_folder`` and the timestamp /
subtitle burn-in the data config asks for. Image records raise: image inputs
into the model (``image_patches`` / ``image_grid_thw`` in the batch and the
loss) wait for a later slice (ROADMAP Queue 1).

The collator emits what the train step consumes: right-padded, bucketed
input_ids / labels / attention_mask, M-RoPE position_ids (host-planned),
the concatenated video patches and the planned VisionLayout.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from pathlib import Path
from typing import Any

import numpy as np

from ..engine.chat import expand_vision_placeholders
from ..models.config import ModelConfig
from ..models.mrope import get_rope_index
from ..models.vision import VisionLayout, plan_vision_layout
from ..video.api import VideoFeatures, VideoPreprocessConfig, fetch_video
from .config import DataConfig
from .constants import DEFAULT_SYSTEM_MESSAGE, IGNORE_INDEX, IM_END, IM_START, VIDEO_PAD
from .conversion import llava_to_openai


def _resolve(path: str, folder: str) -> str:
    if os.path.exists(path) or path.startswith("http"):
        return path
    return os.path.join(folder, path)


@dataclass
class SFTExample:
    input_ids: np.ndarray          # [S]
    labels: np.ndarray             # [S]
    video_patches: np.ndarray | None
    video_grid_thw: list[tuple[int, int, int]]
    second_per_grid_ts: list[float]


class SFTDataset:
    """Map-style dataset over LLaVA-format records (a JSON path or a list)."""

    def __init__(self, data: str | list, tokenizer, cfg: ModelConfig,
                 dcfg: DataConfig, system_message: str = DEFAULT_SYSTEM_MESSAGE):
        if isinstance(data, str):
            with open(data) as f:
                data = json.load(f)
        self.records = data
        self.tok = tokenizer
        self.cfg = cfg
        self.dcfg = dcfg
        self.system_message = system_message
        self.vcfg = VideoPreprocessConfig(
            fps_max_frames=dcfg.fps_max_frames,
            write_timestamps=dcfg.write_timestamps,
            write_subtitles=dcfg.write_subtitles,
        )

    def __len__(self):
        return len(self.records)

    def _load_videos(self, rec: dict) -> list[VideoFeatures]:
        """The record's videos through fetch_video, each element built as
        the JAX dataset's ``_load_vision`` builds it."""
        if "image" in rec:
            raise NotImplementedError(
                "image records: image inputs into the model (image_patches / "
                "image_grid_thw in the SFT batch and the loss) are not ported yet "
                "(ROADMAP Queue 1, image inputs)")
        if "video" not in rec:
            return []
        d = self.dcfg
        files = rec["video"] if isinstance(rec["video"], list) else [rec["video"]]
        videos = []
        for f in files:
            sub = None
            if d.video_subtitles_folder and isinstance(f, str):
                cand = Path(os.path.join(d.video_subtitles_folder, f)).with_suffix(".srt")
                sub = str(cand) if cand.exists() else None
            ele = {"video": _resolve(f, d.image_folder) if isinstance(f, str) else f,
                   "subtitles": sub,
                   "min_pixels": d.video_min_pixels, "max_pixels": d.video_max_pixels,
                   "fps": d.fps}
            if d.video_resized_width:
                ele["resized_width"] = d.video_resized_width
                ele["resized_height"] = d.video_resized_height
            if "video_fps" in rec:
                ele["video_fps"] = rec["video_fps"]
            videos.append(fetch_video(ele, self.vcfg))
        return videos

    def __getitem__(self, i: int) -> SFTExample:
        rec = self.records[i]
        videos = self._load_videos(rec)
        conv = llava_to_openai(rec["conversations"], is_video="video" in rec)
        vid_counts = [v.num_tokens for v in videos]

        ids_parts: list[list[int]] = []
        lab_parts: list[list[int]] = []
        if self.system_message:
            sys_ids = self.tok.encode(
                f"{IM_START}system\n{self.system_message}{IM_END}\n")
            ids_parts.append(sys_ids)
            lab_parts.append([IGNORE_INDEX] * len(sys_ids))

        for j in range(0, len(conv), 2):
            user, gpt = conv[j], conv[j + 1]
            prompt_text = (f"{IM_START}{user['role']}\n{user['content']}{IM_END}\n"
                           f"{IM_START}{gpt['role']}\n")
            if VIDEO_PAD in prompt_text:
                prompt_text = expand_vision_placeholders(prompt_text, vid_counts, [])
            prompt_ids = self.tok.encode(prompt_text)
            resp_ids = self.tok.encode(f"{gpt['content']}{IM_END}\n")
            ids_parts.append(prompt_ids)
            lab_parts.append([IGNORE_INDEX] * len(prompt_ids))
            ids_parts.append(resp_ids)
            lab_parts.append(list(resp_ids))

        input_ids = np.concatenate([np.asarray(p, np.int32) for p in ids_parts])
        labels = np.concatenate([np.asarray(p, np.int32) for p in lab_parts])
        if input_ids.shape[0] > self.dcfg.max_seq_length:
            input_ids = input_ids[: self.dcfg.max_seq_length]
            labels = labels[: self.dcfg.max_seq_length]

        return SFTExample(
            input_ids=input_ids,
            labels=labels,
            video_patches=(np.concatenate([v.patches for v in videos])
                           if videos else None),
            video_grid_thw=[v.grid_thw for v in videos],
            second_per_grid_ts=[v.second_per_grid_t for v in videos],
        )


@dataclass
class SFTBatch:
    """Host arrays of one batch + the static video layout."""

    arrays: dict[str, Any]               # input_ids, labels, attention_mask,
                                         # position_ids, video_patches
    video_layout: VisionLayout | None


class SFTCollator:
    """Right-pad to a bucketed length; plan the video layout; compute
    M-RoPE positions host-side."""

    def __init__(self, cfg: ModelConfig, dcfg: DataConfig):
        self.cfg = cfg
        self.dcfg = dcfg

    def __call__(self, examples: list[SFTExample]) -> SFTBatch:
        B = len(examples)
        mult = self.dcfg.pad_to_multiple
        smax = max(e.input_ids.shape[0] for e in examples)
        smax = -(-smax // mult) * mult
        ids = np.full((B, smax), self.cfg.pad_token_id, np.int32)
        labels = np.full((B, smax), IGNORE_INDEX, np.int32)
        mask = np.zeros((B, smax), np.int32)
        for b, e in enumerate(examples):
            L = e.input_ids.shape[0]
            ids[b, :L] = e.input_ids
            labels[b, :L] = e.labels
            mask[b, :L] = 1

        video_grids = [g for e in examples for g in e.video_grid_thw]
        spg = np.asarray(
            [s for e in examples for s in e.second_per_grid_ts], np.float64)
        pos, _ = get_rope_index(
            ids, self.cfg,
            video_grid_thw=np.asarray(video_grids) if video_grids else None,
            second_per_grid_ts=spg if len(spg) else None,
            attention_mask=mask)

        arrays = {"input_ids": ids, "labels": labels, "attention_mask": mask,
                  "position_ids": pos}
        video_layout = None
        if video_grids:
            arrays["video_patches"] = np.concatenate(
                [e.video_patches for e in examples if e.video_patches is not None])
            video_layout = plan_vision_layout(video_grids, self.cfg.vision)
        return SFTBatch(arrays, video_layout)
