"""GRPO dataset: LLaVA records -> prompt-only samples with the GT answer and
the temporal ground truth.

Port of ``video_r2_tpu/data/grpo.py`` for video records: ``"video"`` holds
a file (resolved under ``image_folder``) or decoded uint8 frames ([T, H, W,
3], or a list of such clips). The media placeholders are deleted from the
text (the media travel structurally, as video elements the GRPO runner reads
through video/api.py::fetch_video), and the sample carries the assistant's
answer plus ``temporal_captions`` / ``temporal_grounding`` for the TAR
reward. Image records raise: image prompts into the model wait for a later
slice (ROADMAP Queue 1).
"""

from __future__ import annotations

import json
import os
from pathlib import Path

from .config import DataConfig
from .constants import DEFAULT_SYSTEM_MESSAGE
from .conversion import llava_to_openai
from .sft import _resolve


class GRPODataset:
    def __init__(self, data: str | list, dcfg: DataConfig,
                 system_message: str = DEFAULT_SYSTEM_MESSAGE):
        if isinstance(data, str):
            with open(data) as f:
                data = json.load(f)
        self.records = data
        self.dcfg = dcfg
        self.system_message = system_message

    def __len__(self):
        return len(self.records)

    def __getitem__(self, i: int) -> dict:
        rec = self.records[i]
        is_video = "video" in rec
        contents: list[dict] = []

        if "image" in rec:
            raise NotImplementedError(
                "image records: image prompts into the model are not ported yet "
                "(ROADMAP Queue 1, image inputs)")
        if is_video:
            files = rec["video"] if isinstance(rec["video"], list) else [rec["video"]]
            key_frames = rec.get("key_frame", "")
            if isinstance(key_frames, str):
                key_frames = [key_frames]
            for f, kf in zip(files, key_frames + [""] * (len(files) - len(key_frames))):
                sub = None
                if self.dcfg.video_subtitles_folder and isinstance(f, str):
                    cand = Path(os.path.join(self.dcfg.video_subtitles_folder, f)
                                ).with_suffix(".srt")
                    sub = str(cand) if cand.exists() else None
                ele = {"type": "video",
                       "video": _resolve(f, self.dcfg.image_folder)
                       if isinstance(f, str) else f,
                       "subtitles": sub, "key_frame": kf,
                       "min_pixels": self.dcfg.video_min_pixels,
                       "max_pixels": self.dcfg.video_max_pixels,
                       "fps": self.dcfg.fps}
                if self.dcfg.video_resized_width:
                    ele["resized_width"] = self.dcfg.video_resized_width
                    ele["resized_height"] = self.dcfg.video_resized_height
                if "video_fps" in rec:
                    ele["video_fps"] = rec["video_fps"]
                contents.append(ele)

        conv = llava_to_openai(rec["conversations"], is_video=is_video, strip_media=True)
        contents.append({"type": "text", "text": conv[0]["content"]})
        prompt = [{"role": "user", "content": contents}]
        if self.system_message:
            prompt.insert(0, {"role": "system", "content": self.system_message})
        return {
            "prompt": prompt,
            "assistant": conv[1]["content"] if len(conv) > 1 else "",
            "temporal_captions": rec.get("temporal_captions", {}),
            "temporal_grounding": rec.get("temporal_grounding", {}),
        }
