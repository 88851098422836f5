"""GRPO dataset: LLaVA records -> prompt-only samples with the GT answer and
the temporal ground truth.

Port of ``video_r2_tpu/data/grpo.py`` for records whose ``"video"`` holds
decoded uint8 frames ([T, H, W, 3], or a list of such clips): the media
placeholders are deleted from the text (the media travel structurally, as
video elements the GRPO runner reads through video/api.py::fetch_video),
and the sample carries the assistant's answer plus ``temporal_captions`` /
``temporal_grounding`` for the TAR reward. Video files and image records
raise until the video reader is ported (ROADMAP Queue 1 #4).
"""

from __future__ import annotations

import json

import numpy as np

from .config import DataConfig
from .constants import DEFAULT_SYSTEM_MESSAGE
from .conversion import llava_to_openai


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
            raise NotImplementedError("image records need the image reader port "
                                      "(ROADMAP Queue 1 #4)")
        if is_video:
            clips = rec["video"] if isinstance(rec["video"], list) else [rec["video"]]
            key_frames = rec.get("key_frame", "")
            if isinstance(key_frames, str):
                key_frames = [key_frames]
            for f, kf in zip(clips, key_frames + [""] * (len(clips) - len(key_frames))):
                if not isinstance(f, np.ndarray):
                    raise NotImplementedError(
                        f"video {f!r}: decoding files needs the video reader port "
                        "(ROADMAP Queue 1 #4); pass decoded uint8 frames [T, H, W, 3]")
                ele = {"type": "video", "video": f, "subtitles": None, "key_frame": kf,
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
