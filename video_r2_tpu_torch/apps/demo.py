"""Single-video QA: decoded frames + a question -> a think-style answer.

Port of ``video_r2_tpu/apps/demo.py::DemoRunner``, split where the JAX
runner's ``fetch_video`` returns: the runner here takes `VideoFeatures`
(video/api.py builds them from decoded uint8 frames). The cv2 reader with
timestamp / subtitle burn-in and the web UI come with the video reader port.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..engine.chat import expand_vision_placeholders, pack_prompts, render_messages
from ..engine.generate import GenerationResult, generate
from ..engine.sampling import SamplingParams
from ..models.model import Qwen25VL
from ..models.mrope import get_rope_index
from ..models.vision import VisionLayout, plan_vision_layout, vit_forward
from ..video.api import VideoFeatures

DEMO_MAX_NEW_TOKENS = 2048

# Exact think-mode post-prompt of the *_think task YAMLs (a copy of
# video_r2_tpu/evalharness/api.py::THINK_POST_PROMPT).
THINK_POST_PROMPT = (
    "\nPlease think about this question as if you were a human pondering "
    "deeply. Engage in an internal dialogue using expressions such as 'let me "
    "think', 'wait', 'Hmm', 'oh, I see', 'let's break it down', etc, or other "
    "natural language thought expressions. It's encouraged to include "
    "self-reflection or verification in the reasoning process. Provide your "
    "detailed reasoning between the <think> and </think> tags, and then give "
    "your final answer between the <answer> and </answer> tags."
)


@dataclass
class DemoRequest:
    """Host-planned inputs of one question (what `answer` feeds the model)."""

    input_ids: np.ndarray      # [1, S]
    lengths: np.ndarray        # [1]
    position_ids: np.ndarray   # [3, 1, S]
    rope_deltas: np.ndarray    # [1]
    layout: VisionLayout
    patches: np.ndarray


class DemoRunner:
    def __init__(self, model: Qwen25VL, tok, impl: str = "auto"):
        """impl: decoder prefill attention, "flash" or "xla"; "auto" picks
        flash on a CUDA device (as the JAX demo picks it on the TPU). The ViT
        picks its kernels the same way (vision.vit_forward)."""
        self.model = model
        self.cfg = model.cfg
        self.tok = tok
        self.device = model.device
        if impl == "auto":
            impl = "flash" if self.device.type == "cuda" else "xla"
        self.impl = impl

    def prepare(self, feats: VideoFeatures, question: str) -> DemoRequest:
        messages = [{"role": "user", "content": [
            {"type": "video", "video": "frames"},
            {"type": "text", "text": question + THINK_POST_PROMPT},
        ]}]
        text = render_messages(messages)
        text = expand_vision_placeholders(text, [feats.num_tokens], [])
        packed = pack_prompts([self.tok.encode(text)], pad_id=self.cfg.pad_token_id)
        mask = (np.arange(packed.input_ids.shape[1])[None, :]
                < packed.lengths[:, None]).astype(np.int64)
        pos, deltas = get_rope_index(
            packed.input_ids, self.cfg,
            video_grid_thw=np.array([feats.grid_thw]),
            second_per_grid_ts=np.array([feats.second_per_grid_t]),
            attention_mask=mask)
        layout = plan_vision_layout([feats.grid_thw], self.cfg.vision)
        return DemoRequest(packed.input_ids, packed.lengths, pos, deltas[:, 0],
                           layout, feats.patches)

    @torch.inference_mode()
    def vision_embeds(self, req: DemoRequest, attn_impl: str = "auto") -> torch.Tensor:
        patches = torch.as_tensor(req.patches, device=self.device)
        return vit_forward(self.model.visual, patches, req.layout, attn_impl)

    def generate(self, req: DemoRequest, max_new_tokens: int) -> GenerationResult:
        sp = SamplingParams(max_new_tokens=max_new_tokens,
                            eos_token_ids=(self.cfg.eos_token_id,),
                            pad_token_id=self.cfg.pad_token_id)
        return generate(self.model, req.input_ids, req.lengths, sp,
                        position_ids=req.position_ids,
                        rope_deltas=req.rope_deltas,
                        vision_embeds=self.vision_embeds(req),
                        vision_token_id=self.cfg.video_token_id,
                        attn_impl=self.impl)

    def answer(self, feats: VideoFeatures, question: str,
               max_new_tokens: int = DEMO_MAX_NEW_TOKENS) -> str:
        res = self.generate(self.prepare(feats, question), max_new_tokens)
        return self.tok.decode(res.sequences[0][: res.lengths[0]],
                               skip_special_tokens=True)
