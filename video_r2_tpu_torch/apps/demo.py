"""Single-video QA demo (demo/gradio_demo.py parity).

Port of ``video_r2_tpu/apps/demo.py``: a video file (and an optional .srt,
burned into the frames) plus a question -> a think-style answer, through
video/api.py's fetch_video, the ViT and `generate`, on the model's device.
`DemoRunner.answer` takes the file as the JAX runner does; callers with
decoded frames call `prepare` (from `VideoFeatures`) and `generate`. The
UI is a minimal stdlib web app with the reference's surface (video path +
optional .srt + question + nframes); --cli answers one question and exits.

Usage (the card; seeded random weights until the HF loader is ported):
  python -m video_r2_tpu_torch.apps.demo --port 7860
  python -m video_r2_tpu_torch.apps.demo --cli --video clip.mp4 --question "What?"
"""

from __future__ import annotations

import html
import sys
import urllib.parse
from dataclasses import dataclass
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from ..config import parse_config
from ..engine.chat import expand_vision_placeholders, pack_prompts, render_messages
from ..engine.generate import GenerationResult, generate
from ..engine.sampling import SamplingParams
from ..evalharness.api import THINK_POST_PROMPT
from ..models.model import Qwen25VL
from ..models.mrope import get_rope_index
from ..models.vision import VisionLayout, plan_vision_layout, vit_forward
from ..video.api import VideoFeatures, VideoPreprocessConfig, fetch_video
from .common import build_model, build_tokenizer, logger, setup_logging

# demo defaults (gradio_demo.py:47,123-124)
DEMO_MAX_PIXELS = 200704
DEMO_DEFAULT_NFRAMES = 32
DEMO_MAX_NEW_TOKENS = 2048


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

    def answer(self, video_path: str, question: str,
               nframes: int = DEMO_DEFAULT_NFRAMES, srt_path: str | None = None,
               max_new_tokens: int = DEMO_MAX_NEW_TOKENS) -> str:
        """A video file (nframes sampled, at most DEMO_MAX_PIXELS a frame;
        srt_path's subtitles burned in) -> the answer."""
        ele = {"video": video_path, "nframes": nframes, "max_pixels": DEMO_MAX_PIXELS}
        if srt_path:
            ele["subtitles"] = srt_path
        feats = fetch_video(ele, VideoPreprocessConfig(write_subtitles=bool(srt_path)))
        res = self.generate(self.prepare(feats, question), max_new_tokens)
        return self.tok.decode(res.sequences[0][: res.lengths[0]],
                               skip_special_tokens=True)


PAGE = """<!doctype html><html><head><title>Video-R2 demo</title></head>
<body style="font-family:sans-serif;max-width:720px;margin:2em auto">
<h2>Video-R2 — single-video QA</h2>
<form method="post">
Video path: <input name="video" size="60" value="{video}"/><br/><br/>
Subtitles (.srt, optional): <input name="srt" size="60" value="{srt}"/><br/><br/>
Frames (1-768): <input name="nframes" type="number" value="{nframes}"/><br/><br/>
Question:<br/><textarea name="question" rows="3" cols="70">{question}</textarea><br/><br/>
<button type="submit">Ask</button>
</form>
<pre style="white-space:pre-wrap;background:#f4f4f4;padding:1em">{answer}</pre>
</body></html>"""


def make_handler(runner: DemoRunner):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def _page(self, **kw):
            defaults = dict(video="", srt="", nframes=DEMO_DEFAULT_NFRAMES,
                            question="", answer="")
            defaults.update(kw)
            body = PAGE.format(**{k: html.escape(str(v))
                                  for k, v in defaults.items()}).encode()
            self.send_response(200)
            self.send_header("Content-Type", "text/html")
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            self._page()

        def do_POST(self):
            length = int(self.headers.get("Content-Length", 0))
            form = urllib.parse.parse_qs(self.rfile.read(length).decode())
            video = form.get("video", [""])[0]
            srt = form.get("srt", [""])[0] or None
            nframes = int(form.get("nframes", [DEMO_DEFAULT_NFRAMES])[0])
            question = form.get("question", [""])[0]
            try:
                answer = runner.answer(video, question, nframes=nframes,
                                       srt_path=srt)
            except Exception as e:  # noqa: BLE001
                answer = f"error: {e}"
            self._page(video=video, srt=srt or "", nframes=nframes,
                       question=question, answer=answer)

    return Handler


def main(argv=None):
    setup_logging()
    argv = list(sys.argv[1:] if argv is None else argv)
    cli, video, question, srt, port = False, "", "", None, 7860
    nframes = DEMO_DEFAULT_NFRAMES
    rest = []
    i = 0
    while i < len(argv):
        a = argv[i]
        if a == "--cli":
            cli = True
            i += 1
        elif a in ("--video", "--question", "--srt", "--port", "--nframes"):
            val = argv[i + 1]
            if a == "--video":
                video = val
            elif a == "--question":
                question = val
            elif a == "--srt":
                srt = val
            elif a == "--port":
                port = int(val)
            else:
                nframes = int(val)
            i += 2
        else:
            rest.append(a)
            i += 1
    app = parse_config(rest)
    model = build_model(app)
    runner = DemoRunner(model, build_tokenizer(app), impl=app.run.attn_impl)
    if cli:
        print(runner.answer(video, question, nframes=nframes, srt_path=srt))
        return
    logger.info("demo UI on :%d", port)
    ThreadingHTTPServer(("0.0.0.0", port), make_handler(runner)).serve_forever()


if __name__ == "__main__":
    main()
