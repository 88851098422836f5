"""Shared app bootstrap: the model, tokenizer and mesh from an AppConfig.

Port of ``video_r2_tpu/apps/common.py``. `build_model` builds the preset
with seeded random weights on the card (``device``, "cuda" unless the caller
asks for another), a Qwen25VL or, for the Qwen3-Next preset, a Qwen3Next
(models/qwen3_next.py), and quantizes it in place for ``run.weight_quant``
(models/quant.py). Loading an HF checkpoint or a BPE tokenizer waits for the
HF loader port (ROADMAP Queue 1 #9), and a mesh for the parallelism port
(Queue 1 #8): each raises.
"""

from __future__ import annotations

import logging

import torch

from ..config import AppConfig
from ..engine.chat import (
    IM_END,
    IM_START,
    IMAGE_PAD,
    VIDEO_PAD,
    VISION_END,
    VISION_START,
    ByteTokenizer,
)
from ..models.loader import init_params
from ..models.qwen3_next import (
    init_qwen3_next_params,
    is_qwen3_next_config,
    quantize_qwen3_next_params,
)
from ..models.quant import quantize_params

logger = logging.getLogger("video_r2_tpu_torch")


def setup_logging():
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s %(message)s")


def build_model(app: AppConfig, device: str | torch.device = "cuda"):
    """The preset's model (Qwen25VL, or Qwen3Next for the Next preset) with
    seeded weights on `device`; weight_quant
    "int8" / "int4" quantizes it in place (weight-only). A CUDA device that
    is not there raises: the entry points never fall back to the CPU."""
    cfg = app.model_config()
    wq = app.run.weight_quant
    if wq not in ("", None, "int8", "int4"):
        # a typo ('in8', 'int_4') would otherwise silently load int8
        raise ValueError(
            f"run.weight_quant must be '', 'int8', or 'int4' (got {wq!r})")
    if app.run.checkpoint:
        raise NotImplementedError("loading HF weights waits for the HF loader port "
                                  "(ROADMAP Queue 1 #9)")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the model is built on the card, and no CUDA device is "
                           "available (a caller that wants the CPU builds its own "
                           "model and passes it in)")
    bits = 4 if wq == "int4" else 8
    if is_qwen3_next_config(cfg):
        model = init_qwen3_next_params(cfg, seed=app.run.seed, device=device)
        if wq:
            quantize_qwen3_next_params(model, bits=bits)
    else:
        model = init_params(cfg, seed=app.run.seed, dtype=cfg.dtype, device=device)
        if wq:
            quantize_params(model, bits=bits)
    logger.warning("no checkpoint given - seeded random weights%s",
                   f" ({wq} weight-only)" if wq else "")
    return model


def build_tokenizer(app: AppConfig):
    """The byte tokenizer. A preset whose vocabulary stops below the Qwen
    special ids (tiny-test) gets the config's own special ids, and <|im_start|>
    the first id past the bytes, so that every id it emits has an embedding
    row (the JAX package's gather clamps such ids; an index here raises)."""
    if app.run.tokenizer:
        raise NotImplementedError("the BPE tokenizer waits for the HF loader port "
                                  "(ROADMAP Queue 1 #9)")
    cfg = app.model_config()
    if is_qwen3_next_config(cfg) or cfg.text.vocab_size > max(ByteTokenizer.SPECIALS.values()):
        return ByteTokenizer()
    return ByteTokenizer({
        "<|endoftext|>": cfg.pad_token_id, IM_START: 256, IM_END: cfg.eos_token_id,
        VISION_START: cfg.vision_start_token_id, VISION_END: cfg.vision_end_token_id,
        IMAGE_PAD: cfg.image_token_id, VIDEO_PAD: cfg.video_token_id})


def build_mesh(app: AppConfig):
    """None for one device; a mesh raises until the parallelism port."""
    r = app.run
    if r.dp * r.pp * r.fsdp * r.sp * r.ep * r.tp <= 1:
        return None
    raise NotImplementedError("a device mesh waits for the parallelism port "
                              "(ROADMAP Queue 1 #8)")
