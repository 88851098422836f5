"""Random initialisation of the full model on a device.

`init_params` builds the same parameter tree, with the same shapes, as
``video_r2_tpu/models/loader.py::init_params`` (the MoE, qk-norm and
bias-free judge tree included, no vision tower for text-only configs):
weights normal with scale 1/sqrt(fan_in) (embedding and LM head 0.02), norms
ones, biases zeros. The draws come from a ``torch.Generator`` on the target
device, directly in the model's dtype, so the 30.5 B-parameter judge
initialises on the card in seconds. (The JAX initialiser divides stacked
weights by their leading axis, the layer count; here fan_in is the weight's
input width: H for the router and gate / up experts, I for down.) Loading HF
checkpoints comes with the loader port.
"""

from __future__ import annotations

import math

import torch

from .config import ModelConfig
from .model import Qwen25VL

@torch.no_grad()
def init_params(cfg: ModelConfig, seed: int = 0, dtype=None,
                device: str | torch.device = "cuda") -> Qwen25VL:
    """A frozen Qwen25VL with seeded random weights, built directly on
    `device` (the card unless the caller asks for the CPU).
    dtype: a torch dtype or its name ("bfloat16"); default cfg.dtype."""
    dtype = dtype or cfg.dtype
    if isinstance(dtype, str):
        dtype = getattr(torch, dtype)
    device = torch.device(device)
    model = Qwen25VL(cfg, dtype=dtype, device=device)
    model.requires_grad_(False)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "scale":
            p.fill_(1.0)
        elif leaf == "bias":
            p.zero_()
        elif leaf == "embedding" or name == "lm_head.kernel":
            p.normal_(0.0, 0.02, generator=gen)
        else:
            p.normal_(0.0, 1.0 / math.sqrt(p.shape[-2]), generator=gen)
    return model


def param_count(model: torch.nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())
