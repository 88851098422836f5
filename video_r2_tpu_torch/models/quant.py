"""Weight-only int8 quantization (per-output-channel scales).

Port of the 8-bit part of ``video_r2_tpu/models/quant.py``. A quantized
kernel [.., in, out] becomes int8 ``kernel_q`` plus fp32 ``scale`` [.., out]
(absmax over the input axis / 127, round half to even); models/layers.py's
Linear and ExpertLinear compute with either form. `quantize_params` rewrites
a model in place, module by module: each float kernel is freed as its int8
copy is built, so the peak stays near the float model plus one kernel (the
reference's consume=True). int4 waits for the int4 kernel.
"""

from __future__ import annotations

import torch
from torch import nn

QUANT_SUFFIXES = (
    ("attn", "q", "kernel"), ("attn", "k", "kernel"), ("attn", "v", "kernel"),
    ("attn", "o", "kernel"), ("mlp", "gate", "kernel"), ("mlp", "up", "kernel"),
    ("mlp", "down", "kernel"), ("attn", "qkv", "kernel"),
    ("attn", "proj", "kernel"), ("fc1", "kernel"), ("fc2", "kernel"),
    ("lm_head", "kernel"),
)

# MoE expert FFNs (models/moe.py): int8 weight-only whatever the bits
MOE_SUFFIXES = (
    ("experts", "gate", "kernel"), ("experts", "up", "kernel"),
    ("experts", "down", "kernel"),
)


def quantize_kernel(w: torch.Tensor) -> dict:
    """[.., in, out] -> {"kernel_q": int8, "scale": fp32 [.., out]}."""
    w32 = w.float()
    scale = torch.clamp(w32.abs().amax(dim=-2, keepdim=True), min=1e-8) / 127.0
    q = torch.clamp(torch.round(w32 / scale), -127, 127).to(torch.int8)
    return {"kernel_q": q, "scale": scale[..., 0, :]}


def dequantize_kernel(leaf: dict, dtype=torch.bfloat16) -> torch.Tensor:
    return (leaf["kernel_q"].float() * leaf["scale"][..., None, :]).to(dtype)


def _matches(path: tuple, suffixes) -> bool:
    return any(path[-len(s):] == s for s in suffixes)


@torch.no_grad()
def quantize_params(model: nn.Module, include_embedding: bool = False,
                    bits: int = 8) -> nn.Module:
    """Quantize every targeted kernel of `model` in place (a module's
    ``kernel`` parameter is replaced by ``kernel_q`` and ``scale``; biases
    stay). include_embedding casts the embedding table to bf16. Returns
    `model`."""
    if bits != 8:
        raise NotImplementedError("int4 weights are not ported to the PyTorch "
                                  "package yet (they come with the int4 kernel)")
    for name, mod in model.named_modules():
        w = getattr(mod, "kernel", None)
        path = tuple(name.split(".")) + ("kernel",)
        if not isinstance(w, nn.Parameter) or not _matches(path, QUANT_SUFFIXES
                                                            + MOE_SUFFIXES):
            continue
        leaf = quantize_kernel(w)
        mod.kernel = None          # the float kernel goes before the next one is read
        del w
        mod.kernel_q = nn.Parameter(leaf["kernel_q"], requires_grad=False)
        mod.scale = nn.Parameter(leaf["scale"], requires_grad=False)
    if include_embedding:
        emb = model.model.embed_tokens
        emb.embedding = nn.Parameter(emb.embedding.to(torch.bfloat16), requires_grad=False)
    return model
