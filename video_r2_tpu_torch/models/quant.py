"""Weight-only int8 and int4 quantization.

Port of ``video_r2_tpu/models/quant.py``. An 8-bit kernel [.., in, out]
becomes int8 ``kernel_q`` plus fp32 ``scale`` [.., out] (absmax over the
input axis / 127, round half to even). A 4-bit kernel [.., K, N] becomes
``kernel_q4`` int8 [.., K/2, N], half-split packed nibbles
(ops/int4_matmul.py), plus fp32 ``scale4`` [.., K/g, N] (absmax over each
group of g rows / 7, q in [-7, 7]). models/layers.py's Linear computes
with every form, ExpertLinear with float and int8. `quantize_params`
rewrites a model in place, module by module: each float kernel is freed as
its quantized copy is built, so the peak stays near the float model plus
one kernel (the reference's consume=True).
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops.int4_matmul import dequant_int4, pack_int4_halves

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


INT4_GROUP_SIZE = 128


def quantize_kernel_int4(w: torch.Tensor, group_size: int = INT4_GROUP_SIZE) -> dict:
    """[.., K, N] -> {"kernel_q4": int8 [.., K/2, N] half-split packed,
    "scale4": fp32 [.., K/g, N]}, symmetric per group of g rows along K."""
    *lead, K, N = w.shape
    g = group_size
    if K % (2 * g):
        raise ValueError(f"int4 needs K = {K} to be a multiple of 2 x group {g}")
    w32 = w.float().reshape(*lead, K // g, g, N)
    scale = torch.clamp(w32.abs().amax(dim=-2, keepdim=True), min=1e-8) / 7.0
    q = torch.clamp(torch.round(w32 / scale), -7, 7).to(torch.int8).reshape(*lead, K, N)
    return {"kernel_q4": pack_int4_halves(q), "scale4": scale[..., 0, :]}


def dequantize_kernel_int4(leaf: dict, dtype=torch.bfloat16,
                           group_size: int = INT4_GROUP_SIZE) -> torch.Tensor:
    return dequant_int4(leaf["kernel_q4"], leaf["scale4"], group_size, dtype)


def _matches(path: tuple, suffixes) -> bool:
    return any(path[-len(s):] == s for s in suffixes)


@torch.no_grad()
def quantize_params(model: nn.Module, include_embedding: bool = False,
                    bits: int = 8, group_size: int = INT4_GROUP_SIZE,
                    extra_suffixes: tuple = ()) -> nn.Module:
    """Quantize every targeted kernel of `model` in place (a module's
    ``kernel`` parameter is replaced by its quantized leaves; biases stay).
    bits=4 uses group-wise int4 where the input dim K permits
    (K % (2 group_size) == 0: the 7B decoder, LM head, ViT attention and
    gate / up, and merger) and int8 elsewhere (the 7B ViT's down
    projection); MoE experts are int8 whatever the bits. include_embedding
    casts the embedding table to bf16. extra_suffixes: more module paths
    to quantize, for model families whose modules are named otherwise (the
    Qwen3-Next judge passes its own). Returns `model`."""
    if bits not in (4, 8):
        raise ValueError(f"bits must be 4 or 8, got {bits}")
    suffixes = QUANT_SUFFIXES + MOE_SUFFIXES + tuple(extra_suffixes)
    for name, mod in model.named_modules():
        w = getattr(mod, "kernel", None)
        path = tuple(name.split(".")) + ("kernel",)
        if not isinstance(w, nn.Parameter) or not _matches(path, suffixes):
            continue
        if (bits == 4 and not _matches(path, MOE_SUFFIXES)
                and w.shape[-2] % (2 * group_size) == 0):
            leaf = quantize_kernel_int4(w, group_size)
        else:
            leaf = quantize_kernel(w)
        mod.kernel = None          # the float kernel goes before the next one is read
        del w
        for key, val in leaf.items():
            setattr(mod, key, nn.Parameter(val, requires_grad=False))
    if include_embedding:
        emb = model.model.embed_tokens
        emb.embedding = nn.Parameter(emb.embedding.to(torch.bfloat16), requires_grad=False)
    return model


@torch.no_grad()
def init_params_quantized_zeros(cfg, bits: int = 8, group_size: int = INT4_GROUP_SIZE,
                                device="cuda") -> nn.Module:
    """A frozen model of `cfg` whose targeted kernels are quantized zeros
    (int8 0 with scale 1e-8; int4 nibbles that decode to 0) and whose other
    parameters are bf16 zeros, in the layout `quantize_params(bits=)`
    gives (the reference's init_params_quantized_zeros). Built on the meta
    device first, so no float kernel is ever allocated: the peak is the
    final footprint. For benchmarks of speed and memory: every logit is
    equal."""
    from .model import Qwen25VL

    if bits not in (4, 8):
        raise ValueError(f"bits must be 4 or 8, got {bits}")
    model = Qwen25VL(cfg, dtype=torch.bfloat16, device="meta")
    fills = {}
    for name, mod in model.named_modules():
        w = getattr(mod, "kernel", None)
        path = tuple(name.split(".")) + ("kernel",)
        if not isinstance(w, nn.Parameter) or not _matches(path, QUANT_SUFFIXES
                                                            + MOE_SUFFIXES):
            continue
        *lead, K, N = w.shape
        if bits == 4 and not _matches(path, MOE_SUFFIXES) and K % (2 * group_size) == 0:
            # packed zeros decode to q = 0: nibble value 8 in both halves
            leaves = {"kernel_q4": ((*lead, K // 2, N), torch.int8, (8 | 8 << 4) - 256),
                      "scale4": ((*lead, K // group_size, N), torch.float32, 1e-8)}
        else:
            leaves = {"kernel_q": ((*lead, K, N), torch.int8, 0),
                      "scale": ((*lead, N), torch.float32, 1e-8)}
        mod.kernel = None
        for key, (shape, dt, value) in leaves.items():
            setattr(mod, key, nn.Parameter(torch.empty(shape, dtype=dt, device="meta"),
                                           requires_grad=False))
            fills[f"{name}.{key}"] = value
    model.to_empty(device=device)
    model.requires_grad_(False)
    for name, p in model.named_parameters():
        p.fill_(fills.get(name, 0))
    return model
