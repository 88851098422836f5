"""One-token batch decode attention over the head-major stacked KV cache.

Port of ``video_r2_tpu/ops/decode_attention.py``. The cache is head-major,
[L, B, kh, Smax, hd] (models/decoder.py::DecodeKVCache), so one (layer,
sequence, kv head) is a contiguous [Smax, hd] run, read in blocks of
`BLOCK_S` rows; Smax is a multiple of BLOCK_S (engine/generate.py pads the
cache). The mask is the batch-generate layout's: prompt keys [0, len_b)
(right-padded prompts, true length per sequence) and the fixed decode slots
[s_pad, slot_end], the same for the whole batch; slot_end < s_pad turns the
window off.

`decode_attention_stacked` replaces ``_decode_kernel`` (the TPU kernel
behind the JAX ``decode_attention_stacked``). On CUDA tensors it launches
``csrc/decode_attn.cu`` (bf16 or fp32, one type for q and the cache; bf16
at head dims 64 and 128, fp32 at any head dim up to 128, the instance
picked by `split.decode_kernel_instance`; up to 16 query heads per kv
head; each sequence's keys
split across blocks by `split.decode_split_plan` where B kh blocks do not
fill the card, one launch a call) and raises on anything it does not take;
on CPU tensors it runs `decode_attention_stacked_plain`: fp32 scores over
the layer's whole cache, the same mask (masked scores -1e30, as the TPU
kernel's), fp32 softmax and P @ V.
"""

from __future__ import annotations

import torch

from .cuda_build import check, kernels
from .split import (
    SPLIT_TILE,
    decode_kernel_instance,
    decode_splits,
    split_width,
    split_workspace,
)

NEG_INF = -1e30
BLOCK_S = 128
KERNEL_MAX_GROUP = 16     # query heads per kv head one block holds


def decode_attention_stacked(q: torch.Tensor, k_cache: torch.Tensor,
                             v_cache: torch.Tensor, lengths: torch.Tensor,
                             slot_end: int, layer: int, s_pad: int) -> torch.Tensor:
    """Attention of the decode token q [B, nh, hd] over layer `layer` of
    the stacked head-major cache k_cache / v_cache [L, B, kh, Smax, hd]:
    keys [0, lengths[b]) and [s_pad, slot_end]. Returns [B, nh, hd] in q's
    dtype."""
    if q.device.type == "cpu":
        return decode_attention_stacked_plain(q, k_cache, v_cache, lengths, slot_end,
                                              layer, s_pad)
    out = _decode_cuda(q, k_cache, v_cache, lengths, slot_end, layer, s_pad)
    decode_attention_stacked.launches += 1
    return out


decode_attention_stacked.launches = 0   # kernel launches (CUDA only)


def decode_attention_stacked_plain(q, k_cache, v_cache, lengths, slot_end: int,
                                   layer: int, s_pad: int) -> torch.Tensor:
    """Dense PyTorch version of the kernel on any device."""
    B, nh, hd = q.shape
    kh, smax = k_cache.shape[2], k_cache.shape[3]
    k, v = k_cache[layer].float(), v_cache[layer].float()       # [B, kh, Smax, hd]
    qg = q.float().reshape(B, kh, nh // kh, hd) * hd ** -0.5
    s = torch.einsum("bhgd,bhkd->bhgk", qg, k)
    kpos = torch.arange(smax, device=q.device)
    valid = ((kpos[None] < lengths.to(q.device).long()[:, None])
             | ((kpos >= s_pad) & (kpos <= slot_end))[None])   # [B, Smax]
    s = torch.where(valid[:, None, None], s, NEG_INF)
    o = torch.einsum("bhgk,bhkd->bhgd", torch.softmax(s, dim=-1), v)
    return o.reshape(B, nh, hd).to(q.dtype)


def _decode_cuda(q, k_cache, v_cache, lengths, slot_end, layer, s_pad):
    """Check the operands and launch csrc/decode_attn.cu."""
    if q.dim() != 3 or k_cache.dim() != 5:
        raise ValueError(f"decode kernel: q [B, nh, hd] and cache [L, B, kh, Smax, hd], "
                         f"got {tuple(q.shape)} and {tuple(k_cache.shape)}")
    B, nh, hd = q.shape
    L, Bc, kh, smax, hdc = k_cache.shape
    if Bc != B or hdc != hd or v_cache.shape != k_cache.shape:
        raise ValueError(f"decode kernel: caches {tuple(k_cache.shape)} / "
                         f"{tuple(v_cache.shape)} do not fit q {tuple(q.shape)}")
    decode_kernel_instance(q.dtype, hd)
    if nh % kh or nh // kh > KERNEL_MAX_GROUP:
        raise ValueError(f"decode kernel: {nh} query heads over {kh} kv heads; needs kv "
                         f"heads dividing query heads and at most {KERNEL_MAX_GROUP} "
                         f"per kv head")
    if smax % BLOCK_S:
        raise ValueError(f"decode kernel: cache width {smax} is not a multiple of "
                         f"{BLOCK_S}")
    if not 0 <= layer < L:
        raise ValueError(f"decode kernel: layer {layer} of {L}")
    dev = q.device
    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache)):
        if t.device != dev:
            raise ValueError(f"decode kernel: {name} on {t.device}, q on {dev}")
        if t.dtype != q.dtype:
            raise TypeError(f"decode kernel: {name} must be {q.dtype} as q is, got "
                            f"{t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"decode kernel: {name} must be contiguous")
    lens = lengths.to(device=dev, dtype=torch.int32).contiguous()
    if lens.shape != (B,):
        raise ValueError(f"decode kernel: lengths {tuple(lens.shape)} must be [{B}]")
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(dev).cuda_stream
    S = decode_splits(B * kh, smax // SPLIT_TILE, dev.index)
    part = counters = None
    if S > 1:
        part, counters = split_workspace(dev, stream,
                                         B * kh * S * (nh // kh) * (split_width(hd) + 2),
                                         B * kh)
    err = kernels().vr2_decode_attention(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), out.data_ptr(),
        lens.data_ptr(), B, nh, kh, hd, L, smax, int(layer), int(s_pad), int(slot_end),
        q.element_size(), S, hd ** -0.5, None if part is None else part.data_ptr(),
        None if counters is None else counters.data_ptr(), stream)
    check(err, "decode attention kernel")
    return out
