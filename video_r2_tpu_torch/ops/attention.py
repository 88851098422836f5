"""Attention dispatch: the plain masked path and the flash kernel.

Port of ``video_r2_tpu/ops/attention.py::dot_product_attention``: prefill
(Sq > 8 with kv_lengths) under impl="flash" goes to ops/flash.py; everything
else, single-token decode included, runs `plain_attention`, the port of the
JAX package's XLA path (fp32 scores and softmax, GQA by reshape, probs cast
to v's dtype before P @ V). `quant_dot_product_attention` is the port of
the JAX package's int8-KV attention (an XLA op there, torch ops here).
"""

from __future__ import annotations

import torch

NEG_INF = -1e30


def dot_product_attention(
    q: torch.Tensor,            # [B, Sq, num_heads, head_dim]
    k: torch.Tensor,            # [B, Skv, kv_heads, head_dim]
    v: torch.Tensor,
    bias: torch.Tensor | None = None,        # [B, 1, Sq, Skv] additive
    kv_lengths: torch.Tensor | None = None,  # [B] prefix-valid keys
    causal: bool = False,
    segment_ids: torch.Tensor | None = None,  # [B, S] (flash path, Sq == Sk)
    impl: str = "xla",
) -> torch.Tensor:
    """GQA attention, fp32 accumulation. Returns [B, Sq, num_heads, head_dim].
    impl="xla" names the plain path, as in the JAX package. segment_ids
    (with kv_lengths, no bias) admit key j for query i only within one
    segment, on the flash path and on the plain path it falls back to."""
    if impl not in ("xla", "flash"):
        raise ValueError(f"unknown attention impl {impl!r}")
    if impl == "flash" and kv_lengths is not None and q.shape[1] > 8:
        from .flash import flash_attention

        return flash_attention(q, k, v, kv_lengths=kv_lengths, causal=causal,
                               segment_ids=segment_ids)
    if bias is None and kv_lengths is not None:
        Sq, Sk = q.shape[1], k.shape[1]
        j = torch.arange(Sk, device=q.device)[None, :]
        allowed = j[None] < kv_lengths.to(q.device)[:, None, None]
        if causal:
            i = torch.arange(Sq, device=q.device)[:, None]
            allowed = allowed & (j <= i)[None]
        if segment_ids is not None:
            allowed = allowed & (segment_ids[:, :, None] == segment_ids[:, None, :])
        bias = torch.where(allowed[:, None], 0.0, NEG_INF)
    return plain_attention(q, k, v, bias)


def plain_attention(q, k, v, bias):
    B, Sq, nh, hd = q.shape
    kh = k.shape[2]
    qg = q.reshape(B, Sq, kh, nh // kh, hd)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float()) * hd ** -0.5
    if bias is not None:
        scores = scores + bias[:, :, None].float()
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v)
    return out.reshape(B, Sq, nh, hd)


def quant_dot_product_attention(q, k_q, k_scale, v_q, v_scale, bias):
    """GQA attention over an int8 cache: q [B, Sq, nh, hd], k_q / v_q int8
    [B, Skv, kh, hd] with fp32 per-row scales [B, Skv, kh], bias [B, 1, Sq,
    Skv] additive. The scales factor out of both products, q . (k_q s_k) =
    (q . k_q) s_k and sum p (v_q s_v) = sum (p s_v) v_q, so they apply to the
    fp32 scores and to the probabilities, not to the values. The int8
    values convert exactly, but into copies: an fp32 copy of k_q for the
    scores (4 bytes an element) and a copy of v_q in q's dtype for P @ V,
    as the reference's operands, formed on every call."""
    B, Sq, nh, hd = q.shape
    kh = k_q.shape[2]
    qg = q.reshape(B, Sq, kh, nh // kh, hd)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k_q.float()) * hd ** -0.5
    scores = scores * k_scale.transpose(1, 2)[:, :, None, None, :]
    scores = scores + bias[:, :, None].float()
    probs = torch.softmax(scores, dim=-1)
    probs = (probs * v_scale.transpose(1, 2)[:, :, None, None, :]).to(q.dtype)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v_q.to(q.dtype))
    return out.reshape(B, Sq, nh, hd)
