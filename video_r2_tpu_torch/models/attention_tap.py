"""Attention tap: last-layer attention mass from generated tokens to video
tokens.

Port of ``video_r2_tpu/models/attention_tap.py``: the paper's quantitative
VAS ("mean attention of generated tokens over video tokens, last layer,
averaged across heads"). The flash and paged kernels never form
probabilities, so this runs the decoder layers [0, L-1) as the model does
(attn_impl "flash" through the flash kernel, which forms no [S, S] matrix)
and then only the last layer's attention, as torch ops over a trailing
window of query rows (the generated tokens), with the keys streamed in
fixed chunks through an online softmax: peak memory is
O(W x key_chunk x heads), never [S, S].
"""

from __future__ import annotations

import torch

from .decoder import causal_mask_bias
from .layers import apply_rotary
from .model import Qwen25VL, embed_inputs, merge_vision_embeddings
from .mrope import mrope_cos_sin

NEG_INF = -1e30


@torch.inference_mode()
def attention_to_video_scores(
    model: Qwen25VL,
    input_ids,                     # [B, S] full prompt + completion sequence
    position_ids,                  # [3, B, S]
    attention_mask,                # [B, S] 1 = valid
    query_mask,                    # [B, S] 1 = generated-token queries
    video_mask=None,               # [B, S] 1 = video keys (default: video pads)
    video_embeds=None,             # [N, H] merged ViT outputs
    video_patches=None,
    video_layout=None,
    completion_window: int | None = None,   # query rows = the last W columns
    key_chunk: int = 2048,         # online-softmax key chunk
    attn_impl: str = "xla",        # "flash": layers [0, L-1) (and the ViT of
                                   # video_patches) through the kernels
) -> torch.Tensor:
    """[B] fp32 mean (over generated tokens and heads) attention mass on
    video tokens in the LAST decoder layer."""
    cfg, tcfg = model.cfg, model.cfg.text
    device = model.device
    as_t = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    input_ids, position_ids = as_t(input_ids).long(), as_t(position_ids).long()
    attention_mask, query_mask = as_t(attention_mask), as_t(query_mask)
    video_mask = (input_ids == cfg.video_token_id if video_mask is None
                  else as_t(video_mask))
    if video_embeds is not None:
        h = merge_vision_embeddings(input_ids, model.model.embed_tokens(input_ids),
                                    as_t(video_embeds), cfg.video_token_id)
    else:
        h = embed_inputs(model, input_ids,
                         as_t(video_patches) if video_patches is not None else None,
                         video_layout, "auto" if attn_impl == "flash" else "xla")
    cos, sin = mrope_cos_sin(position_ids, cfg, dtype=h.dtype)

    # layers [0, L-1), keeping the raw residual stream (no final norm)
    B, S, _ = h.shape
    *head, last = model.model.layers
    if attn_impl == "flash":
        kw = dict(bias=None, attn_impl="flash", causal=True,
                  kv_lengths=attention_mask.sum(-1).int())
    else:
        kw = dict(bias=causal_mask_bias(S, attention_mask, device))
    x = h
    for layer in head:
        x = layer(x, cos, sin, **kw)

    # the last layer's probabilities, streamed: queries are the trailing
    # window of W rows, keys go in chunks with flash-style (m, l, n)
    # accumulation, n carrying the video-mask-weighted numerator
    nh, kh, hd = tcfg.num_attention_heads, tcfg.num_key_value_heads, tcfg.head_dim
    g = nh // kh
    W = S if completion_window is None else min(completion_window, S)
    attn = last.attn
    hn = last.input_layernorm(x)
    q = attn.q(hn[:, S - W:]).reshape(B, W, nh, hd)
    k = attn.k(hn).reshape(B, S, kh, hd)
    if tcfg.qk_norm:
        q, k = attn.q_norm(q), attn.k_norm(k)
    # queries take the window's cos / sin rows, keys the whole sequence's
    q, _ = apply_rotary(q, q, cos[:, S - W:, None, :], sin[:, S - W:, None, :])
    _, k = apply_rotary(k, k, cos[:, :, None, :], sin[:, :, None, :])
    qg = q.reshape(B, W, kh, g, hd).float()
    scale = hd ** -0.5
    valid, vmask = attention_mask.bool(), video_mask.float()
    abs_q = (S - W) + torch.arange(W, device=device)          # absolute query rows
    m = torch.full((B, kh, g, W), NEG_INF, dtype=torch.float32, device=device)
    l = torch.zeros_like(m)
    n = torch.zeros_like(m)
    for c0 in range(0, S, min(key_chunk, S)):
        c1 = min(c0 + key_chunk, S)
        s = torch.einsum("bwhgd,bkhd->bhgwk", qg, k[:, c0:c1].float()) * scale
        jpos = torch.arange(c0, c1, device=device)
        allowed = (jpos[None, None, :] <= abs_q[None, :, None]) & valid[:, None, c0:c1]
        s = torch.where(allowed[:, None, None], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(-1)
        n = n * alpha + torch.einsum("bhgwk,bk->bhgw", p, vmask[:, c0:c1])
        m = m_new
    vmass = (n / torch.clamp(l, min=1e-30)).mean(dim=(1, 2))  # over heads -> [B, W]
    qm = query_mask[:, S - W:].float()
    return (vmass * qm).sum(-1) / torch.clamp(qm.sum(-1), min=1.0)
