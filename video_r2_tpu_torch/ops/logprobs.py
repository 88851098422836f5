"""Chunked per-token log-probabilities (selective log-softmax).

Port of ``video_r2_tpu/ops/logprobs.py``: GRPO needs log p(token) of every
completion token under the policy, the old policy and the reference. At a
152k vocabulary the [N, V] logits are the memory wall, so the rows go in
chunks: each chunk's logits are formed in fp32 (divided by the
temperature) and reduced to logsumexp and the token's logit, and the
backward recomputes the chunk's softmax, so no [N, V] buffer is ever
formed. The backward forms dh, and the fp32 [H, V] weight gradient only
when the head trains (``ctx.needs_input_grad``), as ops/fused_ce.py does;
the JAX op always forms it. Not a Pallas kernel in the JAX package (a
``lax.scan`` of XLA products): the chunk products stay ``torch.matmul``.
"""

from __future__ import annotations

import torch


def chunked_token_logprobs(hidden: torch.Tensor,   # [N, H]
                           weight: torch.Tensor,   # [H, V]
                           tokens: torch.Tensor,   # [N] int
                           temperature: float = 1.0,
                           chunk_size: int = 1024) -> torch.Tensor:
    """log softmax(h @ W / temperature)[token] per row -> [N] fp32."""
    return _ChunkedTokenLogprobs.apply(hidden, weight, tokens, temperature, chunk_size)


class _ChunkedTokenLogprobs(torch.autograd.Function):
    @staticmethod
    def forward(ctx, hidden, weight, tokens, temperature, chunk_size):
        w32 = weight.float()
        tok = tokens.long()
        out = torch.empty(hidden.shape[0], dtype=torch.float32, device=hidden.device)
        for c0 in range(0, hidden.shape[0], chunk_size):
            logits = (hidden[c0:c0 + chunk_size].float() @ w32) / temperature
            ll = logits.gather(1, tok[c0:c0 + chunk_size, None])[:, 0]
            out[c0:c0 + chunk_size] = ll - torch.logsumexp(logits, -1)
        ctx.save_for_backward(hidden, weight, tokens)
        ctx.temperature, ctx.chunk_size = temperature, chunk_size
        return out

    @staticmethod
    def backward(ctx, grad):
        hidden, weight, tokens = ctx.saved_tensors
        want_dh, want_dw = ctx.needs_input_grad[0], ctx.needs_input_grad[1]
        T, n = ctx.temperature, ctx.chunk_size
        w32 = weight.float()
        tok = tokens.long()
        dh = torch.empty_like(hidden) if want_dh else None
        dw = torch.zeros_like(w32) if want_dw else None
        for c0 in range(0, hidden.shape[0], n):
            h32 = hidden[c0:c0 + n].float()
            # d logp / d logits = onehot - softmax, times g / T
            dlogits = -torch.softmax((h32 @ w32) / T, dim=-1)
            rows = torch.arange(dlogits.shape[0], device=dlogits.device)
            dlogits[rows, tok[c0:c0 + n]] += 1.0
            dlogits *= (grad[c0:c0 + n].float() / T)[:, None]
            if want_dh:
                dh[c0:c0 + n] = (dlogits @ w32.T).to(hidden.dtype)
            if want_dw:
                dw += h32.T @ dlogits
        return dh, dw.to(weight.dtype) if want_dw else None, None, None, None
