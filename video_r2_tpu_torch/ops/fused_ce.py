"""Chunked fused linear + cross-entropy.

Port of ``video_r2_tpu/ops/fused_ce.py``: the loss walks the tokens in
chunks; each chunk's logits are formed in fp32 and reduced to (logsumexp,
label logit), and the backward recomputes the chunk's softmax, so peak
memory is O(chunk x V), never [N, V]. Loss semantics match torch CE with
ignore_index=-100 and mean reduction over non-ignored tokens. The JAX op
always forms the fp32 [H, V] weight gradient; here it is formed only when
the head trains (``ctx.needs_input_grad``), so a frozen head (LoRA) costs
no [H, V] buffer beyond the fp32 weight. Not a Pallas kernel in the JAX
package: the chunk products stay ``torch.matmul``.
"""

from __future__ import annotations

import torch

IGNORE_INDEX = -100


def fused_linear_cross_entropy(hidden: torch.Tensor,   # [N, H]
                               weight: torch.Tensor,   # [H, V]
                               labels: torch.Tensor,   # [N] int, IGNORE_INDEX skips
                               chunk_size: int = 1024) -> torch.Tensor:
    """Mean CE over non-ignored tokens (0 when all are ignored)."""
    return _FusedLinearCE.apply(hidden, weight, labels, chunk_size)


class _FusedLinearCE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, hidden, weight, labels, chunk_size):
        w32 = weight.float()
        valid = labels != IGNORE_INDEX
        count = valid.sum().clamp(min=1).float()
        total = torch.zeros((), dtype=torch.float32, device=hidden.device)
        for c0 in range(0, hidden.shape[0], chunk_size):
            logits = hidden[c0:c0 + chunk_size].float() @ w32
            lab, ok = labels[c0:c0 + chunk_size], valid[c0:c0 + chunk_size]
            ll = logits.gather(1, torch.where(ok, lab, 0).long()[:, None])[:, 0]
            total = total + torch.where(ok, torch.logsumexp(logits, -1) - ll, 0.0).sum()
        ctx.save_for_backward(hidden, weight, labels)
        ctx.chunk_size = chunk_size
        return total / count

    @staticmethod
    def backward(ctx, grad):
        hidden, weight, labels = ctx.saved_tensors
        want_dh, want_dw = ctx.needs_input_grad[0], ctx.needs_input_grad[1]
        w32 = weight.float()
        valid = labels != IGNORE_INDEX
        inv = grad.float() / valid.sum().clamp(min=1).float()
        dh = torch.empty_like(hidden) if want_dh else None
        dw = torch.zeros_like(w32) if want_dw else None
        for c0 in range(0, hidden.shape[0], ctx.chunk_size):
            h32 = hidden[c0:c0 + ctx.chunk_size].float()
            lab, ok = (labels[c0:c0 + ctx.chunk_size],
                       valid[c0:c0 + ctx.chunk_size])
            dlogits = torch.softmax(h32 @ w32, dim=-1)
            rows = torch.arange(dlogits.shape[0], device=dlogits.device)
            dlogits[rows, torch.where(ok, lab, 0).long()] -= 1.0
            dlogits *= (ok.float() * inv)[:, None]
            if want_dh:
                dh[c0:c0 + ctx.chunk_size] = (dlogits @ w32.T).to(hidden.dtype)
            if want_dw:
                dw += h32.T @ dlogits
        return dh, dw.to(weight.dtype) if want_dw else None, None, None

