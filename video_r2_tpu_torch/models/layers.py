"""Shared building blocks: linear, RMSNorm, SwiGLU MLP, rotary.

Port of the float path of ``video_r2_tpu/models/layers.py``. Numerics match
HF Qwen2: RMSNorm in fp32 with cast-back-before-scale, gated SiLU MLP,
rotate-half rotary applied in fp32. Linear weights keep the JAX layout
``kernel [in, out]`` so parameters carry across unchanged
(models/convert.py). LoRA adapters attach in the JAX "attach" form
(train/lora.py); the int8 / int4 branches are not ported yet.
"""

from __future__ import annotations

import torch
from torch import nn


def _param(*shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device))


class Linear(nn.Module):
    """y = x @ kernel (+ bias), kernel [in, out].

    With LoRA adapters attached (fp32 ``lora_a`` [in, r], ``lora_b``
    [r, out], set by train/lora.py::attach_lora) it computes
    y = x @ kernel + (x @ A) @ (B * lora_scale) (+ bias), the adapters cast
    to x's dtype, as the JAX package's attach form: the kernel is never
    touched and W + AB is never formed."""

    def __init__(self, d_in: int, d_out: int, bias: bool, *, dtype, device):
        super().__init__()
        self.kernel = _param(d_in, d_out, dtype=dtype, device=device)
        self.bias = _param(d_out, dtype=dtype, device=device) if bias else None
        self.lora_a: nn.Parameter | None = None
        self.lora_b: nn.Parameter | None = None
        self.lora_scale = 1.0

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.matmul(x, self.kernel)
        if self.lora_a is not None:
            b = (self.lora_b * self.lora_scale).to(x.dtype)
            y = y + torch.matmul(torch.matmul(x, self.lora_a.to(x.dtype)), b)
        if self.bias is not None:
            y = y + self.bias
        return y


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float, *, dtype, device):
        super().__init__()
        self.eps = eps
        self.scale = _param(dim, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return rms_norm(self.scale, x, self.eps)


class MLP(nn.Module):
    """down(silu(gate(x)) * up(x)) — Qwen2MLP / Qwen2_5_VLMLP."""

    def __init__(self, dim: int, hidden: int, bias: bool, *, dtype, device):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.gate = Linear(dim, hidden, bias, **kw)
        self.up = Linear(dim, hidden, bias, **kw)
        self.down = Linear(hidden, dim, bias, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.down(torch.nn.functional.silu(self.gate(x)) * self.up(x))


def rms_norm(scale: torch.Tensor, x: torch.Tensor, eps: float) -> torch.Tensor:
    """HF Qwen2RMSNorm: fp32 variance, cast back to input dtype, then scale."""
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    normed = (x32 * torch.rsqrt(var + eps)).to(x.dtype)
    return scale * normed


def rotate_half(x: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def apply_rotary(q: torch.Tensor, k: torch.Tensor, cos: torch.Tensor,
                 sin: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Apply rotary embedding in fp32, preserving input dtype.
    cos/sin broadcast against q/k (already expanded by the caller)."""
    cos32, sin32 = cos.float(), sin.float()
    q32, k32 = q.float(), k.float()
    q_out = q32 * cos32 + rotate_half(q32) * sin32
    k_out = k32 * cos32 + rotate_half(k32) * sin32
    return q_out.to(q.dtype), k_out.to(k.dtype)


def rotary_inv_freq(dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim
    return 1.0 / (theta ** exps)
