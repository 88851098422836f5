"""Shared building blocks: linear, RMSNorm, SwiGLU MLP, rotary.

Port of ``video_r2_tpu/models/layers.py``. Numerics match HF Qwen2: RMSNorm
in fp32 with cast-back-before-scale, gated SiLU MLP, rotate-half rotary
applied in fp32. Linear weights keep the JAX layout ``kernel [in, out]`` so
parameters carry across unchanged (models/convert.py). LoRA adapters attach
in the JAX "attach" form (train/lora.py). After models/quant.py a linear
holds int8 ``kernel_q`` and fp32 per-output-channel ``scale``: weight-only
it goes through ops/int8_matmul.py::quantized_linear_auto, as the
reference's linear does (1 to INT8_KERNEL_MAX_ROWS rows through the int8
kernel, more converted to x's dtype and multiplied with torch.matmul); with
act_quant="int8" it runs W8A8, per-token int8 activations times the int8
kernel in int32. The reference leaves that product to XLA; on the card it
goes to
``torch._int_mm`` (a cuBLASLt int8 GEMM, the one library product the port
calls: it is a plain matrix product outside any kernel of the reference's),
on the CPU to the plain integer product. An int4 linear (models/quant.py:
``kernel_q4`` int8 [K/2, N] half-split nibbles, ``scale4`` fp32 [K/g, N])
takes its branch before act_quant, so W8A8 never applies to it: by the
reference's rule, at most 1024 rows of activations go to the int4 kernel
(ops/int4_matmul.py), more are dequantised and multiplied with
torch.matmul, as the reference leaves them to XLA.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.int4_matmul import KERNEL_MAX_ROWS, int4_matmul, int4_matmul_plain
from ..ops.int8_matmul import quantized_linear_auto


def _param(*shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device))


def quantize_act(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Dynamic per-token int8: [..., K] -> (int8 [M, K], fp32 scale [M, 1])
    with rows flattened; scale max(|x|, 1e-6) / 127, round half to even.
    Computed once per shared matmul input (q/k/v share one, gate/up one)."""
    x2 = x.reshape(-1, x.shape[-1]).float()
    a = torch.clamp(x2.abs().amax(dim=-1, keepdim=True), min=1e-6) / 127.0
    return torch.clamp(torch.round(x2 / a), -127, 127).to(torch.int8), a


def int8_int_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """int8 [M, K] @ int8 [K, N] -> int32, exact. On the card
    torch._int_mm, which wants more than 16 rows (fewer are padded with
    zero rows); on the CPU the plain integer product."""
    if a.device.type == "cpu":
        return a.int() @ b.int()
    M = a.shape[0]
    if M <= 16:
        a = F.pad(a, (0, 0, 0, 32 - M))
    return torch._int_mm(a, b.contiguous())[:M]


def _w8a8_linear(wq: torch.Tensor, w_scale: torch.Tensor, x: torch.Tensor,
                 pre_quant=None) -> torch.Tensor:
    """Per-token int8 activations x int8 weights, int32 sums, times the row
    and channel scales; pre_quant: (xq, scale) shared across siblings."""
    lead = x.shape[:-1]
    xq, a = quantize_act(x) if pre_quant is None else pre_quant
    y = (int8_int_mm(xq, wq).float() * a * w_scale[None, :]).to(x.dtype)
    return y.reshape(*lead, wq.shape[-1])


def _int4_linear(wq: torch.Tensor, scale: torch.Tensor, x: torch.Tensor,
                 impl: str = "kernel") -> torch.Tensor:
    """x [.., K] @ the int4 kernel: 1 to KERNEL_MAX_ROWS rows through the
    int4 kernel's wrapper, more dequantised and multiplied with
    torch.matmul (the reference's dispatch, layers.py:_int4_linear).
    impl="plain" sends every call to the wrapper's plain version."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1]).contiguous()
    kernel = impl == "kernel" and 0 < x2.shape[0] <= KERNEL_MAX_ROWS
    fn = int4_matmul if kernel else int4_matmul_plain
    return fn(x2, wq, scale).reshape(*lead, wq.shape[-1])


class Linear(nn.Module):
    """y = x @ kernel (+ bias), kernel [in, out].

    With LoRA adapters attached (fp32 ``lora_a`` [in, r], ``lora_b``
    [r, out], set by train/lora.py::attach_lora) it computes
    y = x @ kernel + (x @ A) @ (B * lora_scale) (+ bias), the adapters cast
    to x's dtype, as the JAX package's attach form: the kernel is never
    touched and W + AB is never formed. int4_impl="plain" runs an int4
    leaf's product through the int4 kernel's plain version on the card (the
    reference path), int8_impl="plain" an int8 weight-only leaf's through
    the int8 kernel's."""

    def __init__(self, d_in: int, d_out: int, bias: bool, *, dtype, device):
        super().__init__()
        self.kernel = _param(d_in, d_out, dtype=dtype, device=device)
        self.register_parameter("kernel_q", None)   # int8, set by models/quant.py
        self.register_parameter("scale", None)
        self.register_parameter("kernel_q4", None)  # int4, set by models/quant.py
        self.register_parameter("scale4", None)
        self.bias = _param(d_out, dtype=dtype, device=device) if bias else None
        self.lora_a: nn.Parameter | None = None
        self.lora_b: nn.Parameter | None = None
        self.lora_scale = 1.0
        self.int4_impl = "kernel"
        self.int8_impl = "kernel"

    def forward(self, x: torch.Tensor, act_quant: str | None = None,
                pre_quant=None) -> torch.Tensor:
        if self.kernel is not None:
            y = torch.matmul(x, self.kernel)
        elif self.kernel_q4 is not None:
            y = _int4_linear(self.kernel_q4, self.scale4, x, self.int4_impl)
        elif act_quant == "int8":
            y = _w8a8_linear(self.kernel_q, self.scale, x, pre_quant)
        else:
            y = quantized_linear_auto(x, self.kernel_q, self.scale, self.int8_impl)
        if self.lora_a is not None:
            b = (self.lora_b * self.lora_scale).to(x.dtype)
            y = y + torch.matmul(torch.matmul(x, self.lora_a.to(x.dtype)), b)
        if self.bias is not None:
            y = y + self.bias
        return y


class ExpertLinear(nn.Module):
    """Stacked expert kernels [E, in, out] (int8 ``kernel_q`` with ``scale``
    [E, out] after models/quant.py); the MoE ops take `leaf()`."""

    def __init__(self, experts: int, d_in: int, d_out: int, *, dtype, device):
        super().__init__()
        self.kernel = _param(experts, d_in, d_out, dtype=dtype, device=device)
        self.register_parameter("kernel_q", None)
        self.register_parameter("scale", None)

    def leaf(self) -> dict:
        if self.kernel is not None:
            return {"kernel": self.kernel}
        return {"kernel_q": self.kernel_q, "scale": self.scale}


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

    def forward(self, x: torch.Tensor, act_quant: str | None = None) -> torch.Tensor:
        """Under W8A8 gate and up share one activation quantization (not on
        int4 leaves, which take no act_quant)."""
        pq = (quantize_act(x) if act_quant == "int8" and self.gate.kernel_q is not None
              else None)
        h = F.silu(self.gate(x, act_quant, pq)) * self.up(x, act_quant, pq)
        return self.down(h, act_quant)


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
