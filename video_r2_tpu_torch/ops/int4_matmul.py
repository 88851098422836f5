"""Int4 weight-only matmul: half-split packed nibbles with group scales.

Port of ``video_r2_tpu/ops/int4_matmul.py``. A [K, N] kernel packs to int8
[K/2, N] ("half-split"): packed row p holds q[p] in its low nibble and
q[p + K/2] in its high nibble, each nibble storing q + 8 with q in [-7, 7];
the fp32 scales [K/g, N] are symmetric per group of g rows along K. So the
low nibbles multiply x[:, :K/2] and the high nibbles x[:, K/2:], two
contiguous halves of x, and their scale rows are the two halves of the
scale array.

`int4_matmul` replaces ``_stacked_kernel4`` (the TPU kernel behind
``int4_matmul_stacked``). The JAX package passes the whole [L, K/2, N]
stack and a layer index; each layer of the port is its own module, so the
wrapper takes one layer's ``wq`` [K/2, N] and ``scale`` [K/g, N]. On CUDA
tensors it launches ``csrc/int4_matmul.cu`` (any g that divides K/2, K a
multiple of 64, bf16 x of at most 1024 rows, any N), outside autograd, and
raises on anything the kernel does not take; on CPU tensors
it runs `int4_matmul_plain`, the JAX package's CPU path (dequantise to x's
dtype, then one matmul). Which calls reach the wrapper is the reference's
own rule (``models/layers.py::Linear``): at most `KERNEL_MAX_ROWS` rows of
activations go to the kernel, more are dequantised with torch ops and
multiplied with torch.matmul, as the JAX package leaves them to XLA.
"""

from __future__ import annotations

import torch

from .cuda_build import check, kernels

KERNEL_K = 64             # K must be a multiple of this (a stage: 32 packed rows)
KERNEL_MAX_ROWS = 1024    # the reference's row limit for its kernel


def pack_int4_halves(q: torch.Tensor) -> torch.Tensor:
    """[.., K, N] ints in [-7, 7] -> [.., K/2, N] int8 packed."""
    K = q.shape[-2]
    if K % 2:
        raise ValueError(f"int4 packing needs an even K, got {K}")
    u = (q + 8).to(torch.uint8)
    return (u[..., : K // 2, :] | (u[..., K // 2:, :] << 4)).view(torch.int8)


def unpack_int4_halves(packed: torch.Tensor) -> torch.Tensor:
    """[.., K/2, N] int8 -> [.., K, N] int8 values in [-7, 7]."""
    lo = (packed & 15) - 8
    hi = ((packed >> 4) & 15) - 8
    return torch.cat([lo, hi], dim=-2).to(torch.int8)


def dequant_int4(packed: torch.Tensor, scale: torch.Tensor, group_size: int,
                 dtype=torch.bfloat16) -> torch.Tensor:
    """[.., K/2, N] packed + [.., K/g, N] scales -> [.., K, N] in dtype
    (the product in fp32, then one rounding)."""
    w = unpack_int4_halves(packed).float()
    *lead, K, N = w.shape
    wg = w.reshape(*lead, K // group_size, group_size, N) * scale.float()[..., :, None, :]
    return wg.reshape(*lead, K, N).to(dtype)


def int4_matmul_plain(x: torch.Tensor, wq: torch.Tensor,
                      scale: torch.Tensor) -> torch.Tensor:
    """x [M, K] @ dequant(wq, scale) -> [M, N] in x's dtype, the weight
    dequantised to x's dtype first."""
    K = 2 * wq.shape[-2]
    return torch.matmul(x, dequant_int4(wq, scale, K // scale.shape[-2], x.dtype))


def int4_matmul(x: torch.Tensor, wq: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """x [M, K] @ dequant(wq [K/2, N] int8, scale [K/g, N] fp32) -> [M, N]
    in x's dtype. CUDA tensors launch the kernel (fp32 sums, each weight
    dequantised in fp32 and rounded to bf16 before its product, as the TPU
    kernel casts its tile to x's dtype), outside autograd only (the kernel
    has no backward); CPU tensors run the plain version."""
    if x.device.type == "cpu":
        return int4_matmul_plain(x, wq, scale)
    if torch.is_grad_enabled() and (x.requires_grad or scale.requires_grad):
        raise NotImplementedError("the int4 kernel has no backward: call it outside "
                                  "autograd (int4 weights do not train)")
    out = _int4_cuda(x, wq, scale)
    int4_matmul.launches += 1
    return out


int4_matmul.launches = 0   # kernel launches (CUDA only)


def _int4_cuda(x, wq, scale):
    """Check the operands and launch csrc/int4_matmul.cu."""
    if x.dim() != 2 or wq.dim() != 2 or scale.dim() != 2:
        raise ValueError(f"int4 kernel: x [M, K], wq [K/2, N] and scale [K/g, N], got "
                         f"{tuple(x.shape)}, {tuple(wq.shape)}, {tuple(scale.shape)}")
    M, K = x.shape
    Kp, N = wq.shape
    G = scale.shape[0]
    g = K // G if G else 0
    if (K != 2 * Kp or K % KERNEL_K or scale.shape[1] != N or not g or g * G != K
            or Kp % g):
        raise ValueError(f"int4 kernel: x {tuple(x.shape)}, wq {tuple(wq.shape)} and scale "
                         f"{tuple(scale.shape)} must be [M, K], [K/2, N], [K/g, N] with K a "
                         f"multiple of {KERNEL_K} and g dividing K/2")
    if not 0 < M <= KERNEL_MAX_ROWS:
        raise ValueError(f"int4 kernel: {M} rows, the kernel takes 1 to {KERNEL_MAX_ROWS}")
    dev = x.device
    for name, t, dtype in (("x", x, torch.bfloat16), ("wq", wq, torch.int8),
                           ("scale", scale, torch.float32)):
        if t.device != dev:
            raise ValueError(f"int4 kernel: {name} on {t.device}, x on {dev}")
        if t.dtype != dtype:
            raise TypeError(f"int4 kernel: {name} must be {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"int4 kernel: {name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"int4 kernel: {name} must be 16-byte aligned")
    out = torch.empty((M, N), dtype=torch.bfloat16, device=dev)
    err = kernels().vr2_int4_matmul(x.data_ptr(), wq.data_ptr(), scale.data_ptr(),
                                    out.data_ptr(), M, K, N, g,
                                    torch.cuda.current_stream(dev).cuda_stream)
    check(err, "int4 matmul kernel")
    return out
