"""ViT window attention (fixed 64-slot windows with a valid-slot mask),
differentiable.

`window_attention` is the port of
``video_r2_tpu/ops/vit_window_attention.py::window_attention``. Without
gradients it runs the forward (``_win_kernel``); with gradients it runs
`_WindowFn`, the port of the ``_window_attention_hm`` custom VJP, whose
backward recomputes the scores (``_win_bwd_kernel``; no forward statistics
are saved). On CUDA tensors both steps launch hand-written Hopper kernels
(``csrc/vit_window_attn.cu``, ``csrc/vit_window_attn_bwd.cu``; routed as
the flash kernels by ops/flash.py::kernel_instance: bf16 at head dims 64 /
80 / 128 on the tensor cores, fp32 at any head dim up to 128 on the CUDA
cores) and raise on anything the kernels do not take; on CPU tensors the
Function runs the plain PyTorch versions
(`window_attention_plain`, `window_attention_bwd_plain`), which the CPU tests
hold against the JAX kernels in interpret mode.

Semantics: slot i attends to slot j of its own window when valid[j];
probabilities are cast to the operand dtype before the P @ V product and
normalised after it. Rows of a fully invalid window are never read
downstream; every version here emits 0 there and gives them zero gradients
(the JAX kernel attends uniformly there instead).
"""

from __future__ import annotations

import ctypes

import torch

from .cuda_build import check, kernels
from .flash import _check_operand, kernel_instance

WINDOW = 64


def window_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     valid: torch.Tensor, wp: int = WINDOW) -> torch.Tensor:
    """q/k/v [S, nh, hd] grouped in `wp`-slot windows; valid [S] bool.
    Returns [S, nh, hd] in q's dtype; differentiable in q, k, v."""
    S = q.shape[0]
    if S % wp:
        raise ValueError(f"S={S} not a multiple of the window {wp}")
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        return _WindowFn.apply(q, k, v, valid, wp)
    return _window_fwd(q, k, v, valid, wp)


window_attention.launches = 0   # forward kernel launches (CUDA path only)


class _WindowFn(torch.autograd.Function):
    """Saves only the operands: the backward recomputes S and P."""

    @staticmethod
    def forward(ctx, q, k, v, valid, wp):
        ctx.save_for_backward(q, k, v, valid)
        ctx.wp = wp
        return _window_fwd(q, k, v, valid, wp)

    @staticmethod
    def backward(ctx, dout):
        q, k, v, valid = ctx.saved_tensors
        dq, dk, dv = window_attention_bwd(q, k, v, valid, dout, ctx.wp)
        return dq, dk, dv, None, None


def _window_fwd(q, k, v, valid, wp):
    if q.device.type == "cpu":
        return window_attention_plain(q, k, v, valid, wp)
    return _window_cuda(q, k, v, valid, wp)


def window_attention_bwd(q, k, v, valid, dout, wp: int = WINDOW):
    """(dq, dk, dv) [S, nh, hd] in q's dtype: the backward kernel on CUDA
    tensors, the plain version on CPU tensors."""
    if q.device.type == "cpu":
        return window_attention_bwd_plain(q, k, v, valid, dout, wp)
    return _window_bwd_cuda(q, k, v, valid, dout, wp)


window_attention_bwd.launches = 0   # backward kernel launches (CUDA path only)


def _window_probs(q, k, valid, wp):
    """fp32 (unnormalised p [nw, nh, wp, wp], row sums l) over valid keys;
    p = 0 in a fully invalid window."""
    S, nh, hd = q.shape
    nw = S // wp
    qw, kw = (x.reshape(nw, wp, nh, hd) for x in (q, k))
    s = torch.einsum("wqnd,wknd->wnqk", qw.float(), kw.float()) * hd ** -0.5
    s = s.masked_fill(~valid.reshape(nw, 1, 1, wp).to(q.device), float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isinf(m), 0.0, m)        # fully invalid windows
    p = torch.exp(s - m)
    return p, p.sum(dim=-1, keepdim=True)


def window_attention_plain(q, k, v, valid, wp: int = WINDOW) -> torch.Tensor:
    """Batched dense PyTorch version of the kernel: fp32 scores, keys masked
    by `valid`, P cast to v's dtype for an fp32-accumulated P @ V."""
    S, nh, hd = q.shape
    p, l = _window_probs(q, k, valid, wp)
    vw = v.reshape(S // wp, wp, nh, hd)
    o = torch.einsum("wnqk,wknd->wnqd", p.to(v.dtype).float(), vw.float())
    o = o / torch.clamp(l, min=1e-30)
    return o.permute(0, 2, 1, 3).reshape(S, nh, hd).to(q.dtype)


def window_attention_bwd_plain(q, k, v, valid, dout, wp: int = WINDOW):
    """Dense PyTorch version of the backward kernel (the JAX package's
    recompute, in fp32): P = softmax(S), dv = P^T do, O = P v,
    D = rowsum(do * O), ds = P (do v^T - D), dq = scale ds k,
    dk = scale ds^T q."""
    S, nh, hd = q.shape
    nw, scale = S // wp, hd ** -0.5
    p, l = _window_probs(q, k, valid, wp)
    P = p / torch.clamp(l, min=1e-30)
    qw, kw, vw, dow = (x.float().reshape(nw, wp, nh, hd) for x in (q, k, v, dout))
    dv = torch.einsum("wnqk,wqnd->wknd", P, dow)
    o = torch.einsum("wnqk,wknd->wqnd", P, vw)
    D = (dow * o).sum(-1).permute(0, 2, 1)[..., None]        # [nw, nh, wp, 1]
    ds = P * (torch.einsum("wqnd,wknd->wnqk", dow, vw) - D)
    dq = torch.einsum("wnqk,wknd->wqnd", ds, kw) * scale
    dk = torch.einsum("wnqk,wqnd->wknd", ds, qw) * scale
    return tuple(x.reshape(S, nh, hd).to(q.dtype) for x in (dq, dk, dv))


def _window_operands(q, k, v, valid, wp):
    S, nh, hd = q.shape
    if wp != WINDOW:
        raise ValueError(f"window kernel: window {wp} != {WINDOW}")
    kernel_instance(q.dtype, hd, window=True)
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"window kernel: q/k/v shapes differ: {tuple(q.shape)} "
                         f"{tuple(k.shape)} {tuple(v.shape)}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        _check_operand(name, x, q.device, q.dtype)
    if valid.shape != (S,) or valid.dtype != torch.bool:
        raise ValueError(f"valid must be bool [{S}], got {valid.dtype} "
                         f"{tuple(valid.shape)}")
    return _aligned_flags(valid, q.device)


def _aligned_flags(valid: torch.Tensor, device) -> torch.Tensor:
    """`valid` on `device`, contiguous and 16-byte aligned (the bf16 kernels
    copy a window's 64 flags as four 16-byte chunks): the tensor itself
    where it already is, else a copy."""
    valid = valid.to(device).contiguous()
    return valid.clone() if valid.data_ptr() % 16 else valid


def _window_cuda(q, k, v, valid, wp):
    S, nh, hd = q.shape
    valid = _window_operands(q, k, v, valid, wp)
    out = torch.empty((S, nh, hd), dtype=q.dtype, device=q.device)
    err = kernels().vr2_window_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), valid.data_ptr(),
        out.data_ptr(), S, nh, hd,
        q.stride(0), q.stride(1), k.stride(0), k.stride(1),
        v.stride(0), v.stride(1), hd ** -0.5, int(q.dtype == torch.float32),
        torch.cuda.current_stream(q.device).cuda_stream)
    check(err, "window_attention kernel")
    window_attention.launches += 1
    return out


def _window_bwd_cuda(q, k, v, valid, dout, wp):
    S, nh, hd = q.shape
    valid = _window_operands(q, k, v, valid, wp)
    dout = dout.contiguous()
    _check_operand("dout", dout, q.device, q.dtype)
    if dout.shape != q.shape:
        raise ValueError(f"window backward: dout {tuple(dout.shape)} != q "
                         f"{tuple(q.shape)}")
    dq, dk, dv = (torch.empty((S, nh, hd), dtype=q.dtype, device=q.device)
                  for _ in range(3))
    err = kernels().vr2_window_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
        valid.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), S, nh, hd,
        q.stride(0), q.stride(1), k.stride(0), k.stride(1),
        v.stride(0), v.stride(1), hd ** -0.5, int(q.dtype == torch.float32),
        torch.cuda.current_stream(q.device).cuda_stream)
    check(err, "window_attention backward kernel")
    window_attention_bwd.launches += 1
    return dq, dk, dv


def window_bwd_layout(hd: int) -> tuple[int, int, int]:
    """(threads a block, blocks resident an SM, the card's SMs) of the bf16
    window backward at head dim `hd`: its persistent grid is min(heads x
    windows, resident x SMs) blocks, each walking a contiguous range of
    (head, window) items."""
    out = (ctypes.c_int * 3)()
    check(kernels().vr2_window_attention_bwd_layout(int(hd), out), "window backward layout")
    return out[0], out[1], out[2]
