"""Flash attention (causal / padding-aware / segments, GQA), differentiable.

`flash_attention` is the port of ``video_r2_tpu/ops/flash.py::flash_attention``.
Without gradients it runs the serving forward (``_flash_kernel``). With
gradients it runs `_FlashFn`, the port of the ``_flash_core`` custom VJP: a
forward that also writes each row's log-sum-exp (``_flash_fwd_kernel``) and
the FA2 recompute backward from it (``_flash_bwd_dq_kernel``,
``_flash_bwd_dkv_kernel``). On CUDA tensors every step launches a
hand-written Hopper kernel (``csrc/flash_attn.cu``, ``csrc/flash_attn_bwd.cu``;
bf16, head dims 64 / 80 / 128) and raises on anything the kernels do not
take; on CPU tensors the same Function runs the plain PyTorch versions
(`flash_attention_fwd_lse_plain`, `flash_attention_bwd_plain`), which the CPU
tests hold against the JAX kernels in interpret mode.

Mask semantics (every version): key j is admitted for query row i of batch b
when j < kv_lengths[b], and (causal) j <= q_offset + i, and (segments)
segment_ids[b, i] == segment_ids[b, j]. A row that admits no key emits 0,
has an LSE of +1e30 and gets no gradient.
"""

from __future__ import annotations

import ctypes

import torch

from .cuda_build import check, kernels

KERNEL_HEAD_DIMS = (64, 80, 128)
NO_KEY_LSE = 1e30   # LSE of a row that admits no key: exp(s - lse) == 0


def flash_attention(
    q: torch.Tensor,                 # [B, Sq, nh, hd]
    k: torch.Tensor,                 # [B, Sk, kh, hd]
    v: torch.Tensor,
    kv_lengths: torch.Tensor | None = None,   # [B] valid kv per batch
    causal: bool = True,
    q_offset: int = 0,               # global position of q row 0
    segment_ids: torch.Tensor | None = None,  # [B, S] int; Sq == Sk required
) -> torch.Tensor:
    """Returns [B, Sq, nh, hd] in q's dtype; differentiable in q, k, v."""
    B, Sq, nh, hd = q.shape
    Sk, kh = k.shape[1], k.shape[2]
    if nh % kh:
        raise ValueError(f"query heads {nh} not a multiple of kv heads {kh}")
    if segment_ids is not None and Sq != Sk:
        raise ValueError("segment_ids require self-attention shapes (Sq == Sk)")
    if kv_lengths is None:
        kv_lengths = torch.full((B,), Sk, dtype=torch.int32, device=q.device)
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        return _FlashFn.apply(q, k, v, kv_lengths, causal, q_offset, segment_ids)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, kv_lengths, causal, q_offset,
                                     segment_ids)
    return _flash_cuda(q, k, v, kv_lengths, causal, q_offset, segment_ids)[0]


flash_attention.launches = 0   # serving-forward kernel launches (CUDA only)


class _FlashFn(torch.autograd.Function):
    """Forward with LSE; saves q, k, v, out, lse, lengths and segments; the
    backward recomputes P from the LSE."""

    @staticmethod
    def forward(ctx, q, k, v, kv_lengths, causal, q_offset, segment_ids):
        out, lse = flash_attention_fwd_lse(q, k, v, kv_lengths, causal, q_offset,
                                           segment_ids)
        ctx.save_for_backward(q, k, v, out, lse, kv_lengths, segment_ids)
        ctx.causal, ctx.q_offset = causal, q_offset
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse, kv_lengths, segment_ids = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, dout, lse, kv_lengths,
                                         ctx.causal, ctx.q_offset, segment_ids)
        return dq, dk, dv, None, None, None, None


def flash_attention_fwd_lse(q, k, v, kv_lengths, causal=True, q_offset=0,
                            segment_ids=None):
    """(out [B, Sq, nh, hd], lse [B, nh, Sq] fp32): the kernel with its LSE
    output on CUDA tensors, the plain version on CPU tensors."""
    if q.device.type == "cpu":
        return flash_attention_fwd_lse_plain(q, k, v, kv_lengths, causal,
                                             q_offset, segment_ids)
    return _flash_cuda(q, k, v, kv_lengths, causal, q_offset, segment_ids,
                       with_lse=True)


flash_attention_fwd_lse.launches = 0   # training-forward kernel launches


def flash_attention_bwd(q, k, v, out, dout, lse, kv_lengths, causal=True,
                        q_offset=0, segment_ids=None):
    """(dq, dk, dv) in the operands' dtypes, GQA group summed into dk / dv:
    the two backward kernels on CUDA tensors, the plain version on CPU."""
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, out, dout, lse, kv_lengths,
                                         causal, q_offset, segment_ids)
    args = (q, k, v, dout, lse, attention_delta(out, dout), kv_lengths, causal,
            q_offset, segment_ids)
    return (flash_bwd_dq_cuda(*args), *flash_bwd_dkv_cuda(*args))


def flash_attention_plain(q, k, v, kv_lengths, causal=True, q_offset=0,
                          segment_ids=None) -> torch.Tensor:
    """Dense PyTorch version of the serving kernel: fp32 scores and softmax,
    the same mask, fp32 P @ V, output in q's dtype."""
    return flash_attention_fwd_lse_plain(q, k, v, kv_lengths, causal, q_offset,
                                         segment_ids)[0]


def _admitted(B, Sq, Sk, kv_lengths, causal, q_offset, segment_ids, device):
    """[B, Sq, Sk] bool: the mask every version applies."""
    kpos = torch.arange(Sk, device=device)
    allowed = (kpos[None, None, :] < kv_lengths.to(device)[:, None, None])
    allowed = allowed.expand(B, Sq, Sk)
    if causal:
        qpos = q_offset + torch.arange(Sq, device=device)
        allowed = allowed & (kpos[None, :] <= qpos[:, None])[None]
    if segment_ids is not None:
        seg = segment_ids.to(device)
        allowed = allowed & (seg[:, :, None] == seg[:, None, :])
    return allowed


def _grouped(x, kh):
    """[B, S, nh, hd] -> fp32 [B, S, kh, nh // kh, hd] (head h = kv head
    h // g, member h % g)."""
    B, S, nh, hd = x.shape
    return x.float().reshape(B, S, kh, nh // kh, hd)


def flash_attention_fwd_lse_plain(q, k, v, kv_lengths, causal=True, q_offset=0,
                                  segment_ids=None):
    """Dense PyTorch version of the forward with LSE: (out in q's dtype,
    lse [B, nh, Sq] fp32, NO_KEY_LSE where a row admits no key)."""
    B, Sq, nh, hd = q.shape
    Sk, kh = k.shape[1], k.shape[2]
    s = torch.einsum("bqhgd,bkhd->bhgqk", _grouped(q, kh) * hd ** -0.5, k.float())
    allowed = _admitted(B, Sq, Sk, kv_lengths, causal, q_offset, segment_ids,
                        q.device)
    s = s.masked_fill(~allowed[:, None, None], float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isinf(m), 0.0, m)        # rows with no admitted key
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhgqk,bkhd->bhgqd", p, v.float())
    o = o / torch.clamp(l, min=1e-30)
    lse = torch.where(l > 0, m + torch.log(torch.clamp(l, min=1e-30)), NO_KEY_LSE)
    return (o.permute(0, 3, 1, 2, 4).reshape(B, Sq, nh, hd).to(q.dtype),
            lse.reshape(B, nh, Sq))


def flash_attention_bwd_plain(q, k, v, out, dout, lse, kv_lengths, causal=True,
                              q_offset=0, segment_ids=None):
    """Dense PyTorch version of the two backward kernels (the JAX package's
    FA2 recompute): p = exp(s - lse) under the mask, delta = rowsum(do * o),
    ds = p (do v^T - delta); dq = scale ds k, dk = scale ds^T q and
    dv = p^T do, both summed over the GQA group."""
    B, Sq, nh, hd = q.shape
    Sk, kh = k.shape[1], k.shape[2]
    g, scale = nh // kh, hd ** -0.5
    qf, dof = _grouped(q, kh), _grouped(dout, kh)
    kf, vf = k.float(), v.float()
    s = torch.einsum("bqhgd,bkhd->bhgqk", qf, kf) * scale
    allowed = _admitted(B, Sq, Sk, kv_lengths, causal, q_offset, segment_ids,
                        q.device)
    p = torch.where(allowed[:, None, None],
                    torch.exp(s - lse.reshape(B, kh, g, Sq, 1)), 0.0)
    delta = (dof * _grouped(out, kh)).sum(-1).permute(0, 2, 3, 1)[..., None]
    ds = p * (torch.einsum("bqhgd,bkhd->bhgqk", dof, vf) - delta)
    dq = torch.einsum("bhgqk,bkhd->bqhgd", ds, kf) * scale
    dk = torch.einsum("bhgqk,bqhgd->bkhd", ds, qf) * scale
    dv = torch.einsum("bhgqk,bqhgd->bkhd", p, dof)
    return (dq.reshape(B, Sq, nh, hd).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def _check_operand(name: str, x: torch.Tensor, device) -> None:
    if x.device.type != "cuda" or x.device != device:
        raise ValueError(f"{name} on {x.device}: the kernel takes tensors on "
                         f"one CUDA device ({device})")
    if x.dtype != torch.bfloat16:
        raise TypeError(f"{name}: the kernel takes bfloat16, got {x.dtype}")
    if x.stride(-1) != 1 or any(s % 8 for s in x.stride()[:-1]) \
            or x.data_ptr() % 16:
        raise ValueError(f"{name}: the kernel reads 16-byte rows; needs a unit "
                         f"last stride, strides that are multiples of 8 and a "
                         f"16-byte aligned base, got strides {x.stride()}")


def _kernel_inputs(q, k, v, kv_lengths, segment_ids):
    """Check the operands; (lengths int32 [B], segments int32 [B, Sk] or
    None), contiguous on q's device."""
    B, Sq, nh, hd = q.shape
    Sk, kh = k.shape[1], k.shape[2]
    if hd not in KERNEL_HEAD_DIMS:
        raise ValueError(f"flash kernel: head dim {hd} not in {KERNEL_HEAD_DIMS}")
    if k.shape != (B, Sk, kh, hd) or v.shape != k.shape:
        raise ValueError(f"flash kernel: k {tuple(k.shape)} / v "
                         f"{tuple(v.shape)} do not match q {tuple(q.shape)}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        _check_operand(name, x, q.device)
    lengths = kv_lengths.to(device=q.device, dtype=torch.int32).contiguous()
    if lengths.shape != (B,):
        raise ValueError(f"kv_lengths shape {tuple(lengths.shape)} != ({B},)")
    seg = None
    if segment_ids is not None:
        seg = segment_ids.to(device=q.device, dtype=torch.int32).contiguous()
        if seg.shape != (B, Sk):
            raise ValueError(f"segment_ids shape {tuple(seg.shape)} != ({B}, {Sk})")
    return lengths, seg


def _strides(q, k, v):
    return (q.stride(0), q.stride(1), q.stride(2), k.stride(0), k.stride(1),
            k.stride(2), v.stride(0), v.stride(1), v.stride(2))


def _flash_cuda(q, k, v, kv_lengths, causal, q_offset, segment_ids,
                with_lse=False):
    """Launch csrc/flash_attn.cu: (out, lse or None)."""
    B, Sq, nh, hd = q.shape
    Sk, kh = k.shape[1], k.shape[2]
    lengths, seg = _kernel_inputs(q, k, v, kv_lengths, segment_ids)
    out = torch.empty((B, Sq, nh, hd), dtype=q.dtype, device=q.device)
    lse = (torch.empty((B, nh, Sq), dtype=torch.float32, device=q.device)
           if with_lse else None)
    err = kernels().vr2_flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr() if with_lse else None,
        lengths.data_ptr(), seg.data_ptr() if seg is not None else None,
        B, Sq, Sk, nh, kh, hd, *_strides(q, k, v),
        int(causal), int(q_offset), hd ** -0.5,
        torch.cuda.current_stream(q.device).cuda_stream)
    check(err, "flash_attention kernel")
    if with_lse:
        flash_attention_fwd_lse.launches += 1
    else:
        flash_attention.launches += 1
    return out, lse


def attention_delta(out, dout) -> torch.Tensor:
    """delta = rowsum(dout * out) in fp32, [B, nh, Sq] (the backward's row
    term; the JAX package computes it in XLA outside Pallas)."""
    return (dout.float() * out.float()).sum(-1).transpose(1, 2).contiguous()


def _bwd_operands(q, k, v, dout, lse, delta, kv_lengths, segment_ids):
    """Check the backward's operands: (lengths, seg, dout, lse, delta) as
    the kernels read them."""
    B, Sq, nh, _ = q.shape
    lengths, seg = _kernel_inputs(q, k, v, kv_lengths, segment_ids)
    dout = dout.contiguous()
    _check_operand("dout", dout, q.device)
    for name, x in (("lse", lse), ("delta", delta)):
        if x.shape != (B, nh, Sq) or x.dtype != torch.float32 or x.device != q.device:
            raise ValueError(f"flash backward: {name} must be fp32 [{B}, {nh}, {Sq}] "
                             f"on {q.device}, got {x.dtype} {tuple(x.shape)}")
    if dout.shape != q.shape:
        raise ValueError(f"flash backward: dout {tuple(dout.shape)} != q "
                         f"{tuple(q.shape)}")
    return lengths, seg, dout, lse.contiguous(), delta.contiguous()


def _bwd_args(q, k, v, dout, lse, delta, lengths, seg, causal, q_offset):
    B, Sq, nh, hd = q.shape
    Sk, kh = k.shape[1], k.shape[2]
    head = (q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), lengths.data_ptr(),
            seg.data_ptr() if seg is not None else None)
    tail = (B, Sq, Sk, nh, kh, hd, *_strides(q, k, v), int(causal),
            int(q_offset), hd ** -0.5,
            torch.cuda.current_stream(q.device).cuda_stream)
    return head, tail


def flash_bwd_dq_cuda(q, k, v, dout, lse, delta, kv_lengths, causal=True,
                      q_offset=0, segment_ids=None) -> torch.Tensor:
    """Launch the dq kernel (csrc/flash_attn_bwd.cu): dq [B, Sq, nh, hd]."""
    lengths, seg, dout, lse, delta = _bwd_operands(q, k, v, dout, lse, delta,
                                                   kv_lengths, segment_ids)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    head, tail = _bwd_args(q, k, v, dout, lse, delta, lengths, seg, causal, q_offset)
    check(kernels().vr2_flash_attention_bwd_dq(*head, dq.data_ptr(), *tail),
          "flash_attention dq kernel")
    flash_bwd_dq_cuda.launches += 1
    return dq


flash_bwd_dq_cuda.launches = 0


def flash_bwd_dkv_cuda(q, k, v, dout, lse, delta, kv_lengths, causal=True,
                       q_offset=0, segment_ids=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the dk/dv kernel (csrc/flash_attn_bwd.cu): dk, dv
    [B, Sk, kh, hd], the GQA group summed. The kernel runs one block per
    (key rows, query head): under GQA it adds each head into zeroed fp32
    sums, rounded to the operands' dtype here."""
    lengths, seg, dout, lse, delta = _bwd_operands(q, k, v, dout, lse, delta,
                                                   kv_lengths, segment_ids)
    gqa = q.shape[2] != k.shape[2]
    dk, dv = (torch.zeros(k.shape, dtype=torch.float32, device=q.device) if gqa
              else torch.empty(k.shape, dtype=x.dtype, device=q.device) for x in (k, v))
    head, tail = _bwd_args(q, k, v, dout, lse, delta, lengths, seg, causal, q_offset)
    check(kernels().vr2_flash_attention_bwd_dkv(*head, dk.data_ptr(), dv.data_ptr(),
                                                *tail),
          "flash_attention dk/dv kernel")
    flash_bwd_dkv_cuda.launches += 1
    return (dk.to(k.dtype), dv.to(v.dtype)) if gqa else (dk, dv)


flash_bwd_dkv_cuda.launches = 0


def flash_bwd_layout(hd: int, dkv: bool) -> tuple[int, int, int]:
    """The launch shape of the dq (dkv False) or dk/dv kernel at head dim
    `hd`: (rows of a block, warpgroups of a block, blocks that stay resident
    on one SM by the CUDA occupancy calculator)."""
    out = (ctypes.c_int * 3)()
    check(kernels().vr2_flash_attention_bwd_layout(int(hd), int(dkv), out),
          "flash backward layout")
    return out[0], out[1], out[2]
