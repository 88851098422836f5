"""Sorted grouped-matmul MoE prefill: exact at about the routed work.

Port of the forward of ``video_r2_tpu/ops/moe_gmm.py``: sort the T k
routing slots by expert, pad each expert's run of rows to a multiple of
`block_rows`, and run the grouped FFN (ops/moe_ragged.ragged_expert_ffn:
its block axis becomes the row-block axis, its id table the block ->
expert map) over the sorted rows. Compute is T k rows plus at most
E (block_rows - 1) padding rows, and nothing drops. Everything around the
kernel keeps static shapes on the device (stable argsort, per-expert counts,
one scatter into the sorted layout, one gather back) and synchronises with
the host nowhere.

The backward kernels (``moe_mlp_gmm_diff``) come with the MoE training
slice; models/moe.moe_mlp raises for a float-weight GMM call under autograd
until then. The sharded variant waits for the parallelism port.
"""

from __future__ import annotations

import torch

from .moe_ragged import _plain_ffn, quantize_rows, ragged_expert_ffn


def sorted_expert_layout(topi: torch.Tensor, E: int, block_rows: int):
    """Routing table [T, k] -> (dst [Tk], blk_expert [n_blocks], blk_valid
    [n_blocks], R_pad). Row dst[j] holds flat routing slot j inside
    expert-contiguous, block-aligned runs; blk_expert[b] is the expert of
    row block b; blk_valid[b] == 0 marks blocks past the occupied rows (the
    static bound's slack). Sentinel ids == E map to the trash row R_pad - 1.
    R_pad = Tk + E (block_rows - 1) + 1 rounded up to a block multiple."""
    T, k = topi.shape
    Tk = T * k
    bm = block_rows
    dev = topi.device
    f = topi.reshape(-1).long()
    is_real = f < E
    fc = torch.clamp(f, max=E - 1)
    perm = torch.argsort(f, stable=True)          # sentinels sort past real ids
    f_sorted = f[perm]
    counts = torch.zeros(E, dtype=torch.long, device=dev).index_add_(0, fc, is_real.long())
    zero = torch.zeros(1, dtype=torch.long, device=dev)
    starts = torch.cat([zero, torch.cumsum(counts, 0)[:-1]])
    padded = -(-counts // bm) * bm
    pstart = torch.cat([zero, torch.cumsum(padded, 0)[:-1]])
    total = padded.sum()
    R_pad = -(-(Tk + E * (bm - 1) + 1) // bm) * bm
    fs = torch.clamp(f_sorted, max=E - 1)
    rank = torch.arange(Tk, device=dev) - starts[fs]
    dst_sorted = torch.where(f_sorted < E, pstart[fs] + rank, R_pad - 1)
    dst = torch.zeros(Tk, dtype=torch.long, device=dev).scatter_(0, perm, dst_sorted)
    n_blocks = R_pad // bm
    row0 = torch.arange(n_blocks, device=dev) * bm
    blk_expert = torch.clamp(torch.searchsorted(pstart + padded, row0, right=True),
                             max=E - 1).int()
    blk_valid = (row0 < total).int()
    return dst, blk_expert, blk_valid, R_pad


def auto_block_rows(Tk: int, E: int) -> int:
    """Row-block size: about the average rows per expert, a power of two in
    [8, 128] (per-expert padding wastes up to E (block_rows - 1) rows)."""
    avg = Tk // max(E, 1)
    bm = 8
    while bm < 128 and bm * 2 <= avg:
        bm *= 2
    return bm


def moe_mlp_gmm(p: dict, xt: torch.Tensor, k: int, norm_topk_prob: bool,
                block_rows: int | None = None, act_quant: str | None = None,
                ffn_impl: str = "kernel") -> torch.Tensor:
    """Exact sparse MoE forward over sorted expert groups. xt [T, H] ->
    [T, H]; routing as models/moe.route; equals the dense expert loop (no
    capacity, no drops). Expert leaves float {kernel} or int8 {kernel_q,
    scale}."""
    from ..models.moe import route

    T, H = xt.shape
    E = p["router"]["kernel"].shape[-1]
    if block_rows is None:
        block_rows = auto_block_rows(T * k, E)
    topv, topi = route(p["router"]["kernel"], xt, k, norm_topk_prob)
    ex = p["experts"]
    return _gmm_apply(xt, topv, topi, E, ex["gate"], ex["up"], ex["down"], block_rows,
                      act_quant=act_quant, ffn_impl=ffn_impl)


def gmm_layout(xt: torch.Tensor, topi: torch.Tensor, E: int, block_rows: int):
    """The sorted layout's dispatch of xt [T, H]: (xs [n_blocks, bm, H],
    blk_expert, blk_valid, dst [T k]); routing slot j's row is dst[j]."""
    k = topi.shape[-1]
    dst, blk_expert, blk_valid, R_pad = sorted_expert_layout(topi, E, block_rows)
    x_sorted = torch.zeros((R_pad, xt.shape[1]), dtype=xt.dtype, device=xt.device)
    x_sorted[dst] = xt.repeat_interleave(k, dim=0)
    return x_sorted.reshape(R_pad // block_rows, block_rows, -1), blk_expert, blk_valid, dst


def _gmm_apply(xt, topv, topi, E: int, gate, up, down, block_rows: int,
               act_quant: str | None = None, ffn_impl: str = "kernel") -> torch.Tensor:
    """Sort / scatter -> grouped FFN -> gather / combine."""
    T, H = xt.shape
    k = topi.shape[-1]
    xs, blk_expert, blk_valid, dst = gmm_layout(xt, topi, E, block_rows)
    ffn = ragged_expert_ffn if ffn_impl == "kernel" else _plain_ffn
    if act_quant == "int8" and "kernel_q" in gate:
        xq, ax = quantize_rows(xs)
        y = ffn(xq, blk_expert, gate, up, down, blk_valid=blk_valid, x_scales=ax)
    else:
        y = ffn(xs, blk_expert, gate, up, down, blk_valid=blk_valid)
    w = topv.reshape(-1).to(y.dtype)
    # slot j belongs to token j // k: the combine is a sum over k, no atomics
    out = (y.reshape(-1, H)[dst] * w[:, None]).reshape(T, k, H).sum(dim=1)
    return out.to(xt.dtype)
