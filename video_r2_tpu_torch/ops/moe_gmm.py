"""Sorted grouped-matmul MoE: exact at about the routed work, forward and
backward.

Port of ``video_r2_tpu/ops/moe_gmm.py``: sort the T k routing slots by
expert, pad each expert's run of rows to a multiple of `block_rows`, and run
the grouped FFN (ops/moe_ragged.ragged_expert_ffn: its block axis becomes
the row-block axis, its id table the block -> expert map) over the sorted
rows. Compute is T k rows plus at most E (block_rows - 1) padding rows, and
nothing drops. Everything around the kernels keeps static shapes on the
device (stable argsort, per-expert counts, one scatter into the sorted
layout, one gather back) and synchronises with the host nowhere.

Float expert weights train through `moe_mlp_gmm_diff` (`_GmmExpertFFN`, the
counterpart of the reference's custom VJP ``gmm_expert_ffn_diff``): the
forward saves only xt, topv and topi (and the weights, by reference), and
the backward rebuilds the forward's sorted layout (the same block_rows)
and recomputes per block:
- d_topv from one forward recompute through the grouped FFN (the
  unweighted per-slot outputs);
- dY, the output gradient of each routed slot times its combine weight,
  scattered into the sorted layout;
- `gmm_bwd_dx`: dX per row (and the SwiGLU terms dg, du, with h when dW is
  asked for), gathered back to the tokens as a sum over each token's k slots;
- `gmm_bwd_dw` (dWg, dWu) and `gmm_bwd_dwd` (dWd), per expert, only when
  autograd asks for the expert weights' gradients; an expert with no routed
  rows gets exactly zero.
On CUDA tensors those three wrappers launch ``csrc/moe_gmm_bwd.cu`` (which
replaces ``_bwd_dx_kernel``, ``_bwd_dw_kernel`` and ``_bwd_dwd_kernel``; bf16
or fp32 operands, `gmm_bwd_dx_tiles` and `gmm_bwd_dw_tiles` pick their
tiles) and count their launches; on CPU tensors they run their plain
versions. The rounding points are the kernels', in the working type of x
(bf16 on the card, none in float32): dY before dh and dWd, dg / du / h
before the products that consume them; every sum is fp32, dX comes out
fp32 and each dW in its weight's dtype, rounded once from the fp32 sum
(the reference's dwg.astype(wg.dtype)) by the kernel itself.
int8 expert weights (a QLoRA base) train through the same Function with
no weight gradient: the forward and the d_topv recompute run the grouped
FFN's int8-weight instance (the counterpart of ``_ffn_kernel_q``, the
scales on the fp32 sums, as the reference's einsum factors them onto the
outputs), and dX runs the bf16 dX kernel over the layer's experts
dequantized for that call (W_q times its per-column scale, rounded to x's
dtype; 3.2 GB at E 512, H 2048, I 512), freed before the call returns and
never saved for the backward. The reference has no such path: its
next_loss takes the einsum, which this one equals at capacity factor 0
(models/moe.py::moe_mlp_train). W8A8 has no backward. The sharded variant
waits for the parallelism port.
"""

from __future__ import annotations

import ctypes

import torch

from .cuda_build import check, kernels
from .moe_ragged import KERNEL_TILE, _plain_ffn, quantize_rows, ragged_expert_ffn

DW_MAX_EXPERTS = 1024   # the weight-gradient kernel's run table (shared memory)


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


# ---------------------------------------------------------------------------
# The backward: three kernels over the sorted layout, their plain versions,
# and the autograd Function
# ---------------------------------------------------------------------------

def gmm_bwd_dx_plain(xs, dYs, ids, valid, wg, wu, wd, keep_h: bool = False,
                     chunk: int = 32):
    """PyTorch version of the dX kernel over the sorted layout: xs [n, bm, H],
    dYs [n, bm, H] (rounded to xs's dtype here, as the caller rounds it for
    the kernel), ids / valid [n]; weights wg / wu [E, H, I], wd [E, I, H].
    Per block, with e = ids[a]: g = x Wg[e], u = x Wu[e], dh = dY Wd[e]^T
    (fp32 sums), dg = dh u silu'(g), du = dh silu(g), h = silu(g) u, each
    rounded to xs's dtype; dX = dg Wg[e]^T + du Wu[e]^T in fp32. Returns
    (dX fp32 [n, bm, H], dg, du [n, bm, I], h or None); slack blocks
    (valid 0) are zero in every output."""
    n, bm, H = xs.shape
    I = wg.shape[-1]
    dt, dev = xs.dtype, xs.device
    dx = torch.zeros((n, bm, H), dtype=torch.float32, device=dev)
    dg, du = (torch.zeros((n, bm, I), dtype=dt, device=dev) for _ in range(2))
    h = torch.zeros((n, bm, I), dtype=dt, device=dev) if keep_h else None
    e_all = ids.to(dev).long()
    keep = valid.to(dev) != 0
    for a0 in range(0, n, chunk):
        sl = slice(a0, a0 + chunk)
        e, m = e_all[sl], keep[sl][:, None, None]
        wge, wue = wg[e].float(), wu[e].float()
        x = xs[sl].float()
        g, u = torch.bmm(x, wge), torch.bmm(x, wue)
        dh = torch.bmm(dYs[sl].to(dt).float(), wd[e].float().transpose(1, 2))
        s = torch.sigmoid(g)
        dg_c = (dh * u * s * (1.0 + g * (1.0 - s))).to(dt)
        du_c = (dh * g * s).to(dt)
        dx_c = (torch.bmm(dg_c.float(), wge.transpose(1, 2))
                + torch.bmm(du_c.float(), wue.transpose(1, 2)))
        dx[sl] = torch.where(m, dx_c, 0.0)
        dg[sl] = torch.where(m, dg_c, 0.0)
        du[sl] = torch.where(m, du_c, 0.0)
        if keep_h:
            h[sl] = torch.where(m, (g * s * u).to(dt), 0.0)
    return dx, dg, du, h


def _expert_sums(a, b, ids, valid, E: int, chunk: int, out_dtype):
    """sum over the valid blocks of each expert of a[blk]^T b[blk]: a
    [n, bm, M], b [n, bm, N] -> [E, M, N], summed in fp32 and rounded to
    out_dtype (a's dtype when None) once; zero for an expert with no valid
    block."""
    n, _, M = a.shape
    out = torch.zeros((E, M, b.shape[-1]), dtype=torch.float32, device=a.device)
    e_all = ids.to(a.device).long()
    keep = valid.to(a.device) != 0
    for a0 in range(0, n, chunk):
        sl = slice(a0, a0 + chunk)
        m = keep[sl][:, None, None]
        prod = torch.bmm(a[sl].float().transpose(1, 2), b[sl].float())
        out.index_add_(0, e_all[sl], torch.where(m, prod, 0.0))
    return out.to(out_dtype or a.dtype)


def gmm_bwd_dw_plain(xs, dg, du, ids, valid, E: int, out_dtype=None, chunk: int = 32):
    """PyTorch version of the dWg / dWu kernel: per expert e, the sum over
    its valid blocks of x^T dg and x^T du ([E, H, I] each, fp32 sums rounded
    once to out_dtype, x's dtype by default; zero for an expert with no
    rows)."""
    return (_expert_sums(xs, dg, ids, valid, E, chunk, out_dtype),
            _expert_sums(xs, du, ids, valid, E, chunk, out_dtype))


def gmm_bwd_dwd_plain(h, dYs, ids, valid, E: int, out_dtype=None, chunk: int = 32):
    """PyTorch version of the dWd kernel: per expert, the sum over its valid
    blocks of h^T dY ([E, I, H], fp32 sums rounded once to out_dtype, h's
    dtype by default; zero for an expert with no rows). dY is rounded to h's
    dtype first, as for the dX kernel."""
    return _expert_sums(h, dYs.to(h.dtype), ids, valid, E, chunk, out_dtype)


def gmm_bwd_dx_tiles(bm: int, H: int) -> tuple[int, int]:
    """The bf16 dX kernels' tiles for blocks of bm rows and hidden width H
    (a multiple of 64): (rows a block: 128 where 128 divides bm, else 64,
    one warpgroup per 64; columns of H a dX block: 128 where 128 divides H,
    else 64). The terms pass takes 64 columns of I a block."""
    return (128 if bm % 128 == 0 else 64), (128 if H % 128 == 0 else 64)


def gmm_bwd_dx(xs, dYs, ids, valid, wg, wu, wd, keep_h: bool = False):
    """dX of the sorted layout (gmm_bwd_dx_plain's function). CUDA tensors
    launch the kernel (bf16 or fp32 operands of one type, H and I multiples
    of 64); CPU tensors run the plain version."""
    if xs.device.type == "cpu":
        return gmm_bwd_dx_plain(xs, dYs, ids, valid, wg, wu, wd, keep_h)
    out = _bwd_dx_cuda(xs, dYs, ids, valid, wg, wu, wd, keep_h)
    gmm_bwd_dx.launches += 1
    return out


def gmm_bwd_dw_tiles(N: int, nb: int) -> tuple[int, int]:
    """The bf16 weight-gradient kernel's output tile for nb outputs (2: dWg
    and dWu, 1: dWd) of width N (a multiple of 64): (128 rows, one
    warpgroup per 64; columns: 128 for two outputs, 256 for one, where they
    divide N, else 64). Rows past M are left to the TMA store, which writes
    nothing past the tensor."""
    wide = 128 if nb == 2 else 256
    return 128, (wide if N % wide == 0 else 64)


def gmm_bwd_dw(xs, dg, du, ids, valid, E: int, out_dtype=None):
    """(dWg, dWu) [E, H, I] (gmm_bwd_dw_plain's function) in out_dtype, the
    operands' by default. The kernel takes the sorted layout as
    sorted_expert_layout makes it: the valid blocks first, each expert's
    blocks one run, experts in ascending order; it writes the operands'
    dtype (bf16 sums rounded once in its epilogue)."""
    if xs.device.type == "cpu":
        return gmm_bwd_dw_plain(xs, dg, du, ids, valid, E, out_dtype)
    out = _bwd_dw_cuda(xs, (dg, du), ids, valid, E, out_dtype)
    gmm_bwd_dw.launches += 1
    return out


def gmm_bwd_dwd(h, dYs, ids, valid, E: int, out_dtype=None):
    """dWd [E, I, H] (gmm_bwd_dwd_plain's function) in out_dtype, h's by
    default; the sorted layout as for gmm_bwd_dw. dY must already be in h's
    dtype on the card (the backward rounds it so once)."""
    if h.device.type == "cpu":
        return gmm_bwd_dwd_plain(h, dYs, ids, valid, E, out_dtype)
    out = _bwd_dw_cuda(h, (dYs,), ids, valid, E, out_dtype)[0]
    gmm_bwd_dwd.launches += 1
    return out


gmm_bwd_dx.launches = 0     # kernel launches (CUDA only)
gmm_bwd_dw.launches = 0
gmm_bwd_dwd.launches = 0


def _check(what: str, operands, dev) -> bool:
    """Device, type, layout and alignment of the operands (the first one's
    type, bf16 or fp32, for all). Returns whether they are fp32."""
    dtype = operands[0][1].dtype
    if dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{what}: {operands[0][0]} must be torch.bfloat16 or torch.float32, "
                        f"got {dtype}")
    for name, t in operands:
        if t.device != dev:
            raise ValueError(f"{what}: {name} on {t.device}, x on {dev}")
        if t.dtype != dtype:
            raise TypeError(f"{what}: {name} must be {dtype} as {operands[0][0]}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{what}: {name} must be 16-byte aligned")
    return dtype == torch.float32


def _block_table(ids, valid, n: int, dev):
    ids32 = ids.to(device=dev, dtype=torch.int32).contiguous()
    valid32 = valid.to(device=dev, dtype=torch.int32).contiguous()
    if ids32.shape != (n,) or valid32.shape != (n,):
        raise ValueError(f"gmm backward: ids {tuple(ids32.shape)} / blk_valid "
                         f"{tuple(valid32.shape)} must be [{n}]")
    return ids32, valid32


def _bwd_dx_cuda(xs, dYs, ids, valid, wg, wu, wd, keep_h: bool):
    """Check the operands and launch the dX kernel of csrc/moe_gmm_bwd.cu."""
    if xs.dim() != 3 or wg.dim() != 3:
        raise ValueError(f"gmm dX kernel: x [n, bm, H] and weights [E, H, I], got "
                         f"{tuple(xs.shape)}, {tuple(wg.shape)}")
    n, bm, H = xs.shape
    E, _, I = wg.shape
    if (wg.shape != (E, H, I) or wu.shape != (E, H, I) or wd.shape != (E, I, H)
            or dYs.shape != xs.shape):
        raise ValueError(f"gmm dX kernel: gate / up {tuple(wg.shape)} / {tuple(wu.shape)}, "
                         f"down {tuple(wd.shape)} and dY {tuple(dYs.shape)} do not fit x "
                         f"{tuple(xs.shape)}")
    if H % KERNEL_TILE or I % KERNEL_TILE:
        raise ValueError(f"gmm dX kernel: hidden {H} and intermediate {I} must be "
                         f"multiples of {KERNEL_TILE}")
    dev = xs.device
    fp32 = _check("gmm dX kernel", (("x", xs), ("dY", dYs), ("gate", wg), ("up", wu),
                                    ("down", wd)), dev)
    ids32, valid32 = _block_table(ids, valid, n, dev)
    dx = torch.empty((n, bm, H), dtype=torch.float32, device=dev)
    dg, du = (torch.empty((n, bm, I), dtype=xs.dtype, device=dev) for _ in range(2))
    h = torch.empty((n, bm, I), dtype=xs.dtype, device=dev) if keep_h else None
    err = kernels().vr2_moe_gmm_bwd_dx(
        xs.data_ptr(), dYs.data_ptr(), ids32.data_ptr(), valid32.data_ptr(),
        wg.data_ptr(), wu.data_ptr(), wd.data_ptr(), dg.data_ptr(), du.data_ptr(),
        None if h is None else h.data_ptr(), dx.data_ptr(), n, bm, H, I, E,
        *gmm_bwd_dx_tiles(bm, H), int(fp32), torch.cuda.current_stream(dev).cuda_stream)
    check(err, "gmm backward dX kernel")
    return dx, dg, du, h


def _bwd_dw_cuda(a, bs, ids, valid, E: int, out_dtype):
    """Check the operands and launch the weight-gradient kernel of
    csrc/moe_gmm_bwd.cu: per expert, the sum over its run of rows of
    a^T b for each b in bs (one or two), [E, M, N] in the operands' dtype.
    The kernel counts each expert's run from the block table (valid blocks
    first, experts in ascending order: sorted_expert_layout's layout)."""
    if a.dim() != 3 or any(b.shape[:2] != a.shape[:2] or b.dim() != 3 for b in bs):
        raise ValueError(f"gmm dW kernel: operands [n, bm, M] and [n, bm, N], got "
                         f"{tuple(a.shape)} and {[tuple(b.shape) for b in bs]}")
    n, bm, M = a.shape
    N = bs[0].shape[-1]
    if M % KERNEL_TILE or N % KERNEL_TILE or any(b.shape[-1] != N for b in bs):
        raise ValueError(f"gmm dW kernel: widths {M} and {N} must be multiples of "
                         f"{KERNEL_TILE}")
    dev = a.device
    fp32 = _check("gmm dW kernel",
                  [("rows", a)] + [(f"operand {i}", b) for i, b in enumerate(bs)], dev)
    if not 0 < E <= (E if fp32 else DW_MAX_EXPERTS):
        raise ValueError(f"gmm dW kernel: {E} experts; bf16 takes 1 to {DW_MAX_EXPERTS}")
    if out_dtype not in (None, a.dtype):
        raise TypeError(f"gmm dW kernel: writes the operands' dtype {a.dtype}, asked for "
                        f"{out_dtype}")
    ids32, valid32 = _block_table(ids, valid, n, dev)
    outs = [torch.empty((E, M, N), dtype=a.dtype, device=dev) for _ in bs]
    err = kernels().vr2_moe_gmm_bwd_dw(
        a.data_ptr(), bs[0].data_ptr(), None if len(bs) == 1 else bs[1].data_ptr(),
        ids32.data_ptr(), valid32.data_ptr(), outs[0].data_ptr(),
        None if len(bs) == 1 else outs[1].data_ptr(), n, bm, M, N, E,
        gmm_bwd_dw_tiles(N, len(bs))[1], int(fp32), torch.cuda.current_stream(dev).cuda_stream)
    check(err, "gmm backward dW kernel")
    return outs


def gmm_bwd_dw_layout(M: int, N: int, E: int, nb: int) -> dict:
    """The bf16 weight-gradient kernel's launch for nb outputs [E, M, N]:
    {rows, cols (of a tile), stages (of its ring), smem (bytes a block),
    tiles, blocks (the persistent grid: one per SM, at most one per
    tile)}."""
    out = (ctypes.c_int * 6)()
    check(kernels().vr2_moe_gmm_bwd_dw_layout(M, N, E, nb, gmm_bwd_dw_tiles(N, nb)[1], out),
          "gmm dW layout")
    return dict(zip(("rows", "cols", "stages", "smem", "tiles", "blocks"), out))


def sorted_dy(dy_slot, topv, dst, shape, dtype) -> torch.Tensor:
    """dY in the sorted layout `shape` [n, bm, H]: each routed slot's output
    gradient dy_slot [T k, H] (fp32) times its combine weight (the output is
    linear in it) at its row dst, rounded to `dtype` once (the backward's
    first rounding point); zero on padding and slack rows."""
    n, bm, H = shape
    dY = torch.zeros((n * bm, H), dtype=torch.float32, device=dy_slot.device)
    dY[dst] = topv.reshape(-1, 1).float() * dy_slot
    return dY.to(dtype).reshape(shape)


def _leaves(w, scale) -> dict:
    """An expert leaf: {kernel} for float weights, {kernel_q, scale} for
    int8 ones (scale [E, N])."""
    return {"kernel": w} if scale is None else {"kernel_q": w, "scale": scale}


class _GmmExpertFFN(torch.autograd.Function):
    """The exact MoE FFN over sorted expert groups with the recompute
    backward (the reference's gmm_expert_ffn_diff). Float weights wg / wu
    [E, H, I], wd [E, I, H] without scales; or int8 weights with their
    scales sg / su [E, I], sd [E, H], which get no gradient (dX through the
    weights dequantized for the call). topi gets no gradient."""

    @staticmethod
    def forward(ctx, xt, topv, topi, wg, wu, wd, block_rows: int, ffn_impl: str, sg=None,
                su=None, sd=None):
        ctx.save_for_backward(xt, topv, topi, wg, wu, wd, sg, su, sd)
        ctx.block_rows, ctx.ffn_impl = block_rows, ffn_impl
        return _gmm_apply(xt, topv, topi, wg.shape[0], _leaves(wg, sg), _leaves(wu, su),
                          _leaves(wd, sd), block_rows, ffn_impl=ffn_impl)

    @staticmethod
    def backward(ctx, dy):
        xt, topv, topi, wg, wu, wd, sg, su, sd = ctx.saved_tensors
        T, H = xt.shape
        k = topi.shape[-1]
        E = wg.shape[0]
        bm = ctx.block_rows
        kernel = ctx.ffn_impl == "kernel"
        quant = sg is not None
        xs, ids, valid, dst = gmm_layout(xt, topi, E, bm)
        R_pad = xs.shape[0] * bm

        # d_topv needs the unweighted per-slot outputs: one forward recompute
        ffn = ragged_expert_ffn if kernel else _plain_ffn
        y = ffn(xs, ids, _leaves(wg, sg), _leaves(wu, su), _leaves(wd, sd), blk_valid=valid)
        dy_slot = dy.float().repeat_interleave(k, dim=0)                # [T k, H]
        d_topv = (dy_slot * y.reshape(R_pad, H)[dst].float()).sum(-1).reshape(T, k)
        del y
        dYs = sorted_dy(dy_slot, topv, dst, xs.shape, xs.dtype)
        del dy_slot

        need_w = (False,) * 3 if quant else ctx.needs_input_grad[3:6]
        bwd = (gmm_bwd_dx, gmm_bwd_dw, gmm_bwd_dwd) if kernel else (
            gmm_bwd_dx_plain, gmm_bwd_dw_plain, gmm_bwd_dwd_plain)
        if quant:   # the layer's experts for this call alone
            from ..models.quant import dequantize_kernel

            wg, wu, wd = (dequantize_kernel(_leaves(w, s), xs.dtype)
                          for w, s in ((wg, sg), (wu, su), (wd, sd)))
        dx, dg, du, h = bwd[0](xs, dYs, ids, valid, wg, wu, wd, keep_h=need_w[2])
        if quant:
            del wg, wu, wd
        # each token's k slots summed (the reference's index-add over tok_of_flat)
        d_xt = dx.reshape(R_pad, H)[dst].reshape(T, k, H).sum(1).to(xt.dtype)
        del dx
        dwg = dwu = dwd = None
        if need_w[0] or need_w[1]:
            dwg, dwu = (w if need else None
                        for w, need in zip(bwd[1](xs, dg, du, ids, valid, E, wg.dtype),
                                           need_w))
        if need_w[2]:
            dwd = bwd[2](h, dYs, ids, valid, E, wd.dtype)
        # the scales' Nones past the float call's inputs are dropped by autograd
        return (d_xt, d_topv.to(topv.dtype), None, dwg, dwu, dwd, None, None, None, None,
                None)


def moe_mlp_gmm_diff(p: dict, xt: torch.Tensor, k: int, norm_topk_prob: bool,
                     block_rows: int | None = None, ffn_impl: str = "kernel") -> torch.Tensor:
    """The exact MoE forward over sorted expert groups, differentiable: float
    expert leaves {kernel} (their gradients when they require one) or int8
    leaves {kernel_q, scale} (none). Routing through autograd (the router's
    gradient flows through topv's), the FFN through _GmmExpertFFN. The
    backward reuses the forward's layout (block_rows, auto_block_rows by
    default): bm changes only the order of fp32 sums. ffn_impl="plain" runs
    the forward FFN and the backward through their plain versions on any
    device."""
    from ..models.moe import route

    E = p["router"]["kernel"].shape[-1]
    if block_rows is None:
        block_rows = auto_block_rows(xt.shape[0] * k, E)
    topv, topi = route(p["router"]["kernel"], xt, k, norm_topk_prob)
    ex = p["experts"]
    quant = "kernel_q" in ex["gate"]
    w = [ex[n]["kernel_q" if quant else "kernel"] for n in ("gate", "up", "down")]
    s = [ex[n]["scale"] if quant else None for n in ("gate", "up", "down")]
    return _GmmExpertFFN.apply(xt, topv, topi, *w, block_rows, ffn_impl, *s)
