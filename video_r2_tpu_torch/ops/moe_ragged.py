"""Grouped SwiGLU expert FFN over row blocks, and the ragged MoE decode path.

Port of ``video_r2_tpu/ops/moe_ragged.py``. `ragged_expert_ffn` computes,
for every row block a of x [A, C, H] and its expert e = ids[a],
silu(x[a] @ Wg[e]) * (x[a] @ Wu[e]) @ Wd[e], over float weights, int8
weights with per-output-channel scales, or W8A8 (int8 x with row scales and
int8 weights, h re-quantised per row over each bi-wide tile of I). It is the
kernel behind both MoE fast paths: the ragged decode here (a block is one
active-expert slot, C = max(T, 8) rows) and the sorted-GMM prefill of
ops/moe_gmm.py (a block is a run of rows of one expert).

On CUDA tensors the wrapper launches the hand-written kernel
(``csrc/moe_ffn.cu``, which replaces ``_ffn_kernel``, ``_ffn_kernel_q`` and
``_ffn_kernel_qq``; `ffn_wgmma_tiles` picks its wgmma path for bf16 blocks
of a multiple of 64 rows) and raises on anything it does not take, a call under
autograd among them (the kernel has no backward; the float GMM path trains
through ops/moe_gmm.py's autograd Function, which calls it without); on CPU tensors
it runs `ragged_expert_ffn_plain` (a gathered bmm per chunk of blocks with
the same rounding points). Blocks whose blk_valid is 0 output zeros.

`moe_mlp_ragged` routes a decode step's tokens, builds the static-size
active-expert table (A = min(E, T k) slots, pads repeat the last id) and
dispatches / combines around the kernel without a host synchronisation.
Unlike the reference, the pad slots are passed as blk_valid 0: their x rows
are zero, so their output is exactly the zeros the kernel then writes
without reading their expert's weights again. The sharded variants wait for
the parallelism port.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .cuda_build import check, kernels

KERNEL_TILE = 64          # H, I (and the W8A8 bi) must be multiples of this
WGMMA_ROWS = 64           # rows of a warpgroup in the wgmma kernels


def ffn_wgmma_tiles(mode: int, C: int, H: int, I: int) -> tuple[int, int, int] | None:
    """The kernel's path for a call: mode 0 (bf16) with C a multiple of 64
    (the GMM prefill's 64- and 128-row blocks) takes the wgmma kernels,
    returned as their tiles (rows a block: 128 where 128 divides C, else 64;
    gate / up columns of I a block: 128 where it divides I, else 64; down
    columns of H a block: 256 where it divides H, else 64). Everything else
    (ragged decode below 64 rows, int8 weights, W8A8) takes the mma.sync
    kernels: None. H and I are multiples of 64 (the wrapper checks)."""
    if mode != 0 or C % WGMMA_ROWS:
        return None
    return (2 * WGMMA_ROWS if C % (2 * WGMMA_ROWS) == 0 else WGMMA_ROWS,
            128 if I % 128 == 0 else 64, 256 if H % 256 == 0 else 64)


def _fit_block_i(cap: int, C: int, H: int, I: int, xbytes: int,
                 wbytes: int, obytes: int) -> int:
    """The reference's intermediate tile, copied as is: the largest
    lane-aligned (x128) divisor of I <= cap whose working set fits ~14 MB of
    the TPU's scoped VMEM, else the largest plain divisor for tiny I. It is
    not a tuning knob here: the W8A8 variant re-quantises h per row over
    each bi-wide tile, so bi is part of the result (384 at the A3B judge's
    I = 768, I itself at tiny test widths); the kernel and the plain version
    both take it."""
    lim = min(cap, I)
    aligned = [d for d in range(lim, 0, -1) if I % d == 0 and d % 128 == 0]
    if not aligned:
        return next(d for d in range(lim, 0, -1) if I % d == 0)

    def vmem(bi: int) -> int:
        ins = 2 * (C * H * xbytes + 3 * H * bi * wbytes)
        outs = 2 * C * H * obytes
        return ins + outs + C * H * 4

    return next((bi for bi in aligned if vmem(bi) <= 14 * 2 ** 20),
                aligned[-1])


def _block_i(x_slots, wg, x_scales, block_i: int) -> int:
    """_fit_block_i at these operands' shapes and element sizes."""
    C, H = x_slots.shape[1:]
    obytes = 4 if x_scales is not None else x_slots.element_size()
    return _fit_block_i(block_i, C, H, wg.shape[-1], x_slots.element_size(),
                        wg.element_size(), obytes)


def _weights(gate: dict, up: dict, down: dict):
    """(quant, wg, sg, wu, su, wd, sd): kernels, and scales for int8 leaves."""
    if "kernel_q" in gate:
        return (True, gate["kernel_q"], gate["scale"], up["kernel_q"], up["scale"],
                down["kernel_q"], down["scale"])
    return False, gate["kernel"], None, up["kernel"], None, down["kernel"], None


def ragged_expert_ffn(x_slots: torch.Tensor, active_ids: torch.Tensor, gate: dict,
                      up: dict, down: dict, block_i: int = 512,
                      blk_valid: torch.Tensor | None = None,
                      x_scales: torch.Tensor | None = None) -> torch.Tensor:
    """Fused SwiGLU over row blocks. x_slots [A, C, H] (int8 with x_scales
    [A, C] for W8A8, which needs int8 weight leaves), active_ids [A] expert
    per block, leaves {"kernel" [E, K, N]} or {"kernel_q" int8, "scale"
    [E, N]}. Returns [A, C, H] in x's dtype (fp32 for W8A8)."""
    A = x_slots.shape[0]
    quant, wg, *_ = _weights(gate, up, down)
    if x_scales is not None and not quant:
        raise ValueError("W8A8 (x_scales) needs int8 weight leaves")
    bi = _block_i(x_slots, wg, x_scales, block_i)
    if blk_valid is None:
        blk_valid = torch.ones(A, dtype=torch.int32, device=x_slots.device)
    if x_slots.device.type == "cpu":
        return ragged_expert_ffn_plain(x_slots, active_ids, gate, up, down, bi,
                                       blk_valid, x_scales)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (x_slots, x_scales, *_weights(gate, up, down)[1:])):
        raise NotImplementedError(
            "the grouped FFN kernel has no backward: under autograd, float expert "
            "weights train through the GMM path (ops/moe_gmm.moe_mlp_gmm_diff); the "
            "ragged path and int8 / W8A8 weights do not train")
    out = _moe_ffn_cuda(x_slots, active_ids, gate, up, down, bi, blk_valid, x_scales)
    ragged_expert_ffn.launches["w8a8" if x_scales is not None else
                               "int8" if quant else "bf16"] += 1
    return out


# kernel launches per variant: float, int8 weights, W8A8
ragged_expert_ffn.launches = {"bf16": 0, "int8": 0, "w8a8": 0}


def ragged_expert_ffn_plain(x_slots, active_ids, gate: dict, up: dict, down: dict,
                            bi: int, blk_valid=None, x_scales=None,
                            chunk: int = 32) -> torch.Tensor:
    """PyTorch version of the kernel, blocks gathered `chunk` at a time:
    float products in fp32 from the working-type operands (int8 weights
    converted exactly), h rounded to x's dtype, y rounded to x's dtype; W8A8
    in float64 (integer sums exact at any width), h re-quantised per row
    over each bi-wide tile, fp32 out. Blocks with blk_valid 0 output 0."""
    A, C, H = x_slots.shape
    quant, wg, sg, wu, su, wd, sd = _weights(gate, up, down)
    w8a8 = x_scales is not None
    out_dtype = torch.float32 if w8a8 else x_slots.dtype
    out = torch.zeros((A, C, H), dtype=out_dtype, device=x_slots.device)
    ids = active_ids.to(x_slots.device).long()
    keep = (torch.ones(A, dtype=torch.bool, device=x_slots.device) if blk_valid is None
            else blk_valid.to(x_slots.device) != 0)
    I = wg.shape[-1]
    for a0 in range(0, A, chunk):
        sl = slice(a0, a0 + chunk)
        e = ids[sl]
        if w8a8:
            xd = x_slots[sl].double()
            ax = x_scales[sl].float()[..., None]
            g = torch.bmm(xd, wg[e].double()).float() * ax * sg[e][:, None, :]
            u = torch.bmm(xd, wu[e].double()).float() * ax * su[e][:, None, :]
            h = F.silu(g) * u
            y = torch.zeros_like(out[sl])
            for t0 in range(0, I, bi):
                ht = h[..., t0:t0 + bi]
                ah = torch.clamp(ht.abs().amax(dim=-1), min=1e-6) / 127.0
                hq = torch.clamp(torch.round(ht / ah[..., None]), -127, 127)
                dot = torch.bmm(hq.double(), wd[e][:, t0:t0 + bi].double()).float()
                y = y + dot * ah[..., None] * sd[e][:, None, :]
        else:
            xf = x_slots[sl].float()
            g = torch.bmm(xf, wg[e].float())
            u = torch.bmm(xf, wu[e].float())
            if quant:
                g, u = g * sg[e][:, None, :], u * su[e][:, None, :]
            h = (F.silu(g) * u).to(x_slots.dtype)
            y = torch.bmm(h.float(), wd[e].float())
            if quant:
                y = y * sd[e][:, None, :]
        out[sl] = torch.where(keep[sl][:, None, None], y.to(out_dtype), 0.0)
    return out


def _moe_ffn_cuda(x, ids, gate, up, down, bi, blk_valid, x_scales):
    """Check the operands and launch csrc/moe_ffn.cu."""
    quant, wg, sg, wu, su, wd, sd = _weights(gate, up, down)
    w8a8 = x_scales is not None
    mode = 2 if w8a8 else 1 if quant else 0
    if x.dim() != 3:
        raise ValueError(f"moe kernel: x must be [A, C, H], got {tuple(x.shape)}")
    A, C, H = x.shape
    if wg.dim() != 3:
        raise ValueError(f"moe kernel: expert kernels must be [E, K, N], got "
                         f"{tuple(wg.shape)}")
    E, _, I = wg.shape
    if wg.shape != (E, H, I) or wu.shape != (E, H, I) or wd.shape != (E, I, H):
        raise ValueError(f"moe kernel: gate / up {tuple(wg.shape)} / {tuple(wu.shape)} "
                         f"and down {tuple(wd.shape)} do not fit x {tuple(x.shape)}")
    if H % KERNEL_TILE or I % KERNEL_TILE:
        raise ValueError(f"moe kernel: hidden {H} and intermediate {I} must be multiples "
                         f"of {KERNEL_TILE}")
    if w8a8 and (bi % KERNEL_TILE or I % bi):
        raise ValueError(f"moe kernel: W8A8 tile {bi} must divide {I} and be a multiple "
                         f"of {KERNEL_TILE}")
    x_dtype = torch.int8 if w8a8 else torch.bfloat16
    w_dtype = torch.int8 if quant else torch.bfloat16
    operands = [("x", x, x_dtype), ("gate", wg, w_dtype), ("up", wu, w_dtype),
                ("down", wd, w_dtype)]
    if quant:
        operands += [("gate scale", sg, torch.float32), ("up scale", su, torch.float32),
                     ("down scale", sd, torch.float32)]
        if sg.shape != (E, I) or su.shape != (E, I) or sd.shape != (E, H):
            raise ValueError(f"moe kernel: scales {tuple(sg.shape)} / {tuple(su.shape)} / "
                             f"{tuple(sd.shape)} must be [E, I], [E, I], [E, H]")
    if w8a8:
        operands.append(("x scales", x_scales, torch.float32))
        if x_scales.shape != (A, C):
            raise ValueError(f"moe kernel: x scales must be [A, C] = {(A, C)}, got "
                             f"{tuple(x_scales.shape)}")
    dev = x.device
    for name, t, dtype in operands:
        if t.device != dev:
            raise ValueError(f"moe kernel: {name} on {t.device}, x on {dev}")
        if t.dtype != dtype:
            raise TypeError(f"moe kernel: {name} must be {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"moe kernel: {name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"moe kernel: {name} must be 16-byte aligned")
    ids32 = ids.to(device=dev, dtype=torch.int32).contiguous()
    valid32 = blk_valid.to(device=dev, dtype=torch.int32).contiguous()
    if ids32.shape != (A,) or valid32.shape != (A,):
        raise ValueError(f"moe kernel: ids {tuple(ids32.shape)} / blk_valid "
                         f"{tuple(valid32.shape)} must be [{A}]")
    h = torch.empty((A, C, I), dtype=torch.float32 if w8a8 else torch.bfloat16, device=dev)
    hq = torch.empty((A, C, I), dtype=torch.int8, device=dev) if w8a8 else None
    ah = torch.empty((A, C, I // bi), dtype=torch.float32, device=dev) if w8a8 else None
    out = torch.empty((A, C, H), dtype=torch.float32 if w8a8 else torch.bfloat16,
                      device=dev)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    tiles = ffn_wgmma_tiles(mode, C, H, I) or (0, 0, 0)
    err = kernels().vr2_moe_ffn(
        x.data_ptr(), ptr(x_scales), ids32.data_ptr(), valid32.data_ptr(),
        wg.data_ptr(), ptr(sg), wu.data_ptr(), ptr(su), wd.data_ptr(), ptr(sd),
        h.data_ptr(), ptr(hq), ptr(ah), out.data_ptr(), A, C, H, I, E, bi, mode, *tiles,
        torch.cuda.current_stream(dev).cuda_stream)
    check(err, "moe expert FFN kernel")
    return out


def quantize_rows(x: torch.Tensor, keepdims: bool = False):
    """Per-row absmax int8 over the last axis: (int8 values, fp32 scale
    max(|x|, 1e-6) / 127), rounded half to even."""
    x32 = x.float()
    a = torch.clamp(x32.abs().amax(dim=-1, keepdim=keepdims), min=1e-6) / 127.0
    xq = torch.clamp(torch.round(x32 / (a if keepdims else a[..., None])), -127, 127)
    return xq.to(torch.int8), a


def active_expert_table(topi: torch.Tensor, num_experts: int):
    """Routing table [T, k] -> (active_ids [A] sorted, a_idx [T, k]).

    A = min(E, T k). active_ids holds the step's distinct routed experts in
    ascending order, pads repeating the last valid id; a_idx maps each
    routing slot to its active row. Sentinel ids E ("not routed here") never
    enter the set and map to a_idx == A. No host synchronisation."""
    T, k = topi.shape
    E = num_experts
    A = min(E, T * k)
    flat = topi.reshape(-1).long()
    s = torch.sort(flat).values
    first = torch.cat([torch.ones(1, dtype=torch.bool, device=s.device), s[1:] != s[:-1]])
    su = torch.sort(torch.where(first, s, E)).values[:A]
    valid = su < E
    n_valid = torch.clamp(valid.sum(), min=1)
    last = su.gather(0, (n_valid - 1).reshape(1))
    active_ids = torch.clamp(torch.where(valid, su, last), max=E - 1)
    a_idx = torch.searchsorted(active_ids, flat).reshape(T, k)
    return active_ids, a_idx


def ragged_layout(xt: torch.Tensor, topi: torch.Tensor, E: int):
    """The active-expert table's dispatch of a routed step xt [T, H]:
    (x_slots [A, C, H], active_ids [A], blk_valid [A], row [T k]) with
    C = max(T, 8); slot a holds its tokens in routing-slot order, row[j] is
    routing slot j's row of x_slots viewed [A C, H] (A C for a sentinel,
    which dispatches nothing). blk_valid is 0 on the pad slots (repeats of
    the previous id), which carry only zero rows."""
    T, H = xt.shape
    k = topi.shape[-1]
    active_ids, a_idx = active_expert_table(topi, E)
    A = active_ids.shape[0]
    C = max(T, 8)
    flat = a_idx.reshape(-1)                                       # [Tk]
    oh = F.one_hot(flat, A + 1)[:, :A]
    pos = (torch.cumsum(oh, dim=0) - 1).gather(1, flat.clamp(max=A - 1)[:, None])[:, 0]
    row = torch.where(flat < A, flat * C + pos, A * C)
    x_slots = torch.zeros((A * C + 1, H), dtype=xt.dtype, device=xt.device)
    x_slots.index_copy_(0, row, xt.repeat_interleave(k, dim=0))
    blk_valid = torch.cat([torch.ones(1, dtype=torch.bool, device=xt.device),
                           active_ids[1:] != active_ids[:-1]]).int()
    return x_slots[:A * C].reshape(A, C, H), active_ids, blk_valid, row


def _ragged_apply(xt, topv, topi, E: int, gate: dict, up: dict, down: dict,
                  act_quant: str | None = None, ffn_impl: str = "kernel"):
    """Dispatch / grouped FFN / combine over the active-expert table of a
    routed step. xt [T, H], topv / topi [T, k] -> [T, H]; sentinel slots
    combine to 0."""
    T, H = xt.shape
    k = topi.shape[-1]
    x_slots, active_ids, blk_valid, row = ragged_layout(xt, topi, E)
    ffn = ragged_expert_ffn if ffn_impl == "kernel" else _plain_ffn
    if act_quant == "int8" and "kernel_q" in gate:
        xq, ax = quantize_rows(x_slots)
        y = ffn(xq, active_ids, gate, up, down, blk_valid=blk_valid, x_scales=ax)
    else:
        y = ffn(x_slots, active_ids, gate, up, down, blk_valid=blk_valid)
    y = torch.cat([y.reshape(-1, H), y.new_zeros((1, H))])
    w = topv.reshape(-1).to(y.dtype)
    out = (y[row] * w[:, None]).reshape(T, k, H).sum(dim=1)
    return out.to(xt.dtype)


def _plain_ffn(x_slots, ids, gate, up, down, block_i: int = 512, blk_valid=None,
               x_scales=None):
    """ragged_expert_ffn's plain version on any device, with the same tile
    (the plain path chip_smoke.py holds the kernel path against)."""
    bi = _block_i(x_slots, _weights(gate, up, down)[1], x_scales, block_i)
    return ragged_expert_ffn_plain(x_slots, ids, gate, up, down, bi, blk_valid, x_scales)


def moe_mlp_ragged(p: dict, xt: torch.Tensor, k: int, norm_topk_prob: bool,
                   act_quant: str | None = None, ffn_impl: str = "kernel") -> torch.Tensor:
    """Decode-path sparse MoE over the active experts only. xt [T, H] (T
    small: a decode step's tokens) -> [T, H]. Exact (never drops: each
    active expert holds up to T rows). p: {"router": {"kernel" [H, E]},
    "experts": {"gate" / "up" / "down": leaf}}."""
    from ..models.moe import route

    E = p["router"]["kernel"].shape[-1]
    topv, topi = route(p["router"]["kernel"], xt, k, norm_topk_prob)
    ex = p["experts"]
    return _ragged_apply(xt, topv, topi, E, ex["gate"], ex["up"], ex["down"],
                         act_quant=act_quant, ffn_impl=ffn_impl)
