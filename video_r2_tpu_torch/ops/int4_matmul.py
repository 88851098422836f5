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
multiple of 64, bf16 or fp32 x of at most 1024 rows, any N; fp32 x
through an fp32 CUDA-core path; bf16 x of at most 16 rows over weights of
16 MiB or more with 16 | N, 64 | g and 128 | K (the decode gate / up,
down and head of the presets) through the decode kernel on the stream-K
plan of `int4_decode_plan`; other bf16 x through the staged kernel, split
over K in the same launch where `int4_split_plan` finds that the grid does
not fill the card, a tile's splits one thread-block cluster), outside
autograd, and raises on anything
the kernel does not take; on CPU tensors
it runs `int4_matmul_plain`, the JAX package's CPU path (dequantise to x's
dtype, then one matmul). Which calls reach the wrapper is the reference's
own rule (``models/layers.py::Linear``): at most `KERNEL_MAX_ROWS` rows of
activations go to the kernel, more are dequantised with torch ops and
multiplied with torch.matmul, as the JAX package leaves them to XLA.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .cuda_build import check, kernels
from .split import SPLIT_BLOCKS_PER_SM, split_workspace

KERNEL_K = 64             # K must be a multiple of this (a stage: 32 packed rows)
KERNEL_MAX_ROWS = 1024    # the reference's row limit for its kernel
KERNEL_COLUMNS = 64       # output columns of a staged kernel's block
SPLIT_MIN_STAGES = 4      # split-K keeps at least this many stages a split
SPLIT_MAX = 16            # ... and makes at most this many (a tile's splits are one cluster)
DECODE_MAX_ROWS = 16      # the decode kernel's rows of x at most
DECODE_COLUMNS = 128      # output columns of a decode tile
DECODE_STEP_ROWS = 64     # packed rows of a step (16 a warp); 64 | K/2 and 64 | g
DECODE_TILE_ROWS = 8      # rows of an x tile of the decode kernel (its instances hold 1 or 2)
# packed bytes (K/2 x N) from which the decode kernel takes a shape: below,
# its cross-block closes cost more than the staged kernel's split-K (the
# 7B's q / o, 6.4 MB: 0.0125-0.0131 device ms against 0.0110-0.0114 with
# the ticket close, 0.0097-0.0098 with the cluster close, and k / v the
# same either way then, 0.0060 now; gate / up, down and the head, 34-272 MB:
# 0.028-0.16 against 0.037-0.19. scripts/bench_int4_ffn.py, --staged for
# the staged kernel, on an H100 80GB HBM3 at 700 W)
DECODE_MIN_BYTES = 16 << 20
# where both kernels put the group scale (csrc/int4_matmul.cu): "a", each
# weight rounded to bf16(q s) before its product, as the reference
SCALE_PLACEMENT = "a"


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


def int4_tiles(M: int, N: int) -> int:
    """The kernel's (column blocks x row blocks) grid for x [M, K] @ [K, N]:
    blocks of 64 columns and of the smallest of 16, 32 and 64 rows that
    holds M (csrc/int4_matmul.cu's launch)."""
    rows = 16 if M <= 16 else 32 if M <= 32 else 64
    return -(-N // KERNEL_COLUMNS) * -(-M // rows)


def int4_split_plan(M: int, K: int, N: int, sms: int) -> tuple[int, list[tuple[int, int]]]:
    """Split-K for x [M, K] @ [K, N] on a card of `sms` SMs: (S, the stage
    range [begin, end) of each split). A stage is 32 packed rows (64 k).
    S = 1 where the (column blocks x row blocks) grid already fills the
    card; otherwise S brings the grid to about SPLIT_BLOCKS_PER_SM blocks an
    SM, capped so that each split keeps SPLIT_MIN_STAGES stages and at
    SPLIT_MAX (a tile's splits are one thread-block cluster). The ranges
    are the kernel's own (grid z): consecutive, their lengths differing by
    at most one stage."""
    stages = K // KERNEL_K
    blocks = int4_tiles(M, N)
    S = 1
    if blocks < sms:
        S = max(1, min(-(-SPLIT_BLOCKS_PER_SM * sms // blocks), stages // SPLIT_MIN_STAGES,
                       SPLIT_MAX))
    base, rem = divmod(stages, S)
    return S, [(z * base + min(z, rem), (z + 1) * base + min(z + 1, rem)) for z in range(S)]


def int4_decode_plan(M: int, K: int, N: int, g: int, sms: int,
                     resident: int) -> tuple[int, int, int] | None:
    """The decode kernel's stream-K plan for x [M, K] @ [K, N] with group g
    on a card of `sms` SMs that keeps `resident` decode blocks an SM (the
    kernel's own count: `int4_decode_resident`): (blocks, tiles, steps), or
    None where the decode kernel does not take the shape (more than
    DECODE_MAX_ROWS rows, fewer than DECODE_MIN_BYTES packed bytes, N not a
    multiple of 16, K/2 or g not a multiple of DECODE_STEP_ROWS). A step is
    DECODE_STEP_ROWS packed rows of a tile of DECODE_COLUMNS output columns;
    the steps of all tiles, tile after tile, are cut into `blocks` ranges
    (`int4_decode_ranges`), `resident` an SM, so every SM reads the same
    bytes to within a step a block, or a step a block where there are fewer
    steps."""
    if (M > DECODE_MAX_ROWS or K // 2 * N < DECODE_MIN_BYTES or N % 16
            or g % DECODE_STEP_ROWS or (K // 2) % DECODE_STEP_ROWS):
        return None
    tiles = -(-N // DECODE_COLUMNS)
    steps = tiles * (K // 2 // DECODE_STEP_ROWS)
    blocks = min(resident * sms, steps)
    return blocks, tiles, steps


def int4_decode_ranges(steps: int, blocks: int) -> list[tuple[int, int]]:
    """The step range [begin, end) of each decode block (the kernel's own:
    block b takes [b S / B, (b + 1) S / B))."""
    return [(b * steps // blocks, (b + 1) * steps // blocks) for b in range(blocks)]


@functools.lru_cache(maxsize=256)
def _launch_plan(M: int, K: int, N: int, g: int, index: int) -> tuple[int, int, int]:
    """(blocks, splits, tiles) of a bf16 launch on card `index`: the decode
    kernel's blocks and tiles (each tile a counter), or 0 blocks and the
    staged kernel's split plan at the card's SM count. Cached: a decode step
    makes ~200 calls of a few shapes."""
    sms = torch.cuda.get_device_properties(index).multi_processor_count
    plan = None
    if M <= DECODE_MAX_ROWS:
        resident = int4_decode_resident(index)[M > DECODE_TILE_ROWS]
        plan = int4_decode_plan(M, K, N, g, sms, resident)
    if plan is not None:
        return plan[0], 1, plan[1]
    return 0, int4_split_plan(M, K, N, sms)[0], 0


@functools.lru_cache(maxsize=16)
def int4_decode_resident(index: int) -> tuple[int, int]:
    """The decode kernel's resident blocks an SM on card `index`, for up to
    8 and up to 16 rows of x (the occupancy calculator's, of the kernel as
    built: its shared memory and launch bounds set the count, and
    `int4_decode_plan` takes it from here)."""
    out = (ctypes.c_int * 2)()
    with torch.cuda.device(index):
        check(kernels().vr2_int4_matmul_layout(out), "int4 decode kernel layout")
    if min(out) < 1:
        raise RuntimeError(f"int4 decode kernel: {tuple(out)} blocks resident an SM")
    return out[0], out[1]


def int4_matmul(x: torch.Tensor, wq: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """x [M, K] @ dequant(wq [K/2, N] int8, scale [K/g, N] fp32) -> [M, N]
    in x's dtype. CUDA tensors launch the kernel (fp32 sums, each weight
    dequantised in fp32 and rounded to x's dtype before its product, as the
    TPU kernel casts its tile to x's dtype), outside autograd only (the kernel
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
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"int4 kernel: x must be bfloat16 or float32, got {x.dtype}")
    for name, t, dtype in (("x", x, x.dtype), ("wq", wq, torch.int8),
                           ("scale", scale, torch.float32)):
        if t.device != dev:
            raise ValueError(f"int4 kernel: {name} on {t.device}, x on {dev}")
        if t.dtype != dtype:
            raise TypeError(f"int4 kernel: {name} must be {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"int4 kernel: {name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"int4 kernel: {name} must be 16-byte aligned")
    out = torch.empty((M, N), dtype=x.dtype, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    if x.dtype == torch.float32:
        err = kernels().vr2_int4_matmul_f32(x.data_ptr(), wq.data_ptr(), scale.data_ptr(),
                                            out.data_ptr(), M, K, N, g, stream)
    else:
        blocks, S, tiles = _launch_plan(M, K, N, g, dev.index)
        part = counters = None
        if blocks:      # two parts of M x DECODE_COLUMNS a block
            part, counters = split_workspace(dev, stream, 2 * blocks * M * DECODE_COLUMNS, tiles)
        err = kernels().vr2_int4_matmul(
            x.data_ptr(), wq.data_ptr(), scale.data_ptr(), out.data_ptr(), M, K, N, g, S,
            None if part is None else part.data_ptr(),
            None if counters is None else counters.data_ptr(), blocks, stream)
    check(err, "int4 matmul kernel")
    return out
