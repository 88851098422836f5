"""Int8 weight-only matmul: x @ int8 weights, times per-column scales.

Port of ``video_r2_tpu/ops/int8_matmul.py`` and of the all-layers kernel of
``scripts/microbench_int8.py``. A quantized linear holds int8 ``wq``
[K, N] and fp32 ``scale`` [N] (models/quant.py); the product is
(x @ wq) * scale with every int8 weight converted to x's dtype (exact), the
sums in fp32, the scale in fp32 and one rounding to x's dtype, as the TPU
kernels compute it. Three wrappers, one per TPU kernel:

- `int8_matmul` (``_kernel``): x [M, K] @ wq [K, N];
- `int8_matmul_stacked` (``_stacked_kernel``): layer `layer` of a stacked
  wq [L, K, N], scale [L, N], read in place (no wq[layer] slice copy);
- `int8_matmul_all_layers` (the microbench's ``_kernel_all``): every layer
  of the stack in one launch, out [L, M, N].

On CUDA tensors each launches a kernel of ``csrc/int8_matmul.cu`` (bf16
x of any M >= 1 rows, any K and N), outside autograd, and raises on
anything the kernels do not take; on CPU tensors it runs its `*_plain`
version. The kernel is chosen by shape, up front: `int8_matmul` sends 1 to
16 rows over a K of at least 256 and an N that 128 divides (the 7B's
decode linears and head) to the decode kernel, on the plan of
`int8_decode_plan`; every other shape whose rows TMA can map (K % 8 == 0,
N % 16 == 0), of all three wrappers, goes to the wide kernel (TMA and
wgmma), on the plan of `int8_wide_plan`; the rest (the ViT's 3420, odd
widths) to the element-load kernel.
`quantized_linear_auto` is the dispatcher the int8 linears call
(models/layers.py::Linear): 1 to `INT8_KERNEL_MAX_ROWS` rows of bf16
activations go to `int8_matmul` (the plain version on the CPU); more rows,
and x of any other dtype (the kernel takes bf16 only), are converted to x's
dtype and multiplied with torch.matmul, as the reference leaves them to XLA.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .cuda_build import check, kernels

# The dispatcher's row limit, measured on the card by chip_smoke.py phase 16
# (the kernel against convert + torch.matmul at the 7B's gate / up, 3584 ->
# 18944, and q, 3584 -> 3584; cold weights): the largest of M = 1, 4, 16,
# 64, 256, 1024 at which the kernel is no slower at both shapes. On an
# NVIDIA H100 80GB HBM3 at a 700 W power limit, ms kernel / convert +
# matmul, gate / up then q:
#   M = 1     0.0456 / 0.2458   0.0501 / 0.0804
#   M = 4     0.0454 / 0.2462   0.0434 / 0.0710
#   M = 16    0.0489 / 0.2475   0.0439 / 0.0793
#   M = 64    0.0759 / 0.2481   0.0584 / 0.0982
#   M = 256   0.2170 / 0.2630   0.0644 / 0.0983
#   M = 1024  0.7023 / 0.4163   0.1506 / 0.0912
# A second run of the same table on the same card: M = 256 0.2160 / 0.2605,
# 0.0619 / 0.0922; M = 1024 0.6925 / 0.4129, 0.1494 / 0.0882. Sub-ms times
# vary between runs, so phase 16 prints each run's table and flags a run
# whose largest winning M differs from this constant.
# Not the reference's 0, which was measured on a TPU for a cause this port
# does not have (a per-layer slice copy of a stacked weight inside lax.scan).
INT8_KERNEL_MAX_ROWS = 256

DECODE_MAX_ROWS = 16      # the decode kernel's rows of x at most
DECODE_TILE_ROWS = 8      # rows of an x tile of the decode kernel (its instances hold 1 or 2)
DECODE_COLUMNS = 128      # output columns of a decode tile: a 128-byte box row of int8
DECODE_STEP_K = 64        # k of a decode step: 64 rows of a weight box
DECODE_MIN_STEPS = 4      # K / DECODE_STEP_K at least: a smaller K stays on the staged kernel
DECODE_SPLIT_MIN_STEPS = 2  # a split keeps at least this many steps
DECODE_MAX_SPLITS = 16    # splits of a tile at most: one thread-block cluster

WIDE_ROWS = (32, 64, 128)  # the wide kernel's row tiles (wgmma's N), one instance each
WIDE_COLUMNS = 128         # output columns of a wide block: a 128-byte box row of int8
WIDE_STEP_K = 64           # k of a wide stage
WIDE_SPLIT_MIN_STEPS = 2   # a split keeps at least this many steps
WIDE_MAX_SPLITS = 16       # splits of a tile at most: one thread-block cluster


def int8_matmul_plain(x: torch.Tensor, wq: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """(x @ wq) * scale in fp32, rounded once to x's dtype: x [M, K], wq
    [K, N] int8, scale [N]."""
    return ((x.float() @ wq.float()) * scale.float()).to(x.dtype)


def int8_matmul_stacked_plain(x, wq, scale, layer: int) -> torch.Tensor:
    return int8_matmul_plain(x, wq[layer], scale[layer])


def int8_matmul_all_layers_plain(x, wq, scale) -> torch.Tensor:
    """[L, M, N]: every layer of wq [L, K, N], scale [L, N], one at a time."""
    return torch.stack([int8_matmul_plain(x, wq[i], scale[i]) for i in range(wq.shape[0])])


def _refuse_autograd(x, scale) -> None:
    if torch.is_grad_enabled() and (x.requires_grad or scale.requires_grad):
        raise NotImplementedError("the int8 kernel has no backward: call it outside "
                                  "autograd (int8 weights do not train)")


def int8_matmul(x: torch.Tensor, wq: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """x [M, K] @ wq [K, N] int8, times scale [N] fp32 -> [M, N] in x's
    dtype. CUDA tensors launch the kernel `int8_route` picks by shape
    (decode, wide or element-load); CPU tensors run the plain version."""
    if x.device.type == "cpu":
        return int8_matmul_plain(x, wq, scale)
    _refuse_autograd(x, scale)
    dims = _check(x, wq, scale, 2)
    route, plan = int8_route(dims[0], dims[1], dims[3], 1, x.get_device())
    if route == "decode":
        out = _launch_decode(x, wq, scale, plan, dims)
        int8_matmul.decode_launches += 1
    else:
        out = _launch(x, wq, scale, dims, 0, 1, False, plan)
        int8_matmul.wide_launches += route == "wide"
    int8_matmul.launches += 1
    return out


def int8_route(M: int, K: int, N: int, layers: int, index: int,
               decode: bool = True) -> tuple[str, object]:
    """The kernel a CUDA call of x [M, K] @ [K, N] over `layers` layers
    takes on card `index`, by shape, up front: ("decode", splits) where
    `decode` (the one-layer entry) and the decode plan takes the shape,
    else ("wide", (row tile, splits)) where TMA can map the operands, else
    ("element", None)."""
    if decode and M <= DECODE_MAX_ROWS:
        splits = _decode_plan(M, K, N, index)
        if splits is not None:
            return "decode", splits
    plan = _wide_plan(M, K, N, layers, index)
    return ("element", None) if plan is None else ("wide", plan)


def int8_decode_plan(M: int, K: int, N: int, sms: int, resident: int,
                     clusters: tuple[int, ...]) -> int | None:
    """The decode kernel's splits S of a tile's K for x [M, K] @ [K, N] on
    a card of `sms` SMs that keeps `resident` decode blocks an SM and
    clusters[S - 1] clusters of S blocks at once (the kernel's own counts:
    `int8_decode_layout`), or None where the decode kernel does not take
    the shape (more than DECODE_MAX_ROWS rows, N not a multiple of
    DECODE_COLUMNS, K not a multiple of DECODE_STEP_K or under
    DECODE_MIN_STEPS steps). A tile is DECODE_COLUMNS output columns, a
    step DECODE_STEP_K of its k; the S splits of a tile are one
    thread-block cluster, tiles x S blocks in all. S = 1 where the tiles
    alone give every resident slot a block (the head's 1188), else the
    largest S <= DECODE_MAX_SPLITS that keeps DECODE_SPLIT_MIN_STEPS steps
    a split, tiles x S within the resident slots and every cluster
    resident at once, so the grid is one wave."""
    if (not 0 < M <= DECODE_MAX_ROWS or N % DECODE_COLUMNS or K % DECODE_STEP_K
            or K // DECODE_STEP_K < DECODE_MIN_STEPS):
        return None
    tiles, ks = N // DECODE_COLUMNS, K // DECODE_STEP_K
    S = 1
    for s in range(2, min(DECODE_MAX_SPLITS, ks // DECODE_SPLIT_MIN_STEPS) + 1):
        if tiles * s <= resident * sms and tiles <= clusters[s - 1]:
            S = s
    return S


@functools.lru_cache(maxsize=16)
def int8_decode_layout(index: int) -> tuple[tuple[int, int], tuple[tuple[int, ...], ...]]:
    """The decode kernel's residency on card `index` (the occupancy
    calculator's, of the kernel as built): (blocks an SM for up to 8 and up
    to 16 rows of x, and for each the clusters of S = 1 .. 16 blocks the
    card holds at once)."""
    out = (ctypes.c_int * (2 + 2 * DECODE_MAX_SPLITS))()
    with torch.cuda.device(index):
        check(kernels().vr2_int8_matmul_layout(out), "int8 decode kernel layout")
    if min(out[0], out[1]) < 1:
        raise RuntimeError(f"int8 decode kernel: {out[0]} / {out[1]} blocks resident an SM")
    n = DECODE_MAX_SPLITS
    return (out[0], out[1]), (tuple(out[2:2 + n]), tuple(out[2 + n:2 + 2 * n]))


@functools.lru_cache(maxsize=256)
def _decode_plan(M: int, K: int, N: int, index: int) -> int | None:
    """int8_decode_plan on card `index`. Cached: a decode step makes ~200
    calls of a few shapes."""
    if not 0 < M <= DECODE_MAX_ROWS:
        return None
    sms = torch.cuda.get_device_properties(index).multi_processor_count
    resident, clusters = int8_decode_layout(index)
    big = M > DECODE_TILE_ROWS
    return int8_decode_plan(M, K, N, sms, resident[big], clusters[big])


def int8_wide_plan(M: int, K: int, N: int, layers: int, sms: int,
                   clusters: tuple[tuple[int, ...], ...]) -> tuple[int, int] | None:
    """The wide kernel's (row tile, splits S of a tile's K) for x [M, K] @
    [K, N] over `layers` layers on a card of `sms` SMs that holds
    clusters[i][S - 1] clusters of S blocks of instance i (row tile
    WIDE_ROWS[i]) at once (the kernel's own counts: `int8_wide_layout`),
    or None where TMA cannot map the operands (K % 8: x's row pitch, N %
    16: the weights'; the element-load kernel takes those). The row tile
    is the smallest instance that holds M (M past the largest: row tiles
    of it); a block is one row tile of WIDE_COLUMNS output columns of one
    layer. S = 1 where the blocks alone give every SM one, else the
    largest S <= WIDE_MAX_SPLITS that keeps WIDE_SPLIT_MIN_STEPS steps of
    WIDE_STEP_K a split, at most one block an SM and every cluster
    resident at once. Measured on an H100 (PERF.md): a split grid past one
    block an SM, or past one wave, is slower (q / o at 64 rows: 4 splits
    0.0107 ms, 8 splits 0.0131; gate / up's 148 tiles: unsplit 0.0363, 2
    splits 0.0468)."""
    if M < 1 or K < 1 or N < 1 or layers < 1 or K % 8 or N % 16:
        return None
    i = next((i for i, r in enumerate(WIDE_ROWS) if M <= r), len(WIDE_ROWS) - 1)
    rows = WIDE_ROWS[i]
    blocks = -(-M // rows) * -(-N // WIDE_COLUMNS) * layers
    ks = -(-K // WIDE_STEP_K)
    S = 1
    for s in range(2, min(WIDE_MAX_SPLITS, ks // WIDE_SPLIT_MIN_STEPS) + 1):
        if blocks * s <= sms and blocks <= clusters[i][s - 1]:
            S = s
    return rows, S


@functools.lru_cache(maxsize=16)
def int8_wide_layout(index: int) -> tuple[tuple[int, ...], tuple[tuple[int, ...], ...]]:
    """The wide kernel's residency on card `index` (the occupancy
    calculator's, of the kernel as built): (blocks an SM of each instance
    of WIDE_ROWS, and for each the clusters of S = 1 .. 16 blocks the card
    holds at once)."""
    n = WIDE_MAX_SPLITS + 1
    out = (ctypes.c_int * (n * len(WIDE_ROWS)))()
    with torch.cuda.device(index):
        check(kernels().vr2_int8_matmul_wide_layout(out), "int8 wide kernel layout")
    resident = tuple(out[n * i] for i in range(len(WIDE_ROWS)))
    if min(resident) < 1:
        raise RuntimeError(f"int8 wide kernel: {resident} blocks resident an SM")
    return resident, tuple(tuple(out[n * i + 1:n * i + n]) for i in range(len(WIDE_ROWS)))


@functools.lru_cache(maxsize=256)
def _wide_plan(M: int, K: int, N: int, layers: int, index: int) -> tuple[int, int] | None:
    """int8_wide_plan on card `index`. Cached: a prefill makes ~200 calls
    of a few shapes."""
    if K % 8 or N % 16:
        return None
    sms = torch.cuda.get_device_properties(index).multi_processor_count
    return int8_wide_plan(M, K, N, layers, sms, int8_wide_layout(index)[1])


def int8_matmul_stacked(x: torch.Tensor, wq: torch.Tensor, scale: torch.Tensor,
                        layer: int) -> torch.Tensor:
    """x [M, K] @ wq[layer] (wq [L, K, N] int8), times scale[layer] (scale
    [L, N]) -> [M, N]; the kernel reads the layer in place."""
    if x.device.type == "cpu":
        return int8_matmul_stacked_plain(x, wq, scale, layer)
    _refuse_autograd(x, scale)
    L = wq.shape[0] if wq.dim() == 3 else 0
    if not 0 <= layer < L:
        raise ValueError(f"int8 kernel: layer {layer} of a stack of {L}")
    dims = _check(x, wq, scale, 3)
    route, plan = int8_route(dims[0], dims[1], dims[3], 1, x.get_device(), decode=False)
    out = _launch(x, wq, scale, dims, layer, 1, False, plan)
    int8_matmul_stacked.wide_launches += route == "wide"
    int8_matmul_stacked.launches += 1
    return out


def int8_matmul_all_layers(x: torch.Tensor, wq: torch.Tensor,
                           scale: torch.Tensor) -> torch.Tensor:
    """[L, M, N]: x [M, K] @ wq[l], times scale[l], for every layer of
    wq [L, K, N] and scale [L, N], in one launch."""
    if x.device.type == "cpu":
        return int8_matmul_all_layers_plain(x, wq, scale)
    _refuse_autograd(x, scale)
    dims = _check(x, wq, scale, 3)
    route, plan = int8_route(dims[0], dims[1], dims[3], dims[2], x.get_device(), decode=False)
    out = _launch(x, wq, scale, dims, 0, dims[2], True, plan)
    int8_matmul_all_layers.wide_launches += route == "wide"
    int8_matmul_all_layers.launches += 1
    return out


int8_matmul.launches = 0              # kernel launches (CUDA only), any kernel
int8_matmul.decode_launches = 0       # ... of them on the decode kernel
int8_matmul.wide_launches = 0         # ... of them on the wide kernel
int8_matmul_stacked.launches = 0
int8_matmul_stacked.wide_launches = 0
int8_matmul_all_layers.launches = 0
int8_matmul_all_layers.wide_launches = 0


def _launch(x, wq, scale, dims: tuple[int, int, int, int], layer0: int, layers: int,
            all_layers: bool, plan: tuple[int, int] | None) -> torch.Tensor:
    """Launch layers layer0 .. layer0 + layers - 1 of checked operands
    (dims: _check's (M, K, L, N)) on the wide kernel with plan (row tile,
    splits), or on the element-load kernel where plan is None: y
    [(layers,) M, N]."""
    M, K, L, N = dims
    dev = x.device
    out = torch.empty(((layers,) if all_layers else ()) + (M, N), dtype=torch.bfloat16,
                      device=dev)
    args = (x.data_ptr(), wq.data_ptr(), scale.data_ptr(), out.data_ptr(), M, K, N, L,
            layer0, layers)
    stream = torch.cuda.current_stream(dev).cuda_stream
    if plan is None:
        check(kernels().vr2_int8_matmul_elem(*args, stream), "int8 matmul element-load kernel")
    else:
        check(kernels().vr2_int8_matmul_wide(*args, *plan, stream), "int8 matmul wide kernel")
    return out


def _launch_decode(x, wq, scale, splits: int, dims=None) -> torch.Tensor:
    """Launch the decode kernel with `splits` splits of each tile's K on
    operands x, wq [K, N], scale [N] (checked here unless dims holds
    _check's (M, K, L, N))."""
    M, K, _, N = dims or _check(x, wq, scale, 2)
    dev = x.device
    out = torch.empty((M, N), dtype=torch.bfloat16, device=dev)
    err = kernels().vr2_int8_matmul_decode(
        x.data_ptr(), wq.data_ptr(), scale.data_ptr(), out.data_ptr(), M, K, N, splits,
        torch.cuda.current_stream(dev).cuda_stream)
    check(err, "int8 matmul decode kernel")
    return out


def _check(x, wq, scale, rank: int) -> tuple[int, int, int, int]:
    """(M, K, L, N) of operands x [M, K], wq [K, N] and scale [N] (rank 2;
    L = 1) or wq [L, K, N] and scale [L, N] (rank 3); raises on anything
    the kernels do not take."""
    if x.dim() != 2 or wq.dim() != rank or scale.dim() != rank - 1:
        raise ValueError(f"int8 kernel: x [M, K], wq [(L,) K, N] and scale [(L,) N], got "
                         f"{tuple(x.shape)}, {tuple(wq.shape)}, {tuple(scale.shape)}")
    M, K = x.shape
    Kw, N = wq.shape[-2:]
    L = wq.shape[0] if rank == 3 else 1
    if Kw != K or scale.shape != wq.shape[:-2] + (N,):
        raise ValueError(f"int8 kernel: x {tuple(x.shape)}, wq {tuple(wq.shape)} and scale "
                         f"{tuple(scale.shape)} do not match")
    if M < 1:
        raise ValueError("int8 kernel: x has no rows")
    dev = x.device
    for name, t, dtype in (("x", x, torch.bfloat16), ("wq", wq, torch.int8),
                           ("scale", scale, torch.float32)):
        if t.device != dev:
            raise ValueError(f"int8 kernel: {name} on {t.device}, x on {dev}")
        if t.dtype != dtype:
            raise TypeError(f"int8 kernel: {name} must be {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"int8 kernel: {name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"int8 kernel: {name} must be 16-byte aligned")
    return M, K, L, N


def quantized_linear_auto(x: torch.Tensor, wq: torch.Tensor, scale: torch.Tensor,
                          impl: str = "kernel") -> torch.Tensor:
    """x [..., K] @ an int8 leaf (wq [K, N], scale [N]) -> [..., N]: 1 to
    INT8_KERNEL_MAX_ROWS rows of bf16 x through `int8_matmul` (impl="plain":
    its plain version); more rows, x of another dtype, or a call that needs
    a gradient (grad enabled and x or scale requiring it: QLoRA's frozen
    base under adapters), converted to x's dtype and multiplied with
    torch.matmul, the scale in x's dtype, as the reference's XLA path, so
    autograd forms dX = dY (W s)^T. Chosen by dtype, rows and autograd up
    front."""
    lead, K = x.shape[:-1], x.shape[-1]
    x2 = x.reshape(-1, K)
    needs_grad = torch.is_grad_enabled() and (x.requires_grad or scale.requires_grad)
    if (x.dtype == torch.bfloat16 and 0 < x2.shape[0] <= INT8_KERNEL_MAX_ROWS
            and not needs_grad):
        fn = int8_matmul if impl == "kernel" else int8_matmul_plain
        y = fn(x2.contiguous(), wq, scale)
    else:
        y = torch.matmul(x2, wq.to(x.dtype)) * scale.to(x.dtype)
    return y.reshape(*lead, wq.shape[-1])
