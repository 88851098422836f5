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

On CUDA tensors each launches its entry of ``csrc/int8_matmul.cu`` (bf16 x
of any M >= 1 rows, any K and N), outside autograd, and raises
on anything the kernel does not take; on CPU tensors it runs its `*_plain`
version. `int8_matmul` sends 1 to 16 rows over a K of at least 256 and an N
that 128 divides (the 7B's decode linears and head) to the decode kernel,
on the plan of `int8_decode_plan`, and the rest to the staged kernel.
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
    dtype. CUDA tensors launch the kernel; CPU tensors run the plain
    version."""
    if x.device.type == "cpu":
        return int8_matmul_plain(x, wq, scale)
    _refuse_autograd(x, scale)
    splits = None
    if x.dim() == 2 and wq.dim() == 2 and x.shape[0] <= DECODE_MAX_ROWS:
        splits = _decode_plan(x.shape[0], wq.shape[0], wq.shape[1], x.get_device())
    if splits is None:
        out = _launch("vr2_int8_matmul", x, wq, scale, (), False)
    else:
        out = _launch_decode(x, wq, scale, splits)
        int8_matmul.decode_launches += 1
    int8_matmul.launches += 1
    return out


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
    out = _launch("vr2_int8_matmul_stacked", x, wq, scale, (L, layer), False)
    int8_matmul_stacked.launches += 1
    return out


def int8_matmul_all_layers(x: torch.Tensor, wq: torch.Tensor,
                           scale: torch.Tensor) -> torch.Tensor:
    """[L, M, N]: x [M, K] @ wq[l], times scale[l], for every layer of
    wq [L, K, N] and scale [L, N], in one launch."""
    if x.device.type == "cpu":
        return int8_matmul_all_layers_plain(x, wq, scale)
    _refuse_autograd(x, scale)
    out = _launch("vr2_int8_matmul_all_layers", x, wq, scale, (wq.shape[0],), True)
    int8_matmul_all_layers.launches += 1
    return out


int8_matmul.launches = 0              # kernel launches (CUDA only), either kernel
int8_matmul.decode_launches = 0       # ... of them on the decode kernel
int8_matmul_stacked.launches = 0
int8_matmul_all_layers.launches = 0


def _launch(entry: str, x, wq, scale, extra: tuple, all_layers: bool) -> torch.Tensor:
    """Check the operands (wq [K, N] and scale [N] for the one-layer entry,
    wq [L, K, N] and scale [L, N] for the others) and launch `entry`."""
    M, K, L, N = _check(x, wq, scale, 2 if entry == "vr2_int8_matmul" else 3)
    dev = x.device
    out = torch.empty(((L,) if all_layers else ()) + (M, N), dtype=torch.bfloat16, device=dev)
    err = getattr(kernels(), entry)(x.data_ptr(), wq.data_ptr(), scale.data_ptr(),
                                    out.data_ptr(), M, K, N, *extra,
                                    torch.cuda.current_stream(dev).cuda_stream)
    check(err, f"int8 matmul kernel ({entry})")
    return out


def _launch_decode(x, wq, scale, splits: int) -> torch.Tensor:
    """Check the operands (wq [K, N], scale [N]) and launch the decode
    kernel with `splits` splits of each tile's K."""
    M, K, _, N = _check(x, wq, scale, 2)
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
    its plain version); more rows, or x of another dtype, converted to x's
    dtype and multiplied with torch.matmul, the scale in x's dtype, as the
    reference's XLA path. Chosen by dtype and rows up front."""
    lead, K = x.shape[:-1], x.shape[-1]
    x2 = x.reshape(-1, K)
    if x.dtype == torch.bfloat16 and 0 < x2.shape[0] <= INT8_KERNEL_MAX_ROWS:
        fn = int8_matmul if impl == "kernel" else int8_matmul_plain
        y = fn(x2.contiguous(), wq, scale)
    else:
        y = torch.matmul(x2, wq.to(x.dtype)) * scale.to(x.dtype)
    return y.reshape(*lead, wq.shape[-1])
