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
version. `quantized_linear_auto` is the dispatcher the int8 linears call
(models/layers.py::Linear): 1 to `INT8_KERNEL_MAX_ROWS` rows of bf16
activations go to `int8_matmul` (the plain version on the CPU); more rows,
and x of any other dtype (the kernel takes bf16 only), are converted to x's
dtype and multiplied with torch.matmul, as the reference leaves them to XLA.
"""

from __future__ import annotations

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
    out = _launch("vr2_int8_matmul", x, wq[None], scale[None], (), False)
    int8_matmul.launches += 1
    return out


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


int8_matmul.launches = 0              # kernel launches (CUDA only)
int8_matmul_stacked.launches = 0
int8_matmul_all_layers.launches = 0


def _launch(entry: str, x, wq, scale, extra: tuple, all_layers: bool) -> torch.Tensor:
    """Check the operands (wq [L, K, N], scale [L, N]) and launch `entry`."""
    if x.dim() != 2 or wq.dim() != 3 or scale.dim() != 2:
        raise ValueError(f"int8 kernel: x [M, K], wq [(L,) K, N] and scale [(L,) N], got "
                         f"{tuple(x.shape)}, {tuple(wq.shape)}, {tuple(scale.shape)}")
    M, K = x.shape
    L, Kw, N = wq.shape
    if Kw != K or tuple(scale.shape) != (L, N):
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
    out = torch.empty(((L,) if all_layers else ()) + (M, N), dtype=torch.bfloat16, device=dev)
    err = getattr(kernels(), entry)(x.data_ptr(), wq.data_ptr(), scale.data_ptr(),
                                    out.data_ptr(), M, K, N, *extra,
                                    torch.cuda.current_stream(dev).cuda_stream)
    check(err, f"int8 matmul kernel ({entry})")
    return out


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
