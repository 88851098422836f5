#!/usr/bin/env python3
"""The MoE kernels of the PyTorch port at the judge's shapes, on one NVIDIA
GPU: the bf16 and int8-weight ragged decode FFN and the GMM backward's dX
and weight gradients, each timed eagerly and in a CUDA graph (device time)
beside the library call timed both ways (for int8 weights, which no single
PyTorch call takes: the bf16 kernel at the same routing) and the bound.

    python3 scripts/bench_moe_kernels.py                 # this checkout's port
    python3 scripts/bench_moe_kernels.py --root DIR      # another checkout's
    python3 scripts/bench_moe_kernels.py --cases dx,dw   # some of the cases

Shapes (Qwen3-30B-A3B: E 128, H 2048, I 768, top 8; one layer's weights,
seeded and scaled like chip_smoke.py phase 10's): the grouped FFN (csrc/
moe_ffn.cu) in the ragged decode table at phase 10's T = 16 (and phase 11's
paged pass, T = 8), the library call three torch._grouped_mm and the
SwiGLU over the routed rows (the GMM prefill cases also with the SM clock
and power draw nvidia-smi reads while they run); the same with the
layer's int8 weights
(quantize_kernel) at T = 16, 8 and 4 (phase 11's int8 pass); the GMM
prefill FFN at T = 4096 in bf16 (its wgmma kernels share the ring with
dX), over the int8 weights with bf16 x and in W8A8 (int8 x by
quantize_rows), the last two beside the bf16 kernel at the same routing;
dX of the GMM backward (csrc/
moe_gmm_bwd.cu) at phase 14's T = 4096 and phase 15's T = 2048, the
library call chip_smoke.gmm_bwd_library's (five torch._grouped_mm and the
SwiGLU terms); the weight gradients dWg / dWu and dWd at phase 14's T =
4096, from the dX kernel's dg / du / h, the library call two and one
torch._grouped_mm (2d x 2d, grouped along the rows), the bound at the
weights' bf16 (the port before it wrote fp32 and converted). Each case
also gives its kernels' device time from
torch.profiler and the wrapper's host time a call (the enqueue time of
back-to-back calls: what a host-bound decode loop pays for it). The
helpers are chip_smoke.py's, from this checkout; the port timed is the one
under --root. Prints one JSON line a case, then the card's name and power
limit (nvidia-smi). To compare two versions on one card, run them in turns
in one command (parent, change, change, parent).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
DECODE_TOKENS = (16, 8)       # phase 10's ragged decode, phase 11's paged pass
INT8_DECODE_TOKENS = (16, 8, 4)   # ... and phase 11's int8 pass
PREFILL_TOKENS = 4096         # phase 10's GMM prefill
DX_TOKENS = (4096, 2048)      # phases 14 and 15
DW_TOKENS = 4096              # phase 14


def kernel_us(fn, calls: int = 5) -> dict:
    """{kernel name: device microseconds a call} over `calls` calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return {e.key[:80]: e.device_time_total / calls for e in prof.key_averages()
            if e.device_time_total > 0}


def host_us(fn, calls: int = 50) -> float:
    """Host microseconds a call: the enqueue time of `calls` back-to-back
    calls (the card runs behind, so none waits on it), after a warm call."""
    import time

    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / calls * 1e6


def under_load(fn, seconds: float = 2.0) -> dict:
    """The card's SM clock (MHz) and power draw (W), nvidia-smi's medians
    over `seconds` of back-to-back calls of fn: what the timed calls ran at
    (a card below its maximum clock under this load runs every rate below
    the data sheet's)."""
    import statistics
    import time

    import torch

    smi = subprocess.Popen(["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                            "--format=csv,noheader,nounits", "-lms", "100"],
                           stdout=subprocess.PIPE, text=True)
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        for _ in range(10):
            fn()
        torch.cuda.synchronize()
    smi.terminate()
    rows = [line.split(",") for line in smi.communicate()[0].splitlines() if "," in line]
    smi.wait()
    if not rows:
        return {}
    return {"sm_clock_mhz": statistics.median(float(c) for c, _ in rows),
            "power_w": statistics.median(float(w) for _, w in rows)}


def device_ms(fn) -> float | None:
    """chip_smoke.graph_ms, or None where a library call does not capture
    (a probe of the yardstick, not of the port)."""
    import chip_smoke

    try:
        return chip_smoke.graph_ms(fn)
    except RuntimeError as e:
        print(f"no device time: {str(e)[:160]}", file=sys.stderr)
        return None


def judge_layer(device, seed: int):
    """(router [H, E], bf16 leaves) of one seeded judge-width MoE layer."""
    import torch

    from video_r2_tpu_torch.models.config import qwen3_moe_30b_a3b

    tc = qwen3_moe_30b_a3b().text
    E, H, I = tc.num_experts, tc.hidden_size, tc.moe_intermediate_size
    gen = torch.Generator(device=device).manual_seed(seed)
    randw = lambda *s: (torch.randn(*s, generator=gen, device=device)  # noqa: E731
                        * s[-2] ** -0.5).to(torch.bfloat16)
    leaves = {"gate": {"kernel": randw(E, H, I)}, "up": {"kernel": randw(E, H, I)},
              "down": {"kernel": randw(E, I, H)}}
    return randw(H, E), leaves, gen


def ffn_case(router, leaves, gen, T: int, layout: str, int8: dict | None = None,
             w8a8: bool = False) -> dict:
    """The bf16 grouped FFN at T tokens in the ragged table or the GMM
    blocks: eager and device ms, the library's, the bound, its kernels; with
    `int8` leaves, the int8-weight FFN instead (with w8a8, over x quantized
    by rows: W8A8), the bf16 kernel at the same routing in the library's
    place."""
    import torch

    import chip_smoke
    from video_r2_tpu_torch.models.moe import route
    from video_r2_tpu_torch.ops import moe_ragged
    from video_r2_tpu_torch.ops.moe_gmm import auto_block_rows, gmm_layout

    E, H, I = leaves["gate"]["kernel"].shape
    x = torch.randn(T, H, generator=gen, device=gen.device).to(torch.bfloat16)
    _, topi = route(router, x, 8, True)
    if layout == "ragged":
        xs, ids, valid, _ = moe_ragged.ragged_layout(x, topi, E)
    else:
        xs, ids, valid, _ = gmm_layout(x, topi, E, auto_block_rows(T * 8, E))
    variant = "bf16" if int8 is None else "w8a8" if w8a8 else "int8"
    g, u, d = (leaves[n] for n in ("gate", "up", "down"))
    if int8 is None:
        library = chip_smoke.grouped_mm_library(x, topi, leaves, E)
    else:       # the yardstick: the bf16 kernel at the same routing
        library = lambda g=g, u=u, d=d: moe_ragged.ragged_expert_ffn(  # noqa: E731
            xs, ids, g, u, d, blk_valid=valid)
        g, u, d = (int8[n] for n in ("gate", "up", "down"))
    xq, ax = moe_ragged.quantize_rows(xs) if w8a8 else (xs, None)
    run = lambda: moe_ragged.ragged_expert_ffn(xq, ids, g, u, d, blk_valid=valid,  # noqa: E731
                                               x_scales=ax)
    bi = moe_ragged._block_i(xq, moe_ragged._weights(g, u, d)[1], ax, 512)
    ref = moe_ragged.ragged_expert_ffn_plain(xq, ids, g, u, d, bi, valid, ax)
    err, excess = chip_smoke.compare(run(), ref)
    n_exp = int(torch.unique(topi).numel())
    r = {"ms": chip_smoke.cuda_ms(run), "device_ms": device_ms(run), "host_us": host_us(run),
         **(under_load(run) if layout == "gmm" else {}),
         "library_ms": chip_smoke.cuda_ms(library) if library else None,
         "library_device_ms": device_ms(library) if library else None,
         **chip_smoke.moe_bound(T * 8, n_exp, H, I, variant),
         "max_abs_err": err, "excess": excess, "experts": n_exp,
         "shape": list(xs.shape), "kernels_us": kernel_us(run)}
    if int8 is not None:
        r["library"] = "the bf16 kernel at the same routing"
        r["bf16_bound_ms"] = chip_smoke.moe_bound(T * 8, n_exp, H, I, "bf16")["bound_ms"]
    if hasattr(moe_ragged, "ffn_decode_tiles"):
        r["launch"] = chip_smoke.ffn_launch_line(variant, xs.shape[0], xs.shape[1], H, I)
    return r


def dx_case(router, leaves, gen, T: int) -> dict:
    """dX of the GMM backward at T tokens: eager and device ms, the
    library's, the bound, its kernels."""
    import torch

    import chip_smoke
    from video_r2_tpu_torch.models.moe import route
    from video_r2_tpu_torch.ops import moe_gmm as gmm

    E, H, I = leaves["gate"]["kernel"].shape
    wg, wu, wd = (leaves[n]["kernel"] for n in ("gate", "up", "down"))
    with torch.no_grad():
        x = torch.randn(T, H, generator=gen, device=gen.device).to(torch.bfloat16)
        topv, topi = route(router, x, 8, True)
        bm = gmm.auto_block_rows(T * 8, E)
        xs, ids, valid, dst = gmm.gmm_layout(x, topi, E, bm)
        dys = gmm.sorted_dy(torch.randn(T * 8, H, generator=gen, device=gen.device), topv,
                            dst, xs.shape, xs.dtype)
        run = lambda: gmm.gmm_bwd_dx(xs, dys, ids, valid, wg, wu, wd)  # noqa: E731
        dx, dg, du, h = gmm.gmm_bwd_dx(xs, dys, ids, valid, wg, wu, wd, keep_h=True)
        ref = gmm.gmm_bwd_dx_plain(xs, dys, ids, valid, wg, wu, wd)[0]
        rel = chip_smoke.rel_l2(dx, ref)
        del ref
        rows = torch.zeros(E, dtype=torch.int32, device=gen.device).index_add_(
            0, ids.long(), valid.int()) * bm
        library = chip_smoke.gmm_bwd_library(xs, dg, du, h, dys, wg, wu, wd,
                                             rows)["moe_gmm_bwd_dx"]
        n_exp = int(torch.unique(topi).numel())
        r = {"ms": chip_smoke.cuda_ms(run, iters=10), "device_ms": device_ms(run),
             "host_us": host_us(run, calls=10),
             "library_ms": chip_smoke.cuda_ms(library, iters=10) if library else None,
             **chip_smoke.gmm_bwd_bounds(T * 8, n_exp, E, H, I)["moe_gmm_bwd_dx"],
             "rel_l2": rel, "experts": n_exp, "shape": [xs.shape[0], bm, H, I],
             "kernels_us": kernel_us(run)}
        if hasattr(gmm, "gmm_bwd_dx_tiles"):
            r["launch"] = chip_smoke.gmm_dx_launch_line(xs.shape[0], bm, H, I)
    return r


def dw_cases(router, leaves, gen, T: int) -> dict:
    """dWg / dWu and dWd of the GMM backward at T tokens, from the dX
    kernel's dg / du / h: {kernel name: eager and device ms, the library's
    both ways, the bound, the relative L2 against the plain version, the
    output dtype, its kernels}."""
    import torch

    import chip_smoke
    from video_r2_tpu_torch.models.moe import route
    from video_r2_tpu_torch.ops import moe_gmm as gmm

    E, H, I = leaves["gate"]["kernel"].shape
    wg, wu, wd = (leaves[n]["kernel"] for n in ("gate", "up", "down"))
    out = {}
    with torch.no_grad():
        x = torch.randn(T, H, generator=gen, device=gen.device).to(torch.bfloat16)
        topv, topi = route(router, x, 8, True)
        bm = gmm.auto_block_rows(T * 8, E)
        xs, ids, valid, dst = gmm.gmm_layout(x, topi, E, bm)
        dys = gmm.sorted_dy(torch.randn(T * 8, H, generator=gen, device=gen.device), topv,
                            dst, xs.shape, xs.dtype)
        _, dg, du, h = gmm.gmm_bwd_dx(xs, dys, ids, valid, wg, wu, wd, keep_h=True)
        rows = torch.zeros(E, dtype=torch.int32, device=gen.device).index_add_(
            0, ids.long(), valid.int()) * bm
        library = chip_smoke.gmm_bwd_library(xs, dg, du, h, dys, wg, wu, wd, rows)
        n_exp = int(torch.unique(topi).numel())
        bounds = chip_smoke.gmm_bwd_bounds(T * 8, n_exp, E, H, I)
        runs = {"moe_gmm_bwd_dw": (lambda: gmm.gmm_bwd_dw(xs, dg, du, ids, valid, E),
                                   lambda: gmm.gmm_bwd_dw_plain(xs, dg, du, ids, valid, E),
                                   (H, I, 2)),
                "moe_gmm_bwd_dwd": (lambda: gmm.gmm_bwd_dwd(h, dys, ids, valid, E),
                                    lambda: gmm.gmm_bwd_dwd_plain(h, dys, ids, valid, E),
                                    (I, H, 1))}
        for name, (run, plain, (M, N, nb)) in runs.items():
            got, ref = run(), plain()
            got = tuple(got) if isinstance(got, (tuple, list)) else (got,)
            ref = tuple(ref) if isinstance(ref, (tuple, list)) else (ref,)
            lib = library[name]
            r = {"ms": chip_smoke.cuda_ms(run, iters=10), "device_ms": device_ms(run),
                 "library_ms": chip_smoke.cuda_ms(lib, iters=10) if lib else None,
                 "library_device_ms": device_ms(lib) if lib else None, **bounds[name],
                 "rel_l2": max(chip_smoke.rel_l2(a, b) for a, b in zip(got, ref)),
                 "dtype": str(got[0].dtype), "experts": n_exp, "shape": [xs.shape[0], bm, H, I],
                 "kernels_us": kernel_us(run)}
            if hasattr(gmm, "gmm_bwd_dw_layout"):
                r["launch"] = chip_smoke.gmm_dw_launch_line(M, N, E, nb)
            out[name] = r
            del got, ref
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(REPO),
                    help="checkout whose video_r2_tpu_torch is timed")
    ap.add_argument("--label", default="", help="a tag printed on every line")
    ap.add_argument("--cases", default="decode,prefill,dx,dw",
                    help="which cases, comma-separated: decode, prefill, dx, dw")
    args = ap.parse_args()
    cases = set(args.cases.split(","))
    import torch

    if not torch.cuda.is_available():
        print("bench_moe_kernels: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(args.root).resolve()))
    sys.path.insert(1, str(REPO))
    import chip_smoke
    from video_r2_tpu_torch.ops import cuda_build

    torch.backends.cuda.matmul.allow_tf32 = False
    lib = cuda_build.kernels()
    chip_smoke.register_report(Path(lib._name).with_suffix(".log"))
    device = torch.device("cuda")
    router, leaves, gen = judge_layer(device, chip_smoke.SEED + 3)

    def emit(kernel: str, what: str, r: dict) -> None:
        line = {"label": args.label, "kernel": kernel, "what": what, **r}
        for key in ("ms", "device_ms"):
            if r.get(key):
                line[f"of_bound_{key}"] = r["bound_ms"] / r[key]
        print(json.dumps(line), flush=True)

    for T in DECODE_TOKENS if "decode" in cases else ():
        emit("moe_ffn_bf16_ragged", f"ragged decode, T={T}",
             ffn_case(router, leaves, gen, T, "ragged"))
    if "decode" in cases:
        from video_r2_tpu_torch.models.quant import quantize_kernel

        int8 = {n: quantize_kernel(leaf["kernel"]) for n, leaf in leaves.items()}
        for T in INT8_DECODE_TOKENS:
            emit("moe_ffn_int8_ragged", f"int8-weight ragged decode, T={T}",
                 ffn_case(router, leaves, gen, T, "ragged", int8))
        del int8
    if "prefill" in cases:
        from video_r2_tpu_torch.models.quant import quantize_kernel

        emit("moe_ffn_bf16_gmm", f"GMM prefill, T={PREFILL_TOKENS}",
             ffn_case(router, leaves, gen, PREFILL_TOKENS, "gmm"))
        int8 = {n: quantize_kernel(leaf["kernel"]) for n, leaf in leaves.items()}
        for variant in ("int8", "w8a8"):
            emit(f"moe_ffn_{variant}_gmm", f"{variant} GMM prefill, T={PREFILL_TOKENS}",
                 ffn_case(router, leaves, gen, PREFILL_TOKENS, "gmm", int8,
                          w8a8=variant == "w8a8"))
        del int8
        torch.cuda.empty_cache()
    for T in DX_TOKENS if "dx" in cases else ():
        emit("moe_gmm_bwd_dx", f"GMM backward dX, T={T}", dx_case(router, leaves, gen, T))
        torch.cuda.empty_cache()
    if "dw" in cases:
        for name, r in dw_cases(router, leaves, gen, DW_TOKENS).items():
            emit(name, f"GMM backward {name[12:]}, T={DW_TOKENS}", r)
        torch.cuda.empty_cache()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
