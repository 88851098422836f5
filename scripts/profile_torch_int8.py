#!/usr/bin/env python3
"""Where the time of an int8 decode step goes, on one GPU.

    python3 scripts/profile_torch_int8.py      # from the repository root

Builds chip_smoke.py's int8 serving model (Qwen2.5-VL-7B with seeded
random weights, quantize_params in place, bits=8) and profiles single decode
steps (engine/generate.py::decode_step_logits, one warm-up step first) with
torch.profiler at the two shapes chip_smoke.py phase 17 drives:
- (a) the eval backend's batch: B = 16 over a cache of 1600 keys,
  weight-only (the int8 kernel), int8 KV; the same with the dispatcher's
  row limit (ops/int8_matmul.py::INT8_KERNEL_MAX_ROWS) set to 0 for the
  step, so every int8 linear converts its weights and calls torch.matmul;
  and the same over a bf16 cache;
- (b) bench.py's batch: B = 256 over a cache of 384 keys, W8A8 (act_quant
  "int8", as decode_act_quant="auto" picks there), int8 KV.
For each: the step's wall time (host clock, ends with a synchronize), the
device's busy time (the union of the CUDA kernel intervals) and idle share,
the kernel launches, the device time by kernel name, and the host time by
operator (self CPU time). Then the prefill of one bench chunk (64 prompts
of 256 tokens, W8A8, int8 KV) the same way. Last, the W8A8 product alone:
torch._int_mm over the weights as the port stores them (row-major [K, N])
against the same weights column-major (a [N, K] copy, transposed view) and
against a transposed copy made in the call, beside bf16 torch.matmul, at
bench.py's decode and prefill-chunk rows (CUDA events); and the host time
of one int8 kernel wrapper call against one torch op (host clock, 2000
calls, no synchronize inside). Exits 1 without CUDA.
"""

from __future__ import annotations

import sys
import time
from collections import defaultdict
from pathlib import Path

TOP = 12


def report(prof, wall: float, what: str, busy_ms) -> None:
    import torch

    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    busy = busy_ms([(e.time_range.start, e.time_range.end) for e in kernels])
    by_name = defaultdict(lambda: [0.0, 0])
    for e in kernels:
        by_name[e.name][0] += (e.time_range.end - e.time_range.start) / 1e3
        by_name[e.name][1] += 1
    print(f"\n{what}: wall {wall:.2f} ms, device busy {busy:.2f} ms, idle "
          f"{100 * (1 - busy / wall):.1f}%, {len(kernels)} kernel launches", flush=True)
    print("  top kernels by device time:")
    for name, (ms, count) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:TOP]:
        print(f"    {ms:9.3f} ms  {count:5d} x  {name[:110]}")
    print("  top operators by host (self CPU) time:")
    ops = sorted(prof.key_averages(), key=lambda a: -a.self_cpu_time_total)[:TOP]
    for a in ops:
        print(f"    {a.self_cpu_time_total / 1e3:9.3f} ms  {a.count:5d} x  {a.key[:90]}")


def main() -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("profile_torch_int8: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    repo = Path(__file__).resolve().parents[1]
    sys.path.insert(0, str(repo))
    sys.path.insert(0, str(repo / "scripts"))
    import chip_smoke as cs
    from profile_torch_sft import busy_ms
    from video_r2_tpu_torch.engine.generate import decode_step_logits, prefill
    from video_r2_tpu_torch.models.config import qwen25vl_7b
    from video_r2_tpu_torch.models.decoder import KVCache, QuantKVCache
    from video_r2_tpu_torch.models.loader import init_params
    from video_r2_tpu_torch.models.quant import quantize_params
    from video_r2_tpu_torch.ops import cuda_build
    from video_r2_tpu_torch.ops import int8_matmul as int8_mod

    torch.backends.cuda.matmul.allow_tf32 = False
    print(cs.card_line(), flush=True)
    cuda_build.kernels()
    dev = torch.device("cuda:0")
    cfg = qwen25vl_7b()
    model = quantize_params(init_params(cfg, seed=cs.SEED, dtype="bfloat16", device=dev))
    torch.cuda.empty_cache()

    def timed(fn, what):
        with torch.inference_mode():
            fn()                                   # warm-up
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1e3
        report(prof, wall, what, busy_ms)

    new = 64
    limit = int8_mod.INT8_KERNEL_MAX_ROWS
    for what, B, smax, act_quant, kind, rows in (
            ("(a) decode step, B=16, 1600 keys, weight-only, int8 KV", 16, 1600, None, "int8",
             limit),
            ("(a) decode step, B=16, 1600 keys, weight-only, int8 KV, INT8_KERNEL_MAX_ROWS=0 "
             "(convert + matmul)", 16, 1600, None, "int8", 0),
            ("(a) decode step, B=16, 1600 keys, weight-only, bf16 KV", 16, 1600, None, "bf16",
             limit),
            ("(b) decode step, B=256, 384 keys, W8A8, int8 KV", 256, 384, "int8", "int8",
             limit)):
        int8_mod.INT8_KERNEL_MAX_ROWS = rows
        cache = (QuantKVCache.init(cfg.text, B, smax, dev) if kind == "int8" else
                 KVCache.init(cfg.text, B, smax, torch.bfloat16, dev))
        tok = torch.arange(B, device=dev) + 1000
        lengths = torch.full((B,), smax - new, dtype=torch.int32, device=dev)
        pos = torch.full((B,), smax - 1, dtype=torch.long, device=dev)
        step = lambda: decode_step_logits(model, tok, pos, cache, lengths,  # noqa: E731
                                          smax - new, new - 1, "flash", act_quant)
        timed(step, what)
        del cache
        torch.cuda.empty_cache()
    int8_mod.INT8_KERNEL_MAX_ROWS = limit

    B, S = cs.BENCH_CHUNK, cs.BENCH_PROMPT
    ids = torch.randint(2, 150000, (B, S), device=dev)
    pos3 = torch.arange(S, device=dev).expand(3, B, S)
    lengths = torch.full((B,), S, dtype=torch.int32, device=dev)
    cache = QuantKVCache.init(cfg.text, B, S + cs.BENCH_NEW, dev)
    timed(lambda: prefill(model, ids, pos3, lengths, cache, attn_impl="flash",
                          act_quant="int8"),
          f"(b) prefill of one chunk, {B} prompts of {S} tokens, W8A8, int8 KV")
    del cache, model
    torch.cuda.empty_cache()
    int_mm_layouts(cs, dev)
    return 0


def int_mm_layouts(cs, dev) -> None:
    """torch._int_mm by the weights' layout, and the host time per call."""
    import torch

    from video_r2_tpu_torch.ops.int8_matmul import int8_matmul

    print()
    rows = cs.BENCH_B, cs.BENCH_CHUNK * cs.BENCH_PROMPT
    for M, K, N in ((rows[0], 3584, 18944), (rows[0], 18944, 3584), (rows[1], 3584, 18944),
                    (rows[1], 18944, 3584), (rows[0], 3584, 152064)):
        a = torch.randint(-127, 128, (M, K), device=dev, dtype=torch.int8)
        b = torch.randint(-127, 128, (K, N), device=dev, dtype=torch.int8)
        b_nk = b.t().contiguous()             # b_nk.t() is b, column-major
        if not torch.equal(torch._int_mm(a, b), torch._int_mm(a, b_nk.t())):
            raise AssertionError("_int_mm differs by the weights' layout")
        row = cs.cuda_ms(lambda: torch._int_mm(a, b), iters=10)
        col = cs.cuda_ms(lambda: torch._int_mm(a, b_nk.t()), iters=10)
        copy = cs.cuda_ms(lambda: torch._int_mm(a, b.t().contiguous().t()), iters=10)
        xb, wb = a.to(torch.bfloat16), b.to(torch.bfloat16)
        bf = cs.cuda_ms(lambda: xb @ wb, iters=10)
        print(f"_int_mm M={M} K={K} N={N}: weights row-major {row:.4f} ms, column-major "
              f"{col:.4f} ms, transposed in the call {copy:.4f} ms; bf16 matmul {bf:.4f} ms",
              flush=True)
    x = torch.randn(16, 3584, device=dev).to(torch.bfloat16)
    wq = torch.randint(-127, 128, (3584, 512), device=dev, dtype=torch.int8)
    sc = torch.rand(512, device=dev)
    y = torch.empty(16, 512, device=dev)
    for what, fn in (("int8_matmul wrapper (k / v, B = 16)", lambda: int8_matmul(x, wq, sc)),
                     ("torch.add", lambda: torch.add(y, 1.0))):
        for _ in range(10):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(2000):
            fn()
        host = (time.perf_counter() - t0) / 2000
        torch.cuda.synchronize()
        print(f"host time of one call, {what}: {1e6 * host:.1f} us", flush=True)


if __name__ == "__main__":
    sys.exit(main())
