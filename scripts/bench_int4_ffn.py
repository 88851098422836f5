#!/usr/bin/env python3
"""The int4 matmul at the 7B's decode shapes and the bf16 grouped expert FFN
at the judge's GMM prefill, on one NVIDIA GPU: each against its plain
version, timed with CUDA events beside one library call and the bound.

    python3 scripts/bench_int4_ffn.py                  # this checkout's port
    python3 scripts/bench_int4_ffn.py --root DIR       # another checkout's
    python3 scripts/bench_int4_ffn.py --step           # and an int4 decode step
    python3 scripts/bench_int4_ffn.py --cases int4     # a subset: int4, ffn
    python3 scripts/bench_int4_ffn.py --cases int4 --shapes 'decode q,decode k / v'

Shapes: the int4 kernel at B = 4 rows for the 7B's q, k / v, o, gate / up
and down, at B = 1 for gate / up and the head, and at the merger's 784
rows for fc1 (chip_smoke.py phase 12's cases: seeded weights quantized by
quantize_kernel_int4, copies rotating past the L2 cache so each launch reads
cold weights; the library call torch._weight_int4pack_mm); the grouped FFN
in bf16 at T = 4096 and 2048 tokens routed top 8 over the judge's 128
experts (H 2048, I 768: phase 10's GMM prefill cases; the library call three
torch._grouped_mm and the SwiGLU), with each of its kernels' device time
from torch.profiler. The cases and their helpers are chip_smoke.py's, from
this checkout; the port timed is the one under --root. --step adds the
7B's int4 decode step (seeded weights quantized with bits=4, 4 text prompts
of chip_smoke.py phase 13's lengths, generate(attn_impl="flash",
decode_impl="kernel")): (the time of 66 new tokens - that of 2) / 64, three
times, eager as a server runs it. Prints one JSON line a case (with the
split-K plan or the FFN's tiles where the port has them), then the card's
name and power limit (nvidia-smi). To compare two versions on one card,
run them in turns in one command (parent, change, change, parent): readings
under 0.13 ms vary up to 2x between runs.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
# (what, rows, K, N): the 7B's int4 linears at decode, B = 4
INT4_SHAPES = (("decode q", 4, 3584, 3584), ("decode k / v", 4, 3584, 512),
               ("decode o", 4, 3584, 3584), ("decode gate / up", 4, 3584, 18944),
               ("decode down", 4, 18944, 3584), ("B=1 gate / up", 1, 3584, 18944),
               ("B=1 head", 1, 3584, 152064), ("merger fc1", 784, 5120, 5120))
FFN_TOKENS = (4096, 2048)
STEP_LENGTHS = (1354, 1391, 1326, 1423)    # phase 13's prompt lengths


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


def decode_step_ms(device) -> list[float]:
    """The 7B's int4 decode step at B = 4, eager: three readings."""
    import time

    import numpy as np
    import torch

    from video_r2_tpu_torch.engine.generate import generate
    from video_r2_tpu_torch.engine.sampling import SamplingParams
    from video_r2_tpu_torch.models.config import qwen25vl_7b
    from video_r2_tpu_torch.models.loader import init_params
    from video_r2_tpu_torch.models.quant import quantize_params

    cfg = qwen25vl_7b()
    model = quantize_params(init_params(cfg, seed=0, dtype="bfloat16", device=device), bits=4)
    torch.cuda.empty_cache()
    lengths = np.array(STEP_LENGTHS, np.int32)
    ids = np.random.default_rng(0).integers(2, 150000, size=(len(lengths), max(lengths)))

    def run(new: int) -> float:
        sp = SamplingParams(max_new_tokens=new, eos_token_ids=(),
                            pad_token_id=cfg.pad_token_id)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        generate(model, ids.astype(np.int32), lengths, sp, attn_impl="flash",
                 decode_impl="kernel")
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    run(4)
    out = []
    for _ in range(3):
        short = run(2)
        out.append((run(66) - short) / 64 * 1e3)
    return out


def ffn_call(gen, layer: dict, T: int):
    """One bf16 grouped-FFN call over T new tokens routed top 8 in the GMM
    prefill layout (moe_case's inputs, drawn afresh)."""
    import torch

    from video_r2_tpu_torch.models.moe import route
    from video_r2_tpu_torch.ops.moe_gmm import auto_block_rows, gmm_layout
    from video_r2_tpu_torch.ops.moe_ragged import ragged_expert_ffn

    w = layer["bf16"]
    E, H, _ = w["gate"]["kernel"].shape
    x = torch.randn(T, H, generator=gen, device=gen.device).to(torch.bfloat16)
    _, topi = route(layer["router"], x, 8, True)
    xs, ids, valid, _ = gmm_layout(x, topi, E, auto_block_rows(T * 8, E))
    return lambda: ragged_expert_ffn(xs, ids, w["gate"], w["up"], w["down"], blk_valid=valid)


def judge_layer(device, seed: int) -> dict:
    """One judge MoE layer's bf16 weights, scaled like init_params (as
    chip_smoke.py's phase 10 makes them)."""
    import torch

    from video_r2_tpu_torch.models.config import qwen3_moe_30b_a3b

    tc = qwen3_moe_30b_a3b().text
    E, H, I = tc.num_experts, tc.hidden_size, tc.moe_intermediate_size
    gen = torch.Generator(device=device).manual_seed(seed)
    randw = lambda *s: (torch.randn(*s, generator=gen, device=device)  # noqa: E731
                        * s[-2] ** -0.5).to(torch.bfloat16)
    return {"router": randw(H, E),
            "bf16": {"gate": {"kernel": randw(E, H, I)}, "up": {"kernel": randw(E, H, I)},
                     "down": {"kernel": randw(E, I, H)}}}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(REPO),
                    help="the checkout whose video_r2_tpu_torch is timed")
    ap.add_argument("--label", default="", help="a name printed with each line")
    ap.add_argument("--step", action="store_true", help="also time an int4 decode step")
    ap.add_argument("--cases", default="int4,ffn", help="comma-separated subset of int4, ffn")
    ap.add_argument("--shapes", default=None,
                    help="int4: comma-separated subset of the shapes' names, as "
                         "'decode q,decode k / v'")
    ap.add_argument("--warm", action="store_true",
                    help="int4: one copy of the weights (L2-resident), not cold copies")
    ap.add_argument("--staged", action="store_true",
                    help="int4: every shape on the staged kernel (no decode kernel)")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("bench_int4_ffn: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(args.root).resolve()))
    sys.path.insert(1, str(REPO))
    import chip_smoke
    from video_r2_tpu_torch.ops import cuda_build, int4_matmul, moe_ragged

    torch.backends.cuda.matmul.allow_tf32 = False
    lib = cuda_build.kernels()
    chip_smoke.register_report(Path(lib._name).with_suffix(".log"))
    device = torch.device("cuda")
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    gen = torch.Generator(device=device).manual_seed(chip_smoke.SEED + 5)
    cases = set(args.cases.split(","))
    if args.warm:
        chip_smoke.COLD_BYTES = 0
    if args.staged:
        int4_matmul.DECODE_MAX_ROWS = 0
        int4_matmul._launch_plan.cache_clear()
    if hasattr(int4_matmul, "int4_decode_resident"):
        print(json.dumps({"label": args.label,
                          "int4_decode_resident":
                              int4_matmul.int4_decode_resident(torch.cuda.current_device())}))
    shapes = [s for s in INT4_SHAPES if args.shapes is None or s[0] in args.shapes.split(",")]
    for what, M, K, N in shapes if "int4" in cases else ():
        try:
            r = chip_smoke.int4_case(gen, what, M, K, N)
        except AssertionError as e:    # a variant that gives up the result (its times
            print(json.dumps({"label": args.label, "what": what, "error": str(e)}),
                  flush=True)          # are on the "kernel ..." line above)
            continue
        line = {"label": args.label, "kernel": "int4_matmul", "what": what, "M": M, "K": K,
                "N": N, **r}
        if hasattr(int4_matmul, "int4_split_plan"):
            line["launch"] = chip_smoke.int4_launch_line(M, K, N, sms)
        print(json.dumps(line), flush=True)
        torch.cuda.empty_cache()
    layer = judge_layer(device, chip_smoke.SEED + 3) if "ffn" in cases else None
    for T in FFN_TOKENS if "ffn" in cases else ():
        E, H, I = layer["bf16"]["gate"]["kernel"].shape
        r = chip_smoke.moe_case(gen, layer, T, "gmm", "bf16")
        line = {"label": args.label, "kernel": "moe_ffn_bf16_gmm", "what": f"GMM prefill T={T}",
                "H": H, "I": I, **r, "kernel_us": kernel_us(ffn_call(gen, layer, T))}
        if hasattr(moe_ragged, "ffn_wgmma_tiles"):
            line["launch"] = chip_smoke.ffn_launch_line("bf16", r["blocks"], r["rows"], H, I)
        print(json.dumps(line), flush=True)
    if args.step:
        del layer
        torch.cuda.empty_cache()
        print(json.dumps({"label": args.label, "kernel": "int4 decode step",
                          "what": f"B={len(STEP_LENGTHS)}, eager",
                          "ms_per_step": decode_step_ms(device)}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
