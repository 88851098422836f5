#!/usr/bin/env python3
"""Where the time of one LoRA SFT step of the PyTorch port goes, on one GPU.

    python3 scripts/profile_torch_sft.py      # from the repository root

Builds chip_smoke.py's training slice (Qwen2.5-VL-7B in bf16 with seeded
random weights, LoRA r=64 / alpha=64, B=2 records of 16 frames at 392x392),
takes one warm-up step, then profiles one step with torch.profiler, for the
tower frozen and for adapters in the tower. For each it prints the step's
wall time (host clock, synchronized), the device's busy time (the union of
the CUDA kernel intervals) and idle share (1 - busy / wall), the kernel
launches, and the device time by kind of kernel and by kernel name. The
profiler's own cost is inside the wall time. Exits 1 without CUDA.
"""

from __future__ import annotations

import sys
import time
from collections import defaultdict
from pathlib import Path

KINDS = (  # (kind, substrings of the kernel name), first match wins
    ("paged decode", ("paged_decode_kernel",)),
    ("flash fwd (+lse)", ("flash_fwd_kernel",)),
    ("flash bwd dq", ("flash_bwd_dq_kernel",)),
    ("flash bwd dk/dv", ("flash_bwd_dkv_kernel",)),
    ("window bwd", ("window_attn_bwd_kernel",)),
    ("window fwd", ("window_attn_kernel",)),
    ("matmul", ("gemm", "cutlass", "xmma", "gemv", "splitK", "nvjet")),
    ("softmax / logsumexp", ("softmax", "logsumexp")),
    ("reduction", ("reduce",)),
    ("index / gather / scatter", ("index", "gather", "scatter")),
    ("copy / cat / memset", ("copy", "cat", "Cat", "Memcpy", "Memset")),
    ("elementwise", ("elementwise", "vectorized")),
)


def kind_of(name: str) -> str:
    for kind, keys in KINDS:
        if any(k in name for k in keys):
            return kind
    return "other"


def busy_ms(intervals) -> float:
    """Length of the union of (start, end) intervals, in ms (us in)."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total / 1e3


def profile_step(step, state, batch, torch):
    from torch.profiler import ProfilerActivity, profile

    step(state, batch)                      # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _, metrics = step(state, batch)
        loss = float(metrics["loss"])
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    # device-side events, without the ranges of user annotations
    # (Optimizer.step and the like), which span kernels rather than add to them
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)
               and not e.name.startswith(("Optimizer.", "ProfilerStep"))]
    intervals = [(e.time_range.start, e.time_range.end) for e in kernels]
    by_kind, by_name = defaultdict(float), defaultdict(lambda: [0.0, 0])
    for e in kernels:
        ms = (e.time_range.end - e.time_range.start) / 1e3
        by_kind[kind_of(e.name)] += ms
        by_name[e.name][0] += ms
        by_name[e.name][1] += 1
    return wall, busy_ms(intervals), len(kernels), by_kind, by_name, loss


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("profile_torch_sft: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    repo = Path(__file__).resolve().parents[1]
    sys.path.insert(0, str(repo))
    import chip_smoke
    from video_r2_tpu_torch.data.config import DataConfig
    from video_r2_tpu_torch.data.sft import SFTCollator, SFTDataset
    from video_r2_tpu_torch.engine.chat import ByteTokenizer
    from video_r2_tpu_torch.models.config import qwen25vl_7b
    from video_r2_tpu_torch.models.loader import init_params
    from video_r2_tpu_torch.ops import cuda_build
    from video_r2_tpu_torch.train.lora import LoRAConfig, attach_lora, init_lora
    from video_r2_tpu_torch.train.optim import OptimConfig
    from video_r2_tpu_torch.train.sft import SFTConfig, init_train_state, make_lora_sft_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(chip_smoke.card_line(), flush=True)
    cuda_build.kernels()
    device = torch.device("cuda:0")
    cfg = qwen25vl_7b()
    model = init_params(cfg, seed=chip_smoke.SEED, dtype="bfloat16", device=device)
    dataset = SFTDataset(chip_smoke.training_records(), ByteTokenizer(), cfg, DataConfig())
    batch = SFTCollator(cfg, DataConfig())([dataset[i] for i in range(len(dataset))])
    tensors = {k: torch.as_tensor(v, device=device) for k, v in batch.arrays.items()}
    tokens = int(batch.arrays["attention_mask"].sum())
    scfg = SFTConfig(attn_impl="flash", vit_attn_impl="kernel")
    for what, lcfg in (("tower frozen", LoRAConfig()),
                       ("adapters in the tower", LoRAConfig(include_vision=True,
                                                            include_merger=True))):
        params = attach_lora(model, init_lora(model, lcfg, seed=chip_smoke.SEED), lcfg)
        state = init_train_state(params, OptimConfig(total_steps=3))
        step = make_lora_sft_step(model, scfg, batch.video_layout)
        wall, busy, n, by_kind, by_name, loss = profile_step(step, state, tensors, torch)
        print(f"\n[{what}] one LoRA SFT step, B=2, {tokens} tokens, loss {loss:.6f}: "
              f"wall {wall:.1f} ms, device busy {busy:.1f} ms, idle "
              f"{100 * (1 - busy / wall):.1f}%, {n} kernel launches", flush=True)
        for kind, ms in sorted(by_kind.items(), key=lambda kv: -kv[1]):
            print(f"  {kind:26s} {ms:9.2f} ms  {100 * ms / busy:5.1f}% of busy")
        print("  top kernels by device time:")
        for name, (ms, count) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]:
            print(f"    {ms:9.2f} ms  {count:5d} x  {name[:110]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
