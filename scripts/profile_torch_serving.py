#!/usr/bin/env python3
"""Where the time of batched decoding through the paged engine goes, on one GPU.

    python3 scripts/profile_torch_serving.py      # from the repository root

Builds chip_smoke.py's batched serving slice (Qwen2.5-VL-7B in bf16 with
seeded random weights; PagedContinuousEngine with 8 slots, page size 128,
buckets 128-2048, bf16 pages), admits its first 8 video requests through
submit_batch, takes one warm-up window of step(steps=8), then profiles one
window with torch.profiler: the window's wall time (host clock, ends when
the tokens reach the host), the device's busy time (the union of the CUDA
kernel intervals) and idle share, the kernel launches per decode step, and
the device time by kind and by kernel name. Then it profiles 50 launches of
the paged kernel alone at the window's lengths, to give its device time per
launch beside the host time per call. Exits 1 without CUDA.
"""

from __future__ import annotations

import sys
import time
from collections import defaultdict
from pathlib import Path


def main() -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("profile_torch_serving: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    repo = Path(__file__).resolve().parents[1]
    sys.path.insert(0, str(repo))
    sys.path.insert(0, str(repo / "scripts"))
    import chip_smoke as cs
    from profile_torch_sft import busy_ms, kind_of
    from video_r2_tpu_torch.apps.demo import DemoRunner
    from video_r2_tpu_torch.engine.chat import ByteTokenizer
    from video_r2_tpu_torch.engine.continuous import PagedContinuousEngine
    from video_r2_tpu_torch.engine.sampling import SamplingParams
    from video_r2_tpu_torch.models.config import qwen25vl_7b
    from video_r2_tpu_torch.models.loader import init_params
    from video_r2_tpu_torch.ops import cuda_build
    from video_r2_tpu_torch.ops.paged_attention import paged_decode_attention_stacked

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(cs.card_line(), flush=True)
    cuda_build.kernels()
    cfg = qwen25vl_7b()
    model = init_params(cfg, seed=cs.SEED, dtype="bfloat16", device=torch.device("cuda:0"))
    runner = DemoRunner(model, ByteTokenizer())
    requests = cs.serve_requests(runner, cfg)[:cs.SERVE_SLOTS]
    eng = PagedContinuousEngine(
        model, num_slots=cs.SERVE_SLOTS, max_len=cs.SERVE_MAX_LEN,
        sp=SamplingParams(eos_token_ids=(), pad_token_id=cfg.pad_token_id),
        attn_impl="flash", prompt_buckets=cs.SERVE_BUCKETS, page_size=cs.PAGE_SIZE)
    items = [cs.submit_item(runner, r) for r in requests]
    rids = eng.submit_batch([(it[0], 256) + it[2:] for it in items])   # none finish
    if None in rids:
        raise RuntimeError(f"not every request was admitted: {rids}")
    eng.step(cs.DECODE_STEPS)                      # warm-up window
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.step(cs.DECODE_STEPS)
        wall = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    busy = busy_ms([(e.time_range.start, e.time_range.end) for e in kernels])
    by_kind, by_name = defaultdict(float), defaultdict(lambda: [0.0, 0])
    for e in kernels:
        ms = (e.time_range.end - e.time_range.start) / 1e3
        by_kind[kind_of(e.name)] += ms
        by_name[e.name][0] += ms
        by_name[e.name][1] += 1
    lens = [int(x) for x in eng.cur_len]
    print(f"\none window of {cs.DECODE_STEPS} decode steps, {cs.SERVE_SLOTS} slots, cache "
          f"lengths {lens}: wall {wall:.1f} ms, device busy {busy:.1f} ms, idle "
          f"{100 * (1 - busy / wall):.1f}%, {len(kernels)} kernel launches "
          f"({len(kernels) / cs.DECODE_STEPS:.0f} per step)", flush=True)
    for kind, ms in sorted(by_kind.items(), key=lambda kv: -kv[1]):
        print(f"  {kind:26s} {ms:9.2f} ms  {100 * ms / busy:5.1f}% of busy")
    print("  top kernels by device time:")
    for name, (ms, count) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]:
        print(f"    {ms:9.2f} ms  {count:5d} x  {name[:110]}")

    # the paged kernel alone, at the window's tables and lengths
    pc = eng.pcache
    tables = torch.as_tensor(
        (pc.page_tables * (pc.page_tables >= 0) + eng.trash_page * (pc.page_tables < 0)),
        dtype=torch.int32, device=model.device)
    lengths = torch.as_tensor(eng.cur_len, dtype=torch.int32, device=model.device)
    q = torch.randn(cs.SERVE_SLOTS, cfg.text.num_attention_heads, cfg.text.head_dim,
                    device=model.device).to(torch.bfloat16)
    n_layers, n = cfg.text.num_hidden_layers, 50
    call = lambda i: paged_decode_attention_stacked(  # noqa: E731
        q, pc.k, pc.v, tables, lengths, i % n_layers, cs.PAGE_SIZE)
    for i in range(5):
        call(i)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(n):
            call(i)
        torch.cuda.synchronize()
        host = (time.perf_counter() - t0) * 1e3 / n
    dev = [(e.time_range.end - e.time_range.start) / 1e3 for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]   # one kernel a call
    print(f"\npaged kernel alone, {n} launches over the 28 layers of the pool: device "
          f"{1e3 * sum(dev) / max(len(dev), 1):.1f} us per launch (min "
          f"{1e3 * min(dev):.1f}, max {1e3 * max(dev):.1f}; {len(dev)} kernels seen), "
          f"host clock {1e3 * host:.1f} us per call", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
