#!/usr/bin/env python3
"""The flash backward kernels (dq, dk/dv) of the PyTorch port at the training
shapes, on one NVIDIA GPU: each against its plain version, timed with CUDA
events beside the SDPA backward and the bound, with the blocks each launch
puts on an SM.

    python3 scripts/bench_flash_bwd.py                  # this checkout's port
    python3 scripts/bench_flash_bwd.py --root DIR       # another checkout's

Shapes (chip_smoke.py's phases 6 and 15): the 7B decoder's LoRA step (B 2,
S 2432, lengths 2422 / 2342, 28 / 4 heads of 128, causal), the judge's (B 2,
S 1024, lengths 643 / 709, 32 / 4 heads of 128, causal) and the ViT's
full-attention groups (16 groups of 1024, 16 heads of 80, segments: 10% of
the slots padding). Inputs are seeded unit normals in bf16. Prints one JSON
line a shape, then the card's name and power limit (nvidia-smi). To
compare two versions on one card, run them in turns in one command
(parent, change, change, parent).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

PEAK_BF16 = 989e12          # H100 SXM dense bf16 FLOP/s
PEAK_BYTES = 3.35e12        # H100 SXM HBM3 bytes/s
SHAPES = {
    "decoder training": dict(B=2, S=2432, nh=28, kh=4, hd=128, lengths=(2422, 2342)),
    "judge training": dict(B=2, S=1024, nh=32, kh=4, hd=128, lengths=(643, 709)),
    "vit full training": dict(B=16, S=1024, nh=16, kh=16, hd=80, lengths=None),
}


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def rel_l2(a, b) -> float:
    a, b = a.float(), b.float()
    return float((a - b).norm() / b.norm().clamp(min=1e-30))


def run_shape(name: str, B, S, nh, kh, hd, lengths) -> dict:
    import torch
    import torch.nn.functional as F

    from video_r2_tpu_torch.ops import flash

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    bf = lambda *s: torch.randn(*s, generator=gen, device=dev).to(torch.bfloat16)  # noqa: E731
    q, dout = bf(B, S, nh, hd), bf(B, S, nh, hd)
    k, v = bf(B, S, kh, hd), bf(B, S, kh, hd)
    if lengths is None:
        causal, lens = False, torch.full((B,), S, dtype=torch.int32, device=dev)
        seg = torch.where(torch.rand(B, S, generator=gen, device=dev) < 0.9, 1, -2).int()
    else:
        causal, seg = True, None
        lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    out, lse = flash.flash_attention_fwd_lse_plain(q, k, v, lens, causal, 0, seg)
    delta = flash.attention_delta(out, dout)
    args = (q, k, v, dout, lse, delta, lens, causal, 0, seg)
    dq, (dk, dv) = flash.flash_bwd_dq_cuda(*args), flash.flash_bwd_dkv_cuda(*args)
    ref = flash.flash_attention_bwd_plain(q, k, v, out, dout, lse, lens, causal, 0, seg)
    rels = [rel_l2(a, b) for a, b in zip((dq, dk, dv), ref)]

    # the bound: admitted (row, key) pairs of every head; operands read once
    key = torch.arange(S, device=dev)
    ok = (key[None, None, :] < lens[:, None, None]).expand(B, S, S)
    if causal:
        ok = ok & (key[None, :] <= key[:, None])[None]
    if seg is not None:
        ok = ok & (seg[:, :, None] == seg[:, None, :])
    pairs = float(ok.sum()) * nh
    q_bytes, kv_bytes = 2.0 * q.numel(), 2.0 * 2 * float(lens.sum()) * kh * hd
    row_bytes = 4.0 * B * nh * S
    bound = lambda f, n: max(f / PEAK_BF16, n / PEAK_BYTES) * 1e3  # noqa: E731
    dq_bound = bound(6 * hd * pairs, 3 * q_bytes + kv_bytes + 2 * row_bytes)
    dkv_bound = bound(8 * hd * pairs, 2 * q_bytes + kv_bytes + 2 * row_bytes
                      + 2.0 * 2 * B * S * kh * hd)

    qt, kt_, vt = (x.detach().transpose(1, 2).contiguous().requires_grad_() for x in (q, k, v))
    o = F.scaled_dot_product_attention(qt, kt_, vt, attn_mask=ok[:, None], enable_gqa=True)
    dt = dout.transpose(1, 2).contiguous()
    sdpa = cuda_ms(lambda: torch.autograd.grad(o, (qt, kt_, vt), dt, retain_graph=True),
                   iters=10)
    dq_ms = cuda_ms(lambda: flash.flash_bwd_dq_cuda(*args))
    dkv_ms = cuda_ms(lambda: flash.flash_bwd_dkv_cuda(*args))
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    r = {"shape": name, "B": B, "S": S, "nh": nh, "kh": kh, "hd": hd,
         "rel_l2_dq_dk_dv": rels, "dq_ms": dq_ms, "dkv_ms": dkv_ms,
         "pair_ms": dq_ms + dkv_ms, "sdpa_bwd_ms": sdpa,
         "dq_bound_ms": dq_bound, "dkv_bound_ms": dkv_bound}
    if hasattr(flash, "flash_bwd_layout"):      # (rows, warpgroups, resident) a block
        for which, dkv in (("dq", False), ("dkv", True)):
            rows, wgs, resident = flash.flash_bwd_layout(hd, dkv)
            r[f"{which}_blocks_per_sm"] = -(-S // rows) * nh * B / sms
            r[f"{which}_warpgroups_resident"] = wgs * resident
    return r


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]),
                    help="the checkout whose video_r2_tpu_torch is timed")
    ap.add_argument("--label", default="", help="a name printed with each line")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("bench_flash_bwd: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(args.root).resolve()))
    from video_r2_tpu_torch.ops import cuda_build

    torch.backends.cuda.matmul.allow_tf32 = False
    cuda_build.kernels()
    for name, shape in SHAPES.items():
        r = run_shape(name, **shape)
        r["label"] = args.label
        print(json.dumps(r), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
