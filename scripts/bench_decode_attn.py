#!/usr/bin/env python3
"""The decode-attention kernels of the PyTorch port, on one NVIDIA GPU: the
paged kernel (csrc/paged_attn.cu) at chip_smoke.py phase 8's shapes and the
head-major decode kernel (csrc/decode_attn.cu) at phase 12's, each against
its plain version, timed eagerly and in a CUDA graph (device time: at these
sizes an eager loop times the wrapper's host work) beside one SDPA call
timed both ways, with the bound.

    python3 scripts/bench_decode_attn.py                 # this checkout's port
    python3 scripts/bench_decode_attn.py --root DIR      # another checkout's

Paged (phase 8): B = 8 sequences of the batched slice's prompt lengths plus
64 decode steps, 28 / 4 heads of 128, page size 128, shuffled tables over a
28-layer pool, each timed launch on the next layer: bf16 pages with W = 1
and with a W = 4 verify chunk, int8 pages, the one-layer entry, and (where
the port takes them) fp32 q and pages. Decode (phase 12): B = 4 prompts of
phase 13's lengths right-padded to 1472 in a 1536-wide 28-layer cache, at
decode step 0, step 63 and with the window off. Prints one JSON line a case,
then the card's name and power limit (nvidia-smi). To compare two versions
on one card, run them in turns in one command (parent, change, change,
parent). --splits 4,8,12 also times the device time of the paged bf16 W = 1
case and of decode step 63 at each of those split counts (the plan's choice
overridden; a port with the split plan only), the measurement behind
ops/split.py's constants.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
# chip_smoke.py's batched slice: its first 8 prompts (1384-1403 tokens) + 64
PAGED_LENGTHS = (1448, 1457, 1466, 1448, 1457, 1466, 1449, 1458)
# phase 13's 4 prompts, right-padded to 1472; a 1536-wide cache for 64 tokens
DECODE_LENGTHS, DECODE_PAD, DECODE_NEW = (1354, 1391, 1326, 1423), 1472, 64


def sweep(label: str, splits: list[int], cfg, device) -> None:
    """Device ms of the paged bf16 W = 1 case and of decode step 63 with the
    split count forced to each of `splits` (each timed launch on the next
    layer, as in chip_smoke.py)."""
    import torch

    import chip_smoke
    from video_r2_tpu_torch.ops import decode_attention as dec
    from video_r2_tpu_torch.ops import paged_attention as paged

    tc = cfg.text
    L, kh, nh, hd, ps = (tc.num_hidden_layers, tc.num_key_value_heads,
                         tc.num_attention_heads, tc.head_dim, chip_smoke.PAGE_SIZE)
    gen = torch.Generator(device=device).manual_seed(chip_smoke.SEED + 7)
    need = [-(-n // ps) for n in PAGED_LENGTHS]
    tables = (torch.randperm(sum(need), generator=gen, device=device).int()
              .reshape(len(need), need[0]))
    pk, pv = (torch.randn(L, kh, sum(need), ps, hd, generator=gen, device=device)
              .to(torch.bfloat16) for _ in range(2))
    pq = torch.randn(len(need), nh, hd, generator=gen, device=device).to(torch.bfloat16)
    plens = torch.tensor(PAGED_LENGTHS, dtype=torch.int32, device=device)
    smax = -(-(DECODE_PAD + DECODE_NEW) // 128) * 128
    k, v = (torch.randn(L, len(DECODE_LENGTHS), kh, smax, hd, generator=gen, device=device)
            .to(torch.bfloat16) for _ in range(2))
    q = torch.randn(len(DECODE_LENGTHS), nh, hd, generator=gen, device=device) \
        .to(torch.bfloat16)
    lens = torch.tensor(DECODE_LENGTHS, dtype=torch.int32, device=device)
    at = [0]

    def rotate(fn):
        def go():
            at[0] = (at[0] + 1) % L
            return fn(at[0])
        return go

    cases = (("paged bf16, W=1", paged, lambda l: paged.paged_decode_attention_stacked(
                  pq, pk, pv, tables, plens, l, ps)),
             ("decode step 63", dec, lambda l: dec.decode_attention_stacked(
                  q, k, v, lens, DECODE_PAD + DECODE_NEW - 1, l, DECODE_PAD)))
    for what, module, call in cases:
        plan = module.decode_splits
        for S in splits:
            module.decode_splits = lambda blocks, tiles, index, S=S: S
            print(json.dumps({"label": label, "sweep": what, "splits": S,
                              "device_ms": chip_smoke.graph_ms(rotate(call))}), flush=True)
        module.decode_splits = plan


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(REPO),
                    help="checkout whose video_r2_tpu_torch is timed")
    ap.add_argument("--label", default="", help="a tag printed on every line")
    ap.add_argument("--splits", default="",
                    help="comma-separated split counts to time beside the plan's")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("bench_decode_attn: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(args.root).resolve()))
    sys.path.insert(1, str(REPO))
    import chip_smoke
    from video_r2_tpu_torch.models.config import qwen25vl_7b
    from video_r2_tpu_torch.ops import cuda_build

    torch.backends.cuda.matmul.allow_tf32 = False
    lib = cuda_build.kernels()
    chip_smoke.register_report(Path(lib._name).with_suffix(".log"))
    device = torch.device("cuda")
    cfg = qwen25vl_7b()
    split = importlib.util.find_spec("video_r2_tpu_torch.ops.split") is not None
    sms = torch.cuda.get_device_properties(device).multi_processor_count

    def emit(kernel: str, what: str, r: dict, launch: str | None) -> None:
        line = {"label": args.label, "kernel": kernel, "what": what, **r,
                "of_bound_device": r["bound_ms"] / r["device_ms"]}
        if launch:
            line["launch"] = launch
        print(json.dumps(line), flush=True)

    gen = torch.Generator(device=device).manual_seed(chip_smoke.SEED + 2)
    max_pages = max(-(-n // chip_smoke.PAGE_SIZE) for n in PAGED_LENGTHS)
    for what, W, pages, one_layer in (("decode, W=1", 1, "bf16", False),
                                      ("verify chunk, W=4", 4, "bf16", False),
                                      ("int8 pages, W=1", 1, "int8", False),
                                      ("one-layer pool, W=1", 1, "bf16", True),
                                      ("fp32 q and pages, W=1", 1, "fp32", False)):
        if pages == "fp32" and not split:
            continue                     # this port's paged kernel takes bf16 q only
        (name, r), = chip_smoke.paged_case(gen, what, cfg, list(PAGED_LENGTHS), W, pages,
                                           one_layer).items()
        emit(name, what, r, chip_smoke.split_line(
            len(PAGED_LENGTHS), 4, max_pages * chip_smoke.PAGE_SIZE // 64, sms,
            "tc_kernel<128,1,__nv_bfloat16,1") if split and pages == "bf16" and W == 1
            else None)
        torch.cuda.empty_cache()

    tc = cfg.text
    B, kh, nh, hd = len(DECODE_LENGTHS), tc.num_key_value_heads, tc.num_attention_heads, \
        tc.head_dim
    smax = -(-(DECODE_PAD + DECODE_NEW) // 128) * 128
    gen = torch.Generator(device=device).manual_seed(chip_smoke.SEED + 5)
    k, v = (torch.randn(tc.num_hidden_layers, B, kh, smax, hd, generator=gen, device=device)
            .to(torch.bfloat16) for _ in range(2))
    q = torch.randn(B, nh, hd, generator=gen, device=device).to(torch.bfloat16)
    lens = torch.tensor(DECODE_LENGTHS, dtype=torch.int32, device=device)
    launch = (chip_smoke.split_line(B, kh, smax // 64, sms, "tc_kernel<128,1,__nv_bfloat16,0")
              if split else None)
    for what, slot_end, layer in (("step 0", DECODE_PAD, 5),
                                  (f"step {DECODE_NEW - 1}", DECODE_PAD + DECODE_NEW - 1, 27),
                                  ("window off", DECODE_PAD - 1, 14)):
        r = chip_smoke.decode_case(gen, what, q, k, v, lens, DECODE_PAD, slot_end, layer)
        emit("decode_attention", what, r, launch)
    if args.splits and split:
        sweep(args.label, [int(x) for x in args.splits.split(",")], cfg, device)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
