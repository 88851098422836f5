#!/usr/bin/env python3
"""The flash kernels of the PyTorch port, on one NVIDIA GPU: the forward
(serving, and with LSE) and the backward pair (dq, dk/dv), each against its
plain version, timed with CUDA events beside one SDPA call (forward, or
backward) and the bound, with the blocks each launch puts on an SM.

    python3 scripts/bench_flash_bwd.py                  # this checkout's port
    python3 scripts/bench_flash_bwd.py --root DIR       # another checkout's
    python3 scripts/bench_flash_bwd.py --cases window   # a subset: fwd, bwd, window,
                                                        # window_bwd, next

Forward shapes (chip_smoke.py's phases 3, 6, 15 and 16): the 7B's causal
prefill (B 3, Sq 1408, Sk 1440, lengths 1408 / 1311 / 704, 28 / 4 heads of
128), the ViT's full-attention groups of a 392x392 clip at 8 frames (4
groups of 1024 slots, 784 valid, 16 heads of 80, segment ids from
plan_vision_layout: valid slots 1, padding -2), the int8 fill (B 16, S
1536, lengths 1536 - 13 i) and one bench chunk (B 64, S 256), then with LSE
the training shapes below (the ViT's at 16 frames: 8 groups). "next": the
serving forward at head dim 256 (chip_smoke.py phase 23: the Qwen3-Next
judge's 2048-token prefill chunk, B 1, 16 / 2 heads, causal, and phase
23(c)'s 4 judge prompts, B 4, S 704).
Backward shapes (phases 6 and 15): the 7B decoder's LoRA step (B 2, S 2432,
lengths 2422 / 2342, 28 / 4 heads of 128, causal), the judge's (B 2, S 1024,
lengths 643 / 709, 32 / 4 heads of 128, causal) and the ViT's
full-attention groups (16 groups of 1024, 16 heads of 80, segments: 10% of
the slots padding). The window forward (chip_smoke.py phase 3's "vit
windows": the 8-frame clip's 4096 slots in 64-slot windows, the valid-slot
mask from plan_vision_layout, 16 heads of 80, strided views of one qkv)
through chip_smoke.py's window_case, from this checkout, on the port under
--root: eager and CUDA-graph device times beside SDPA's. The window
backward (window_bwd: chip_smoke.py phase 6's "vit windows training", the
training batch's two 16-frame clips, 16384 slots, 16 heads of 80) the same
way, with SDPA's backward (its forward + backward less its forward) and the
launch's persistent grid. Inputs are seeded unit normals in bf16. Prints
one JSON line a shape, then the card's name and power limit (nvidia-smi).
To compare two versions on one card, run them in turns in one command
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
FWD_SHAPES = {
    "decoder prefill": dict(B=3, Sq=1408, Sk=1440, nh=28, kh=4, hd=128,
                            lengths=(1408, 1311, 704), lse=False),
    "vit full": dict(grid=(4, 28, 28), nh=16, hd=80, lse=False),
    "int8 fill (a)": dict(B=16, Sq=1536, Sk=1536, nh=28, kh=4, hd=128,
                          lengths=tuple(1536 - 13 * i for i in range(16)), lse=False),
    "int8 fill (b) chunk": dict(B=64, Sq=256, Sk=256, nh=28, kh=4, hd=128,
                                lengths=(256,) * 64, lse=False),
    "decoder training": dict(B=2, Sq=2432, Sk=2432, nh=28, kh=4, hd=128,
                             lengths=(2422, 2342), lse=True),
    "judge training": dict(B=2, Sq=1024, Sk=1024, nh=32, kh=4, hd=128,
                           lengths=(643, 709), lse=True),
    "vit full training": dict(grid=(8, 28, 28), nh=16, hd=80, lse=True),
}
NEXT_SHAPES = {
    "next prefill chunk": dict(B=1, Sq=2048, Sk=2048, nh=16, kh=2, hd=256,
                               lengths=(2048,), lse=False),
    "next judge prompts": dict(B=4, Sq=704, Sk=704, nh=16, kh=2, hd=256,
                               lengths=(559, 625, 622, 670), lse=False),
}
SHAPES = {
    "decoder training": dict(B=2, S=2432, nh=28, kh=4, hd=128, lengths=(2422, 2342)),
    "judge training": dict(B=2, S=1024, nh=32, kh=4, hd=128, lengths=(643, 709)),
    "vit full training": dict(B=16, S=1024, nh=16, kh=16, hd=80, lengths=None),
}
WINDOW_SHAPES = {"vit windows": dict(grids=((4, 28, 28),), nh=16, hd=80, training=False),
                 "vit windows training": dict(grids=((8, 28, 28),) * 2, nh=16, hd=80,
                                              training=True)}


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


def vit_segments(grid, dev):
    """[G, L] segment ids of the ViT's full-attention groups for one clip
    (valid slots 1, padding -2), as the tower gathers them."""
    import torch

    from video_r2_tpu_torch.models.config import qwen25vl_7b
    from video_r2_tpu_torch.models.vision import plan_vision_layout

    layout = plan_vision_layout([grid], qwen25vl_7b().vision)
    fg = torch.as_tensor(layout.full_gather, device=dev).long()
    valid = torch.as_tensor(layout.valid, device=dev)
    return torch.where((fg >= 0) & valid[fg.clamp(min=0)], 1, -2).int()


def run_fwd_shape(name: str, nh, hd, lse, B=None, Sq=None, Sk=None, kh=None,
                  lengths=None, grid=None) -> dict:
    """One forward (serving, or with LSE) against its plain version, SDPA's
    forward and the bound."""
    import torch
    import torch.nn.functional as F

    from video_r2_tpu_torch.ops import flash

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    bf = lambda *s: torch.randn(*s, generator=gen, device=dev).to(torch.bfloat16)  # noqa: E731
    if grid is not None:                      # the ViT's groups: segments, not causal
        seg = vit_segments(grid, dev)
        B, Sq = seg.shape
        Sk, kh, causal = Sq, nh, False
        lens = torch.full((B,), Sk, dtype=torch.int32, device=dev)
    else:
        seg, causal = None, True
        lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    q, k, v = bf(B, Sq, nh, hd), bf(B, Sk, kh, hd), bf(B, Sk, kh, hd)
    args = (q, k, v, lens, causal, 0, seg)
    if lse:
        run = lambda: flash.flash_attention_fwd_lse(*args)  # noqa: E731
    else:
        run = lambda: (flash.flash_attention(q, k, v, kv_lengths=lens, causal=causal,  # noqa: E731
                                             segment_ids=seg), None)
    (out, got_lse), (ref, ref_lse) = run(), flash.flash_attention_fwd_lse_plain(*args)
    d = (out.float() - ref.float()).abs()
    excess = float((d / (1e-2 + 1e-2 * ref.float().abs())).max())

    key = torch.arange(Sk, device=dev)
    ok = (key[None, None, :] < lens[:, None, None]).expand(B, Sq, Sk)
    if causal:
        ok = ok & (key[None, :] <= torch.arange(Sq, device=dev)[:, None])[None]
    if seg is not None:
        ok = ok & (seg[:, :, None] == seg[:, None, :])
    pairs = float(ok.sum()) * nh
    nbytes = 2 * 2.0 * q.numel() + 2.0 * 2 * float(lens.clamp(max=Sk).sum()) * kh * hd
    nbytes += 4.0 * B * nh * Sq if lse else 0.0
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    sdpa = cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=ok[:, None],
                                                          enable_gqa=True))
    r = {"shape": name, "B": B, "Sq": Sq, "Sk": Sk, "nh": nh, "kh": kh, "hd": hd,
         "lse": lse, "excess": excess, "ms": cuda_ms(run), "sdpa_fwd_ms": sdpa,
         "bound_ms": max(4 * hd * pairs / PEAK_BF16, nbytes / PEAK_BYTES) * 1e3,
         "bound_by": "operations" if 4 * hd * pairs / PEAK_BF16 >= nbytes / PEAK_BYTES
                     else "bytes"}
    if lse:
        has_key = ref_lse < flash.NO_KEY_LSE
        r["lse_max_abs_err"] = float((got_lse - ref_lse)[has_key].abs().max())
    if hasattr(flash, "flash_fwd_layout"):      # (rows, warpgroups, resident) a block
        rows, wgs, resident = flash.flash_fwd_layout(hd)
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        r["blocks_per_sm"] = -(-Sq // rows) * nh * B / sms
        r["warpgroups_resident"] = wgs * resident
    return r


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


def run_window_shape(name: str, grids, nh, hd, training) -> dict:
    """The window forward (or backward, `training`) at the clips' layout:
    chip_smoke.py's window_case (kernel vs plain, eager and device times,
    SDPA's, the bound; the backward's grid line)."""
    import torch

    import chip_smoke
    from video_r2_tpu_torch.models.config import qwen25vl_7b
    from video_r2_tpu_torch.models.vision import plan_vision_layout

    dev = torch.device("cuda")
    layout = plan_vision_layout(list(grids), qwen25vl_7b().vision)
    valid = torch.as_tensor(layout.valid, device=dev)
    gen = torch.Generator(device=dev).manual_seed(chip_smoke.SEED)
    r = chip_smoke.window_case(gen, name, valid, nh, hd, training=training)
    r = r["window_attention_bwd" if training else "window_attention"]
    return {"shape": name, "S": int(valid.shape[0]), "nh": nh, "hd": hd,
            "valid": int(valid.sum()), **r}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]),
                    help="the checkout whose video_r2_tpu_torch is timed")
    ap.add_argument("--label", default="", help="a name printed with each line")
    ap.add_argument("--cases", default="fwd,bwd,window,window_bwd",
                    help="comma-separated subset of fwd, bwd, window, window_bwd, next")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("bench_flash_bwd: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(args.root).resolve()))
    sys.path.insert(1, str(Path(__file__).resolve().parents[1]))
    from video_r2_tpu_torch.ops import cuda_build

    torch.backends.cuda.matmul.allow_tf32 = False
    lib = cuda_build.kernels()
    import chip_smoke    # the ptxas lines of the --root build, for the grid lines

    chip_smoke.register_report(Path(lib._name).with_suffix(".log"))
    cases = set(args.cases.split(","))
    runs = [(run_fwd_shape, name, shape) for name, shape in FWD_SHAPES.items()
            if "fwd" in cases]
    runs += [(run_fwd_shape, name, shape) for name, shape in NEXT_SHAPES.items()
             if "next" in cases]
    runs += [(run_shape, name, shape) for name, shape in SHAPES.items() if "bwd" in cases]
    runs += [(run_window_shape, name, shape) for name, shape in WINDOW_SHAPES.items()
             if ("window_bwd" if shape["training"] else "window") in cases]
    for fn, name, shape in runs:
        try:
            r = fn(name, **shape)
        except AssertionError as e:    # a variant that gives up the result (its times
            print(json.dumps({"label": args.label, "shape": name, "error": str(e)}),
                  flush=True)          # are on the "kernel ..." line above)
            continue
        r["label"] = args.label
        print(json.dumps(r), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
