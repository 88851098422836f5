#!/usr/bin/env python3
"""Make a variant of a checkout's port: a copy of its video_r2_tpu_torch/
with one kernel source edited, to time what a part of a kernel costs.

    python3 scripts/kernel_variants.py --root DIR --out DIR2 NAME [NAME ...]
    python3 scripts/bench_int4_ffn.py --cases int4 --root DIR2 --label NAME

A variant drops or changes one piece of work and keeps the rest, so its
results are wrong on purpose (the benches report the failed check and go
on). Each edit names the exact text it replaces and fails where the
source does not hold it, so a variant never silently times the unchanged
kernel. The variants, and the sources whose text they match:

  int4_nodequant       csrc/int4_matmul.cu as of af66272: the B fragments
                       packed from the raw staged bytes, with no nibble
                       conversion, scale multiply or bf16 pack
  window_notranspose   csrc/vit_window_attn.cu as of af66272: V staged
                       row-major like K (no transposing 2-byte stores)
  int4_nodequant_new   csrc/int4_matmul.cu of this tree: the decode
                       kernel's fragments are the raw weight words
  int4_nocompute       the same source: the decode kernel's loads and tile
                       closes without its products
  int4_noclose         the same source: the decode kernel without its tile
                       closes (no y is written; ptxas then drops the
                       products too, whose sums nothing reads: the loads
                       alone)
  int4_noticket        the same source: every tile close stores its sums
                       as y (no parts, tickets or fixups)
  int4_2blocks         the same source: 2 decode blocks an SM (6 stages)
  int4_4blocks         the same source: 4 decode blocks an SM (3 stages;
                       for x of up to 8 rows)
  int4_staged_noreduce csrc/int4_matmul.cu as of 9c80a9b (the staged
                       kernel's split-K closed by a ticket through L2):
                       the splits write their fp32 sums and stop (no
                       ticket, no last block's sum of the splits, no y)
  int4_staged_direct   the same source: each split stores its own sums as
                       y (no fp32 parts, ticket or sum of the splits)
  int4_staged_onesplit ops/int4_matmul.py of 9c80a9b or this tree: the
                       staged kernel on one split (the split plan returns
                       S = 1)
  int4_staged_noload   csrc/int4_matmul.cu of 9c80a9b or this tree: the
                       staged kernel loads no stage (its products and
                       close run on whatever shared memory holds: launch,
                       products and close alone)
  int4_cluster_nosum   this tree: the staged kernel's cluster close keeps
                       its barriers and stores, without the loads and sums
                       of the splits' shared memory
  int4_cluster_local   this tree: the staged kernel's cluster close
                       without its barriers or other blocks' sums (each
                       split stores its own sums as y: the cluster launch
                       and the shared-memory round trip alone)
  int4_split8          ops/int4_matmul.py of this tree: at most 8 splits
                       (clusters of 8, the portable size)

The variants of one source combine (int4_nocompute with int4_2blocks).
"""

from __future__ import annotations

import argparse
import shutil
import sys
from pathlib import Path

PARENT_INT4_DEQUANT = """\
          blo[nt][0] = vr2::pack_bf16(nib(u0, slo[nt]), nib(u1, slo[nt]));
          blo[nt][1] = vr2::pack_bf16(nib(u2, slo[nt]), nib(u3, slo[nt]));
          bhi[nt][0] = vr2::pack_bf16(nib(u0 >> 4, shi[nt]), nib(u1 >> 4, shi[nt]));
          bhi[nt][1] = vr2::pack_bf16(nib(u2 >> 4, shi[nt]), nib(u3 >> 4, shi[nt]));
"""
RAW_INT4 = """\
          blo[nt][0] = u0 | (u1 << 16);
          blo[nt][1] = u2 | (u3 << 16);
          bhi[nt][0] = (u0 | (u1 << 16)) >> 4;
          bhi[nt][1] = (u2 | (u3 << 16)) >> 4;
"""

DECODE_DEQUANT = """\
        a[0] = scale_pair(nib_pair(v01), s0, s0), a[1] = scale_pair(nib_pair(v01 >> 8), s1, s1);
        a[2] = scale_pair(nib_pair(v23), s0, s0), a[3] = scale_pair(nib_pair(v23 >> 8), s1, s1);
"""
RAW_DECODE = """\
        a[0] = v01, a[1] = v01 >> 8, a[2] = v23, a[3] = v23 >> 8;
        (void)s0, (void)s1;
"""

# name -> [(file under csrc/, or a path from it, old text, new text)]
VARIANTS = {
    "int4_nodequant": [("int4_matmul.cu", PARENT_INT4_DEQUANT, RAW_INT4)],
    "window_notranspose": [(
        "vit_window_attn.cu",
        "vr2::load_tile_transposed<HD>(sVt, VP,",
        "vr2::load_tile<HD>(sVt, QP,")],
    "int4_nodequant_new": [("int4_matmul.cu", DECODE_DEQUANT, RAW_DECODE)],
    "int4_nocompute": [("int4_matmul.cu", "      compute(st);\n", "")],
    "int4_noclose": [("int4_matmul.cu", "    flush(T, sa, sb);\n", "")],
    "int4_noticket": [(
        "int4_matmul.cu",
        "  if (sa == tb && sb == te) {  // the whole tile",
        "  if (true) {  // the whole tile")],
    # the plan takes the resident count from the kernel (vr2_int4_matmul_layout)
    "int4_2blocks": [
        ("int4_matmul.cu", "constexpr int kBlocksPerSm = 3;", "constexpr int kBlocksPerSm = 2;"),
        ("int4_matmul.cu", "static constexpr int STAGES = MT == 1 ? 5 : 3;",
         "static constexpr int STAGES = MT == 1 ? 6 : 5;")],
    "int4_4blocks": [
        ("int4_matmul.cu", "constexpr int kBlocksPerSm = 3;", "constexpr int kBlocksPerSm = 4;"),
        ("int4_matmul.cu", "static constexpr int STAGES = MT == 1 ? 5 : 3;",
         "static constexpr int STAGES = MT == 1 ? 3 : 2;")],
    "int4_staged_noreduce": [(
        "int4_matmul.cu",
        "  __threadfence();  // this block's sums, before its ticket\n",
        "  return;\n")],
    "int4_staged_direct": [(
        "int4_matmul.cu",
        "    reduce_splits<MT, WV>(acc, p, n0 + wn0, row0, rows, lane, tid);\n    return;\n",
        "")],
    "int4_staged_onesplit": [(
        "../ops/int4_matmul.py",
        "    base, rem = divmod(stages, S)\n",
        "    S = 1\n    base, rem = divmod(stages, S)\n")],
    "int4_cluster_nosum": [(
        "int4_matmul.cu",
        "      if (z < S) got[z] = ld_cluster_f4(at, z);\n",
        "      got[z] = make_float4(0.f, 0.f, 0.f, 0.f);\n")],
    "int4_cluster_local": [
        ("int4_matmul.cu", "  cluster_sync();  // every split's sums are in its shared memory\n",
         "  __syncthreads();\n"),
        ("int4_matmul.cu",
         "  for (int i = blockIdx.z * kThreads + tid; i < rows * (kBN / 4); i += S * kThreads) {",
         "  for (int i = tid; i < rows * (kBN / 4); i += kThreads) {"),
        ("int4_matmul.cu", "      if (z < S) got[z] = ld_cluster_f4(at, z);\n",
         "      got[z] = z == 0 ? *reinterpret_cast<const float4*>(at)\n"
         "                      : make_float4(0.f, 0.f, 0.f, 0.f);\n"),
        ("int4_matmul.cu",
         "  cluster_sync();  // no block leaves while another reads its sums\n", "")],
    "int4_split8": [("../ops/int4_matmul.py", "SPLIT_MAX = 16 ", "SPLIT_MAX = 8 ")],
    "int4_staged_noload": [
        ("int4_matmul.cu",
         "      load_stage<MT, WV, G>(smem + s * R::BYTES, p, first + s, n0, row0, rows, tid);\n",
         "      ;\n"),
        ("int4_matmul.cu",
         "      load_stage<MT, WV, G>(smem + (nx % R::STAGES) * R::BYTES, p, first + nx, n0, row0,"
         " rows,\n                            tid);\n",
         "      ;\n")],
}


def make(root: Path, out: Path, names: list[str]) -> None:
    src = root / "video_r2_tpu_torch"
    dst = out / "video_r2_tpu_torch"
    if out.exists():
        shutil.rmtree(out)
    shutil.copytree(src, dst, ignore=shutil.ignore_patterns("__pycache__"))
    for name in names:
        for fname, old, new in VARIANTS[name]:
            path = dst / "csrc" / fname
            text = path.read_text()
            if text.count(old) != 1:
                raise SystemExit(f"variant {name}: {fname} holds {text.count(old)} copies "
                                 f"of the text it replaces, not 1")
            path.write_text(text.replace(old, new))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", required=True, help="the checkout whose port is copied")
    ap.add_argument("--out", required=True, help="where the variant's checkout goes")
    ap.add_argument("names", nargs="+", choices=sorted(VARIANTS))
    args = ap.parse_args()
    make(Path(args.root), Path(args.out), args.names)
    print(args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
