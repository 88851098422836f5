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
  int4_nocompute       csrc/stream_k.cuh of this tree (the ring the int4
                       and int8 decode kernels share; int8_nocompute is the
                       same edit): the decode kernel's loads and tile
                       closes without its products
  int4_noclose         the same source (int8_noclose is the same edit):
                       the decode kernel without its tile closes (no y is
                       written; ptxas then drops the products too, whose
                       sums nothing reads: the loads alone)
  int4_noticket        csrc/stream_k.cuh of this tree (csrc/int4_matmul.cu
                       of 9746d8c): every stream-K tile close stores its
                       sums as y (no parts, tickets or fixups)
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
  int8_noconvert       csrc/stream_k.cuh of this tree: the int8 decode
                       kernels' A fragments (the matmul's and the MoE
                       FFN's; moeq_noconvert is the same edit) are the raw
                       weight words (no int8_pairs)
  int8_nocompute       as int4_nocompute
  int8_noclose         as int4_noclose
  int8_4blocks         csrc/int8_matmul.cu of this tree: 4 decode blocks an
                       SM (5 / 4 stages for 8 / 16 rows of x)
  moe_3blocks          csrc/moe_ffn.cu of this tree: the decode kernel on 3
                       blocks an SM at every width (4 / 3 / 3 stages for 1-2
                       / 4 / 8 token tiles; bf16 and int8 weights alike)
  moeq_noconvert       as int8_noconvert
  moewq_noconvert      csrc/moe_ffn.cu of this tree: the int8-weight GMM
                       prefill's wgmma kernels (moe_int8_wgmma_kernel, mode
                       1) take the raw weight words as their A fragments
                       (no int8_pairs)
  moewq_noproducts     the same source: the int8-weight and W8A8 wgmma
                       kernels issue no product (their fragments are formed
                       and folded into one accumulator each, so ptxas keeps
                       them; the loads, fragments and epilogue alone)
  moewq_rowfast        the same source: the blocks of the int8 wgmma kernels
                       in row-tile-fastest order (the row blocks of one
                       weight tile in flight together, not the column tiles
                       of one row block)
  moewq_halfboxes      the same source: each weight box loaded as two boxes
                       of half its k rows (twice the boxes a stage, the same
                       bytes and layout)
  moewq_halfring       the same source: half the ring (half the stages)
  moewq_nofrags        the same source: the int8 wgmma kernels' products run
                       on constant A fragments (no ldmatrix, no conversion)
  moewq_ss             the same source, with moewq_nofrags: mode 1's products
                       read A from shared memory (the weight box taken as a
                       bf16 tile: wgmma's shared-memory form, not its
                       register form)
  moewq_oneexpert      the same source: every block of the int8 wgmma kernels
                       reads expert 0's weights (L2-resident: what the weights'
                       misses cost)
  moewq_onerow         the same source: every block reads the x (or h) rows of
                       row block 0 (L2-resident)
  moe_bf16_loads       the same source: the bf16 wgmma kernels (gate / up and
                       down) issue no product (their ring and epilogue alone)
  moewq_halfx          the same source: the x (or h) box loaded on even stages
                       only (odd stages reuse stale rows: half the rows' bytes)
  moewq_halfw          the same source: the weight boxes loaded on even stages
                       only (half the weights' bytes)
  moewq_wait0          the same source: each stage waits for its own products
                       (the next stage's fragments are not formed under them)
  moewq_loads          the same source, with moewq_noproducts: nor do they
                       form fragments (no ldmatrix, no conversion: the TMA
                       ring, its barriers and the epilogue alone)
  int8w_noconvert      csrc/int8_matmul.cu of this tree: the wide kernel's A
                       fragments are the raw weight words (no conversion)
  int8w_noproducts     the same source: the wide kernel issues no product
                       (its fragments are formed and folded into one
                       accumulator, so ptxas keeps them; the ring, the
                       fragments and the epilogue alone)
  int8w_loads          the same source, with int8w_noproducts and
                       int8w_noconvert: nor does it load fragments (no
                       ldmatrix: the TMA ring, its barriers and the
                       epilogue alone)
  int8w_1block         the same source: the 32- and 64-row tiles on one
                       block an SM (the 128-row tile's ring and registers)
  int8w_depth3         the same source: three fragment buffers, the
                       products of two stages in flight while the next
                       stage's fragments are formed (not one)
  winbwd_noproducts    csrc/attn_common.cuh of this tree: no mma.sync
                       product (each is a fold of its fragments into one
                       sum, so ptxas keeps the ldmatrix loads), in every
                       kernel of the copy; timed on the bf16 window
                       backward: its ring, fragments, softmax, P / dS tiles
                       and stores
  winbwd_nostores      csrc/vit_window_attn_bwd.cu of this tree: no
                       gradient reaches device memory
                       (the shared-memory staging is kept, its read-back
                       and the 16-byte stores dropped)
  winbwd_loads         the same source: the ring alone (each window's q, k,
                       v, dO and flags land, and nothing reads them: no
                       fragment, product or store)
  winbwd_directstores  the same source: each gradient stored from its C
                       fragments as 4-byte bf16 pairs (the parent's
                       stores), with no shared-memory staging
  winbwd_windowsfast   the same source: the (head, window) items windows
                       fastest, the forward's order (a block walks windows
                       of one head; neighbouring heads' pieces of a row
                       meet half a block's range apart)
  winbwd_stages2       the same source: a ring of 2 stages (two blocks an
                       SM at hd 64 / 80: 106 KB of shared memory each)
  winbwd_stages4       the same source: a ring of 4 stages at hd 64 / 80
                       (194 KB at hd 80; hd 128 keeps 3)
  winbwd_bulkstores    the same source: each gradient's 16 staged rows of a
                       warp leave by bulk asynchronous copies
                       (cp.async.bulk, one row a lane) in place of 16-byte
                       stores; a lane waits for its copies' reads before
                       its rows are written again or the ring refills
  winbwd_streamstores  the same source: the gradients' 16-byte stores with
                       the streaming hint (st.global.cs, __stcs)

The variants of one source combine (int4_nocompute with int4_2blocks).
"""

from __future__ import annotations

import argparse
import shutil
import sys
from pathlib import Path

INT8W_LDSM = "      vr2::ldsm_x4_trans(r, vr2::sw128_at(st, 32 * h + lane, c0));\n"
INT8W_NO_LDSM = "      r[0] = r[1] = r[2] = r[3] = 0x01020304u * (h + 1) + lane;\n"
INT8W_PAIRS = """\
        vr2::int8_pairs(r[2 * q], f[2 * h + q][0], f[2 * h + q][1]);
        vr2::int8_pairs(r[2 * q + 1], f[2 * h + q][2], f[2 * h + q][3]);
"""
INT8W_RAW = """\
        f[2 * h + q][0] = f[2 * h + q][1] = r[2 * q];
        f[2 * h + q][2] = f[2 * h + q][3] = r[2 * q + 1];
"""
INT8W_PRODUCTS = """\
    for (int kk = 0; kk < 4; ++kk)
      vr2::wgmma_rs<BN, 0>(acc, f[kk], vr2::desc_k_sw128(st + G::W_BYTES, kk), 1);
"""
INT8W_NO_PRODUCTS = """\
    for (int kk = 0; kk < 4; ++kk)
      acc[0][0] += __uint_as_float((f[kk][0] ^ f[kk][1] ^ f[kk][2] ^ f[kk][3]) & 0x3fffffffu);
"""
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

# the ring and the int8 A fragments the decode kernels share (csrc/stream_k.cuh)
DECODE_COMPUTE = "      compute(ring + slot * BYTES);\n"
DECODE_FLUSH = "    flush(T, sa, sb);\n"
INT8_PAIRS = "  for (int i = 0; i < 4; ++i) int8_pairs(wr[i], even[i], odd[i]);\n"
RAW_PAIRS = "  for (int i = 0; i < 4; ++i) even[i] = wr[i], odd[i] = wr[i] >> 8;\n"

# the int8 wgmma kernels of the GMM prefill FFN (csrc/moe_ffn.cu, namespace wq)
WQ_PAIRS = """\
          int8_pairs(r[2 * q], f[kk][q][0], f[kk][q][1]);
          int8_pairs(r[2 * q + 1], f[kk][q][2], f[kk][q][3]);
"""
WQ_RAW = """\
          f[kk][q][0] = r[2 * q], f[kk][q][1] = r[2 * q] >> 8;
          f[kk][q][2] = r[2 * q + 1], f[kk][q][3] = r[2 * q + 1] >> 8;
"""
WQ_PRODUCTS = """\
      for (int u = 0; u < NU; ++u) {
        if constexpr (MODE == kW8A8)
          wgmma_rs<BN>(acc[u], f[kk][u], db, scale);
        else
          wgmma_rs<BN, 0>(acc[u], f[kk][u], db, scale);
      }
"""
WQ_NO_PRODUCTS = """\
      for (int u = 0; u < NU; ++u)
        acc[u][0][0] += (Acc)(f[kk][u][0] ^ f[kk][u][1] ^ f[kk][u][2] ^ f[kk][u][3] ^ (uint32_t)db);
"""
WQ_LDSM_Q = """\
        ldsm_x4_trans(r, sw128_at(st + (u ? box[NU - 1] : box[0]), kr,
                                  (u ? c0[NU - 1] : c0[0]) % kBoxCols));
"""
WQ_LDSM_QQ = """\
          ldsm_x4_trans(r, sw128_at(st + box[u], kr, c0[u] % kBoxCols));
"""
WQ_NO_LDSM_Q = "        r[0] = r[1] = r[2] = r[3] = kk;\n"
WQ_NO_LDSM_QQ = "          r[0] = r[1] = r[2] = r[3] = kk;\n"

# the bf16 window backward (csrc/vit_window_attn_bwd.cu)
WINBWD_MMA = """\
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
"""
WINBWD_NO_MMA = "  d[0] += __uint_as_float((a[0] ^ a[1] ^ a[2] ^ a[3] ^ b0 ^ b1) & 0x3fffffffu);\n"
WINBWD_STORE = """\
    *reinterpret_cast<uint4*>(out + ((long long)(s0 + r0 + r) * nh + h) * HD + c) =
        *reinterpret_cast<const uint4*>(stage + (r0 + r) * QP + c);
"""
WINBWD_STAGED = """\
  __syncwarp();  // the lanes' reads of these rows for the last gradient are done
#pragma unroll
  for (int ri = 0; ri < 2; ++ri) {
    __nv_bfloat16* row = stage + (r0 + g + 8 * ri) * QP + 2 * t;
"""
WINBWD_DIRECT = """\
  (void)stage, (void)CH;
#pragma unroll
  for (int ri = 0; ri < 2; ++ri) {
    __nv_bfloat16* row = out + ((long long)(s0 + r0 + g + 8 * ri) * nh + h) * HD + 2 * t;
"""
WINBWD_STORE_LOOP = """\
  __syncwarp();
#pragma unroll
  for (int i = lane; i < 16 * CH; i += vr2::kWarp) {
    const int r = i / CH, c = (i - r * CH) * 8;
    *reinterpret_cast<uint4*>(out + ((long long)(s0 + r0 + r) * nh + h) * HD + c) =
        *reinterpret_cast<const uint4*>(stage + (r0 + r) * QP + c);
  }
"""
WINBWD_BULK = """\
  asm volatile("fence.proxy.async.shared::cta;\\n" ::: "memory");  // the rows, for the copies
  __syncwarp();
  (void)CH;
  if (lane < 16) {
    const unsigned src =
        static_cast<unsigned>(__cvta_generic_to_shared(stage + (r0 + lane) * QP));
    asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\\n" ::"l"(
                     out + ((long long)(s0 + r0 + lane) * nh + h) * HD),
                 "r"(src), "r"(HD * 2)
                 : "memory");
    asm volatile("cp.async.bulk.commit_group;\\n" ::: "memory");
  }
"""
WINBWD_TOP = ("    __syncthreads();  // ... every thread's; the last window's stage, P and dS "
              "are free\n")
WINBWD_TOP_BULK = ("    asm volatile(\"cp.async.bulk.wait_group.read 0;\\n\" ::: \"memory\");\n"
                   + WINBWD_TOP)
WINBWD_END = """\
                     pass == 0 ? 1.f : p.scale);
    }
  }
}
"""
WINBWD_END_BULK = """\
                     pass == 0 ? 1.f : p.scale);
    }
  }
  asm volatile("cp.async.bulk.wait_group 0;\\n" ::: "memory");
}
"""
WINBWD_REFILL = """\
    if (nx < end)
      load_window<HD>(smem_raw + (sl == 0 ? W::STAGES - 1 : sl - 1) * W::BYTES, p, nx, tid);
    vr2::cp_async_commit();
"""

# name -> [(file under csrc/, or a path from it, old text, new text)]
VARIANTS = {
    "int4_nodequant": [("int4_matmul.cu", PARENT_INT4_DEQUANT, RAW_INT4)],
    "window_notranspose": [(
        "vit_window_attn.cu",
        "vr2::load_tile_transposed<HD>(sVt, VP,",
        "vr2::load_tile<HD>(sVt, QP,")],
    "int4_nodequant_new": [("int4_matmul.cu", DECODE_DEQUANT, RAW_DECODE)],
    "int4_nocompute": [("stream_k.cuh", DECODE_COMPUTE, "")],
    "int4_noclose": [("stream_k.cuh", DECODE_FLUSH, "")],
    "int4_noticket": [(
        "stream_k.cuh",
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
        "      if (z < S) got[z] = vr2::sk::ld_cluster_f4(at, z);\n",
        "      got[z] = make_float4(0.f, 0.f, 0.f, 0.f);\n")],
    "int4_cluster_local": [
        ("int4_matmul.cu",
         "  vr2::sk::cluster_sync();  // every split's sums are in its shared memory\n",
         "  __syncthreads();\n"),
        ("int4_matmul.cu",
         "  for (int i = blockIdx.z * kThreads + tid; i < rows * (kBN / 4); i += S * kThreads) {",
         "  for (int i = tid; i < rows * (kBN / 4); i += kThreads) {"),
        ("int4_matmul.cu", "      if (z < S) got[z] = vr2::sk::ld_cluster_f4(at, z);\n",
         "      got[z] = z == 0 ? *reinterpret_cast<const float4*>(at)\n"
         "                      : make_float4(0.f, 0.f, 0.f, 0.f);\n"),
        ("int4_matmul.cu",
         "  vr2::sk::cluster_sync();  // no block leaves while another reads its sums\n",
         "")],
    "int4_split8": [("../ops/int4_matmul.py", "SPLIT_MAX = 16 ", "SPLIT_MAX = 8 ")],
    "int8_noconvert": [("stream_k.cuh", INT8_PAIRS, RAW_PAIRS)],
    "int8_nocompute": [("stream_k.cuh", DECODE_COMPUTE, "")],
    "int8_noclose": [("stream_k.cuh", DECODE_FLUSH, "")],
    "int8w_noconvert": [("int8_matmul.cu", INT8W_PAIRS, INT8W_RAW)],
    "int8w_noproducts": [("int8_matmul.cu", INT8W_PRODUCTS, INT8W_NO_PRODUCTS)],
    "int8w_loads": [("int8_matmul.cu", INT8W_PAIRS, INT8W_RAW),
                    ("int8_matmul.cu", INT8W_PRODUCTS, INT8W_NO_PRODUCTS),
                    ("int8_matmul.cu", INT8W_LDSM, INT8W_NO_LDSM)],
    "int8w_1block": [("int8_matmul.cu", "  static constexpr int MINB = BN <= 64 ? 2 : 1;\n",
                      "  static constexpr int MINB = 1;\n")],
    "int8w_depth3": [("int8_matmul.cu", "constexpr int kDepth = 2;", "constexpr int kDepth = 3;")],
    "int8_4blocks": [
        ("int8_matmul.cu", "constexpr int kBlocksPerSm = 3;", "constexpr int kBlocksPerSm = 4;"),
        ("int8_matmul.cu", "static constexpr int STAGES = MT == 1 ? 7 : 6;",
         "static constexpr int STAGES = MT == 1 ? 5 : 4;")],
    "moe_3blocks": [(
        "moe_ffn.cu",
        "static constexpr int STAGES = Q && NT == 1 ? 4 : NT <= 2 ? 6 : NT == 4 ? 5 : 4;",
        "static constexpr int STAGES = NT <= 2 ? 4 : 3;")],
    "moeq_noconvert": [("stream_k.cuh", INT8_PAIRS, RAW_PAIRS)],
    "moewq_noconvert": [("moe_ffn.cu", WQ_PAIRS, WQ_RAW)],
    "moewq_noproducts": [("moe_ffn.cu", WQ_PRODUCTS, WQ_NO_PRODUCTS)],
    "moewq_rowfast": [("moe_ffn.cu",
                       "  wg::block_coords((N + G::COLS - 1) / G::COLS, C / BN, a, z, j);\n",
                       "  {\n    const int rz = gridDim.x / ((N + G::COLS - 1) / G::COLS);\n"
                       "    j = blockIdx.x / rz;\n    a = blockIdx.x % rz / (C / BN);\n"
                       "    z = blockIdx.x % rz % (C / BN);\n  }\n")],
    "moewq_halfboxes": [
        ("moe_ffn.cu", "    tma_stage(bar, G::STAGE, 1 + NW * NB, [&](int b) {",
         "    tma_stage(bar, G::STAGE, 1 + 2 * NW * NB, [&](int b) {"),
        ("moe_ffn.cu",
         "        const int which = (b - 1) / NB, bx = (b - 1) % NB;\n"
         "        tma_load_3d(st + G::X_BYTES + (b - 1) * G::BOX, which ? &mw1 : &mw0, bar,\n"
         "                    n0 + kBoxCols * bx, k0, e);\n",
         "        const int which = (b - 1) / 2 / NB, bx = (b - 1) / 2 % NB, hf = (b - 1) % 2;\n"
         "        tma_load_3d(st + G::X_BYTES + (b - 1) / 2 * G::BOX + hf * G::BOX / 2,\n"
         "                    which ? &mw1 : &mw0, bar, n0 + kBoxCols * bx, k0 + hf * G::KS / 2, e);\n"),
        ("moe_ffn.cu", "p.I, p.H, p.E, GU::KS, true)) != cudaSuccess ||\n"
         "      (err = box_map(&mwu, p.wu, p.I, p.H, p.E, GU::KS, true))",
         "p.I, p.H, p.E, GU::KS / 2, true)) != cudaSuccess ||\n"
         "      (err = box_map(&mwu, p.wu, p.I, p.H, p.E, GU::KS / 2, true))"),
        ("moe_ffn.cu", "box_map(&mwd, p.wd, p.H, p.I, p.E, DN::KS, true)",
         "box_map(&mwd, p.wd, p.H, p.I, p.E, DN::KS / 2, true)")],
    "moewq_halfring": [("moe_ffn.cu", "constexpr int kRingBytes = 200 * 1024;",
                        "constexpr int kRingBytes = 100 * 1024;")],
    "moewq_nofrags": [("moe_ffn.cu", WQ_LDSM_Q, WQ_NO_LDSM_Q),
                      ("moe_ffn.cu", WQ_LDSM_QQ, WQ_NO_LDSM_QQ)],
    "moewq_ss": [("moe_ffn.cu", WQ_LDSM_Q, WQ_NO_LDSM_Q),
                 ("moe_ffn.cu", WQ_LDSM_QQ, WQ_NO_LDSM_QQ),
                 ("moe_ffn.cu", "          wgmma_rs<BN, 0>(acc[u], f[kk][u], db, scale);",
                  "          wgmma_ss<BN, 0>(acc[u], desc_k_sw128(st + box[u], kk), db, scale);")],
    "moewq_oneexpert": [("moe_ffn.cu",
                         "  const int e = min(max(ids[a], 0), E - 1);\n  // tile u = (weight u / NB",
                         "  const int e = 0;\n  // tile u = (weight u / NB")],
    "moewq_onerow": [("moe_ffn.cu", "        tma_load_2d(st, &mx, bar, k0, row);\n      } else {\n"
                      "        const int which",
                      "        tma_load_2d(st, &mx, bar, k0, 0);\n      } else {\n"
                      "        const int which")],
    "moe_bf16_loads": [
        ("moe_ffn.cu",
         "          wgmma_ss<BN, 1>(g, da, desc_mn_sw128(st + R::A_BYTES, kk, kBoxBytes), 1);\n"
         "          wgmma_ss<BN, 1>(u, da, desc_mn_sw128(st + R::A_BYTES + R::B_BYTES, kk, kBoxBytes), 1);\n",
         "          g[0][0] += (float)(uint32_t)da;\n"),
        ("moe_ffn.cu",
         "          wgmma_ss<BN, 1>(acc, desc_k_sw128(st + w * kRows * 128, kk),\n"
         "                          desc_mn_sw128(st + R::A_BYTES, kk, kBoxBytes), 1);\n",
         "          acc[0][0] += (float)(uint32_t)desc_k_sw128(st + w * kRows * 128, kk);\n")],
    "moewq_halfx": [("moe_ffn.cu", "    tma_stage(bar, G::STAGE, 1 + NW * NB, [&](int b) {",
                     "    tma_stage(bar, G::STAGE - (s & 1) * G::X_BYTES, 1 + NW * NB, [&](int b) {"),
                    ("moe_ffn.cu", "        tma_load_2d(st, &mx, bar, k0, row);\n      } else {\n"
                     "        const int which",
                     "        if (!(s & 1)) tma_load_2d(st, &mx, bar, k0, row);\n      } else {\n"
                     "        const int which")],
    "moewq_halfw": [("moe_ffn.cu", "    tma_stage(bar, G::STAGE, 1 + NW * NB, [&](int b) {",
                     "    tma_stage(bar, G::STAGE - (s & 1) * NW * NB * G::BOX, 1 + NW * NB, [&](int b) {"),
                    ("moe_ffn.cu", "        tma_load_3d(st + G::X_BYTES + (b - 1) * G::BOX, which ? &mw1 : &mw0, bar,\n"
                     "                    n0 + kBoxCols * bx, k0, e);\n",
                     "        if (!(s & 1))\n"
                     "          tma_load_3d(st + G::X_BYTES + (b - 1) * G::BOX, which ? &mw1 : &mw0, bar,\n"
                     "                      n0 + kBoxCols * bx, k0, e);\n")],
    "moewq_wait0": [("moe_ffn.cu", "    wgmma_commit();\n    wgmma_wait<1>();\n",
                     "    wgmma_commit();\n    wgmma_wait<0>();\n")],
    "moewq_loads": [("moe_ffn.cu", WQ_PRODUCTS, WQ_NO_PRODUCTS),
                    ("moe_ffn.cu", WQ_LDSM_Q, WQ_NO_LDSM_Q),
                    ("moe_ffn.cu", WQ_LDSM_QQ, WQ_NO_LDSM_QQ)],
    "winbwd_noproducts": [("attn_common.cuh", WINBWD_MMA, WINBWD_NO_MMA)],
    "winbwd_nostores": [("vit_window_attn_bwd.cu", WINBWD_STORE, "    (void)out, (void)c;\n")],
    "winbwd_loads": [("vit_window_attn_bwd.cu", WINBWD_REFILL, WINBWD_REFILL + "    continue;\n")],
    "winbwd_directstores": [("vit_window_attn_bwd.cu", WINBWD_STAGED, WINBWD_DIRECT),
                            ("vit_window_attn_bwd.cu", WINBWD_STORE, "    (void)c;\n")],
    "winbwd_windowsfast": [
        ("vit_window_attn_bwd.cu", "  const int h = item % p.nh, s0 = item / p.nh * WP;\n",
         "  const int h = item / p.nw, s0 = (item - h * p.nw) * WP;\n"),
        ("vit_window_attn_bwd.cu", "    const int h = it % p.nh, s0 = it / p.nh * WP;\n",
         "    const int h = it / p.nw, s0 = (it - h * p.nw) * WP;\n")],
    "winbwd_stages2": [("vit_window_attn_bwd.cu", "  static constexpr int STAGES = 3;\n",
                        "  static constexpr int STAGES = 2;\n")],
    "winbwd_stages4": [("vit_window_attn_bwd.cu", "  static constexpr int STAGES = 3;\n",
                        "  static constexpr int STAGES = HD == 128 ? 3 : 4;\n")],
    "winbwd_bulkstores": [
        ("vit_window_attn_bwd.cu", WINBWD_STAGED,
         "  if (lane < 16) asm volatile(\"cp.async.bulk.wait_group.read 0;\\n\" ::: \"memory\");\n"
         + WINBWD_STAGED),
        ("vit_window_attn_bwd.cu", WINBWD_STORE_LOOP, WINBWD_BULK),
        ("vit_window_attn_bwd.cu", WINBWD_TOP, WINBWD_TOP_BULK),
        ("vit_window_attn_bwd.cu", WINBWD_END, WINBWD_END_BULK)],
    "winbwd_streamstores": [("vit_window_attn_bwd.cu", WINBWD_STORE, """\
    __stcs(reinterpret_cast<uint4*>(out + ((long long)(s0 + r0 + r) * nh + h) * HD + c),
           *reinterpret_cast<const uint4*>(stage + (r0 + r) * QP + c));
""")],
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
