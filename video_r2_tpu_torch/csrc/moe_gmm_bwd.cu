// Backward of the sorted grouped-matmul MoE FFN (the GMM layout) for Hopper
// (sm_90a): the port of video_r2_tpu/ops/moe_gmm.py::_bwd_dx_kernel (:185),
// _bwd_dw_kernel (:213) and _bwd_dwd_kernel (:258), the kernels of the
// custom VJP gmm_expert_ffn_diff.
//
// Over the sorted layout (rows in blocks of bm, block a of expert ids[a],
// valid[a] == 0 on the slack blocks past the occupied rows), with
// g = x Wg, u = x Wu, dh = dY Wd^T:
//   dg = dh u silu'(g), du = dh silu(g), h = silu(g) u
//   dX = dg Wg^T + du Wu^T                       per row
//   dWg = sum x^T dg, dWu = sum x^T du, dWd = sum h^T dY   per expert, over
//                                                its run of rows
// Rounding points (the plain versions in ops/moe_gmm.py have the same): dY
// arrives in bf16 (the wrapper rounds the fp32 dY once); g, u, dh, dX and
// the dW sums are fp32 from bf16 products; dg, du and h are rounded to bf16
// once, after their fp32 elementwise terms, because the products that
// consume them take bf16 operands. The TPU kernels keep them in fp32 and
// recompute g, u and dh inside each of the three kernels (their VMEM could
// not hold the intermediates); here they are formed once. fp32 operands
// take the fp32 instances (CUDA cores, fp32_tile.cuh): every operand,
// product and term fp32, as the JAX kernels cast their tiles.
//
// Three entry points, four launches:
//   vr2_moe_gmm_bwd_dx (replaces _bwd_dx_kernel), two launches of warpgroup
//   wgmma fed by TMA, the bf16 forward's machinery (csrc/moe_ffn.cu, namespace
//   wg; the ring in wgmma.cuh):
//     1. terms: one block per (64 or 128 rows of a row block, 64 columns of
//        I), one warpgroup per 64 rows; K = H streams through a 4-stage ring
//        of 64-k stages (56 KB a stage at 128 rows: the x and dY tiles and a
//        box of each of Wg, Wu, Wd, 128-byte swizzle). Each k16 step issues
//        g = x Wg and u = x Wu (B MN-major: the weights' own [H, I] layout,
//        the transpose bit set) and dh = dY Wd^T (B K-major: Wd's own [I, H]
//        rows), three 64 x 64 fp32 accumulators a warpgroup (96 registers a
//        thread). The epilogue forms dg, du (and h when dW will be formed)
//        in bf16 [rows, I].
//     2. dX: one block per (64 or 128 rows, 128 columns of H; 64 where 128
//        does not divide H), K = I, dg Wg^T + du Wu^T into one fp32
//        accumulator: both B operands K-major, Wg's and Wu's own [H, I]
//        rows; a 3-stage ring of 64 KB stages at 128 rows.
//     Blocks of 128 rows take two warpgroups, others one; a tile that runs
//     past its block (bm not a multiple of 64) multiplies the next block's
//     rows and drops them (each output row depends on its own A row only),
//     and boxes past the array read zeros. Slack blocks write zeros and read
//     nothing. No atomics: two calls give the same bits.
//   vr2_moe_gmm_bwd_dw (replaces _bwd_dw_kernel, and _bwd_dwd_kernel with
//     one operand): each expert's gradient is the sum over its run of rows
//     (contiguous in the layout) of a^T b_j, in the operands' type: bf16
//     sums are fp32 and rounded to bf16 once, in the epilogue (the JAX
//     package's dwg.astype(wg.dtype)). Each output tile is written once,
//     by one block, with no atomics and no second pass; an expert with no
//     rows writes zeros. The run of each expert is counted from the block
//     table inside the kernel, so a call is one launch. bf16: a persistent
//     grid of 384-thread blocks (namespace wgw) over tiles of 128 rows by
//     128 (dWg / dWu, two accumulators) or 256 (dWd, one) columns, 64 where
//     those do not divide N; wgmma with both operands MN-major, fed by TMA
//     through a ring of 64-row stages; the epilogue stored by TMA while the
//     next tile's stages load. fp32: one 256-thread block per (expert, 64 x
//     64 output tile) on the CUDA cores.
//
// What bounds it: at the judge's shapes (H 2048, I 768, E 128, top 8, ~32k
// routed rows) the operations, 16 R H I for the whole backward (g, u 4,
// dh 2, dX 4, dWg / dWu 4, dWd 2), and the dW outputs, 3 E H I words (1.2
// GB in bf16), which bound the dW launches by bytes. The grids run the
// innermost output tiles fastest (columns of I in the terms pass, of H in
// dX, the tiles of one expert in dW), so a row tile, and an expert's
// weights or rows, are read from device memory about once and served to
// their other tiles from L2. On an H100 80GB HBM3 at 700 W: the dX pair was
// mma.sync over 16-byte cp.async copies on 64 x 64 tiles first (4.0 ms at
// T = 4096): the copies, as in the forward, set its rate. So was dW (64 x
// 64 tiles, fp32 outputs converted after: 1.63 and 0.95 ms at T = 4096);
// its 128-row tiles copy 2-3x fewer bytes from L2, and it writes half the
// bytes. Its loads and stores alone take 89-96% of its time there (PERF.md
// section 5): a cluster sharing the b tiles (a third fewer L2 bytes) did
// not move it, and storing straight from registers instead of the TMA
// store ran 2x slower.
#include "attn_common.cuh"
#include "fp32_tile.cuh"
#include "wgmma.cuh"

namespace vr2 {
namespace gmm_bwd {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float sigmoid(float v) { return 1.0f / (1.0f + expf(-v)); }

// block index -> (row block a, its row tile z, column tile j), j fastest:
// the column tiles of a row tile read its rows together
__device__ __forceinline__ void block_coords(int nj, int zt, int& a, int& z, int& j) {
  j = blockIdx.x % nj;
  z = (blockIdx.x / nj) % zt;
  a = blockIdx.x / (nj * zt);
}

// ---------------------------------------------------------------------------
// dX on wgmma fed by TMA
// ---------------------------------------------------------------------------
namespace wgx {

constexpr int kK = 64;                // k per ring stage (four k16 steps)
constexpr int kRows = 64;             // rows of a warpgroup
constexpr int kBoxBytes = 64 * 128;   // a box [64][64 bf16]

// as many stages of STAGE bytes as fit the shared memory, at most 4
constexpr int stages_for(int stage) {
  return kSwizzleAlign + 4 * stage + 32 <= 232448 ? 4 : 3;
}

// terms: the x and dY tiles [BM][64 k], then the Wg and Wu boxes [64 k][64
// columns of I] and the Wd box [64 columns of I][64 k]
template <int WG>
struct TermsGeo {
  static constexpr int BM = WG * kRows;
  static constexpr int A_BYTES = BM * 128;
  static constexpr int STAGE = 2 * A_BYTES + 3 * kBoxBytes;
  static constexpr int STAGES = stages_for(STAGE);
  static constexpr int SMEM = kSwizzleAlign + STAGES * STAGE + STAGES * 8;
};

// dX: the dg and du tiles [BM][64 k], then the Wg and Wu tiles [BN columns
// of H][64 k] (BN / 64 boxes each)
template <int WG, int BN>
struct DxGeo {
  static constexpr int BM = WG * kRows;
  static constexpr int A_BYTES = BM * 128;
  static constexpr int B_BYTES = BN * 128;
  static constexpr int STAGE = 2 * A_BYTES + 2 * B_BYTES;
  static constexpr int STAGES = stages_for(STAGE);
  static constexpr int SMEM = kSwizzleAlign + STAGES * STAGE + STAGES * 8;
};

// Pass 1 of dX: dg, du (and h when h != nullptr) [rows, I] bf16 for one
// (row tile, 64 columns of I). Maps: x, dY 2-D [n bm, H] in boxes of BM
// rows; wg, wu, wd 3-D over [E, H, I] / [E, H, I] / [E, I, H] in [64][64]
// boxes.
template <int WG>
__global__ void __launch_bounds__(128 * WG, 1)
    gmm_bwd_terms_kernel(__grid_constant__ const CUtensorMap mx,
                         __grid_constant__ const CUtensorMap mdy,
                         __grid_constant__ const CUtensorMap mwg,
                         __grid_constant__ const CUtensorMap mwu,
                         __grid_constant__ const CUtensorMap mwd, const int* __restrict__ ids,
                         const int* __restrict__ valid, bf16* __restrict__ dg,
                         bf16* __restrict__ du, bf16* __restrict__ h, int bm, int H, int I,
                         int E) {
  using G = TermsGeo<WG>;
  extern __shared__ __align__(128) unsigned char smem[];
  int a, z, j;
  block_coords(I / 64, (bm + G::BM - 1) / G::BM, a, z, j);
  const int n0 = j * 64, r0 = z * G::BM, rows = min(G::BM, bm - r0);
  const int row = a * bm + r0, tid = threadIdx.x, w = tid / 128, lane = tid & 31;
  if (valid[a] == 0) {  // slack block: zeros, nothing read
    for (int i = tid; i < rows * 32; i += 128 * WG) {
      const long long o = (long long)(row + i / 32) * I + n0 + 2 * (i % 32);
      const uint32_t zr = pack_bf16(0.0f, 0.0f);
      *reinterpret_cast<uint32_t*>(dg + o) = zr;
      *reinterpret_cast<uint32_t*>(du + o) = zr;
      if (h) *reinterpret_cast<uint32_t*>(h + o) = zr;
    }
    return;
  }
  const int e = min(max(ids[a], 0), E - 1);
  float g[8][4], u[8][4], dh[8][4];
  zero_acc(g);
  zero_acc(u);
  zero_acc(dh);
  unsigned char* ring = swizzle_aligned(smem);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + G::STAGES * G::STAGE);
  tma_ring<G::STAGES, 1>(
      full, H / kK,
      [&](int s) {
        unsigned char* st = ring + (s % G::STAGES) * G::STAGE;
        uint64_t* bar = full + s % G::STAGES;
        const int k0 = s * kK;
        unsigned char* wst = st + 2 * G::A_BYTES;
        tma_stage(bar, G::STAGE, 5, [&](int b) {
          if (b == 0) tma_load_2d(st, &mx, bar, k0, row);
          else if (b == 1) tma_load_2d(st + G::A_BYTES, &mdy, bar, k0, row);
          else if (b == 2) tma_load_3d(wst, &mwg, bar, n0, k0, e);
          else if (b == 3) tma_load_3d(wst + kBoxBytes, &mwu, bar, n0, k0, e);
          else tma_load_3d(wst + 2 * kBoxBytes, &mwd, bar, k0, n0, e);
        });
      },
      [&](int slot) {
        const unsigned char* st = ring + slot * G::STAGE;
        const unsigned char* wst = st + 2 * G::A_BYTES;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kK / 16; ++kk) {
          const uint64_t da = desc_k_sw128(st + w * kRows * 128, kk);
          wgmma_ss<64, 1>(g, da, desc_mn_sw128(wst, kk, kBoxBytes), 1);
          wgmma_ss<64, 1>(u, da, desc_mn_sw128(wst + kBoxBytes, kk, kBoxBytes), 1);
          wgmma_ss<64, 0>(dh, desc_k_sw128(st + G::A_BYTES + w * kRows * 128, kk),
                          desc_k_sw128(wst + 2 * kBoxBytes, kk), 1);
        }
        wgmma_commit();
        wgmma_wait<1>();
      });
  wgmma_wait<0>();
  fence_regs(g);
  fence_regs(u);
  fence_regs(dh);

  // accumulator c[j][2 half + jj] = D[16 (warp % 4) + lane / 4 + 8 half][8 j
  // + 2 (lane % 4) + jj] of this warpgroup's 64 rows
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = w * kRows + ((tid >> 5) & 3) * 16 + (lane >> 2) + 8 * half;
    if (r >= rows) continue;
    const long long o = (long long)(row + r) * I + n0 + 2 * (lane & 3);
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      float vg[2], vu[2], vh[2];
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const float gv = g[c][2 * half + jj], uv = u[c][2 * half + jj];
        const float d = dh[c][2 * half + jj];
        const float sg = sigmoid(gv);
        vg[jj] = d * uv * sg * (1.0f + gv * (1.0f - sg));
        vu[jj] = d * gv * sg;
        vh[jj] = gv * sg * uv;
      }
      *reinterpret_cast<uint32_t*>(dg + o + 8 * c) = pack_bf16(vg[0], vg[1]);
      *reinterpret_cast<uint32_t*>(du + o + 8 * c) = pack_bf16(vu[0], vu[1]);
      if (h) *reinterpret_cast<uint32_t*>(h + o + 8 * c) = pack_bf16(vh[0], vh[1]);
    }
  }
}

// Pass 2 of dX: dX [rows, H] fp32 = dg Wg^T + du Wu^T for one (row tile, BN
// columns of H). Maps: dg, du 2-D [n bm, I] in boxes of BM rows; wg, wu 3-D
// over [E, H, I] in [64][64] boxes (the terms pass's maps).
template <int WG, int BN>
__global__ void __launch_bounds__(128 * WG, 1)
    gmm_bwd_dx_kernel(__grid_constant__ const CUtensorMap mdg,
                      __grid_constant__ const CUtensorMap mdu,
                      __grid_constant__ const CUtensorMap mwg,
                      __grid_constant__ const CUtensorMap mwu, const int* __restrict__ ids,
                      const int* __restrict__ valid, float* __restrict__ dx, int bm, int H,
                      int I, int E) {
  using G = DxGeo<WG, BN>;
  extern __shared__ __align__(128) unsigned char smem[];
  int a, z, j;
  block_coords(H / BN, (bm + G::BM - 1) / G::BM, a, z, j);
  const int n0 = j * BN, r0 = z * G::BM, rows = min(G::BM, bm - r0);
  const int row = a * bm + r0, tid = threadIdx.x, w = tid / 128, lane = tid & 31;
  if (valid[a] == 0) {
    for (int i = tid; i < rows * (BN / 4); i += 128 * WG)
      *reinterpret_cast<float4*>(dx + (long long)(row + i / (BN / 4)) * H + n0 +
                                 4 * (i % (BN / 4))) = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    return;
  }
  const int e = min(max(ids[a], 0), E - 1);
  float acc[BN / 8][4];
  zero_acc(acc);
  unsigned char* ring = swizzle_aligned(smem);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + G::STAGES * G::STAGE);
  tma_ring<G::STAGES, 1>(
      full, I / kK,
      [&](int s) {
        unsigned char* st = ring + (s % G::STAGES) * G::STAGE;
        uint64_t* bar = full + s % G::STAGES;
        const int k0 = s * kK;
        tma_stage(bar, G::STAGE, 2 + 2 * (BN / 64), [&](int b) {
          if (b < 2) {
            tma_load_2d(st + b * G::A_BYTES, b ? &mdu : &mdg, bar, k0, row);
          } else {
            const int which = (b - 2) / (BN / 64), c = (b - 2) % (BN / 64);
            tma_load_3d(st + 2 * G::A_BYTES + which * G::B_BYTES + c * kBoxBytes,
                        which ? &mwu : &mwg, bar, k0, n0 + 64 * c, e);
          }
        });
      },
      [&](int slot) {
        const unsigned char* st = ring + slot * G::STAGE;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kK / 16; ++kk) {
          wgmma_ss<BN, 0>(acc, desc_k_sw128(st + w * kRows * 128, kk),
                          desc_k_sw128(st + 2 * G::A_BYTES, kk), 1);
          wgmma_ss<BN, 0>(acc, desc_k_sw128(st + G::A_BYTES + w * kRows * 128, kk),
                          desc_k_sw128(st + 2 * G::A_BYTES + G::B_BYTES, kk), 1);
        }
        wgmma_commit();
        wgmma_wait<1>();
      });
  wgmma_wait<0>();
  fence_regs(acc);

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = w * kRows + ((tid >> 5) & 3) * 16 + (lane >> 2) + 8 * half;
    if (r >= rows) continue;
    float* dr = dx + (long long)(row + r) * H + n0 + 2 * (lane & 3);
#pragma unroll
    for (int c = 0; c < BN / 8; ++c)
      *reinterpret_cast<float2*>(dr + 8 * c) = make_float2(acc[c][2 * half], acc[c][2 * half + 1]);
  }
}

}  // namespace wgx

// ---------------------------------------------------------------------------
// The fp32 instances (CUDA cores): the terms, dX and dW passes over fp32
// operands, 64 x 64 tiles of 64-row tiles of the blocks
// ---------------------------------------------------------------------------

// Pass 1 of dX over fp32: dg, du (and h) [rows, I] fp32
__global__ void __launch_bounds__(f32::kThreads)
    gmm_bwd_terms_f32_kernel(const float* __restrict__ x, const float* __restrict__ dy,
                             const int* __restrict__ ids, const int* __restrict__ valid,
                             const float* __restrict__ wg, const float* __restrict__ wu,
                             const float* __restrict__ wd, float* __restrict__ dg,
                             float* __restrict__ du, float* __restrict__ h, int bm, int H,
                             int I, int E) {
  __shared__ f32::Smem sm;
  int a, z, j;
  block_coords(I / f32::kTile, (bm + f32::kTile - 1) / f32::kTile, a, z, j);
  const int n0 = j * f32::kTile, r0 = z * f32::kTile, rows = min(f32::kTile, bm - r0);
  const long long row = (long long)a * bm + r0;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  f32::Acc g, u, dh;
  f32::zero(g);
  f32::zero(u);
  f32::zero(dh);
  const bool live = valid[a] != 0;
  if (live) {  // slack blocks: zeros, nothing read
    const int e = min(max(ids[a], 0), E - 1);
    const f32::Operand<true> xo{x + row * H, H, rows};
    f32::product(g, xo, f32::Operand<false>{wg + (long long)e * H * I + n0, I, f32::kTile}, H,
                 sm);
    f32::product(u, xo, f32::Operand<false>{wu + (long long)e * H * I + n0, I, f32::kTile}, H,
                 sm);
    f32::product(dh, f32::Operand<true>{dy + row * H, H, rows},
                 f32::Operand<true>{wd + ((long long)e * I + n0) * H, H, f32::kTile}, H, sm);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (4 * ty + i >= rows) continue;
    float vg[4], vu[4], vh[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const float gv = g[i][c], uv = u[i][c], d = dh[i][c], sg = sigmoid(gv);
      vg[c] = live ? d * uv * sg * (1.0f + gv * (1.0f - sg)) : 0.0f;
      vu[c] = live ? d * gv * sg : 0.0f;
      vh[c] = live ? gv * sg * uv : 0.0f;
    }
    const long long o = (row + 4 * ty + i) * I + n0 + 4 * tx;
    *reinterpret_cast<float4*>(dg + o) = make_float4(vg[0], vg[1], vg[2], vg[3]);
    *reinterpret_cast<float4*>(du + o) = make_float4(vu[0], vu[1], vu[2], vu[3]);
    if (h) *reinterpret_cast<float4*>(h + o) = make_float4(vh[0], vh[1], vh[2], vh[3]);
  }
}

// Pass 2 of dX over fp32: dX [rows, H] = dg Wg^T + du Wu^T
__global__ void __launch_bounds__(f32::kThreads)
    gmm_bwd_dx_f32_kernel(const float* __restrict__ dg, const float* __restrict__ du,
                          const int* __restrict__ ids, const int* __restrict__ valid,
                          const float* __restrict__ wg, const float* __restrict__ wu,
                          float* __restrict__ dx, int bm, int H, int I, int E) {
  __shared__ f32::Smem sm;
  int a, z, j;
  block_coords(H / f32::kTile, (bm + f32::kTile - 1) / f32::kTile, a, z, j);
  const int n0 = j * f32::kTile, r0 = z * f32::kTile, rows = min(f32::kTile, bm - r0);
  const long long row = (long long)a * bm + r0;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  f32::Acc acc;
  f32::zero(acc);
  if (valid[a] != 0) {
    const int e = min(max(ids[a], 0), E - 1);
    f32::product(acc, f32::Operand<true>{dg + row * I, I, rows},
                 f32::Operand<true>{wg + ((long long)e * H + n0) * I, I, f32::kTile}, I, sm);
    f32::product(acc, f32::Operand<true>{du + row * I, I, rows},
                 f32::Operand<true>{wu + ((long long)e * H + n0) * I, I, f32::kTile}, I, sm);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
    if (4 * ty + i < rows)
      *reinterpret_cast<float4*>(dx + (row + 4 * ty + i) * H + n0 + 4 * tx) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
}

// The run of rows of expert e in the sorted layout (the valid blocks first,
// each expert's blocks one run, experts ascending): rows [start, start +
// rows), counted by all the block's threads from the block table (sm: two
// ints of shared memory)
__device__ __forceinline__ void expert_run(const int* __restrict__ ids,
                                           const int* __restrict__ valid, int n_blocks, int bm,
                                           int e, int E, int* sm, int& start, int& rows) {
  if (threadIdx.x == 0) sm[0] = sm[1] = 0;
  __syncthreads();
  int before = 0, mine = 0;
  for (int a = threadIdx.x; a < n_blocks; a += blockDim.x)
    if (valid[a] != 0) {
      const int id = min(max(ids[a], 0), E - 1);
      before += id < e;
      mine += id == e;
    }
  if (before) atomicAdd(sm, before);
  if (mine) atomicAdd(sm + 1, mine);
  __syncthreads();
  start = sm[0] * bm;
  rows = sm[1] * bm;
}

// Per expert over fp32: out_j[e] [M, N] = sum over its run of rows of
// a^T b_j (NB = 1 or 2). Grid (N / 64, M / 64, E).
template <int NB>
__global__ void __launch_bounds__(f32::kThreads)
    gmm_bwd_dw_f32_kernel(const float* __restrict__ a, const float* __restrict__ b0,
                          const float* __restrict__ b1, const int* __restrict__ ids,
                          const int* __restrict__ valid, float* __restrict__ out0,
                          float* __restrict__ out1, int n_blocks, int bm, int M, int N, int E) {
  __shared__ f32::Smem sm;
  __shared__ int run[2];
  const int n0 = blockIdx.x * f32::kTile, m0 = blockIdx.y * f32::kTile, e = blockIdx.z;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  int begin, nr;
  expert_run(ids, valid, n_blocks, bm, e, E, run, begin, nr);
  const long long r_begin = begin;
  const f32::Operand<false> ao{a + r_begin * M + m0, M, f32::kTile};
  f32::Acc acc0, acc1;
  f32::zero(acc0);
  f32::zero(acc1);
  f32::product(acc0, ao, f32::Operand<false>{b0 + r_begin * N + n0, N, f32::kTile}, nr, sm);
  if constexpr (NB == 2)
    f32::product(acc1, ao, f32::Operand<false>{b1 + r_begin * N + n0, N, f32::kTile}, nr, sm);
  const long long base = (long long)e * M * N;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long o = base + (long long)(m0 + 4 * ty + i) * N + n0 + 4 * tx;
    *reinterpret_cast<float4*>(out0 + o) = make_float4(acc0[i][0], acc0[i][1], acc0[i][2],
                                                       acc0[i][3]);
    if constexpr (NB == 2)
      *reinterpret_cast<float4*>(out1 + o) = make_float4(acc1[i][0], acc1[i][1], acc1[i][2],
                                                         acc1[i][3]);
  }
}

// ---------------------------------------------------------------------------
// The weight gradients over bf16: wgmma fed by TMA, a persistent grid, the
// epilogue stored by TMA while the next tile's stages load
// ---------------------------------------------------------------------------
namespace wgw {

constexpr int kK = 64;                      // rows of the run a stage: four k16 steps
constexpr int kBM = 128;                    // output rows of a tile: two warpgroups of 64
constexpr int kBox = 64 * 128;              // one [64][64] bf16 box, 128-byte swizzle
constexpr int kConsumers = 256;             // two consumer warpgroups
constexpr int kThreads = kConsumers + 128;  // and a producer warpgroup
// 384 threads start at 65536 / 384 (168 registers); 128 x (168 - 40) =
// 256 x (232 - 168), as the flash forward
constexpr int kProducerRegs = 40, kConsumerRegs = 232;
constexpr int kMaxExperts = 1024;           // entries of the run table

// Shared memory of the (BN, NB) instance: the ring (a stage: a^T as two
// boxes [64 k][64 of M], then each b_j as BN / 64 boxes [64 k][64 of N]),
// each warpgroup's staging tiles for the TMA store (NB x BN / 64 boxes [64
// rows][64 columns]), the full / empty barriers and the run table; as many
// stages as fit, at most 4
template <int BN, int NB>
struct Geo {
  static constexpr int A_BYTES = 2 * kBox;
  static constexpr int B_BYTES = BN / 64 * kBox;
  static constexpr int STAGE = A_BYTES + NB * B_BYTES;
  static constexpr int OUT_WG = NB * B_BYTES;
  static constexpr int FIXED = kSwizzleAlign + 2 * OUT_WG + 8 * kMaxExperts + 64;
  static constexpr int FIT = (232448 - FIXED) / STAGE;
  static constexpr int STAGES = FIT < 4 ? FIT : 4;
  static constexpr int SMEM = FIXED + STAGES * STAGE;
};

// Every expert's run of rows, start[e] and rows[e] in shared memory (as
// expert_run), by all the block's threads
__device__ __forceinline__ void run_table(const int* __restrict__ ids,
                                          const int* __restrict__ valid, int n_blocks, int bm,
                                          int E, int* start, int* rows) {
  for (int e = threadIdx.x; e < E; e += blockDim.x) rows[e] = 0;
  __syncthreads();
  for (int a = threadIdx.x; a < n_blocks; a += blockDim.x)
    if (valid[a] != 0) atomicAdd(rows + min(max(ids[a], 0), E - 1), bm);
  __syncthreads();
  if (threadIdx.x == 0)
    for (int e = 0, s = 0; e < E; ++e) {
      start[e] = s;
      s += rows[e];
    }
  __syncthreads();
}

// Per expert e: out_j[e] [M, N] = the sum over its run of rows of a^T b_j
// (j < NB), rounded once to bf16. A persistent grid: block b takes tiles b,
// b + gridDim.x, ..., tile t = (expert, 128 rows of M, BN columns of N),
// the columns fastest, so the blocks in flight work on one or two experts
// and read their rows from L2. The producer warpgroup's first thread loads
// each tile's stages (64 rows of the run) by TMA into the ring and runs on
// into the next tile's while the consumers finish; each consumer warpgroup
// owns 64 rows of the tile: NB accumulators [64 x BN] fed by wgmma with
// both operands MN-major, as stored (A = a^T: the transpose-A bit; B = b_j:
// the transpose-B bit). A stage that runs past the expert's run holds the
// next expert's rows, or slack rows that may hold anything: those rows are
// zeroed in shared memory, in both operands, before the product. The
// epilogue rounds to bf16 into a staging tile in the 128-byte swizzle and
// stores it by TMA (rows past M and columns past N are not written), which
// drains while the next tile's products run. Maps: a 2-D [rows, M], b_j
// 2-D [rows, N] in [64][64] boxes; out_j 3-D [E, M, N] in [64][64] boxes.
template <int BN, int NB>
__global__ void __launch_bounds__(kThreads, 1)
    gmm_bwd_dw_wgmma_kernel(__grid_constant__ const CUtensorMap ma,
                            __grid_constant__ const CUtensorMap mb0,
                            __grid_constant__ const CUtensorMap mb1,
                            __grid_constant__ const CUtensorMap mo0,
                            __grid_constant__ const CUtensorMap mo1,
                            const int* __restrict__ ids, const int* __restrict__ valid,
                            int n_blocks, int bm, int M, int N, int E) {
  using G = Geo<BN, NB>;
  constexpr int NBOX = BN / 64;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* ring = swizzle_aligned(smem);
  unsigned char* staging = ring + G::STAGES * G::STAGE;
  uint64_t* full = reinterpret_cast<uint64_t*>(staging + 2 * G::OUT_WG);
  uint64_t* empty = full + G::STAGES;
  int* run_start = reinterpret_cast<int*>(empty + G::STAGES);
  int* run_rows = run_start + E;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid & 31;
  if (tid == 0) {
    for (int s = 0; s < G::STAGES; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, kConsumers / 32);  // each consumer warp releases the slot
    }
    mbar_init_fence();
  }
  run_table(ids, valid, n_blocks, bm, E, run_start, run_rows);

  const int tn = (N + BN - 1) / BN, per_e = (M + kBM - 1) / kBM * tn, n_tiles = E * per_e;
  if (warp >= kConsumers / 32) {
    regs_shrink<kProducerRegs>();
    if (warp == kConsumers / 32 && lane == 0) {
      int it = 0;  // stages issued so far, over all tiles
      for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
        const int e = t / per_e, m0 = t % per_e / tn * kBM, n0 = t % tn * BN;
        const int r0 = run_start[e], n_k = (run_rows[e] + kK - 1) / kK;
        for (int s = 0; s < n_k; ++s, ++it) {
          const int slot = it % G::STAGES;
          mbar_wait(empty + slot, ((it / G::STAGES) & 1) ^ 1);
          unsigned char* st = ring + slot * G::STAGE;
          uint64_t* bar = full + slot;
          const int k0 = r0 + s * kK;
          mbar_expect_tx(bar, G::STAGE);
          tma_load_2d(st, &ma, bar, m0, k0);
          tma_load_2d(st + kBox, &ma, bar, m0 + 64, k0);
#pragma unroll
          for (int c = 0; c < NBOX; ++c) {
            tma_load_2d(st + G::A_BYTES + c * kBox, &mb0, bar, n0 + 64 * c, k0);
            if constexpr (NB == 2)
              tma_load_2d(st + G::A_BYTES + G::B_BYTES + c * kBox, &mb1, bar, n0 + 64 * c, k0);
          }
        }
      }
    }
    return;
  }

  regs_grow<kConsumerRegs>();
  const int w = warp / 4, ct = tid % 128;  // consumer warpgroup: rows m0 + 64 w ..
  const int r_lo = (warp % 4) * 16 + (lane >> 2), c_lo = 2 * (lane & 3);
  unsigned char* out_wg = staging + w * G::OUT_WG;
  float acc[NB][BN / 8][4];
  int it = 0;
  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const int e = t / per_e, m0 = t % per_e / tn * kBM, n0 = t % tn * BN;
    const int rows = run_rows[e], n_k = (rows + kK - 1) / kK;
#pragma unroll
    for (int j = 0; j < NB; ++j) zero_acc(acc[j]);
    for (int s = 0; s < n_k; ++s, ++it) {
      const int slot = it % G::STAGES;
      mbar_wait(full + slot, (it / G::STAGES) & 1);
      unsigned char* st = ring + slot * G::STAGE;
      const int live = rows - s * kK;
      if (live < kK) {  // rows [live, 64) of every box lie past the run
        const int chunks = (kK - live) * 8;  // of 16 bytes, a box
        for (int i = tid; i < G::STAGE / kBox * chunks; i += kConsumers)
          *reinterpret_cast<uint4*>(st + i / chunks * kBox + live * 128 + i % chunks * 16) =
              make_uint4(0u, 0u, 0u, 0u);
        fence_proxy_async();
        named_sync(1, kConsumers);
      }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kK / 16; ++kk) {
        const uint64_t da = desc_mn_sw128(st + w * kBox, kk, kBox);
#pragma unroll
        for (int j = 0; j < NB; ++j)
          wgmma_ss<BN, 1, 1>(acc[j], da,
                             desc_mn_sw128(st + G::A_BYTES + j * G::B_BYTES, kk, kBox), 1);
      }
      wgmma_commit();
      wgmma_wait<1>();  // the previous stage's products are done: release its slot
      if (s > 0 && lane == 0) mbar_arrive(empty + (it - 1) % G::STAGES);
    }
    wgmma_wait<0>();
    if (n_k > 0 && lane == 0) mbar_arrive(empty + (it - 1) % G::STAGES);
#pragma unroll
    for (int j = 0; j < NB; ++j) fence_regs(acc[j]);

    // epilogue: the previous tile's store has read the staging tiles
    if (ct == 0) bulk_wait_read<0>();
    named_sync(2 + w, 128);
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int jj = 0; jj < BN / 8; ++jj) {
        const int col = 8 * jj + c_lo;
        const unsigned char* box = out_wg + (j * NBOX + col / 64) * kBox;
#pragma unroll
        for (int half = 0; half < 2; ++half)
          *reinterpret_cast<uint32_t*>(const_cast<unsigned char*>(
              sw128_at(box, r_lo + 8 * half, (col % 64) * 2))) =
              pack_bf16(acc[j][jj][2 * half], acc[j][jj][2 * half + 1]);
      }
    fence_proxy_async();
    named_sync(2 + w, 128);
    if (ct == 0 && m0 + 64 * w < M) {
#pragma unroll
      for (int j = 0; j < NB; ++j)
#pragma unroll
        for (int c = 0; c < NBOX; ++c)
          if (n0 + 64 * c < N)
            tma_store_3d(j ? &mo1 : &mo0, out_wg + (j * NBOX + c) * kBox, n0 + 64 * c,
                         m0 + 64 * w, e);
      bulk_commit();
    }
  }
  if (ct == 0) bulk_wait<0>();
}

}  // namespace wgw

template <class K>
cudaError_t set_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// The bf16 dX pair at WG warpgroups (BM = 64 WG rows a block) and BN
// columns of H a dX block
template <int WG, int BN>
cudaError_t launch_dx(const void* x, const void* dy, const int* ids, const int* valid,
                      const void* wg, const void* wu, const void* wd, void* dg, void* du,
                      void* h, float* dx, int n_blocks, int bm, int H, int I, int E,
                      cudaStream_t st) {
  using TG = wgx::TermsGeo<WG>;
  using DG = wgx::DxGeo<WG, BN>;
  const uint64_t R = (uint64_t)n_blocks * bm;
  CUtensorMap mx, mdy, mwg, mwu, mwd, mdg, mdu;
  cudaError_t err;
  if ((err = box_map(&mx, x, H, R, 0, TG::BM)) != cudaSuccess ||
      (err = box_map(&mdy, dy, H, R, 0, TG::BM)) != cudaSuccess ||
      (err = box_map(&mwg, wg, I, H, E, 64)) != cudaSuccess ||
      (err = box_map(&mwu, wu, I, H, E, 64)) != cudaSuccess ||
      (err = box_map(&mwd, wd, H, I, E, 64)) != cudaSuccess ||
      (err = box_map(&mdg, dg, I, R, 0, DG::BM)) != cudaSuccess ||
      (err = box_map(&mdu, du, I, R, 0, DG::BM)) != cudaSuccess)
    return err;
  if ((err = set_smem(wgx::gmm_bwd_terms_kernel<WG>, TG::SMEM)) != cudaSuccess ||
      (err = set_smem(wgx::gmm_bwd_dx_kernel<WG, BN>, DG::SMEM)) != cudaSuccess)
    return err;
  const long long tiles = (long long)n_blocks * ((bm + TG::BM - 1) / TG::BM);
  wgx::gmm_bwd_terms_kernel<WG><<<(unsigned)(tiles * (I / 64)), 128 * WG, TG::SMEM, st>>>(
      mx, mdy, mwg, mwu, mwd, ids, valid, static_cast<bf16*>(dg), static_cast<bf16*>(du),
      static_cast<bf16*>(h), bm, H, I, E);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  wgx::gmm_bwd_dx_kernel<WG, BN><<<(unsigned)(tiles * (H / BN)), 128 * WG, DG::SMEM, st>>>(
      mdg, mdu, mwg, mwu, ids, valid, dx, bm, H, I, E);
  return cudaGetLastError();
}

// The bf16 weight gradients at BN columns a tile and NB outputs: the maps,
// then a persistent grid of one block per SM (at most one per tile)
template <int BN, int NB>
cudaError_t launch_dw(const void* a, const void* b0, const void* b1, const int* ids,
                      const int* valid, void* out0, void* out1, int n_blocks, int bm, int M,
                      int N, int E, cudaStream_t st) {
  using G = wgw::Geo<BN, NB>;
  const uint64_t R = (uint64_t)n_blocks * bm;
  CUtensorMap ma, mb0, mb1, mo0, mo1;
  cudaError_t err;
  if ((err = box_map(&ma, a, M, R, 0, 64)) != cudaSuccess ||
      (err = box_map(&mb0, b0, N, R, 0, 64)) != cudaSuccess ||
      (err = box_map(&mb1, NB == 2 ? b1 : b0, N, R, 0, 64)) != cudaSuccess ||
      (err = box_map(&mo0, out0, N, M, E, 64)) != cudaSuccess ||
      (err = box_map(&mo1, NB == 2 ? out1 : out0, N, M, E, 64)) != cudaSuccess ||
      (err = set_smem(wgw::gmm_bwd_dw_wgmma_kernel<BN, NB>, G::SMEM)) != cudaSuccess)
    return err;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  const long long tiles = (long long)E * ((M + wgw::kBM - 1) / wgw::kBM) * ((N + BN - 1) / BN);
  wgw::gmm_bwd_dw_wgmma_kernel<BN, NB>
      <<<(unsigned)(tiles < sms ? tiles : sms), wgw::kThreads, G::SMEM, st>>>(
          ma, mb0, mb1, mo0, mo1, ids, valid, n_blocks, bm, M, N, E);
  return cudaGetLastError();
}

// The (BN, NB) instance's launch shape: out = {rows of a tile, its columns,
// stages of the ring, bytes of shared memory, tiles, grid blocks}
template <int BN, int NB>
cudaError_t dw_layout(int M, int N, int E, int* out) {
  using G = wgw::Geo<BN, NB>;
  int dev = 0, sms = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  const long long tiles = (long long)E * ((M + wgw::kBM - 1) / wgw::kBM) * ((N + BN - 1) / BN);
  out[0] = wgw::kBM;
  out[1] = BN;
  out[2] = G::STAGES;
  out[3] = G::SMEM;
  out[4] = (int)tiles;
  out[5] = (int)(tiles < sms ? tiles : sms);
  return cudaSuccess;
}

// The bf16 instance of (nb outputs, `cols` columns a tile), or null: cols
// is 128 (nb 2) or 256 (nb 1) where it divides N, else 64
// (ops/moe_gmm.py::gmm_bwd_dw_tiles picks it)
using DwLaunch = cudaError_t (*)(const void*, const void*, const void*, const int*, const int*,
                                 void*, void*, int, int, int, int, int, cudaStream_t);
using DwLayout = cudaError_t (*)(int, int, int, int*);

inline bool dw_instance(int nb, int cols, int N, DwLaunch* launch, DwLayout* layout) {
  if (nb == 2 && cols == 128 && N % 128 == 0) {
    *launch = &launch_dw<128, 2>, *layout = &dw_layout<128, 2>;
  } else if (nb == 2 && cols == 64) {
    *launch = &launch_dw<64, 2>, *layout = &dw_layout<64, 2>;
  } else if (nb == 1 && cols == 256 && N % 256 == 0) {
    *launch = &launch_dw<256, 1>, *layout = &dw_layout<256, 1>;
  } else if (nb == 1 && cols == 64) {
    *launch = &launch_dw<64, 1>, *layout = &dw_layout<64, 1>;
  } else {
    return false;
  }
  return true;
}

}  // namespace gmm_bwd
}  // namespace vr2

// x, dy [n_blocks * bm, H] bf16 or fp32 (fp32 != 0); ids / valid [n_blocks]
// int32; wg / wu [E, H, I], wd [E, I, H] of x's type; out: dg, du (and h,
// or nullptr) [n_blocks * bm, I] of x's type, dx [n_blocks * bm, H] fp32. H
// and I multiples of 64 (the wrapper checks). Two launches: the terms, then
// dX. bf16: blocks of `rows` rows (64, or 128 where 128 divides bm) and dX
// tiles `dx_cols` columns of H wide (128, or 64 where 128 does not divide H:
// ops/moe_gmm.py::gmm_bwd_dx_tiles picks both).
extern "C" int vr2_moe_gmm_bwd_dx(const void* x, const void* dy, const int* ids,
                                  const int* valid, const void* wg, const void* wu,
                                  const void* wd, void* dg, void* du, void* h, float* dx,
                                  int n_blocks, int bm, int H, int I, int E, int rows,
                                  int dx_cols, int fp32, void* stream) {
  using namespace vr2::gmm_bwd;
  namespace f32 = vr2::f32;
  if (n_blocks <= 0 || bm <= 0 || H % 64 || I % 64) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (fp32) {
    const long long tiles = (long long)n_blocks * ((bm + f32::kTile - 1) / f32::kTile);
    gmm_bwd_terms_f32_kernel<<<(unsigned)(tiles * (I / f32::kTile)), f32::kThreads, 0, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(dy), ids, valid,
        static_cast<const float*>(wg), static_cast<const float*>(wu),
        static_cast<const float*>(wd), static_cast<float*>(dg), static_cast<float*>(du),
        static_cast<float*>(h), bm, H, I, E);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    gmm_bwd_dx_f32_kernel<<<(unsigned)(tiles * (H / f32::kTile)), f32::kThreads, 0, st>>>(
        static_cast<const float*>(dg), static_cast<const float*>(du), ids, valid,
        static_cast<const float*>(wg), static_cast<const float*>(wu), dx, bm, H, I, E);
    return (int)cudaGetLastError();
  }
  const bool two = rows == 128 && bm % 128 == 0, wide = dx_cols == 128 && H % 128 == 0;
  if ((rows != 64 && !two) || (dx_cols != 64 && !wide)) return (int)cudaErrorInvalidValue;
  const auto launch = two ? (wide ? &launch_dx<2, 128> : &launch_dx<2, 64>)
                          : (wide ? &launch_dx<1, 128> : &launch_dx<1, 64>);
  return (int)launch(x, dy, ids, valid, wg, wu, wd, dg, du, h, dx, n_blocks, bm, H, I, E, st);
}

// a [rows, M] bf16 or fp32 (fp32 != 0); b0 (and b1, or nullptr) [rows, N]
// of a's type; ids / valid [n_blocks] int32, the block table of the sorted
// layout (n_blocks * bm rows; each expert's run of rows counted from it);
// out0 (and out1) [E, M, N] of a's type. M and N multiples of 64 (the
// wrapper checks); bf16: tiles of 128 x `cols` (see dw_instance), E at most
// 1024.
extern "C" int vr2_moe_gmm_bwd_dw(const void* a, const void* b0, const void* b1,
                                  const int* ids, const int* valid, void* out0, void* out1,
                                  int n_blocks, int bm, int M, int N, int E, int cols,
                                  int fp32, void* stream) {
  using namespace vr2::gmm_bwd;
  namespace f32 = vr2::f32;
  if (E <= 0 || n_blocks <= 0 || bm <= 0 || M % 64 || N % 64) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (fp32) {
    const dim3 grid(N / 64, M / 64, E);
    const float *fa = static_cast<const float*>(a), *f0 = static_cast<const float*>(b0);
    float *o0 = static_cast<float*>(out0), *o1 = static_cast<float*>(out1);
    if (b1 != nullptr)
      gmm_bwd_dw_f32_kernel<2><<<grid, f32::kThreads, 0, st>>>(
          fa, f0, static_cast<const float*>(b1), ids, valid, o0, o1, n_blocks, bm, M, N, E);
    else
      gmm_bwd_dw_f32_kernel<1><<<grid, f32::kThreads, 0, st>>>(fa, f0, nullptr, ids, valid, o0,
                                                                nullptr, n_blocks, bm, M, N, E);
    return (int)cudaGetLastError();
  }
  DwLaunch launch;
  DwLayout layout;
  if (E > wgw::kMaxExperts || !dw_instance(b1 != nullptr ? 2 : 1, cols, N, &launch, &layout))
    return (int)cudaErrorInvalidValue;
  return (int)launch(a, b0, b1, ids, valid, out0, out1, n_blocks, bm, M, N, E, st);
}

// The bf16 weight-gradient kernel's launch shape for nb outputs [E, M, N]
// at `cols` columns a tile: out[0..5] as dw_layout. Returns a cudaError_t.
extern "C" int vr2_moe_gmm_bwd_dw_layout(int M, int N, int E, int nb, int cols, int* out) {
  using namespace vr2::gmm_bwd;
  DwLaunch launch;
  DwLayout layout;
  if (E <= 0 || M % 64 || N % 64 || !dw_instance(nb, cols, N, &launch, &layout))
    return (int)cudaErrorInvalidValue;
  return (int)layout(M, N, E, out);
}
