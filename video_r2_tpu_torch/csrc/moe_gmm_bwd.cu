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
//     one operand): one block per (expert, 64 rows of the output, 64
//     columns); it walks its expert's run of rows (contiguous in the
//     layout) 32 rows a stage, so each output tile is written once, by one
//     block, with no atomics and no second pass; an expert with no rows
//     writes zeros. mma.sync m16n8k16 over a 3-stage cp.async ring; the
//     row-major operands, transposed for the product, load by ldmatrix
//     .trans; four warps split a 64 x 64 output tile 2 x 2.
//
// What bounds it: at the judge's shapes (H 2048, I 768, E 128, top 8, ~32k
// routed rows) the operations, 16 R H I for the whole backward (g, u 4,
// dh 2, dX 4, dWg / dWu 4, dWd 2), and the dW outputs, 3 E H I fp32 words
// (2.4 GB), which bound the dW launches by bytes. The grids run the
// innermost output tiles fastest (columns of I in the terms pass, of H in
// dX, both output dims of an expert in dW), so a row tile, and an expert's
// weights or rows, are read from device memory about once and served to
// their other tiles from L2. The dX pair was mma.sync over 16-byte cp.async
// copies on 64 x 64 tiles first (4.0 ms at T = 4096 on an H100): the
// copies, as in the forward, set its rate.
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

// Per expert over fp32: out_j[e] [M, N] = sum over its run of rows of
// a^T b_j (NB = 1 or 2). Grid (N / 64, M / 64, E).
template <int NB>
__global__ void __launch_bounds__(f32::kThreads)
    gmm_bwd_dw_f32_kernel(const float* __restrict__ a, const float* __restrict__ b0,
                          const float* __restrict__ b1, const int* __restrict__ start,
                          const int* __restrict__ n_rows, float* __restrict__ out0,
                          float* __restrict__ out1, int M, int N) {
  __shared__ f32::Smem sm;
  const int n0 = blockIdx.x * f32::kTile, m0 = blockIdx.y * f32::kTile, e = blockIdx.z;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const long long r_begin = start[e];
  const int nr = n_rows[e];
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
// The dW pass over bf16: mma.sync over a cp.async ring
// ---------------------------------------------------------------------------
namespace dw {

constexpr int kThreads = 128;  // 4 warps, 2 x 2 over a 64 x 64 output tile
constexpr int kTile = 64;      // output rows and columns of a block
constexpr int kBK = 32;        // rows (the sum's k) per stage: two m16n8k16 steps
constexpr int kMPitch = 144;   // bytes per row of a stage tile [32][64 bf16]:
                               // 128 + 16 keeps ldmatrix free of bank conflicts
constexpr int kMBytes = kBK * kMPitch;    // 4608
constexpr int kStages = 3;

// Stage tile: rows [0, 32) (the k of this stage) of a row-major bf16 matrix
// g, 64 elements from g's column 0; rows at or past `rows` zero.
__device__ __forceinline__ void load_tile(char* s, const bf16* g, long long ld, int rows,
                                          int tid) {
#pragma unroll
  for (int i = tid; i < kBK * 8; i += kThreads) {
    const int r = i >> 3, c = i & 7;
    const bool ok = r < rows;
    cp_async_zfill<16>(s + r * kMPitch + 16 * c, ok ? g + r * ld + 8 * c : g, ok);
  }
}

// The A fragment of rows [m0, m0 + 16) and k-step ks of a stage tile stored
// [k][m], transposed by the load. ldmatrix matrix j of lane l = 8 j + r: a0
// (m lo, k lo), a1 (m hi, k lo), a2 (m lo, k hi), a3 (m hi, k hi).
__device__ __forceinline__ void frag_a(uint32_t (&a)[4], const char* s, int m0, int ks,
                                       int lane) {
  const int r8 = lane & 7, j = lane >> 3;
  ldsm_x4_trans(a, s + (ks * 16 + r8 + 8 * (j >> 1)) * kMPitch + (m0 + 8 * (j & 1)) * 2);
}

// The B fragments of columns [n0, n0 + 16) (two 8-column tiles: b[0], b[1]
// and b[2], b[3]) of a stage tile stored [k][n]. Matrix j: (n lo, k lo),
// (n lo, k hi), (n hi, k lo), (n hi, k hi).
__device__ __forceinline__ void frag_b(uint32_t (&b)[4], const char* s, int n0, int ks,
                                       int lane) {
  const int r8 = lane & 7, j = lane >> 3;
  ldsm_x4_trans(b, s + (ks * 16 + r8 + 8 * (j & 1)) * kMPitch + (n0 + 8 * (j >> 1)) * 2);
}

using Acc = float[2][4][4];  // a warp's 32 x 32: 2 row tiles x 4 column tiles

// One stage's products of a warp: its 32 rows (from wm0) by 32 columns
// (from wn0), K = 32.
__device__ __forceinline__ void stage_mma(Acc& acc, const char* As, const char* Bs, int wm0,
                                          int wn0, int lane) {
#pragma unroll
  for (int ks = 0; ks < 2; ++ks) {
    uint32_t a[2][4], b[2][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) frag_a(a[mt], As, wm0 + 16 * mt, ks, lane);
#pragma unroll
    for (int np = 0; np < 2; ++np) frag_b(b[np], Bs, wn0 + 16 * np, ks, lane);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        mma_bf16_16816(acc[mt][2 * np], a[mt], b[np][0], b[np][1]);
        mma_bf16_16816(acc[mt][2 * np + 1], a[mt], b[np][2], b[np][3]);
      }
  }
}

__device__ __forceinline__ void zero(Acc& acc) {
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.0f;
}

// The ring: stage s of n_stages into buffer s % kStages; compute(buf) runs on
// a landed stage. The barrier at the top of each step also frees the buffer
// the next load overwrites (computed one step before).
template <int STAGE_BYTES, class Load, class Compute>
__device__ __forceinline__ void pipeline(char* smem, int n_stages, Load load,
                                         Compute compute) {
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_stages) load(s, smem + s * STAGE_BYTES);
    cp_async_commit();
  }
  for (int s = 0; s < n_stages; ++s) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    const int nx = s + kStages - 1;
    if (nx < n_stages) load(nx, smem + (nx % kStages) * STAGE_BYTES);
    cp_async_commit();
    compute(smem + (s % kStages) * STAGE_BYTES);
  }
}

// Per expert e, out_j[e] [M, N] fp32 = sum over its rows [start[e],
// start[e] + n_rows[e]) of a^T b_j, for NB = 1 or 2 operands b_j [rows, N]
// (a [rows, M]). Grid (N / 64, M / 64, E).
template <int NB>
__global__ void __launch_bounds__(kThreads)
    gmm_bwd_dw_kernel(const bf16* __restrict__ a, const bf16* __restrict__ b0,
                      const bf16* __restrict__ b1, const int* __restrict__ start,
                      const int* __restrict__ n_rows, float* __restrict__ out0,
                      float* __restrict__ out1, int M, int N) {
  extern __shared__ __align__(16) char smem[];
  constexpr int kStage = (1 + NB) * kMBytes;
  const int n0 = blockIdx.x * kTile, m0 = blockIdx.y * kTile, e = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int wm0 = (warp >> 1) * 32, wn0 = (warp & 1) * 32;
  const long long r_begin = start[e];
  const int nr = n_rows[e];
  const bf16* aa = a + r_begin * M + m0;
  const bf16* ba0 = b0 + r_begin * N + n0;
  const bf16* ba1 = NB == 2 ? b1 + r_begin * N + n0 : nullptr;

  Acc acc0, acc1;
  zero(acc0);
  zero(acc1);
  pipeline<kStage>(
      smem, (nr + kBK - 1) / kBK,
      [&](int s, char* st) {
        const int k0 = s * kBK, rows = nr - k0;
        load_tile(st, aa + (long long)k0 * M, M, rows, tid);
        load_tile(st + kMBytes, ba0 + (long long)k0 * N, N, rows, tid);
        if constexpr (NB == 2) load_tile(st + 2 * kMBytes, ba1 + (long long)k0 * N, N, rows, tid);
      },
      [&](const char* st) {
        stage_mma(acc0, st, st + kMBytes, wm0, wn0, lane);
        if constexpr (NB == 2) stage_mma(acc1, st, st + 2 * kMBytes, wm0, wn0, lane);
      });

  const long long base = (long long)e * M * N;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = m0 + wm0 + mt * 16 + g + 8 * half;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const long long o = base + (long long)r * N + n0 + wn0 + nt * 8 + 2 * t;
        *reinterpret_cast<float2*>(out0 + o) =
            make_float2(acc0[mt][nt][2 * half], acc0[mt][nt][2 * half + 1]);
        if constexpr (NB == 2)
          *reinterpret_cast<float2*>(out1 + o) =
              make_float2(acc1[mt][nt][2 * half], acc1[mt][nt][2 * half + 1]);
      }
    }
}

}  // namespace dw

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
// of a's type; start / n_rows [E] int32, the run of rows of each expert;
// out0 (and out1) [E, M, N] fp32. M and N multiples of 64 (the wrapper
// checks).
extern "C" int vr2_moe_gmm_bwd_dw(const void* a, const void* b0, const void* b1,
                                  const int* start, const int* n_rows, float* out0,
                                  float* out1, int M, int N, int E, int fp32, void* stream) {
  using namespace vr2::gmm_bwd;
  namespace f32 = vr2::f32;
  if (E <= 0 || M % 64 || N % 64) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(N / 64, M / 64, E);
  if (fp32) {
    const float *fa = static_cast<const float*>(a), *f0 = static_cast<const float*>(b0);
    if (b1 != nullptr)
      gmm_bwd_dw_f32_kernel<2><<<grid, f32::kThreads, 0, st>>>(
          fa, f0, static_cast<const float*>(b1), start, n_rows, out0, out1, M, N);
    else
      gmm_bwd_dw_f32_kernel<1><<<grid, f32::kThreads, 0, st>>>(fa, f0, nullptr, start, n_rows,
                                                                out0, nullptr, M, N);
    return (int)cudaGetLastError();
  }
  cudaError_t err;
  if (b1 != nullptr) {
    constexpr int smem = dw::kStages * 3 * dw::kMBytes;
    err = set_smem(dw::gmm_bwd_dw_kernel<2>, smem);
    if (err != cudaSuccess) return (int)err;
    dw::gmm_bwd_dw_kernel<2><<<grid, dw::kThreads, smem, st>>>(
        static_cast<const bf16*>(a), static_cast<const bf16*>(b0), static_cast<const bf16*>(b1),
        start, n_rows, out0, out1, M, N);
  } else {
    constexpr int smem = dw::kStages * 2 * dw::kMBytes;
    err = set_smem(dw::gmm_bwd_dw_kernel<1>, smem);
    if (err != cudaSuccess) return (int)err;
    dw::gmm_bwd_dw_kernel<1><<<grid, dw::kThreads, smem, st>>>(
        static_cast<const bf16*>(a), static_cast<const bf16*>(b0), nullptr, start, n_rows,
        out0, nullptr, M, N);
  }
  return (int)cudaGetLastError();
}
