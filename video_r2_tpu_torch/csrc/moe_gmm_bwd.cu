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
// the dW sums are fp32 from bf16 products (mma.sync m16n8k16); dg, du and h
// are rounded to bf16 once, after their fp32 elementwise terms, because the
// products that consume them take bf16 operands. The TPU kernels keep them
// in fp32 and recompute g, u and dh inside each of the three kernels (their
// VMEM could not hold the intermediates); here they are formed once.
//
// Three entry points, four launches:
//   vr2_moe_gmm_bwd_dx (replaces _bwd_dx_kernel):
//     1. terms: one 128-thread block per (64 rows of a row block, 64
//        columns of I); g, u and dh over K = H in one pipeline (x and dY
//        tiles as A, Wg / Wu / Wd tiles as B), then dg, du (and h when dW
//        will be formed) in bf16 [rows, I]. Slack blocks write zeros.
//     2. dX: one block per (64 rows, 64 columns of H), K = I, dg Wg^T +
//        du Wu^T into one fp32 accumulator. Slack blocks write zeros.
//   vr2_moe_gmm_bwd_dw (replaces _bwd_dw_kernel, and _bwd_dwd_kernel with
//     one operand): one block per (expert, 64 rows of the output, 64
//     columns); it walks its expert's run of rows (contiguous in the
//     layout) 32 rows a stage, so each output tile is written once, by one
//     block, with no atomics and no second pass; an expert with no rows
//     writes zeros.
// Every operand stays in its natural row-major layout: a tile that mma.sync
// wants transposed (Wg / Wu in the terms pass; x, dg, du, h, dY in the dW
// pass) is loaded with ldmatrix .trans from shared memory. Tiles come by
// cp.async into a 3-stage ring (dynamic shared memory); four warps split a
// 64 x 64 output tile 2 x 2.
//
// What bounds it: at the judge's shapes (H 2048, I 768, E 128, top 8, ~32k
// routed rows) the operations, 16 R H I for the whole backward (g, u 4,
// dh 2, dX 4, dWg / dWu 4, dWd 2), and the dW outputs, 3 E H I fp32 words
// (2.4 GB), which bound the dW launches by bytes. The grids run the
// innermost output tiles fastest (columns of I in the terms pass, of H in
// dX, both output dims of an expert in dW), so a row tile, and an expert's
// weights or rows, are read from device memory about once and served to
// their other tiles from L2. mma.sync over a cp.async ring is the simple
// first design; wgmma and TMA are later work.
#include "attn_common.cuh"

namespace vr2 {
namespace gmm_bwd {

constexpr int kThreads = 128;  // 4 warps, 2 x 2 over a 64 x 64 output tile
constexpr int kTile = 64;      // output rows and columns of a block
constexpr int kBK = 32;        // k per stage: two m16n8k16 steps
constexpr int kKPitch = 80;    // bytes per row of a K-major tile [64][32 bf16]:
                               // 64 + 16 keeps ldmatrix free of bank conflicts
constexpr int kMPitch = 144;   // bytes per row of an MN-major tile [32][64 bf16]
constexpr int kKBytes = kTile * kKPitch;  // 5120
constexpr int kMBytes = kBK * kMPitch;    // 4608
constexpr int kStages = 3;

using bf16 = __nv_bfloat16;

// 16 bytes from device to shared memory, zero-filled when !valid (gmem must
// still be a mapped address then: callers pass the operand's base)
__device__ __forceinline__ void cp16(void* smem, const void* gmem, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(valid ? 16 : 0));
}

// K-major stage tile: rows [0, 64) of a row-major bf16 matrix g (row r at
// g + r * ld), elements [k0, k0 + 32) of each; rows at or past `rows` zero.
__device__ __forceinline__ void load_k(char* s, const bf16* g, long long ld, int rows, int k0,
                                       int tid) {
#pragma unroll
  for (int i = tid; i < kTile * 4; i += kThreads) {
    const int r = i >> 2, c = i & 3;
    const bool ok = r < rows;
    cp16(s + r * kKPitch + 16 * c, ok ? g + r * ld + k0 + 8 * c : g, ok);
  }
}

// MN-major stage tile: rows [0, 32) (the k of this stage) of a row-major
// bf16 matrix g, 64 elements from g's column 0; rows at or past `rows` zero.
__device__ __forceinline__ void load_mn(char* s, const bf16* g, long long ld, int rows,
                                        int tid) {
#pragma unroll
  for (int i = tid; i < kBK * 8; i += kThreads) {
    const int r = i >> 3, c = i & 7;
    const bool ok = r < rows;
    cp16(s + r * kMPitch + 16 * c, ok ? g + r * ld + 8 * c : g, ok);
  }
}

// The A fragment of rows [m0, m0 + 16) and k-step ks of a stage tile stored
// [m][k] (K-major) or [k][m] (MN-major, transposed by the load). ldmatrix
// matrix j of lane l = 8 j + r: a0 (m lo, k lo), a1 (m hi, k lo), a2 (m lo,
// k hi), a3 (m hi, k hi).
template <bool MN>
__device__ __forceinline__ void frag_a(uint32_t (&a)[4], const char* s, int m0, int ks,
                                       int lane) {
  const int r8 = lane & 7, j = lane >> 3;
  if constexpr (!MN)
    ldsm_x4(a, s + (m0 + r8 + 8 * (j & 1)) * kKPitch + ks * 32 + 16 * (j >> 1));
  else
    ldsm_x4_trans(a, s + (ks * 16 + r8 + 8 * (j >> 1)) * kMPitch + (m0 + 8 * (j & 1)) * 2);
}

// The B fragments of columns [n0, n0 + 16) (two 8-column tiles: b[0], b[1]
// and b[2], b[3]) of a stage tile stored [n][k] (K-major) or [k][n]
// (MN-major). Matrix j: (n lo, k lo), (n lo, k hi), (n hi, k lo), (n hi, k hi).
template <bool MN>
__device__ __forceinline__ void frag_b(uint32_t (&b)[4], const char* s, int n0, int ks,
                                       int lane) {
  const int r8 = lane & 7, j = lane >> 3;
  if constexpr (!MN)
    ldsm_x4(b, s + (n0 + r8 + 8 * (j >> 1)) * kKPitch + ks * 32 + 16 * (j & 1));
  else
    ldsm_x4_trans(b, s + (ks * 16 + r8 + 8 * (j & 1)) * kMPitch + (n0 + 8 * (j >> 1)) * 2);
}

using Acc = float[2][4][4];  // a warp's 32 x 32: 2 row tiles x 4 column tiles

// One stage's products of a warp: its 32 rows (from wm0) by 32 columns
// (from wn0), K = 32.
template <bool AMN, bool BMN>
__device__ __forceinline__ void stage_mma(Acc& acc, const char* As, const char* Bs, int wm0,
                                          int wn0, int lane) {
#pragma unroll
  for (int ks = 0; ks < 2; ++ks) {
    uint32_t a[2][4], b[2][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) frag_a<AMN>(a[mt], As, wm0 + 16 * mt, ks, lane);
#pragma unroll
    for (int np = 0; np < 2; ++np) frag_b<BMN>(b[np], Bs, wn0 + 16 * np, ks, lane);
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

// A block's row tile: (block a, rows [r0, r0 + rows) of it) from a flat index
// whose fastest part is the column tile (n_col of them).
struct RowTile {
  int a, col0, rows;
  long long row0;  // first row in the [n_blocks * bm, .] arrays
  __device__ RowTile(int bm, int n_col) {
    const int zt = (bm + kTile - 1) / kTile;
    const long long flat = blockIdx.x;
    col0 = (int)(flat % n_col) * kTile;
    const long long rest = flat / n_col;
    a = (int)(rest / zt);
    const int r0 = (int)(rest % zt) * kTile;
    rows = min(kTile, bm - r0);
    row0 = (long long)a * bm + r0;
  }
};

constexpr int kTermsStage = 3 * kKBytes + 2 * kMBytes;  // x, dY, Wd; Wg, Wu
constexpr int kDxStage = 4 * kKBytes;                    // dg, du, Wg, Wu

__device__ __forceinline__ float sigmoid(float v) { return 1.0f / (1.0f + expf(-v)); }

// Pass 1 of dX: dg, du (and h when h != nullptr) [rows, I] bf16.
__global__ void __launch_bounds__(kThreads)
    gmm_bwd_terms_kernel(const bf16* __restrict__ x, const bf16* __restrict__ dy,
                         const int* __restrict__ ids, const int* __restrict__ valid,
                         const bf16* __restrict__ wg, const bf16* __restrict__ wu,
                         const bf16* __restrict__ wd, bf16* __restrict__ dg,
                         bf16* __restrict__ du, bf16* __restrict__ h, int bm, int H, int I,
                         int E) {
  extern __shared__ __align__(16) char smem[];
  const RowTile rt(bm, I / kTile);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int wm0 = (warp >> 1) * 32, wn0 = (warp & 1) * 32;
  if (valid[rt.a] == 0) {  // slack block: zeros, nothing read
    for (int i = tid; i < rt.rows * (kTile / 2); i += kThreads) {
      const long long o = (rt.row0 + i / (kTile / 2)) * I + rt.col0 + 2 * (i % (kTile / 2));
      const uint32_t z = pack_bf16(0.0f, 0.0f);
      *reinterpret_cast<uint32_t*>(dg + o) = z;
      *reinterpret_cast<uint32_t*>(du + o) = z;
      if (h) *reinterpret_cast<uint32_t*>(h + o) = z;
    }
    return;
  }
  const int e = min(max(ids[rt.a], 0), E - 1);
  const bf16* xa = x + rt.row0 * H;
  const bf16* dya = dy + rt.row0 * H;
  const bf16* wga = wg + (long long)e * H * I + rt.col0;       // [k = H][n = I]
  const bf16* wua = wu + (long long)e * H * I + rt.col0;
  const bf16* wda = wd + ((long long)e * I + rt.col0) * H;     // [n = I][k = H]

  Acc accg, accu, accd;
  zero(accg);
  zero(accu);
  zero(accd);
  pipeline<kTermsStage>(
      smem, H / kBK,
      [&](int s, char* st) {
        const int k0 = s * kBK;
        load_k(st, xa, H, rt.rows, k0, tid);
        load_k(st + kKBytes, dya, H, rt.rows, k0, tid);
        load_k(st + 2 * kKBytes, wda, H, kTile, k0, tid);
        load_mn(st + 3 * kKBytes, wga + (long long)k0 * I, I, kBK, tid);
        load_mn(st + 3 * kKBytes + kMBytes, wua + (long long)k0 * I, I, kBK, tid);
      },
      [&](const char* st) {
        stage_mma<false, true>(accg, st, st + 3 * kKBytes, wm0, wn0, lane);
        stage_mma<false, true>(accu, st, st + 3 * kKBytes + kMBytes, wm0, wn0, lane);
        stage_mma<false, false>(accd, st + kKBytes, st + 2 * kKBytes, wm0, wn0, lane);
      });

#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = wm0 + mt * 16 + g + 8 * half;
      if (r >= rt.rows) continue;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const long long o = (rt.row0 + r) * I + rt.col0 + wn0 + nt * 8 + 2 * t;
        float vg[2], vu[2], vh[2];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float gv = accg[mt][nt][2 * half + j], uv = accu[mt][nt][2 * half + j];
          const float dh = accd[mt][nt][2 * half + j];
          const float s = sigmoid(gv);
          vg[j] = dh * uv * s * (1.0f + gv * (1.0f - s));
          vu[j] = dh * gv * s;
          vh[j] = gv * s * uv;
        }
        *reinterpret_cast<uint32_t*>(dg + o) = pack_bf16(vg[0], vg[1]);
        *reinterpret_cast<uint32_t*>(du + o) = pack_bf16(vu[0], vu[1]);
        if (h) *reinterpret_cast<uint32_t*>(h + o) = pack_bf16(vh[0], vh[1]);
      }
    }
}

// Pass 2 of dX: dX [rows, H] fp32 = dg Wg^T + du Wu^T.
__global__ void __launch_bounds__(kThreads)
    gmm_bwd_dx_kernel(const bf16* __restrict__ dg, const bf16* __restrict__ du,
                      const int* __restrict__ ids, const int* __restrict__ valid,
                      const bf16* __restrict__ wg, const bf16* __restrict__ wu,
                      float* __restrict__ dx, int bm, int H, int I, int E) {
  extern __shared__ __align__(16) char smem[];
  const RowTile rt(bm, H / kTile);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int wm0 = (warp >> 1) * 32, wn0 = (warp & 1) * 32;
  if (valid[rt.a] == 0) {
    for (int i = tid; i < rt.rows * (kTile / 4); i += kThreads) {
      const long long o = (rt.row0 + i / (kTile / 4)) * H + rt.col0 + 4 * (i % (kTile / 4));
      *reinterpret_cast<float4*>(dx + o) = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
    return;
  }
  const int e = min(max(ids[rt.a], 0), E - 1);
  const bf16* dga = dg + rt.row0 * I;
  const bf16* dua = du + rt.row0 * I;
  const bf16* wga = wg + ((long long)e * H + rt.col0) * I;     // [n = H][k = I]
  const bf16* wua = wu + ((long long)e * H + rt.col0) * I;

  Acc acc;
  zero(acc);
  pipeline<kDxStage>(
      smem, I / kBK,
      [&](int s, char* st) {
        const int k0 = s * kBK;
        load_k(st, dga, I, rt.rows, k0, tid);
        load_k(st + kKBytes, dua, I, rt.rows, k0, tid);
        load_k(st + 2 * kKBytes, wga, I, kTile, k0, tid);
        load_k(st + 3 * kKBytes, wua, I, kTile, k0, tid);
      },
      [&](const char* st) {
        stage_mma<false, false>(acc, st, st + 2 * kKBytes, wm0, wn0, lane);
        stage_mma<false, false>(acc, st + kKBytes, st + 3 * kKBytes, wm0, wn0, lane);
      });

#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = wm0 + mt * 16 + g + 8 * half;
      if (r >= rt.rows) continue;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const long long o = (rt.row0 + r) * H + rt.col0 + wn0 + nt * 8 + 2 * t;
        *reinterpret_cast<float2*>(dx + o) =
            make_float2(acc[mt][nt][2 * half], acc[mt][nt][2 * half + 1]);
      }
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
        load_mn(st, aa + (long long)k0 * M, M, rows, tid);
        load_mn(st + kMBytes, ba0 + (long long)k0 * N, N, rows, tid);
        if constexpr (NB == 2) load_mn(st + 2 * kMBytes, ba1 + (long long)k0 * N, N, rows, tid);
      },
      [&](const char* st) {
        stage_mma<true, true>(acc0, st, st + kMBytes, wm0, wn0, lane);
        if constexpr (NB == 2) stage_mma<true, true>(acc1, st, st + 2 * kMBytes, wm0, wn0, lane);
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

template <class K>
cudaError_t set_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

}  // namespace gmm_bwd
}  // namespace vr2

// x, dy [n_blocks * bm, H] bf16; ids / valid [n_blocks] int32; wg / wu
// [E, H, I], wd [E, I, H] bf16; out: dg, du (and h, or nullptr) [n_blocks *
// bm, I] bf16, dx [n_blocks * bm, H] fp32. H and I multiples of 64 (the
// wrapper checks). Two launches: the terms, then dX.
extern "C" int vr2_moe_gmm_bwd_dx(const void* x, const void* dy, const int* ids,
                                  const int* valid, const void* wg, const void* wu,
                                  const void* wd, void* dg, void* du, void* h, float* dx,
                                  int n_blocks, int bm, int H, int I, int E, void* stream) {
  using namespace vr2::gmm_bwd;
  if (n_blocks <= 0 || bm <= 0 || H % kTile || I % kTile) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long row_tiles = (long long)n_blocks * ((bm + kTile - 1) / kTile);
  constexpr int terms_smem = kStages * kTermsStage, dx_smem = kStages * kDxStage;
  cudaError_t err = set_smem(gmm_bwd_terms_kernel, terms_smem);
  if (err != cudaSuccess) return (int)err;
  gmm_bwd_terms_kernel<<<(unsigned)(row_tiles * (I / kTile)), kThreads, terms_smem, st>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(dy), ids, valid,
      static_cast<const bf16*>(wg), static_cast<const bf16*>(wu), static_cast<const bf16*>(wd),
      static_cast<bf16*>(dg), static_cast<bf16*>(du), static_cast<bf16*>(h), bm, H, I, E);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = set_smem(gmm_bwd_dx_kernel, dx_smem);
  if (err != cudaSuccess) return (int)err;
  gmm_bwd_dx_kernel<<<(unsigned)(row_tiles * (H / kTile)), kThreads, dx_smem, st>>>(
      static_cast<const bf16*>(dg), static_cast<const bf16*>(du), ids, valid,
      static_cast<const bf16*>(wg), static_cast<const bf16*>(wu), dx, bm, H, I, E);
  return (int)cudaGetLastError();
}

// a [rows, M] bf16; b0 (and b1, or nullptr) [rows, N] bf16; start / n_rows
// [E] int32, the run of rows of each expert; out0 (and out1) [E, M, N] fp32.
// M and N multiples of 64 (the wrapper checks).
extern "C" int vr2_moe_gmm_bwd_dw(const void* a, const void* b0, const void* b1,
                                  const int* start, const int* n_rows, float* out0,
                                  float* out1, int M, int N, int E, void* stream) {
  using namespace vr2::gmm_bwd;
  if (E <= 0 || M % kTile || N % kTile) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(N / kTile, M / kTile, E);
  cudaError_t err;
  if (b1 != nullptr) {
    constexpr int smem = kStages * 3 * kMBytes;
    err = set_smem(gmm_bwd_dw_kernel<2>, smem);
    if (err != cudaSuccess) return (int)err;
    gmm_bwd_dw_kernel<2><<<grid, kThreads, smem, st>>>(
        static_cast<const bf16*>(a), static_cast<const bf16*>(b0), static_cast<const bf16*>(b1),
        start, n_rows, out0, out1, M, N);
  } else {
    constexpr int smem = kStages * 2 * kMBytes;
    err = set_smem(gmm_bwd_dw_kernel<1>, smem);
    if (err != cudaSuccess) return (int)err;
    gmm_bwd_dw_kernel<1><<<grid, kThreads, smem, st>>>(
        static_cast<const bf16*>(a), static_cast<const bf16*>(b0), nullptr, start, n_rows,
        out0, nullptr, M, N);
  }
  return (int)cudaGetLastError();
}
