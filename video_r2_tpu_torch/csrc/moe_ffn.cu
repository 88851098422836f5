// Grouped SwiGLU expert FFN over row blocks: the port of
// video_r2_tpu/ops/moe_ragged.py::_ffn_kernel (bf16), _ffn_kernel_q (int8
// weights, bf16 activations) and _ffn_kernel_qq (W8A8), the kernel behind
// both MoE fast paths: ragged decode (a block is one active-expert slot) and
// the sorted-GMM prefill layout (a block is one expert-homogeneous run of
// rows).
//
// For every block a with valid[a] != 0 and e = ids[a]:
//   g = x[a] @ Wg[e], u = x[a] @ Wu[e]                 (fp32 / int32 sums)
//   h = silu(g) * u                                     [C, I]
//   y[a] = h @ Wd[e]                                    [C, H]
// with the reference's rounding points:
//   mode 0 (bf16):     h rounded to bf16, y = fp32 sum over I rounded to bf16;
//   mode 1 (int8 w):   int8 weights converted exactly to bf16; the fp32 dot
//                      outputs times the per-output-channel scales sg / su,
//                      h rounded to bf16, y times sd, rounded to bf16;
//   mode 2 (W8A8):     int8 x with row scales ax; int32 dots; g, u = dot * ax *
//                      sg (su); h re-quantised to int8 per row over each
//                      bi-wide tile of I (its scale max(|h|, 1e-6) / 127, round
//                      half to even, clip to +-127: the reference's tile width
//                      is part of the result); y = sum over tiles of the int32
//                      dot * ah * sd, fp32 out.
// Blocks with valid[a] == 0 (the GMM layout's slack tail, the ragged table's
// pad slots) write zeros and read nothing: uninitialised memory could hold
// NaN bits that 0-weight combines would spread.
//
// Bound: at decode (C = 8..32 rows per block) the weights dominate, every
// routed expert's 3 H x I matrices are read once: bytes. At prefill (C = 128
// row blocks over ~T * top_k routed rows) 6 H I flops per row: operations.
// Design, simple first: three launches (two for modes 0 and 1).
//   1. gate/up: one block per (a, 64 columns of I, BM rows); 4 warps side
//      by side over the columns (16 each, both g and u), and for blocks of
//      more than 64 rows a second row of 4 warps (BM = 128, 256 threads,
//      so a weight tile serves twice the rows); each warp holds 16, 32 or
//      64 rows (the block's capacity C picks the smallest). K = H streams
//      through a register-staged, double-buffered shared tile of 64 bytes
//      of K per stage. Weight tiles are transposed into shared memory on
//      the way ([column][k], k contiguous), so one fragment layout, loaded
//      by ldmatrix, serves the bf16 mma.m16n8k16 and the s8 mma.m16n8k32
//      (32 bytes of K each); int8 weights of mode 1 are converted to bf16
//      there (exact). The grid runs a fastest, so the blocks of one expert
//      (GMM runs) read its weight tiles together and the repeats come from
//      L2.
//   2. (mode 2 only) quantise h per (row, bi tile): one warp each.
//   3. down: one block per (a, 64 columns of H, BM rows), K = I, the same
//      tile machinery; mode 2 folds each bi tile's int32 sum into fp32 with
//      its row scale at the tile's end.
// h lives in a [A, C, I] scratch the wrapper allocates (bf16, or fp32 plus
// int8 and scales for mode 2).
#include <type_traits>

#include "attn_common.cuh"

namespace vr2 {
namespace moe {

constexpr int kBN = 64;        // output columns per block, 16 per warp
constexpr int kWarpsN = 4;     // warps side by side over the columns
constexpr int kStage = 64;     // bytes of K per pipeline stage: two mma k-steps
constexpr int kPitch = 80;     // shared row pitch in bytes: 64 + 16 keeps the
                               // ldmatrix row reads free of bank conflicts
constexpr int kLoaders = 128;  // threads that stage one weight matrix

enum Mode { kBf16 = 0, kInt8W = 1, kW8A8 = 2 };

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  mma_bf16_16816(d, a, b0, b1);
}

__device__ __forceinline__ void mma(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float silu(float v) { return v / (1.0f + expf(-v)); }

// Rows [0, BM) of a row-major byte matrix (row r at base + r * row_bytes),
// bytes [k0, k0 + 64) of each: 16-byte vectors staged in registers by
// THREADS threads, then stored to a [BM][kPitch] shared tile. Rows at or
// past `rows` are zero.
template <int BM, int THREADS>
struct RowTile {
  static constexpr int kVec = (BM * 4 + THREADS - 1) / THREADS;
  uint4 v[kVec];

  __device__ __forceinline__ void load(const char* base, long long row_bytes, int rows,
                                       long long k0, int tid) {
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      const int idx = tid + i * THREADS, r = idx >> 2;
      v[i] = make_uint4(0u, 0u, 0u, 0u);
      if (idx < BM * 4 && r < rows)
        v[i] = *reinterpret_cast<const uint4*>(base + r * row_bytes + k0 + 16 * (idx & 3));
    }
  }

  __device__ __forceinline__ void store(char* smem, int tid) const {
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      const int idx = tid + i * THREADS;
      if (idx < BM * 4)
        *reinterpret_cast<uint4*>(smem + (idx >> 2) * kPitch + 16 * (idx & 3)) = v[i];
    }
  }
};

// One stage of a weight matrix W [K, N] (N contiguous, row_bytes apart), 64
// columns from n0, staged by 128 threads: the K rows whose 64 shared bytes
// this stage holds, stored transposed as [column][k], so a B fragment (4
// bytes of consecutive k of one column) is a 32-bit word of a shared row.
// Loader thread lt owns the shared word column kw = lt % 16 (2 bf16 or 4
// int8 of k) of the 8 columns 8 * (lt / 16) + j.
template <int MODE>
struct WeightTile {
  static constexpr int kRows = MODE == kW8A8 ? 4 : 2;      // k per shared word
  static constexpr int kWords = MODE == kBf16 ? 4 : 2;     // 32-bit words per row read
  static constexpr int kElem = MODE == kBf16 ? 2 : 1;      // bytes per weight
  uint32_t w[kRows][kWords];

  __device__ __forceinline__ void load(const char* W, long long row_bytes, int k0, int n0,
                                       int lt) {
    const int kw = lt & 15, ng = lt >> 4;
    const char* p = W + (long long)(k0 + kw * kRows) * row_bytes + (n0 + ng * 8) * kElem;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if constexpr (kWords == 4) {
        const uint4 v = *reinterpret_cast<const uint4*>(p + r * row_bytes);
        w[r][0] = v.x, w[r][1] = v.y, w[r][2] = v.z, w[r][3] = v.w;
      } else {
        const uint2 v = *reinterpret_cast<const uint2*>(p + r * row_bytes);
        w[r][0] = v.x, w[r][1] = v.y;
      }
    }
  }

  __device__ __forceinline__ uint32_t word(int j) const {
    if constexpr (MODE == kBf16) {   // bf16 j of rows k and k + 1
      return __byte_perm(w[0][j >> 1], w[1][j >> 1], (j & 1) ? 0x7632 : 0x5410);
    } else if constexpr (MODE == kInt8W) {  // int8 -> bf16, exact
      const int sh = 8 * (j & 3);
      const float lo = (float)(int8_t)((w[0][j >> 2] >> sh) & 0xff);
      const float hi = (float)(int8_t)((w[1][j >> 2] >> sh) & 0xff);
      return pack_bf16(lo, hi);
    } else {               // int8 j of rows k .. k + 3
      const int sh = 8 * (j & 3);
      uint32_t out = 0;
#pragma unroll
      for (int r = 0; r < 4; ++r) out |= ((w[r][j >> 2] >> sh) & 0xffu) << (8 * r);
      return out;
    }
  }

  __device__ __forceinline__ void store(char* smem, int lt) const {
    const int kw = lt & 15, ng = lt >> 4;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      *reinterpret_cast<uint32_t*>(smem + (ng * 8 + j) * kPitch + kw * 4) = word(j);
  }
};

template <int MODE>
using Acc = typename std::conditional<MODE == kW8A8, int, float>::type;

// One stage (two 32-byte k-steps) of a warp's products: its 16 columns (two
// 8-column tiles, from shared row wn0) over its MT 16-row tiles (from
// shared row wm0). ldmatrix tile order: A rows 0-7 / 8-15 x bytes 0-15 /
// 16-31 give a0..a3; B columns 0-7 x bytes 0-15 / 16-31, then columns 8-15,
// give (b0, b1) of the two column tiles.
template <int MODE, int MT>
__device__ __forceinline__ void stage_mma(Acc<MODE> (&acc)[MT][2][4], const char* As,
                                          const char* Bs, int wm0, int wn0, int lane) {
  const int r8 = lane & 7, hi = lane >> 4, mid = (lane >> 3) & 1;
#pragma unroll
  for (int ks = 0; ks < 2; ++ks) {
    uint32_t b[4];
    ldsm_x4(b, Bs + (wn0 + r8 + 8 * hi) * kPitch + ks * 32 + 16 * mid);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      uint32_t a[4];
      ldsm_x4(a, As + (wm0 + mt * 16 + r8 + 8 * mid) * kPitch + ks * 32 + 16 * hi);
      mma(acc[mt][0], a, b[0], b[1]);
      mma(acc[mt][1], a, b[2], b[3]);
    }
  }
}

template <int MODE, int MT>
__device__ __forceinline__ void zero(Acc<MODE> (&acc)[MT][2][4]) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0;
}

// Phase 1: h = silu(x @ Wg) * (x @ Wu) for one (block, 64 columns of I,
// 16 * MT * WM rows); WM rows of 4 warps, 128 * WM threads. With WM == 2
// the first 128 threads stage Wg and the others Wu.
template <int MODE, int MT, int WM>
__global__ void __launch_bounds__(128 * WM)
    moe_gate_up_kernel(const char* __restrict__ x, const float* __restrict__ x_scales,
                       const int* __restrict__ ids, const int* __restrict__ valid,
                       const char* __restrict__ wg, const float* __restrict__ sg,
                       const char* __restrict__ wu, const float* __restrict__ su,
                       void* __restrict__ h, int C, int H, int I, int E) {
  constexpr int kThr = 128 * WM, BM = 16 * MT * WM;
  constexpr int kXElem = MODE == kW8A8 ? 1 : 2;
  constexpr int kKStage = kStage / kXElem;   // k per stage
  __shared__ __align__(16) char As[2][BM * kPitch];
  __shared__ __align__(16) char Bg[2][kBN * kPitch];
  __shared__ __align__(16) char Bu[2][kBN * kPitch];

  const int a = blockIdx.x, n0 = blockIdx.y * kBN, row0 = blockIdx.z * BM;
  if (valid[a] == 0 || row0 >= C) return;
  const int e = min(max(ids[a], 0), E - 1);
  const int rows = min(BM, C - row0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int wm0 = (warp / kWarpsN) * 16 * MT, wn0 = (warp % kWarpsN) * 16;

  const long long x_row = (long long)H * kXElem;
  const char* xa = x + ((long long)a * C + row0) * x_row;
  const long long w_row = (long long)I * WeightTile<MODE>::kElem;
  const char* wga = wg + (long long)e * H * w_row;
  const char* wua = wu + (long long)e * H * w_row;
  // WM == 2: the first 128 threads stage Wg, the others Wu (as b0)
  const int lt = tid & (kLoaders - 1);
  const bool second = WM == 2 && tid >= kLoaders;
  const char* w_first = second ? wua : wga;

  Acc<MODE> accg[MT][2][4], accu[MT][2][4];
  zero<MODE, MT>(accg);
  zero<MODE, MT>(accu);

  RowTile<BM, kThr> at;
  WeightTile<MODE> b0, b1;
  const int n_stages = H / kKStage;
  at.load(xa, x_row, rows, 0, tid);
  b0.load(w_first, w_row, 0, n0, lt);
  if (WM == 1) b1.load(wua, w_row, 0, n0, lt);
  at.store(As[0], tid);
  b0.store(second ? Bu[0] : Bg[0], lt);
  if (WM == 1) b1.store(Bu[0], lt);
  __syncthreads();
  for (int s = 0; s < n_stages; ++s) {
    const int buf = s & 1;
    const bool more = s + 1 < n_stages;
    if (more) {
      at.load(xa, x_row, rows, (long long)(s + 1) * kStage, tid);
      b0.load(w_first, w_row, (s + 1) * kKStage, n0, lt);
      if (WM == 1) b1.load(wua, w_row, (s + 1) * kKStage, n0, lt);
    }
    stage_mma<MODE, MT>(accg, As[buf], Bg[buf], wm0, wn0, lane);
    stage_mma<MODE, MT>(accu, As[buf], Bu[buf], wm0, wn0, lane);
    if (more) {
      at.store(As[buf ^ 1], tid);
      b0.store(second ? Bu[buf ^ 1] : Bg[buf ^ 1], lt);
      if (WM == 1) b1.store(Bu[buf ^ 1], lt);
    }
    __syncthreads();
  }

#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = wm0 + mt * 16 + g + 8 * half;
      if (r >= rows) continue;
      const long long row = (long long)a * C + row0 + r;
      const float ax = MODE == kW8A8 ? x_scales[row] : 1.0f;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const int c = n0 + wn0 + nt * 8 + 2 * t;
        float hv[2];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          float gv = (float)accg[mt][nt][2 * half + j];
          float uv = (float)accu[mt][nt][2 * half + j];
          if (MODE == kW8A8) {
            gv = gv * ax * sg[(long long)e * I + c + j];
            uv = uv * ax * su[(long long)e * I + c + j];
          } else if (MODE == kInt8W) {
            gv = gv * sg[(long long)e * I + c + j];
            uv = uv * su[(long long)e * I + c + j];
          }
          hv[j] = silu(gv) * uv;
        }
        if (MODE == kW8A8) {
          *reinterpret_cast<float2*>(reinterpret_cast<float*>(h) + row * I + c) =
              make_float2(hv[0], hv[1]);
        } else {
          *reinterpret_cast<uint32_t*>(reinterpret_cast<__nv_bfloat16*>(h) + row * I + c) =
              pack_bf16(hv[0], hv[1]);
        }
      }
    }
}

// Mode 2: h [A*C, I] fp32 -> int8 hq and one scale per (row, bi tile); one
// warp per (row, tile).
__global__ void __launch_bounds__(128)
    moe_quantize_h_kernel(const float* __restrict__ h, const int* __restrict__ valid,
                          int8_t* __restrict__ hq, float* __restrict__ ah, int A, int C,
                          int I, int bi) {
  const int n_i = I / bi;
  const long long unit = (long long)blockIdx.x * (128 / kWarp) + (threadIdx.x >> 5);
  if (unit >= (long long)A * C * n_i) return;
  const long long row = unit / n_i;
  const int tile = (int)(unit % n_i), lane = threadIdx.x & 31;
  if (valid[row / C] == 0) return;
  const float* src = h + row * I + (long long)tile * bi;
  int8_t* dst = hq + row * I + (long long)tile * bi;
  float m = 0.0f;
  for (int j = lane; j < bi; j += kWarp) m = fmaxf(m, fabsf(src[j]));
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  const float s = fmaxf(m, 1e-6f) / 127.0f;
  for (int j = lane; j < bi; j += kWarp)
    dst[j] = (int8_t)fminf(fmaxf(rintf(src[j] / s), -127.0f), 127.0f);
  if (lane == 0) ah[unit] = s;
}

// Phase 2: y = h @ Wd for one (block, 64 columns of H, 16 * MT * WM rows);
// the first 128 threads stage Wd.
template <int MODE, int MT, int WM>
__global__ void __launch_bounds__(128 * WM)
    moe_down_kernel(const char* __restrict__ hs, const float* __restrict__ ah,
                    const int* __restrict__ ids, const int* __restrict__ valid,
                    const char* __restrict__ wd, const float* __restrict__ sd,
                    void* __restrict__ out, int C, int H, int I, int E, int bi) {
  constexpr int kThr = 128 * WM, BM = 16 * MT * WM;
  constexpr int kXElem = MODE == kW8A8 ? 1 : 2;
  constexpr int kKStage = kStage / kXElem;
  __shared__ __align__(16) char As[2][BM * kPitch];
  __shared__ __align__(16) char Bs[2][kBN * kPitch];

  const int a = blockIdx.x, n0 = blockIdx.y * kBN, row0 = blockIdx.z * BM;
  if (row0 >= C) return;
  const int rows = min(BM, C - row0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int wm0 = (warp / kWarpsN) * 16 * MT, wn0 = (warp % kWarpsN) * 16;
  const long long out_row0 = (long long)a * C + row0;

  if (valid[a] == 0) {   // slack block: zeros, nothing read
    for (int i = tid; i < rows * kBN; i += kThr) {
      const long long o = (out_row0 + i / kBN) * H + n0 + i % kBN;
      if (MODE == kW8A8) reinterpret_cast<float*>(out)[o] = 0.0f;
      else reinterpret_cast<__nv_bfloat16*>(out)[o] = __float2bfloat16(0.0f);
    }
    return;
  }
  const int e = min(max(ids[a], 0), E - 1);
  const long long h_row = (long long)I * kXElem;
  const char* ha = hs + out_row0 * h_row;
  const long long w_row = (long long)H * WeightTile<MODE>::kElem;
  const char* wda = wd + (long long)e * I * w_row;

  Acc<MODE> acc[MT][2][4];
  float facc[MT][2][4];
  zero<MODE, MT>(acc);
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) facc[mt][nt][i] = 0.0f;
  float sdc[2][2];
#pragma unroll
  for (int nt = 0; nt < 2; ++nt)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      sdc[nt][j] = MODE == kBf16 ? 1.0f : sd[(long long)e * H + n0 + wn0 + nt * 8 + 2 * t + j];

  RowTile<BM, kThr> at;
  WeightTile<MODE> bw;
  const bool loader = tid < kLoaders;
  const int n_stages = I / kKStage, tile_stages = bi / kKStage, n_i = I / bi;
  at.load(ha, h_row, rows, 0, tid);
  if (loader) bw.load(wda, w_row, 0, n0, tid);
  at.store(As[0], tid);
  if (loader) bw.store(Bs[0], tid);
  __syncthreads();
  for (int s = 0; s < n_stages; ++s) {
    const int buf = s & 1;
    const bool more = s + 1 < n_stages;
    if (more) {
      at.load(ha, h_row, rows, (long long)(s + 1) * kStage, tid);
      if (loader) bw.load(wda, w_row, (s + 1) * kKStage, n0, tid);
    }
    stage_mma<MODE, MT>(acc, As[buf], Bs[buf], wm0, wn0, lane);
    if (MODE == kW8A8 && (s + 1) % tile_stages == 0) {
      const int tile = s / tile_stages;   // fold this bi tile's int32 sums
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = wm0 + mt * 16 + g + 8 * half;
          const float ahr = r < rows ? ah[(out_row0 + r) * n_i + tile] : 0.0f;
#pragma unroll
          for (int nt = 0; nt < 2; ++nt)
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              facc[mt][nt][2 * half + j] +=
                  (float)acc[mt][nt][2 * half + j] * ahr * sdc[nt][j];
              acc[mt][nt][2 * half + j] = 0;
            }
        }
    }
    if (more) {
      at.store(As[buf ^ 1], tid);
      if (loader) bw.store(Bs[buf ^ 1], tid);
    }
    __syncthreads();
  }

#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = wm0 + mt * 16 + g + 8 * half;
      if (r >= rows) continue;
      const long long row = out_row0 + r;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const int c = n0 + wn0 + nt * 8 + 2 * t;
        if (MODE == kW8A8) {
          *reinterpret_cast<float2*>(reinterpret_cast<float*>(out) + row * H + c) =
              make_float2(facc[mt][nt][2 * half], facc[mt][nt][2 * half + 1]);
        } else {
          const float y0 = (float)acc[mt][nt][2 * half] * sdc[nt][0];
          const float y1 = (float)acc[mt][nt][2 * half + 1] * sdc[nt][1];
          *reinterpret_cast<uint32_t*>(reinterpret_cast<__nv_bfloat16*>(out) + row * H + c) =
              pack_bf16(y0, y1);
        }
      }
    }
}

struct Args {
  const void* x;
  const float* x_scales;
  const int* ids;
  const int* valid;
  const void* wg;
  const float* sg;
  const void* wu;
  const float* su;
  const void* wd;
  const float* sd;
  void* h;
  int8_t* hq;
  float* ah;
  void* out;
  int A, C, H, I, E, bi;
};

template <int MODE, int MT, int WM>
cudaError_t launch(const Args& p, cudaStream_t stream) {
  constexpr int BM = 16 * MT * WM;
  const int zt = (p.C + BM - 1) / BM;
  moe_gate_up_kernel<MODE, MT, WM><<<dim3(p.A, p.I / kBN, zt), 128 * WM, 0, stream>>>(
      static_cast<const char*>(p.x), p.x_scales, p.ids, p.valid,
      static_cast<const char*>(p.wg), p.sg, static_cast<const char*>(p.wu), p.su, p.h, p.C,
      p.H, p.I, p.E);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const void* hs = p.h;
  if (MODE == kW8A8) {
    const long long units = (long long)p.A * p.C * (p.I / p.bi);
    const int per = 128 / kWarp;
    moe_quantize_h_kernel<<<(unsigned)((units + per - 1) / per), 128, 0, stream>>>(
        static_cast<const float*>(p.h), p.valid, p.hq, p.ah, p.A, p.C, p.I, p.bi);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    hs = p.hq;
  }
  moe_down_kernel<MODE, MT, WM><<<dim3(p.A, p.H / kBN, zt), 128 * WM, 0, stream>>>(
      static_cast<const char*>(hs), p.ah, p.ids, p.valid, static_cast<const char*>(p.wd),
      p.sd, p.out, p.C, p.H, p.I, p.E, p.bi);
  return cudaGetLastError();
}

// The smallest row capacity that holds a block's C rows: 16, 32 or 64 rows
// in one row of 4 warps, 128 rows in two.
template <int MODE>
cudaError_t launch_mode(const Args& p, cudaStream_t stream) {
  if (p.C <= 16) return launch<MODE, 1, 1>(p, stream);
  if (p.C <= 32) return launch<MODE, 2, 1>(p, stream);
  if (p.C <= 64) return launch<MODE, 4, 1>(p, stream);
  return launch<MODE, 4, 2>(p, stream);
}

}  // namespace moe
}  // namespace vr2

// x [A, C, H] (bf16, or int8 with x_scales [A, C] fp32 in mode 2); ids /
// valid [A] int32; wg / wu [E, H, I], wd [E, I, H] (bf16 in mode 0, int8
// otherwise) with fp32 scales sg / su [E, I], sd [E, H] (modes 1 and 2);
// h [A, C, I] scratch (bf16, fp32 in mode 2); hq [A, C, I] int8 and ah
// [A, C, I / bi] (mode 2); out [A, C, H] (bf16, fp32 in mode 2). The wrapper
// checks H % 64 == 0, I % 64 == 0 and, in mode 2, bi % 64 == 0 and I % bi == 0.
extern "C" int vr2_moe_ffn(const void* x, const float* x_scales, const int* ids,
                           const int* valid, const void* wg, const float* sg, const void* wu,
                           const float* su, const void* wd, const float* sd, void* h,
                           int8_t* hq, float* ah, void* out, int A, int C, int H, int I,
                           int E, int bi, int mode, void* stream) {
  using namespace vr2::moe;
  const Args p{x, x_scales, ids, valid, wg, sg, wu, su, wd, sd, h, hq, ah, out,
               A, C, H, I, E, bi};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case kBf16: return launch_mode<kBf16>(p, s);
    case kInt8W: return launch_mode<kInt8W>(p, s);
    case kW8A8: return launch_mode<kW8A8>(p, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
