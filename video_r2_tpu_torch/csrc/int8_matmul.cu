// Int8 weight-only matmul for Hopper (sm_90a): y = (x @ wq) * scale.
//
// Replaces the three TPU kernels of the int8 dequant matmul, one device
// kernel behind three entry points:
// - video_r2_tpu/ops/int8_matmul.py::_kernel (:23, via int8_matmul):
//   x [M, K] @ wq [K, N] -> vr2_int8_matmul;
// - video_r2_tpu/ops/int8_matmul.py::_stacked_kernel (:81, via
//   int8_matmul_stacked): layer l of a stacked wq [L, K, N], scale [L, N],
//   l a scalar prefetch there -> vr2_int8_matmul_stacked, which offsets wq
//   and scale by the layer inside the kernel (no slice copy of wq[l]);
// - scripts/microbench_int8.py::_kernel_all (:32, via all_layers_matmul):
//   every layer in one launch, out [L, M, N] -> vr2_int8_matmul_all_layers,
//   the layer on the grid's z.
// Same semantics: x bf16; each int8 weight converted to bf16 (exact: |q| <=
// 128 needs 8 significant bits), the products summed in fp32 (mma.sync
// m16n8k16), the sum times the fp32 per-output-channel scale once, and y
// rounded to bf16 once.
//
// What bounds it on the card: at decode (M = 1 to 16 rows) each weight byte
// serves M products, far below the ~295 operations a byte the card needs to
// be compute-bound, so the int8 weights (K N bytes, read once) bound it; at
// a thousand rows the products do.
// What the design does about it: one 128-thread block per (16 / 32 / 64
// rows: the smallest row capacity that holds M, 64 output columns); the
// weights stream through a ring of shared-memory stages filled by cp.async
// (8 stages of 64 rows of K for up to 16 rows of x, so a block keeps ~28 KB
// of weights in flight), each stage 4 KB of int8 weights [64 k][64 n] as they
// lie in memory and the matching [rows][64 k] of x. The mma wants its B
// operand with K contiguous; the tile is row-major in n, so each warp takes
// its 16 columns of 32 k rows with one ldmatrix .trans of 16-bit pairs: a
// lane gets W[2t][2g], W[2t][2g+1], W[2t+1][2g], W[2t+1][2g+1], which are
// the B fragments of two n-tiles, the even columns and the odd ones. Bytes
// become bf16 without a conversion instruction: byte ^ 0x80 placed in the
// mantissa of 2^23 gives the float 2^23 + q + 128 (one byte permute), minus
// 2^23 + 128 gives q exactly, and its upper 16 bits are bf16(q) (a second
// permute packs two). Row blocks run fastest on the grid, so the row blocks
// of one column block share its weights through L2 when M > 64. At small N
// (the k / v projections: 8 blocks on 132 SMs) the card is mostly idle:
// split-K is later work, as are TMA and wgmma.
// Any K and N: K and N multiples of 64 (every decoder width, the head, the
// ViT's qkv and proj, the merger) take unpredicated 16-byte copies; any
// other width (the ViT's gate / up and down at 3420, K 300 / N 500) loads
// byte by byte (weights) and value by value (x), zero past K and N. The K
// tail's x columns and weight rows are zero in shared memory, so they add
// nothing; columns past N are not stored.
#include "attn_common.cuh"

namespace {

constexpr int kThreads = 128;  // 4 warps side by side over the columns
constexpr int kBN = 64;        // output columns per block, 16 per warp
constexpr int kKS = 64;        // rows of K per stage
constexpr int kWPitch = 80;    // shared row pitch (bytes) of the staged weights:
                               // 64 + 16 keeps ldmatrix's 8 rows on distinct banks
constexpr int kXPitch = 144;   // shared row pitch (bytes) of the staged x: 128 + 16

// How a stage is copied: every width a multiple of 64 (no tail), or
// anything else (element loads)
enum Path { kWhole = 0, kAny1 = 1 };

template <int MT>
struct Ring {
  static constexpr int BM = 16 * MT;
  static constexpr int W_BYTES = kKS * kWPitch;
  static constexpr int X_BYTES = BM * kXPitch;
  static constexpr int BYTES = W_BYTES + X_BYTES;
  static constexpr int STAGES = MT == 1 ? 8 : MT == 2 ? 6 : 4;
  static constexpr int SMEM = STAGES * BYTES;
};

struct Int8Params {
  const __nv_bfloat16* x;  // [M, K]
  const int8_t* wq;        // [L, K, N]
  const float* scale;      // [L, N]
  __nv_bfloat16* y;        // [gridDim.z, M, N]
  int M, K, N;
  int layer0;              // the layer of grid z = 0
};

using vr2::int8_pairs;
using vr2::ldsm_x4_trans;

// Start the copies of stage s (rows [64 s, 64 s + 64) of K) of the block's
// 64 columns from n0 and its rows [row0, row0 + rows) of x into `st`; rows
// of x at or past `rows` are left as they are (their outputs are not
// stored).
template <int MT, int PATH>
__device__ __forceinline__ void load_stage(unsigned char* st, const Int8Params& p,
                                           const int8_t* w, int s, int n0, int row0,
                                           int rows, int tid) {
  using R = Ring<MT>;
  const int k0 = s * kKS;
  unsigned char* xs = st + R::W_BYTES;
  if constexpr (PATH == kWhole) {
#pragma unroll
    for (int i = tid; i < kKS * 4; i += kThreads) {  // 64 rows x 4 chunks of 16 bytes
      const int r = i >> 2, c = 16 * (i & 3);
      vr2::cp_async16(st + r * kWPitch + c, w + (long long)(k0 + r) * p.N + n0 + c);
    }
#pragma unroll
    for (int i = tid; i < R::BM * 8; i += kThreads) {  // rows x 8 chunks of 8 values
      const int r = i >> 3, c = i & 7;
      if (r < rows)
        vr2::cp_async16(xs + r * kXPitch + 16 * c,
                        p.x + (long long)(row0 + r) * p.K + k0 + 8 * c);
    }
  } else {  // loaded and stored here: the barrier before this stage is read
            // orders them as it does the copies
#pragma unroll 4
    for (int i = tid; i < kKS * kBN; i += kThreads) {
      const int r = i >> 6, c = i & 63;
      st[r * kWPitch + c] = k0 + r < p.K && n0 + c < p.N
                                ? static_cast<unsigned char>(w[(long long)(k0 + r) * p.N + n0 + c])
                                : 0;
    }
    for (int i = tid; i < R::BM * kKS; i += kThreads) {
      const int r = i >> 6, c = i & 63;
      if (r < rows)
        reinterpret_cast<__nv_bfloat16*>(xs + r * kXPitch)[c] =
            k0 + c < p.K ? p.x[(long long)(row0 + r) * p.K + k0 + c] : __float2bfloat16_rn(0.f);
    }
  }
}

template <int MT, int PATH>
__global__ void __launch_bounds__(kThreads) int8_matmul_kernel(const Int8Params p) {
  using R = Ring<MT>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int row0 = blockIdx.x * R::BM, n0 = blockIdx.y * kBN;
  const int layer = p.layer0 + blockIdx.z;
  const int rows = min(R::BM, p.M - row0);
  const int8_t* w = p.wq + (long long)layer * p.K * p.N;
  const float* scale = p.scale + (long long)layer * p.N;
  __nv_bfloat16* y = p.y + (long long)blockIdx.z * p.M * p.N;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r8 = lane & 7, mid = (lane >> 3) & 1, lhi = lane >> 4;
  const int wn0 = warp * 16;
  const int n_stages = (p.K + kKS - 1) / kKS;

#pragma unroll
  for (int s = 0; s < R::STAGES - 1; ++s) {
    if (s < n_stages)
      load_stage<MT, PATH>(smem + s * R::BYTES, p, w, s, n0, row0, rows, tid);
    vr2::cp_async_commit();
  }

  // acc[mt][0]: the warp's even columns wn0 + 2c, acc[mt][1]: the odd ones
  float acc[MT][2][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int e = 0; e < 2; ++e)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][e][i] = 0.f;

  for (int s = 0; s < n_stages; ++s) {
    vr2::cp_async_wait<R::STAGES - 2>();  // stage s has landed
    __syncthreads();                      // ... for every thread; stage s - 1 is free
    const int nx = s + R::STAGES - 1;
    if (nx < n_stages)
      load_stage<MT, PATH>(smem + (nx % R::STAGES) * R::BYTES, p, w, nx, n0, row0, rows, tid);
    vr2::cp_async_commit();

    const unsigned char* st = smem + (s % R::STAGES) * R::BYTES;
    const unsigned char* xs = st + R::W_BYTES;
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      // k rows [32 kk, 32 kk + 32) of the warp's 16 columns: tile i holds
      // rows 8 i to 8 i + 7, so tiles 2h and 2h + 1 are the b0 and b1 of
      // the 16 k of step h
      uint32_t b[4];
      ldsm_x4_trans(b, st + (32 * kk + lane) * kWPitch + wn0);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        uint32_t be0, bo0, be1, bo1;
        int8_pairs(b[2 * h], be0, bo0);
        int8_pairs(b[2 * h + 1], be1, bo1);
        const int ks = 2 * kk + h;
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          uint32_t a[4];
          vr2::ldsm_x4(a, xs + (mt * 16 + r8 + 8 * mid) * kXPitch + ks * 32 + 16 * lhi);
          vr2::mma_bf16_16816(acc[mt][0], a, be0, be1);
          vr2::mma_bf16_16816(acc[mt][1], a, bo0, bo1);
        }
      }
    }
  }

  // lane (g, t) holds columns c .. c + 3 = n0 + wn0 + 4t + {0, 1, 2, 3}
  // (even c, odd c, even c + 2, odd c + 2) of rows g and g + 8
  const int c = n0 + wn0 + 4 * t;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = mt * 16 + g + 8 * half;
      if (r >= rows) continue;
      const float v[4] = {acc[mt][0][2 * half], acc[mt][1][2 * half],
                          acc[mt][0][2 * half + 1], acc[mt][1][2 * half + 1]};
      __nv_bfloat16* yr = y + (long long)(row0 + r) * p.N;
      if constexpr (PATH == kWhole) {  // 64 | N: the scales and the 4 outputs aligned
        const float4 sc = __ldg(reinterpret_cast<const float4*>(scale + c));
        *reinterpret_cast<uint2*>(yr + c) =
            make_uint2(vr2::pack_bf16(v[0] * sc.x, v[1] * sc.y),
                       vr2::pack_bf16(v[2] * sc.z, v[3] * sc.w));
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (c + j < p.N) yr[c + j] = __float2bfloat16_rn(v[j] * __ldg(scale + c + j));
      }
    }
}

template <int MT, int PATH>
cudaError_t launch(const Int8Params& p, int layers, cudaStream_t stream) {
  using R = Ring<MT>;
  cudaError_t err = cudaFuncSetAttribute(
      int8_matmul_kernel<MT, PATH>, cudaFuncAttributeMaxDynamicSharedMemorySize, R::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.M + R::BM - 1) / R::BM, (p.N + kBN - 1) / kBN, layers);
  int8_matmul_kernel<MT, PATH><<<grid, kThreads, R::SMEM, stream>>>(p);
  return cudaGetLastError();
}

template <int MT>
cudaError_t launch_path(const Int8Params& p, int layers, cudaStream_t stream) {
  if (p.K % kKS == 0 && p.N % kBN == 0) return launch<MT, kWhole>(p, layers, stream);
  return launch<MT, kAny1>(p, layers, stream);
}

cudaError_t run(const void* x, const void* wq, const void* scale, void* y, int M, int K,
                int N, int layer0, int layers, void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || layers <= 0) return cudaErrorInvalidValue;
  const Int8Params p{static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(wq),
                     static_cast<const float*>(scale), static_cast<__nv_bfloat16*>(y),
                     M, K, N, layer0};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M <= 16) return launch_path<1>(p, layers, st);
  if (M <= 32) return launch_path<2>(p, layers, st);
  return launch_path<4>(p, layers, st);
}

}  // namespace

// Plain C entry points, loaded with ctypes; each returns a cudaError_t.
// x [M, K] bf16, scale fp32, y bf16, all contiguous and 16-byte aligned
// (as is wq); any M, K, N >= 1.
// y [M, N] = (x @ wq [K, N]) * scale [N]
extern "C" int vr2_int8_matmul(const void* x, const void* wq, const void* scale, void* y,
                               int M, int K, int N, void* stream) {
  return int(run(x, wq, scale, y, M, K, N, 0, 1, stream));
}

// y [M, N] = (x @ wq[layer]) * scale[layer], wq [L, K, N], scale [L, N]
extern "C" int vr2_int8_matmul_stacked(const void* x, const void* wq, const void* scale,
                                       void* y, int M, int K, int N, int L, int layer,
                                       void* stream) {
  if (layer < 0 || layer >= L) return int(cudaErrorInvalidValue);
  return int(run(x, wq, scale, y, M, K, N, layer, 1, stream));
}

// y [L, M, N]: y[l] = (x @ wq[l]) * scale[l] for every layer, in one launch
extern "C" int vr2_int8_matmul_all_layers(const void* x, const void* wq, const void* scale,
                                          void* y, int M, int K, int N, int L,
                                          void* stream) {
  return int(run(x, wq, scale, y, M, K, N, 0, L, stream));
}
