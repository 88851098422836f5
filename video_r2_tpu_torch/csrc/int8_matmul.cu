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
// The staged kernel (every entry; vr2_int8_matmul past the decode
// kernel's shapes): one 128-thread block per (16 / 32 / 64
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
// of one column block share its weights through L2 when M > 64. At decode
// it ran at 45% of the bound at gate / up and left the card idle at k / v
// (8 blocks on 132 SMs): the decode kernel below takes those shapes.
// Any K and N: K and N multiples of 64 (every decoder width, the head, the
// ViT's qkv and proj, the merger) take unpredicated 16-byte copies; any
// other width (the ViT's gate / up and down at 3420, K 300 / N 500) loads
// byte by byte (weights) and value by value (x), zero past K and N. The K
// tail's x columns and weight rows are zero in shared memory, so they add
// nothing; columns past N are not stored.
//
// The decode kernel (vr2_int8_matmul_decode: 1 to 16 rows, 128 | N, 64 | K;
// the wrapper's int8_decode_plan routes the 7B's decode linears to it):
// - Every byte comes by TMA into a ring of 6-7 shared-memory stages (~70
//   KB a block, 3 blocks an SM, ~150 KB in flight an SM): a step is one box
//   of 64 k x 128 int8 columns, 128 bytes wide with the 128-byte swizzle,
//   and one box of x's 64 k over 8 or 16 rows (rows past M read zeros).
//   The staged kernel's 16-byte cp.async pieces capped its rate at 45% of
//   the bound (PERF.md), as they capped the int4 kernels'.
// - The weights are mma's A operand (the output columns are M, x's rows N
//   in tiles of 8), so no product is padded past 8 rows of x. Warp w owns
//   columns 32 w .. 32 w + 31 of the tile over the step's 64 k: a k16 step
//   is one ldmatrix .trans of 16-bit pairs, whose 4 words int8_pairs splits
//   into the A fragments of the even and of the odd columns; x's B
//   fragments come by ldmatrix from its swizzled box. The ring, both
//   fragment loads and the close are csrc/stream_k.cuh's, shared with the
//   int4 decode kernel and the MoE FFN's int8 decode instances.
// - The scale is applied once a column, to the fp32 sum, at the close.
// - Split-K in one launch: the S <= 16 splits of a tile's K one
//   thread-block cluster that adds their sums through its shared memory in
//   a fixed order, so y is the same bit for bit from call to call; S = 1
//   where the tiles alone give every resident slot a block (the head's
//   1188 tiles on 396 slots). A stream-K close with a ticket measured
//   0.0403-0.0410 ms at gate / up against the cluster's 0.0320, and ran
//   the head 0-3% faster than the unsplit tiles (PERF.md): one close is
//   kept, the cluster's.
#include "attn_common.cuh"
#include "stream_k.cuh"

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

// The decode kernel; see the file's header.
namespace dec {

using vr2::sk::kCols;
using vr2::sk::kThreads;

constexpr int kStepK = 64;       // k of a step: 64 rows of a weight box
constexpr int kBlocksPerSm = 3;  // the shared memory below keeps it at 3

// One ring stage for MT 8-row tiles of x, each part a TMA box (1024-byte
// aligned, as the 128-byte swizzle needs): the weights [64 k][128 columns]
// int8 and x's rows [8 MT][64 k] bf16, both swizzled; then the fp32 sums
// [8 MT][128] of the close
template <int MT>
struct Ring {
  static constexpr int W_BYTES = kStepK * kCols;
  static constexpr int X_BYTES = 8 * MT * 128;
  static constexpr int BYTES = W_BYTES + X_BYTES;
  static constexpr int STAGES = MT == 1 ? 7 : 6;
  static constexpr int RED = 8 * MT * kCols * 4;
  static constexpr int SMEM = vr2::kSwizzleAlign + STAGES * BYTES + RED + STAGES * 8;
  static_assert(BYTES % vr2::kSwizzleAlign == 0, "stages stay 1024-byte aligned");
};

struct DecParams {
  vr2::sk::Out out;  // y, the column scales, M, N (no stream-K workspace)
  int K;
};

// tile blockIdx.x, split blockIdx.z of gridDim.z: the splits of a tile one
// cluster
template <int MT>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
    int8_decode_kernel(__grid_constant__ const CUtensorMap mw,
                       __grid_constant__ const CUtensorMap mx, const DecParams p) {
  using R = Ring<MT>;
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int ks = p.K / kStepK, T = blockIdx.x, S = gridDim.z, z = blockIdx.z;
  const int u0 = T * ks + vr2::sk::range_begin(z, ks, S);
  const int u1 = T * ks + vr2::sk::range_begin(z + 1, ks, S);
  unsigned char* ring = vr2::swizzle_aligned(smem);
  float* red = reinterpret_cast<float*>(ring + R::STAGES * R::BYTES);
  uint64_t* full = reinterpret_cast<uint64_t*>(red + R::RED / 4);

  // acc[0]: the warp's even columns, acc[1]: the odd ones
  float acc[2][MT][4];
#pragma unroll
  for (int e = 0; e < 2; ++e)
#pragma unroll
    for (int jt = 0; jt < MT; ++jt)
      acc[e][jt][0] = acc[e][jt][1] = acc[e][jt][2] = acc[e][jt][3] = 0.f;

  vr2::sk::decode_ring<R::STAGES, R::BYTES>(
      ring, full, u0, u1, ks,
      // unit u: the weights of its tile, k [64 j, 64 j + 64), and x's
      // columns of the same k (warp 0)
      [&](int u, unsigned char* st, uint64_t* bar) {
        const int k0 = (u - T * ks) * kStepK;
        vr2::tma_stage(bar, R::BYTES, 2, [&](int bx) {
          if (bx == 0)
            vr2::tma_load_2d(st, &mw, bar, T * kCols, k0);
          else
            vr2::tma_load_2d(st + R::W_BYTES, &mx, bar, k0, 0);
        });
      },
      // this warp's products of a step: its 32 columns over the step's 64 k
      [&](const unsigned char* st) {
#pragma unroll
        for (int kk = 0; kk < kStepK / 16; ++kk) {
          uint32_t b[MT][2], ae[4], ao[4];
          vr2::sk::x_b_frags<MT>(b, st + R::W_BYTES, kk, lane);
          vr2::sk::int8_a_frags(ae, ao, st, kk * 16, 32 * w, lane);
#pragma unroll
          for (int jt = 0; jt < MT; ++jt) {
            vr2::mma_bf16_16816(acc[0][jt], ae, b[jt][0], b[jt][1]);
            vr2::mma_bf16_16816(acc[1][jt], ao, b[jt][0], b[jt][1]);
          }
        }
      },
      // the close: the warp's sums into red [row][column] (C fragment:
      // acc[e][jt][i] is row 8 jt + 2t + (i & 1), column 32 w + 2g + 16 (i
      // >> 1) + e), then the cluster's sums of the tile in split order
      [&](int, int, int) {
#pragma unroll
        for (int jt = 0; jt < MT; ++jt)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int r = 8 * jt + 2 * t + (i & 1), c = 32 * w + 2 * g + 16 * (i >> 1);
            if (r < p.out.M)
              *reinterpret_cast<float2*>(red + r * kCols + c) =
                  make_float2(acc[0][jt][i], acc[1][jt][i]);
          }
        vr2::sk::close_cluster(p.out, red, T, S);
      },
      &mw, &mx);
}

// the shared memory, the carveout and clusters past the portable 8, set
// once a device
template <int MT>
cudaError_t configure() {
  static std::atomic<uint64_t> done{0};
  return vr2::sk::once_per_device(done, [] {
    const auto kernel = int8_decode_kernel<MT>;
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           Ring<MT>::SMEM);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                 int(cudaSharedmemCarveoutMaxShared));
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    return err;
  });
}

// a launch of `splits` blocks a tile, one cluster (dims 1 x 1 x splits)
template <int MT>
cudaLaunchConfig_t cluster_config(cudaLaunchAttribute& cluster, int tiles, int splits,
                                  cudaStream_t stream) {
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = 1, cluster.val.clusterDim.y = 1, cluster.val.clusterDim.z = splits;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(tiles, 1, splits), cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = Ring<MT>::SMEM, cfg.stream = stream;
  cfg.attrs = &cluster, cfg.numAttrs = 1;
  return cfg;
}

template <int MT>
cudaError_t launch(const __nv_bfloat16* x, const int8_t* wq, const DecParams& p, int splits,
                   cudaStream_t stream) {
  cudaError_t err = configure<MT>();
  if (err != cudaSuccess) return err;
  CUtensorMap mw, mx;
  if ((err = vr2::box_map(&mw, wq, p.out.N, p.K, 0, kStepK, true)) != cudaSuccess ||
      (err = vr2::box_map(&mx, x, p.K, p.out.M, 0, 8 * MT)) != cudaSuccess)
    return err;
  cudaLaunchAttribute cluster;
  const cudaLaunchConfig_t cfg = cluster_config<MT>(cluster, p.out.N / kCols, splits, stream);
  if ((err = cudaLaunchKernelEx(&cfg, int8_decode_kernel<MT>, mw, mx, p)) != cudaSuccess)
    return err;
  return cudaGetLastError();
}

}  // namespace dec

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

// y [M, N] = (x @ wq [K, N]) * scale [N] on the decode kernel: M <= 16,
// 128 | N, 64 | K; the K steps (64 k each) of each 128-column tile cut into
// `splits` ranges (at least 1, at most 16 and at most the steps), the
// splits of a tile one cluster.
extern "C" int vr2_int8_matmul_decode(const void* x, const void* wq, const void* scale, void* y,
                                      int M, int K, int N, int splits, void* stream) {
  if (M <= 0 || M > 16 || K <= 0 || K % dec::kStepK != 0 || N <= 0 || N % dec::kCols != 0 ||
      splits < 1 || splits > vr2::sk::kMaxSplits || splits > K / dec::kStepK)
    return int(cudaErrorInvalidValue);
  const dec::DecParams p{{static_cast<__nv_bfloat16*>(y), nullptr, nullptr,
                          static_cast<const float*>(scale), M, N},
                         K};
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* w8 = static_cast<const int8_t*>(wq);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return int(M <= 8 ? dec::launch<1>(xb, w8, p, splits, st) : dec::launch<2>(xb, w8, p, splits, st));
}

// The decode kernel's residency on the current device, for 8 and 16 rows
// of x: out[0], out[1] its blocks an SM (the occupancy calculator's
// count); out[2 + 16 r + S - 1] (r = 0 for 8 rows, 1 for 16) the clusters
// of S blocks the card holds at once (cudaOccupancyMaxActiveClusters; S =
// 1 .. 16; 0 for a size the card does not schedule). Returns a
// cudaError_t.
extern "C" int vr2_int8_matmul_layout(int* out) {
  cudaError_t err;
  if ((err = dec::configure<1>()) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &out[0], dec::int8_decode_kernel<1>, dec::kThreads, dec::Ring<1>::SMEM)) !=
          cudaSuccess ||
      (err = dec::configure<2>()) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &out[1], dec::int8_decode_kernel<2>, dec::kThreads, dec::Ring<2>::SMEM)) !=
          cudaSuccess)
    return int(err);
  for (int S = 1; S <= vr2::sk::kMaxSplits; ++S) {
    cudaLaunchAttribute c1, c2;
    const cudaLaunchConfig_t f1 = dec::cluster_config<1>(c1, 1, S, nullptr);
    const cudaLaunchConfig_t f2 = dec::cluster_config<2>(c2, 1, S, nullptr);
    for (int r = 0; r < 2; ++r) {
      int* at = &out[2 + 16 * r + S - 1];
      err = r ? cudaOccupancyMaxActiveClusters(at, dec::int8_decode_kernel<2>, &f2)
              : cudaOccupancyMaxActiveClusters(at, dec::int8_decode_kernel<1>, &f1);
      if (err != cudaSuccess) {  // a cluster size the card does not schedule: none
        *at = 0;
        cudaGetLastError();
      }
    }
  }
  return int(cudaSuccess);
}
