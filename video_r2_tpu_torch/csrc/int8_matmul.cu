// Int8 weight-only matmul for Hopper (sm_90a): y = (x @ wq) * scale.
//
// Replaces the three TPU kernels of the int8 dequant matmul, with three
// device kernels chosen by shape in the wrapper (ops/int8_matmul.py):
// - video_r2_tpu/ops/int8_matmul.py::_kernel (:23, via int8_matmul):
//   x [M, K] @ wq [K, N];
// - video_r2_tpu/ops/int8_matmul.py::_stacked_kernel (:81, via
//   int8_matmul_stacked): layer l of a stacked wq [L, K, N], scale [L, N],
//   l a scalar prefetch there; here the layer is a coordinate of the
//   weights' tensor map or an offset inside the kernel (no slice copy of
//   wq[l]);
// - scripts/microbench_int8.py::_kernel_all (:32, via all_layers_matmul):
//   every layer in one launch, out [L, M, N]: the layer on the grid.
// Same semantics: x bf16; each int8 weight converted to bf16 (exact: |q| <=
// 128 needs 8 significant bits), the products summed in fp32, the sum times
// the fp32 per-output-channel scale once, and y rounded to bf16 once.
//
// What bounds it on the card: each weight byte serves M products. At the
// 7B's widths the int8 weights (K N bytes, read once) bound it up to ~64
// rows of x (at 64 rows of gate / up, 0.0203 ms of bytes against 0.0088 of
// bf16 products); above, the products do (0.0351 ms at 256 rows).
//
// The wide kernel (vr2_int8_matmul_wide; ops/int8_matmul.py::
// int8_wide_plan: every TMA-mappable shape the decode kernel does not take,
// so the one-layer entry at 17-256 rows of bf16 x and every stacked and
// all-layers call with K % 8 == 0 and N % 16 == 0):
// - A block owns 128 output columns of one row tile of x (32, 64 or 128
//   rows: the smallest that holds M; more rows are more row tiles, the row
//   tiles of a column tile neighbours on the grid so they share its weights
//   through L2) and a range of the K steps (64 k each). Every byte comes by
//   TMA into a ring of shared-memory stages: one box of 64 k x 128 int8
//   columns (the layer a coordinate of a 3-D map over [L, K, N]) and one
//   box of the row tile's x over the same 64 k, both with the 128-byte
//   swizzle; rows past M and k past K read zeros. The staged kernel it
//   replaces loaded 16-byte cp.async pieces by every thread with a block
//   barrier a stage, and re-read x from L2 for every 64 columns; it ran at
//   28% of the bound at 64 rows of gate / up (PERF.md).
// - A producer warpgroup (one thread issues every box; setmaxnreg gives its
//   registers to the consumers) runs ahead by the ring's depth, a full and
//   an empty barrier a slot: no block-wide barrier a stage. Each consumer
//   warp releases a slot once the products that read it have completed.
// - Products on wgmma with the weight columns as M: two consumer
//   warpgroups, 64 columns each. Warp v's A fragments of a k16 step (rows
//   g, g + 8 are columns 16 v + 2 g, 16 v + 2 g + 1 of its warpgroup's 64)
//   come from one ldmatrix .trans of 16-bit pairs a k32 (two columns' bytes
//   at one k), split by int8_pairs into exact bf16; x's row tile is wgmma's
//   N, K-major from the swizzled box. A stage's four products are one
//   commit group; the next stage's fragments are formed into a second
//   register buffer while they run.
// - The scale is read once a column and applied to the fp32 sum.
// - Waves: 32- and 64-row tiles keep two blocks an SM, 128-row tiles one.
//   Where the tiles leave SMs idle (q / o: 28 tiles; k / v: 4) the plan
//   splits each tile's K over a thread-block cluster of up to 16 blocks,
//   at most one block an SM, whose sums are added through shared memory in
//   split order, so y is the same bit for bit from call to call (no
//   ticket, no workspace: a captured CUDA graph stays valid).
// - Measured on an H100 (PERF.md): the ring alone (no fragments, no
//   products) streams gate / up at 64 rows at 78% of the bytes bound, so
//   the producer warp and the empty barriers removed the cap of the
//   staged kernel's loads; the whole kernel reaches 58% there, held by the
//   16 SMs that take two of the 148 tiles and by the conversions. Split
//   grids past one block an SM, a persistent grid of one block an SM, a
//   third fragment buffer and tiles of 256 columns all measured slower.
//
// The element-load kernel (vr2_int8_matmul_elem: K % 8 != 0 or N % 16 != 0,
// which TMA cannot map, such as the ViT's 3420; the wrapper routes by shape,
// up front): one 128-thread block per (16 / 32 / 64 rows, 64 output
// columns), the weights loaded byte by byte and x value by value through a
// ring of shared-memory stages, zero past K and N; products on mma.sync
// m16n8k16 with the weights as B (ldmatrix .trans of 16-bit pairs,
// int8_pairs); columns past N are not stored.
//
// The decode kernel (vr2_int8_matmul_decode: 1 to 16 rows, 128 | N, 64 | K;
// the wrapper's int8_decode_plan routes the 7B's decode linears to it):
// - Every byte comes by TMA into a ring of 6-7 shared-memory stages (~70
//   KB a block, 3 blocks an SM, ~150 KB in flight an SM): a step is one box
//   of 64 k x 128 int8 columns, 128 bytes wide with the 128-byte swizzle,
//   and one box of x's 64 k over 8 or 16 rows (rows past M read zeros).
//   16-byte cp.async pieces capped the staged kernel's rate at 45% of the
//   bound (PERF.md), as they capped the int4 kernels'.
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

using bf16 = __nv_bfloat16;

// The element-load kernel; see the file's header.
namespace elem {

constexpr int kThreads = 128;  // 4 warps side by side over the columns
constexpr int kBN = 64;        // output columns per block, 16 per warp
constexpr int kKS = 64;        // rows of K per stage
constexpr int kWPitch = 80;    // shared row pitch (bytes) of the staged weights:
                               // 64 + 16 keeps ldmatrix's 8 rows on distinct banks
constexpr int kXPitch = 144;   // shared row pitch (bytes) of the staged x: 128 + 16

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
  const bf16* x;           // [M, K]
  const int8_t* wq;        // [L, K, N]
  const float* scale;      // [L, N]
  bf16* y;                 // [gridDim.z, M, N]
  int M, K, N;
  int layer0;              // the layer of grid z = 0
};

using vr2::int8_pairs;
using vr2::ldsm_x4_trans;

// Load stage s (rows [64 s, 64 s + 64) of K) of the block's 64 columns from
// n0 and its rows [row0, row0 + rows) of x into `st`, zero past K and N;
// rows of x at or past `rows` are left as they are (their outputs are not
// stored). Loaded and stored by the block's threads: the barrier before
// this stage is read orders them.
template <int MT>
__device__ __forceinline__ void load_stage(unsigned char* st, const Int8Params& p,
                                           const int8_t* w, int s, int n0, int row0,
                                           int rows, int tid) {
  using R = Ring<MT>;
  const int k0 = s * kKS;
  unsigned char* xs = st + R::W_BYTES;
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
      reinterpret_cast<bf16*>(xs + r * kXPitch)[c] =
          k0 + c < p.K ? p.x[(long long)(row0 + r) * p.K + k0 + c] : __float2bfloat16_rn(0.f);
  }
}

template <int MT>
__global__ void __launch_bounds__(kThreads) int8_elem_kernel(const Int8Params p) {
  using R = Ring<MT>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int row0 = blockIdx.x * R::BM, n0 = blockIdx.y * kBN;
  const int layer = p.layer0 + blockIdx.z;
  const int rows = min(R::BM, p.M - row0);
  const int8_t* w = p.wq + (long long)layer * p.K * p.N;
  const float* scale = p.scale + (long long)layer * p.N;
  bf16* y = p.y + (long long)blockIdx.z * p.M * p.N;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r8 = lane & 7, mid = (lane >> 3) & 1, lhi = lane >> 4;
  const int wn0 = warp * 16;
  const int n_stages = (p.K + kKS - 1) / kKS;

  for (int s = 0; s < R::STAGES - 1 && s < n_stages; ++s)
    load_stage<MT>(smem + s * R::BYTES, p, w, s, n0, row0, rows, tid);

  // acc[mt][0]: the warp's even columns wn0 + 2c, acc[mt][1]: the odd ones
  float acc[MT][2][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int e = 0; e < 2; ++e)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][e][i] = 0.f;

  for (int s = 0; s < n_stages; ++s) {
    __syncthreads();  // stage s is stored by every thread; stage s - 1 is free
    const int nx = s + R::STAGES - 1;
    if (nx < n_stages)
      load_stage<MT>(smem + (nx % R::STAGES) * R::BYTES, p, w, nx, n0, row0, rows, tid);

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
      bf16* yr = y + (long long)(row0 + r) * p.N;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (c + j < p.N) yr[c + j] = __float2bfloat16_rn(v[j] * __ldg(scale + c + j));
    }
}

template <int MT>
cudaError_t launch(const Int8Params& p, int layers, cudaStream_t stream) {
  using R = Ring<MT>;
  cudaError_t err = cudaFuncSetAttribute(
      int8_elem_kernel<MT>, cudaFuncAttributeMaxDynamicSharedMemorySize, R::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.M + R::BM - 1) / R::BM, (p.N + kBN - 1) / kBN, layers);
  int8_elem_kernel<MT><<<grid, kThreads, R::SMEM, stream>>>(p);
  return cudaGetLastError();
}

cudaError_t run(const Int8Params& p, int layers, cudaStream_t st) {
  if (p.M <= 16) return launch<1>(p, layers, st);
  if (p.M <= 32) return launch<2>(p, layers, st);
  return launch<4>(p, layers, st);
}

}  // namespace elem

// The wide kernel; see the file's header.
namespace wide {

using vr2::sk::kCols;                       // output columns of a block: a box row of int8
constexpr int kStepK = 64;                  // k of a stage: 64 rows of a weight box
constexpr int kConsumers = 256;             // two consumer warpgroups, 64 columns each
constexpr int kThreads = kConsumers + 128;  // and a producer warpgroup
constexpr int kRedPitch = kCols + 4;        // fp32 row pitch of the split close's sums
// fragment buffers of a consumer: the products of kDepth - 1 stages run
// while the next stage's fragments are formed
constexpr int kDepth = 2;

// One instance's ring: STAGES stages of a weight box [64 k][128 columns]
// int8 and x's box [BN rows][64 k] bf16 (each 1024-byte aligned, as the
// 128-byte swizzle needs), then the full and the empty barriers. BN 32 and
// 64 keep two blocks an SM (~108 KB of ring each), BN 128 one (~200 KB);
// setmaxnreg moves the producer's registers to the consumers: at two
// blocks 384 threads start at 80 (65536 / 768, in steps of 8), 128 x (80 -
// 24) >= 256 x (104 - 80); at one block at 168, 128 x (168 - 40) = 256 x
// (232 - 168).
template <int BN>
struct Geo {
  static constexpr int W_BYTES = kStepK * kCols;
  static constexpr int X_BYTES = BN * 128;
  static constexpr int STAGE = W_BYTES + X_BYTES;
  static constexpr int MINB = BN <= 64 ? 2 : 1;
  static constexpr int STAGES = (MINB == 2 ? 108 : 200) * 1024 / STAGE;
  static constexpr int SMEM = vr2::kSwizzleAlign + STAGES * STAGE + 2 * STAGES * 8;
  static constexpr int PRODUCER_REGS = MINB == 2 ? 24 : 40;
  static constexpr int CONSUMER_REGS = MINB == 2 ? 104 : 232;
  static_assert(STAGE % vr2::kSwizzleAlign == 0, "stages stay 1024-byte aligned");
  static_assert(BN * kRedPitch * 4 <= STAGES * STAGE, "the close's sums fit in the ring");
};

struct WideParams {
  bf16* y;              // [layers, M, N]
  const float* scale;   // [L, N]
  int M, K, N;
  int layer0;           // the layer of grid z slab 0
  int col_tiles;        // ceil(N / kCols)
};

// Block (split z = blockIdx.x of S = gridDim.x, row tile blockIdx.y, slab
// blockIdx.z / col_tiles, column tile blockIdx.z % col_tiles): the S splits
// of a tile are one cluster (dims S x 1 x 1). The split's K steps are
// taken kDepth at a time (one register buffer of fragments each), a range
// that kDepth does not divide ending with stages past K that read zeros
// and add nothing.
template <int BN>
__global__ void __launch_bounds__(kThreads, Geo<BN>::MINB)
    int8_wide_kernel(__grid_constant__ const CUtensorMap mw,
                     __grid_constant__ const CUtensorMap mx, const WideParams p) {
  using G = Geo<BN>;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* ring = vr2::swizzle_aligned(smem);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + G::STAGES * G::STAGE);
  uint64_t* empty = full + G::STAGES;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int S = gridDim.x, z = blockIdx.x;
  const int row0 = blockIdx.y * BN;
  const int slab = blockIdx.z / p.col_tiles, n0 = (blockIdx.z % p.col_tiles) * kCols;
  const int ks = (p.K + kStepK - 1) / kStepK;
  const int s0 = vr2::sk::range_begin(z, ks, S);
  const int ns = vr2::sk::range_begin(z + 1, ks, S) - s0;
  const int n_groups = (ns + kDepth - 1) / kDepth;

  if (tid == 0) {
    for (int i = 0; i < G::STAGES; ++i) {
      vr2::mbar_init(full + i, 1);
      vr2::mbar_init(empty + i, kConsumers / 32);  // an arrival a consumer warp
    }
    vr2::mbar_init_fence();
    vr2::sk::prefetch_map(&mw);
    vr2::sk::prefetch_map(&mx);
  }
  __syncthreads();

  if (warp >= kConsumers / 32) {  // the producer: one thread keeps the ring full
    vr2::regs_shrink<G::PRODUCER_REGS>();
    if (warp == kConsumers / 32 && lane == 0) {
      const int layer = p.layer0 + slab;
      for (int i = 0; i < kDepth * n_groups; ++i) {
        const int slot = i % G::STAGES;
        if (i >= G::STAGES) vr2::mbar_wait(empty + slot, (i / G::STAGES - 1) & 1);
        unsigned char* st = ring + slot * G::STAGE;
        const int k0 = (i < ns ? s0 + i : ks) * kStepK;
        vr2::mbar_expect_tx(full + slot, G::STAGE);
        vr2::tma_load_3d(st, &mw, full + slot, n0, k0, layer);
        vr2::tma_load_2d(st + G::W_BYTES, &mx, full + slot, k0, row0);
      }
    }
    return;  // a cluster barrier waits for the threads that have not exited
  }

  vr2::regs_grow<G::CONSUMER_REGS>();
  const int v = warp & 3, g = lane >> 2, t = lane & 3;
  const int c0 = 64 * (warp >> 2) + 16 * v;  // the warp's 16 columns of the block's 128
  // acc[j][e]: column c0 + 2 g + (e >> 1) of the block, x row 8 j + 2 t + (e & 1)
  float acc[BN / 8][4];
  vr2::zero_acc(acc);

  // stage i: its fragments into f (k steps 0-3), its products one commit
  // group, then a wait for stage i - kDepth + 1's group, which frees its
  // ring slot (one arrival a warp on the slot's empty barrier) and its
  // fragment registers (the buffer stage i + 1 fills)
  auto stage = [&](int i, uint32_t (&f)[4][4]) {
    const int slot = i % G::STAGES;
    vr2::mbar_wait(full + slot, (i / G::STAGES) & 1);
    const unsigned char* st = ring + slot * G::STAGE;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      // k [32 h, 32 h + 32) of the warp's 16 columns: 8 x 8 tiles of 16-bit
      // pairs at k [8 m, 8 m + 8), m = 0..3; tiles 2q and 2q + 1 are the k
      // [0, 8) and [8, 16) of step 2 h + q
      uint32_t r[4];
      vr2::ldsm_x4_trans(r, vr2::sw128_at(st, 32 * h + lane, c0));
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        vr2::int8_pairs(r[2 * q], f[2 * h + q][0], f[2 * h + q][1]);
        vr2::int8_pairs(r[2 * q + 1], f[2 * h + q][2], f[2 * h + q][3]);
      }
    }
    vr2::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      vr2::wgmma_rs<BN, 0>(acc, f[kk], vr2::desc_k_sw128(st + G::W_BYTES, kk), 1);
    vr2::wgmma_commit();
    vr2::wgmma_wait<kDepth - 1>();
    __syncwarp();
    if (i >= kDepth - 1 && lane == 0)
      vr2::mbar_arrive(empty + (i - kDepth + 1) % G::STAGES);
  };
  uint32_t f[kDepth][4][4];
  for (int gi = 0; gi < n_groups; ++gi)
#pragma unroll
    for (int d = 0; d < kDepth; ++d) stage(kDepth * gi + d, f[d]);
  vr2::wgmma_wait<0>();
  vr2::fence_regs(acc);

  const float* scale = p.scale + (long long)(p.layer0 + slab) * p.N;
  bf16* y = p.y + (long long)slab * p.M * p.N;
  if (S == 1) {  // the whole K: y from the registers
    const int c = n0 + c0 + 2 * g;
    if (c >= p.N) return;  // 16 | N: both columns or neither
    const float2 sc = __ldg(reinterpret_cast<const float2*>(scale + c));
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int lo = 0; lo < 2; ++lo) {
        const int r = row0 + 8 * j + 2 * t + lo;
        if (r < p.M)
          *reinterpret_cast<uint32_t*>(y + (long long)r * p.N + c) =
              vr2::pack_bf16(acc[j][lo] * sc.x, acc[j][2 + lo] * sc.y);
      }
    return;
  }
  // A split: the sums into red [row][column] over the free ring (both
  // consumer warpgroups are past it and every box has landed), then after
  // a cluster barrier split z takes every S-th quad of the tile from z on
  // and adds the S splits' sums of it in the order 0 .. S - 1, scales,
  // rounds y to bf16 once and stores it; a second barrier keeps each
  // block's sums until the others have read them.
  vr2::named_sync(1, kConsumers);
  float* red = reinterpret_cast<float*>(ring);
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int lo = 0; lo < 2; ++lo)
      *reinterpret_cast<float2*>(red + (8 * j + 2 * t + lo) * kRedPitch + c0 + 2 * g) =
          make_float2(acc[j][lo], acc[j][2 + lo]);
  vr2::sk::cluster_sync();
  const int rows = min(BN, p.M - row0);
  for (int i = z * kConsumers + tid; i < rows * (kCols / 4); i += S * kConsumers) {
    const int r = i / (kCols / 4), c4 = 4 * (i % (kCols / 4));
    const float* at = red + r * kRedPitch + c4;
    float4 got[vr2::sk::kMaxSplits];
#pragma unroll
    for (int zz = 0; zz < vr2::sk::kMaxSplits; ++zz)
      if (zz < S) got[zz] = vr2::sk::ld_cluster_f4(at, zz);
    float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int zz = 0; zz < vr2::sk::kMaxSplits; ++zz)
      if (zz < S) sum.x += got[zz].x, sum.y += got[zz].y, sum.z += got[zz].z, sum.w += got[zz].w;
    const int col = n0 + c4;
    if (col < p.N) {  // 16 | N: all four columns or none
      const float4 sc = __ldg(reinterpret_cast<const float4*>(scale + col));
      *reinterpret_cast<uint2*>(y + (long long)(row0 + r) * p.N + col) =
          make_uint2(vr2::pack_bf16(sum.x * sc.x, sum.y * sc.y),
                     vr2::pack_bf16(sum.z * sc.z, sum.w * sc.w));
    }
  }
  vr2::sk::cluster_sync();
}

// the shared memory, the carveout and clusters past the portable 8, set
// once a device
template <int BN>
cudaError_t configure() {
  static std::atomic<uint64_t> done{0};
  return vr2::sk::once_per_device(done, [] {
    const auto kernel = int8_wide_kernel<BN>;
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           Geo<BN>::SMEM);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                 int(cudaSharedmemCarveoutMaxShared));
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    return err;
  });
}

// a launch over `grid`, its `splits` blocks of a tile one cluster (dims
// splits x 1 x 1)
template <int BN>
cudaLaunchConfig_t cluster_config(cudaLaunchAttribute& cluster, dim3 grid, int splits,
                                  cudaStream_t stream) {
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = splits, cluster.val.clusterDim.y = 1, cluster.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid, cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = Geo<BN>::SMEM, cfg.stream = stream;
  cfg.attrs = &cluster, cfg.numAttrs = 1;
  return cfg;
}

template <int BN>
cudaError_t launch(const bf16* x, const int8_t* wq, const WideParams& p, int L, int layers,
                   int splits, cudaStream_t stream) {
  cudaError_t err = configure<BN>();
  if (err != cudaSuccess) return err;
  CUtensorMap mw, mx;
  if ((err = vr2::box_map(&mw, wq, p.N, p.K, L, kStepK, true)) != cudaSuccess ||
      (err = vr2::box_map(&mx, x, p.K, p.M, 0, BN)) != cudaSuccess)
    return err;
  cudaLaunchAttribute cluster;
  const dim3 grid(splits, (p.M + BN - 1) / BN, p.col_tiles * layers);
  const cudaLaunchConfig_t cfg = cluster_config<BN>(cluster, grid, splits, stream);
  if ((err = cudaLaunchKernelEx(&cfg, int8_wide_kernel<BN>, mw, mx, p)) != cudaSuccess)
    return err;
  return cudaGetLastError();
}

// instance BN's residency: out[0] its blocks an SM (the occupancy
// calculator's), out[S] the clusters of S blocks the card holds at once
// (S = 1 .. 16; 0 for a size the card does not schedule)
template <int BN>
cudaError_t layout(int* out) {
  cudaError_t err = configure<BN>();
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[0], int8_wide_kernel<BN>,
                                                        kThreads, Geo<BN>::SMEM);
  if (err != cudaSuccess) return err;
  for (int S = 1; S <= vr2::sk::kMaxSplits; ++S) {
    cudaLaunchAttribute c;
    const cudaLaunchConfig_t f = cluster_config<BN>(c, dim3(S, 1, 1), S, nullptr);
    if (cudaOccupancyMaxActiveClusters(&out[S], int8_wide_kernel<BN>, &f) != cudaSuccess) {
      out[S] = 0;  // a cluster size the card does not schedule: none
      cudaGetLastError();
    }
  }
  return cudaSuccess;
}

}  // namespace wide

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
// x [M, K] bf16, wq [L, K, N] int8, scale [L, N] fp32, y bf16, all
// contiguous and 16-byte aligned. y [layers, M, N]: y[i] = (x @ wq[layer0 +
// i]) * scale[layer0 + i] (the one-layer entry of the wrapper: L = 1; the
// stacked: one layer; the all-layers: every layer).

// The wide kernel: 8 | K, 16 | N, `rows` (32, 64 or 128) x rows a row
// tile, the K steps (64 k each) of each tile cut into `splits` ranges (at
// least 1, at most 16 and at most the steps), the splits of a tile one
// cluster.
extern "C" int vr2_int8_matmul_wide(const void* x, const void* wq, const void* scale, void* y,
                                    int M, int K, int N, int L, int layer0, int layers,
                                    int rows, int splits, void* stream) {
  if (M <= 0 || K <= 0 || K % 8 != 0 || N <= 0 || N % 16 != 0 || L <= 0 || layers <= 0 ||
      layer0 < 0 || layer0 + layers > L || splits < 1 || splits > vr2::sk::kMaxSplits ||
      splits > (K + wide::kStepK - 1) / wide::kStepK)
    return int(cudaErrorInvalidValue);
  const wide::WideParams p{static_cast<bf16*>(y), static_cast<const float*>(scale), M, K, N,
                           layer0, (N + wide::kCols - 1) / wide::kCols};
  const auto* xb = static_cast<const bf16*>(x);
  const auto* w8 = static_cast<const int8_t*>(wq);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (rows) {
    case 32: return int(wide::launch<32>(xb, w8, p, L, layers, splits, st));
    case 64: return int(wide::launch<64>(xb, w8, p, L, layers, splits, st));
    case 128: return int(wide::launch<128>(xb, w8, p, L, layers, splits, st));
    default: return int(cudaErrorInvalidValue);
  }
}

// The wide kernel's residency on the current device, for its 32-, 64- and
// 128-row instances i = 0, 1, 2: out[17 i] its blocks an SM, out[17 i + S]
// the clusters of S blocks the card holds at once (S = 1 .. 16).
extern "C" int vr2_int8_matmul_wide_layout(int* out) {
  cudaError_t err;
  if ((err = wide::layout<32>(out)) != cudaSuccess ||
      (err = wide::layout<64>(out + 17)) != cudaSuccess ||
      (err = wide::layout<128>(out + 34)) != cudaSuccess)
    return int(err);
  return int(cudaSuccess);
}

// The element-load kernel: any K and N.
extern "C" int vr2_int8_matmul_elem(const void* x, const void* wq, const void* scale, void* y,
                                    int M, int K, int N, int L, int layer0, int layers,
                                    void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || L <= 0 || layers <= 0 || layer0 < 0 ||
      layer0 + layers > L)
    return int(cudaErrorInvalidValue);
  const elem::Int8Params p{static_cast<const bf16*>(x), static_cast<const int8_t*>(wq),
                           static_cast<const float*>(scale), static_cast<bf16*>(y),
                           M, K, N, layer0};
  return int(elem::run(p, layers, static_cast<cudaStream_t>(stream)));
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
