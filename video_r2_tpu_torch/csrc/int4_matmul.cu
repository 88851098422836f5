// Int4 weight-only matmul for Hopper (sm_90a): y = x @ dequant(wq, scale).
//
// Replaces the TPU kernel video_r2_tpu/ops/int4_matmul.py::_stacked_kernel4
// (:65, via int4_matmul_stacked), one layer's weights per call (each layer
// of the port is its own module). Same semantics: x [M, K] bf16; wq
// [K/2, N] int8, half-split packed (packed row p holds original row p in
// its low nibble and row p + K/2 in its high nibble, each as q + 8, q in
// [-7, 7]); scale [K/g, N] fp32 for any group g that divides K/2, so scale
// row p / g serves the low nibbles of packed row p and row (p + K/2) / g its
// high nibbles. Each weight is dequantised in fp32, (nibble - 8) * scale,
// and rounded to bf16 before its product, as the TPU kernel casts its
// dequantised tile to x's dtype (scale placement (a): the reference's
// rounding; placement (b), exact q on the tensor cores and each group's
// fp32 sums times its scale, ran 6% faster at the 7B's gate / up and left
// the card tests' tolerance on weights of every code: PERF.md); the
// products sum in fp32 (mma.sync m16n8k16) and y is rounded to bf16 once.
//
// What bounds it on the card: at decode (M = 1 to 16 rows) each weight
// byte serves M products, far below the ~295 operations a byte the card
// needs to be compute-bound, so the packed weights (K N / 2 bytes) and
// their scales (4 K N / g bytes) read once from device memory bound it;
// at the ViT merger's 784 rows the products bound it.
//
// Dequantisation without conversion instructions (both kernels): a nibble
// n placed in the mantissa of the bf16 128 (0x4300 | n, one LOP3 for two)
// is the bf16 128 + n exactly, and one bf16x2 subtract of 136 gives q = n -
// 8 exactly, two weights an instruction. q in fp32 is that bf16 shifted
// into the upper half of a word; q * s in fp32 and one bf16 pack of two
// products (the only conversion left, one a packed byte) give bf16(q s).
//
// The decode kernel (M <= 16 over at least 16 MiB of nibbles, 16 | N,
// 64 | g, 128 | K: the presets' decode gate / up, down and head; the
// wrapper's int4_decode_plan routes):
// - The weights are mma's A operand (the output columns are M, x's rows
//   are N = 8 or 16), so no product is padded past 8 rows of x. A block
//   step is 64 packed rows of a tile of 128 columns; warp w takes rows 16 w
//   .. 16 w + 15, and lane (g, t) the 16 bytes of columns 16 g .. 16 g + 15
//   of rows 4 t .. 4 t + 3. One byte permute of two rows' words puts two
//   columns' bytes of two rows in one word, whose four nibble pairs are the
//   A registers of two output columns (mma rows g and g + 8 are columns 2 i
//   and 2 i + 1 of the lane's 16, mma tile i) for two k (k slots 2t, 2t + 1
//   are rows 4t, 4t + 1; 2t + 8, 2t + 9 rows 4t + 2, 4t + 3) of both
//   halves. x's B fragments are then four consecutive elements of a row of
//   x. The lane's outputs are 16 consecutive columns of two rows of y.
// - Every byte comes by TMA into a ring of 3-5 shared-memory stages (72 KB
//   a block, 3 blocks an SM: 2 and 4 measured slower; ~120 KB in flight an
//   SM): a step's nibbles as
//   one 8 KB box 128 bytes wide with the 128-byte swizzle, x's columns of
//   both halves as two boxes of 8 or 16 rows (rows past M read zeros), the
//   step's scale rows as four 128-byte boxes; warp 0 arms the stage's
//   mbarrier and refills a slot once the block is past it. Each lane reads
//   its bytes back as 16-byte words, a half's 16 column scales as four.
//   Moved in 16-byte cp.async pieces the same bytes took 30 us at gate / up
//   with no products at all (PERF.md).
// - Stream-K: the steps of all tiles, tile after tile, are cut into one
//   contiguous range a block, the block count a multiple of the SM count,
//   so every SM reads the same bytes to within a step a block (8 KB). A
//   block that covers a whole tile stores y; a block that covers part of
//   one adds its warps' sums in shared memory in warp order, writes them to
//   the workspace (two slots a block: the segment at the head of its range
//   and the one at its tail) and takes a ticket on the tile's counter (one
//   acq_rel atomic); the last block adds the tile's parts in block order
//   (16 parts' loads issued before their sums), rounds y to bf16 once and
//   resets the counter. The
//   order is fixed, so y is the same bit for bit from call to call, and a
//   linear stays one launch. The ring, the cut, the close and the cluster
//   helpers of the staged kernel's split-K live in csrc/stream_k.cuh; the
//   int8 decode kernel shares the ring and the cluster close.
//
// The staged kernel (everything else: M > 16, smaller weights such as the
// decode q / o and k / v, where its split-K beats the decode kernel's
// cross-block closes, N not a multiple of 16, g or K/2 of 64): one
// 128-thread block per (64 output columns, 16 / 32 / 64 rows: the smallest
// row capacity that holds M); the packed K streams through a ring of
// shared-memory stages filled by cp.async (8 stages for up to 16 rows, so
// each block keeps ~14 KB of weights and x in flight, enough to cover the
// memory latency), each stage 32 packed rows: 2 KB of nibbles, the
// matching 32 columns of both halves of x and the two scale rows of their
// groups (one group holds 4 stages). Each warp owns 16 output columns and
// takes its mma B fragments by one ldmatrix .trans over byte pairs a
// stage: each word holds two rows' bytes of two columns, whose nibble
// pairs are the B registers of the even column (mma tile 0) and the odd
// one (tile 1) in both halves, so y's columns come four in a row a lane;
// the low nibbles multiply the x tile of the first half, the high nibbles
// that of the second, into one fp32 accumulator; x fragments come by
// ldmatrix. Blocks run over N fastest, so a row-block's
// blocks share x through L2.
// Split-K, in the same launch: where the (column blocks x row blocks) grid
// does not fill the card the wrapper's split plan cuts the K stages into S
// <= 16 ranges of equal length (within one stage), one per grid z, and a
// tile's S blocks form one thread-block cluster. Each block leaves its fp32
// sums in its shared memory; after a cluster barrier each block adds a
// share of the tile's sums over the S blocks' shared memory in a fixed
// order, rounds y to bf16 once and stores it (reduce_splits). The close of
// the 7B's decode k / v, a fence, a ticket and the last block's serial
// reads of 14 parts through L2, took half its time (PERF.md). One split
// takes an instantiation without this code.
// Any N: where 64 does not divide N (the ViT's gate / up, N = 3420) the
// last block zero-fills the weights and scales of its columns past N and
// stores only those below it. A packed row of N bytes is 16-byte aligned
// only when 16 divides N; otherwise the nibbles come in 4-byte copies
// (4 | N) or byte by byte, and the scales in 4-byte copies (4 does not
// divide N). Each case is its own instantiation, and the widths 64 divides
// (every decoder and merger width) keep unpredicated copies and stores.
// Any group: g = 128 (every preset) keeps its own instantiation, the group
// a constant and the two scale rows of a stage staged with it; any other g
// stages no scales and reads each packed row's two scales through L1 where
// its fragment is built.
// fp32 x (the TPU kernel takes f32 activations too) takes a CUDA-core path
// that keeps every operand fp32: each weight dequantised in fp32 and
// multiplied in fp32, y fp32. One thread per output column and up to 8
// rows; a block of 128 columns stages its rows of x, 128 packed rows of both
// halves at a time, in shared memory. No preset runs it on the card.
#include <cuda.h>

#include <atomic>

#include "attn_common.cuh"
#include "stream_k.cuh"
#include "wgmma.cuh"

namespace {

using vr2::sk::once_per_device;

constexpr int kThreads = 128;  // 4 warps side by side over the columns
constexpr int kBN = 64;        // output columns per block, 16 per warp
constexpr int kKS = 32;        // packed rows per stage: 32 k of each half
constexpr int kGroup = 128;    // rows per scale group of the presets (a G of its own)
constexpr int kFineG = 1;      // G: any other g, scales read per packed row
constexpr int kWhole = 64;     // load_stage's WV when 64 divides N
constexpr int kMaxSplits = 16; // splits of a tile at most: a cluster's blocks
constexpr int kRedPitch = kBN + 4;  // fp32 row pitch of a block's sums at the close
constexpr int kPitch = 80;     // shared row pitch in bytes of the staged
                               // nibbles and x tiles: 64 + 16 spreads the
                               // byte reads of a fragment over four bank
                               // groups and keeps ldmatrix conflict-free

// One ring stage for blocks of 16 * MT rows: the packed rows [kKS][kBN]
// (pitch kPitch), the x tiles of both halves [BM][kKS bf16] (pitch kPitch),
// then the low and high scale rows [2][kBN] fp32.
template <int MT>
struct Ring {
  static constexpr int BM = 16 * MT;
  static constexpr int W_BYTES = kKS * kPitch;
  static constexpr int X_BYTES = BM * kPitch;
  static constexpr int S_BYTES = 2 * kBN * 4;
  static constexpr int BYTES = W_BYTES + 2 * X_BYTES + S_BYTES;
  static constexpr int STAGES = MT == 1 ? 8 : MT == 2 ? 6 : 4;
  static constexpr int SMEM = STAGES * BYTES;
};

struct Int4Params {
  const __nv_bfloat16* x;  // [M, K]
  const uint8_t* wq;       // [K/2, N]
  const float* scale;      // [K/g, N]
  __nv_bfloat16* y;        // [M, N]
  float* part;             // the decode kernel's fp32 parts: 2 slots a block
  int* counters;           // ... and its tile counters, 0 between launches
  int M, K, N, g, splits;
};

// Start the copies of stage s (packed rows [32 s, 32 s + 32)) of the block's
// 64 columns from n0 and its rows [row0, row0 + rows) into `st`; columns
// past N are zero-filled. WV: kWhole when 64 divides N (no tail: the copies
// go unpredicated), else the bytes a copy of nibbles, 16 (16 | N), 4 (4 | N)
// or 1. G: kGroup, or kFineG (no scales staged).
template <int MT, int WV, int G>
__device__ __forceinline__ void load_stage(unsigned char* st, const Int4Params& p, int s,
                                           int n0, int row0, int rows, int tid) {
  using R = Ring<MT>;
  const int Kp = p.K / 2, p0 = s * kKS;
  const uint8_t* wrow = p.wq + (long long)p0 * p.N + n0;
  // 32 rows x 64 bytes of nibbles
  if constexpr (WV == kWhole) {  // one 16-byte copy a thread
    const int r = tid >> 2, c = 16 * (tid & 3);
    vr2::cp_async16(st + r * kPitch + c, p.wq + (long long)(p0 + r) * p.N + n0 + c);
  } else if constexpr (WV == 16) {  // the same, predicated
    const int r = tid >> 2, c = 16 * (tid & 3);
    const bool ok = n0 + c < p.N;
    vr2::cp_async_zfill<16>(st + r * kPitch + c, ok ? wrow + (long long)r * p.N + c : p.wq, ok);
  } else if constexpr (WV == 4) {  // four 4-byte copies a thread
#pragma unroll
    for (int i = tid; i < kKS * kBN / 4; i += kThreads) {
      const int r = i >> 4, c = 4 * (i & 15);
      const bool ok = n0 + c < p.N;
      vr2::cp_async_zfill<4>(st + r * kPitch + c, ok ? wrow + (long long)r * p.N + c : p.wq, ok);
    }
  } else {  // 16 bytes a thread, loaded and stored here: the next barrier
            // before this stage is read orders them as it does the copies
#pragma unroll 4
    for (int i = tid; i < kKS * kBN; i += kThreads) {
      const int r = i >> 6, c = i & 63;
      st[r * kPitch + c] = n0 + c < p.N ? wrow[(long long)r * p.N + c] : 0;
    }
  }
  unsigned char* xs = st + R::W_BYTES;
  for (int i = tid; i < 2 * R::BM * 4; i += kThreads) {  // both halves, 4 chunks a row
    const int half = i / (R::BM * 4), r = (i >> 2) % R::BM, c = 16 * (i & 3);
    if (r < rows)
      vr2::cp_async16(xs + half * R::X_BYTES + r * kPitch + c,
                      reinterpret_cast<const unsigned char*>(
                          p.x + (long long)(row0 + r) * p.K + half * Kp + p0) + c);
  }
  float* sc = reinterpret_cast<float*>(st + R::W_BYTES + 2 * R::X_BYTES);
  if constexpr (G == kFineG) {
    return;
  } else if constexpr (WV == kWhole) {  // the two scale rows: 16 chunks of 4 each
    if (tid < 32) {
      const int half = tid >> 4, c = 4 * (tid & 15);
      const int srow = (half * Kp + p0) / kGroup;
      vr2::cp_async16(st + R::W_BYTES + 2 * R::X_BYTES + half * kBN * 4 + 4 * c,
                      p.scale + (long long)srow * p.N + n0 + c);
    }
  } else if constexpr (WV > 1) {  // the same, predicated (4 | N)
    if (tid < 32) {
      const int half = tid >> 4, c = 4 * (tid & 15);
      const int srow = (half * Kp + p0) / kGroup;
      const bool ok = n0 + c < p.N;
      vr2::cp_async_zfill<16>(sc + half * kBN + c,
                              ok ? p.scale + (long long)srow * p.N + n0 + c : p.scale, ok);
    }
  } else {  // one scale a thread
    const int half = tid >> 6, c = tid & 63;
    const int srow = (half * Kp + p0) / kGroup;
    const bool ok = n0 + c < p.N;
    vr2::cp_async_zfill<4>(sc + half * kBN + c,
                           ok ? p.scale + (long long)srow * p.N + n0 + c : p.scale, ok);
  }
}

// The bf16 pair (n0 - 8, n1 - 8) of the nibbles n0, n1 at bits 0-3 and
// 16-19 of v (n0 in the low half), exact: (v & 0x000F000F) | 0x43004300 is
// the pair 128 + n (one LOP3), and 1 * (128 + n) - 136 is exact in bf16
__device__ __forceinline__ uint32_t nib_pair(uint32_t v) {
  const uint32_t biased = (v & 0x000F000Fu) | 0x43004300u;
  uint32_t q;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n"
      : "=r"(q)
      : "r"(biased), "r"(0x3F803F80u), "r"(0xC308C308u));  // bf16 1.0 and -136.0
  return q;
}

// bf16(q0 s0), bf16(q1 s1) of the exact bf16 pair (q0, q1): the products
// in fp32, rounded once, as the reference dequantises (its only conversion)
__device__ __forceinline__ uint32_t scale_pair(uint32_t q, float s0, float s1) {
  return vr2::pack_bf16(__uint_as_float(q << 16) * s0, __uint_as_float(q & 0xFFFF0000u) * s1);
}

// the scales of packed row pr (low nibbles) and pr + K/2 (high) at column
// col, 0 past N: G = kFineG
__device__ __forceinline__ float2 row_scales(const Int4Params& p, int pr, int col) {
  if (col >= p.N) return make_float2(0.f, 0.f);
  const int Kp = p.K / 2;
  return make_float2(__ldg(p.scale + (long long)(pr / p.g) * p.N + col),
                     __ldg(p.scale + (long long)((Kp + pr) / p.g) * p.N + col));
}

// y[row][c .. c + 3] = v rounded to bf16, c a multiple of 4; columns past N
// are dropped (WV == kWhole: none are)
template <int WV>
__device__ __forceinline__ void store_quad(const Int4Params& p, int row, int c,
                                           const float (&v)[4]) {
  __nv_bfloat16* yr = p.y + (long long)row * p.N;
  if (WV == kWhole || (p.N & 3) == 0) {  // c < N means c + 3 < N; 8-byte aligned
    if (WV == kWhole || c < p.N)
      *reinterpret_cast<uint2*>(yr + c) = make_uint2(vr2::pack_bf16(v[0], v[1]),
                                                     vr2::pack_bf16(v[2], v[3]));
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (c + i < p.N) yr[c + i] = __float2bfloat16_rn(v[i]);
  }
}

// The four consecutive columns col0 + 4t .. + 3 of row g (half 0) or g + 8
// (half 1) of row tile mt: the even columns are mma tile 0's, the odd ones
// tile 1's (the B fragments' column order)
template <int MT>
__device__ __forceinline__ void quad(float (&v)[4], const float (&acc)[MT][2][4], int mt,
                                     int half) {
  v[0] = acc[mt][0][2 * half], v[1] = acc[mt][1][2 * half];
  v[2] = acc[mt][0][2 * half + 1], v[3] = acc[mt][1][2 * half + 1];
}

// Split-K's close, in the launch: the splits of a tile are one cluster
// (grid z). Each block leaves its fp32 sums [rows][kBN] in its own shared
// memory; after a cluster barrier block z takes every S-th quad of the
// tile from z on and adds the S blocks' sums of it in the order 0 .. S - 1
// (all S loads issued before the first add), rounds y to bf16 once and
// stores it; a second barrier keeps each block's sums until the others have
// read them. The fixed order makes y the same bit for bit from run to run.
template <int MT, int WV>
__device__ __forceinline__ void reduce_splits(const float (&acc)[MT][2][4], const Int4Params& p,
                                              unsigned char* smem, int n0, int wn0, int row0,
                                              int rows, int lane, int tid) {
  static_assert(Ring<MT>::BM * kRedPitch * 4 <= Ring<MT>::SMEM, "the sums fit in the ring");
  float* red = reinterpret_cast<float*>(smem);
  const int g = lane >> 2, t = lane & 3;
  vr2::cp_async_wait<0>();
  __syncthreads();  // every warp is done with the ring
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float v[4];
      quad<MT>(v, acc, mt, half);
      *reinterpret_cast<float4*>(red + (mt * 16 + g + 8 * half) * kRedPitch + wn0 + 4 * t) =
          make_float4(v[0], v[1], v[2], v[3]);
    }
  vr2::sk::cluster_sync();  // every split's sums are in its shared memory
  const int S = p.splits;
  for (int i = blockIdx.z * kThreads + tid; i < rows * (kBN / 4); i += S * kThreads) {
    const int r = i / (kBN / 4), c = 4 * (i % (kBN / 4));
    const float* at = red + r * kRedPitch + c;
    float4 got[kMaxSplits];
#pragma unroll
    for (int z = 0; z < kMaxSplits; ++z)
      if (z < S) got[z] = vr2::sk::ld_cluster_f4(at, z);
    float v[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int z = 0; z < kMaxSplits; ++z)
      if (z < S) v[0] += got[z].x, v[1] += got[z].y, v[2] += got[z].z, v[3] += got[z].w;
    store_quad<WV>(p, row0 + r, n0 + c, v);
  }
  vr2::sk::cluster_sync();  // no block leaves while another reads its sums
}

template <int MT, int WV, int G, bool SPLIT>
__global__ void __launch_bounds__(kThreads) int4_matmul_kernel(const Int4Params p) {
  using R = Ring<MT>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int n0 = blockIdx.x * kBN, row0 = blockIdx.y * R::BM;
  const int rows = min(R::BM, p.M - row0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r8 = lane & 7, mid = (lane >> 3) & 1, lhi = lane >> 4;
  const int wn0 = warp * 16;
  // split z of the K stages: [first, first + n_stages), the lengths of the
  // splits differing by at most one stage
  const int all_stages = p.K / 2 / kKS, z = blockIdx.z;
  int first = 0, n_stages = all_stages;
  if constexpr (SPLIT) {
    const int base = all_stages / p.splits, rem = all_stages % p.splits;
    first = z * base + min(z, rem), n_stages = base + (z < rem ? 1 : 0);
  }

  // rows past M stay zero in every stage's x tiles (cp.async skips them)
  for (int i = tid; i < R::STAGES * 2 * R::BM * 4; i += kThreads) {
    const int r = (i >> 2) % R::BM;
    if (r >= rows) {
      const int sh = (i >> 2) / R::BM;  // stage * 2 + half
      *reinterpret_cast<uint4*>(smem + (sh >> 1) * R::BYTES + R::W_BYTES +
                                (sh & 1) * R::X_BYTES + r * kPitch + 16 * (i & 3)) =
          make_uint4(0u, 0u, 0u, 0u);
    }
  }
#pragma unroll
  for (int s = 0; s < R::STAGES - 1; ++s) {
    if (s < n_stages)
      load_stage<MT, WV, G>(smem + s * R::BYTES, p, first + s, n0, row0, rows, tid);
    vr2::cp_async_commit();
  }

  float acc[MT][2][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;

  for (int s = 0; s < n_stages; ++s) {
    vr2::cp_async_wait<R::STAGES - 2>();  // stage s has landed
    __syncthreads();                      // ... for every thread; stage s - 1 is free
    const int nx = s + R::STAGES - 1;
    if (nx < n_stages)
      load_stage<MT, WV, G>(smem + (nx % R::STAGES) * R::BYTES, p, first + nx, n0, row0, rows,
                            tid);
    vr2::cp_async_commit();

    const unsigned char* st = smem + (s % R::STAGES) * R::BYTES;
    const unsigned char* xlo = st + R::W_BYTES;
    const unsigned char* xhi = xlo + R::X_BYTES;
    const float* sc = reinterpret_cast<const float*>(xhi + R::X_BYTES);
    // mma tile 0 takes the even columns wn0 + 2g, tile 1 the odd ones
    float slo[2], shi[2];
    if constexpr (G != kFineG) {
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        slo[nt] = sc[wn0 + 2 * g + nt];
        shi[nt] = sc[kBN + wn0 + 2 * g + nt];
      }
    }
    // the warp's 16 columns of the stage's 32 rows by one ldmatrix .trans
    // over byte pairs: word j holds, of rows 8 j + 2t and 8 j + 2t + 1,
    // the bytes of columns wn0 + 2g and + 1, so its nibble pairs are the B
    // registers of both columns and both halves
    uint32_t wt[4];
    vr2::ldsm_x4_trans(wt, st + ((lane >> 3) * 8 + r8) * kPitch + wn0);
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      const uint32_t w0 = wt[2 * ks], w1 = wt[2 * ks + 1];  // k = 2t, +1 | + 8, + 9
      uint32_t blo[2][2], bhi[2][2];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const int sh = 8 * nt;  // the odd column's byte
        const uint32_t q0 = nib_pair(w0 >> sh), q1 = nib_pair(w1 >> sh);
        const uint32_t h0 = nib_pair(w0 >> (sh + 4)), h1 = nib_pair(w1 >> (sh + 4));
        if constexpr (G == kFineG) {  // rows k, k + 1, k + 8, k + 9 may span groups
          const int pr = (first + s) * kKS + ks * 16 + 2 * t, col = n0 + wn0 + 2 * g + nt;
          const float2 s0 = row_scales(p, pr, col), s1 = row_scales(p, pr + 1, col);
          const float2 s8 = row_scales(p, pr + 8, col), s9 = row_scales(p, pr + 9, col);
          blo[nt][0] = scale_pair(q0, s0.x, s1.x);
          blo[nt][1] = scale_pair(q1, s8.x, s9.x);
          bhi[nt][0] = scale_pair(h0, s0.y, s1.y);
          bhi[nt][1] = scale_pair(h1, s8.y, s9.y);
        } else {
          blo[nt][0] = scale_pair(q0, slo[nt], slo[nt]);
          blo[nt][1] = scale_pair(q1, slo[nt], slo[nt]);
          bhi[nt][0] = scale_pair(h0, shi[nt], shi[nt]);
          bhi[nt][1] = scale_pair(h1, shi[nt], shi[nt]);
        }
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int off = (mt * 16 + r8 + 8 * mid) * kPitch + ks * 32 + 16 * lhi;
        uint32_t a[4];
        vr2::ldsm_x4(a, xlo + off);
        vr2::mma_bf16_16816(acc[mt][0], a, blo[0][0], blo[0][1]);
        vr2::mma_bf16_16816(acc[mt][1], a, blo[1][0], blo[1][1]);
        vr2::ldsm_x4(a, xhi + off);
        vr2::mma_bf16_16816(acc[mt][0], a, bhi[0][0], bhi[0][1]);
        vr2::mma_bf16_16816(acc[mt][1], a, bhi[1][0], bhi[1][1]);
      }
    }
  }

  if constexpr (SPLIT) {
    reduce_splits<MT, WV>(acc, p, smem, n0, wn0, row0, rows, lane, tid);
    return;
  }
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = mt * 16 + g + 8 * half;
      if (r >= rows) continue;
      float v[4];
      quad<MT>(v, acc, mt, half);
      store_quad<WV>(p, row0 + r, n0 + wn0 + 4 * t, v);
    }
}

template <int MT, int WV, int G, bool SPLIT>
cudaError_t launch_kernel(const Int4Params& p, cudaStream_t stream) {
  using R = Ring<MT>;
  static std::atomic<uint64_t> done{0};
  cudaError_t err = once_per_device(done, [] {
    cudaError_t e = cudaFuncSetAttribute(int4_matmul_kernel<MT, WV, G, SPLIT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, R::SMEM);
    if (e == cudaSuccess && SPLIT)  // clusters of up to 16 blocks, past the portable 8
      e = cudaFuncSetAttribute(int4_matmul_kernel<MT, WV, G, SPLIT>,
                               cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    return e;
  });
  if (err != cudaSuccess) return err;
  const dim3 grid((p.N + kBN - 1) / kBN, (p.M + R::BM - 1) / R::BM, p.splits);
  if constexpr (!SPLIT) {
    int4_matmul_kernel<MT, WV, G, SPLIT><<<grid, kThreads, R::SMEM, stream>>>(p);
  } else {  // the splits of a tile form one cluster
    cudaLaunchAttribute cluster;
    cluster.id = cudaLaunchAttributeClusterDimension;
    cluster.val.clusterDim.x = 1, cluster.val.clusterDim.y = 1;
    cluster.val.clusterDim.z = p.splits;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = grid, cfg.blockDim = dim3(kThreads), cfg.dynamicSmemBytes = R::SMEM;
    cfg.stream = stream, cfg.attrs = &cluster, cfg.numAttrs = 1;
    if ((err = cudaLaunchKernelEx(&cfg, int4_matmul_kernel<MT, WV, G, SPLIT>, p)) != cudaSuccess)
      return err;
  }
  return cudaGetLastError();
}

// one split takes the instantiation without the split code (it cost the
// gate / up shape 8% on the card)
template <int MT, int WV, int G = kGroup>
cudaError_t launch(const Int4Params& p, cudaStream_t stream) {
  return p.splits > 1 ? launch_kernel<MT, WV, G, true>(p, stream)
                      : launch_kernel<MT, WV, G, false>(p, stream);
}

// the copy width of the nibbles by N's alignment (a row is N bytes); groups
// other than 128 take the whole-tile copies or the byte loads
template <int MT>
cudaError_t launch_rows(const Int4Params& p, cudaStream_t stream) {
  if (p.g != kGroup) {
    const bool whole = p.N % kBN == 0;
    return whole ? launch<MT, kWhole, kFineG>(p, stream) : launch<MT, 1, kFineG>(p, stream);
  }
  if (p.N % kBN == 0) return launch<MT, kWhole>(p, stream);
  if (p.N % 16 == 0) return launch<MT, 16>(p, stream);
  if (p.N % 4 == 0) return launch<MT, 4>(p, stream);
  return launch<MT, 1>(p, stream);
}

// The decode kernel (M <= 16): the weights as mma's A operand fed by a TMA
// ring, stream-K over (tile, step); see the file's header.
namespace dec {

using vr2::kSwizzleAlign;

constexpr int kWarps = 4;                // warps a block: 16 packed rows of a step each
constexpr int kThreads = 32 * kWarps;
constexpr int kCols = 128;               // output columns of a tile: a 128-byte box row
constexpr int kStepRows = 16 * kWarps;   // packed rows of a step
constexpr int kScaleBox = 32;            // fp32 columns of a scale box (128 bytes)
constexpr int kBlocksPerSm = 3;          // the shared memory below keeps it at 3

// One ring stage for MT 8-row tiles of x, each part a TMA box (1024-byte
// aligned, as the 128-byte swizzle needs): the nibbles [64 packed rows]
// [128 bytes] (swizzled), x's rows of both halves [8 MT][64 bf16]
// (swizzled; rows past M read zeros), the scales [4 boxes][half][32
// columns] fp32 (the step's group of each half)
template <int MT>
struct Ring {
  static constexpr int W_BYTES = kStepRows * 128;
  static constexpr int X_BYTES = 8 * MT * 128;
  static constexpr int S_BYTES = 2 * kCols * 4;
  static constexpr int BYTES = W_BYTES + 2 * X_BYTES + S_BYTES;
  static constexpr int STAGES = MT == 1 ? 5 : 3;        // 72 KB a block either way
  static constexpr int RED = kWarps * 8 * MT * kCols * 4;   // the warps' fp32 sums
  static constexpr int SMEM = kSwizzleAlign + STAGES * BYTES + RED + STAGES * 8;
  static_assert(BYTES % kSwizzleAlign == 0, "stages stay 1024-byte aligned");
};

template <int MT>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
    int4_decode_kernel(__grid_constant__ const CUtensorMap mw,
                       __grid_constant__ const CUtensorMap mx,
                       __grid_constant__ const CUtensorMap ms, const Int4Params p) {
  using R = Ring<MT>;
  constexpr int ROWS = 8 * MT;
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int Kp = p.K / 2, ks = Kp / kStepRows, tiles = (p.N + kCols - 1) / kCols;
  const int U = tiles * ks, G = gridDim.x, b = blockIdx.x;
  const int u0 = vr2::sk::range_begin(b, U, G), u1 = vr2::sk::range_begin(b + 1, U, G);
  unsigned char* ring = vr2::swizzle_aligned(smem);
  float* red = reinterpret_cast<float*>(ring + R::STAGES * R::BYTES);
  uint64_t* full = reinterpret_cast<uint64_t*>(red + R::RED / 4);

  float acc[8][MT][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int jt = 0; jt < MT; ++jt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][jt][e] = 0.f;

  // unit u into its stage: the nibbles of tile T, rows [64 j, 64 j + 64),
  // x's columns of both halves, the scales of the step's group in both
  // halves (warp 0)
  auto fill = [&](int u, unsigned char* st, uint64_t* bar) {
    const int T = u / ks, pr = (u - T * ks) * kStepRows;
    vr2::tma_stage(bar, R::BYTES, 3 + kCols / kScaleBox, [&](int bx) {
      if (bx == 0)
        vr2::tma_load_2d(st, &mw, bar, T * kCols, pr);
      else if (bx < 3)
        vr2::tma_load_2d(st + R::W_BYTES + (bx - 1) * R::X_BYTES, &mx, bar,
                         (bx - 1) * Kp + pr, 0);
      else
        vr2::tma_load_3d(st + R::W_BYTES + 2 * R::X_BYTES + (bx - 3) * 2 * kScaleBox * 4, &ms,
                         bar, T * kCols + (bx - 3) * kScaleBox, pr / p.g, 0);
    });
  };

  // this warp's products of a step: rows 16 w + 4 t + j of its columns
  auto compute = [&](const unsigned char* st) {
    uint32_t r[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int row = 16 * w + 4 * t + j;
      const uint4 v = *reinterpret_cast<const uint4*>(st + row * 128 + ((g ^ (row & 7)) << 4));
      r[j][0] = v.x, r[j][1] = v.y, r[j][2] = v.z, r[j][3] = v.w;
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      // x: row 8 jt + g, k 16 w + 4 t .. + 3 of the step (bytes 32 w + 8 t)
      uint2 xf[MT];
#pragma unroll
      for (int jt = 0; jt < MT; ++jt) {
        const int m = 8 * jt + g;
        xf[jt] = *reinterpret_cast<const uint2*>(st + R::W_BYTES + half * R::X_BYTES + m * 128 +
                                                 (((2 * w + (t >> 1)) ^ (m & 7)) << 4) +
                                                 (t & 1) * 8);
      }
      // the half's scales of the lane's columns 16 g .. 16 g + 15: 64 bytes
      // of scale box g / 2, four 16-byte loads (a quarter warp's two
      // column groups land on other banks)
      float4 sc[4];
#pragma unroll
      for (int q = 0; q < 4; ++q)
        sc[q] = *reinterpret_cast<const float4*>(st + R::W_BYTES + 2 * R::X_BYTES +
                                                 (g >> 1) * 2 * kScaleBox * 4 +
                                                 half * kScaleBox * 4 + (g & 1) * 64 + q * 16);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        // columns 2i, 2i + 1 of rows 0, 1 (2, 3): bytes [c, c + 1] of each
        // row; the half's nibble of each byte
        const uint32_t sel = (i & 1) ? 0x7632u : 0x5410u;
        const int sh = 4 * half;
        const uint32_t v01 = __byte_perm(r[0][i >> 1], r[1][i >> 1], sel) >> sh;
        const uint32_t v23 = __byte_perm(r[2][i >> 1], r[3][i >> 1], sel) >> sh;
        const float s0 = (i & 1) ? sc[i >> 1].z : sc[i >> 1].x;  // column 2i
        const float s1 = (i & 1) ? sc[i >> 1].w : sc[i >> 1].y;  // column 2i + 1
        uint32_t a[4];
        a[0] = scale_pair(nib_pair(v01), s0, s0), a[1] = scale_pair(nib_pair(v01 >> 8), s1, s1);
        a[2] = scale_pair(nib_pair(v23), s0, s0), a[3] = scale_pair(nib_pair(v23 >> 8), s1, s1);
#pragma unroll
        for (int jt = 0; jt < MT; ++jt) vr2::mma_bf16_16816(acc[i][jt], a, xf[jt].x, xf[jt].y);
      }
    }
  };

  // a tile segment's close: this warp's sums into its rows of red, then
  // (close_segment) the warps' sums in warp order and y or the block's part
  auto flush = [&](int T, int sa, int sb) {
    float* mine = red + w * ROWS * kCols;
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int jt = 0; jt < MT; ++jt) {
        const int r0 = 8 * jt + 2 * t, c = 16 * g + 2 * i;
        if (r0 < p.M)
          *reinterpret_cast<float2*>(mine + r0 * kCols + c) = make_float2(acc[i][jt][0], acc[i][jt][2]);
        if (r0 + 1 < p.M)
          *reinterpret_cast<float2*>(mine + (r0 + 1) * kCols + c) =
              make_float2(acc[i][jt][1], acc[i][jt][3]);
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][jt][e] = 0.f;
      }
    const vr2::sk::Out out{p.y, p.part, p.counters, nullptr, p.M, p.N};
    vr2::sk::close_segment<ROWS, kWarps>(out, red, T, sa, sb, u0, U, G, ks);
  };

  vr2::sk::decode_ring<R::STAGES, R::BYTES>(ring, full, u0, u1, ks, fill, compute, flush, &mw,
                                             &mx, &ms);
}

// the shared memory and the carveout that keep kBlocksPerSm blocks an SM,
// set once a device
template <int MT>
cudaError_t configure() {
  static std::atomic<uint64_t> done{0};
  return once_per_device(done, [] {
    cudaError_t err = cudaFuncSetAttribute(int4_decode_kernel<MT>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           Ring<MT>::SMEM);
    if (err != cudaSuccess) return err;
    return cudaFuncSetAttribute(int4_decode_kernel<MT>,
                                cudaFuncAttributePreferredSharedMemoryCarveout,
                                int(cudaSharedmemCarveoutMaxShared));
  });
}

template <int MT>
cudaError_t launch(const Int4Params& p, int blocks, cudaStream_t stream) {
  using R = Ring<MT>;
  cudaError_t err = configure<MT>();
  if (err != cudaSuccess) return err;
  const int Kp = p.K / 2, groups = Kp / p.g;
  CUtensorMap mw, mx, ms;
  const cuuint64_t wd[2] = {cuuint64_t(p.N), cuuint64_t(Kp)}, ws[1] = {cuuint64_t(p.N)};
  const cuuint32_t wb[2] = {kCols, kStepRows};
  const cuuint64_t sd[3] = {cuuint64_t(p.N), cuuint64_t(groups), 2};
  const cuuint64_t ss[2] = {cuuint64_t(p.N) * 4, cuuint64_t(p.N) * 4 * groups};
  const cuuint32_t sb[3] = {kScaleBox, 1, 2};
  if ((err = vr2::sk::tiled_map(&mw, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, p.wq, wd, ws, wb, true)) !=
          cudaSuccess ||
      (err = vr2::box_map(&mx, p.x, p.K, p.M, 0, 8 * MT)) != cudaSuccess ||
      (err = vr2::sk::tiled_map(&ms, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, p.scale, sd, ss, sb,
                                false)) != cudaSuccess)
    return err;
  int4_decode_kernel<MT><<<blocks, kThreads, R::SMEM, stream>>>(mw, mx, ms, p);
  return cudaGetLastError();
}

}  // namespace dec

constexpr int kF32Rows = 8;     // rows of x (and y) per fp32 block
constexpr int kF32Chunk = 128;  // packed rows of x staged at a time

template <int ROWS>
__global__ void __launch_bounds__(kThreads) int4_matmul_f32_kernel(
    const float* __restrict__ x, const uint8_t* __restrict__ wq,
    const float* __restrict__ scale, float* __restrict__ y, int M, int K, int N, int g) {
  __shared__ float xs[2][ROWS][kF32Chunk];  // [half][row][packed row]
  const int n = blockIdx.x * kThreads + threadIdx.x;
  const int m0 = blockIdx.y * ROWS;
  const int Kp = K / 2;
  float acc[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) acc[r] = 0.f;
  for (int p0 = 0; p0 < Kp; p0 += kF32Chunk) {
    const int len = min(kF32Chunk, Kp - p0);
    __syncthreads();  // every thread is done with the previous chunk
    for (int i = threadIdx.x; i < 2 * ROWS * kF32Chunk; i += kThreads) {
      const int c = i % kF32Chunk, r = (i / kF32Chunk) % ROWS, half = i / (kF32Chunk * ROWS);
      xs[half][r][c] = (m0 + r < M && c < len)
                           ? x[(long long)(m0 + r) * K + half * Kp + p0 + c]
                           : 0.f;
    }
    __syncthreads();
    if (n >= N) continue;
    for (int c = 0; c < len; ++c) {
      const int pr = p0 + c;
      const int b = wq[(long long)pr * N + n];
      const float lo = float((b & 15) - 8) * scale[(long long)(pr / g) * N + n];
      const float hi = float((b >> 4) - 8) * scale[(long long)((pr + Kp) / g) * N + n];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) acc[r] = fmaf(xs[1][r][c], hi, fmaf(xs[0][r][c], lo, acc[r]));
    }
  }
  if (n >= N) return;
#pragma unroll
  for (int r = 0; r < ROWS; ++r)
    if (m0 + r < M) y[(long long)(m0 + r) * N + n] = acc[r];
}

}  // namespace

// Plain C entry point, loaded with ctypes. x [M, K] bf16, wq [K/2, N] int8,
// scale [K/g, N] fp32, y [M, N] bf16, all contiguous and 16-byte aligned;
// K a multiple of 64, g dividing K/2, any N >= 1, 1 <= M. blocks > 0: the
// decode kernel on that many blocks (M <= 16, 16 | N, 64 | g, 128 | K; at
// most one block a step of 64 packed rows x 128 columns), part an fp32
// workspace of 2 blocks M 128 floats and counters one int a 128-column
// tile, all 0 (the launch leaves them 0). blocks = 0: the staged kernel, its
// K stages (32 packed rows each) cut into `splits` ranges (at most 16), one
// per grid z, the splits of a tile one cluster; part and counters unused.
// Returns a cudaError_t.
extern "C" int vr2_int4_matmul(const void* x, const void* wq, const void* scale, void* y,
                               int M, int K, int N, int g, int splits, void* part,
                               void* counters, int blocks, void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || g <= 0 || K % (2 * kKS) != 0 || (K / 2) % g != 0 ||
      splits <= 0 || splits > K / (2 * kKS) || splits > kMaxSplits || blocks < 0 ||
      (blocks > 0 && (part == nullptr || counters == nullptr)))
    return int(cudaErrorInvalidValue);
  const Int4Params p{static_cast<const __nv_bfloat16*>(x), static_cast<const uint8_t*>(wq),
                     static_cast<const float*>(scale), static_cast<__nv_bfloat16*>(y),
                     static_cast<float*>(part), static_cast<int*>(counters), M, K, N, g,
                     splits};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (blocks > 0) {
    const long long steps = (long long)(N + dec::kCols - 1) / dec::kCols * (K / 2 / dec::kStepRows);
    if (M > 16 || N % 16 != 0 || g % dec::kStepRows != 0 || (K / 2) % dec::kStepRows != 0 ||
        splits != 1 || blocks > steps)
      return int(cudaErrorInvalidValue);
    return int(M <= 8 ? dec::launch<1>(p, blocks, st) : dec::launch<2>(p, blocks, st));
  }
  if (M <= 16) return int(launch_rows<1>(p, st));
  if (M <= 32) return int(launch_rows<2>(p, st));
  return int(launch_rows<4>(p, st));
}

// The decode kernel's resident blocks an SM on the current device (the
// occupancy calculator's count, which the wrapper's stream-K plan takes as
// its blocks an SM) for 8 and 16 rows of x into out[0], out[1]. Returns a
// cudaError_t.
extern "C" int vr2_int4_matmul_layout(int* out) {
  cudaError_t err;
  if ((err = dec::configure<1>()) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &out[0], dec::int4_decode_kernel<1>, dec::kThreads, dec::Ring<1>::SMEM)) !=
          cudaSuccess ||
      (err = dec::configure<2>()) != cudaSuccess)
    return int(err);
  return int(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &out[1], dec::int4_decode_kernel<2>, dec::kThreads, dec::Ring<2>::SMEM));
}

// The same for fp32 x and y (y [M, N] fp32); the same conditions.
extern "C" int vr2_int4_matmul_f32(const void* x, const void* wq, const void* scale, void* y,
                                   int M, int K, int N, int g, void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || g <= 0 || K % (2 * kKS) != 0 || (K / 2) % g != 0)
    return int(cudaErrorInvalidValue);
  const dim3 grid((N + kThreads - 1) / kThreads, (M + kF32Rows - 1) / kF32Rows);
  int4_matmul_f32_kernel<kF32Rows><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const uint8_t*>(wq),
      static_cast<const float*>(scale), static_cast<float*>(y), M, K, N, g);
  return int(cudaGetLastError());
}
