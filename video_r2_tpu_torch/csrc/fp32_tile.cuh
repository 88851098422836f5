// CUDA-core fp32 products for the fp32 instances of the MoE kernels (the
// grouped expert FFN and the GMM backward) and of the attention kernels
// (flash forward and backward, window forward and backward): one
// 256-thread block forms a 64 x 64 fp32 tile of A B over K, 16 k a step
// through shared memory, each thread a 4 x 4 piece (rows 4 (tid / 16) + i,
// columns 4 (tid % 16) + j). Simple and block-cooperative: no preset runs
// these instances (every preset is bf16); they give an fp32 model (the
// tiny test config among them) the f32 arithmetic of the JAX kernels,
// which cast their tiles to f32 whatever the operands' dtype. Operands are
// read one element at a time, so any stride and any K (a head dim of 12)
// will do; rows past an operand's end read as zero.
#pragma once

#include <cuda_runtime.h>

namespace vr2 {
namespace f32 {

constexpr int kThreads = 256;
constexpr int kTile = 64;  // output rows and columns of a block
constexpr int kK = 16;     // k per step

using Acc = float[4][4];

// One operand of a product, seen as [kTile, K]: element (i, k) is
// p[i * ld + k] when K_CONTIG (k contiguous), else p[k * ld + i]; rows at
// or past n read as zero (and are never read)
template <bool K_CONTIG>
struct Operand {
  const float* p;
  long long ld;
  int n;
};

struct Smem {
  float a[kK][kTile + 4];
  float b[kK][kTile + 4];
};

// k [k0, k0 + 16) of an operand into dst[k][i]; consecutive threads read
// consecutive addresses along the operand's contiguous dimension
template <bool KC>
__device__ __forceinline__ void stage(float (&dst)[kK][kTile + 4], const Operand<KC>& o, int k0,
                                      int K, int tid) {
#pragma unroll
  for (int idx = tid; idx < kTile * kK; idx += kThreads) {
    const int i = KC ? idx / kK : idx % kTile, k = KC ? idx % kK : idx / kTile;
    float v = 0.f;
    if (i < o.n && k0 + k < K)
      v = KC ? o.p[(long long)i * o.ld + k0 + k] : o.p[(long long)(k0 + k) * o.ld + i];
    dst[k][i] = v;
  }
}

// acc += A B^T over K for the block's tile (A and B both [kTile, K]: A's
// rows are the tile's rows, B's its columns)
template <bool AKC, bool BKC>
__device__ __forceinline__ void product(Acc& acc, const Operand<AKC>& a, const Operand<BKC>& b,
                                        int K, Smem& sm) {
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  for (int k0 = 0; k0 < K; k0 += kK) {
    stage(sm.a, a, k0, K, tid);
    stage(sm.b, b, k0, K, tid);
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kK; ++k) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = sm.a[k][4 * ty + i], bv[i] = sm.b[k][4 * tx + i];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
}

// A 64 x 64 tile in shared memory (a pitch of 65 words keeps a column's
// reads off one bank), e.g. the probabilities of one key tile: as an
// operand, Operand<true>{&t[0][0], kTile + 1, rows} reads it row-major and
// Operand<false>{&t[0][0], kTile + 1, cols} transposed
using Tile = float[kTile][kTile + 1];

// the thread's piece of acc into t (rows 4 ty + i, columns 4 tx + j)
__device__ __forceinline__ void to_tile(Tile& t, const Acc& acc) {
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) t[4 * ty + i][4 * tx + j] = acc[i][j];
}

// max / sum over the 16 threads that hold one row of the tile (a half-warp;
// every thread of the warp calls it)
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ void zero(Acc& acc) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
}

}  // namespace f32
}  // namespace vr2
