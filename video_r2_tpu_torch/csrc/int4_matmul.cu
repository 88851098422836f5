// Int4 weight-only matmul for Hopper (sm_90a): y = x @ dequant(wq, scale).
//
// Replaces the TPU kernel video_r2_tpu/ops/int4_matmul.py::_stacked_kernel4
// (:65, via int4_matmul_stacked), one layer's weights per call (each layer
// of the port is its own module). Same semantics: x [M, K] bf16; wq
// [K/2, N] int8, half-split packed (packed row p holds original row p in
// its low nibble and row p + K/2 in its high nibble, each as q + 8, q in
// [-7, 7]); scale [K/g, N] fp32 for any group g that divides K/2, so scale
// row p / g serves the low nibbles of packed row p and row (p + K/2) / g its
// high nibbles. Each
// weight is dequantised in fp32, (nibble - 8) * scale, and rounded to bf16
// before its product, as the TPU kernel casts its dequantised tile to x's
// dtype; the products sum in fp32 (mma.sync m16n8k16) and y is rounded to
// bf16 once.
//
// What bounds it on the card: at decode (M = 1 to 16 rows) each weight
// byte serves M products, far below the ~295 operations a byte the card
// needs to be compute-bound, so the packed weights (K N / 2 bytes) and
// their scales (4 K N / g bytes) read once from device memory bound it;
// at the ViT merger's 784 rows the products bound it.
// What the design does about it: one 128-thread block per (64 output
// columns, 16 / 32 / 64 rows: the smallest row capacity that holds M); the
// packed K streams through a ring of shared-memory stages filled by
// cp.async (8 stages for up to 16 rows, so each block keeps ~14 KB of
// weights and x in flight, enough to cover the memory latency), each stage
// 32 packed rows: 2 KB of nibbles, the matching 32 columns of both halves
// of x and the two scale rows of their groups (one group holds 4 stages).
// Each warp owns 16 output columns and builds its mma B fragments straight
// from the staged bytes (unsigned: the storage is signed int8, and the TPU
// kernel masks with & 15 after an arithmetic shift): the low nibbles
// multiply the x tile of the first half, the high nibbles that of the
// second, into one fp32 accumulator; x fragments come by ldmatrix. Blocks
// run over N fastest, so a row-block's blocks share x through L2.
// Split-K, in the same launch: where the (column blocks x row blocks) grid
// does not fill the card (the decode shapes at small N: 8 blocks at k / v,
// 56 at q / o and down, on 132 SMs) the wrapper's split plan cuts the K
// stages into S ranges of equal length (within one stage), one per grid z,
// so ~3 blocks an SM (2 and 4 measured slower at the down projection) each
// walk a short chain of stages: at 4 rows a stage's time is the latency of
// issuing its copies, not its bytes. Each block writes its fp32 sums to a
// [S, M, N] workspace and takes a ticket on its tile's counter; the last
// block adds the S sums in a fixed order, rounds y to bf16 once and resets
// the counter (reduce_splits), so y is the same bit for bit from run to run
// and a linear stays one launch. One split takes an instantiation without
// this code. TMA and wgmma are later work.
// Any N: where 64 does not divide N (the ViT's gate / up, N = 3420) the
// last block zero-fills the weights and scales of its columns past N and
// stores only those below it. A packed row of N bytes is 16-byte aligned
// only when 16 divides N; otherwise the nibbles come in 4-byte copies
// (4 | N) or byte by byte, and the scales in 4-byte copies (4 does not
// divide N). Each case is its own instantiation, and the widths 64 divides
// (every decoder and merger width) keep unpredicated copies and stores:
// predicated copies slowed the latency-bound decode shapes on the card.
// Any group: g = 128 (every preset) keeps its own instantiation, the group
// a constant and the two scale rows of a stage staged with it; any other g
// (no preset uses one) stages no scales and reads each packed row's two
// scales through L1 where its fragment is built.
// fp32 x (the TPU kernel takes f32 activations too) takes a CUDA-core path
// that keeps every operand fp32: each weight dequantised in fp32 and
// multiplied in fp32, y fp32. One thread per output column and up to 8
// rows; a block of 128 columns stages its rows of x, 128 packed rows of both
// halves at a time, in shared memory. No preset runs it on the card.
#include "attn_common.cuh"

namespace {

constexpr int kThreads = 128;  // 4 warps side by side over the columns
constexpr int kBN = 64;        // output columns per block, 16 per warp
constexpr int kKS = 32;        // packed rows per stage: 32 k of each half
constexpr int kGroup = 128;    // rows per scale group of the presets (a G of its own)
constexpr int kFineG = 1;      // G: any other g, scales read per packed row
constexpr int kWhole = 64;     // load_stage's WV when 64 divides N
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
  float* part;             // [splits, M, N] fp32 partial sums (splits > 1)
  int* counters;           // one per (column block, row block), 0 between launches
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

__device__ __forceinline__ float nib(unsigned u, float s) {
  return static_cast<float>(static_cast<int>(u & 15u) - 8) * s;
}

// the scales of packed row pr (low nibbles) and pr + K/2 (high) at column
// col, 0 past N: G = kFineG
__device__ __forceinline__ float2 row_scales(const Int4Params& p, int pr, int col) {
  if (col >= p.N) return make_float2(0.f, 0.f);
  const int Kp = p.K / 2;
  return make_float2(__ldg(p.scale + (long long)(pr / p.g) * p.N + col),
                     __ldg(p.scale + (long long)((Kp + pr) / p.g) * p.N + col));
}

// y[row][c], y[row][c + 1] = (lo, hi) rounded to bf16, c even; columns past N
// are dropped (WV == kWhole: none are)
template <int WV>
__device__ __forceinline__ void store_pair(const Int4Params& p, int row, int c, float lo,
                                           float hi) {
  __nv_bfloat16* yr = p.y + (long long)row * p.N;
  if constexpr (WV == kWhole) {
    *reinterpret_cast<uint32_t*>(yr + c) = vr2::pack_bf16(lo, hi);
  } else if ((p.N & 1) == 0) {  // c < N means c + 1 < N; the pair is 4-byte aligned
    if (c < p.N) *reinterpret_cast<uint32_t*>(yr + c) = vr2::pack_bf16(lo, hi);
  } else {
    if (c < p.N) yr[c] = __float2bfloat16_rn(lo);
    if (c + 1 < p.N) yr[c + 1] = __float2bfloat16_rn(hi);
  }
}

// Split-K's close, in the launch: each block writes its fp32 sums to its
// split's slice of p.part, then takes a ticket on its tile's counter; the
// block that takes the last one adds the splits' sums in the order 0 ..
// splits - 1 (through L2: other blocks wrote them), rounds y to bf16 once
// and sets the counter back to 0. The fixed order makes y the same bit for
// bit from run to run.
template <int MT, int WV>
__device__ __forceinline__ void reduce_splits(const float (&acc)[MT][2][4], const Int4Params& p,
                                              int col0, int row0, int rows, int lane,
                                              int tid) {
  __shared__ int last;
  const int g = lane >> 2, t = lane & 3;
  const long long slice = (long long)p.M * p.N;
  float* part = p.part + blockIdx.z * slice;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = mt * 16 + g + 8 * half;
      if (r >= rows) continue;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const int c = col0 + nt * 8 + 2 * t;
        float* pr = part + (long long)(row0 + r) * p.N + c;
        if (WV == kWhole || (p.N & 1) == 0) {  // an even N keeps the pair 8-byte aligned
          if (c < p.N)
            *reinterpret_cast<float2*>(pr) =
                make_float2(acc[mt][nt][2 * half], acc[mt][nt][2 * half + 1]);
        } else {
          if (c < p.N) pr[0] = acc[mt][nt][2 * half];
          if (c + 1 < p.N) pr[1] = acc[mt][nt][2 * half + 1];
        }
      }
    }
  __threadfence();  // this block's sums, before its ticket
  __syncthreads();
  int* counter = p.counters + blockIdx.y * gridDim.x + blockIdx.x;
  if (tid == 0) last = atomicAdd(counter, 1) == p.splits - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();  // every other block's sums, after their tickets
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = mt * 16 + g + 8 * half;
      if (r >= rows) continue;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const int c = col0 + nt * 8 + 2 * t;
        const float* pr = p.part + (long long)(row0 + r) * p.N + c;
        float lo = 0.f, hi = 0.f;
        for (int z = 0; z < p.splits; ++z, pr += slice) {
          if (c < p.N) lo += __ldcg(pr);
          if (c + 1 < p.N) hi += __ldcg(pr + 1);
        }
        store_pair<WV>(p, row0 + r, c, lo, hi);
      }
    }
  if (tid == 0) *counter = 0;
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
    float slo[2], shi[2];
    if constexpr (G != kFineG) {
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        slo[nt] = sc[wn0 + nt * 8 + g];
        shi[nt] = sc[kBN + wn0 + nt * 8 + g];
      }
    }
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      // B fragments (k = ks * 16 + 2t, +1 | +8, +9; column g of each tile)
      uint32_t blo[2][2], bhi[2][2];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const unsigned char* c = st + (ks * 16 + 2 * t) * kPitch + wn0 + nt * 8 + g;
        const unsigned u0 = c[0], u1 = c[kPitch], u2 = c[8 * kPitch], u3 = c[9 * kPitch];
        if constexpr (G == kFineG) {  // rows k, k + 1, k + 8, k + 9 may span groups
          const int pr = (first + s) * kKS + ks * 16 + 2 * t, col = n0 + wn0 + nt * 8 + g;
          const float2 s0 = row_scales(p, pr, col), s1 = row_scales(p, pr + 1, col);
          const float2 s8 = row_scales(p, pr + 8, col), s9 = row_scales(p, pr + 9, col);
          blo[nt][0] = vr2::pack_bf16(nib(u0, s0.x), nib(u1, s1.x));
          blo[nt][1] = vr2::pack_bf16(nib(u2, s8.x), nib(u3, s9.x));
          bhi[nt][0] = vr2::pack_bf16(nib(u0 >> 4, s0.y), nib(u1 >> 4, s1.y));
          bhi[nt][1] = vr2::pack_bf16(nib(u2 >> 4, s8.y), nib(u3 >> 4, s9.y));
        } else {
          blo[nt][0] = vr2::pack_bf16(nib(u0, slo[nt]), nib(u1, slo[nt]));
          blo[nt][1] = vr2::pack_bf16(nib(u2, slo[nt]), nib(u3, slo[nt]));
          bhi[nt][0] = vr2::pack_bf16(nib(u0 >> 4, shi[nt]), nib(u1 >> 4, shi[nt]));
          bhi[nt][1] = vr2::pack_bf16(nib(u2 >> 4, shi[nt]), nib(u3 >> 4, shi[nt]));
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
    reduce_splits<MT, WV>(acc, p, n0 + wn0, row0, rows, lane, tid);
    return;
  }
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = mt * 16 + g + 8 * half;
      if (r >= rows) continue;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const int c = n0 + wn0 + nt * 8 + 2 * t;  // even
        store_pair<WV>(p, row0 + r, c, acc[mt][nt][2 * half], acc[mt][nt][2 * half + 1]);
      }
    }
}

template <int MT, int WV, int G, bool SPLIT>
cudaError_t launch_kernel(const Int4Params& p, cudaStream_t stream) {
  using R = Ring<MT>;
  cudaError_t err = cudaFuncSetAttribute(int4_matmul_kernel<MT, WV, G, SPLIT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, R::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.N + kBN - 1) / kBN, (p.M + R::BM - 1) / R::BM, p.splits);
  int4_matmul_kernel<MT, WV, G, SPLIT><<<grid, kThreads, R::SMEM, stream>>>(p);
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
// K a multiple of 64, g dividing K/2, any N >= 1, 1 <= M. splits: the K
// stages (32 packed rows each) are cut into this many ranges, one per grid
// z; with splits > 1, part is an fp32 [splits, M, N] workspace and counters
// one int per (column block, row block) tile, all 0 (the launch leaves them
// 0). Returns a cudaError_t.
extern "C" int vr2_int4_matmul(const void* x, const void* wq, const void* scale, void* y,
                               int M, int K, int N, int g, int splits, void* part,
                               void* counters, void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || g <= 0 || K % (2 * kKS) != 0 || (K / 2) % g != 0 ||
      splits <= 0 || splits > K / (2 * kKS) ||
      (splits > 1 && (part == nullptr || counters == nullptr)))
    return int(cudaErrorInvalidValue);
  const Int4Params p{static_cast<const __nv_bfloat16*>(x), static_cast<const uint8_t*>(wq),
                     static_cast<const float*>(scale), static_cast<__nv_bfloat16*>(y),
                     static_cast<float*>(part), static_cast<int*>(counters), M, K, N, g,
                     splits};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M <= 16) return int(launch_rows<1>(p, st));
  if (M <= 32) return int(launch_rows<2>(p, st));
  return int(launch_rows<4>(p, st));
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
