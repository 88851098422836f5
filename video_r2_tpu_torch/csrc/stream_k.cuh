// Shared pieces of the decode kernels that stream weights by TMA
// (csrc/int4_matmul.cu, csrc/int8_matmul.cu, and csrc/moe_ffn.cu's int8
// decode instances): the once-a-device setting of a kernel's function
// attributes, tensor maps of any element type, the ring that feeds a block's
// range of (tile, step) units, the int8 weights' A fragments and x's B
// fragments of a k16 step, the stream-K cut of a launch's units into block
// ranges with its fixed-order close through a workspace and a ticket, and
// the thread-block cluster's barrier and shared-memory reads that close a
// split-K tile without either.
//
// A tile is kCols = 128 output columns of y [M, N] (M <= 16 rows); a step is
// one ring stage of a tile's K. Stream-K cuts the U = tiles x steps units,
// tile after tile, into G contiguous ranges, one a block: a block that
// covers a whole tile stores it; a block that covers part of one writes its
// fp32 part to the workspace (two slots a block: the segment at the head of
// its range and the one at its tail) and takes a ticket on the tile's
// counter; the tile's last block adds the parts in block order and resets
// the counter, so y is the same bit for bit from call to call.
#pragma once

#include <cuda.h>

#include <atomic>

#include "attn_common.cuh"
#include "wgmma.cuh"

namespace vr2 {
namespace sk {

constexpr int kCols = 128;     // output columns of a tile: a 128-byte box row of bytes
constexpr int kThreads = 128;  // threads of a decode block: one a tile column at the close
constexpr int kMaxSplits = 16; // blocks of a split-K cluster at most

// Run `set` (a kernel's function attributes, which hold per device) the
// first time a launcher runs on the current device, and not on later calls:
// `done` holds a bit a device (devices past 63 set theirs every call)
template <typename F>
cudaError_t once_per_device(std::atomic<uint64_t>& done, F set) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const uint64_t bit = dev < 64 ? uint64_t(1) << dev : 0;
  if (done.load(std::memory_order_acquire) & bit) return cudaSuccess;
  if ((err = set()) == cudaSuccess) done.fetch_or(bit, std::memory_order_release);
  return err;
}

// A tensor map of `rank` dims (innermost first) with strides in bytes of
// dims 1.., boxes `box`, the 128-byte swizzle or none; coordinates past
// the end read zeros
inline cudaError_t tiled_map(CUtensorMap* map, CUtensorMapDataType type, int rank,
                             const void* base, const cuuint64_t* dims,
                             const cuuint64_t* strides, const cuuint32_t* box, bool swizzle) {
  const EncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint32_t one[3] = {1, 1, 1};
  const CUresult r = encode(map, type, rank, const_cast<void*>(base), dims, strides, box, one,
                            CU_TENSOR_MAP_INTERLEAVE_NONE,
                            swizzle ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// fetch a tensor map's descriptor ahead of its first box
__device__ __forceinline__ void prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

// A block's ring over its units [u0, u1), ks units (steps) a tile, STAGES
// stages of BYTES from `ring`, a barrier a stage at `full`: thread 0 sets
// up the barriers and fetches the tensor maps' descriptors ahead of the
// first box; warp 0 keeps STAGES units in flight (fill(u, stage, barrier)
// issues unit u's boxes); the block multiplies each unit once its boxes
// have landed (compute(stage)) and warp 0 refills the slot once every warp
// is past it; each tile segment [sa, sb) ends with flush(T, sa, sb). Tile
// segment by tile segment, so the steps' loop stays small (the close inside
// it ran the int4 kernel ~2x slower on the card).
template <int STAGES, int BYTES, class Fill, class Compute, class Flush, class... Maps>
__device__ __forceinline__ void decode_ring(unsigned char* ring, uint64_t* full, int u0, int u1,
                                            int ks, Fill fill, Compute compute, Flush flush,
                                            const Maps*... maps) {
  if (threadIdx.x == 0) {
    for (int i = 0; i < STAGES; ++i) mbar_init(full + i, 1);
    mbar_init_fence();
    (prefetch_map(maps), ...);
  }
  __syncthreads();
  const int n = u1 - u0;
  if (threadIdx.x < 32)
    for (int s = 0; s < STAGES && s < n; ++s) fill(u0 + s, ring + s * BYTES, full + s);
  for (int sa = u0, s = 0; sa < u1;) {
    const int T = sa / ks, sb = min(u1, (T + 1) * ks);
    for (; u0 + s < sb; ++s) {
      const int slot = s % STAGES;
      mbar_wait(full + slot, (s / STAGES) & 1);
      compute(ring + slot * BYTES);
      __syncthreads();  // every warp is past the slot
      if (threadIdx.x < 32 && s + STAGES < n)
        fill(u0 + s + STAGES, ring + slot * BYTES, full + slot);
    }
    flush(T, sa, sb);
    sa = sb;
  }
}

// x's B fragments of k16 step kk of a swizzled box [8 MT rows][64 bf16 k]:
// token tiles jt, jt + 1 by one ldmatrix (matrices: n lo / k lo, n lo / k
// hi, n hi / k lo, n hi / k hi)
template <int MT>
__device__ __forceinline__ void x_b_frags(uint32_t (&b)[MT][2], const unsigned char* xs, int kk,
                                          int lane) {
  const int r8 = lane & 7, j4 = lane >> 3;
#pragma unroll
  for (int jt = 0; jt < MT; jt += 2) {
    uint32_t r[4];
    const int row = jt * 8 + r8 + (MT > 1 ? 8 * (j4 >> 1) : 0);
    ldsm_x4(r, sw128_at(xs, row, kk * 32 + 16 * (j4 & 1)));
    b[jt][0] = r[0], b[jt][1] = r[1];
    if constexpr (MT > 1) b[jt + 1][0] = r[2], b[jt + 1][1] = r[3];
  }
}

// The A fragments of int8 weights over k [k0, k0 + 16) and columns [c0, c0
// + 32) of a swizzled box [k][128 bytes]. ldmatrix cannot transpose bytes,
// so it takes 16-bit pairs (two columns' bytes of one k) transposed
// (matrices: k lo / columns 0-15, k lo / 16-31, k hi / 0-15, k hi / 16-31),
// and int8_pairs splits each word into the exact bf16 pairs of its even
// and its odd column: the A fragments of two mma tiles (mma rows g and g +
// 8 are columns c0 + 2g (+ 1) and c0 + 16 + 2g (+ 1))
__device__ __forceinline__ void int8_a_frags(uint32_t (&even)[4], uint32_t (&odd)[4],
                                             const unsigned char* box, int k0, int c0,
                                             int lane) {
  const int r8 = lane & 7, j4 = lane >> 3;
  uint32_t wr[4];
  ldsm_x4_trans(wr, sw128_at(box, k0 + r8 + 8 * (j4 >> 1), c0 + 16 * (j4 & 1)));
#pragma unroll
  for (int i = 0; i < 4; ++i) int8_pairs(wr[i], even[i], odd[i]);
}

// the block that owns unit u of U cut into G ranges [b U / G, (b + 1) U / G)
__device__ __forceinline__ int owner(int u, int U, int G) {
  return int(((long long)(u + 1) * G + U - 1) / U) - 1;
}

__device__ __forceinline__ int range_begin(int b, int U, int G) {
  return int((long long)b * U / G);
}

// the output side of a decode launch
struct Out {
  __nv_bfloat16* y;    // [M, N]
  float* part;         // stream-K: 2 slots a block of M x kCols fp32
  int* counters;       // stream-K: one a tile, 0 between launches
  const float* scale;  // [N] fp32 multiplied into each sum before its rounding, or null
  int M, N;
};

__device__ __forceinline__ float4 scaled(float4 v, const Out& o, int col) {
  if (o.scale == nullptr) return v;
  const float4 s = __ldg(reinterpret_cast<const float4*>(o.scale + col));
  return make_float4(v.x * s.x, v.y * s.y, v.z * s.z, v.w * s.w);
}

// A tile segment's close: red holds SLABS slabs of sums [slab][row]
// [column]; they are added in slab order, then the whole tile's y is
// stored, or the block's part is written to its workspace slot (the head
// or the tail of its range) and a ticket taken on the tile's counter; the
// tile's last block adds the parts in block order (each thread a row and
// four columns, 16 parts' loads issued before their sums), rounds y to bf16
// once and resets the counter. 16 | N.
template <int ROWS, int SLABS>
__device__ __forceinline__ void close_segment(const Out& o, const float* red, int T, int sa,
                                              int sb, int u0, int U, int G, int ks) {
  __shared__ int last;
  const int tid = threadIdx.x, b = blockIdx.x;
  __syncthreads();
  const int col = T * kCols + tid;
  float v[ROWS];
#pragma unroll
  for (int m = 0; m < ROWS; ++m) {
    v[m] = 0.f;
    if (m < o.M)
#pragma unroll
      for (int ww = 0; ww < SLABS; ++ww) v[m] += red[(ww * ROWS + m) * kCols + tid];
  }
  const int tb = T * ks, te = tb + ks;
  if (sa == tb && sb == te) {  // the whole tile
    if (col < o.N) {
      const float s = o.scale == nullptr ? 1.f : __ldg(o.scale + col);
#pragma unroll
      for (int m = 0; m < ROWS; ++m)
        if (m < o.M)
          o.y[(long long)m * o.N + col] = __float2bfloat16_rn(v[m] * s);
    }
  } else {
    const long long slot_floats = (long long)o.M * kCols;
    const int slot = T == u0 / ks ? 2 * b : 2 * b + 1;
#pragma unroll
    for (int m = 0; m < ROWS; ++m)
      if (m < o.M) o.part[slot * slot_floats + m * kCols + tid] = v[m];
    // the block's part is written; one atomic with release and acquire
    // semantics (after the barrier, so it orders the whole block's part)
    // takes the ticket, in the last warp: warp 0 keeps the ring's TMA
    // boxes in flight (a fence and an atomic there measured 1% slower)
    __syncthreads();
    const int bf = owner(tb, U, G), bl = owner(te - 1, U, G);
    if (tid == kThreads - 1) {  // release this block's part, acquire the others'
      int old;
      asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], 1;\n"
                   : "=r"(old)
                   : "l"(o.counters + T)
                   : "memory");
      last = old == bl - bf;
    }
    __syncthreads();
    if (last) {  // row tid / 32 (+ 4 k) of columns 4 (tid % 32) .. + 3, PB parts at a time
      constexpr int PB = 16;
      const int c4 = 4 * (tid & 31);
      for (int r = tid >> 5; r < o.M; r += kThreads / 32) {
        float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
        for (int c0 = bf; c0 <= bl; c0 += PB) {
          float4 got[PB];
#pragma unroll
          for (int k = 0; k < PB; ++k) {
            const int c = c0 + k;
            const int cs = (c == bf && range_begin(c, U, G) < tb) ? 2 * c + 1 : 2 * c;
            got[k] = c <= bl ? __ldcg(reinterpret_cast<const float4*>(
                                   o.part + cs * slot_floats + r * kCols + c4))
                             : make_float4(0.f, 0.f, 0.f, 0.f);
          }
#pragma unroll
          for (int k = 0; k < PB; ++k)
            sum.x += got[k].x, sum.y += got[k].y, sum.z += got[k].z, sum.w += got[k].w;
        }
        if (T * kCols + c4 < o.N) {  // 16 | N: all four columns or none
          sum = scaled(sum, o, T * kCols + c4);
          *reinterpret_cast<uint2*>(o.y + (long long)r * o.N + T * kCols + c4) =
              make_uint2(pack_bf16(sum.x, sum.y), pack_bf16(sum.z, sum.w));
        }
      }
      if (tid == kThreads - 1) o.counters[T] = 0;
    }
  }
  __syncthreads();  // red is free for the next segment
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// the float4 at `local`'s offset in the shared memory of the cluster's block `rank`
__device__ __forceinline__ float4 ld_cluster_f4(const float* local, int rank) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(local));
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(remote) : "r"(addr), "r"(rank));
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(remote)
               : "memory");
  return v;
}

// A split-K tile's close, the S splits of tile T one cluster (rank z =
// blockIdx.z): each block's sums [row][column] are in red (pitch kCols);
// after a cluster barrier block z takes every S-th quad of the tile from z
// on and adds the S blocks' sums of it in the order 0 .. S - 1 (all S
// loads issued before the first add), scales, rounds y to bf16 once and
// stores it; a second barrier keeps each block's sums until the others have
// read them. An unsplit tile (S = 1) reads its own sums after a block
// barrier, with no cluster barrier or remote read. 16 | N.
__device__ __forceinline__ void close_cluster(const Out& o, const float* red, int T, int S) {
  if (S > 1)
    cluster_sync();  // every split's sums are in its shared memory
  else
    __syncthreads();
  for (int i = blockIdx.z * kThreads + threadIdx.x; i < o.M * (kCols / 4); i += S * kThreads) {
    const int r = i / (kCols / 4), c4 = 4 * (i % (kCols / 4));
    const float* at = red + r * kCols + c4;
    float4 got[kMaxSplits];
#pragma unroll
    for (int z = 0; z < kMaxSplits; ++z)
      if (z < S) got[z] = S > 1 ? ld_cluster_f4(at, z) : *reinterpret_cast<const float4*>(at);
    float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int z = 0; z < kMaxSplits; ++z)
      if (z < S) sum.x += got[z].x, sum.y += got[z].y, sum.z += got[z].z, sum.w += got[z].w;
    const int col = T * kCols + c4;
    if (col < o.N) {
      sum = scaled(sum, o, col);
      *reinterpret_cast<uint2*>(o.y + (long long)r * o.N + col) =
          make_uint2(pack_bf16(sum.x, sum.y), pack_bf16(sum.z, sum.w));
    }
  }
  if (S > 1) cluster_sync();  // no block leaves while another reads its sums
}

}  // namespace sk
}  // namespace vr2
