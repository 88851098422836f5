// Shared device pieces of the port's kernels: the bf16 tensor-core product
// and its fragment helpers, ldmatrix, cp.async, warp reductions and the
// bf16-to-fp32 unpacking of staged rows.
//
// Every product is one warp-wide mma.sync.m16n8k16 (bf16 in, fp32 out). With
// lane = 4 * g + t (g = lane / 4, t = lane % 4) its operands sit as follows:
//   A (16x16, row-major), 4 x b32:  a0 = A[g][2t..2t+1]    a1 = A[g+8][2t..2t+1]
//                                   a2 = A[g][2t+8..+9]    a3 = A[g+8][2t+8..+9]
//   B (16x8,  "col": B[k][n]), 2 x b32: b0 = B[2t..2t+1][g]  b1 = B[2t+8..+9][g]
//   C (16x8,  fp32), 4 x f32:       c0,c1 = C[g][2t..2t+1]  c2,c3 = C[g+8][2t..2t+1]
// so the C tiles of two neighbouring 8-column blocks of S are exactly the A
// operand of the next product P @ V, and P never leaves registers.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace vr2 {

constexpr int kWarp = 32;

__device__ __forceinline__ void mma_bf16_16816(float (&d)[4], const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two bf16 from consecutive addresses (lower address in the low half)
__device__ __forceinline__ uint32_t ld_pair(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// A operand of rows [r0, r0 + 16) and columns [c0, c0 + 16) of a row-major
// bf16 tile in shared memory; `p` points at tile[r0 + g][c0 + 2t]
__device__ __forceinline__ void ld_a_frag(uint32_t (&a)[4], const __nv_bfloat16* p,
                                          int pitch) {
  a[0] = ld_pair(p);
  a[1] = ld_pair(p + 8 * pitch);
  a[2] = ld_pair(p + 8);
  a[3] = ld_pair(p + 8 * pitch + 8);
}

// The C tiles of two neighbouring 8-column blocks (16 x 16 fp32) rounded to
// the bf16 A operand of the next product
__device__ __forceinline__ void c_to_a(uint32_t (&a)[4], const float (&c0)[4],
                                       const float (&c1)[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

// Four 8x8 tiles of 16-byte rows from shared memory; lane l gives the row
// address of tile l / 8 and receives 32-bit word l % 4 of row l / 4 of each.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// 16-byte asynchronous copy from device to shared memory (both 16-byte
// aligned), and its commit / wait of the most recent groups
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most N of the committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// 16 bytes of bf16 (8 values) as fp32, unpacked with shifts so the chunk
// stays in registers (bf16 widens exactly)
__device__ __forceinline__ void chunk_to_float(const __nv_bfloat16* src, float* dst) {
  const uint4 u = *reinterpret_cast<const uint4*>(src);
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    dst[2 * i] = __uint_as_float(w[i] << 16);              // lower address
    dst[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// 4 consecutive bf16 (8 bytes) as fp32
__device__ __forceinline__ float4 quad_to_float(const __nv_bfloat16* src) {
  const uint2 u = *reinterpret_cast<const uint2*>(src);
  return make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
}

// max / sum over the 4 lanes of a quad (the lanes that share a C row)
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Copy a [rows, HD] bf16 tile whose rows are `row_stride` elements apart in
// global memory into shared memory with row pitch `pitch`; rows at or past
// `valid_rows` are zero. 16-byte vector accesses: HD, the strides and the
// base address must be multiples of 8 elements (the wrappers check).
template <int HD>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, int pitch,
                                          const __nv_bfloat16* src,
                                          long long row_stride, int rows,
                                          int valid_rows, int tid, int nthreads) {
  constexpr int kChunks = HD / 8;
  for (int i = tid; i < rows * kChunks; i += nthreads) {
    const int r = i / kChunks, c = (i % kChunks) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (r < valid_rows) v = *reinterpret_cast<const uint4*>(src + r * row_stride + c);
    *reinterpret_cast<uint4*>(dst + r * pitch + c) = v;
  }
}

// Same, stored transposed: dst[c * pitch + r] = src[r][c], so that the P @ V
// product reads its B operand (V[key][d] over two consecutive keys) as one
// 32-bit shared load.
template <int HD>
__device__ __forceinline__ void load_tile_transposed(__nv_bfloat16* dst, int pitch,
                                                     const __nv_bfloat16* src,
                                                     long long row_stride, int rows,
                                                     int valid_rows, int tid,
                                                     int nthreads) {
  constexpr int kChunks = HD / 8;
  for (int i = tid; i < rows * kChunks; i += nthreads) {
    const int r = i / kChunks, c = (i % kChunks) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (r < valid_rows) v = *reinterpret_cast<const uint4*>(src + r * row_stride + c);
    const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&v);
#pragma unroll
    for (int j = 0; j < 8; ++j) dst[(c + j) * pitch + r] = e[j];
  }
}

}  // namespace vr2
