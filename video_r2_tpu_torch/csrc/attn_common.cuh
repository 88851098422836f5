// Shared device pieces of the port's kernels: the bf16 tensor-core product
// and its fragment helpers, ldmatrix, cp.async, warp reductions and the
// int8-to-bf16 unpacking of staged rows.
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

// The same, each tile transposed: lane l receives, from each tile, the
// elements [2 (l % 4)][l / 4] and [2 (l % 4) + 1][l / 4]
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// Four int8 values of one 32-bit word, bytes (k, n) = (0, 0), (0, 1),
// (1, 0), (1, 1), as the bf16 pairs of column n = 0 (`even`: bytes 0 and 2)
// and n = 1 (`odd`: bytes 1 and 3), k = 0 in the low half. Exact, with no
// conversion instruction: byte ^ 0x80 placed in the mantissa of 2^23 gives
// the float 2^23 + q + 128 (one byte permute), minus 2^23 + 128 gives q
// exactly, and its upper 16 bits are bf16(q), as |q| <= 128 needs 8
// significant bits (a second permute packs two).
__device__ __forceinline__ void int8_pairs(uint32_t w, uint32_t& even, uint32_t& odd) {
  const uint32_t u = w ^ 0x80808080u;  // q + 128 in each byte
  constexpr float kMagic = 8388736.f;  // 2^23 + 128
  const float f0 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650)) - kMagic;
  const float f1 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7651)) - kMagic;
  const float f2 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7652)) - kMagic;
  const float f3 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7653)) - kMagic;
  even = __byte_perm(__float_as_uint(f0), __float_as_uint(f2), 0x7632);
  odd = __byte_perm(__float_as_uint(f1), __float_as_uint(f3), 0x7632);
}

// 16-byte asynchronous copy from device to shared memory (both 16-byte
// aligned), and its commit / wait of the most recent groups
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

// Asynchronous copy of BYTES (4 or 16) that reads them from `gmem` when
// `valid` and zero-fills them otherwise (gmem must then still be a mapped
// address: callers pass the operand's base)
template <int BYTES>
__device__ __forceinline__ void cp_async_zfill(void* smem, const void* gmem, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int src = valid ? BYTES : 0;
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
                 "r"(src));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(s), "l"(gmem),
                 "n"(BYTES), "r"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most N of the committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// 2^x by the special-function unit (ex2.approx, flush to zero): the exp of
// the softmax as exp(x) = 2^(x log2 e), log2 e folded into the operands
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
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

// max / sum over the 4 lanes of a quad (the lanes that share a C row)
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

}  // namespace vr2
