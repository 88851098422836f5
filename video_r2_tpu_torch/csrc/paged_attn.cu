// Paged decode attention for Hopper (sm_90a): one decode token, or a W-token
// verify chunk, per sequence, reading its keys and values through a page
// table out of the stacked page pool [L, kh, N_pages, page_size, hd].
//
// Replaces the TPU kernels video_r2_tpu/ops/paged_attention.py::
// _paged_decode_kernel_stacked (:91, bf16 pages) and
// _paged_decode_kernel_stacked_quant (:166, int8 pages with fp32
// per-(token, head) scale pages), and, over a one-layer view of the pool,
// _paged_decode_kernel (:30). Same semantics: the layer index picks the
// layer of the pool; query i of the chunk (row w * g + j for query head
// h * g + j) admits keys < lengths[b] + i; the int8 scales factor out of
// both products (s = (q . k_int8) * k_scale, and P times the v scale before
// P @ V, as the TPU kernel's :227 and :237); online softmax in fp32; the
// output is the accumulator over max(l, 1e-30). A row that admits no key
// emits 0.
//
// What bounds it on the card: every key and value row of a sequence is read
// once per kv head, against 4 * W * g * hd FLOP per key (g = 7 at 7B), so
// the work is bound by device memory (3.35 TB/s), far below the tensor
// cores' rate. What the design does about it: one 256-thread block per
// (sequence, kv head) holds its W * g query rows in shared memory (fp32,
// pre-scaled) and walks the cdiv(L + W - 1, page_size) pages of its table
// row; each page's K and V rows that hold admitted keys are staged in
// shared memory by cp.async, double-buffered, so the next page streams in
// while this one is reduced. The products are fp32 FMA (W * g is 7 or 28,
// no tensor-core tile shape, and the math stays the TPU kernel's fp32):
// scores one key per thread, the softmax one row per warp, P @ V four head
// dims per thread, each launch instantiated for the smallest row capacity
// (8, 16, 32, 64) that holds its W * g rows. Int8 values convert to fp32 exactly. B * kh blocks (32
// at B = 8 on 7B) fill a quarter of the 132 SMs: splitting a sequence's
// pages across blocks (flash-decoding) is later work.
#include <cmath>

#include "attn_common.cuh"

namespace {

constexpr int NTHREADS = 256;
constexpr int NWARPS = NTHREADS / 32;
constexpr int MAX_ROWS = 64;  // W * g query rows per block

struct PagedParams {
  const __nv_bfloat16* q;  // [B, W, nh, hd] contiguous
  const void* k;           // [L, kh, N, ps, hd] contiguous, bf16 or int8
  const void* v;
  const float* k_scale;    // [L, kh, N, ps] (int8 pages) or null
  const float* v_scale;
  __nv_bfloat16* o;        // [B, W, nh, hd] contiguous
  const int* tables;       // [B, max_pages]
  const int* lengths;      // [B]
  int W, nh, kh, num_pages, max_pages, layer;
  float scale;
};

template <bool Quant>
struct PageElem {
  using T = __nv_bfloat16;
};
template <>
struct PageElem<true> {
  using T = int8_t;
};

using vr2::chunk_to_float;
using vr2::cp_async16;
using vr2::cp_async_commit;
using vr2::quad_to_float;
using vr2::warp_max;
using vr2::warp_sum;

// One page's shared-memory stage: K rows with a pitch of HD + 16 bytes (so
// the 16-byte row reads of neighbouring threads fall on distinct banks),
// V rows unpadded, then (int8) the page's k and v scales.
template <int HD, int PS, bool Quant>
struct Stage {
  using T = typename PageElem<Quant>::T;
  static constexpr int EPC = 16 / sizeof(T);  // elements per 16-byte chunk
  static constexpr int KP = HD + EPC;         // K row pitch, elements
  static constexpr int K_BYTES = PS * KP * sizeof(T);
  static constexpr int V_BYTES = PS * HD * sizeof(T);
  static constexpr int BYTES = K_BYTES + V_BYTES + (Quant ? 2 * PS * 4 : 0);
};

// Start the copies of the first `rows` rows of page `pid` (layer p.layer,
// kv head h) into `stage`.
template <int HD, int PS, bool Quant>
__device__ __forceinline__ void load_page(unsigned char* stage, const PagedParams& p,
                                          int h, int pid, int rows) {
  using S = Stage<HD, PS, Quant>;
  using T = typename S::T;
  constexpr int CH = HD / S::EPC;  // 16-byte chunks per row
  if ((unsigned)pid >= (unsigned)p.num_pages) __trap();  // a table entry off the pool
  const long long page = ((long long)p.layer * p.kh + h) * p.num_pages + pid;
  const T* gk = static_cast<const T*>(p.k) + page * PS * HD;
  const T* gv = static_cast<const T*>(p.v) + page * PS * HD;
  T* sk = reinterpret_cast<T*>(stage);
  T* sv = reinterpret_cast<T*>(stage + S::K_BYTES);
  for (int i = threadIdx.x; i < rows * CH; i += NTHREADS) {
    const int r = i / CH, c = (i % CH) * S::EPC;
    cp_async16(sk + r * S::KP + c, gk + r * HD + c);
    cp_async16(sv + r * HD + c, gv + r * HD + c);
  }
  if (Quant) {
    float* sks = reinterpret_cast<float*>(stage + S::K_BYTES + S::V_BYTES);
    const float* gks = p.k_scale + page * PS;
    const float* gvs = p.v_scale + page * PS;
    for (int i = threadIdx.x; i < (rows + 3) / 4; i += NTHREADS) {
      cp_async16(sks + 4 * i, gks + 4 * i);
      cp_async16(sks + PS + 4 * i, gvs + 4 * i);
    }
  }
}

// 16 bytes of int8 page values as fp32 (int8 converts exactly; the bf16
// overload is in attn_common.cuh), unpacked with shifts
__device__ __forceinline__ void chunk_to_float(const int8_t* src, float* dst) {
  const uint4 u = *reinterpret_cast<const uint4*>(src);
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j)  // byte j, sign-extended
      dst[4 * i + j] = static_cast<float>(static_cast<int>(w[i] << (24 - 8 * j)) >> 24);
  }
}

// 4 consecutive int8 page values as fp32
__device__ __forceinline__ float4 quad_to_float(const int8_t* src) {
  const unsigned w = *reinterpret_cast<const unsigned*>(src);
  return make_float4(static_cast<float>(static_cast<int>(w << 24) >> 24),
                     static_cast<float>(static_cast<int>(w << 16) >> 24),
                     static_cast<float>(static_cast<int>(w << 8) >> 24),
                     static_cast<float>(static_cast<int>(w) >> 24));
}

// MR: the block's row capacity (W * g <= MR), so that the unrolled per-row
// loops carry no more rows than the launch has.
template <int HD, int PS, int MR, bool Quant>
__global__ void __launch_bounds__(NTHREADS) paged_decode_kernel(const PagedParams p) {
  using S = Stage<HD, PS, Quant>;
  using T = typename S::T;
  constexpr int QK_GROUPS = NTHREADS / PS;  // key j = tid % PS, rows by tid / PS
  constexpr int QK_RPT = (MR + QK_GROUPS - 1) / QK_GROUPS;
  constexpr int PV_LANES = HD / 4;          // dims 4 * (tid % PV_LANES) .. +3
  constexpr int PV_GROUPS = NTHREADS / PV_LANES;
  constexpr int PV_RPT = (MR + PV_GROUPS - 1) / PV_GROUPS;
  extern __shared__ __align__(16) unsigned char smem[];

  const int b = blockIdx.x, h = blockIdx.y, tid = threadIdx.x;
  const int g = p.nh / p.kh, R = p.W * g;
  float* sQ = reinterpret_cast<float*>(smem + 2 * S::BYTES);  // [R, HD], scaled
  float* sS = sQ + R * HD;                                     // [R, PS] scores / P
  float* sM = sS + R * PS;                                     // running max
  float* sL = sM + R;                                          // running sum
  float* sA = sL + R;                                          // this page's rescale

  const int L = p.lengths[b];
  const int n_keys = min(L + p.W - 1, p.max_pages * PS);  // the last query's bound
  const int n_pages = n_keys > 0 ? (n_keys + PS - 1) / PS : 0;
  const int* table = p.tables + (long long)b * p.max_pages;

  if (n_pages > 0) load_page<HD, PS, Quant>(smem, p, h, table[0], min(PS, n_keys));
  cp_async_commit();

  for (int i = tid; i < R * HD; i += NTHREADS) {
    const int r = i / HD, d = i % HD;
    const int w = r / g, j = r % g;
    sQ[i] = __bfloat162float(p.q[(((long long)b * p.W + w) * p.nh + h * g + j) * HD + d]) *
            p.scale;
  }
  for (int r = tid; r < R; r += NTHREADS) {
    sM[r] = -INFINITY;
    sL[r] = 0.f;
  }
  __syncthreads();  // the queries and row stats, also when no page is read

  const int d = 4 * (tid % PV_LANES), pv_grp = tid / PV_LANES;
  float4 acc[PV_RPT];
#pragma unroll
  for (int i = 0; i < PV_RPT; ++i) acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int pg = 0; pg < n_pages; ++pg) {
    unsigned char* stage = smem + (pg & 1) * S::BYTES;
    const int k0 = pg * PS;
    const int valid = min(PS, n_keys - k0);  // rows of this page that were loaded
    if (pg + 1 < n_pages)
      load_page<HD, PS, Quant>(smem + ((pg + 1) & 1) * S::BYTES, p, h, table[pg + 1],
                               min(PS, n_keys - k0 - PS));
    cp_async_commit();
    vr2::cp_async_wait<1>();  // this page's group has landed
    __syncthreads();

    const T* sk = reinterpret_cast<const T*>(stage);
    const T* sv = reinterpret_cast<const T*>(stage + S::K_BYTES);
    const float* sks = reinterpret_cast<const float*>(stage + S::K_BYTES + S::V_BYTES);

    // scores: thread (key j, row group); s = q . k (times the k scale), masked
    {
      const int j = tid % PS, grp = tid / PS;
      float s[QK_RPT];
#pragma unroll
      for (int i = 0; i < QK_RPT; ++i) s[i] = 0.f;
      if (j < valid) {
        const T* kr = sk + j * S::KP;
#pragma unroll 2
        for (int c = 0; c < HD; c += S::EPC) {
          float kf[S::EPC];
          chunk_to_float(kr + c, kf);
#pragma unroll
          for (int i = 0; i < QK_RPT; ++i) {
            const int r = grp + i * QK_GROUPS;
            if (r < R) {
              const float4* qr = reinterpret_cast<const float4*>(sQ + r * HD + c);
#pragma unroll
              for (int e = 0; e < S::EPC / 4; ++e) {
                const float4 a = qr[e];
                s[i] += a.x * kf[4 * e] + a.y * kf[4 * e + 1] + a.z * kf[4 * e + 2] +
                        a.w * kf[4 * e + 3];
              }
            }
          }
        }
      }
      const float ks = (Quant && j < valid) ? sks[j] : 1.f;
#pragma unroll
      for (int i = 0; i < QK_RPT; ++i) {
        const int r = grp + i * QK_GROUPS;
        if (r < R) {
          const bool ok = j < valid && k0 + j < L + r / g;
          sS[r * PS + j] = ok ? s[i] * ks : -INFINITY;
        }
      }
    }
    __syncthreads();

    // online softmax, one row per warp: P = exp(s - m) (times the v scale)
    {
      const int warp = tid / 32, lane = tid % 32;
      for (int r = warp; r < R; r += NWARPS) {
        float* row = sS + r * PS;
        float mx = -INFINITY;
        for (int j = lane; j < PS; j += 32) mx = fmaxf(mx, row[j]);
        mx = warp_max(mx);
        const float m_old = sM[r];
        const float m_new = fmaxf(m_old, mx);
        const float mref = (m_new == -INFINITY) ? 0.f : m_new;  // no admitted key yet
        float sum = 0.f;
        for (int j = lane; j < PS; j += 32) {
          const float e = __expf(row[j] - mref);
          sum += e;
          row[j] = Quant ? (j < valid ? e * sks[PS + j] : 0.f) : e;
        }
        sum = warp_sum(sum);
        if (lane == 0) {
          const float alpha = __expf(m_old - mref);
          sA[r] = alpha;
          sL[r] = sL[r] * alpha + sum;
          sM[r] = m_new;
        }
      }
    }
    __syncthreads();

    // O = O * alpha + P @ V over the loaded rows, four head dims per thread
    {
#pragma unroll
      for (int i = 0; i < PV_RPT; ++i) {
        const int r = pv_grp + i * PV_GROUPS;
        if (r < R) {
          const float a = sA[r];
          acc[i].x *= a;
          acc[i].y *= a;
          acc[i].z *= a;
          acc[i].w *= a;
        }
      }
#pragma unroll 4
      for (int j = 0; j < valid; ++j) {
        const float4 vv = quad_to_float(sv + j * HD + d);
#pragma unroll
        for (int i = 0; i < PV_RPT; ++i) {
          const int r = pv_grp + i * PV_GROUPS;
          if (r < R) {
            const float pj = sS[r * PS + j];
            acc[i].x += pj * vv.x;
            acc[i].y += pj * vv.y;
            acc[i].z += pj * vv.z;
            acc[i].w += pj * vv.w;
          }
        }
      }
    }
    __syncthreads();  // every thread is done with this stage and sS
  }

#pragma unroll
  for (int i = 0; i < PV_RPT; ++i) {
    const int r = pv_grp + i * PV_GROUPS;
    if (r < R) {
      const float inv = 1.f / fmaxf(sL[r], 1e-30f);
      const int w = r / g, j = r % g;
      __nv_bfloat162* op = reinterpret_cast<__nv_bfloat162*>(
          p.o + (((long long)b * p.W + w) * p.nh + h * g + j) * HD + d);
      op[0] = __floats2bfloat162_rn(acc[i].x * inv, acc[i].y * inv);
      op[1] = __floats2bfloat162_rn(acc[i].z * inv, acc[i].w * inv);
    }
  }
}

template <int HD, int PS, int MR, bool Quant>
cudaError_t launch_paged(const PagedParams& p, int B, cudaStream_t stream) {
  const int R = p.W * (p.nh / p.kh);
  const size_t smem = 2 * size_t(Stage<HD, PS, Quant>::BYTES) +
                      size_t(R) * (HD + PS + 3) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(paged_decode_kernel<HD, PS, MR, Quant>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         int(smem));
  if (err != cudaSuccess) return err;
  paged_decode_kernel<HD, PS, MR, Quant><<<dim3(B, p.kh), NTHREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int HD, int PS, bool Quant>
cudaError_t launch_rows(const PagedParams& p, int B, cudaStream_t st) {
  const int R = p.W * (p.nh / p.kh);
  if (R <= 0 || R > MAX_ROWS) return cudaErrorInvalidValue;
  if (R <= 8) return launch_paged<HD, PS, 8, Quant>(p, B, st);
  if (R <= 16) return launch_paged<HD, PS, 16, Quant>(p, B, st);
  if (R <= 32) return launch_paged<HD, PS, 32, Quant>(p, B, st);
  return launch_paged<HD, PS, MAX_ROWS, Quant>(p, B, st);
}

template <bool Quant>
cudaError_t dispatch(const PagedParams& p, int B, int hd, int ps, cudaStream_t st) {
  if (hd == 128 && ps == 128) return launch_rows<128, 128, Quant>(p, B, st);
  if (hd == 128 && ps == 64) return launch_rows<128, 64, Quant>(p, B, st);
  if (hd == 64 && ps == 128) return launch_rows<64, 128, Quant>(p, B, st);
  if (hd == 64 && ps == 64) return launch_rows<64, 64, Quant>(p, B, st);
  return cudaErrorInvalidValue;
}

}  // namespace

// Plain C entry point, loaded with ctypes. q and o are contiguous
// [B, W, nh, hd] bf16; k / v the contiguous pool [L, kh, num_pages,
// page_size, hd], bf16, or int8 when k_scale / v_scale (fp32 [L, kh,
// num_pages, page_size]) are given; tables int32 [B, max_pages], every entry
// a row reads a valid page id; lengths int32 [B]. Returns a cudaError_t.
extern "C" int vr2_paged_decode_attention(const void* q, const void* k, const void* v,
                                          const void* k_scale, const void* v_scale,
                                          void* o, const int* tables, const int* lengths,
                                          int B, int W, int nh, int kh, int hd,
                                          int page_size, int num_pages, int max_pages,
                                          int layer, float scale, void* stream) {
  if (B <= 0 || W <= 0 || kh <= 0 || nh % kh != 0) return int(cudaErrorInvalidValue);
  if ((k_scale == nullptr) != (v_scale == nullptr)) return int(cudaErrorInvalidValue);
  PagedParams p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = k;
  p.v = v;
  p.k_scale = static_cast<const float*>(k_scale);
  p.v_scale = static_cast<const float*>(v_scale);
  p.o = static_cast<__nv_bfloat16*>(o);
  p.tables = tables;
  p.lengths = lengths;
  p.W = W;
  p.nh = nh;
  p.kh = kh;
  p.num_pages = num_pages;
  p.max_pages = max_pages;
  p.layer = layer;
  p.scale = scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (k_scale != nullptr) return int(dispatch<true>(p, B, hd, page_size, st));
  return int(dispatch<false>(p, B, hd, page_size, st));
}
