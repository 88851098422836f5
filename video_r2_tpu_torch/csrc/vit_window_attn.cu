// ViT window attention for Hopper (sm_90a): bf16 in, fp32 accumulation (an
// fp32 instance on the CUDA cores for fp32 operands, at the end).
//
// Replaces the TPU kernel video_r2_tpu/ops/vit_window_attention.py::_win_kernel
// (:36), with the same semantics: attention within fixed 64-slot windows
// (the physically padded layout of models/vision.py), keys admitted by the
// valid-slot mask, probabilities cast to the operand type before the P @ V
// product and normalised after it. A fully invalid window (never read
// downstream) emits 0.
//
// What bounds it on the card: each window is a 64x64 score tile over
// hd = 80, so the kernel reads q/k/v once and writes o once (~4 x 64 x 80 x
// 2 bytes per window and head) for 2 x 64 x 64 x 80 x 2 flops: about 40
// flops per byte, below the H100's bf16 balance point, so device-memory
// traffic bounds it (0.0125 ms at the 8-frame clip's 4096 slots, 16 heads).
// What the design does about it:
// - A persistent grid: as many 128-thread blocks as the card keeps
//   resident (the occupancy calculator's count times the SMs), each walking
//   a contiguous range of (head, window) items, windows fastest, so a block
//   takes several windows of one head.
// - q, k and v of a window come by 16-byte cp.async from their strided
//   [S, heads, hd] views (no head-major transpose, TPU-only:
//   vit_window_attention.py:223-225) into a 2-stage ring, with the 64
//   valid flags: the next window lands while this one's products run.
// - Each warp owns 16 query rows: Q's A fragments, K's B fragments (S = Q
//   K^T) and V's (P V, by ldmatrix .trans from V's natural row-major tile)
//   all come by ldmatrix; the score tile stays in registers (mma.sync
//   m16n8k16) and is the A operand of P V, so scores never reach memory.
// - The output goes through the warp's own rows of the Q tile (read into
//   registers first) to 16-byte stores.
// The TPU kernel's 4-window slabs exist for the 128x128 MXU; here a window
// is a block's step.
#include <cmath>

#include "attn_common.cuh"
#include "fp32_tile.cuh"

namespace {

constexpr int WP = 64;        // slots per window (4 warps x 16 rows)
constexpr int NTHREADS = 128;
constexpr int PAD = 8;        // row pitch HD + 8: ldmatrix's 8 rows on 8 bank groups

struct WinParams {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const unsigned char* valid;  // [S] bool, 16-byte aligned
  __nv_bfloat16* o;            // [S, nh, hd] contiguous
  int nh, nw;                  // heads, windows
  long long q_ss, q_sh, k_ss, k_sh, v_ss, v_sh;
  float scale;
};

// one ring stage: the q, k and v tiles [WP][HD + PAD] and the window's flags
template <int HD>
struct WinStage {
  static constexpr int PITCH = HD + PAD;
  static constexpr int TILE = WP * PITCH * 2;
  static constexpr int BYTES = 3 * TILE + WP;
  static constexpr int SMEM = 2 * BYTES;
};

template <int HD>
__device__ __forceinline__ void load_window(unsigned char* st, const WinParams& p, int item,
                                            int tid) {
  using W = WinStage<HD>;
  constexpr int CH = HD / 8;  // 16-byte chunks a row
  const int h = item / p.nw, s0 = (item - h * p.nw) * WP;
  const __nv_bfloat16* src[3] = {p.q + s0 * p.q_ss + h * p.q_sh, p.k + s0 * p.k_ss + h * p.k_sh,
                                 p.v + s0 * p.v_ss + h * p.v_sh};
  const long long ss[3] = {p.q_ss, p.k_ss, p.v_ss};
#pragma unroll
  for (int m = 0; m < 3; ++m) {
    __nv_bfloat16* dst = reinterpret_cast<__nv_bfloat16*>(st + m * W::TILE);
    for (int i = tid; i < WP * CH; i += NTHREADS) {
      const int r = i / CH, c = (i - r * CH) * 8;
      vr2::cp_async16(dst + r * W::PITCH + c, src[m] + r * ss[m] + c);
    }
  }
  if (tid < WP / 16) vr2::cp_async16(st + 3 * W::TILE + 16 * tid, p.valid + s0 + 16 * tid);
}

template <int HD>
__global__ void __launch_bounds__(NTHREADS) window_attn_kernel(const WinParams p) {
  using W = WinStage<HD>;
  constexpr int QP = W::PITCH;
  constexpr int NT = WP / 8;   // 8-key tiles of S
  constexpr int DT = HD / 8;   // 8-dim tiles of O
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int tid = threadIdx.x, warp = tid / vr2::kWarp, lane = tid % vr2::kWarp;
  const int g = lane >> 2, t = lane & 3;
  const int l8 = lane & 7, j4 = lane >> 3;  // ldmatrix: the row and tile a lane addresses
  const int items = p.nh * p.nw;
  const int first = int((long long)blockIdx.x * items / gridDim.x);
  const int end = int((long long)(blockIdx.x + 1) * items / gridDim.x);

  if (first < end) load_window<HD>(smem_raw, p, first, tid);
  vr2::cp_async_commit();
  for (int it = first, sl = 0; it < end; ++it, sl ^= 1) {
    vr2::cp_async_wait<0>();  // this window has landed (this thread's copies)
    __syncthreads();          // ... every thread's; the other stage is free
    if (it + 1 < end) load_window<HD>(smem_raw + (sl ^ 1) * W::BYTES, p, it + 1, tid);
    vr2::cp_async_commit();

    unsigned char* st = smem_raw + sl * W::BYTES;
    __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(st);
    const __nv_bfloat16* sK = sQ + WP * QP;
    const __nv_bfloat16* sV = sK + WP * QP;
    const unsigned char* sValid = st + 3 * W::TILE;
    const int h = it / p.nw, s0 = (it - h * p.nw) * WP;
    const int r0 = warp * 16;

    // S = Q K^T over this warp's 16 rows
    float s[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      uint32_t qa[4];
      vr2::ldsm_x4(qa, sQ + (r0 + l8 + 8 * (j4 & 1)) * QP + kk * 16 + 8 * (j4 >> 1));
#pragma unroll
      for (int n2 = 0; n2 < NT / 2; ++n2) {  // keys 16 n2 .. + 15: two n tiles
        uint32_t kb[4];
        vr2::ldsm_x4(kb, sK + (16 * n2 + l8 + 8 * (j4 >> 1)) * QP + kk * 16 + 8 * (j4 & 1));
        vr2::mma_bf16_16816(s[2 * n2], qa, kb[0], kb[1]);
        vr2::mma_bf16_16816(s[2 * n2 + 1], qa, kb[2], kb[3]);
      }
    }

    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = n * 8 + 2 * t + (e & 1);
        const float x = sValid[key] ? s[n][e] * p.scale : -INFINITY;
        s[n][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float mref[2], l[2] = {0.f, 0.f};
#pragma unroll
    for (int ri = 0; ri < 2; ++ri) {
      const float m = vr2::quad_max(mx[ri]);
      mref[ri] = (m == -INFINITY) ? 0.f : m;
    }
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pe = __expf(s[n][e] - mref[e >> 1]);
        s[n][e] = pe;
        l[e >> 1] += pe;
      }
    }

    // O = P V: P rounded to bf16 (the A operand), V's B fragments by
    // ldmatrix .trans from its row-major tile
    float acc[DT][4];
#pragma unroll
    for (int d = 0; d < DT; ++d) acc[d][0] = acc[d][1] = acc[d][2] = acc[d][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < WP / 16; ++kk) {
      uint32_t pa[4];
      vr2::c_to_a(pa, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int d2 = 0; d2 < DT / 2; ++d2) {  // dims 16 d2 .. + 15: two d tiles
        uint32_t vb[4];
        vr2::ldsm_x4_trans(vb, sV + (kk * 16 + l8 + 8 * (j4 & 1)) * QP + 16 * d2 + 8 * (j4 >> 1));
        vr2::mma_bf16_16816(acc[2 * d2], pa, vb[0], vb[1]);
        vr2::mma_bf16_16816(acc[2 * d2 + 1], pa, vb[2], vb[3]);
      }
    }

    // normalise into this warp's rows of the Q tile (every lane has read its
    // Q fragments above), then 16-byte stores of those rows
    __syncwarp();
#pragma unroll
    for (int ri = 0; ri < 2; ++ri) {
      const float tot = vr2::quad_sum(l[ri]);
      const float inv = tot > 0.f ? 1.f / tot : 0.f;
      __nv_bfloat16* orow = sQ + (r0 + g + 8 * ri) * QP + 2 * t;
#pragma unroll
      for (int d = 0; d < DT; ++d)
        *reinterpret_cast<uint32_t*>(orow + d * 8) =
            vr2::pack_bf16(acc[d][2 * ri] * inv, acc[d][2 * ri + 1] * inv);
    }
    __syncwarp();
    constexpr int CH = HD / 8;
#pragma unroll
    for (int i = lane; i < 16 * CH; i += vr2::kWarp) {
      const int r = i / CH, c = (i - r * CH) * 8;
      *reinterpret_cast<uint4*>(p.o + ((long long)(s0 + r0 + r) * p.nh + h) * HD + c) =
          *reinterpret_cast<const uint4*>(sQ + (r0 + r) * QP + c);
    }
  }
}

template <int HD>
cudaError_t launch_window(const WinParams& p, cudaStream_t stream) {
  constexpr int smem = WinStage<HD>::SMEM;
  static int resident = 0, sms = 0;  // the grid: the blocks the card keeps resident
  cudaError_t err = cudaFuncSetAttribute(
      window_attn_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(window_attn_kernel<HD>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               int(cudaSharedmemCarveoutMaxShared));
  if (err != cudaSuccess) return err;
  if (resident == 0) {
    int dev = 0;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
        (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) !=
            cudaSuccess ||
        (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident, window_attn_kernel<HD>,
                                                             NTHREADS, smem)) != cudaSuccess)
      return err;
    if (resident < 1) return cudaErrorInvalidConfiguration;
  }
  const int grid = min(p.nh * p.nw, resident * sms);
  window_attn_kernel<HD><<<grid, NTHREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

// The fp32 instance (CUDA cores; fp32_tile.cuh): fp32 q / k / v at any
// head dim up to 128, P and both products in fp32, the same mask and the
// same zeros on a fully invalid window. One 256-thread block per (window,
// head): S in registers (4 x 4 a thread), P through shared memory into
// P V. No preset runs it: the tiny fp32 test config does.
namespace f32 = vr2::f32;

struct WinF32Params {
  const float *q, *k, *v;      // [S, nh, hd] by stride
  const unsigned char* valid;  // [S] bool
  float* o;                    // [S, nh, hd] contiguous
  int nh, hd;
  long long q_ss, q_sh, k_ss, k_sh, v_ss, v_sh;
  float scale;
};

__global__ void __launch_bounds__(f32::kThreads) window_attn_f32_kernel(const WinF32Params p) {
  __shared__ f32::Smem sm;
  __shared__ f32::Tile sp;
  const int s0 = blockIdx.x * WP, h = blockIdx.y;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  f32::Acc s;
  f32::zero(s);
  f32::product(s, f32::Operand<true>{p.q + s0 * p.q_ss + h * p.q_sh, p.q_ss, WP},
               f32::Operand<true>{p.k + s0 * p.k_ss + h * p.k_sh, p.k_ss, WP}, p.hd, sm);
  float tot[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      s[i][j] = p.valid[s0 + 4 * tx + j] ? s[i][j] * p.scale : -INFINITY;
      mx = fmaxf(mx, s[i][j]);
    }
    mx = f32::row_max(mx);
    const float ref = mx == -INFINITY ? 0.f : mx;  // a fully invalid window
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) sum += s[i][j] = expf(s[i][j] - ref);
    tot[i] = f32::row_sum(sum);
  }
  f32::to_tile(sp, s);
  __syncthreads();
  f32::Acc o[2];
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    f32::zero(o[c]);
    if (c * f32::kTile < p.hd)
      f32::product(o[c], f32::Operand<true>{&sp[0][0], f32::kTile + 1, WP},
                   f32::Operand<false>{p.v + s0 * p.v_ss + h * p.v_sh + c * f32::kTile, p.v_ss,
                                       p.hd - c * f32::kTile},
                   WP, sm);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float inv = tot[i] > 0.f ? 1.f / tot[i] : 0.f;
    float* op = p.o + ((long long)(s0 + 4 * ty + i) * p.nh + h) * p.hd;
#pragma unroll
    for (int c = 0; c < 2; ++c)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = c * f32::kTile + 4 * tx + j;
        if (col < p.hd) op[col] = o[c][i][j] * inv;
      }
  }
}

}  // namespace

// Plain C entry point, loaded with ctypes. S is a multiple of 64; strides are
// in elements; the output is a contiguous [S, nh, hd] of q's type. bf16: hd
// 64, 80 or 128, q / k / v rows 16-byte aligned, valid 16-byte aligned;
// fp32 (fp32 != 0): any hd up to 128. Returns a cudaError_t.
extern "C" int vr2_window_attention_fwd(const void* q, const void* k, const void* v,
                                        const void* valid, void* o, int S, int nh, int hd,
                                        long long q_ss, long long q_sh, long long k_ss,
                                        long long k_sh, long long v_ss, long long v_sh,
                                        float scale, int fp32, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (S % WP != 0) return int(cudaErrorInvalidValue);
  if (fp32) {
    if (hd <= 0 || hd > 2 * f32::kTile) return int(cudaErrorInvalidValue);
    const WinF32Params p{static_cast<const float*>(q), static_cast<const float*>(k),
                         static_cast<const float*>(v), static_cast<const unsigned char*>(valid),
                         static_cast<float*>(o), nh, hd, q_ss, q_sh, k_ss, k_sh, v_ss, v_sh,
                         scale};
    window_attn_f32_kernel<<<dim3(S / WP, nh), f32::kThreads, 0, st>>>(p);
    return int(cudaGetLastError());
  }
  if (reinterpret_cast<uintptr_t>(valid) % 16 != 0) return int(cudaErrorInvalidValue);
  WinParams p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.valid = static_cast<const unsigned char*>(valid);
  p.o = static_cast<__nv_bfloat16*>(o);
  p.nh = nh;
  p.nw = S / WP;
  p.q_ss = q_ss;
  p.q_sh = q_sh;
  p.k_ss = k_ss;
  p.k_sh = k_sh;
  p.v_ss = v_ss;
  p.v_sh = v_sh;
  p.scale = scale;
  switch (hd) {
    case 64: return launch_window<64>(p, st);
    case 80: return launch_window<80>(p, st);
    case 128: return launch_window<128>(p, st);
    default: return int(cudaErrorInvalidValue);
  }
}
