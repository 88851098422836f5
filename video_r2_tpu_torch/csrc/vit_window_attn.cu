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
// flops per byte, below the H100's bf16 balance point, so it is bound by
// device-memory traffic and launch granularity, not by the tensor cores.
// What the design does about it: one 128-thread block per (window, head)
// reads its q/k/v rows once by stride from [S, heads, hd] (no head-major
// transpose, TPU-only: vit_window_attention.py:223-225), keeps the score tile
// in registers (mma.sync m16n8k16; each warp owns 16 query rows) and writes
// only the output, so scores never reach device memory. The TPU kernel's
// 4-window slabs exist for the 128x128 MXU; here a block is one window.
#include <cmath>

#include "attn_common.cuh"
#include "fp32_tile.cuh"

namespace {

constexpr int WP = 64;        // slots per window (4 warps x 16 rows)
constexpr int NTHREADS = 128;
constexpr int PAD = 8;

struct WinParams {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const unsigned char* valid;  // [S] bool
  __nv_bfloat16* o;            // [S, nh, hd] contiguous
  int nh;
  long long q_ss, q_sh, k_ss, k_sh, v_ss, v_sh;
  float scale;
};

template <int HD>
constexpr size_t win_smem_bytes() {
  return (2 * size_t(WP) * (HD + PAD) + size_t(HD) * (WP + PAD)) * sizeof(__nv_bfloat16) +
         WP;
}

template <int HD>
__global__ void __launch_bounds__(NTHREADS) window_attn_kernel(const WinParams p) {
  constexpr int QP = HD + PAD;
  constexpr int VP = WP + PAD;
  constexpr int NT = WP / 8;
  constexpr int DT = HD / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sK = sQ + WP * QP;
  __nv_bfloat16* sVt = sK + WP * QP;
  unsigned char* sValid = reinterpret_cast<unsigned char*>(sVt + HD * VP);

  const int s0 = blockIdx.x * WP, h = blockIdx.y;
  const int tid = threadIdx.x, warp = tid / vr2::kWarp, lane = tid % vr2::kWarp;
  const int g = lane >> 2, t = lane & 3;

  vr2::load_tile<HD>(sQ, QP, p.q + s0 * p.q_ss + h * p.q_sh, p.q_ss, WP, WP, tid, NTHREADS);
  vr2::load_tile<HD>(sK, QP, p.k + s0 * p.k_ss + h * p.k_sh, p.k_ss, WP, WP, tid, NTHREADS);
  vr2::load_tile_transposed<HD>(sVt, VP, p.v + s0 * p.v_ss + h * p.v_sh, p.v_ss, WP, WP,
                                tid, NTHREADS);
  for (int i = tid; i < WP; i += NTHREADS) sValid[i] = p.valid[s0 + i];
  __syncthreads();

  const int r_lo = warp * 16 + g;
  float s[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const __nv_bfloat16* qp = sQ + r_lo * QP + kk * 16 + 2 * t;
    const uint32_t qa[4] = {vr2::ld_pair(qp), vr2::ld_pair(qp + 8 * QP), vr2::ld_pair(qp + 8),
                            vr2::ld_pair(qp + 8 * QP + 8)};
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const __nv_bfloat16* kp = sK + (n * 8 + g) * QP + kk * 16 + 2 * t;
      vr2::mma_bf16_16816(s[n], qa, vr2::ld_pair(kp), vr2::ld_pair(kp + 8));
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

  float acc[DT][4];
#pragma unroll
  for (int d = 0; d < DT; ++d) acc[d][0] = acc[d][1] = acc[d][2] = acc[d][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < WP / 16; ++kk) {
    uint32_t pa[4];
    pa[0] = vr2::pack_bf16(s[2 * kk][0], s[2 * kk][1]);
    pa[1] = vr2::pack_bf16(s[2 * kk][2], s[2 * kk][3]);
    pa[2] = vr2::pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
    pa[3] = vr2::pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
    for (int d = 0; d < DT; ++d) {
      const __nv_bfloat16* vp = sVt + (d * 8 + g) * VP + kk * 16 + 2 * t;
      vr2::mma_bf16_16816(acc[d], pa, vr2::ld_pair(vp), vr2::ld_pair(vp + 8));
    }
  }

#pragma unroll
  for (int ri = 0; ri < 2; ++ri) {
    const float tot = vr2::quad_sum(l[ri]);
    const float inv = tot > 0.f ? 1.f / tot : 0.f;
    const int row = s0 + r_lo + 8 * ri;
    __nv_bfloat16* op = p.o + ((long long)row * p.nh + h) * HD + 2 * t;
#pragma unroll
    for (int d = 0; d < DT; ++d) {
      *reinterpret_cast<__nv_bfloat162*>(op + d * 8) =
          __floats2bfloat162_rn(acc[d][2 * ri] * inv, acc[d][2 * ri + 1] * inv);
    }
  }
}

template <int HD>
cudaError_t launch_window(const WinParams& p, int S, cudaStream_t stream) {
  constexpr size_t smem = win_smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      window_attn_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(S / WP, p.nh);
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
// 64, 80 or 128; fp32 (fp32 != 0): any hd up to 128. Returns a cudaError_t.
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
  WinParams p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.valid = static_cast<const unsigned char*>(valid);
  p.o = static_cast<__nv_bfloat16*>(o);
  p.nh = nh;
  p.q_ss = q_ss;
  p.q_sh = q_sh;
  p.k_ss = k_ss;
  p.k_sh = k_sh;
  p.v_ss = v_ss;
  p.v_sh = v_sh;
  p.scale = scale;
  switch (hd) {
    case 64: return launch_window<64>(p, S, st);
    case 80: return launch_window<80>(p, S, st);
    case 128: return launch_window<128>(p, S, st);
    default: return int(cudaErrorInvalidValue);
  }
}
