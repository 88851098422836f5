// ViT window attention backward for Hopper (sm_90a): bf16 in, fp32
// accumulation (an fp32 instance on the CUDA cores for fp32 operands, at
// the end).
//
// Replaces the TPU kernel video_r2_tpu/ops/vit_window_attention.py::
// _win_bwd_kernel (:90): a recompute backward, no forward statistics saved.
// Per 64-slot window and head it rebuilds S = scale q k^T (keys masked by the
// valid-slot mask), P = softmax(S), O = P v, D = rowsum(dO * O), then
//   dv = P^T dO,  dS = P * (dO v^T - D),  dq = scale dS k,  dk = scale dS^T q.
// P is rounded to bf16 once and that one P feeds both O and dv, so the
// backward's O is the O whose gradient it takes. A fully invalid window
// (never read downstream) has P = 0 and gets zero gradients.
//
// What bounds it on the card: each window reads q/k/v/dO and writes
// dq/dk/dv once (~7 x 64 x hd x 2 bytes per window and head) for five
// 64x64xhd products plus O: ~60 flops per byte, below the H100's bf16
// balance point, so it is bound by device-memory traffic and by launch
// granularity.
// What the design does about it: one 128-thread block per (window, head)
// holds the whole window in shared memory (row-major q/k/v/dO for the row
// products, transposed copies for the B operands, P^T and dS^T for the
// key-side products), reads each input once by stride from [S, heads, hd]
// and writes each gradient once; scores never reach device memory. The TPU
// kernel's 4-window slabs and head chunks serve VMEM and the MXU; here a
// block is one window.
#include <cmath>

#include "attn_common.cuh"
#include "fp32_tile.cuh"

namespace {

constexpr int WP = 64;        // slots per window (4 warps x 16 rows)
constexpr int NTHREADS = 128;
constexpr int PAD = 8;

struct WinBwdParams {
  const __nv_bfloat16* q;      // [S, nh, hd] by stride
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const __nv_bfloat16* dout;   // [S, nh, hd] contiguous
  const unsigned char* valid;  // [S] bool
  __nv_bfloat16* dq;           // [S, nh, hd] contiguous
  __nv_bfloat16* dk;
  __nv_bfloat16* dv;
  int nh;
  long long q_ss, q_sh, k_ss, k_sh, v_ss, v_sh;
  float scale;
};

template <int HD>
constexpr size_t win_bwd_smem_bytes() {
  return (4 * size_t(WP) * (HD + PAD) + 4 * size_t(HD) * (WP + PAD) +
          2 * size_t(WP) * (WP + PAD)) *
             sizeof(__nv_bfloat16) +
         WP;
}

// write a warp's 16 x HD fp32 C tiles (times `mul`) as bf16 rows of a
// contiguous [S, nh, HD] gradient
template <int HD>
__device__ __forceinline__ void store_rows(__nv_bfloat16* out, const float (&acc)[HD / 8][4],
                                           int row, int nh, int h, int t, float mul) {
#pragma unroll
  for (int ri = 0; ri < 2; ++ri) {
    __nv_bfloat16* op = out + ((long long)(row + 8 * ri) * nh + h) * HD + 2 * t;
#pragma unroll
    for (int d = 0; d < HD / 8; ++d) {
      *reinterpret_cast<__nv_bfloat162*>(op + d * 8) =
          __floats2bfloat162_rn(acc[d][2 * ri] * mul, acc[d][2 * ri + 1] * mul);
    }
  }
}

template <int HD>
__global__ void __launch_bounds__(NTHREADS) window_attn_bwd_kernel(const WinBwdParams p) {
  constexpr int QP = HD + PAD;  // pitch of the row-major tiles
  constexpr int TP = WP + PAD;  // pitch of the transposed tiles
  constexpr int NT = WP / 8;
  constexpr int DT = HD / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sK = sQ + WP * QP;
  __nv_bfloat16* sV = sK + WP * QP;
  __nv_bfloat16* sdO = sV + WP * QP;
  __nv_bfloat16* sQt = sdO + WP * QP;   // [HD][TP]
  __nv_bfloat16* sKt = sQt + HD * TP;
  __nv_bfloat16* sVt = sKt + HD * TP;
  __nv_bfloat16* sdOt = sVt + HD * TP;
  __nv_bfloat16* sPt = sdOt + HD * TP;  // P^T  [key][query]
  __nv_bfloat16* sdSt = sPt + WP * TP;  // dS^T [key][query]
  unsigned char* sValid = reinterpret_cast<unsigned char*>(sdSt + WP * TP);

  const int s0 = blockIdx.x * WP, h = blockIdx.y;
  const int tid = threadIdx.x, warp = tid / vr2::kWarp, lane = tid % vr2::kWarp;
  const int g = lane >> 2, t = lane & 3;
  const long long do_ss = (long long)p.nh * HD;

  const __nv_bfloat16* qb = p.q + s0 * p.q_ss + h * p.q_sh;
  const __nv_bfloat16* kb = p.k + s0 * p.k_ss + h * p.k_sh;
  const __nv_bfloat16* vb = p.v + s0 * p.v_ss + h * p.v_sh;
  const __nv_bfloat16* dob = p.dout + s0 * do_ss + h * HD;
  vr2::load_tile<HD>(sQ, QP, qb, p.q_ss, WP, WP, tid, NTHREADS);
  vr2::load_tile<HD>(sK, QP, kb, p.k_ss, WP, WP, tid, NTHREADS);
  vr2::load_tile<HD>(sV, QP, vb, p.v_ss, WP, WP, tid, NTHREADS);
  vr2::load_tile<HD>(sdO, QP, dob, do_ss, WP, WP, tid, NTHREADS);
  vr2::load_tile_transposed<HD>(sQt, TP, qb, p.q_ss, WP, WP, tid, NTHREADS);
  vr2::load_tile_transposed<HD>(sKt, TP, kb, p.k_ss, WP, WP, tid, NTHREADS);
  vr2::load_tile_transposed<HD>(sVt, TP, vb, p.v_ss, WP, WP, tid, NTHREADS);
  vr2::load_tile_transposed<HD>(sdOt, TP, dob, do_ss, WP, WP, tid, NTHREADS);
  for (int i = tid; i < WP; i += NTHREADS) sValid[i] = p.valid[s0 + i];
  __syncthreads();

  const int r_lo = warp * 16 + g;  // this lane's rows: r_lo and r_lo + 8

  // S = Q K^T and dP = dO V^T for this warp's 16 query rows
  float s[NT][4], dp[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    uint32_t qa[4], da[4];
    vr2::ld_a_frag(qa, sQ + r_lo * QP + kk * 16 + 2 * t, QP);
    vr2::ld_a_frag(da, sdO + r_lo * QP + kk * 16 + 2 * t, QP);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int off = (n * 8 + g) * QP + kk * 16 + 2 * t;
      vr2::mma_bf16_16816(s[n], qa, vr2::ld_pair(sK + off), vr2::ld_pair(sK + off + 8));
      vr2::mma_bf16_16816(dp[n], da, vr2::ld_pair(sV + off), vr2::ld_pair(sV + off + 8));
    }
  }

  // P = softmax over the valid keys (0 in a fully invalid window)
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int n = 0; n < NT; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float x = sValid[n * 8 + 2 * t + (e & 1)] ? s[n][e] * p.scale : -INFINITY;
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
#pragma unroll
  for (int ri = 0; ri < 2; ++ri) {
    const float tot = vr2::quad_sum(l[ri]);
    l[ri] = tot > 0.f ? 1.f / tot : 0.f;
  }
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[n][e] *= l[e >> 1];

  // O = P V with P in bf16, then D = rowsum(dO * O)
  uint32_t pa[WP / 16][4];
#pragma unroll
  for (int kk = 0; kk < WP / 16; ++kk) vr2::c_to_a(pa[kk], s[2 * kk], s[2 * kk + 1]);
  float acc[DT][4];
#pragma unroll
  for (int d = 0; d < DT; ++d) acc[d][0] = acc[d][1] = acc[d][2] = acc[d][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < WP / 16; ++kk) {
#pragma unroll
    for (int d = 0; d < DT; ++d) {
      const __nv_bfloat16* vp = sVt + (d * 8 + g) * TP + kk * 16 + 2 * t;
      vr2::mma_bf16_16816(acc[d], pa[kk], vr2::ld_pair(vp), vr2::ld_pair(vp + 8));
    }
  }
  float D[2] = {0.f, 0.f};
#pragma unroll
  for (int d = 0; d < DT; ++d) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = r_lo + 8 * (e >> 1), col = d * 8 + 2 * t + (e & 1);
      D[e >> 1] += acc[d][e] * __bfloat162float(sdO[row * QP + col]);
    }
  }
  D[0] = vr2::quad_sum(D[0]);
  D[1] = vr2::quad_sum(D[1]);

  // dS = P (dP - D) into dp; P^T and dS^T to shared memory for the key side
#pragma unroll
  for (int n = 0; n < NT; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = r_lo + 8 * (e >> 1), key = n * 8 + 2 * t + (e & 1);
      dp[n][e] = s[n][e] * (dp[n][e] - D[e >> 1]);
      sPt[key * TP + row] = __float2bfloat16(s[n][e]);  // the bf16 P that made O
      sdSt[key * TP + row] = __float2bfloat16(dp[n][e]);
    }
  }

  // dQ = scale dS K
#pragma unroll
  for (int d = 0; d < DT; ++d) acc[d][0] = acc[d][1] = acc[d][2] = acc[d][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < WP / 16; ++kk) {
    uint32_t sa[4];
    vr2::c_to_a(sa, dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
    for (int d = 0; d < DT; ++d) {
      const __nv_bfloat16* kp = sKt + (d * 8 + g) * TP + kk * 16 + 2 * t;
      vr2::mma_bf16_16816(acc[d], sa, vr2::ld_pair(kp), vr2::ld_pair(kp + 8));
    }
  }
  store_rows<HD>(p.dq, acc, s0 + r_lo, p.nh, h, t, p.scale);
  __syncthreads();  // P^T and dS^T of every warp are in

  // key side: this warp's 16 keys. dV = P^T dO, then dK = scale dS^T Q
#pragma unroll
  for (int pass = 0; pass < 2; ++pass) {
    const __nv_bfloat16* at = pass == 0 ? sPt : sdSt;
    const __nv_bfloat16* bt = pass == 0 ? sdOt : sQt;
#pragma unroll
    for (int d = 0; d < DT; ++d) acc[d][0] = acc[d][1] = acc[d][2] = acc[d][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < WP / 16; ++kk) {
      uint32_t a[4];
      vr2::ld_a_frag(a, at + r_lo * TP + kk * 16 + 2 * t, TP);
#pragma unroll
      for (int d = 0; d < DT; ++d) {
        const __nv_bfloat16* bp = bt + (d * 8 + g) * TP + kk * 16 + 2 * t;
        vr2::mma_bf16_16816(acc[d], a, vr2::ld_pair(bp), vr2::ld_pair(bp + 8));
      }
    }
    if (pass == 0)
      store_rows<HD>(p.dv, acc, s0 + r_lo, p.nh, h, t, 1.f);
    else
      store_rows<HD>(p.dk, acc, s0 + r_lo, p.nh, h, t, p.scale);
  }
}

template <int HD>
cudaError_t launch_window_bwd(const WinBwdParams& p, int S, cudaStream_t stream) {
  constexpr size_t smem = win_bwd_smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      window_attn_bwd_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(S / WP, p.nh);
  window_attn_bwd_kernel<HD><<<grid, NTHREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

// The fp32 instance (CUDA cores; fp32_tile.cuh): fp32 operands at any head
// dim up to 128, P, dS and every product in fp32, the same zeros on a fully
// invalid window. One 256-thread block per (window, head): S, dP and dS in
// registers (4 x 4 a thread), P and dS through shared memory into their
// products, each gradient written as soon as it is formed. No preset runs
// it: the tiny fp32 test config does.
namespace f32 = vr2::f32;

struct WinBwdF32Params {
  const float *q, *k, *v;      // [S, nh, hd] by stride
  const float* dout;           // [S, nh, hd] contiguous
  const unsigned char* valid;  // [S] bool
  float *dq, *dk, *dv;         // [S, nh, hd] contiguous
  int nh, hd;
  long long q_ss, q_sh, k_ss, k_sh, v_ss, v_sh;
  float scale;
};

// out (a contiguous [S, nh, hd] at head h), rows [s0, s0 + 64) = (T X) x
// mul: T the tile in shared memory, read transposed when `trans`, and X the
// window's rows of x (stride `ld`), both 64-column halves of the head dim
__device__ __forceinline__ void window_grad(float* out, const f32::Tile& t, bool trans,
                                            const float* x, long long ld, int s0, int h,
                                            const WinBwdF32Params& p, float mul,
                                            f32::Smem& sm) {
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    if (c * f32::kTile >= p.hd) continue;
    f32::Acc acc;
    f32::zero(acc);
    const f32::Operand<false> xo{x + c * f32::kTile, ld, p.hd - c * f32::kTile};
    if (trans)
      f32::product(acc, f32::Operand<false>{&t[0][0], f32::kTile + 1, WP}, xo, WP, sm);
    else
      f32::product(acc, f32::Operand<true>{&t[0][0], f32::kTile + 1, WP}, xo, WP, sm);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = c * f32::kTile + 4 * tx + j;
        if (col < p.hd)
          out[((long long)(s0 + 4 * ty + i) * p.nh + h) * p.hd + col] = acc[i][j] * mul;
      }
  }
}

__global__ void __launch_bounds__(f32::kThreads)
    window_attn_bwd_f32_kernel(const WinBwdF32Params p) {
  __shared__ f32::Smem sm;
  __shared__ f32::Tile st;
  const int s0 = blockIdx.x * WP, h = blockIdx.y;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const long long do_ss = (long long)p.nh * p.hd;
  const float* qb = p.q + s0 * p.q_ss + h * p.q_sh;
  const float* kb = p.k + s0 * p.k_ss + h * p.k_sh;
  const float* vb = p.v + s0 * p.v_ss + h * p.v_sh;
  const float* dob = p.dout + s0 * do_ss + h * p.hd;
  f32::Acc s, dp;
  f32::zero(s);
  f32::zero(dp);
  f32::product(s, f32::Operand<true>{qb, p.q_ss, WP}, f32::Operand<true>{kb, p.k_ss, WP}, p.hd,
               sm);
  f32::product(dp, f32::Operand<true>{dob, do_ss, WP}, f32::Operand<true>{vb, p.v_ss, WP},
               p.hd, sm);
  // P = softmax over the valid keys (0 in a fully invalid window)
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      s[i][j] = p.valid[s0 + 4 * tx + j] ? s[i][j] * p.scale : -INFINITY;
      mx = fmaxf(mx, s[i][j]);
    }
    mx = f32::row_max(mx);
    const float ref = mx == -INFINITY ? 0.f : mx;
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) sum += s[i][j] = expf(s[i][j] - ref);
    sum = f32::row_sum(sum);
    const float inv = sum > 0.f ? 1.f / sum : 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] *= inv;
  }
  f32::to_tile(st, s);
  __syncthreads();
  // O = P V, then D = rowsum(dO * O)
  float D[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    if (c * f32::kTile >= p.hd) continue;
    f32::Acc o;
    f32::zero(o);
    f32::product(o, f32::Operand<true>{&st[0][0], f32::kTile + 1, WP},
                 f32::Operand<false>{vb + c * f32::kTile, p.v_ss, p.hd - c * f32::kTile}, WP,
                 sm);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = c * f32::kTile + 4 * tx + j;
        if (col < p.hd) D[i] += o[i][j] * dob[(4 * ty + i) * do_ss + col];
      }
  }
  // dV = P^T dO
  window_grad(p.dv, st, true, dob, do_ss, s0, h, p, 1.f, sm);
  // dS = P (dP - D); dQ = scale dS K, dK = scale dS^T Q
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float d = f32::row_sum(D[i]);
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] *= dp[i][j] - d;
  }
  f32::to_tile(st, s);
  __syncthreads();
  window_grad(p.dq, st, false, kb, p.k_ss, s0, h, p, p.scale, sm);
  window_grad(p.dk, st, true, qb, p.q_ss, s0, h, p, p.scale, sm);
}

}  // namespace

// Plain C entry point, loaded with ctypes. S is a multiple of 64; q / k / v
// strides are in elements; dout is a contiguous [S, nh, hd]; dq / dk / dv
// are written as contiguous [S, nh, hd]. Returns a cudaError_t.
extern "C" int vr2_window_attention_bwd(const void* q, const void* k, const void* v,
                                        const void* dout, const void* valid, void* dq,
                                        void* dk, void* dv, int S, int nh, int hd,
                                        long long q_ss, long long q_sh, long long k_ss,
                                        long long k_sh, long long v_ss, long long v_sh,
                                        float scale, int fp32, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (S % WP != 0) return int(cudaErrorInvalidValue);
  if (fp32) {
    if (hd <= 0 || hd > 2 * f32::kTile) return int(cudaErrorInvalidValue);
    const WinBwdF32Params p{
        static_cast<const float*>(q),    static_cast<const float*>(k),
        static_cast<const float*>(v),    static_cast<const float*>(dout),
        static_cast<const unsigned char*>(valid), static_cast<float*>(dq),
        static_cast<float*>(dk),         static_cast<float*>(dv),
        nh, hd, q_ss, q_sh, k_ss, k_sh, v_ss, v_sh, scale};
    window_attn_bwd_f32_kernel<<<dim3(S / WP, nh), f32::kThreads, 0, st>>>(p);
    return int(cudaGetLastError());
  }
  WinBwdParams p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.dout = static_cast<const __nv_bfloat16*>(dout);
  p.valid = static_cast<const unsigned char*>(valid);
  p.dq = static_cast<__nv_bfloat16*>(dq);
  p.dk = static_cast<__nv_bfloat16*>(dk);
  p.dv = static_cast<__nv_bfloat16*>(dv);
  p.nh = nh;
  p.q_ss = q_ss;
  p.q_sh = q_sh;
  p.k_ss = k_ss;
  p.k_sh = k_sh;
  p.v_ss = v_ss;
  p.v_sh = v_sh;
  p.scale = scale;
  switch (hd) {
    case 64: return launch_window_bwd<64>(p, S, st);
    case 80: return launch_window_bwd<80>(p, S, st);
    case 128: return launch_window_bwd<128>(p, S, st);
    default: return int(cudaErrorInvalidValue);
  }
}
