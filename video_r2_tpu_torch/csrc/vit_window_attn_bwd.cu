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
// balance point, so device-memory traffic bounds it (0.0876 ms at the
// training slice's 16384 slots, 16 heads of 80).
// What the design does about it (the forward's shape, csrc/vit_window_attn.cu):
// - A persistent grid: as many 128-thread blocks as the card keeps
//   resident (the occupancy calculator's count times the SMs: one an SM),
//   each walking a contiguous range of (head, window) items, heads
//   fastest: a block takes the heads of one window in turn, so the pieces
//   of a row that neighbouring heads own (2 x hd bytes each) are read and
//   written within an item of each other and meet in L2.
// - q, k, v and dO of the next windows come by 16-byte cp.async from their
//   strided [S, heads, hd] views into a ring of 3 stages (with P and dS,
//   150 KB of shared memory at hd 80, 222 KB at 128), with the 64 valid
//   flags, while this window's products run. A stage is refilled after the barrier that opens a
//   window, when every warp is done with the window it held.
//   On an H100 80GB HBM3 at 700 W, windows fastest (the forward's order)
//   measured 15% slower, and two blocks an SM on 2 stages each 8% slower
//   (PERF.md §6).
// - Every fragment comes by ldmatrix from row-major tiles, so nothing is
//   stored transposed: Q, dO (A) and K, V (B) of S = Q K^T and dP = dO V^T
//   plainly; the B operands that run over the window's rows (V in O = P V,
//   K in dQ = dS K, dO in dV = P^T dO, Q in dK = dS^T Q) by ldmatrix .trans.
// - Each warp owns 16 query rows: S, dP, P and dS stay in registers
//   (mma.sync m16n8k16) through O, D and dQ. P and dS also go row-major to
//   shared memory as bf16 pairs, where the key side (the warp's 16 keys)
//   reads P^T and dS^T as A operands by ldmatrix .trans.
// - Each gradient goes through the warp's own rows of the V tile (V is
//   read no more by then) to 16-byte stores.
// The TPU kernel's 4-window slabs and head chunks serve VMEM and the MXU;
// here a window is a block's step.
#include <cmath>

#include "attn_common.cuh"
#include "fp32_tile.cuh"

namespace {

constexpr int WP = 64;        // slots per window (4 warps x 16 rows)
constexpr int NTHREADS = 128;
constexpr int PAD = 8;        // row pitch + 8: ldmatrix's 8 rows on 8 bank groups

struct WinBwdParams {
  const __nv_bfloat16* q;      // [S, nh, hd] by stride
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const __nv_bfloat16* dout;   // [S, nh, hd] contiguous
  const unsigned char* valid;  // [S] bool, 16-byte aligned
  __nv_bfloat16* dq;           // [S, nh, hd] contiguous
  __nv_bfloat16* dk;
  __nv_bfloat16* dv;
  int nh, nw;                  // heads, windows
  long long q_ss, q_sh, k_ss, k_sh, v_ss, v_sh;
  float scale;
};

// one ring stage: the q, k, v and dO tiles [WP][HD + PAD] and the window's
// flags; after the STAGES stages, the P and dS tiles [WP][WP + PAD] (query
// rows)
template <int HD>
struct BwdStage {
  static constexpr int STAGES = 3;
  static constexpr int PITCH = HD + PAD;
  static constexpr int TILE = WP * PITCH * 2;
  static constexpr int BYTES = 4 * TILE + WP;
  static constexpr int SP = WP + PAD;
  static constexpr int SMEM = STAGES * BYTES + 2 * WP * SP * 2;
};

template <int HD>
__device__ __forceinline__ void load_window(unsigned char* st, const WinBwdParams& p, int item,
                                            int tid) {
  using W = BwdStage<HD>;
  constexpr int CH = HD / 8;  // 16-byte chunks a row
  const int h = item % p.nh, s0 = item / p.nh * WP;
  const long long do_ss = (long long)p.nh * HD;
  const __nv_bfloat16* src[4] = {p.q + s0 * p.q_ss + h * p.q_sh, p.k + s0 * p.k_ss + h * p.k_sh,
                                 p.v + s0 * p.v_ss + h * p.v_sh, p.dout + s0 * do_ss + h * HD};
  const long long ss[4] = {p.q_ss, p.k_ss, p.v_ss, do_ss};
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    __nv_bfloat16* dst = reinterpret_cast<__nv_bfloat16*>(st + m * W::TILE);
    for (int i = tid; i < WP * CH; i += NTHREADS) {
      const int r = i / CH, c = (i - r * CH) * 8;
      vr2::cp_async16(dst + r * W::PITCH + c, src[m] + r * ss[m] + c);
    }
  }
  if (tid < WP / 16) vr2::cp_async16(st + 4 * W::TILE + 16 * tid, p.valid + s0 + 16 * tid);
}

// a warp's 16 x HD fp32 C tiles (times `mul`) as bf16 rows [s0 + r0, + 16)
// of a contiguous [S, nh, HD] gradient, through rows [r0, r0 + 16) of
// `stage` (pitch HD + PAD) to 16-byte stores
template <int HD>
__device__ __forceinline__ void store_grad(__nv_bfloat16* out, const float (&acc)[HD / 8][4],
                                           __nv_bfloat16* stage, int r0, int s0, int h, int nh,
                                           int lane, float mul) {
  constexpr int QP = HD + PAD, CH = HD / 8;
  const int g = lane >> 2, t = lane & 3;
  __syncwarp();  // the lanes' reads of these rows for the last gradient are done
#pragma unroll
  for (int ri = 0; ri < 2; ++ri) {
    __nv_bfloat16* row = stage + (r0 + g + 8 * ri) * QP + 2 * t;
#pragma unroll
    for (int d = 0; d < HD / 8; ++d)
      *reinterpret_cast<uint32_t*>(row + d * 8) =
          vr2::pack_bf16(acc[d][2 * ri] * mul, acc[d][2 * ri + 1] * mul);
  }
  __syncwarp();
#pragma unroll
  for (int i = lane; i < 16 * CH; i += vr2::kWarp) {
    const int r = i / CH, c = (i - r * CH) * 8;
    *reinterpret_cast<uint4*>(out + ((long long)(s0 + r0 + r) * nh + h) * HD + c) =
        *reinterpret_cast<const uint4*>(stage + (r0 + r) * QP + c);
  }
}

template <int HD>
__global__ void __launch_bounds__(NTHREADS) window_attn_bwd_kernel(const WinBwdParams p) {
  using W = BwdStage<HD>;
  constexpr int QP = W::PITCH;  // pitch of the q / k / v / dO tiles
  constexpr int SP = W::SP;     // pitch of the P and dS tiles
  constexpr int NT = WP / 8;    // 8-key tiles of S
  constexpr int DT = HD / 8;    // 8-dim tiles of a gradient
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sP = reinterpret_cast<__nv_bfloat16*>(smem_raw + W::STAGES * W::BYTES);
  __nv_bfloat16* sdS = sP + WP * SP;
  const int tid = threadIdx.x, warp = tid / vr2::kWarp, lane = tid % vr2::kWarp;
  const int g = lane >> 2, t = lane & 3;
  const int l8 = lane & 7, j4 = lane >> 3;  // ldmatrix: the row and tile a lane addresses
  const int r0 = warp * 16;                 // this warp's 16 query rows, then its 16 keys
  const int items = p.nh * p.nw;
  const int first = int((long long)blockIdx.x * items / gridDim.x);
  const int end = int((long long)(blockIdx.x + 1) * items / gridDim.x);

  for (int s = 0; s < W::STAGES - 1; ++s) {  // the ring's first windows
    if (first + s < end) load_window<HD>(smem_raw + s * W::BYTES, p, first + s, tid);
    vr2::cp_async_commit();
  }
  for (int it = first, sl = 0; it < end; ++it, sl = sl + 1 == W::STAGES ? 0 : sl + 1) {
    vr2::cp_async_wait<W::STAGES - 2>();  // this window has landed (this thread's copies)
    __syncthreads();  // ... every thread's; the last window's stage, P and dS are free
    const int nx = it + W::STAGES - 1;
    if (nx < end)
      load_window<HD>(smem_raw + (sl == 0 ? W::STAGES - 1 : sl - 1) * W::BYTES, p, nx, tid);
    vr2::cp_async_commit();

    unsigned char* st = smem_raw + sl * W::BYTES;
    const __nv_bfloat16* sQ = reinterpret_cast<const __nv_bfloat16*>(st);
    const __nv_bfloat16* sK = sQ + WP * QP;
    __nv_bfloat16* sV = reinterpret_cast<__nv_bfloat16*>(st) + 2 * WP * QP;
    const __nv_bfloat16* sdO = sV + WP * QP;
    const unsigned char* sValid = st + 4 * W::TILE;
    const int h = it % p.nh, s0 = it / p.nh * WP;

    // S = Q K^T and dP = dO V^T over this warp's 16 query rows
    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      uint32_t qa[4], da[4];
      const int aoff = (r0 + l8 + 8 * (j4 & 1)) * QP + kk * 16 + 8 * (j4 >> 1);
      vr2::ldsm_x4(qa, sQ + aoff);
      vr2::ldsm_x4(da, sdO + aoff);
#pragma unroll
      for (int n2 = 0; n2 < NT / 2; ++n2) {  // keys 16 n2 .. + 15: two n tiles
        uint32_t kb[4], vb[4];
        const int boff = (16 * n2 + l8 + 8 * (j4 >> 1)) * QP + kk * 16 + 8 * (j4 & 1);
        vr2::ldsm_x4(kb, sK + boff);
        vr2::ldsm_x4(vb, sV + boff);
        vr2::mma_bf16_16816(s[2 * n2], qa, kb[0], kb[1]);
        vr2::mma_bf16_16816(s[2 * n2 + 1], qa, kb[2], kb[3]);
        vr2::mma_bf16_16816(dp[2 * n2], da, vb[0], vb[1]);
        vr2::mma_bf16_16816(dp[2 * n2 + 1], da, vb[2], vb[3]);
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

    // O = P V with P in bf16 (V by ldmatrix .trans), then D = rowsum(dO * O)
    // from bf16 pairs of this lane's dO elements
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
    float D[2] = {0.f, 0.f};
#pragma unroll
    for (int ri = 0; ri < 2; ++ri) {
      const __nv_bfloat16* dorow = sdO + (r0 + g + 8 * ri) * QP + 2 * t;
#pragma unroll
      for (int d = 0; d < DT; ++d) {
        const float2 o2 =
            __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(dorow + d * 8));
        D[ri] += acc[d][2 * ri] * o2.x + acc[d][2 * ri + 1] * o2.y;
      }
      D[ri] = vr2::quad_sum(D[ri]);
    }

    // dS = P (dP - D) into dp; P (the bf16 P that made O) and dS go
    // row-major to shared memory for the key side, as bf16 pairs
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int ri = 0; ri < 2; ++ri) {
        const int at = (r0 + g + 8 * ri) * SP + n * 8 + 2 * t;
        dp[n][2 * ri] = s[n][2 * ri] * (dp[n][2 * ri] - D[ri]);
        dp[n][2 * ri + 1] = s[n][2 * ri + 1] * (dp[n][2 * ri + 1] - D[ri]);
        *reinterpret_cast<uint32_t*>(sP + at) = vr2::pack_bf16(s[n][2 * ri], s[n][2 * ri + 1]);
        *reinterpret_cast<uint32_t*>(sdS + at) =
            vr2::pack_bf16(dp[n][2 * ri], dp[n][2 * ri + 1]);
      }
    }
    __syncthreads();  // every warp's P and dS are in, and no warp reads V again

    // dQ = scale dS K (K by ldmatrix .trans)
#pragma unroll
    for (int d = 0; d < DT; ++d) acc[d][0] = acc[d][1] = acc[d][2] = acc[d][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < WP / 16; ++kk) {
      uint32_t sa[4];
      vr2::c_to_a(sa, dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
      for (int d2 = 0; d2 < DT / 2; ++d2) {
        uint32_t kb[4];
        vr2::ldsm_x4_trans(kb, sK + (kk * 16 + l8 + 8 * (j4 & 1)) * QP + 16 * d2 + 8 * (j4 >> 1));
        vr2::mma_bf16_16816(acc[2 * d2], sa, kb[0], kb[1]);
        vr2::mma_bf16_16816(acc[2 * d2 + 1], sa, kb[2], kb[3]);
      }
    }
    store_grad<HD>(p.dq, acc, sV, r0, s0, h, p.nh, lane, p.scale);

    // key side: this warp's 16 keys. dV = P^T dO, then dK = scale dS^T Q:
    // P^T and dS^T (A) and dO and Q (B) all by ldmatrix .trans
#pragma unroll
    for (int pass = 0; pass < 2; ++pass) {
      const __nv_bfloat16* at = pass == 0 ? sP : sdS;
      const __nv_bfloat16* bt = pass == 0 ? sdO : sQ;
#pragma unroll
      for (int d = 0; d < DT; ++d) acc[d][0] = acc[d][1] = acc[d][2] = acc[d][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < WP / 16; ++kk) {  // queries 16 kk .. + 15
        uint32_t a[4];
        vr2::ldsm_x4_trans(a, at + (kk * 16 + l8 + 8 * (j4 >> 1)) * SP + r0 + 8 * (j4 & 1));
#pragma unroll
        for (int d2 = 0; d2 < DT / 2; ++d2) {
          uint32_t b[4];
          vr2::ldsm_x4_trans(b, bt + (kk * 16 + l8 + 8 * (j4 & 1)) * QP + 16 * d2 + 8 * (j4 >> 1));
          vr2::mma_bf16_16816(acc[2 * d2], a, b[0], b[1]);
          vr2::mma_bf16_16816(acc[2 * d2 + 1], a, b[2], b[3]);
        }
      }
      store_grad<HD>(pass == 0 ? p.dv : p.dk, acc, sV, r0, s0, h, p.nh, lane,
                     pass == 0 ? 1.f : p.scale);
    }
  }
}

// The bf16 kernel's dynamic shared memory and its blocks resident an SM
// (the occupancy calculator's count) with the card's SMs, found once
template <int HD>
cudaError_t window_bwd_occupancy(int& resident, int& sms) {
  constexpr int smem = BwdStage<HD>::SMEM;
  static int res = 0, n_sm = 0;
  cudaError_t err = cudaFuncSetAttribute(
      window_attn_bwd_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(window_attn_bwd_kernel<HD>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               int(cudaSharedmemCarveoutMaxShared));
  if (err != cudaSuccess) return err;
  if (res == 0) {
    int dev = 0;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
        (err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev)) !=
            cudaSuccess ||
        (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&res, window_attn_bwd_kernel<HD>,
                                                             NTHREADS, smem)) != cudaSuccess)
      return err;
    if (res < 1) return cudaErrorInvalidConfiguration;
  }
  resident = res;
  sms = n_sm;
  return cudaSuccess;
}

template <int HD>
cudaError_t launch_window_bwd(const WinBwdParams& p, cudaStream_t stream) {
  int resident = 0, sms = 0;
  cudaError_t err = window_bwd_occupancy<HD>(resident, sms);
  if (err != cudaSuccess) return err;
  const int grid = min(p.nh * p.nw, resident * sms);
  window_attn_bwd_kernel<HD><<<grid, NTHREADS, BwdStage<HD>::SMEM, stream>>>(p);
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

// Plain C entry points, loaded with ctypes. S is a multiple of 64; q / k / v
// strides are in elements; dout is a contiguous [S, nh, hd]; dq / dk / dv
// are written as contiguous [S, nh, hd]. bf16: hd 64, 80 or 128, q / k / v
// rows 16-byte aligned, valid 16-byte aligned; fp32 (fp32 != 0): any hd up
// to 128. Returns a cudaError_t.
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
  if (reinterpret_cast<uintptr_t>(valid) % 16 != 0) return int(cudaErrorInvalidValue);
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
  p.nw = S / WP;
  p.q_ss = q_ss;
  p.q_sh = q_sh;
  p.k_ss = k_ss;
  p.k_sh = k_sh;
  p.v_ss = v_ss;
  p.v_sh = v_sh;
  p.scale = scale;
  switch (hd) {
    case 64: return launch_window_bwd<64>(p, st);
    case 80: return launch_window_bwd<80>(p, st);
    case 128: return launch_window_bwd<128>(p, st);
    default: return int(cudaErrorInvalidValue);
  }
}

// The bf16 kernel's launch layout at head dim hd: out[0] its threads a
// block, out[1] its blocks resident an SM, out[2] the card's SMs (the grid
// is min(heads x windows, out[1] x out[2]) blocks)
extern "C" int vr2_window_attention_bwd_layout(int hd, int* out) {
  int resident = 0, sms = 0;
  cudaError_t err;
  switch (hd) {
    case 64: err = window_bwd_occupancy<64>(resident, sms); break;
    case 80: err = window_bwd_occupancy<80>(resident, sms); break;
    case 128: err = window_bwd_occupancy<128>(resident, sms); break;
    default: return int(cudaErrorInvalidValue);
  }
  out[0] = NTHREADS;
  out[1] = resident;
  out[2] = sms;
  return int(err);
}
