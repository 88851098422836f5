// Flash attention backward for Hopper (sm_90a): bf16 in, fp32 accumulation.
//
// Replaces the TPU kernels video_r2_tpu/ops/flash.py::_flash_bwd_dq_kernel
// (:116) and ::_flash_bwd_dkv_kernel (:164): the FA2 recompute backward from
// the forward's per-row log-sum-exp (flash_attn.cu with an lse output).
// With s = scale * q k^T under the forward's mask (kv length, causal,
// segments), p = exp(s - lse), dp = do v^T, ds = p * (dp - delta) and
// delta = rowsum(do * o) (a torch reduction before the launch, as the JAX
// package computes it in XLA outside Pallas, flash.py:314):
//   dq = scale * ds k                  (one block per 64 query rows, head)
//   dk = scale * ds^T q, dv = p^T do   (one block per 64 keys, kv head)
// The dk/dv block loops over the g query heads of its GQA group and sums
// them in fp32 registers, writing bf16 once: the TPU kernel writes
// [B, nh, Sk, hd] fp32 and sums the group outside (flash.py:359-363).
//
// What bounds it on the card: at the training shapes (decoder Sq = Sk ~2.4k,
// hd 128; ViT groups L = 1024, hd 80) every block re-reads its K/V (dq) or
// Q/dO (dk/dv) tiles once per 64-row tile of the other side, so the kernels
// are bound by tensor-core issue (5 products per tile pair against the
// forward's 2) and the exp work, not by device memory.
// What the design does about it: score, probability and dS tiles live only
// in registers (mma.sync m16n8k16; C fragments of S are the A operand of
// the next product); K^T, Q^T and dO^T tiles are stored transposed in shared
// memory so every B operand is one 32-bit shared load; causal blocks skip
// the tiles past the diagonal on both sides, and a key tile past the kv
// length writes zeros without a loop. Loads are synchronous and
// single-buffered: simple first; pipelining and wgmma are for later work.
#include <climits>
#include <cmath>

#include "attn_common.cuh"

namespace {

constexpr int BT = 64;        // rows of a query tile and of a key tile (4 warps x 16)
constexpr int NTHREADS = 128;
constexpr int PAD = 8;        // shared-memory row padding (bank spread)

struct FlashBwdParams {
  const __nv_bfloat16* q;     // [B, Sq, nh, hd] by stride
  const __nv_bfloat16* k;     // [B, Sk, kh, hd] by stride
  const __nv_bfloat16* v;
  const __nv_bfloat16* dout;  // [B, Sq, nh, hd] contiguous
  const float* lse;           // [B, nh, Sq]
  const float* delta;         // [B, nh, Sq]
  const int* kv_lengths;      // [B]
  const int* seg;             // [B, Sk] or null (requires Sq == Sk)
  __nv_bfloat16* dq;          // [B, Sq, nh, hd] contiguous
  __nv_bfloat16* dk;          // [B, Sk, kh, hd] contiguous
  __nv_bfloat16* dv;
  int Sq, Sk, nh, kh;
  long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
  int causal, q_offset;
  float scale;
};

// key `key` is admitted for query `row` (segment test done by the caller)
__device__ __forceinline__ bool admitted(const FlashBwdParams& p, int key, int row,
                                         int kv_len) {
  return key < kv_len && (!p.causal || key <= p.q_offset + row);
}

template <int HD>
constexpr size_t dq_smem_bytes() {
  return (4 * size_t(BT) * (HD + PAD) + size_t(HD) * (BT + PAD)) * sizeof(__nv_bfloat16) +
         BT * sizeof(int);
}

// dq for one (64 query rows, head, batch): loops over the key tiles the
// forward visited; each warp owns 16 query rows.
template <int HD>
__global__ void __launch_bounds__(NTHREADS) flash_bwd_dq_kernel(const FlashBwdParams p) {
  constexpr int QP = HD + PAD;  // pitch of the row-major tiles
  constexpr int TP = BT + PAD;  // pitch of the transposed K tile
  constexpr int NT = BT / 8;    // 8-key column blocks of a score tile
  constexpr int DT = HD / 8;    // 8-wide column blocks of dq
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sdO = sQ + BT * QP;
  __nv_bfloat16* sK = sdO + BT * QP;
  __nv_bfloat16* sV = sK + BT * QP;
  __nv_bfloat16* sKt = sV + BT * QP;
  int* sKseg = reinterpret_cast<int*>(sKt + HD * TP);

  const int q0 = blockIdx.x * BT, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (p.nh / p.kh);
  const int tid = threadIdx.x, warp = tid / vr2::kWarp, lane = tid % vr2::kWarp;
  const int g = lane >> 2, t = lane & 3;
  const long long do_ss = (long long)p.nh * HD;

  const __nv_bfloat16* kb = p.k + b * p.k_sb + hk * p.k_sh;
  const __nv_bfloat16* vb = p.v + b * p.v_sb + hk * p.v_sh;
  vr2::load_tile<HD>(sQ, QP, p.q + b * p.q_sb + h * p.q_sh + q0 * p.q_ss, p.q_ss, BT,
                     p.Sq - q0, tid, NTHREADS);
  vr2::load_tile<HD>(sdO, QP, p.dout + ((long long)b * p.Sq + q0) * do_ss + h * HD, do_ss,
                     BT, p.Sq - q0, tid, NTHREADS);

  const int kv_len = min(p.kv_lengths[b], p.Sk);
  const int r_lo = warp * 16 + g;
  const int row[2] = {q0 + r_lo, q0 + r_lo + 8};
  float lse[2], delta[2];
  int qseg[2] = {INT_MIN, INT_MIN};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const long long at = ((long long)b * p.nh + h) * p.Sq + row[i];
    lse[i] = row[i] < p.Sq ? p.lse[at] : 1e30f;  // rows past Sq: p = 0
    delta[i] = row[i] < p.Sq ? p.delta[at] : 0.f;
    if (p.seg != nullptr && row[i] < p.Sq) qseg[i] = p.seg[(long long)b * p.Sk + row[i]];
  }
  int limit = kv_len;
  if (p.causal) limit = min(limit, p.q_offset + q0 + BT);
  const int n_tiles = limit > 0 ? (limit + BT - 1) / BT : 0;

  float acc[DT][4];
#pragma unroll
  for (int d = 0; d < DT; ++d) acc[d][0] = acc[d][1] = acc[d][2] = acc[d][3] = 0.f;

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * BT;
    __syncthreads();  // every warp is done with the previous tiles (and sQ / sdO are in)
    vr2::load_tile<HD>(sK, QP, kb + k0 * p.k_ss, p.k_ss, BT, p.Sk - k0, tid, NTHREADS);
    vr2::load_tile<HD>(sV, QP, vb + k0 * p.v_ss, p.v_ss, BT, p.Sk - k0, tid, NTHREADS);
    vr2::load_tile_transposed<HD>(sKt, TP, kb + k0 * p.k_ss, p.k_ss, BT, p.Sk - k0, tid,
                                  NTHREADS);
    if (p.seg != nullptr) {
      for (int i = tid; i < BT; i += NTHREADS)
        sKseg[i] = (k0 + i < p.Sk) ? p.seg[(long long)b * p.Sk + k0 + i] : INT_MIN;
    }
    __syncthreads();

    // S = Q K^T and dP = dO V^T for this warp's 16 rows x 64 keys
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

    // P = exp(S - lse) under the forward's mask; dS = P (dP - delta), into s
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ri = e >> 1;
        const int key = k0 + n * 8 + 2 * t + (e & 1);
        bool ok = admitted(p, key, row[ri], kv_len);
        if (p.seg != nullptr) ok = ok && sKseg[key - k0] == qseg[ri];
        const float pe = ok ? __expf(s[n][e] * p.scale - lse[ri]) : 0.f;
        s[n][e] = pe * (dp[n][e] - delta[ri]);
      }
    }

    // dQ += dS K (dS rounded to bf16, the operand type)
#pragma unroll
    for (int kk = 0; kk < BT / 16; ++kk) {
      uint32_t sa[4];
      vr2::c_to_a(sa, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int d = 0; d < DT; ++d) {
        const __nv_bfloat16* kp = sKt + (d * 8 + g) * TP + kk * 16 + 2 * t;
        vr2::mma_bf16_16816(acc[d], sa, vr2::ld_pair(kp), vr2::ld_pair(kp + 8));
      }
    }
  }

#pragma unroll
  for (int ri = 0; ri < 2; ++ri) {
    if (row[ri] >= p.Sq) continue;
    __nv_bfloat16* op = p.dq + (((long long)b * p.Sq + row[ri]) * p.nh + h) * HD + 2 * t;
#pragma unroll
    for (int d = 0; d < DT; ++d) {
      *reinterpret_cast<__nv_bfloat162*>(op + d * 8) = __floats2bfloat162_rn(
          acc[d][2 * ri] * p.scale, acc[d][2 * ri + 1] * p.scale);
    }
  }
}

template <int HD>
constexpr size_t dkv_smem_bytes() {
  return (4 * size_t(BT) * (HD + PAD) + 2 * size_t(HD) * (BT + PAD)) *
             sizeof(__nv_bfloat16) +
         BT * (2 * sizeof(float) + sizeof(int));
}

// dk / dv for one (64 keys, kv head, batch): loops over the g query heads of
// the group and, for each, over the query tiles that reach these keys. The
// products run transposed (keys as rows): each warp owns 16 keys, so S^T,
// P^T and dS^T are C fragments whose rows are this warp's keys.
template <int HD>
__global__ void __launch_bounds__(NTHREADS) flash_bwd_dkv_kernel(const FlashBwdParams p) {
  constexpr int QP = HD + PAD;
  constexpr int TP = BT + PAD;
  constexpr int NT = BT / 8;    // 8-query column blocks of a transposed score tile
  constexpr int DT = HD / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sV = sK + BT * QP;
  __nv_bfloat16* sQ = sV + BT * QP;
  __nv_bfloat16* sdO = sQ + BT * QP;
  __nv_bfloat16* sQt = sdO + BT * QP;
  __nv_bfloat16* sdOt = sQt + HD * TP;
  float* sLse = reinterpret_cast<float*>(sdOt + HD * TP);
  float* sDelta = sLse + BT;
  int* sQseg = reinterpret_cast<int*>(sDelta + BT);

  const int k0 = blockIdx.x * BT, hk = blockIdx.y, b = blockIdx.z;
  const int group = p.nh / p.kh;
  const int tid = threadIdx.x, warp = tid / vr2::kWarp, lane = tid % vr2::kWarp;
  const int g = lane >> 2, t = lane & 3;
  const long long do_ss = (long long)p.nh * HD;

  vr2::load_tile<HD>(sK, QP, p.k + b * p.k_sb + hk * p.k_sh + k0 * p.k_ss, p.k_ss, BT,
                     p.Sk - k0, tid, NTHREADS);
  vr2::load_tile<HD>(sV, QP, p.v + b * p.v_sb + hk * p.v_sh + k0 * p.v_ss, p.v_ss, BT,
                     p.Sk - k0, tid, NTHREADS);

  const int kv_len = min(p.kv_lengths[b], p.Sk);
  const int r_lo = warp * 16 + g;
  const int key[2] = {k0 + r_lo, k0 + r_lo + 8};
  int kseg[2] = {INT_MIN, INT_MIN};
  if (p.seg != nullptr) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
      if (key[i] < p.Sk) kseg[i] = p.seg[(long long)b * p.Sk + key[i]];
  }

  float dk[DT][4], dv[DT][4];
#pragma unroll
  for (int d = 0; d < DT; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[d][e] = dv[d][e] = 0.f;

  // no query admits a key past the kv length: such tiles write zeros
  const int n_qt = k0 < kv_len ? (p.Sq + BT - 1) / BT : 0;
  // the first query tile whose last row reaches this tile's first key
  const int qt_lo = p.causal ? max(k0 - p.q_offset, 0) / BT : 0;

  for (int j = 0; j < group; ++j) {
    const int h = hk * group + j;
    const __nv_bfloat16* qb = p.q + b * p.q_sb + h * p.q_sh;
    const __nv_bfloat16* dob = p.dout + (long long)b * p.Sq * do_ss + h * HD;
    for (int qt = qt_lo; qt < n_qt; ++qt) {
      const int q0 = qt * BT;
      __syncthreads();  // every warp is done with the previous query tile
      vr2::load_tile<HD>(sQ, QP, qb + q0 * p.q_ss, p.q_ss, BT, p.Sq - q0, tid, NTHREADS);
      vr2::load_tile<HD>(sdO, QP, dob + q0 * do_ss, do_ss, BT, p.Sq - q0, tid, NTHREADS);
      vr2::load_tile_transposed<HD>(sQt, TP, qb + q0 * p.q_ss, p.q_ss, BT, p.Sq - q0, tid,
                                    NTHREADS);
      vr2::load_tile_transposed<HD>(sdOt, TP, dob + q0 * do_ss, do_ss, BT, p.Sq - q0, tid,
                                    NTHREADS);
      for (int i = tid; i < BT; i += NTHREADS) {
        const int row = q0 + i;
        const long long at = ((long long)b * p.nh + h) * p.Sq + row;
        sLse[i] = row < p.Sq ? p.lse[at] : 1e30f;  // rows past Sq: p = 0
        sDelta[i] = row < p.Sq ? p.delta[at] : 0.f;
        sQseg[i] = (p.seg != nullptr && row < p.Sq) ? p.seg[(long long)b * p.Sk + row]
                                                     : INT_MIN;
      }
      __syncthreads();

      // S^T = K Q^T and dP^T = V dO^T for this warp's 16 keys x 64 queries
      float s[NT][4], dp[NT][4];
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        uint32_t ka[4], va[4];
        vr2::ld_a_frag(ka, sK + r_lo * QP + kk * 16 + 2 * t, QP);
        vr2::ld_a_frag(va, sV + r_lo * QP + kk * 16 + 2 * t, QP);
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          const int off = (n * 8 + g) * QP + kk * 16 + 2 * t;
          vr2::mma_bf16_16816(s[n], ka, vr2::ld_pair(sQ + off), vr2::ld_pair(sQ + off + 8));
          vr2::mma_bf16_16816(dp[n], va, vr2::ld_pair(sdO + off),
                              vr2::ld_pair(sdO + off + 8));
        }
      }

      // P^T under the forward's mask (into s) and dS^T = P^T (dP^T - delta)
#pragma unroll
      for (int n = 0; n < NT; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int ki = e >> 1;
          const int qi = n * 8 + 2 * t + (e & 1);
          bool ok = admitted(p, key[ki], q0 + qi, kv_len);
          if (p.seg != nullptr) ok = ok && sQseg[qi] == kseg[ki];
          const float pe = ok ? __expf(s[n][e] * p.scale - sLse[qi]) : 0.f;
          s[n][e] = pe;
          dp[n][e] = pe * (dp[n][e] - sDelta[qi]);
        }
      }

      // dV += P^T dO and dK += dS^T Q (both rounded to bf16 operands)
#pragma unroll
      for (int kk = 0; kk < BT / 16; ++kk) {
        uint32_t pa[4], sa[4];
        vr2::c_to_a(pa, s[2 * kk], s[2 * kk + 1]);
        vr2::c_to_a(sa, dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
        for (int d = 0; d < DT; ++d) {
          const int off = (d * 8 + g) * TP + kk * 16 + 2 * t;
          vr2::mma_bf16_16816(dv[d], pa, vr2::ld_pair(sdOt + off), vr2::ld_pair(sdOt + off + 8));
          vr2::mma_bf16_16816(dk[d], sa, vr2::ld_pair(sQt + off), vr2::ld_pair(sQt + off + 8));
        }
      }
    }
  }

#pragma unroll
  for (int ki = 0; ki < 2; ++ki) {
    if (key[ki] >= p.Sk) continue;
    const long long at = (((long long)b * p.Sk + key[ki]) * p.kh + hk) * HD + 2 * t;
#pragma unroll
    for (int d = 0; d < DT; ++d) {
      *reinterpret_cast<__nv_bfloat162*>(p.dk + at + d * 8) = __floats2bfloat162_rn(
          dk[d][2 * ki] * p.scale, dk[d][2 * ki + 1] * p.scale);
      *reinterpret_cast<__nv_bfloat162*>(p.dv + at + d * 8) =
          __floats2bfloat162_rn(dv[d][2 * ki], dv[d][2 * ki + 1]);
    }
  }
}

template <int HD>
cudaError_t launch_dq(const FlashBwdParams& p, int B, cudaStream_t stream) {
  constexpr size_t smem = dq_smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Sq + BT - 1) / BT, p.nh, B);
  flash_bwd_dq_kernel<HD><<<grid, NTHREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_dkv(const FlashBwdParams& p, int B, cudaStream_t stream) {
  constexpr size_t smem = dkv_smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Sk + BT - 1) / BT, p.kh, B);
  flash_bwd_dkv_kernel<HD><<<grid, NTHREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

FlashBwdParams make_params(const void* q, const void* k, const void* v, const void* dout,
                           const float* lse, const float* delta, const int* kv_lengths,
                           const int* seg, void* dq, void* dk, void* dv, int Sq, int Sk,
                           int nh, int kh, long long q_sb, long long q_ss, long long q_sh,
                           long long k_sb, long long k_ss, long long k_sh, long long v_sb,
                           long long v_ss, long long v_sh, int causal, int q_offset,
                           float scale) {
  FlashBwdParams p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.dout = static_cast<const __nv_bfloat16*>(dout);
  p.lse = lse;
  p.delta = delta;
  p.kv_lengths = kv_lengths;
  p.seg = seg;
  p.dq = static_cast<__nv_bfloat16*>(dq);
  p.dk = static_cast<__nv_bfloat16*>(dk);
  p.dv = static_cast<__nv_bfloat16*>(dv);
  p.Sq = Sq;
  p.Sk = Sk;
  p.nh = nh;
  p.kh = kh;
  p.q_sb = q_sb;
  p.q_ss = q_ss;
  p.q_sh = q_sh;
  p.k_sb = k_sb;
  p.k_ss = k_ss;
  p.k_sh = k_sh;
  p.v_sb = v_sb;
  p.v_ss = v_ss;
  p.v_sh = v_sh;
  p.causal = causal;
  p.q_offset = q_offset;
  p.scale = scale;
  return p;
}

}  // namespace

// Plain C entry points, loaded with ctypes. q / k / v are read by stride
// (elements); dout is a contiguous [B, Sq, nh, hd]; lse and delta are fp32
// [B, nh, Sq]. dq is written as a contiguous [B, Sq, nh, hd], dk / dv as
// contiguous [B, Sk, kh, hd] (the GQA group already summed). Each returns a
// cudaError_t.
extern "C" int vr2_flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout, const float* lse,
    const float* delta, const int* kv_lengths, const int* seg, void* dq, int B, int Sq,
    int Sk, int nh, int kh, int hd, long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh, long long v_sb, long long v_ss,
    long long v_sh, int causal, int q_offset, float scale, void* stream) {
  const FlashBwdParams p =
      make_params(q, k, v, dout, lse, delta, kv_lengths, seg, dq, nullptr, nullptr, Sq, Sk,
                  nh, kh, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, causal,
                  q_offset, scale);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 64: return launch_dq<64>(p, B, st);
    case 80: return launch_dq<80>(p, B, st);
    case 128: return launch_dq<128>(p, B, st);
    default: return int(cudaErrorInvalidValue);
  }
}

extern "C" int vr2_flash_attention_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout, const float* lse,
    const float* delta, const int* kv_lengths, const int* seg, void* dk, void* dv, int B,
    int Sq, int Sk, int nh, int kh, int hd, long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh, long long v_sb, long long v_ss,
    long long v_sh, int causal, int q_offset, float scale, void* stream) {
  const FlashBwdParams p =
      make_params(q, k, v, dout, lse, delta, kv_lengths, seg, nullptr, dk, dv, Sq, Sk, nh,
                  kh, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, causal, q_offset,
                  scale);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 64: return launch_dkv<64>(p, B, st);
    case 80: return launch_dkv<80>(p, B, st);
    case 128: return launch_dkv<128>(p, B, st);
    default: return int(cudaErrorInvalidValue);
  }
}
