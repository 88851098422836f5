// Flash attention forward for Hopper (sm_90a): bf16 in, fp32 accumulation.
//
// Replaces the TPU kernel video_r2_tpu/ops/flash.py::_flash_kernel (:80),
// with the same semantics: online softmax over key tiles; GQA (kv head =
// q head / (nh / kh)); per-batch kv-length prefix; causal with whole-tile
// skip past the diagonal and an in-tile mask (key <= q_offset + row);
// optional segment ids (a key is admitted only where its id equals the
// query's); a row that admits no key emits 0. With an `lse` output it is
// also the training forward, replacing video_r2_tpu/ops/flash.py::
// _flash_fwd_kernel (:99): it writes the log-sum-exp of each row's scaled
// scores in fp32 ([B, nh, Sq]; +1e30 for a row that admits no key, so that
// the backward's exp(s - lse) is exactly 0 there), from the quad-reduced
// row sum and the running max it was accumulated against.
//
// What bounds it on the card: at the serving shapes (prefill Sq ~1.5k,
// hd 128; ViT groups L = 1024, hd 80) each (batch, head) reads its K/V rows
// once per 64-row query tile, so the kernel is bound by tensor-core issue
// and the softmax's exp/shuffle work, not by device memory.
// What the design does about it: the TPU kernel keeps a whole kv row in VMEM
// (flash.py:239-242); here 64-key K and V^T tiles stream through shared
// memory and the 64x64 score tile lives only in registers (mma.sync
// m16n8k16: the score C fragments are the A operand of P @ V). Operands are
// read by stride from [B, S, heads, hd], so no head-major transpose is made.
// One 128-thread block per (64 query rows, head, batch); each warp owns 16
// rows. Loads are synchronous and single-buffered: simple first; cp.async /
// TMA pipelining and wgmma are for later work.
#include <climits>
#include <cmath>

#include "attn_common.cuh"

namespace {

constexpr int BQ = 64;        // query rows per block (4 warps x 16)
constexpr int BK = 64;        // keys per tile
constexpr int NTHREADS = 128;
constexpr int PAD = 8;        // shared-memory row padding (bank spread)

struct FlashParams {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  __nv_bfloat16* o;           // [B, Sq, nh, hd] contiguous
  float* lse;                 // [B, nh, Sq] or null (serving)
  const int* kv_lengths;      // [B]
  const int* seg;             // [B, Sk] or null (requires Sq == Sk)
  int Sq, Sk, nh, kh;
  long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
  int causal, q_offset;
  float scale;
};

template <int HD>
constexpr size_t flash_smem_bytes() {
  return (size_t(BQ) * (HD + PAD) + size_t(BK) * (HD + PAD) + size_t(HD) * (BK + PAD)) *
             sizeof(__nv_bfloat16) +
         BK * sizeof(int);
}

template <int HD>
__global__ void __launch_bounds__(NTHREADS) flash_fwd_kernel(const FlashParams p) {
  constexpr int QP = HD + PAD;  // pitch of the Q and K tiles
  constexpr int VP = BK + PAD;  // pitch of the transposed V tile
  constexpr int NT = BK / 8;    // 8-key column blocks of a score tile
  constexpr int DT = HD / 8;    // 8-wide column blocks of the output
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sK = sQ + BQ * QP;
  __nv_bfloat16* sVt = sK + BK * QP;
  int* sKseg = reinterpret_cast<int*>(sVt + HD * VP);

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (p.nh / p.kh);
  const int tid = threadIdx.x, warp = tid / vr2::kWarp, lane = tid % vr2::kWarp;
  const int g = lane >> 2, t = lane & 3;

  const __nv_bfloat16* qb = p.q + b * p.q_sb + h * p.q_sh;
  const __nv_bfloat16* kb = p.k + b * p.k_sb + hk * p.k_sh;
  const __nv_bfloat16* vb = p.v + b * p.v_sb + hk * p.v_sh;

  vr2::load_tile<HD>(sQ, QP, qb + q0 * p.q_ss, p.q_ss, BQ, p.Sq - q0, tid, NTHREADS);
  __syncthreads();
  const int r_lo = warp * 16 + g;  // this lane's tile rows: r_lo and r_lo + 8
  uint32_t qa[HD / 16][4];
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const __nv_bfloat16* qp = sQ + r_lo * QP + kk * 16 + 2 * t;
    qa[kk][0] = vr2::ld_pair(qp);
    qa[kk][1] = vr2::ld_pair(qp + 8 * QP);
    qa[kk][2] = vr2::ld_pair(qp + 8);
    qa[kk][3] = vr2::ld_pair(qp + 8 * QP + 8);
  }

  const int kv_len = min(p.kv_lengths[b], p.Sk);
  const int row[2] = {q0 + r_lo, q0 + r_lo + 8};
  int qseg[2] = {INT_MIN, INT_MIN};
  if (p.seg != nullptr) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
      if (row[i] < p.Sq) qseg[i] = p.seg[(long long)b * p.Sk + row[i]];
  }
  int limit = kv_len;
  if (p.causal) limit = min(limit, p.q_offset + q0 + BQ);
  const int n_tiles = limit > 0 ? (limit + BK - 1) / BK : 0;

  float acc[DT][4];
#pragma unroll
  for (int d = 0; d < DT; ++d) acc[d][0] = acc[d][1] = acc[d][2] = acc[d][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};  // per-lane partial row sums (quad-reduced at the end)

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // every warp is done with the previous K / V tile
    vr2::load_tile<HD>(sK, QP, kb + k0 * p.k_ss, p.k_ss, BK, p.Sk - k0, tid, NTHREADS);
    vr2::load_tile_transposed<HD>(sVt, VP, vb + k0 * p.v_ss, p.v_ss, BK, p.Sk - k0, tid,
                                  NTHREADS);
    if (p.seg != nullptr) {
      for (int i = tid; i < BK; i += NTHREADS)
        sKseg[i] = (k0 + i < p.Sk) ? p.seg[(long long)b * p.Sk + k0 + i] : INT_MIN;
    }
    __syncthreads();

    // S = Q K^T for this warp's 16 rows x 64 keys
    float s[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const __nv_bfloat16* kp = sK + (n * 8 + g) * QP + kk * 16 + 2 * t;
        vr2::mma_bf16_16816(s[n], qa[kk], vr2::ld_pair(kp), vr2::ld_pair(kp + 8));
      }
    }

    // mask, scale, running max
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ri = e >> 1;
        const int key = k0 + n * 8 + 2 * t + (e & 1);
        bool ok = key < kv_len;
        if (p.causal) ok = ok && key <= p.q_offset + row[ri];
        if (p.seg != nullptr) ok = ok && sKseg[key - k0] == qseg[ri];
        const float x = ok ? s[n][e] * p.scale : -INFINITY;
        s[n][e] = x;
        mx[ri] = fmaxf(mx[ri], x);
      }
    }
    float alpha[2], mref[2];
#pragma unroll
    for (int ri = 0; ri < 2; ++ri) {
      const float m_new = fmaxf(m[ri], vr2::quad_max(mx[ri]));
      mref[ri] = (m_new == -INFINITY) ? 0.f : m_new;  // no admitted key yet
      alpha[ri] = __expf(m[ri] - mref[ri]);
      m[ri] = m_new;
      l[ri] *= alpha[ri];
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
    for (int d = 0; d < DT; ++d) {
      acc[d][0] *= alpha[0];
      acc[d][1] *= alpha[0];
      acc[d][2] *= alpha[1];
      acc[d][3] *= alpha[1];
    }

    // O += P V with P rounded to bf16 (the operand type)
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
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
  }

  float inv[2];
#pragma unroll
  for (int ri = 0; ri < 2; ++ri) {
    const float tot = vr2::quad_sum(l[ri]);
    inv[ri] = tot > 0.f ? 1.f / tot : 0.f;  // a row with no admitted key emits 0
    // l is relative to the running max m (finite once a key was admitted)
    if (p.lse != nullptr && t == 0 && row[ri] < p.Sq)
      p.lse[((long long)b * p.nh + h) * p.Sq + row[ri]] =
          tot > 0.f ? m[ri] + logf(tot) : 1e30f;
  }
#pragma unroll
  for (int ri = 0; ri < 2; ++ri) {
    if (row[ri] >= p.Sq) continue;
    __nv_bfloat16* op = p.o + (((long long)b * p.Sq + row[ri]) * p.nh + h) * HD + 2 * t;
#pragma unroll
    for (int d = 0; d < DT; ++d) {
      *reinterpret_cast<__nv_bfloat162*>(op + d * 8) =
          __floats2bfloat162_rn(acc[d][2 * ri] * inv[ri], acc[d][2 * ri + 1] * inv[ri]);
    }
  }
}

template <int HD>
cudaError_t launch_flash(const FlashParams& p, int B, cudaStream_t stream) {
  constexpr size_t smem = flash_smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Sq + BQ - 1) / BQ, p.nh, B);
  flash_fwd_kernel<HD><<<grid, NTHREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point, loaded with ctypes. Strides are in elements; the
// output is a contiguous [B, Sq, nh, hd]; lse (fp32 [B, nh, Sq]) may be
// null. Returns a cudaError_t.
extern "C" int vr2_flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, void* lse, const int* kv_lengths,
    const int* seg, int B, int Sq, int Sk, int nh, int kh, int hd, long long q_sb,
    long long q_ss, long long q_sh, long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh, int causal, int q_offset, float scale,
    void* stream) {
  FlashParams p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.o = static_cast<__nv_bfloat16*>(o);
  p.lse = static_cast<float*>(lse);
  p.kv_lengths = kv_lengths;
  p.seg = seg;
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
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 64: return launch_flash<64>(p, B, st);
    case 80: return launch_flash<80>(p, B, st);
    case 128: return launch_flash<128>(p, B, st);
    default: return int(cudaErrorInvalidValue);
  }
}
