// Flash attention forward for Hopper (sm_90a): bf16 in, fp32 accumulation
// (an fp32 instance on the CUDA cores for fp32 operands, at the end).
//
// Replaces the TPU kernel video_r2_tpu/ops/flash.py::_flash_kernel (:80),
// with the same semantics: online softmax over key tiles; GQA (kv head =
// q head / (nh / kh)); per-batch kv-length prefix; causal with whole-tile
// skip past the diagonal and an in-tile mask (key <= q_offset + row);
// optional segment ids (a key is admitted only where its id equals the
// query's); a row that admits no key emits 0. P is rounded to bf16 before
// P V, every sum is fp32. With an `lse` output it is also the training
// forward, replacing video_r2_tpu/ops/flash.py::_flash_fwd_kernel (:99): it
// writes the log-sum-exp of each row's scaled scores in fp32 ([B, nh, Sq];
// +1e30 for a row that admits no key, so that the backward's exp(s - lse)
// is exactly 0 there), from the row sum and the running max it was
// accumulated against. The two are separate instantiations, so serving
// pays nothing for the LSE.
//
// What bounds it on the card: each admitted (row, key) pair costs 4 hd
// flops (S = Q K^T and P V). At the long shapes that is the bound: the
// 7B's prefill (B 3, Sq 1408, Sk 1440, 28 / 4 heads of 128, causal) takes
// 0.0395 ms at the bf16 peak against ~0.02 ms of bytes, the LoRA step's
// (B 2, S 2432) 0.0857 ms, the ViT's full-attention groups (hd 80,
// segments) likewise. Short sequences are bound by device memory instead:
// a 64 x 256 chunk of the W8A8 bench reads Q and writes O once (0.080 ms
// of bytes against 0.031 of products). The first version of this file
// (4-warp blocks of 64 rows, synchronous single-buffered loads, V^T built
// by scalar stores, mma.sync, the mask on every element) ran at 5.6% of
// the bound, 2.4-2.7x behind SDPA.
// What the design does about it (after flash_attn_bwd.cu and moe_ffn.cu):
// - a block is two consumer warpgroups over 128 query rows of one (batch,
//   head), 64 rows each, plus a producer warpgroup that hands its registers
//   to them (setmaxnreg: 232 a consumer thread, so O, S and P stay in
//   registers at hd 128 without spilling); Q stays in shared memory.
//   The grid is 1-D with the head fastest, so the query heads of one GQA
//   group (7 for the 7B, 8 for the judge) run side by side and their K / V
//   tiles come from L2 while hot, and the row block slowest, reversed under
//   a causal mask, so the longest blocks start first and short ones fill
//   the tail;
// - 64-key K and V tiles stream through a ring of STAGES slots. The
//   producer's first thread loads them by TMA, one 4-D tensor map per operand
//   ([B, heads, S, hd] by stride, built per call), and arms the slot's
//   mbarrier with its bytes; rows past Sk are zero-filled by the TMA unit.
//   Each consumer warp releases a slot on a second mbarrier once its
//   products have read it. hd 64 and 128 use boxes 64 elements (128 bytes)
//   wide written with the 128-byte swizzle: moe_ffn.cu measured that
//   16-byte pieces, not device memory, capped the L2-to-SM rate. hd 80
//   (160-byte rows) takes boxes 8 elements wide, each a column of core
//   matrices without swizzle: a 128-byte swizzle atom does not divide 80,
//   and an 80-wide product cannot mix two layouts in one instruction. Its
//   only callers are the ViT's four full-attention layers;
// - S = Q K^T is a wgmma from shared memory, both operands K-major; O += P V
//   a wgmma with P in registers (the C fragments of S rounded to bf16) and V
//   read MN-major as stored, so no transposed copy exists (the swizzle is
//   the descriptor's, so wgmma.cuh's register-A products take the swizzled
//   V tile as they are). P V of tile j - 1 is issued before the softmax
//   of tile j, and S of tile j before O is rescaled, so the exponentials
//   and the rescale overlap the tensor cores. Every tile of the loop issues
//   and waits for the same groups in the same order, which lets ptxas keep
//   the products asynchronous;
// - the softmax is in exp2 with the scale folded into one FMA. The mask is
//   applied per warp only on tiles that need it: the causal diagonal, the
//   kv length, and segments where the tile's keys are not all in the one
//   segment of the warp's rows (the ViT's groups are one segment plus
//   trailing padding, so most of their tiles take no mask). A warpgroup
//   skips the tile past its own diagonal;
// - the row sum is reduced once, in the epilogue, as is the LSE.
// Measured (scripts/bench_flash_bwd.py, H100 80GB HBM3 at 700 W): 0.12 ms
// at the 7B's prefill (33% of the bound; SDPA 0.29), 0.21-0.22 with the
// LSE at the LoRA step's shape (39-41%; SDPA 0.57). Taken apart at the
// prefill shape: with the K / V loads removed it runs as fast, so the ring
// hides them (loads alone 0.068 ms); the products alone take 0.094 (42% of
// the peak: a warpgroup waits for S before its softmax and for P V before
// it rounds the next P), and the softmax adds the rest. 128-key tiles ran
// within 5% either way, and so did rings of 3 to 6 slots. At the ViT's
// groups the mask of the windows that hold padding costs a quarter.
// Head dim 256 (the Qwen3-Next judge's gated attention, served and
// trained) keeps the design with a two-slot ring (a 64 KB Q tile and 64 KB
// slots) and P V as one n256 product: O is 128 fp32 registers a consumer
// thread. Two n128 products over the halves of O had ptxas serialise the
// wgmmas (C7520); the n256 product does not and runs faster
// (scripts/bench_flash_bwd.py --cases next, PERF.md §6), at the cost of 12
// bytes of spill that ptxas -v reports for the serving instance. The LSE
// instance at 256 (Qwen3-Next's next_loss) adds only the row store of the
// epilogue, as at the other head dims.
#include <climits>
#include <cmath>

#include "attn_common.cuh"
#include "fp32_tile.cuh"
#include "wgmma.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int BK = 64;              // keys per tile
constexpr int WG_ROWS = 64;         // query rows of a consumer warpgroup (4 warps x 16)
constexpr int WGS = 2;              // consumer warpgroups of a block
constexpr int BQ = WG_ROWS * WGS;   // query rows of a block
constexpr int CONSUMER_WARPS = 4 * WGS;
constexpr int THREADS = 32 * CONSUMER_WARPS + 128;  // and a producer warpgroup
// registers a thread after the producer gives its up: 384 threads start at
// 65536 / 384 (168); 128 x (168 - 40) = 256 x (232 - 168)
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;
// The K / V ring. A consumer waits for tile j before it releases tile
// j - 1, so two slots would do; measured, 3 to 6 ran within 5% of each
// other at every shape of scripts/bench_flash_bwd.py. Head dim 256 (the
// Qwen3-Next judge's gated attention) takes two: its Q tile is 64 KB and a
// slot 64 KB, so four would ask 321 KB of the 227 KB a block may have.
template <int HD>
constexpr int stages() { return HD > 128 ? 2 : 4; }
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

struct FlashParams {
  bf16* o;                    // [B, Sq, nh, hd] contiguous
  float* lse;                 // [B, nh, Sq] (the LSE instantiation)
  const int* kv_lengths;      // [B]
  const int* seg;             // [B, Sk] or null (requires Sq == Sk)
  int B, Sq, Sk, nh, kh;
  int causal, q_offset;
  float scale;
};

// Shared-memory geometry at head dim HD: the Q tile [BQ][HD], then STAGES
// slots of a K tile and a V tile [BK][HD], then the barriers. Each tile is
// HD / BOX_W TMA boxes of [rows][BOX_W] one after another.
template <int HD>
struct Geo {
  static constexpr bool SW128 = HD % 64 == 0;  // 128-byte swizzled boxes, else core matrices
  static constexpr int BOX_W = SW128 ? 64 : 8;
  static constexpr int NBOX = HD / BOX_W;
  static constexpr int STAGES = stages<HD>();
  static constexpr int Q_BYTES = BQ * HD * 2;
  static constexpr int T_BYTES = BK * HD * 2;  // one K or V tile
  static constexpr int STAGE = 2 * T_BYTES;
  static constexpr int BARRIERS = 2 * STAGES + 1;
  static constexpr int SMEM = 1024 + Q_BYTES + STAGES * STAGE + BARRIERS * 8;
  static_assert(SMEM <= 227 * 1024, "a block's shared memory");
};

// Descriptors of k16 step kk. 128-byte swizzle: a box is rows of 128 bytes
// in 1 KB groups of 8 rows; K-major operands step 32 bytes along a row and
// go to the next box every 4 steps; V (MN-major, N = hd) steps 16 rows of
// keys, its 64-wide column boxes 8 KB apart. Core matrices (hd 80): box c
// holds columns [8 c, 8 c + 8) of every row, 16 bytes a row; K-major
// operands have their neighbour along k one box on (leading offset) and
// the next 8 rows 128 bytes on (stride offset); V has its next 8 keys 128
// bytes on (leading) and its next 8 columns one box on (stride).
template <int HD>
__device__ __forceinline__ uint64_t desc_q(const unsigned char* q, int w, int kk) {
  if constexpr (Geo<HD>::SW128)
    return vr2::smem_desc_sw128(q + (kk / 4) * BQ * 128 + w * WG_ROWS * 128 + (kk % 4) * 32, 0,
                                1024);
  else
    return vr2::smem_desc(q + kk * 2 * BQ * 16 + w * WG_ROWS * 16, BQ * 16, 128);
}

template <int HD>
__device__ __forceinline__ uint64_t desc_k(const unsigned char* k, int kk) {
  if constexpr (Geo<HD>::SW128)
    return vr2::smem_desc_sw128(k + (kk / 4) * BK * 128 + (kk % 4) * 32, 0, 1024);
  else
    return vr2::smem_desc(k + kk * 2 * BK * 16, BK * 16, 128);
}

template <int HD>
__device__ __forceinline__ uint64_t desc_v(const unsigned char* v, int kk) {
  if constexpr (Geo<HD>::SW128)
    return vr2::smem_desc_sw128(v + kk * 16 * 128, BK * 128, 1024);
  else
    return vr2::smem_desc(v + kk * 16 * 16, 128, BK * 16);
}

// S[64 x BK] = Q K^T for warpgroup w's rows, issued and not waited on
template <int HD>
__device__ __forceinline__ void issue_s(float (&s)[BK / 8][4], const unsigned char* sq, int w,
                                        const unsigned char* sk) {
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk)
    vr2::wgmma_ss<64, 0>(s, desc_q<HD>(sq, w, kk), desc_k<HD>(sk, kk), kk > 0);
}

// O[64 x HD] += P V for P's register A operands, issued and not waited on
// (head dim 256: one n256 product over V's four column boxes)
template <int HD>
__device__ __forceinline__ void issue_pv(float (&o)[HD / 8][4], const uint32_t (&pa)[BK / 16][4],
                                         const unsigned char* sv) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    if constexpr (HD == 256)
      vr2::wgmma_rs_n256(o, pa[kk], desc_v<HD>(sv, kk), 1);
    else if constexpr (HD == 128)
      vr2::wgmma_rs_n128(o, pa[kk], desc_v<HD>(sv, kk), 1);
    else if constexpr (HD == 80)
      vr2::wgmma_rs_n80(o, pa[kk], desc_v<HD>(sv, kk), 1);
    else
      vr2::wgmma_rs_n64(o, pa[kk], desc_v<HD>(sv, kk), 1);
  }
}

// the key tiles query rows [r0, r0 + 64) visit: keys below the kv length
// and, under a causal mask, at most q_offset + r0 + 63; none past Sq
__device__ __forceinline__ int row_tiles(const FlashParams& p, int r0, int kv_len) {
  if (r0 >= p.Sq) return 0;
  int limit = kv_len;
  if (p.causal) limit = min(limit, p.q_offset + r0 + WG_ROWS);
  return limit > 0 ? (limit + BK - 1) / BK : 0;
}

// One block: query rows [q0, q0 + 128) of one (batch, head). Warps 0-7 are
// the two consumer warpgroups, warps 8-11 the producer.
template <int HD, bool LSE>
__global__ void __launch_bounds__(THREADS, 1)
    flash_fwd_kernel(__grid_constant__ const CUtensorMap mq,
                     __grid_constant__ const CUtensorMap mk,
                     __grid_constant__ const CUtensorMap mv, const FlashParams p) {
  using G = Geo<HD>;
  constexpr int STAGES = G::STAGES;
  constexpr int NT = BK / 8;   // 8-key column blocks of a score tile
  constexpr int DT = HD / 8;   // 8-wide column blocks of the output
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* sq = smem_raw + (1024 - vr2::smem_u32(smem_raw) % 1024) % 1024;
  unsigned char* ring = sq + G::Q_BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + STAGES * G::STAGE);
  uint64_t* empty = full + STAGES;
  uint64_t* qbar = empty + STAGES;

  // (head, batch) fastest, the row block slowest; causal: the last row
  // blocks (the most keys) first
  const int n_qb = (p.Sq + BQ - 1) / BQ;
  const int h = blockIdx.x % p.nh;
  const int b = (blockIdx.x / p.nh) % p.B;
  const int tile = blockIdx.x / (p.nh * p.B);
  const int q0 = (p.causal ? n_qb - 1 - tile : tile) * BQ;
  const int hk = h / (p.nh / p.kh);
  const int kv_len = min(p.kv_lengths[b], p.Sk);
  const int n0 = row_tiles(p, q0, kv_len), n1 = row_tiles(p, q0 + WG_ROWS, kv_len);
  const int n_tiles = max(n0, n1);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      vr2::mbar_init(full + s, 1);
      // each warp of a warpgroup that visits tiles releases the slots it read
      vr2::mbar_init(empty + s, max(4 * ((n0 > 0) + (n1 > 0)), 1));
    }
    vr2::mbar_init(qbar, 1);
    vr2::mbar_init_fence();
  }
  __syncthreads();

  if (warp >= CONSUMER_WARPS) {  // the producer: Q, then the K / V ring
    vr2::regs_shrink<PRODUCER_REGS>();
    if (warp == CONSUMER_WARPS && lane == 0 && n_tiles > 0) {
      vr2::mbar_expect_tx(qbar, G::Q_BYTES);
      for (int c = 0; c < G::NBOX; ++c)
        vr2::tma_load_4d(sq + c * BQ * G::BOX_W * 2, &mq, qbar, c * G::BOX_W, q0, h, b);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % STAGES;
        if (j >= STAGES) vr2::mbar_wait(empty + s, (j / STAGES - 1) & 1);
        unsigned char* st = ring + s * G::STAGE;
        vr2::mbar_expect_tx(full + s, G::STAGE);
        for (int c = 0; c < G::NBOX; ++c) {
          vr2::tma_load_4d(st + c * BK * G::BOX_W * 2, &mk, full + s, c * G::BOX_W, j * BK, hk,
                           b);
          vr2::tma_load_4d(st + G::T_BYTES + c * BK * G::BOX_W * 2, &mv, full + s,
                           c * G::BOX_W, j * BK, hk, b);
        }
      }
    }
    return;
  }

  vr2::regs_grow<CONSUMER_REGS>();
  const int wg = warp / 4, n = wg ? n1 : n0;
  const int wr0 = q0 + wg * WG_ROWS + (warp % 4) * 16;  // this warp's first row
  const int g = lane >> 2, t = lane & 3;
  const int row[2] = {wr0 + g, wr0 + g + 8};
  const float scale2 = p.scale * LOG2E;  // scores in log2 units
  const int* segb = p.seg != nullptr ? p.seg + (long long)b * p.Sk : nullptr;
  // the warp's rows below Sq all in one segment `useg`: tiles whose keys
  // are all in it need no segment mask
  int qseg[2] = {INT_MIN, INT_MIN}, useg = INT_MIN;
  bool one_seg = false;
  if (segb != nullptr) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
      if (row[i] < p.Sq) qseg[i] = segb[row[i]];
    useg = __shfl_sync(0xffffffffu, qseg[0], 0);
    one_seg = __all_sync(0xffffffffu, (row[0] >= p.Sq || qseg[0] == useg) &&
                                          (row[1] >= p.Sq || qseg[1] == useg));
  }

  float o[DT][4];
#pragma unroll
  for (int d = 0; d < DT; ++d) o[d][0] = o[d][1] = o[d][2] = o[d][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};  // running max of the scaled scores (log2 units)
  float l[2] = {0.f, 0.f};              // per-lane partial row sums (reduced at the end)

  // The mask (on tiles that need it) and the online softmax of S(j), in
  // place: p = 2^(s scale2 - m), rounded to bf16 later; alpha rescales
  // what O holds so far.
  auto softmax = [&](int j, float (&sc)[NT][4], float (&alpha)[2]) {
    const int k0 = j * BK;
    bool whole = k0 + BK <= kv_len && (!p.causal || k0 + BK - 1 <= p.q_offset + wr0);
    int ks_lo = 0, ks_hi = 0;  // key segments k0 + lane and k0 + 32 + lane
    if (segb != nullptr) {
      ks_lo = k0 + lane < p.Sk ? segb[k0 + lane] : INT_MIN;
      ks_hi = k0 + 32 + lane < p.Sk ? segb[k0 + 32 + lane] : INT_MIN;
      whole = __all_sync(0xffffffffu, whole && one_seg && ks_lo == useg && ks_hi == useg);
    }
    if (!whole) {
#pragma unroll
      for (int nb = 0; nb < NT; ++nb) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int kj = nb * 8 + 2 * t + c, key = k0 + kj;
          int kseg = 0;
          if (segb != nullptr)
            kseg = __shfl_sync(0xffffffffu, nb < NT / 2 ? ks_lo : ks_hi, kj % 32);
#pragma unroll
          for (int ri = 0; ri < 2; ++ri) {
            bool ok = key < kv_len && (!p.causal || key <= p.q_offset + row[ri]);
            if (segb != nullptr) ok = ok && kseg == qseg[ri];
            if (!ok) sc[nb][2 * ri + c] = -INFINITY;
          }
        }
      }
    }
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nb = 0; nb < NT; ++nb) {
      mx[0] = fmaxf(mx[0], fmaxf(sc[nb][0], sc[nb][1]));
      mx[1] = fmaxf(mx[1], fmaxf(sc[nb][2], sc[nb][3]));
    }
    float mref[2];
#pragma unroll
    for (int ri = 0; ri < 2; ++ri) {
      const float m_new = fmaxf(m[ri], vr2::quad_max(mx[ri]) * scale2);
      mref[ri] = m_new == -INFINITY ? 0.f : m_new;  // no admitted key yet
      alpha[ri] = vr2::exp2_approx(m[ri] - mref[ri]);
      m[ri] = m_new;
      l[ri] *= alpha[ri];
    }
#pragma unroll
    for (int nb = 0; nb < NT; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pe = vr2::exp2_approx(fmaf(sc[nb][e], scale2, -mref[e >> 1]));
        sc[nb][e] = pe;
        l[e >> 1] += pe;
      }
    }
  };
  // P rounded to bf16: the register A operands of P V's k16 steps
  auto to_p = [&](uint32_t (&pa)[BK / 16][4], const float (&sc)[NT][4]) {
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) vr2::c_to_a(pa[kk], sc[2 * kk], sc[2 * kk + 1]);
  };
  auto rescale = [&](const float (&alpha)[2]) {
#pragma unroll
    for (int d = 0; d < DT; ++d) {
      o[d][0] *= alpha[0];
      o[d][1] *= alpha[0];
      o[d][2] *= alpha[1];
      o[d][3] *= alpha[1];
    }
  };
  auto v_tile = [&](int j) { return ring + (j % STAGES) * G::STAGE + G::T_BYTES; };

  if (n > 0) {
    float sc[NT][4], alpha[2];
    uint32_t pa[BK / 16][4];  // P of the previous tile, rounded to bf16
    vr2::mbar_wait(qbar, 0);
    vr2::mbar_wait(full, 0);
    vr2::wgmma_fence();
    issue_s<HD>(sc, sq, wg, ring);
    vr2::wgmma_commit();
    vr2::wgmma_wait<0>();
    vr2::fence_regs(sc);
    softmax(0, sc, alpha);
    to_p(pa, sc);
    // Tile j: S(j) runs while O is rescaled, P V of tile j - 1 while S(j)'s
    // softmax takes its exponentials
    for (int j = 1; j < n; ++j) {
      const int s = j % STAGES;
      vr2::mbar_wait(full + s, (j / STAGES) & 1);
      vr2::wgmma_fence();
      issue_s<HD>(sc, sq, wg, ring + s * G::STAGE);
      vr2::wgmma_commit();
      rescale(alpha);
      vr2::wgmma_fence();
      issue_pv<HD>(o, pa, v_tile(j - 1));
      vr2::wgmma_commit();
      vr2::wgmma_wait<1>();  // S(j)
      vr2::fence_regs(sc);
      softmax(j, sc, alpha);
      vr2::wgmma_wait<0>();  // P V of tile j - 1: its slot is free
      vr2::fence_regs(o);
      if (lane == 0) vr2::mbar_arrive(empty + (j - 1) % STAGES);
      to_p(pa, sc);
    }
    rescale(alpha);
    vr2::wgmma_fence();
    issue_pv<HD>(o, pa, v_tile(n - 1));
    vr2::wgmma_commit();
    vr2::wgmma_wait<0>();
    vr2::fence_regs(o);
  }

  float inv[2];
#pragma unroll
  for (int ri = 0; ri < 2; ++ri) {
    const float tot = vr2::quad_sum(l[ri]);
    inv[ri] = tot > 0.f ? 1.f / tot : 0.f;  // a row with no admitted key emits 0
    // l is relative to the running max m (finite once a key was admitted)
    if (LSE && t == 0 && row[ri] < p.Sq)
      p.lse[((long long)b * p.nh + h) * p.Sq + row[ri]] =
          tot > 0.f ? (m[ri] + log2f(tot)) * LN2 : 1e30f;
  }
#pragma unroll
  for (int ri = 0; ri < 2; ++ri) {
    if (row[ri] >= p.Sq) continue;
    bf16* op = p.o + (((long long)b * p.Sq + row[ri]) * p.nh + h) * HD + 2 * t;
#pragma unroll
    for (int d = 0; d < DT; ++d)
      *reinterpret_cast<__nv_bfloat162*>(op + d * 8) =
          __floats2bfloat162_rn(o[d][2 * ri] * inv[ri], o[d][2 * ri + 1] * inv[ri]);
  }
}

// A 4-D tensor map over a bf16 operand [B, heads, S, HD] read by stride
// (elements), boxes of [rows][BOX_W] elements
template <int HD>
cudaError_t operand_map(CUtensorMap* map, const void* base, int S, int heads, int B,
                        long long s_stride, long long h_stride, long long b_stride, int rows) {
  using G = Geo<HD>;
  const vr2::EncodeTiled encode = vr2::tensor_map_encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[4] = {cuuint64_t(HD), cuuint64_t(S), cuuint64_t(heads), cuuint64_t(B)};
  const cuuint64_t strides[3] = {cuuint64_t(s_stride) * 2, cuuint64_t(h_stride) * 2,
                                 cuuint64_t(b_stride) * 2};
  const cuuint32_t box[4] = {cuuint32_t(G::BOX_W), cuuint32_t(rows), 1, 1};
  const cuuint32_t one[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides, box,
      one, CU_TENSOR_MAP_INTERLEAVE_NONE,
      G::SW128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int HD, bool LSE>
cudaError_t set_smem() {
  return cudaFuncSetAttribute(flash_fwd_kernel<HD, LSE>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, Geo<HD>::SMEM);
}

struct Operands {
  const void *q, *k, *v;
  long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
};

template <int HD, bool LSE>
cudaError_t launch(const FlashParams& p, const Operands& x, cudaStream_t stream) {
  CUtensorMap mq, mk, mv;
  cudaError_t err;
  if ((err = operand_map<HD>(&mq, x.q, p.Sq, p.nh, p.B, x.q_ss, x.q_sh, x.q_sb, BQ)) !=
          cudaSuccess ||
      (err = operand_map<HD>(&mk, x.k, p.Sk, p.kh, p.B, x.k_ss, x.k_sh, x.k_sb, BK)) !=
          cudaSuccess ||
      (err = operand_map<HD>(&mv, x.v, p.Sk, p.kh, p.B, x.v_ss, x.v_sh, x.v_sb, BK)) !=
          cudaSuccess ||
      (err = set_smem<HD, LSE>()) != cudaSuccess)
    return err;
  const int blocks = (p.Sq + BQ - 1) / BQ * p.nh * p.B;
  flash_fwd_kernel<HD, LSE><<<blocks, THREADS, Geo<HD>::SMEM, stream>>>(mq, mk, mv, p);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_hd(const FlashParams& p, const Operands& x, cudaStream_t stream) {
  return p.lse != nullptr ? launch<HD, true>(p, x, stream) : launch<HD, false>(p, x, stream);
}

// (rows of a block, consumer warpgroups of a block, blocks resident on an SM)
// of the LSE instance
template <int HD>
int layout(int* out) {
  if (set_smem<HD, true>() != cudaSuccess) return -1;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &out[2], flash_fwd_kernel<HD, true>, THREADS, Geo<HD>::SMEM);
  out[0] = BQ;
  out[1] = WGS;
  return int(err);
}

// ---------------------------------------------------------------------------
// The fp32 instance (CUDA cores; fp32_tile.cuh): fp32 q / k / v at any head
// dim up to 128, the same mask and outputs as the bf16 kernel, and P, every
// product, the softmax and the LSE in fp32 (the JAX kernels cast their
// tiles to f32). One 256-thread block per (64 query rows, head, batch);
// 64-key tiles up to the last key any of its rows admits; the scores'
// 64 x 64 tile in registers (4 x 4 a thread), P through shared memory into
// P V. No preset runs it: the tiny fp32 test config does.
// ---------------------------------------------------------------------------
namespace f32 = vr2::f32;

struct F32Params {
  const float *q, *k, *v;     // read by stride
  float* o;                   // [B, Sq, nh, hd] contiguous
  float* lse;                 // [B, nh, Sq] or null
  const int* kv_lengths;      // [B]
  const int* seg;             // [B, Sk] or null
  int B, Sq, Sk, nh, kh, hd, causal, q_offset;
  long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
  float scale;
};

// the keys [0, end) that any query row of [q0, q0 + 64) may admit
__device__ __forceinline__ int key_end(const F32Params& p, int q0, int kv_len) {
  return p.causal ? max(0, min(kv_len, p.q_offset + q0 + f32::kTile)) : kv_len;
}

__global__ void __launch_bounds__(f32::kThreads) flash_fwd_f32_kernel(const F32Params p) {
  __shared__ f32::Smem sm;
  __shared__ f32::Tile sp;
  const int h = blockIdx.x % p.nh, b = blockIdx.x / p.nh % p.B;
  const int q0 = blockIdx.x / (p.nh * p.B) * f32::kTile;
  const int hk = h / (p.nh / p.kh), ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int kv_len = min(p.kv_lengths[b], p.Sk), k_end = key_end(p, q0, kv_len);
  const float* kb = p.k + b * p.k_sb + hk * p.k_sh;
  const float* vb = p.v + b * p.v_sb + hk * p.v_sh;
  const int* segb = p.seg != nullptr ? p.seg + (long long)b * p.Sk : nullptr;
  int row[4], qseg[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    row[i] = q0 + 4 * ty + i;
    qseg[i] = segb != nullptr && row[i] < p.Sq ? segb[row[i]] : 0;
  }
  const f32::Operand<true> qo{p.q + b * p.q_sb + h * p.q_sh + q0 * p.q_ss, p.q_ss,
                              min(f32::kTile, p.Sq - q0)};
  float m[4], l[4];
  f32::Acc o[2];
#pragma unroll
  for (int i = 0; i < 4; ++i) m[i] = -INFINITY, l[i] = 0.f;
  f32::zero(o[0]);
  f32::zero(o[1]);
  for (int k0 = 0; k0 < k_end; k0 += f32::kTile) {
    const int kn = min(f32::kTile, k_end - k0);
    f32::Acc s;
    f32::zero(s);
    f32::product(s, qo, f32::Operand<true>{kb + k0 * p.k_ss, p.k_ss, kn}, p.hd, sm);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = k0 + 4 * tx + j;
        const bool ok = key < k_end && (!p.causal || key <= p.q_offset + row[i]) &&
                        (segb == nullptr || segb[key] == qseg[i]);
        s[i][j] = ok ? s[i][j] * p.scale : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], f32::row_max(mx));
      const float ref = m_new == -INFINITY ? 0.f : m_new;  // no key admitted yet
      const float alpha = expf(m[i] - ref);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - ref);
        sum += s[i][j];
        o[0][i][j] *= alpha;
        o[1][i][j] *= alpha;
      }
      l[i] = l[i] * alpha + sum;  // this thread's columns; summed over the row at the end
      m[i] = m_new;
    }
    f32::to_tile(sp, s);
    __syncthreads();
#pragma unroll
    for (int c = 0; c < 2; ++c)
      if (c * f32::kTile < p.hd)
        f32::product(o[c], f32::Operand<true>{&sp[0][0], f32::kTile + 1, f32::kTile},
                     f32::Operand<false>{vb + k0 * p.v_ss + c * f32::kTile, p.v_ss,
                                         p.hd - c * f32::kTile},
                     kn, sm);
  }
  float tot[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) tot[i] = f32::row_sum(l[i]);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (row[i] >= p.Sq) continue;
    const float inv = tot[i] > 0.f ? 1.f / tot[i] : 0.f;  // no admitted key: 0
    float* op = p.o + (((long long)b * p.Sq + row[i]) * p.nh + h) * p.hd;
#pragma unroll
    for (int c = 0; c < 2; ++c)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = c * f32::kTile + 4 * tx + j;
        if (col < p.hd) op[col] = o[c][i][j] * inv;
      }
    if (p.lse != nullptr && tx == 0)
      p.lse[((long long)b * p.nh + h) * p.Sq + row[i]] =
          tot[i] > 0.f ? m[i] + logf(tot[i]) : 1e30f;
  }
}

cudaError_t launch_f32(const F32Params& p, cudaStream_t stream) {
  if (p.hd <= 0 || p.hd > 2 * f32::kTile) return cudaErrorInvalidValue;
  const int blocks = (p.Sq + f32::kTile - 1) / f32::kTile * p.nh * p.B;
  flash_fwd_f32_kernel<<<blocks, f32::kThreads, 0, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point, loaded with ctypes. q / k / v are read by stride
// (elements; bf16: the row and head strides multiples of 8, the bases
// 16-byte aligned, hd 64, 80, 128 or 256; fp32 (fp32 != 0): any strides, hd
// up to 128); the output is a contiguous [B, Sq, nh, hd] of q's type; lse
// (fp32 [B, nh, Sq]) may be null. Returns a cudaError_t.
extern "C" int vr2_flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, void* lse, const int* kv_lengths,
    const int* seg, int B, int Sq, int Sk, int nh, int kh, int hd, long long q_sb,
    long long q_ss, long long q_sh, long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh, int causal, int q_offset, float scale,
    int fp32, void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || kh <= 0 || nh % kh != 0) return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (fp32) {
    const F32Params p{static_cast<const float*>(q), static_cast<const float*>(k),
                      static_cast<const float*>(v), static_cast<float*>(o),
                      static_cast<float*>(lse), kv_lengths, seg, B, Sq, Sk, nh, kh, hd,
                      causal, q_offset, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
                      scale};
    return int(launch_f32(p, st));
  }
  FlashParams p;
  p.o = static_cast<bf16*>(o);
  p.lse = static_cast<float*>(lse);
  p.kv_lengths = kv_lengths;
  p.seg = seg;
  p.B = B;
  p.Sq = Sq;
  p.Sk = Sk;
  p.nh = nh;
  p.kh = kh;
  p.causal = causal;
  p.q_offset = q_offset;
  p.scale = scale;
  const Operands x{q, k, v, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh};
  switch (hd) {
    case 64: return launch_hd<64>(p, x, st);
    case 80: return launch_hd<80>(p, x, st);
    case 128: return launch_hd<128>(p, x, st);
    case 256: return launch_hd<256>(p, x, st);
    default: return int(cudaErrorInvalidValue);
  }
}

// The forward's launch shape at head dim hd: out[0] query rows of a block,
// out[1] its consumer warpgroups, out[2] the blocks that stay resident on
// one SM (the occupancy calculator). Returns a cudaError_t.
extern "C" int vr2_flash_attention_fwd_layout(int hd, int* out) {
  switch (hd) {
    case 64: return layout<64>(out);
    case 80: return layout<80>(out);
    case 128: return layout<128>(out);
    case 256: return layout<256>(out);
    default: return int(cudaErrorInvalidValue);
  }
}
