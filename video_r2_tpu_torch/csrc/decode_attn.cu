// One-token batch decode attention over the head-major stacked KV cache, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel video_r2_tpu/ops/decode_attention.py::
// _decode_kernel (:42, via decode_attention_stacked), with its semantics:
// the cache is [L, B, kh, Smax, hd] bf16 (Smax a multiple of 128) and the
// layer index picks the layer; query head h * g + j (g = nh / kh) of
// sequence b attends over key positions kpos with kpos < lengths[b] (the
// right-padded prompt) or s_pad <= kpos <= slot_end (the fixed decode
// slots; slot_end < s_pad turns the window off); the block count is
// min(cdiv(max(lengths[b], slot_end + 1), 128), Smax / 128); q is scaled by
// hd^-0.5 in fp32; masked scores are -1e30 and the softmax is online in
// fp32, as the TPU kernel's; the output is the accumulator over
// max(l, 1e-30), rounded to bf16. Masks are selects, so the stale rows
// between lengths[b] and s_pad (the pad tokens' K / V) never reach the
// output.
//
// What bounds it on the card: every admitted key and value row of a
// sequence is read once per kv head, against 4 g hd FLOP a key (g = 7 at
// 7B), so device memory (3.35 TB/s) bounds it, far below the tensor cores'
// rate. What the design does about it: one 256-thread block per (sequence,
// kv head) holds its g query rows in shared memory (fp32, pre-scaled) and
// walks its blocks of 128 rows, each a contiguous [128, hd] run of
// cache[layer, b, h] staged by cp.async, double-buffered, so the next block
// streams in while this one is reduced. The products are fp32 FMA (g rows,
// no tensor-core tile shape, and the math stays the TPU kernel's fp32):
// scores one key per thread, the softmax one row per warp, P @ V four head
// dims per thread; each launch is instantiated for the smallest row
// capacity (8 or 16) that holds g. B * kh blocks (16 at B = 4 on 7B) leave
// most of the 132 SMs idle: splitting a sequence's blocks across SMs
// (flash-decoding) is later work. The loop and its stage layout are the
// paged decode kernel's (csrc/paged_attn.cu), with the mask and the
// addressing of this cache.
#include <cmath>

#include "attn_common.cuh"

namespace {

constexpr int NTHREADS = 256;
constexpr int NWARPS = NTHREADS / 32;
constexpr int BS = 128;           // keys per block (BLOCK_S)
constexpr int MAX_ROWS = 16;      // g = nh / kh query rows per block
constexpr float NEG = -1e30f;     // the TPU kernel's mask value

struct DecodeParams {
  const __nv_bfloat16* q;   // [B, nh, hd]
  const __nv_bfloat16* k;   // [L, B, kh, smax, hd]
  const __nv_bfloat16* v;
  __nv_bfloat16* o;         // [B, nh, hd]
  const int* lengths;       // [B]
  int B, nh, kh, smax, layer, s_pad, slot_end;
  float scale;
};

// One block's shared-memory stage: K rows with a pitch of hd + 8 elements
// (the 16-byte row reads of neighbouring threads fall on distinct banks),
// V rows unpadded.
template <int HD>
struct Stage {
  static constexpr int KP = HD + 8;
  static constexpr int K_BYTES = BS * KP * 2;
  static constexpr int V_BYTES = BS * HD * 2;
  static constexpr int BYTES = K_BYTES + V_BYTES;
};

template <int HD>
__device__ __forceinline__ void load_block(unsigned char* stage, const __nv_bfloat16* gk,
                                           const __nv_bfloat16* gv, int blk) {
  using S = Stage<HD>;
  constexpr int CH = HD / 8;  // 16-byte chunks per row
  gk += (long long)blk * BS * HD;
  gv += (long long)blk * BS * HD;
  __nv_bfloat16* sk = reinterpret_cast<__nv_bfloat16*>(stage);
  __nv_bfloat16* sv = reinterpret_cast<__nv_bfloat16*>(stage + S::K_BYTES);
  for (int i = threadIdx.x; i < BS * CH; i += NTHREADS) {
    const int r = i / CH, c = (i % CH) * 8;
    vr2::cp_async16(sk + r * S::KP + c, gk + r * HD + c);
    vr2::cp_async16(sv + r * HD + c, gv + r * HD + c);
  }
}

// MR: the block's row capacity (g <= MR), so that the unrolled per-row
// loops carry no more rows than the launch has.
template <int HD, int MR>
__global__ void __launch_bounds__(NTHREADS) decode_attn_kernel(const DecodeParams p) {
  using S = Stage<HD>;
  constexpr int QK_GROUPS = NTHREADS / BS;  // key j = tid % BS, rows by tid / BS
  constexpr int QK_RPT = (MR + QK_GROUPS - 1) / QK_GROUPS;
  constexpr int PV_LANES = HD / 4;          // dims 4 * (tid % PV_LANES) .. +3
  constexpr int PV_GROUPS = NTHREADS / PV_LANES;
  constexpr int PV_RPT = (MR + PV_GROUPS - 1) / PV_GROUPS;
  extern __shared__ __align__(16) unsigned char smem[];

  const int b = blockIdx.x, h = blockIdx.y, tid = threadIdx.x;
  const int R = p.nh / p.kh;
  float* sQ = reinterpret_cast<float*>(smem + 2 * S::BYTES);  // [R, HD], scaled
  float* sS = sQ + R * HD;                                     // [R, BS] scores / P
  float* sM = sS + R * BS;                                     // running max
  float* sL = sM + R;                                          // running sum
  float* sA = sL + R;                                          // this block's rescale

  const int L = p.lengths[b];
  const int limit = max(L, p.slot_end + 1);
  const int n_blocks = limit > 0 ? min((limit + BS - 1) / BS, p.smax / BS) : 0;
  const long long head = ((long long)p.layer * p.B + b) * p.kh + h;
  const __nv_bfloat16* gk = p.k + head * p.smax * HD;
  const __nv_bfloat16* gv = p.v + head * p.smax * HD;

  if (n_blocks > 0) load_block<HD>(smem, gk, gv, 0);
  vr2::cp_async_commit();

  for (int i = tid; i < R * HD; i += NTHREADS)
    sQ[i] = __bfloat162float(p.q[((long long)b * p.nh + h * R) * HD + i]) * p.scale;
  for (int r = tid; r < R; r += NTHREADS) {
    sM[r] = NEG;
    sL[r] = 0.f;
  }
  __syncthreads();  // the queries and row stats, also when no block is read

  const int d = 4 * (tid % PV_LANES), pv_grp = tid / PV_LANES;
  float4 acc[PV_RPT];
#pragma unroll
  for (int i = 0; i < PV_RPT; ++i) acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int blk = 0; blk < n_blocks; ++blk) {
    unsigned char* stage = smem + (blk & 1) * S::BYTES;
    const int k0 = blk * BS;
    if (blk + 1 < n_blocks) load_block<HD>(smem + ((blk + 1) & 1) * S::BYTES, gk, gv, blk + 1);
    vr2::cp_async_commit();
    vr2::cp_async_wait<1>();  // this block's group has landed
    __syncthreads();

    const __nv_bfloat16* sk = reinterpret_cast<const __nv_bfloat16*>(stage);
    const __nv_bfloat16* sv = reinterpret_cast<const __nv_bfloat16*>(stage + S::K_BYTES);

    // scores: thread (key j, row group); s = q . k, masked by a select
    {
      const int j = tid % BS, grp = tid / BS;
      float s[QK_RPT];
#pragma unroll
      for (int i = 0; i < QK_RPT; ++i) s[i] = 0.f;
      const __nv_bfloat16* kr = sk + j * S::KP;
#pragma unroll 2
      for (int c = 0; c < HD; c += 8) {
        float kf[8];
        vr2::chunk_to_float(kr + c, kf);
#pragma unroll
        for (int i = 0; i < QK_RPT; ++i) {
          const int r = grp + i * QK_GROUPS;
          if (r < R) {
            const float4* qr = reinterpret_cast<const float4*>(sQ + r * HD + c);
            const float4 a = qr[0], e = qr[1];
            s[i] += a.x * kf[0] + a.y * kf[1] + a.z * kf[2] + a.w * kf[3] + e.x * kf[4] +
                    e.y * kf[5] + e.z * kf[6] + e.w * kf[7];
          }
        }
      }
      const int kpos = k0 + j;
      const bool ok = kpos < L || (kpos >= p.s_pad && kpos <= p.slot_end);
#pragma unroll
      for (int i = 0; i < QK_RPT; ++i) {
        const int r = grp + i * QK_GROUPS;
        if (r < R) sS[r * BS + j] = ok ? s[i] : NEG;
      }
    }
    __syncthreads();

    // online softmax, one row per warp: P = exp(s - m)
    {
      const int warp = tid / 32, lane = tid % 32;
      for (int r = warp; r < R; r += NWARPS) {
        float* row = sS + r * BS;
        float mx = NEG;
        for (int j = lane; j < BS; j += 32) mx = fmaxf(mx, row[j]);
        mx = vr2::warp_max(mx);
        const float m_old = sM[r];
        const float m_new = fmaxf(m_old, mx);
        float sum = 0.f;
        for (int j = lane; j < BS; j += 32) {
          const float e = __expf(row[j] - m_new);
          sum += e;
          row[j] = e;
        }
        sum = vr2::warp_sum(sum);
        if (lane == 0) {
          const float alpha = __expf(m_old - m_new);
          sA[r] = alpha;
          sL[r] = sL[r] * alpha + sum;
          sM[r] = m_new;
        }
      }
    }
    __syncthreads();

    // O = O * alpha + P @ V, four head dims per thread
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
      for (int j = 0; j < BS; ++j) {
        const float4 vv = vr2::quad_to_float(sv + j * HD + d);
#pragma unroll
        for (int i = 0; i < PV_RPT; ++i) {
          const int r = pv_grp + i * PV_GROUPS;
          if (r < R) {
            const float pj = sS[r * BS + j];
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
      __nv_bfloat162* op = reinterpret_cast<__nv_bfloat162*>(
          p.o + ((long long)b * p.nh + h * R + r) * HD + d);
      op[0] = __floats2bfloat162_rn(acc[i].x * inv, acc[i].y * inv);
      op[1] = __floats2bfloat162_rn(acc[i].z * inv, acc[i].w * inv);
    }
  }
}

template <int HD, int MR>
cudaError_t launch_decode(const DecodeParams& p, cudaStream_t stream) {
  const int R = p.nh / p.kh;
  const size_t smem = 2 * size_t(Stage<HD>::BYTES) + size_t(R) * (HD + BS + 3) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(decode_attn_kernel<HD, MR>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         int(smem));
  if (err != cudaSuccess) return err;
  decode_attn_kernel<HD, MR><<<dim3(p.B, p.kh), NTHREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_rows(const DecodeParams& p, cudaStream_t st) {
  const int R = p.nh / p.kh;
  if (R <= 8) return launch_decode<HD, 8>(p, st);
  return launch_decode<HD, MAX_ROWS>(p, st);
}

}  // namespace

// Plain C entry point, loaded with ctypes. q and o are contiguous
// [B, nh, hd] bf16; k / v the contiguous stacked cache [L, B, kh, smax, hd]
// bf16 with smax a multiple of 128; lengths int32 [B]; 0 <= layer < L.
// Returns a cudaError_t.
extern "C" int vr2_decode_attention(const void* q, const void* k, const void* v, void* o,
                                    const int* lengths, int B, int nh, int kh, int hd,
                                    int L, int smax, int layer, int s_pad, int slot_end,
                                    float scale, void* stream) {
  if (B <= 0 || kh <= 0 || nh % kh != 0 || nh / kh > MAX_ROWS || smax <= 0 ||
      smax % BS != 0 || layer < 0 || layer >= L)
    return int(cudaErrorInvalidValue);
  DecodeParams p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.o = static_cast<__nv_bfloat16*>(o);
  p.lengths = lengths;
  p.B = B;
  p.nh = nh;
  p.kh = kh;
  p.smax = smax;
  p.layer = layer;
  p.s_pad = s_pad;
  p.slot_end = slot_end;
  p.scale = scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hd == 128) return int(launch_rows<128>(p, st));
  if (hd == 64) return int(launch_rows<64>(p, st));
  return int(cudaErrorInvalidValue);
}
