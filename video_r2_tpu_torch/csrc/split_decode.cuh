// Decode attention split along the sequence (flash-decoding), for Hopper
// (sm_90a): the device code shared by csrc/decode_attn.cu (the head-major
// stacked cache) and csrc/paged_attn.cu (the paged pool). Each entry point
// fills a Params with its own addressing and mask and launches one of the
// kernels below; their semantics are stated in those files.
//
// What bounds the work on the card: every admitted key and value row of a
// sequence is read once per kv head, against 4 R hd operations a key for R
// query rows (R = 7 at the 7B's decode, 28 for a W = 4 verify chunk), so
// device memory (3.35 TB/s) bounds it. What the design does about it:
// - The grid is (B kh, S): the key range of each (sequence, kv head), cut in
//   tiles of kTile keys, is split into S runs of consecutive tiles whose
//   lengths differ by at most one (the wrapper's split plan, from shapes
//   alone: S = 1 where B kh fills the card, else up to 3 blocks an SM with
//   at least 3 tiles a split). A
//   tile that holds no admitted key issues no copy and is not reduced; an
//   admitted tile copies only its admitted key rows and zero-fills the rest,
//   so stale rows (the pad between a prompt and the decode slots, a page's
//   unwritten tail) never reach shared memory.
// - The tiles stream through a ring of 1-4 shared-memory stages filled by
//   cp.async: a stage for each tile of the split's run (all requested
//   before the first is reduced), as many as leave room for the blocks each
//   SM must hold for the grid to run in one wave.
// - bf16 q (tc_kernel): both products run on the tensor cores,
//   mma.sync.m16n8k16, bf16 in, fp32 out, the query rows padded to 16 MT
//   (MT = 1, 2, 4 row tiles). Four warps split each tile: warp w takes row
//   tile w % MT and keys [kTile / (4 / MT)) of each tile, with its own
//   running max, sum and accumulator, merged once at the end. S = Q K^T
//   takes K straight from shared memory by ldmatrix (bf16: the usual
//   fragments; int8: each 32-bit word holds 4 consecutive dims of a key,
//   split into the even / odd bf16 pairs of two k steps, and Q's fragments
//   permute their dims to match); the softmax runs on the accumulator
//   fragments (a quad of lanes holds a row), so scores never leave
//   registers; P V takes V by ldmatrix .trans (int8: the even / odd pairs are
//   two output column tiles, the dims put back in order when the warps
//   merge). The math keeps fp32-level precision: bf16 q and K (int8 values
//   convert to bf16 exactly) multiply exactly with fp32 sums, hd^-0.5
//   applies to S in fp32, and P enters P V as a bf16 hi + lo pair (two
//   products), so the product keeps ~16 bits of P. int8 scales: the k scale
//   multiplies S's columns in fp32, the v scale P's columns before the split.
//   Not wgmma: its 64-row minimum would pad 7-28 rows 2-9x for work bound by
//   bytes.
// - fp32 q (f32_kernel, over fp32 or int8 rows): CUDA-core fp32 FMA, every
//   operand and product fp32, the same split, ring and combine; the block
//   reduces each tile together (scores one key per thread, the softmax a row
//   per warp, P V four dims per thread), three barriers a tile. Any head dim
//   from 1 to 128, as the JAX kernels take any: the instance of the
//   smallest compiled width (32, 64 or 128) that holds it, the true head dim
//   p.hd at run time. At p.hd == HD the ring is filled by cp.async as for
//   bf16; below it (a row of 12 fp32 or int8 elements is not a whole number
//   of 16-byte pieces, nor aligned to one) each element is read and stored
//   by the block's threads, the dims past p.hd zero in shared memory (they
//   add 0 to every score, and their output columns are never stored). bf16
//   q keeps head dims 64 and 128 on the tensor cores (wrappers route through
//   ops/split.py::decode_kernel_instance).
// - With S > 1 each block writes its rows' (max, sum, accumulator) to an
//   fp32 workspace, takes a ticket on its (sequence, kv head)'s counter
//   after a __threadfence, and the block that takes the last one adds the S
//   partials in split order (so two calls give the same bits), writes the
//   output and sets the counter back to 0: one launch a call. The S = 1
//   instance carries none of this. The workspace and counters are the
//   wrapper's, per (device, stream), grown on demand: a CUDA graph captured
//   after a call at its largest shape replays on the same buffers, but a
//   larger call after capture would grow them under the graph.
// Everything runs in the log2 domain (q . k times hd^-0.5 log2 e, exp2);
// masked scores are -1e30 and weigh 0, so a row with no admitted key ends
// with sum 0 and emits 0; the output is the accumulator over max(sum,
// 1e-30), as the TPU kernels'.
#pragma once

#include <algorithm>

#include "attn_common.cuh"

namespace vr2 {
namespace dsplit {

constexpr int kThreads = 128;             // 4 warps
constexpr int kWarps = kThreads / kWarp;
constexpr int kTile = 64;                 // keys a tile
constexpr int kMaxSplits = 64;
constexpr int kMaxRows = 64;              // query rows a block
constexpr int kMaxQueryRows = 128;        // W g query rows a (sequence, kv head): up to
                                          // two blocks of kMaxRows (grid z)
constexpr int kSmemPerSM = 233472;        // shared memory of an SM, 1 KB a block reserved
constexpr float kNeg = -1e30f;            // the TPU kernels' masked score
constexpr float kLog2e = 1.4426950408889634f;
static_assert(kThreads == 2 * kTile, "load_tile stages a tile's 2 x 64 scales, one a thread");

struct Params {
  const void* q;           // [B, W, nh, hd] (decode: W = 1), bf16 or fp32
  const void* k;           // key / value rows of hd elements: bf16, fp32 or int8
  const void* v;
  const float* k_scale;    // int8 rows: one fp32 scale a row; else null
  const float* v_scale;
  void* o;                 // q's shape and type
  const int* lengths;      // [B]
  const int* tables;       // paged: [B, max_pages]; decode: null
  float* part;             // S > 1: acc [B kh S R HD] (the instance's width), then
                           // max and sum [B kh S R]
  int* counters;           // S > 1: [B kh Z] (Z row groups), 0 between launches
  int B, W, nh, kh, g;     // R = W g query rows a (sequence, kv head)
  int rows;                // query rows a block: block z takes rows [z rows, + rows)
  int hd;                  // the head dim: the instance's HD, or (fp32) below it
  int layer, width;        // decode: width = Smax; paged: width = page size
  int num_pages, max_pages;
  int lo, hi;              // keys [lo, hi] admitted for every row (decode slots)
  int n_tiles, splits, stages;
  float scale;             // hd^-0.5
};

// The key range one block walks: tiles [t0, t1) of split z; query row r
// admits keys < lim + r / g and [lo, hi]; keys < ext (the last row's bound)
// or in [lo, hi] are admitted for some row, so tiles [0, na) and [wa, wb)
// hold admitted keys.
struct Span {
  int t0, t1, lim, ext, na, wa, wb;

  __device__ bool tile_ok(int t) const { return t < na || (t >= wa && t < wb); }
  __device__ int next(int t) const {
    while (t < t1 && !tile_ok(t)) ++t;
    return t;
  }
};

__device__ __forceinline__ Span make_span(const Params& p, int b, int z) {
  Span s;
  const int base = p.n_tiles / p.splits, rem = p.n_tiles % p.splits;
  s.t0 = z * base + min(z, rem);
  s.t1 = s.t0 + base + (z < rem ? 1 : 0);
  s.lim = p.lengths[b];
  s.ext = s.lim + p.W - 1;
  s.na = s.ext > 0 ? min((s.ext + kTile - 1) / kTile, p.n_tiles) : 0;
  const bool window = p.lo <= p.hi && p.lo >= 0;
  s.wa = window ? p.lo / kTile : 0;
  s.wb = window ? min(p.hi / kTile + 1, p.n_tiles) : 0;
  return s;
}

__device__ __forceinline__ bool in_window(const Params& p, int kpos) {
  return kpos >= p.lo && kpos <= p.hi;
}

// Row of the first key of tile t of (sequence b, kv head h), in units of
// key rows of the pool / cache
template <bool PAGED>
__device__ __forceinline__ long long tile_row(const Params& p, int b, int h, int t) {
  if constexpr (PAGED) {
    const int key = t * kTile;  // kTile divides the page size: a tile lies in one page
    const int pid = p.tables[(long long)b * p.max_pages + key / p.width];
    if ((unsigned)pid >= (unsigned)p.num_pages) __trap();  // a table entry off the pool
    return ((long long)(p.layer * p.kh + h) * p.num_pages + pid) * p.width + key % p.width;
  } else {
    return (((long long)p.layer * p.B + b) * p.kh + h) * p.width + (long long)t * kTile;
  }
}

// Row of q and o that query row r of (b, h) is: query w = r / g of the
// chunk, head h g + r % g
__device__ __forceinline__ long long qo_row(const Params& p, int b, int h, int r) {
  return ((long long)b * p.W + r / p.g) * p.nh + h * p.g + r % p.g;
}

// One ring stage: the tile's K rows, then its V rows, each row padded by 16
// bytes (ldmatrix's 8 rows, and 16-byte reads of neighbouring rows, fall
// on distinct banks), then (int8) its 64 k scales and 64 v scales.
template <typename T, int HD>
struct Ring {
  static constexpr int ROW = HD * int(sizeof(T));
  static constexpr int PITCH = ROW + 16;
  static constexpr int KV = kTile * PITCH;
  static constexpr int STAGE = 2 * KV + (sizeof(T) == 1 ? 2 * kTile * 4 : 0);
};

// Start the copies of tile t into stage `st`: admitted key rows, the rest
// zero-filled (no read). Rows of p.hd < HD elements (fp32 instances only)
// are copied element by element, the dims past p.hd zero.
template <typename T, int HD, bool PAGED>
__device__ __forceinline__ void load_tile(unsigned char* st, const Params& p, const Span& s,
                                          int b, int h, int t) {
  using RG = Ring<T, HD>;
  constexpr int CH = RG::ROW / 16;
  const long long row = tile_row<PAGED>(p, b, h, t);
  const int k0 = t * kTile;
  if (p.hd == HD) {
    const char* gk = static_cast<const char*>(p.k) + row * RG::ROW;
    const char* gv = static_cast<const char*>(p.v) + row * RG::ROW;
    for (int i = threadIdx.x; i < kTile * CH; i += kThreads) {
      const int j = i / CH, c = (i % CH) * 16;
      const bool ok = k0 + j < s.ext || in_window(p, k0 + j);
      const int off = j * RG::ROW + c;
      cp_async_zfill<16>(st + j * RG::PITCH + c, ok ? gk + off : gk, ok);
      cp_async_zfill<16>(st + RG::KV + j * RG::PITCH + c, ok ? gv + off : gv, ok);
    }
  } else if constexpr (sizeof(T) != 2) {  // bf16 instances always run at p.hd == HD
    const T* gk = static_cast<const T*>(p.k) + row * p.hd;
    const T* gv = static_cast<const T*>(p.v) + row * p.hd;
    for (int i = threadIdx.x; i < kTile * HD; i += kThreads) {
      const int j = i / HD, d = i % HD;
      const bool ok = d < p.hd && (k0 + j < s.ext || in_window(p, k0 + j));
      const long long off = (long long)j * p.hd + d;
      *reinterpret_cast<T*>(st + j * RG::PITCH + d * sizeof(T)) = ok ? gk[off] : T(0);
      *reinterpret_cast<T*>(st + RG::KV + j * RG::PITCH + d * sizeof(T)) = ok ? gv[off] : T(0);
    }
  }
  if constexpr (sizeof(T) == 1) {  // thread i < 64: k scale of key i; else v scale of i - 64
    const int j = threadIdx.x % kTile;
    const bool ok = k0 + j < s.ext || in_window(p, k0 + j);
    const float* src = threadIdx.x < kTile ? p.k_scale : p.v_scale;
    cp_async_zfill<4>(st + 2 * RG::KV + 4 * threadIdx.x, ok ? src + row + j : src, ok);
  }
}

__device__ __forceinline__ void cp_async_wait_upto(int n) {
  if (n <= 0)
    cp_async_wait<0>();
  else if (n == 1)
    cp_async_wait<1>();
  else if (n == 2)
    cp_async_wait<2>();
  else
    cp_async_wait<3>();
}

// Walk the split's admitted tiles through a ring of `stages` (1-4) slots:
// the first `stages` tiles are all in flight before the first is reduced
// (a split runs 1-3 tiles at the decode shapes, so all of its bytes are
// requested at once); after tile i is reduced, its slot takes tile i +
// stages. `setup` runs once, while the first copies are in flight;
// `compute(stage, tile)` reduces one tile. Returns whether any tile was
// reduced; ends with the ring idle and a barrier behind every thread.
template <typename T, int HD, bool PAGED, typename Setup, typename Compute>
__device__ __forceinline__ bool run_tiles(unsigned char* ring, const Params& p, const Span& s,
                                          int b, int h, Setup&& setup, Compute&& compute) {
  constexpr int STAGE = Ring<T, HD>::STAGE;
  const int stages = p.stages;
  int lt = s.next(s.t0), ct = lt;
  const bool any = ct < s.t1;
  for (int i = 0; i < stages; ++i) {
    if (lt < s.t1) {
      load_tile<T, HD, PAGED>(ring + i * STAGE, p, s, b, h, lt);
      lt = s.next(lt + 1);
    }
    cp_async_commit();
  }
  setup();
  for (int it = 0; ct < s.t1; ++it) {
    cp_async_wait_upto(stages - 1);  // tile it's group (one group a tile, empty past the run)
    __syncthreads();
    compute(ring + (it % stages) * STAGE, ct);
    ct = s.next(ct + 1);
    __syncthreads();  // every warp is done with the slot
    if (lt < s.t1) {
      load_tile<T, HD, PAGED>(ring + (it % stages) * STAGE, p, s, b, h, lt);
      lt = s.next(lt + 1);
    }
    cp_async_commit();
  }
  cp_async_wait<0>();
  __syncthreads();
  return any;
}

// The epilogue's shared memory (over the idle ring): KG partial results of
// rows [0, RP) (a block's warps over different keys; KG = 1 for the fp32
// kernel): acc [KG][RP][HD], max m and sum l [KG][RP], the weights w of the
// merge [KG][RP], then each row's merged max M and sum L. The combine of
// the splits reuses acc for the [S][R] maxima (then weights) and sums.
struct Epi {
  float *acc, *m, *l, *w, *M, *L;

  __host__ __device__ static constexpr int floats(int KG, int RP, int HD) {
    return (KG * RP * HD > 2 * kMaxSplits * kMaxRows ? KG * RP * HD : 2 * kMaxSplits * kMaxRows) +
           3 * KG * RP + 2 * RP;
  }
  __device__ Epi(float* base, int KG, int RP, int HD) {
    acc = base;
    m = base + (KG * RP * HD > 2 * kMaxSplits * kMaxRows ? KG * RP * HD
                                                         : 2 * kMaxSplits * kMaxRows);
    l = m + KG * RP;
    w = l + KG * RP;
    M = w + KG * RP;
    L = M + RP;
  }
};

__device__ __forceinline__ void store4(__nv_bfloat16* dst, float4 x) {
  __nv_bfloat162* d = reinterpret_cast<__nv_bfloat162*>(dst);
  d[0] = __floats2bfloat162_rn(x.x, x.y);
  d[1] = __floats2bfloat162_rn(x.z, x.w);
}
__device__ __forceinline__ void store4(float* dst, float4 x) {
  *reinterpret_cast<float4*>(dst) = x;
}

// dims [d, d + 4) of output row `qrow` (rows p.hd elements apart): one
// vector store at p.hd == HD, else the dims below p.hd one at a time (fp32
// instances only)
template <int HD, typename TO>
__device__ __forceinline__ void store_out(const Params& p, TO* o, long long qrow, int d,
                                          float4 x) {
  if (p.hd == HD) {
    store4(o + qrow * HD + d, x);
  } else if constexpr (sizeof(TO) == 4) {
    const float v[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (d + i < p.hd) o[qrow * p.hd + d + i] = v[i];
  }
}

__device__ __forceinline__ void fma4(float4& a, float w, float4 x) {
  a.x += w * x.x;
  a.y += w * x.y;
  a.z += w * x.z;
  a.w += w * x.w;
}

// Merge the block's KG partial results row by row, then store the output
// (S = 1) or write this split's partial and, in the block that finishes
// (b, h) last, combine the S partials in split order and store the output.
// `any`: whether this block reduced a tile (an empty split writes sum 0).
template <int HD, bool SPLIT, typename TO>
__device__ __forceinline__ void finish(const Params& p, float* base, int KG, int RP, int b,
                                       int h, int z, bool any) {
  constexpr int Q4 = HD / 4;
  const int Rt = p.W * p.g, row0 = blockIdx.z * p.rows;
  const int tid = threadIdx.x, R = min(p.rows, Rt - row0);  // the block's rows from row0
  const Epi e(base, KG, RP, HD);
  for (int r = tid; r < R; r += kThreads) {
    float M = kNeg;
    for (int k = 0; k < KG; ++k) M = fmaxf(M, e.m[k * RP + r]);
    const float mref = M == kNeg ? 0.f : M;
    float L = 0.f;
    for (int k = 0; k < KG; ++k) {
      const float w = exp2_approx(e.m[k * RP + r] - mref);
      e.w[k * RP + r] = w;
      L += w * e.l[k * RP + r];
    }
    e.M[r] = M;
    e.L[r] = L;
  }
  __syncthreads();
  TO* o = static_cast<TO*>(p.o);
  auto merged = [&](int r, int d) {
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int k = 0; k < KG; ++k)
      fma4(a, e.w[k * RP + r], *reinterpret_cast<const float4*>(e.acc + (k * RP + r) * HD + d));
    return a;
  };
  if constexpr (!SPLIT) {
    for (int i = tid; i < R * Q4; i += kThreads) {
      const int r = i / Q4, d = 4 * (i % Q4);
      const float4 a = merged(r, d);
      const float inv = 1.f / fmaxf(e.L[r], 1e-30f);
      store_out<HD>(p, o, qo_row(p, b, h, row0 + r), d,
                    make_float4(a.x * inv, a.y * inv, a.z * inv, a.w * inv));
    }
  } else {
    const int bh = b * p.kh + h, S = p.splits, ct = bh * gridDim.z + blockIdx.z;
    const long long rows = (long long)p.B * p.kh * S * Rt;
    float* pacc = p.part;
    float* pm = pacc + rows * HD;
    float* pl = pm + rows;
    const long long rb = (long long)bh * S * Rt + row0;  // row of split 0, the block's row 0
    const long long r0 = rb + (long long)z * Rt;
    if (any) {
      for (int i = tid; i < R * Q4; i += kThreads) {
        const int r = i / Q4, d = 4 * (i % Q4);
        *reinterpret_cast<float4*>(pacc + (r0 + r) * HD + d) = merged(r, d);
      }
    }
    for (int r = tid; r < R; r += kThreads) {
      pm[r0 + r] = e.M[r];
      pl[r0 + r] = any ? e.L[r] : 0.f;
    }
    __threadfence();  // this block's partial, before its ticket
    __syncthreads();
    __shared__ int last;
    if (tid == 0) last = atomicAdd(p.counters + ct, 1) == S - 1;
    __syncthreads();
    if (!last) return;
    __threadfence();  // every other split's partial, after their tickets
    // the S partials' max and sum in shared memory (all loads in flight at
    // once), then each row's weights [S][R] over acc's space (S R <=
    // kMaxSplits kMaxRows), the sum of an empty split's weighing nothing
    float* cm = e.acc;
    float* cl = e.acc + S * R;
    for (int i = tid; i < S * R; i += kThreads) {
      const long long at = rb + (long long)(i / R) * Rt + i % R;
      cm[i] = __ldcg(pm + at);
      cl[i] = __ldcg(pl + at);
    }
    __syncthreads();
    for (int r = tid; r < R; r += kThreads) {
      float M = kNeg;
      for (int s = 0; s < S; ++s)
        if (cl[s * R + r] > 0.f) M = fmaxf(M, cm[s * R + r]);
      const float mref = M == kNeg ? 0.f : M;
      float L = 0.f;
      for (int s = 0; s < S; ++s) {
        const float ls = cl[s * R + r];
        const float w = ls > 0.f ? exp2_approx(cm[s * R + r] - mref) : 0.f;
        cm[s * R + r] = w;
        L += w * ls;
      }
      e.L[r] = L;
    }
    __syncthreads();
    for (int i = tid; i < R * Q4; i += kThreads) {
      const int r = i / Q4, d = 4 * (i % Q4);
      float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 8
      for (int s = 0; s < S; ++s) {
        const float w = cm[s * R + r];
        if (w != 0.f)
          fma4(a, w,
               __ldcg(reinterpret_cast<const float4*>(pacc + (rb + (long long)s * Rt + r) * HD +
                                                      d)));
      }
      const float inv = 1.f / fmaxf(e.L[r], 1e-30f);
      store_out<HD>(p, o, qo_row(p, b, h, row0 + r), d,
                    make_float4(a.x * inv, a.y * inv, a.z * inv, a.w * inv));
    }
    if (tid == 0) p.counters[ct] = 0;
  }
}

// x, y as a bf16 pair (x low) and the pair of what rounding left of them
__device__ __forceinline__ void split_bf16(float x, float y, uint32_t& hi, uint32_t& lo) {
  hi = pack_bf16(x, y);
  lo = pack_bf16(x - __uint_as_float(hi << 16), y - __uint_as_float(hi & 0xffff0000u));
}

// bf16 q over bf16 (T = __nv_bfloat16) or int8 (T = int8_t) key rows, on the
// tensor cores; 16 MT query rows a block
template <int HD, int MT, typename T, bool PAGED, bool SPLIT>
__global__ void __launch_bounds__(kThreads, MT == 1 ? 3 : 2) tc_kernel(const Params p) {
  constexpr bool Q8 = sizeof(T) == 1;
  using RG = Ring<T, HD>;
  constexpr int KG = kWarps / MT;  // warps side by side over a tile's keys
  constexpr int KW = kTile / KG;   // keys a warp takes of each tile: 16 MT
  constexpr int NS = KW / 8;       // its n tiles of S
  constexpr int NO = HD / 8;       // n tiles of the output
  constexpr int RP = 16 * MT;
  extern __shared__ __align__(16) unsigned char smem[];

  const int b = blockIdx.x / p.kh, h = blockIdx.x % p.kh, z = blockIdx.y;
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int g = lane / 4, t = lane % 4;
  const int mt = warp % MT, kg = warp / MT, kb = kg * KW;  // kb: the warp's first key
  const int row0 = blockIdx.z * p.rows, R = min(p.rows, p.W * p.g - row0);
  const int r0 = 16 * mt + g, r1 = r0 + 8;  // the lane's two query rows (of the block's)
  const Span s = make_span(p, b, z);
  const int lim0 = s.lim + (row0 + r0) / p.g, lim1 = s.lim + (row0 + r1) / p.g;
  const float sc = p.scale * kLog2e;

  uint32_t qf[HD / 16][4];  // Q's A fragments, one per k step of 16 dims
  float acc[NO][4];
  float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int n = 0; n < NO; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  auto setup = [&]() {
    const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(p.q);
    const __nv_bfloat16* q0 = q + (r0 < R ? qo_row(p, b, h, row0 + r0) * HD : 0);
    const __nv_bfloat16* q1 = q + (r1 < R ? qo_row(p, b, h, row0 + r1) * HD : 0);
#pragma unroll
    for (int c = 0; c < HD / 16; ++c) {
      if constexpr (!Q8) {
        qf[c][0] = r0 < R ? ld_pair(q0 + 16 * c + 2 * t) : 0u;
        qf[c][1] = r1 < R ? ld_pair(q1 + 16 * c + 2 * t) : 0u;
        qf[c][2] = r0 < R ? ld_pair(q0 + 16 * c + 8 + 2 * t) : 0u;
        qf[c][3] = r1 < R ? ld_pair(q1 + 16 * c + 8 + 2 * t) : 0u;
      } else {  // k = 2t, 2t + 1 are dims 4t, 4t + 2; k = 2t + 8, 2t + 9 dims 4t + 1, 4t + 3
        const uint2 u0 = r0 < R ? *reinterpret_cast<const uint2*>(q0 + 16 * c + 4 * t)
                                : make_uint2(0u, 0u);
        const uint2 u1 = r1 < R ? *reinterpret_cast<const uint2*>(q1 + 16 * c + 4 * t)
                                : make_uint2(0u, 0u);
        qf[c][0] = __byte_perm(u0.x, u0.y, 0x5410);
        qf[c][1] = __byte_perm(u1.x, u1.y, 0x5410);
        qf[c][2] = __byte_perm(u0.x, u0.y, 0x7632);
        qf[c][3] = __byte_perm(u1.x, u1.y, 0x7632);
      }
    }
  };

  auto compute = [&](const unsigned char* st, int tile) {
    const unsigned char* sk = st;
    const unsigned char* sv = st + RG::KV;
    const float* sks = reinterpret_cast<const float*>(st + 2 * RG::KV);  // int8: k, v scales
    const int k0 = tile * kTile;
    float sa[NS][4];
    // S = Q K^T over the warp's KW keys
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      sa[j][0] = sa[j][1] = sa[j][2] = sa[j][3] = 0.f;
      const unsigned char* kr = sk + (kb + 8 * j + (lane & 7)) * RG::PITCH;
      if constexpr (!Q8) {
#pragma unroll
        for (int c2 = 0; c2 < HD / 32; ++c2) {
          uint32_t r[4];
          ldsm_x4(r, kr + (32 * c2 + 8 * (lane >> 3)) * 2);
          mma_bf16_16816(sa[j], qf[2 * c2], r[0], r[1]);
          mma_bf16_16816(sa[j], qf[2 * c2 + 1], r[2], r[3]);
        }
      } else {
#pragma unroll
        for (int c4 = 0; c4 < HD / 64; ++c4) {
          uint32_t r[4];
          ldsm_x4(r, kr + 64 * c4 + 16 * (lane >> 3));  // r[i]: key g, dims 16 (4 c4 + i) + 4t ..
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            uint32_t even, odd;
            int8_pairs(r[i], even, odd);
            mma_bf16_16816(sa[j], qf[4 * c4 + i], even, odd);
          }
        }
      }
    }
    // scale and mask in fp32, then the online softmax on the fragments
    float mx[2] = {kNeg, kNeg};
#pragma unroll
    for (int j = 0; j < NS; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = kb + 8 * j + 2 * t + (e & 1), kpos = k0 + key;
        float x = sa[j][e] * sc;
        if constexpr (Q8) x *= sks[key];
        const bool ok = kpos < (e < 2 ? lim0 : lim1) || in_window(p, kpos);
        x = ok ? x : kNeg;
        sa[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float mref[2], alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float mn = fmaxf(m[i], quad_max(mx[i]));
      mref[i] = mn == kNeg ? 0.f : mn;  // no admitted key yet: every weight 0
      alpha[i] = exp2_approx(m[i] - mref[i]);
      m[i] = mn;
      l[i] *= alpha[i];
    }
#pragma unroll
    for (int j = 0; j < NS; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float pe = exp2_approx(sa[j][e] - mref[e >> 1]);
        l[e >> 1] += pe;
        if constexpr (Q8) pe *= sks[kTile + kb + 8 * j + 2 * t + (e & 1)];
        sa[j][e] = pe;
      }
    }
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }
    // O += P V, 16 keys a step, P as bf16 hi + lo
#pragma unroll
    for (int kc = 0; kc < KW / 16; ++kc) {
      uint32_t hi[4], lo[4];
      split_bf16(sa[2 * kc][0], sa[2 * kc][1], hi[0], lo[0]);
      split_bf16(sa[2 * kc][2], sa[2 * kc][3], hi[1], lo[1]);
      split_bf16(sa[2 * kc + 1][0], sa[2 * kc + 1][1], hi[2], lo[2]);
      split_bf16(sa[2 * kc + 1][2], sa[2 * kc + 1][3], hi[3], lo[3]);
      const unsigned char* vr =
          sv + (kb + 16 * kc + (lane & 7) + 8 * ((lane >> 3) & 1)) * RG::PITCH;
      if constexpr (!Q8) {
#pragma unroll
        for (int n2 = 0; n2 < HD / 16; ++n2) {
          uint32_t r[4];
          ldsm_x4_trans(r, vr + (16 * n2 + 8 * (lane >> 4)) * 2);
          mma_bf16_16816(acc[2 * n2], hi, r[0], r[1]);
          mma_bf16_16816(acc[2 * n2], lo, r[0], r[1]);
          mma_bf16_16816(acc[2 * n2 + 1], hi, r[2], r[3]);
          mma_bf16_16816(acc[2 * n2 + 1], lo, r[2], r[3]);
        }
      } else {  // acc[2 cj] holds dims 16 cj + 2c (column c), acc[2 cj + 1] dims 16 cj + 2c + 1
#pragma unroll
        for (int j2 = 0; j2 < HD / 32; ++j2) {
          uint32_t r[4];
          ldsm_x4_trans(r, vr + 16 * (2 * j2 + (lane >> 4)));
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int cj = 2 * j2 + half;
            uint32_t e0, o0, e1, o1;
            int8_pairs(r[2 * half], e0, o0);
            int8_pairs(r[2 * half + 1], e1, o1);
            mma_bf16_16816(acc[2 * cj], hi, e0, e1);
            mma_bf16_16816(acc[2 * cj], lo, e0, e1);
            mma_bf16_16816(acc[2 * cj + 1], hi, o0, o1);
            mma_bf16_16816(acc[2 * cj + 1], lo, o0, o1);
          }
        }
      }
    }
  };

  const bool any = run_tiles<T, HD, PAGED>(smem, p, s, b, h, setup, compute);

  // the warp's result for rows r0, r1 as key group kg of the block, dims in order
  const Epi e(reinterpret_cast<float*>(smem), KG, RP, HD);
  l[0] = quad_sum(l[0]);
  l[1] = quad_sum(l[1]);
  if (t == 0) {
    e.m[kg * RP + r0] = m[0];
    e.m[kg * RP + r1] = m[1];
    e.l[kg * RP + r0] = l[0];
    e.l[kg * RP + r1] = l[1];
  }
  float* a0 = e.acc + (kg * RP + r0) * HD;
  float* a1 = e.acc + (kg * RP + r1) * HD;
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    if constexpr (!Q8) {
      *reinterpret_cast<float2*>(a0 + 8 * n + 2 * t) = make_float2(acc[n][0], acc[n][1]);
      *reinterpret_cast<float2*>(a1 + 8 * n + 2 * t) = make_float2(acc[n][2], acc[n][3]);
    } else if (n % 2 == 0) {
      const int d = 8 * n + 4 * t;  // 16 cj + 4t: dims 4t .. 4t + 3 of chunk cj = n / 2
      *reinterpret_cast<float4*>(a0 + d) =
          make_float4(acc[n][0], acc[n + 1][0], acc[n][1], acc[n + 1][1]);
      *reinterpret_cast<float4*>(a1 + d) =
          make_float4(acc[n][2], acc[n + 1][2], acc[n][3], acc[n + 1][3]);
    }
  }
  __syncthreads();
  finish<HD, SPLIT, __nv_bfloat16>(p, e.acc, KG, RP, b, h, z, any);
}

// fp32 q over fp32 (T = float) or int8 (T = int8_t) key rows, CUDA-core
// fp32; up to MR query rows a block
template <int HD, int MR, typename T, bool PAGED, bool SPLIT>
__global__ void __launch_bounds__(kThreads) f32_kernel(const Params p) {
  constexpr bool Q8 = sizeof(T) == 1;
  using RG = Ring<T, HD>;
  constexpr int QG = kThreads / kTile;  // scores: key tid % kTile, rows by tid / kTile
  constexpr int QR = MR / QG;
  constexpr int PL = HD / 4;            // P V: dims 4 (tid % PL) .. + 3, rows by tid / PL
  constexpr int PG = kThreads / PL;
  constexpr int PR = MR / PG;
  constexpr int BASE = ((2 * RG::STAGE > Epi::floats(1, MR, HD) * 4 ? 2 * RG::STAGE
                                                                      : Epi::floats(1, MR, HD) * 4) +
                        15) / 16 * 16;
  extern __shared__ __align__(16) unsigned char smem[];
  float* sQ = reinterpret_cast<float*>(smem + BASE);  // [MR, HD], times hd^-0.5 log2 e
  float* sS = sQ + MR * HD;                            // [MR, kTile] scores, then P
  float* sM = sS + MR * kTile;                         // running max
  float* sL = sM + MR;                                 // running sum
  float* sA = sL + MR;                                 // this tile's rescale

  const int b = blockIdx.x / p.kh, h = blockIdx.x % p.kh, z = blockIdx.y;
  const int tid = threadIdx.x, warp = tid / kWarp, lane = tid % kWarp;
  const int row0 = blockIdx.z * p.rows, R = min(p.rows, p.W * p.g - row0);
  const Span s = make_span(p, b, z);
  const int d = 4 * (tid % PL), pg = tid / PL;
  float4 acc[PR];
#pragma unroll
  for (int i = 0; i < PR; ++i) acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);

  auto load4 = [](const T* src) -> float4 {
    if constexpr (Q8) {
      const unsigned w = *reinterpret_cast<const unsigned*>(src);
      return make_float4(static_cast<float>(static_cast<int>(w << 24) >> 24),
                         static_cast<float>(static_cast<int>(w << 16) >> 24),
                         static_cast<float>(static_cast<int>(w << 8) >> 24),
                         static_cast<float>(static_cast<int>(w) >> 24));
    } else {
      return *reinterpret_cast<const float4*>(src);
    }
  };

  auto setup = [&]() {
    const float* q = static_cast<const float*>(p.q);
    const float sc = p.scale * kLog2e;
    for (int i = tid; i < R * HD; i += kThreads) {
      const int d = i % HD;
      sQ[i] = d < p.hd ? q[qo_row(p, b, h, row0 + i / HD) * p.hd + d] * sc : 0.f;
    }
    for (int r = tid; r < R; r += kThreads) {
      sM[r] = kNeg;
      sL[r] = 0.f;
    }
  };

  auto compute = [&](const unsigned char* st, int tile) {
    const float* sks = reinterpret_cast<const float*>(st + 2 * RG::KV);
    const int k0 = tile * kTile;
    {  // scores (times the k scale), masked
      const int j = tid % kTile, grp = tid / kTile, kpos = k0 + j;
      const T* kr = reinterpret_cast<const T*>(st + j * RG::PITCH);
      float sx[QR];
#pragma unroll
      for (int i = 0; i < QR; ++i) sx[i] = 0.f;
#pragma unroll 4
      for (int c = 0; c < HD; c += 4) {
        const float4 kf = load4(kr + c);
#pragma unroll
        for (int i = 0; i < QR; ++i) {
          const int r = grp + QG * i;
          if (r < R) {
            const float4 a = *reinterpret_cast<const float4*>(sQ + r * HD + c);
            sx[i] += a.x * kf.x + a.y * kf.y + a.z * kf.z + a.w * kf.w;
          }
        }
      }
      const float ks = Q8 ? sks[j] : 1.f;
#pragma unroll
      for (int i = 0; i < QR; ++i) {
        const int r = grp + QG * i;
        if (r < R) {
          const bool ok = kpos < s.lim + (row0 + r) / p.g || in_window(p, kpos);
          sS[r * kTile + j] = ok ? sx[i] * ks : kNeg;
        }
      }
    }
    __syncthreads();
    // the online softmax, a row per warp: P = exp2(s - m) (times the v scale)
    for (int r = warp; r < R; r += kWarps) {
      float* row = sS + r * kTile;
      const float x0 = row[lane], x1 = row[lane + 32];
      const float m_old = sM[r];
      const float mn = fmaxf(m_old, warp_max(fmaxf(x0, x1)));
      const float mref = mn == kNeg ? 0.f : mn;
      float p0 = exp2_approx(x0 - mref), p1 = exp2_approx(x1 - mref);
      const float sum = warp_sum(p0 + p1);
      if constexpr (Q8) {
        p0 *= sks[kTile + lane];
        p1 *= sks[kTile + lane + 32];
      }
      row[lane] = p0;
      row[lane + 32] = p1;
      if (lane == 0) {
        const float alpha = exp2_approx(m_old - mref);
        sA[r] = alpha;
        sL[r] = sL[r] * alpha + sum;
        sM[r] = mn;
      }
    }
    __syncthreads();
    // O = O alpha + P V, four dims a thread
    const T* sv = reinterpret_cast<const T*>(st + RG::KV);
#pragma unroll
    for (int i = 0; i < PR; ++i) {
      const int r = pg + PG * i;
      if (r < R) {
        const float a = sA[r];
        acc[i].x *= a;
        acc[i].y *= a;
        acc[i].z *= a;
        acc[i].w *= a;
      }
    }
#pragma unroll 4
    for (int j = 0; j < kTile; ++j) {
      const float4 vv = load4(reinterpret_cast<const T*>(
                                  reinterpret_cast<const unsigned char*>(sv) + j * RG::PITCH) +
                              d);
#pragma unroll
      for (int i = 0; i < PR; ++i) {
        const int r = pg + PG * i;
        if (r < R) fma4(acc[i], sS[r * kTile + j], vv);
      }
    }
  };

  const bool any = run_tiles<T, HD, PAGED>(smem, p, s, b, h, setup, compute);

  const Epi e(reinterpret_cast<float*>(smem), 1, MR, HD);
#pragma unroll
  for (int i = 0; i < PR; ++i) {
    const int r = pg + PG * i;
    if (r < R) *reinterpret_cast<float4*>(e.acc + r * HD + d) = acc[i];
  }
  for (int r = tid; r < R; r += kThreads) {
    e.m[r] = sM[r];
    e.l[r] = sL[r];
  }
  __syncthreads();
  finish<HD, SPLIT, float>(p, e.acc, 1, MR, b, h, z, any);
}

template <typename Kernel>
cudaError_t launch(Kernel kernel, const Params& p, size_t smem, cudaStream_t stream) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  const int R = p.W * p.g;
  kernel<<<dim3(p.B * p.kh, p.splits, (R + p.rows - 1) / p.rows), kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

inline int sm_count() {
  static int count[64] = {};  // by device
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64) return 132;
  if (count[dev] == 0) cudaDeviceGetAttribute(&count[dev], cudaDevAttrMultiProcessorCount, dev);
  return count[dev];
}

// The tensor-core kernel for bf16 q: a ring stage for each tile of the
// split's run (all in flight at once), up to 4, as many as fit beside the
// other blocks an SM holds when the grid runs in one wave
// Query rows a block takes of R, at most cap: R in ceil(R / cap) groups, as even as can
// be (one group where R <= cap, as at every decode step)
inline int block_rows(int R, int cap) {
  const int n = (R + cap - 1) / cap;
  return (R + n - 1) / n;
}

template <int HD, int MT, typename T, bool PAGED>
cudaError_t launch_tc(Params p, cudaStream_t stream) {
  constexpr int STAGE = Ring<T, HD>::STAGE;
  p.rows = block_rows(p.W * p.g, 16 * MT);
  const int run = (p.n_tiles + p.splits - 1) / p.splits;
  const int sms = sm_count(),
            grid = p.B * p.kh * p.splits * ((p.W * p.g + p.rows - 1) / p.rows);
  const int per_sm = std::max(1, (grid + sms - 1) / sms);
  p.stages = std::max(1, std::min({run, 4, (kSmemPerSM / per_sm - 1024) / STAGE}));
  const size_t smem = std::max(size_t(p.stages) * STAGE,
                               size_t(Epi::floats(kWarps / MT, 16 * MT, HD)) * 4);
  if (p.splits > 1) return launch(tc_kernel<HD, MT, T, PAGED, true>, p, smem, stream);
  return launch(tc_kernel<HD, MT, T, PAGED, false>, p, smem, stream);
}

template <int HD, typename T, bool PAGED>
cudaError_t launch_tc_rows(const Params& p, cudaStream_t stream) {
  const int R = block_rows(p.W * p.g, kMaxRows);  // rows a block
  if (R <= 16) return launch_tc<HD, 1, T, PAGED>(p, stream);
  if (R <= 32) return launch_tc<HD, 2, T, PAGED>(p, stream);
  return launch_tc<HD, 4, T, PAGED>(p, stream);
}

// The CUDA-core kernel for fp32 q: a two-stage ring
template <int HD, int MR, typename T, bool PAGED>
cudaError_t launch_f32(Params p, cudaStream_t stream) {
  constexpr size_t RING = 2 * size_t(Ring<T, HD>::STAGE);
  constexpr size_t EPI = size_t(Epi::floats(1, MR, HD)) * 4;
  constexpr size_t BASE = ((RING > EPI ? RING : EPI) + 15) / 16 * 16;
  p.stages = 2;
  p.rows = block_rows(p.W * p.g, MR);
  const size_t smem = BASE + size_t(MR) * (HD + kTile + 3) * 4;
  if (p.splits > 1) return launch(f32_kernel<HD, MR, T, PAGED, true>, p, smem, stream);
  return launch(f32_kernel<HD, MR, T, PAGED, false>, p, smem, stream);
}

// Checks common to both entry points
inline bool valid(const Params& p) {
  const int R = p.W * p.g;
  return p.B > 0 && p.W > 0 && p.kh > 0 && p.g > 0 && R <= kMaxQueryRows && p.n_tiles > 0 &&
         p.hd > 0 && p.hd <= 128 &&
         p.splits >= 1 && p.splits <= std::min(kMaxSplits, p.n_tiles) &&
         (p.splits == 1 || (p.part != nullptr && p.counters != nullptr));
}

}  // namespace dsplit
}  // namespace vr2
