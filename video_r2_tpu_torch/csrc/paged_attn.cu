// Paged decode attention for Hopper (sm_90a): one decode token, or a W-token
// verify chunk, per sequence, reading its keys and values through a page
// table out of the stacked page pool [L, kh, N_pages, page_size, hd].
//
// Replaces the TPU kernels video_r2_tpu/ops/paged_attention.py::
// _paged_decode_kernel_stacked (:91, bf16 pages) and
// _paged_decode_kernel_stacked_quant (:166, int8 pages with fp32
// per-(token, head) scale pages), and, over a one-layer view of the pool,
// _paged_decode_kernel (:30). Same semantics: q and the output bf16 or
// fp32, as the JAX kernels take both (they cast each tile to f32 and write
// the operand's type); pages of q's type, or int8 with fp32 scales; the
// layer index picks the layer of the pool; query i of the chunk (row w * g
// + j for query head h * g + j) admits keys < lengths[b] + i; the int8
// scales factor out of both products (s = (q . k_int8) * k_scale, and P
// times the v scale before P @ V, as the TPU kernel's :227 and :237);
// online softmax in fp32; the output is the accumulator over max(l, 1e-30).
// A row that admits no key emits 0. Only the pages that hold admitted keys
// are read, and of those only the admitted rows; each table entry read is
// checked against the pool.
//
// What bounds it on the card, and the design (split along the sequence,
// both products on the tensor cores for bf16 q over bf16 or int8 pages, a
// CUDA-core fp32 instance for fp32 q over fp32 or int8 pages):
// csrc/split_decode.cuh. Here: tile t of a sequence is rows [64 t mod ps,
// + 64) of page table[b][64 t / ps] (page sizes 64 and 128, so a tile lies
// in one page); W g <= 128 query rows a (sequence, kv head): up to 64 in one
// block, more in two blocks of even halves (grid z; the judge's 72-row
// verify chunk at K = 8, g = 8, as two of 36), a block's rows in 1, 2 or 4
// row tiles of 16 (bf16 q) or up to 64 rows (fp32 q). Both blocks read the
// same key tiles: above 64 rows the key bytes are read twice. bf16 q at
// head dims 64 and 128; fp32 q at any head dim from 1 to 128, on the
// instance of width 32, 64 or 128.
#include "split_decode.cuh"

using namespace vr2::dsplit;

namespace {

template <int HD>
cudaError_t dispatch_bf16(const Params& p, bool quant, cudaStream_t st) {
  return quant ? launch_tc_rows<HD, int8_t, true>(p, st)
               : launch_tc_rows<HD, __nv_bfloat16, true>(p, st);
}

template <int HD>
cudaError_t dispatch_f32(const Params& p, bool quant, cudaStream_t st) {
  return quant ? launch_f32<HD, kMaxRows, int8_t, true>(p, st)
               : launch_f32<HD, kMaxRows, float, true>(p, st);
}

}  // namespace

// Plain C entry point, loaded with ctypes. q and o are contiguous
// [B, W, nh, hd], bf16 (elem_bytes 2; hd 64 or 128) or fp32 (4; hd 1 to
// 128); k / v the contiguous
// pool [L, kh, num_pages, page_size, hd] of q's type, or int8 when k_scale /
// v_scale (fp32 [L, kh, num_pages, page_size]) are given; tables int32
// [B, max_pages], every entry a row reads a valid page id; lengths int32
// [B]; `splits` the wrapper's split plan (1 to min(64, max_pages page_size /
// 64)), and with splits > 1 an fp32 workspace `part` of B kh splits W
// (nh / kh) (w + 2) floats (w: hd rounded up to 32, 64 or 128) and B kh Z
// int32 `counters` (Z = 1 up to 64 query rows, else 2), 0 between launches
// (each launch leaves them 0). Returns a cudaError_t.
extern "C" int vr2_paged_decode_attention(const void* q, const void* k, const void* v,
                                          const void* k_scale, const void* v_scale,
                                          void* o, const int* tables, const int* lengths,
                                          int B, int W, int nh, int kh, int hd,
                                          int page_size, int num_pages, int max_pages,
                                          int layer, int elem_bytes, int splits, float scale,
                                          void* part, void* counters, void* stream) {
  if (kh <= 0 || nh % kh != 0 || (page_size != 64 && page_size != 128) || max_pages <= 0 ||
      layer < 0)
    return int(cudaErrorInvalidValue);
  if ((k_scale == nullptr) != (v_scale == nullptr)) return int(cudaErrorInvalidValue);
  Params p{};
  p.q = q;
  p.k = k;
  p.v = v;
  p.k_scale = static_cast<const float*>(k_scale);
  p.v_scale = static_cast<const float*>(v_scale);
  p.o = o;
  p.lengths = lengths;
  p.tables = tables;
  p.part = static_cast<float*>(part);
  p.counters = static_cast<int*>(counters);
  p.B = B;
  p.W = W;
  p.nh = nh;
  p.kh = kh;
  p.g = nh / kh;
  p.hd = hd;
  p.layer = layer;
  p.width = page_size;
  p.num_pages = num_pages;
  p.max_pages = max_pages;
  p.lo = 1;  // no key range admitted for every row
  p.hi = 0;
  p.n_tiles = max_pages * page_size / kTile;
  p.splits = splits;
  p.scale = scale;
  if (!valid(p)) return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool quant = k_scale != nullptr;
  if (elem_bytes == 2) {
    if (hd == 128) return int(dispatch_bf16<128>(p, quant, st));
    if (hd == 64) return int(dispatch_bf16<64>(p, quant, st));
  } else if (elem_bytes == 4) {
    if (hd <= 32) return int(dispatch_f32<32>(p, quant, st));
    if (hd <= 64) return int(dispatch_f32<64>(p, quant, st));
    return int(dispatch_f32<128>(p, quant, st));
  }
  return int(cudaErrorInvalidValue);
}
