// One-token batch decode attention over the head-major stacked KV cache, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel video_r2_tpu/ops/decode_attention.py::
// _decode_kernel (:42, via decode_attention_stacked), with its semantics:
// the cache is [L, B, kh, Smax, hd] (Smax a multiple of 128), bf16 or fp32
// as the JAX kernel takes both, of one type with q and the output; the
// layer index picks the layer; query head h * g + j (g = nh / kh) of
// sequence b attends over key positions kpos with kpos < lengths[b] (the
// right-padded prompt) or s_pad <= kpos <= slot_end (the fixed decode
// slots; slot_end < s_pad turns the window off); q . k is scaled by
// hd^-0.5 in fp32; masked scores are -1e30 and the softmax is online in
// fp32, as the TPU kernel's; the output is the accumulator over
// max(l, 1e-30), rounded to the operands' type. Masks are selects, and the
// stale rows between lengths[b] and s_pad (the pad tokens' K / V) are never
// read: a 64-key tile with no admitted key is skipped whole, and an
// admitted tile zero-fills its other rows. A row with no admitted key (no
// caller makes one) emits 0.
//
// What bounds it on the card, and the design (split along the sequence,
// both products on the tensor cores for bf16, a CUDA-core fp32 instance):
// csrc/split_decode.cuh. Here: one (layer, sequence, kv head) is a
// contiguous [Smax, hd] run, so tile t is rows [64 t, 64 t + 64) of it; g
// <= 16 query rows take one 16-row tile (bf16) or a 16-row block (fp32).
// bf16 at head dims 64 and 128; fp32 at any head dim from 1 to 128, on the
// instance of width 32, 64 or 128.
#include "split_decode.cuh"

using namespace vr2::dsplit;

// Plain C entry point, loaded with ctypes. q and o are contiguous
// [B, nh, hd]; k / v the contiguous stacked cache [L, B, kh, smax, hd] with
// smax a multiple of 128; all four bf16 (elem_bytes 2; hd 64 or 128) or fp32
// (4; hd 1 to 128); lengths int32 [B]; 0 <= layer < L; `splits` the
// wrapper's split plan (1 to min(64, smax / 64)), and with splits > 1 an
// fp32 workspace `part` of B kh splits (nh / kh) (w + 2) floats (w: hd
// rounded up to 32, 64 or 128) and B kh int32 `counters`, 0 between
// launches (each launch leaves them 0). Returns a cudaError_t.
extern "C" int vr2_decode_attention(const void* q, const void* k, const void* v, void* o,
                                    const int* lengths, int B, int nh, int kh, int hd,
                                    int L, int smax, int layer, int s_pad, int slot_end,
                                    int elem_bytes, int splits, float scale, void* part,
                                    void* counters, void* stream) {
  if (kh <= 0 || nh % kh != 0 || nh / kh > 16 || smax <= 0 || smax % 128 != 0 ||
      layer < 0 || layer >= L)
    return int(cudaErrorInvalidValue);
  Params p{};
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.lengths = lengths;
  p.part = static_cast<float*>(part);
  p.counters = static_cast<int*>(counters);
  p.B = B;
  p.W = 1;
  p.nh = nh;
  p.kh = kh;
  p.g = nh / kh;
  p.hd = hd;
  p.layer = layer;
  p.width = smax;
  p.lo = s_pad;
  p.hi = slot_end;
  p.n_tiles = smax / kTile;
  p.splits = splits;
  p.scale = scale;
  if (!valid(p)) return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (elem_bytes == 2) {
    if (hd == 128) return int(launch_tc<128, 1, __nv_bfloat16, false>(p, st));
    if (hd == 64) return int(launch_tc<64, 1, __nv_bfloat16, false>(p, st));
  } else if (elem_bytes == 4) {
    if (hd <= 32) return int(launch_f32<32, 16, float, false>(p, st));
    if (hd <= 64) return int(launch_f32<64, 16, float, false>(p, st));
    return int(launch_f32<128, 16, float, false>(p, st));
  }
  return int(cudaErrorInvalidValue);
}
