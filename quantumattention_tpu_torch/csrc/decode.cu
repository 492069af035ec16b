// K4: GQA decode attention over a ragged slot cache, one query token a head
// or T speculative candidates (sm_90a).
//
// Replaces the Pallas kernel quantumattention_tpu/ops/decode.py::_decode_kernel
// (decode.py:56; host entry decode_attention, decode.py:321). Same math:
// scores q.k (int8, e4m3 or int4 K taken as its exact value) times
// sm_scale * log2(e) times the token's K scale, exp2-domain online softmax
// in fp32, P times the token's V scale rounded to bf16 for P.V with fp32
// accumulation, a bf16 output, and exact zeros for a slot of length 0 (the
// engine decodes over every slot, active or not). Queries are bf16 (the
// wrapper rounds float32 and float16 ones, as K1 does; over an fp16 cache
// it passes them as fp16, exactly). Multi-query mode (decode.py:359-363,
// mask :176-200): T candidates a head, rows packed t-fastest, candidate t
// seeing the rows below lengths[b] - (T - 1 - t). A sliding window
// (decode.py:200-207) also masks the rows below lengths[b] - 1 - window_left
// - (T - 1 - t), and the tiles wholly below candidate 0's are skipped. fp16 and fp32 caches
// enter as JAX's kernel takes them (no scales): fp16 products with P
// rounded to fp16, fp32 rows rounded to bf16 for bf16 products.
//
// What bounds it on the H100: bytes (each valid cache row of K and V read
// once, 4 * G * D flops a row). It runs on the split-KV decode-attention
// core it shares with K10 (csrc/decode_attn.cuh: a persistent grid balanced
// over the valid 64-row tiles, a TMA producer warp over the
// (B * Hkv * Smax, D) cache, swap-AB mma.sync products with int8 codes
// converted four at a time, one fixed-order merge kernel). Here the rows of
// (slot b, KV head h) are rows (b * Hkv + h) * Smax + r of the cache, and the
// scales enter as the TPU kernel puts them (kScoreScale). A packed int4 cache
// holds element d and d + D/2 in byte d of a row of D/2 bytes: the low
// nibbles meet the query's columns [0, D/2), the high ones [D/2, D), and
// give the output's columns in the same halves. Head dims: any multiple of
// 8 up to 512, at the instantiated width 64/128/256/512; any GQA group
// (more than 16 query rows a KV head are split over segments). The e4m3
// and int4 instantiations are in decode_e4m3.cu and decode_int4.cu, the
// fp16 and fp32 ones (shared with K10) in decode_f16.cu and decode_f32.cu.
#include "decode_attn.cuh"

// q (B, Hq, T, D) bf16 (fp16 for an fp16 cache); k, v (B, Hkv, Smax, D) of
// element kind `kind` (0 int8, 1 e4m3, with fp32 token scales (B, Hkv,
// Smax); 2 bf16, 5 fp16, 6 fp32, scales null; 3 int4, rows of D/2 packed
// bytes, with token scales); lengths (B,) int32, counting the T candidates;
// out (B, Hq, T, D) bf16; part_acc and part_ml fp32 scratch of the sizes
// qa_decode_attn_plan gives. window_left: a sliding window's left extent
// (candidate t sees the rows from lengths[b] - 1 - window_left - (T - 1 - t)
// on; the tiles below candidate 0's first row are never fetched), or -1 for
// none. score_scale = sm_scale * log2(e).
extern "C" int qa_decode(const void* q, const void* k, const void* v, const void* k_scale,
                         const void* v_scale, const void* lengths, void* out, void* part_acc,
                         void* part_ml, int B, int Hq, int Hkv, int Smax, int D, int T, int kind,
                         int window_left, float score_scale, void* stream) {
  using namespace qa::dattn;
  if (B == 0) return 0;
  const bool scaled = kind != kKindBF16 && kind != kKindF16 && kind != kKindF32;
  if (kind == kKindI4T || scaled != (k_scale != nullptr && v_scale != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  Plan pl;
  cudaError_t err = plan(kind, B, Hq, Hkv, D, T, Smax, 0, &pl);
  if (err != cudaSuccess) return static_cast<int>(err);
  Params p = {};
  p.q = q;
  p.ks = static_cast<const float*>(k_scale);
  p.vs = static_cast<const float*>(v_scale);
  p.lengths = static_cast<const int*>(lengths);
  p.table = nullptr;
  p.part_acc = static_cast<float*>(part_acc);
  p.part_ml = static_cast<float*>(part_ml);
  p.B = B;
  p.Hq = Hq;
  p.Hkv = Hkv;
  p.D = D;
  p.T = T;
  p.smax = Smax;
  p.window_left = window_left < 0 ? -1 : window_left;
  p.score_scale = score_scale;
  const int rows = B * Hkv * Smax;
  auto* o = static_cast<__nv_bfloat16*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (kind) {
    case kKindI8: err = run<kScoreScale, kKindI8>(pl, p, k, v, rows, o, s); break;
    case kKindF8: err = run_k4_e4m3(pl, p, k, v, rows, o, s); break;
    case kKindI4D: err = run_k4_int4(pl, p, k, v, rows, o, s); break;
    case kKindF16: err = run_f16(pl, p, k, v, rows, o, s); break;
    case kKindF32: err = run_f32(pl, p, k, v, rows, o, s); break;
    default: err = run_plain16(pl, p, k, v, rows, o, s); break;
  }
  return static_cast<int>(err);
}
