// K10: GQA decode attention over KV pages gathered through a page table,
// one query token a head or T speculative candidates (sm_90a).
//
// Replaces the Pallas kernel quantumattention_tpu/ops/paged.py::_paged_kernel
// (paged.py:77; host entry paged_decode_attention, paged.py:413). Same math
// as its DMA path: each page row of K and V is dequantized per element to
// bf16 (int8, e4m3 or int4 code times the row's fp32 scale, rounded once;
// bf16 pages as they are), scores q.k in fp32 times sm_scale * log2(e)
// (queries rounded to bf16 by the wrapper), rows at or past
// lengths[slot] masked with MASK_VALUE (in multi-query mode, paged.py:459-463,
// mask :261-271, candidate t of T, rows packed t-fastest, also the rows at
// or past lengths[slot] - (T - 1 - t); with a sliding window, paged.py:272-276,
// also the rows below lengths[slot] - 1 - window_left - (T - 1 - t)), an
// exp2 online softmax with fp32
// m, l and accumulator, the unnormalized P rounded to bf16 for P.V, the
// division by l at the end, and exact zeros for a slot of length 0.
//
// What bounds it on the H100: bytes (every valid page row of K and V read
// once, plus a 4-byte scale, for 4 * G * D flops). It runs on the split-KV
// decode-attention core it shares with K4 (csrc/decode_attn.cuh: a
// persistent grid balanced over the valid 64-row tiles, whose size comes
// from the card and never from the lengths, so a decode step can be
// captured in a CUDA graph; a TMA producer warp over the (Hkv * P * ps, D)
// pool; swap-AB mma.sync products; one fixed-order merge kernel). Here a
// 16-row box of slot b's rows is rows (h * P + page) * ps + r % ps of the
// pool, the page read from the table (the TPU kernel's scalar prefetch)
// once a box and only below the slot's length, so table entries past a
// sequence's pages are never read; the scales enter per element
// (kElemScale). Token-packed int4 pages (byte row i of a page of ps tokens
// holds token i low and i + ps/2 high) are read a byte row a token, each
// token taking its nibble. Page sizes: any (even for int4); a 16-token box
// that stays inside a page (and inside its half, for int4: ps % 32 == 0)
// goes by TMA, other sizes row by row by cp.async. Head dims: any multiple
// of 8 up to 512; any GQA group (more than 16 query rows a KV head are
// split over segments). The e4m3 and int4 instantiations are in
// paged_e4m3.cu and paged_int4.cu; fp16 and fp32 pages (no scales, as the
// JAX kernel takes unquantized pages) run the instantiations of
// decode_f16.cu and decode_f32.cu, which K4 shares.
#include "decode_attn.cuh"

// q (B, Hq, T, D) bf16 (fp16 for fp16 pages); k, v (Hkv, P, ps, D) of
// element kind `kind` (0 int8, 1 e4m3, with fp32 token scales (Hkv, P, ps);
// 2 bf16, 5 fp16, 6 fp32, scales null; 4 int4, pages (Hkv, P, ps/2, D)
// token-packed, scales (Hkv, P, ps)); lengths (B,) int32, counting the T
// candidates; table (B, pps) int32 page ids; out (B, Hq, T, D) bf16;
// part_acc and part_ml fp32 scratch of the sizes qa_decode_attn_plan gives
// for smax = pps * ps. window_left: a sliding window's left extent, as K4's
// (pages below candidate 0's first in-window tile are never looked up), or
// -1 for none. score_scale = sm_scale * log2(e).
extern "C" int qa_paged_decode(const void* q, const void* k, const void* v, const void* k_scale,
                               const void* v_scale, const void* lengths, const void* table,
                               void* out, void* part_acc, void* part_ml, int B, int Hq, int Hkv,
                               int P, int ps, int pps, int D, int T, int kind, int window_left,
                               float score_scale, void* stream) {
  using namespace qa::dattn;
  if (B == 0) return 0;
  const bool scaled = kind != kKindBF16 && kind != kKindF16 && kind != kKindF32;
  if (Hkv <= 0 || Hq % Hkv != 0 || ps <= 0 || pps <= 0 || P <= 0 || kind == kKindI4D ||
      scaled != (k_scale != nullptr && v_scale != nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Plan pl;
  cudaError_t err = plan(kind, B, Hq, Hkv, D, T, pps * ps, ps, &pl);
  if (err != cudaSuccess) return static_cast<int>(err);
  Params p = {};
  p.q = q;
  p.ks = static_cast<const float*>(k_scale);
  p.vs = static_cast<const float*>(v_scale);
  p.lengths = static_cast<const int*>(lengths);
  p.table = static_cast<const int*>(table);
  p.part_acc = static_cast<float*>(part_acc);
  p.part_ml = static_cast<float*>(part_ml);
  p.B = B;
  p.Hq = Hq;
  p.Hkv = Hkv;
  p.D = D;
  p.T = T;
  p.smax = pps * ps;
  p.P = P;
  p.ps = ps;
  p.pps = pps;
  p.window_left = window_left < 0 ? -1 : window_left;
  p.score_scale = score_scale;
  const int rows = Hkv * P * (kind == kKindI4T ? ps / 2 : ps);
  auto* o = static_cast<__nv_bfloat16*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (kind) {
    case kKindI8: err = run<kElemScale, kKindI8>(pl, p, k, v, rows, o, s); break;
    case kKindF8: err = run_k10_e4m3(pl, p, k, v, rows, o, s); break;
    case kKindI4T: err = run_k10_int4(pl, p, k, v, rows, o, s); break;
    case kKindF16: err = run_f16(pl, p, k, v, rows, o, s); break;
    case kKindF32: err = run_f32(pl, p, k, v, rows, o, s); break;
    default: err = run_plain16(pl, p, k, v, rows, o, s); break;
  }
  return static_cast<int>(err);
}
