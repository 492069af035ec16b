// K10: one-token GQA decode attention over KV pages gathered through a
// page table (sm_90a).
//
// Replaces the Pallas kernel quantumattention_tpu/ops/paged.py::_paged_kernel
// (paged.py:77; host entry paged_decode_attention, paged.py:413). Same math
// as its DMA path: each page row of K and V is dequantized per element to
// bf16 (int8 code times the row's fp32 scale, rounded once; bf16 pages as
// they are), scores q.k in fp32 times sm_scale * log2(e), rows at or past
// lengths[slot] masked with MASK_VALUE, an exp2 online softmax with fp32
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
// sequence's pages are never read; the int8 scales enter per element
// (kElemScale). Page sizes: multiples of 16 up to 256 (a box never crosses
// a page); head dims: any multiple of 8 up to 512; up to 16 query heads a
// KV head.
#include "decode_attn.cuh"

namespace qa {
namespace dattn {

cudaError_t run_elem_scale(const Plan& pl, const Params& p, const void* k, const void* v, int rows,
                           __nv_bfloat16* out, cudaStream_t stream) {
  return run<kElemScale>(pl, p, k, v, rows, out, stream);
}

}  // namespace dattn
}  // namespace qa

// q (B, Hq, D) bf16; k, v (Hkv, P, ps, D) int8 (kv_code 3, with fp32 token
// scales (Hkv, P, ps)) or bf16 (kv_code 0, scales null); lengths (B,) int32;
// table (B, pps) int32 page ids; out (B, Hq, D) bf16; part_acc and part_ml
// fp32 scratch of the sizes qa_decode_attn_plan gives for smax = pps * ps.
// score_scale = sm_scale * log2(e). G = Hq / Hkv at most 16, ps a multiple
// of 16 up to 256.
extern "C" int qa_paged_decode(const void* q, const void* k, const void* v, const void* k_scale,
                               const void* v_scale, const void* lengths, const void* table,
                               void* out, void* part_acc, void* part_ml, int B, int Hq, int Hkv,
                               int P, int ps, int pps, int D, int kv_code, float score_scale,
                               void* stream) {
  using namespace qa::dattn;
  if (B == 0) return 0;
  const bool q8 = kv_code == qa::kI8;
  if (Hkv <= 0 || Hq % Hkv != 0 || Hq / Hkv > kMaxQRows || ps <= 0 || ps % kBox != 0 ||
      ps > 256 || pps <= 0 || P <= 0 || (!q8 && kv_code != qa::kBF16) ||
      q8 != (k_scale != nullptr && v_scale != nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Plan pl;
  cudaError_t err = plan(q8 ? 1 : 2, B, Hq, Hkv, D, pps * ps, &pl);
  if (err != cudaSuccess) return static_cast<int>(err);
  Params p = {};
  p.q = static_cast<const __nv_bfloat16*>(q);
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
  p.smax = pps * ps;
  p.P = P;
  p.ps = ps;
  p.pps = pps;
  p.score_scale = score_scale;
  const int rows = Hkv * P * ps;
  auto* o = static_cast<__nv_bfloat16*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = q8 ? run_elem_scale(pl, p, k, v, rows, o, s) : run_plain16(pl, p, k, v, rows, o, s);
  return static_cast<int>(err);
}
