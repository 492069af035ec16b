// K10's e4m3 instantiations of the decode-attention core
// (csrc/decode_attn.cuh), in a source of its own so that nvcc builds it
// beside the others: e4m3 codes times their token scales rounded to bf16
// (kElemScale).
#include "decode_attn.cuh"

namespace qa {
namespace dattn {

cudaError_t run_k10_e4m3(const Plan& pl, const Params& p, const void* k, const void* v, int rows,
                         __nv_bfloat16* out, cudaStream_t stream) {
  return run<kElemScale, kKindF8>(pl, p, k, v, rows, out, stream);
}

}  // namespace dattn
}  // namespace qa
