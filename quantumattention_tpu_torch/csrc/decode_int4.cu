// K4's int4 instantiations of the decode-attention core
// (csrc/decode_attn.cuh), in a source of its own so that nvcc builds it
// beside the others: int4 codes packed along the head dim, converted exactly,
// the token scales on the scores.
#include "decode_attn.cuh"

namespace qa {
namespace dattn {

cudaError_t run_k4_int4(const Plan& pl, const Params& p, const void* k, const void* v, int rows,
                        __nv_bfloat16* out, cudaStream_t stream) {
  return run<kScoreScale, kKindI4D>(pl, p, k, v, rows, out, stream);
}

}  // namespace dattn
}  // namespace qa
