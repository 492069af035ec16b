// K10's int4 instantiations of the decode-attention core
// (csrc/decode_attn.cuh), in a source of its own so that nvcc builds it
// beside the others: token-packed int4 pages, each nibble times its token
// scale rounded to bf16 (kElemScale).
#include "decode_attn.cuh"

namespace qa {
namespace dattn {

cudaError_t run_k10_int4(const Plan& pl, const Params& p, const void* k, const void* v, int rows,
                         __nv_bfloat16* out, cudaStream_t stream) {
  return run<kElemScale, kKindI4T>(pl, p, k, v, rows, out, stream);
}

}  // namespace dattn
}  // namespace qa
