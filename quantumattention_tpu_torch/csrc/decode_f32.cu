// The fp32 instantiations of the decode-attention core
// (csrc/decode_attn.cuh), shared by K4 and K10 and in a source of their own
// so that nvcc builds them beside the others: fp32 rows rounded to bf16 in
// registers for the bf16 products (kPlain16: no scales).
#include "decode_attn.cuh"

namespace qa {
namespace dattn {

cudaError_t run_f32(const Plan& pl, const Params& p, const void* k, const void* v, int rows,
                    __nv_bfloat16* out, cudaStream_t stream) {
  return run<kPlain16, kKindF32>(pl, p, k, v, rows, out, stream);
}

}  // namespace dattn
}  // namespace qa
