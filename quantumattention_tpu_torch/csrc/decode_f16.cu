// The fp16 instantiations of the decode-attention core
// (csrc/decode_attn.cuh), shared by K4 and K10 and in a source of their own
// so that nvcc builds them beside the others: fp16 rows in fp16 products, the
// query (exactly) and P rounded to fp16 (kPlain16: no scales).
#include "decode_attn.cuh"

namespace qa {
namespace dattn {

cudaError_t run_f16(const Plan& pl, const Params& p, const void* k, const void* v, int rows,
                    __nv_bfloat16* out, cudaStream_t stream) {
  return run<kPlain16, kKindF16>(pl, p, k, v, rows, out, stream);
}

}  // namespace dattn
}  // namespace qa
