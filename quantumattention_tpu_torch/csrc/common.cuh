// Shared helpers of the hand-written kernels: element loads and stores for
// the dtype codes of ops/_native.py (0 bf16, 1 fp16, 2 e4m3, 3 int8).
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>

namespace qa {

// -0.7 * FLT_MAX: the JAX package's MASK_VALUE (ops/flash.py:52). A masked
// logit flushes exp2 to 0 without the NaN of (-inf) - (-inf).
constexpr float kMaskValue = -0.7f * 3.402823466e38f;

enum ElemCode { kBF16 = 0, kF16 = 1, kE4M3 = 2, kI8 = 3 };

// One element as float. e4m3 and int8 embed exactly in bf16 and float;
// fp16 is exact in float.
__device__ __forceinline__ float load_elem(const void* p, int code, size_t i) {
  switch (code) {
    case kBF16:
      return __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]);
    case kF16:
      return __half2float(static_cast<const __half*>(p)[i]);
    case kE4M3:
      return static_cast<float>(static_cast<const __nv_fp8_e4m3*>(p)[i]);
    default:
      return static_cast<float>(static_cast<const signed char*>(p)[i]);
  }
}

// Output stores: fp16 or bf16 (every other code stores bf16).
__device__ __forceinline__ void store_elem(void* p, int code, size_t i, float x) {
  if (code == kF16) {
    static_cast<__half*>(p)[i] = __float2half_rn(x);
  } else {
    static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16_rn(x);
  }
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

}  // namespace qa
