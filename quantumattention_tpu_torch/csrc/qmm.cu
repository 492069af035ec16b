// The float32 rows of K5, K6 and K7: weight-only quantized matrix products
// (w8a16, w4a16) over float32 activations, sm_90a.
//
// Replaces, for float32 activations, the Pallas kernels of
// quantumattention_tpu/ops/qmm.py: K5 _qmm_kernel (qmm.py:49), K6
// _qmm_kernel_ms (qmm.py:70, K5's math over disjoint K ranges, summed in
// order) and K7 _qmm4_kernel (qmm.py:118). Every bf16 product of the three
// runs on the register-A wgmma kernel of csrc/qgemm.cu. Numerics as in JAX:
// an int8 code becomes a float exactly, products sum in fp32, the sum is
// scaled per column once; an int4 nibble times its fp32 group scale is
// kept unrounded (float32 rows), with no epilogue scale. The output is
// float32, as JAX returns x's type.
//
// Off the main path (models run bf16), so simple and right: a thread owns
// one column and eight rows, fp32 FMAs on the CUDA cores over its K range,
// the x tile in shared memory. Where the output tiles are fewer than the
// SMs, gridDim.z splits the K range (qa_qmm_splits) and reduce_kernel adds
// the fp32 partials in split order, then scales, so the result is
// deterministic. What bounds it: the FMA rate (2 operations an element of
// x and w, fp32), far below the tensor cores.
#include <algorithm>

#include "common.cuh"

namespace {

constexpr int kBN = 128;  // columns per CTA
constexpr int kReduceThreads = 256;

// out[m][n] = sum_z partial[z][m][n] * (scale ? scale[n] : 1), the splits
// added in order. N % 4 == 0.
__global__ void __launch_bounds__(kReduceThreads)
reduce_kernel(const float* __restrict__ partial, int splits, const float* __restrict__ scale,
              float* __restrict__ out, int M, int N) {
  const size_t n4 = static_cast<size_t>(M) * N / 4;
  const float4* p4 = reinterpret_cast<const float4*>(partial);
  for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x; i < n4;
       i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    float4 a = p4[i];
    for (int z = 1; z < splits; ++z) {
      const float4 b = p4[z * n4 + i];
      a.x += b.x; a.y += b.y; a.z += b.z; a.w += b.w;
    }
    if (scale != nullptr) {
      const int col = static_cast<int>((i * 4) % N);
      a.x *= scale[col]; a.y *= scale[col + 1]; a.z *= scale[col + 2]; a.w *= scale[col + 3];
    }
    reinterpret_cast<float4*>(out)[i] = a;
  }
}

cudaError_t launch_reduce(const float* partial, int splits, const float* scale, float* out, int M,
                          int N, cudaStream_t stream) {
  const size_t n4 = static_cast<size_t>(M) * N / 4;
  const int blocks = static_cast<int>(std::min<size_t>(
      (n4 + kReduceThreads - 1) / kReduceThreads, static_cast<size_t>(qa::num_sms()) * 8));
  reduce_kernel<<<blocks, kReduceThreads, 0, stream>>>(partial, splits, scale, out, M, N);
  return cudaGetLastError();
}

// fp32 rows: rows m0 .. m0 + 8 of x times column n of w over K range
// [z * per, min((z + 1) * per, K)) (per % 64 == 0), fp32 FMAs; writes
// dst[z][m][n], times s[n] when `scaled` (int8 without a split).
constexpr int kF32Rows = 8;
constexpr int kF32K = 64;

template <bool INT4>
__global__ void __launch_bounds__(kBN)
qgemm_f32_kernel(const float* __restrict__ x, const unsigned char* __restrict__ w,
                 const float* __restrict__ s, float* __restrict__ dst, int M, int N, int K, int per,
                 int scaled) {
  __shared__ float xs[kF32Rows][kF32K];
  const int n = blockIdx.x * kBN + threadIdx.x, m0 = blockIdx.y * kF32Rows;
  const int k_begin = blockIdx.z * per, k_end = min(K, k_begin + per);
  float acc[kF32Rows];
#pragma unroll
  for (int r = 0; r < kF32Rows; ++r) acc[r] = 0.f;
  for (int k0 = k_begin; k0 < k_end; k0 += kF32K) {
    for (int i = threadIdx.x; i < kF32Rows * kF32K; i += kBN) {
      const int r = i / kF32K, kk = i % kF32K;
      xs[r][kk] = m0 + r < M ? x[static_cast<size_t>(m0 + r) * K + k0 + kk] : 0.f;
    }
    __syncthreads();
    for (int kk = 0; kk < kF32K; ++kk) {
      const int k = k0 + kk;
      float wv;
      if (INT4) {  // packed row 128 (k / 256) + k % 128; high nibble in the block's upper half
        const unsigned char b = w[static_cast<size_t>((k >> 8) * 128 + (k & 127)) * N + n];
        const float nibble = (k & 255) < 128 ? qa::int4_lo(b) : qa::int4_hi(b);
        wv = nibble * s[static_cast<size_t>(k >> 7) * N + n];
      } else {
        wv = static_cast<float>(static_cast<signed char>(w[static_cast<size_t>(k) * N + n]));
      }
#pragma unroll
      for (int r = 0; r < kF32Rows; ++r) acc[r] = fmaf(xs[r][kk], wv, acc[r]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int r = 0; r < kF32Rows; ++r) {
    const int m = m0 + r;
    if (m < M) {
      dst[(static_cast<size_t>(blockIdx.z) * M + m) * N + n] = scaled ? acc[r] * s[n] : acc[r];
    }
  }
}

}  // namespace

// The K ranges of a float32 int8 product: `requested` (an explicit
// n_streams) or, for 0, the card's rule: split when the output tiles (128
// columns by 8 rows) are fewer than the SMs, into about four CTAs an SM.
// No range is left empty.
extern "C" int qa_qmm_splits(int M, int N, int K, int requested) {
  const int iters = K / kF32K;
  int want = requested;
  if (want <= 0) {
    const int tiles = (N / kBN) * ((M + kF32Rows - 1) / kF32Rows);
    const int sms = qa::num_sms();
    want = tiles >= sms ? 1 : (4 * sms + tiles - 1) / tiles;
  }
  want = std::max(1, std::min(want, iters));
  const int per = (iters + want - 1) / want;
  return (iters + per - 1) / per;
}

// fp32 rows: x (M, K) fp32; w int8 (K, N) with scale (N,) fp32, or packed
// int4 (K/2, N) with scale (K/128, N); out (M, N) fp32; partial (splits, M,
// N) fp32 scratch when splits > 1 (int8 only), splits from qa_qmm_splits.
extern "C" int qa_qmm_f32(const void* x, const void* w, const void* scale, void* out, void* partial,
                          int M, int N, int K, int int4, int splits, void* stream) {
  if (M == 0) return 0;
  if (K % (int4 ? 256 : 128) != 0 || N % kBN != 0 || splits < 1 || (int4 && splits != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* s = static_cast<const float*>(scale);
  const int iters = K / kF32K, per = (iters + splits - 1) / splits * kF32K;
  float* dst = static_cast<float*>(splits > 1 ? partial : out);
  const dim3 grid(N / kBN, (M + kF32Rows - 1) / kF32Rows, splits);
  const auto* xf = static_cast<const float*>(x);
  const auto* wq = static_cast<const unsigned char*>(w);
  if (int4) {
    qgemm_f32_kernel<true><<<grid, kBN, 0, st>>>(xf, wq, s, dst, M, N, K, per, 0);
  } else {
    qgemm_f32_kernel<false><<<grid, kBN, 0, st>>>(xf, wq, s, dst, M, N, K, per, splits == 1);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  return static_cast<int>(launch_reduce(static_cast<const float*>(partial), splits, s,
                                        static_cast<float*>(out), M, N, st));
}
