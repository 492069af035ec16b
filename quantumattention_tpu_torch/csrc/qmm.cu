// K6 and the fp32 rows of K5-K7: weight-only quantized matrix products
// (w8a16, w4a16), sm_90a.
//
// Replaces the Pallas kernels of quantumattention_tpu/ops/qmm.py:
//   K6 _qmm_kernel_ms (qmm.py:70): K5's math over disjoint K ranges;
//   K5 _qmm_kernel (qmm.py:49) and K7 _qmm4_kernel (qmm.py:118) for
//      float32 activations (qgemm_f32_kernel). K5 and K7 over bf16 rows run
//      on the register-A wgmma kernel of csrc/qgemm.cu.
// Numerics as in JAX: an int8 code becomes x's type exactly, products sum
// in fp32, the sum is scaled per column once and cast once; an int4 nibble
// times its fp32 group scale is rounded to x's type before the product
// (dequant4_tile, qmm.py:99-115; fp32 rows keep it unrounded), with no
// epilogue scale.
//
// K6 (qgemm_kernel, int8, split): a decode product with few column tiles
// (wo, N = 4096: 32 tiles of 128) would leave most of the 132 SMs idle.
// When the output tiles are fewer than the SMs, gridDim.z splits the K
// range so that about four CTAs an SM stream weights; each CTA writes fp32
// partial sums and reduce_kernel adds them in a fixed order, then scales
// and casts, so the result is deterministic. What bounds it: bytes (2*M
// operations a weight byte at decode rows). A CTA computes BM rows (16 up
// to 16 rows, else 64) by 128 columns with four warps of mma.sync
// m16n8k16; a 4-stage cp.async ring stages 64 weight rows per stage raw
// into shared memory next to the matching bf16 x tile, and the B fragments
// are converted from single bytes as they are built (byte loads that cap
// it below the memory rate; csrc/qgemm.cu converts from 32-bit loads).
//
// fp32 rows (qgemm_f32_kernel): off the main path (models run bf16), so
// simple and right: a thread owns one column and eight rows, fp32 FMAs on
// the CUDA cores over its K range, the x tile in shared memory; K6's split
// adds fp32 partials in split order as above.
#include <algorithm>

#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kBN = 128;            // columns per CTA
constexpr int kBK = 64;             // unpacked weight rows per stage
constexpr int kStages = 4;
constexpr int kXStride = kBK + 8;   // bf16 per x row in shared memory (bank spread)
constexpr int kWStride = kBN + 16;  // bytes per weight row in shared memory
constexpr int kReduceThreads = 256;
constexpr int kMaxDevices = 64;

__host__ __device__ constexpr int stage_bytes(int bm) { return bm * kXStride * 2 + kBK * kWStride; }

int block_m(int M) { return M <= 16 ? 16 : 64; }

// A CTA: rows m0 .. m0 + BM of x times columns n0 .. n0 + 128 of the int8
// w, over K iterations [z * per, min((z + 1) * per, K / 64)). Writes fp32
// partial sums partial[z][M][N], or (partial == nullptr) bf16 out = sum *
// s[col].
template <int BM>
__global__ void __launch_bounds__(kThreads)
qgemm_kernel(const __nv_bfloat16* __restrict__ x, const signed char* __restrict__ w,
             const float* __restrict__ s, float* __restrict__ partial,
             __nv_bfloat16* __restrict__ out, int M, int N, int K, int per) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kMT = BM / 16;
  constexpr int kStage = stage_bytes(BM);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * kBN;
  const int it0 = blockIdx.z * per;
  const int n_it = min(K / kBK, it0 + per) - it0;

  auto load_stage = [&](int buf, int it) {
    unsigned char* base = smem + buf * kStage;
    __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(base);
    unsigned char* ws = base + BM * kXStride * 2;
    // x: BM rows x 64 columns, eight 16-byte chunks a row.
    for (int i = tid; i < BM * 8; i += kThreads) {
      const int r = i >> 3, c = (i & 7) * 8, col = it * kBK + c;
      const bool ok = m0 + r < M;
      const __nv_bfloat16* src = ok ? x + static_cast<size_t>(m0 + r) * K + col : x;
      qa::cp_async16(xs + r * kXStride + c, src, ok);
    }
    // Weights: 64 rows x 128 bytes.
    const size_t row0 = static_cast<size_t>(it) * kBK;
    for (int i = tid; i < kBK * 8; i += kThreads) {
      const int r = i >> 3, c = (i & 7) * 16;
      qa::cp_async16(ws + r * kWStride + c, w + (row0 + r) * N + n0 + c, true);
    }
  };

  float acc[kMT][4][4];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0.f;

#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < n_it) load_stage(st, it0 + st);
    qa::cp_async_commit();
  }

  for (int i = 0; i < n_it; ++i) {
    qa::cp_async_wait<kStages - 2>();
    __syncthreads();  // stage i landed; stage i - 1's buffer is free
    const int nxt = i + kStages - 1;
    if (nxt < n_it) load_stage(nxt % kStages, it0 + nxt);
    qa::cp_async_commit();

    const unsigned char* base = smem + (i % kStages) * kStage;
    const __nv_bfloat16* xs = reinterpret_cast<const __nv_bfloat16*>(base);
    const signed char* ws = reinterpret_cast<const signed char*>(base + BM * kXStride * 2);
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      uint32_t a[kMT][4];
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) qa::load_a_frag(a[mt], xs + mt * 16 * kXStride, kXStride, kk, gq, tq);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = warp * 32 + j * 8 + gq;
        const signed char* p = ws + (kk * 16 + 2 * tq) * kWStride + col;
        const uint32_t b0 = qa::pack_bf16(p[0], p[kWStride]);
        const uint32_t b1 = qa::pack_bf16(p[8 * kWStride], p[9 * kWStride]);
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) qa::mma_bf16(acc[mt][j], a[mt], b0, b1);
      }
    }
  }
  qa::cp_async_wait<0>();

#pragma unroll
  for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + warp * 32 + j * 8 + 2 * tq;
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int row = m0 + mt * 16 + gq + 8 * hf;
        if (row >= M) continue;
        float v0 = acc[mt][j][2 * hf], v1 = acc[mt][j][2 * hf + 1];
        if (partial != nullptr) {
          *reinterpret_cast<float2*>(partial + (static_cast<size_t>(blockIdx.z) * M + row) * N + col) =
              make_float2(v0, v1);
        } else {
          v0 *= s[col];
          v1 *= s[col + 1];
          *reinterpret_cast<__nv_bfloat162*>(out + static_cast<size_t>(row) * N + col) =
              __floats2bfloat162_rn(v0, v1);
        }
      }
    }
  }
}

__device__ __forceinline__ void store4(__nv_bfloat16* out, size_t i, float4 a) {
  __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(out) + 2 * i;
  o[0] = __floats2bfloat162_rn(a.x, a.y);
  o[1] = __floats2bfloat162_rn(a.z, a.w);
}

__device__ __forceinline__ void store4(float* out, size_t i, float4 a) {
  reinterpret_cast<float4*>(out)[i] = a;
}

// out[m][n] = T(sum_z partial[z][m][n] * (scale ? scale[n] : 1)), the
// splits added in order. N % 4 == 0.
template <typename T>
__global__ void __launch_bounds__(kReduceThreads)
reduce_kernel(const float* __restrict__ partial, int splits, const float* __restrict__ scale,
              T* __restrict__ out, int M, int N) {
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
    store4(out, i, a);
  }
}

template <typename T>
cudaError_t launch_reduce(const float* partial, int splits, const float* scale, T* out, int M,
                          int N, cudaStream_t stream) {
  const size_t n4 = static_cast<size_t>(M) * N / 4;
  const int blocks = static_cast<int>(std::min<size_t>(
      (n4 + kReduceThreads - 1) / kReduceThreads, static_cast<size_t>(qa::num_sms()) * 8));
  reduce_kernel<T><<<blocks, kReduceThreads, 0, stream>>>(partial, splits, scale, out, M, N);
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

template <int BM>
cudaError_t launch(const __nv_bfloat16* x, const signed char* w, const float* s, int M, int N, int K,
                   int splits, float* partial, __nv_bfloat16* out, cudaStream_t stream) {
  constexpr int smem = kStages * stage_bytes(BM);
  // Raise the dynamic shared-memory limit once per device (not on every
  // launch: a launch may be captured into a CUDA graph).
  static bool configured[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!configured[dev]) {
    err = cudaFuncSetAttribute(qgemm_kernel<BM>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    configured[dev] = true;
  }
  const int iters = K / kBK;
  const int per = (iters + splits - 1) / splits;
  const dim3 grid((M + BM - 1) / BM, N / kBN, splits);
  qgemm_kernel<BM><<<grid, kThreads, smem, stream>>>(x, w, s, partial, out, M, N, K, per);
  return cudaGetLastError();
}

cudaError_t launch_any(const __nv_bfloat16* x, const signed char* w, const float* s, int M, int N,
                       int K, int splits, float* partial, __nv_bfloat16* out, cudaStream_t stream) {
  if (M == 0) return cudaSuccess;
  if (K % kBK != 0 || N % kBN != 0 || splits < 1) return cudaErrorInvalidValue;
  return block_m(M) == 16 ? launch<16>(x, w, s, M, N, K, splits, partial, out, stream)
                          : launch<64>(x, w, s, M, N, K, splits, partial, out, stream);
}

}  // namespace

namespace qa {

int qgemm_splits(int M, int N, int K, int requested) {
  const int iters = K / kBK;
  int want = requested;
  if (want <= 0) {
    const int tiles = (N / kBN) * ((M + block_m(M) - 1) / block_m(M));
    const int sms = num_sms();
    want = tiles >= sms ? 1 : (4 * sms + tiles - 1) / tiles;
  }
  want = std::max(1, std::min(want, iters));
  const int per = (iters + want - 1) / want;
  return (iters + per - 1) / per;
}

cudaError_t qgemm_out(const __nv_bfloat16* x, const signed char* w, const float* s, int M, int N,
                      int K, int splits, float* partial, __nv_bfloat16* out, cudaStream_t stream) {
  if (splits == 1) return launch_any(x, w, s, M, N, K, 1, nullptr, out, stream);
  cudaError_t err = launch_any(x, w, s, M, N, K, splits, partial, nullptr, stream);
  if (err != cudaSuccess || M == 0) return err;
  return launch_reduce(partial, splits, s, out, M, N, stream);
}

}  // namespace qa

extern "C" int qa_qmm_splits(int M, int N, int K, int requested) {
  return qa::qgemm_splits(M, N, K, requested);
}

// x (M, K) bf16; w int8 (K, N) with scale (N,) fp32; out (M, N) bf16;
// partial (splits, M, N) fp32 scratch when splits > 1 (null otherwise),
// splits from qa_qmm_splits.
extern "C" int qa_qmm(const void* x, const void* w, const void* scale, void* out, void* partial,
                      int M, int N, int K, int splits, void* stream) {
  return static_cast<int>(qa::qgemm_out(static_cast<const __nv_bfloat16*>(x),
                                        static_cast<const signed char*>(w),
                                        static_cast<const float*>(scale), M, N, K, splits,
                                        static_cast<float*>(partial),
                                        static_cast<__nv_bfloat16*>(out),
                                        static_cast<cudaStream_t>(stream)));
}

// fp32 rows: x (M, K) fp32; w and scale as qa_qmm; out (M, N) fp32;
// partial (splits, M, N) fp32 scratch when splits > 1 (int8 only).
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
