// K5, K6, K7: weight-only quantized matrix products (w8a16, w4a16), sm_90a.
//
// Replaces the Pallas kernels of quantumattention_tpu/ops/qmm.py:
//   K5 _qmm_kernel (qmm.py:49; host quantized_matmul, :191):
//      out = (x @ w.astype(x.dtype)) * s, int8 w (K, N), fp32 column scales;
//   K6 _qmm_kernel_ms (qmm.py:70): K5's math over disjoint K ranges;
//   K7 _qmm4_kernel (qmm.py:118; host quantized_matmul4, :323; unpack
//      dequant4_tile, :99): out = x @ dequantize_int4(w4, s).
// Numerics as in JAX: an int8 code becomes bf16 exactly, products sum in
// fp32, the sum is scaled per column once and cast to bf16; an int4 nibble
// times its fp32 group scale is rounded to bf16 before the product, with no
// epilogue scale.
//
// What bounds it on the H100. Decode (M of a few rows): bytes. A product
// does 2*M flops per weight byte (4*M per int4 byte), far below the card's
// ~295 flops/byte balance point, so the kernel must stream each weight byte
// from device memory once, in 16-byte coalesced loads, with enough bytes in
// flight to cover latency. Prefill (M in the thousands): operations, so
// the products run on the tensor cores.
//
// Design. One tiled kernel serves both regimes: a CTA computes BM rows by
// 128 columns (BM = 16 for M <= 16, else 64; four warps of 32 columns). A
// 4-stage cp.async ring stages 64 unpacked weight rows per stage (64 int8
// rows or 32 packed int4 rows) raw into shared memory, 16 bytes a thread
// along N, next to the matching bf16 x tile; the weight bytes are converted
// to bf16 as each mma.sync m16n8k16 B fragment is built (rows 2t, 2t+1,
// 2t+8, 2t+9 of column g), so shared memory holds 1 or 0.5 bytes per
// weight. Row tiles run along gridDim.x, so the CTAs resident at once share
// weight tiles through L2 in the prefill regime. An int4 stage of 32 packed
// rows inside one 256-row packing block covers original rows [256g + r0,
// +32) (low nibbles) and [256g + 128 + r0, +32) (high nibbles): the x tile
// loads those two column ranges, and each half takes one group scale.
//
// K6, the split-K schedule: a decode product with few column tiles (wo,
// N = 4096: 32 tiles) would leave most of the 132 SMs idle. When the
// output tiles are fewer than the SMs, gridDim.z splits the K range so
// that about four CTAs per SM stream weights; each CTA writes fp32 partial
// sums and a second kernel adds them in a fixed order, then scales and
// casts, so the result is deterministic. TMA, wgmma and int8/fp8
// tensor-core operands are later work.
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

__host__ __device__ constexpr int stage_bytes(int bm, bool int4) {
  return bm * kXStride * 2 + (int4 ? kBK / 2 : kBK) * kWStride;
}

int block_m(int M) { return M <= 16 ? 16 : 64; }

// A CTA: rows m0 .. m0 + BM of x times columns n0 .. n0 + 128 of w, over
// K iterations [z * per, min((z + 1) * per, K / 64)). Writes fp32 partial
// sums partial[z][M][N], or (partial == nullptr) bf16 out = sum * s[col]
// (int8) or sum (int4).
template <int BM, bool INT4>
__global__ void __launch_bounds__(kThreads)
qgemm_kernel(const __nv_bfloat16* __restrict__ x, const unsigned char* __restrict__ w,
             const float* __restrict__ s, float* __restrict__ partial,
             __nv_bfloat16* __restrict__ out, int M, int N, int K, int per) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kMT = BM / 16;
  constexpr int kWRows = INT4 ? kBK / 2 : kBK;
  constexpr int kStage = stage_bytes(BM, INT4);
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
    int col0 = it * kBK;
    if (INT4) {
      const int p0 = it * kWRows;  // first packed row of the stage
      col0 = (p0 / 128) * 256 + p0 % 128;
    }
    for (int i = tid; i < BM * 8; i += kThreads) {
      const int r = i >> 3, c = (i & 7) * 8;
      const int col = col0 + ((INT4 && c >= 32) ? 128 + c - 32 : c);
      const bool ok = m0 + r < M;
      const __nv_bfloat16* src = ok ? x + static_cast<size_t>(m0 + r) * K + col : x;
      qa::cp_async16(xs + r * kXStride + c, src, ok);
    }
    // Weights: kWRows rows x 128 bytes.
    const size_t row0 = static_cast<size_t>(it) * kWRows;
    for (int i = tid; i < kWRows * 8; i += kThreads) {
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
    const unsigned char* ws = base + BM * kXStride * 2;
    float s_lo[4], s_hi[4];
    if (INT4) {
      const size_t grp = static_cast<size_t>((it0 + i) * kWRows / 128) * 2;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = n0 + warp * 32 + j * 8 + gq;
        s_lo[j] = __ldg(s + grp * N + col);
        s_hi[j] = __ldg(s + (grp + 1) * N + col);
      }
    }
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      uint32_t a[kMT][4];
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) qa::load_a_frag(a[mt], xs + mt * 16 * kXStride, kXStride, kk, gq, tq);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = warp * 32 + j * 8 + gq;
        uint32_t b0, b1;
        if (INT4) {
          const unsigned char* p = ws + ((kk & 1) * 16 + 2 * tq) * kWStride + col;
          if (kk < 2) {
            const float sc = s_lo[j];
            b0 = qa::pack_bf16(qa::int4_lo(p[0]) * sc, qa::int4_lo(p[kWStride]) * sc);
            b1 = qa::pack_bf16(qa::int4_lo(p[8 * kWStride]) * sc, qa::int4_lo(p[9 * kWStride]) * sc);
          } else {
            const float sc = s_hi[j];
            b0 = qa::pack_bf16(qa::int4_hi(p[0]) * sc, qa::int4_hi(p[kWStride]) * sc);
            b1 = qa::pack_bf16(qa::int4_hi(p[8 * kWStride]) * sc, qa::int4_hi(p[9 * kWStride]) * sc);
          }
        } else {
          const signed char* p =
              reinterpret_cast<const signed char*>(ws + (kk * 16 + 2 * tq) * kWStride + col);
          b0 = qa::pack_bf16(p[0], p[kWStride]);
          b1 = qa::pack_bf16(p[8 * kWStride], p[9 * kWStride]);
        }
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
          if (!INT4) {
            v0 *= s[col];
            v1 *= s[col + 1];
          }
          *reinterpret_cast<__nv_bfloat162*>(out + static_cast<size_t>(row) * N + col) =
              __floats2bfloat162_rn(v0, v1);
        }
      }
    }
  }
}

// out[m][n] = bf16(sum_z partial[z][m][n] * (scale ? scale[n] : 1)), the
// splits added in order. N % 4 == 0.
__global__ void __launch_bounds__(kReduceThreads)
reduce_kernel(const float* __restrict__ partial, int splits, const float* __restrict__ scale,
              __nv_bfloat16* __restrict__ out, int M, int N) {
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
    __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(out) + 2 * i;
    o[0] = __floats2bfloat162_rn(a.x, a.y);
    o[1] = __floats2bfloat162_rn(a.z, a.w);
  }
}

template <int BM, bool INT4>
cudaError_t launch(const __nv_bfloat16* x, qa::QMat w, int M, int N, int K, int splits,
                   float* partial, __nv_bfloat16* out, cudaStream_t stream) {
  constexpr int smem = kStages * stage_bytes(BM, INT4);
  // Raise the dynamic shared-memory limit once per device (not on every
  // launch: a launch may be captured into a CUDA graph).
  static bool configured[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!configured[dev]) {
    err = cudaFuncSetAttribute(qgemm_kernel<BM, INT4>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    configured[dev] = true;
  }
  const int iters = K / kBK;
  const int per = (iters + splits - 1) / splits;
  const dim3 grid((M + BM - 1) / BM, N / kBN, splits);
  qgemm_kernel<BM, INT4><<<grid, kThreads, smem, stream>>>(
      x, static_cast<const unsigned char*>(w.q), w.s, partial, out, M, N, K, per);
  return cudaGetLastError();
}

cudaError_t launch_any(const __nv_bfloat16* x, qa::QMat w, int M, int N, int K, int splits,
                       float* partial, __nv_bfloat16* out, cudaStream_t stream) {
  if (M == 0) return cudaSuccess;
  if (K % (w.int4 ? 256 : 128) != 0 || N % kBN != 0 || splits < 1)
    return cudaErrorInvalidValue;
  if (block_m(M) == 16) {
    return w.int4 ? launch<16, true>(x, w, M, N, K, splits, partial, out, stream)
                  : launch<16, false>(x, w, M, N, K, splits, partial, out, stream);
  }
  return w.int4 ? launch<64, true>(x, w, M, N, K, splits, partial, out, stream)
                : launch<64, false>(x, w, M, N, K, splits, partial, out, stream);
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

cudaError_t qgemm_out(const __nv_bfloat16* x, QMat w, int M, int N, int K, int splits,
                      float* partial, __nv_bfloat16* out, cudaStream_t stream) {
  if (splits == 1) return launch_any(x, w, M, N, K, 1, nullptr, out, stream);
  cudaError_t err = launch_any(x, w, M, N, K, splits, partial, nullptr, stream);
  if (err != cudaSuccess || M == 0) return err;
  const size_t n4 = static_cast<size_t>(M) * N / 4;
  const int blocks = static_cast<int>(std::min<size_t>(
      (n4 + kReduceThreads - 1) / kReduceThreads, static_cast<size_t>(num_sms()) * 8));
  reduce_kernel<<<blocks, kReduceThreads, 0, stream>>>(partial, splits, w.int4 ? nullptr : w.s,
                                                       out, M, N);
  return cudaGetLastError();
}

}  // namespace qa

extern "C" int qa_qmm_splits(int M, int N, int K, int requested) {
  return qa::qgemm_splits(M, N, K, requested);
}

// x (M, K) bf16; w int8 (K, N) with scale (N,) fp32, or (int4) packed
// (K/2, N) with scale (K/128, N); out (M, N) bf16; partial (splits, M, N)
// fp32 scratch when splits > 1 (null otherwise), splits from qa_qmm_splits.
extern "C" int qa_qmm(const void* x, const void* w, const void* scale, void* out, void* partial,
                      int M, int N, int K, int int4, int splits, void* stream) {
  const qa::QMat mat{w, static_cast<const float*>(scale), int4};
  return static_cast<int>(qa::qgemm_out(static_cast<const __nv_bfloat16*>(x), mat, M, N, K, splits,
                                        static_cast<float*>(partial),
                                        static_cast<__nv_bfloat16*>(out),
                                        static_cast<cudaStream_t>(stream)));
}
