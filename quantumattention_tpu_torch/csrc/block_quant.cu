// Per-block dynamic e4m3 quantization: the pre-pass of K1's per-block mode.
//
// Replaces the tile quantizer inside the Pallas kernel
// quantumattention_tpu/ops/flash.py::_flash_kernel (`_quantize_tile`,
// flash.py:227-238, applied to the Q tile at flash.py:241-253 and to each K
// tile at flash.py:290-318). For every (batch, head, block of `block_rows`
// rows counted from row 0; rows past S count as zeros):
//   s    = max(amax(|x|) / 448, 1e-12)        (fp32)
//   code = e4m3(x * (1 / s))                  (one IEEE reciprocal, one
//                                              product, one RN cast)
// which is ops/quant.quantize_block_wise, bit for bit: the max does not
// depend on the order it is taken in, and the library is built without
// fast-math, so 1.0f / s is IEEE-rounded.
//
// Outputs: the codes (B, H, S, W) at K1's row width W (D, or D + 8 zero
// columns where D % 16 == 8: a tensor map's row stride is a multiple of 16
// bytes), the block scales (B, H, ceil(S / block_rows)) and every row's
// scale (B, H, S), which K1 reads in its token-wise mode.
//
// What bounds it on the H100: bytes. A pass reads 2 bytes (bf16/fp16) and
// writes 1 byte an element. The block's amax must be known before its
// first code is written, so two kernels run: the first reads the input once
// and writes one partial amax for each chunk of 64 rows; the second merges
// its block's partials (a max over a fixed list: deterministic), reads the
// chunk again and writes the codes and scales. A block of 1024 rows at D =
// 128 spreads over 16 CTAs, so B = 1 with few heads still fills the SMs.
// The second read goes to memory when the tensor exceeds the 50 MB L2, so a
// call moves about 5 bytes an element against the bound's 3. Fusing the
// quantization into K1's Q load and K tiles removes the pass (ROADMAP
// queue 2).
#include "common.cuh"

namespace {

constexpr int kChunk = 64;     // rows a CTA
constexpr int kThreads = 256;  // 8 warps

template <int CODE>
__device__ __forceinline__ void load8(const void* x, size_t i, float (&f)[8]) {
  if constexpr (CODE == qa::kF32) {
    const float4 a = *reinterpret_cast<const float4*>(static_cast<const float*>(x) + i);
    const float4 b = *reinterpret_cast<const float4*>(static_cast<const float*>(x) + i + 4);
    f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
    f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
  } else if constexpr (CODE == qa::kF16) {
    const uint4 u = *reinterpret_cast<const uint4*>(static_cast<const __half*>(x) + i);
    const __half* h = reinterpret_cast<const __half*>(&u);
#pragma unroll
    for (int e = 0; e < 8; ++e) f[e] = __half2float(h[e]);
  } else {
    const uint4 u = *reinterpret_cast<const uint4*>(static_cast<const __nv_bfloat16*>(x) + i);
    const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&u);
#pragma unroll
    for (int e = 0; e < 8; ++e) f[e] = __bfloat162float(h[e]);
  }
}

// The rows [r0, r1) of chunk c of block blk (empty past S).
__device__ __forceinline__ void chunk_rows(int blk, int c, int block_rows, int S, int& r0,
                                           int& r1) {
  r0 = blk * block_rows + c * kChunk;
  r1 = min(min(r0 + kChunk, (blk + 1) * block_rows), S);
}

// Grid (nblk * cpb, B * H): one CTA a chunk; partial[(bh * nblk + blk) * cpb
// + c] = the chunk's amax (0 for an empty chunk).
template <int CODE>
__global__ void __launch_bounds__(kThreads)
block_amax_kernel(const void* __restrict__ x, float* __restrict__ partial, int S, int D,
                  int block_rows, int nblk, int cpb) {
  const int bh = blockIdx.y, blk = blockIdx.x / cpb, c = blockIdx.x % cpb;
  int r0, r1;
  chunk_rows(blk, c, block_rows, S, r0, r1);
  const int groups = D / 8;
  const size_t base = static_cast<size_t>(bh) * S * D;
  float m = 0.f;
  for (int idx = threadIdx.x; idx < (r1 - r0) * groups; idx += kThreads) {
    float f[8];
    load8<CODE>(x, base + static_cast<size_t>(r0 + idx / groups) * D + idx % groups * 8, f);
#pragma unroll
    for (int e = 0; e < 8; ++e) m = fmaxf(m, fabsf(f[e]));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  __shared__ float warp_max[kThreads / 32];
  if (threadIdx.x % 32 == 0) warp_max[threadIdx.x / 32] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
#pragma unroll
    for (int w = 1; w < kThreads / 32; ++w) m = fmaxf(m, warp_max[w]);
    partial[(static_cast<size_t>(bh) * nblk + blk) * cpb + c] = m;
  }
}

// The same grid: the block's scale from its partials, then the chunk's
// codes (zero columns from D to W) and row scales; chunk 0 also stores the
// block scale.
template <int CODE>
__global__ void __launch_bounds__(kThreads)
block_cast_kernel(const void* __restrict__ x, const float* __restrict__ partial,
                  unsigned char* __restrict__ codes, float* __restrict__ block_scale,
                  float* __restrict__ row_scale, int S, int D, int W, int block_rows, int nblk,
                  int cpb) {
  const int bh = blockIdx.y, blk = blockIdx.x / cpb, c = blockIdx.x % cpb;
  int r0, r1;
  chunk_rows(blk, c, block_rows, S, r0, r1);
  const float* p = partial + (static_cast<size_t>(bh) * nblk + blk) * cpb;
  float amax = 0.f;
  for (int i = 0; i < cpb; ++i) amax = fmaxf(amax, p[i]);
  const float s = fmaxf(amax / 448.0f, 1e-12f);
  const float inv = 1.0f / s;
  if (c == 0 && threadIdx.x == 0) block_scale[static_cast<size_t>(bh) * nblk + blk] = s;
  for (int r = r0 + threadIdx.x; r < r1; r += kThreads) {
    row_scale[static_cast<size_t>(bh) * S + r] = s;
  }
  const int groups = W / 8;
  for (int idx = threadIdx.x; idx < (r1 - r0) * groups; idx += kThreads) {
    const int r = r0 + idx / groups, col = idx % groups * 8;
    uint2 out = make_uint2(0u, 0u);
    if (col < D) {
      float f[8];
      load8<CODE>(x, (static_cast<size_t>(bh) * S + r) * D + col, f);
      uint32_t b[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) b[e] = __nv_cvt_float_to_fp8(f[e] * inv, __NV_SATFINITE, __NV_E4M3);
      out.x = b[0] | (b[1] << 8) | (b[2] << 16) | (b[3] << 24);
      out.y = b[4] | (b[5] << 8) | (b[6] << 16) | (b[7] << 24);
    }
    *reinterpret_cast<uint2*>(codes + (static_cast<size_t>(bh) * S + r) * W + col) = out;
  }
}

template <int CODE>
int launch(const void* x, float* partial, unsigned char* codes, float* block_scale,
           float* row_scale, int BH, int S, int D, int W, int block_rows, cudaStream_t stream) {
  const int nblk = (S + block_rows - 1) / block_rows;
  const int cpb = (block_rows + kChunk - 1) / kChunk;
  const dim3 grid(nblk * cpb, BH);
  block_amax_kernel<CODE><<<grid, kThreads, 0, stream>>>(x, partial, S, D, block_rows, nblk, cpb);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  block_cast_kernel<CODE><<<grid, kThreads, 0, stream>>>(x, partial, codes, block_scale, row_scale,
                                                         S, D, W, block_rows, nblk, cpb);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Partial-amax entries qa_block_quant needs as scratch.
extern "C" int qa_block_quant_partials(int BH, int S, int block_rows) {
  if (BH <= 0 || S <= 0 || block_rows <= 0) return 0;
  return BH * ((S + block_rows - 1) / block_rows) * ((block_rows + kChunk - 1) / kChunk);
}

// x: (B * H, S, D) contiguous bf16 / fp16 / fp32 (code 0 / 1 / 4), 16-byte
// aligned, D a multiple of 8; codes (B * H, S, W) e4m3 with W >= D a
// multiple of 16; block_scale (B * H, ceil(S / block_rows)) and row_scale
// (B * H, S) fp32; partial: qa_block_quant_partials(BH, S, block_rows)
// floats of scratch.
extern "C" int qa_block_quant(const void* x, void* partial, void* codes, void* block_scale,
                              void* row_scale, int BH, int S, int D, int W, int code,
                              int block_rows, void* stream) {
  if (BH == 0 || S == 0) return 0;
  if (BH < 0 || S < 0 || D <= 0 || D % 8 != 0 || W < D || W % 16 != 0 || block_rows <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto* p = static_cast<float*>(partial);
  auto* c = static_cast<unsigned char*>(codes);
  auto* bs = static_cast<float*>(block_scale);
  auto* rs = static_cast<float*>(row_scale);
  auto st = static_cast<cudaStream_t>(stream);
  switch (code) {
    case qa::kBF16:
      return launch<qa::kBF16>(x, p, c, bs, rs, BH, S, D, W, block_rows, st);
    case qa::kF16:
      return launch<qa::kF16>(x, p, c, bs, rs, BH, S, D, W, block_rows, st);
    case qa::kF32:
      return launch<qa::kF32>(x, p, c, bs, rs, BH, S, D, W, block_rows, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
