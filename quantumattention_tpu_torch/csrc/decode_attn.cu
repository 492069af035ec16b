// The decode-attention core's merge kernel, its plan as a C entry point,
// and its bf16 instantiations (csrc/decode_attn.cuh; K4 and K10 share them,
// as they share the fp16 and fp32 ones of decode_f16.cu and decode_f32.cu).
#include "decode_attn.cuh"

namespace qa {
namespace dattn {
namespace {

constexpr int kMergeThreads = 128;
constexpr int kMergeCols = 32;  // output columns of a merge CTA

// One CTA per (segment blockIdx.x of slot blockIdx.y, 32 output columns
// blockIdx.z): the partials of the CTAs whose shares hold the segment's
// tiles, in CTA order, O = sum_c 2^(m_c - M) acc_c / sum_c 2^(m_c - M) l_c;
// zeros for an empty slot; the segment's query rows are among its KV
// head's G * T rows of the (B, Hq, T, D) output. A warp forms the weights
// 2^(m_c - M) of its query rows in shared memory; then each thread sums its
// column of up to four rows over the partials, the loads of all four
// issued together.
// Head-dim-packed int4 (p.half = W / 2) writes column f of its W-wide frame
// to output column f (f < W/2) or D/2 + f - W/2, dropping the frame's
// columns past D/2 in each half.
__global__ void __launch_bounds__(kMergeThreads) merge_kernel(const Params p, __nv_bfloat16* out) {
  constexpr int kWarps = kMergeThreads / 32;
  constexpr int kPerLane = kMaxCtas / 32;
  __shared__ int red[2][kWarps];
  __shared__ float wts[kMaxQRows][kMaxCtas];
  __shared__ float inv_l[kMaxQRows];
  const int j = blockIdx.x, b = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int splits = p.qsplits * p.csplits, segs = p.Hkv * splits;
  int before = 0, total = 0;
  for (int x = threadIdx.x; x < p.B; x += kMergeThreads) {
    const int tiles = slot_tiles(p, slot_len(p, x));
    total += tiles;
    before += x < b ? tiles : 0;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    total += __shfl_xor_sync(0xffffffffu, total, o);
    before += __shfl_xor_sync(0xffffffffu, before, o);
  }
  if (lane == 0) {
    red[0][warp] = total;
    red[1][warp] = before;
  }
  __syncthreads();
  total = before = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    total += red[0][w];
    before += red[1][w];
  }
  const int GT = p.Hq / p.Hkv * p.T;
  const int h = j / splits, qs = (j / p.csplits) % p.qsplits, cs = j % p.csplits;
  const int rows = min(kMaxQRows, GT - qs * kMaxQRows);
  const int cols = p.half ? p.vw : min(p.vw, p.D - cs * p.vw);
  const int col = blockIdx.z * kMergeCols + lane;
  if (blockIdx.z * kMergeCols >= cols) return;
  int ocol = cs * p.vw + col;  // the output column of this thread, or -1
  if (p.half) {
    const int dh = p.D / 2, byte = ocol % p.half;
    ocol = byte < dh ? byte + (ocol >= p.half ? dh : 0) : -1;
  }
  __nv_bfloat16* dst = out + (head_row(p, b, h) + qs * kMaxQRows) * p.D + ocol;
  const int tiles = slot_tiles(p, slot_len(p, b));
  if (tiles == 0) {
    for (int q = warp; q < rows; q += kWarps)
      if (col < cols && ocol >= 0) dst[static_cast<size_t>(q) * p.D] = __float2bfloat16_rn(0.f);
    return;
  }
  const int t0 = before * segs + j * tiles;
  const int c0 = owner(total * segs, p.ctas, t0);
  const int n = owner(total * segs, p.ctas, t0 + tiles - 1) - c0 + 1;
  const size_t s0 = static_cast<size_t>(b) * segs + j + c0;  // the first partial
  pdl_wait();  // the partials are the kernel before's
  for (int q = warp; q < rows; q += kWarps) {
    float m[kPerLane], l[kPerLane];
    float mx = -INFINITY;
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) {
      const int c = lane + 32 * i;
      const float2 ml = c < n ? *reinterpret_cast<const float2*>(p.part_ml + 2 * ((s0 + c) * p.qrows + q))
                              : make_float2(-INFINITY, 0.f);
      m[i] = ml.x;
      l[i] = ml.y;
      mx = fmaxf(mx, ml.x);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    float lsum = 0.f;
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) {
      const int c = lane + 32 * i;
      const float w = c < n ? exp2f(m[i] - mx) : 0.f;
      if (c < n) wts[q][c] = w;
      lsum += w * l[i];
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) lsum += __shfl_xor_sync(0xffffffffu, lsum, o);
    if (lane == 0) inv_l[q] = 1.f / lsum;
  }
  __syncthreads();
  if (col >= cols || ocol < 0) return;
  constexpr int kRowsPer = kMaxQRows / kWarps;
  const size_t step = static_cast<size_t>(p.qrows) * p.ccols;
  const float* acc = p.part_acc + s0 * step + col;
  float num[kRowsPer] = {};
#pragma unroll 4
  for (int k = 0; k < n; ++k) {
#pragma unroll
    for (int r = 0; r < kRowsPer; ++r) {
      const int q = warp + kWarps * r;
      if (q < rows) num[r] += wts[q][k] * acc[k * step + static_cast<size_t>(q) * p.ccols];
    }
  }
#pragma unroll
  for (int r = 0; r < kRowsPer; ++r) {
    const int q = warp + kWarps * r;
    if (q < rows) dst[static_cast<size_t>(q) * p.D] = __float2bfloat16_rn(num[r] * inv_l[q]);
  }
}

}  // namespace

cudaError_t merge(const Params& p, __nv_bfloat16* out, cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.Hkv * p.qsplits * p.csplits, p.B, (p.vw + kMergeCols - 1) / kMergeCols);
  cfg.blockDim = dim3(kMergeThreads);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, merge_kernel, p, out);
  return err != cudaSuccess ? err : cudaGetLastError();
}

cudaError_t run_plain16(const Plan& pl, const Params& p, const void* k, const void* v, int rows,
                        __nv_bfloat16* out, cudaStream_t stream) {
  return run<kPlain16, kKindBF16>(pl, p, k, v, rows, out, stream);
}

}  // namespace dattn
}  // namespace qa

// The plan of a decode-attention call (K4: smax = Smax, ps = 0; K10: smax =
// pages_per_seq * page_size, ps = page_size) of T query tokens a head over
// a cache of element kind `kind` (qa::dattn::Kind: 0 int8, 1 e4m3, 2 bf16,
// 3 head-dim-packed int4, 4 token-packed int4, 5 fp16, 6 fp32): out[8] =
// CTAs, query splits, column splits, rows
// and columns of a split, segments a slot, TMA (1) or cp.async rows (0),
// the instantiated width. The partials take (CTAs + B * segments) x rows x
// columns fp32 (and x 2 for m, l). Returns a CUDA error code.
extern "C" int qa_decode_attn_plan(int kind, int B, int Hq, int Hkv, int D, int T, int smax, int ps,
                                   int* out) {
  qa::dattn::Plan pl;
  const cudaError_t err = qa::dattn::plan(kind, B, Hq, Hkv, D, T, smax, ps, &pl);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = pl.ctas;
  out[1] = pl.qsplits;
  out[2] = pl.csplits;
  out[3] = pl.qrows;
  out[4] = pl.ccols;
  out[5] = pl.segs;
  out[6] = pl.tma;
  out[7] = pl.W;
  return 0;
}
