// K10: one-token GQA decode attention over KV pages gathered through a
// page table (sm_90a).
//
// Replaces the Pallas kernel quantumattention_tpu/ops/paged.py::_paged_kernel
// (paged.py:77; host entry paged_decode_attention, paged.py:413). Same math
// as its DMA path: each page row of K and V is dequantized per element to
// bf16 (int8 code times the row's fp32 scale, rounded once; bf16 pages as
// they are), scores q.k in fp32 times sm_scale * log2(e), rows at or past
// lengths[slot] masked with MASK_VALUE, an exp2 online softmax with fp32
// m, l and accumulator, the unnormalized P rounded to bf16 for P.V, the
// division by l at the end, and exact zeros for a slot of length 0.
//
// What bounds it on the H100: bytes. Every valid page row of K and V is
// read once (1 byte an element for int8, plus a 4-byte scale) for 4*G*D
// flops, far below the card's balance point. The design:
//  - one CTA per (page span, KV head, slot); a span is 256 rows of whole
//    pages, so a few slots still fill the card's 132 SMs (split-KV). The
//    grid comes from pages_per_seq, never from the lengths, so nothing is
//    read back to the host and a decode step can be captured in a CUDA
//    graph. A CTA whose span starts at or past its slot's length exits at
//    once;
//  - the CTA reads its page ids from the table itself (the TPU kernel's
//    scalar prefetch) and only for rows below the length, so table entries
//    past a sequence's pages are never read;
//  - 64-row tiles of page rows come in by cp.async, 16 bytes a thread, in a
//    two-stage ring (the TPU's double-buffered make_async_copy); rows past
//    the length are zero-filled, not read;
//  - the GQA group (4 query heads for Llama-3-8B) is the M dimension of
//    mma.sync m16n8k16, padded to 16 rows; each of the 4 warps owns 16 rows
//    of every tile and keeps its own online softmax in registers (S's
//    accumulator layout is P's A-operand layout), converting int8 codes to
//    bf16 while it builds the K and V fragments;
//  - the 4 warps' (m, l, acc) merge through shared memory at the end of the
//    span, and a second small kernel merges the spans in a fixed order, as
//    K4's split-KV does (csrc/decode.cu): deterministic, no atomics;
//  - head dims: any multiple of 8 up to 512, rounded up to an instantiated
//    width W of 64, 128, 256 or 512 (qa::kernel_width). Page rows of D
//    columns land in tiles W columns wide whose columns past D are
//    zero-filled (the query's are zero too); the products run over all of W
//    with loop bounds known at compile time (runtime chunk counts and early
//    loop exits made this kernel a third slower at D = 128 on the H100: 33.3
//    against 24.8 us), and only D columns are stored. An int8 row of
//    D % 16 == 8 is not 16-byte aligned, so such pages are copied 8 bytes a
//    cp.async. At W = 256 the
//    query's A fragments (64 registers) are read from shared memory at each
//    tile instead of held beside the 128-float accumulator, and the two
//    stages take ~145 KB; at W = 512 two CTAs share each span, each scoring
//    the full D and owning 256 output columns (K tiles 512 wide, V tiles
//    256: ~218 KB for bf16 pages).
#include "common.cuh"

namespace {

using qa::load_a_frag;
using qa::load_b_nn;
using qa::load_b_nt;
using qa::mma_bf16;
using qa::pack_bf16;

constexpr int kTile = 64;        // page rows per tile
constexpr int kSpanRows = 256;   // rows per CTA (rounded to whole pages)
constexpr int kWarps = 4;        // each warp owns 16 rows of a tile
constexpr int kThreads = kWarps * 32;
constexpr int kMaxGroup = 16;    // query heads per KV head: the MMA's M rows

// W: the instantiated width of the query and K rows; a CTA owns kVW <= 256
// output columns (V rows).
template <int W, bool Q8>
struct Layout {
  static constexpr int kElem = Q8 ? 1 : 2;
  static constexpr int kVW = W > 256 ? 256 : W;
  static constexpr int kSplits = W / kVW;
  // Row strides in shared memory: 16 bytes of padding spread the rows of a
  // fragment load over the banks.
  static constexpr int kKRowBytes = W * kElem + 16;
  static constexpr int kVRowBytes = kVW * kElem + 16;
  static constexpr int kKTileBytes = kTile * kKRowBytes;
  static constexpr int kVTileBytes = kTile * kVRowBytes;
  // K tile, V tile, K scales, V scales.
  static constexpr int kStageBytes = kKTileBytes + kVTileBytes + 2 * kTile * 4;
  // The warps' partials at the end of the span reuse the stages.
  static constexpr int kMergeBytes = kWarps * kMaxGroup * (kVW + 2) * 4;
  static constexpr int kWorkBytes = 2 * kStageBytes > kMergeBytes ? 2 * kStageBytes : kMergeBytes;
  static constexpr int kQStride = W + 8;  // bf16 elements
  static constexpr size_t kSmem = kWorkBytes + kMaxGroup * kQStride * 2;
  static_assert(kSmem <= 232448, "shared memory of one CTA");
};

// 4 bytes from device memory to shared memory, asynchronously; zero when
// !valid (the source is then not read).
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, bool valid) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(gmem), "r"(valid ? 4 : 0));
}

// 8 bytes likewise (int8 rows of D % 16 == 8 are only 8-byte aligned).
__device__ __forceinline__ void cp_async8(void* smem, const void* gmem, bool valid) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n"
               :: "r"(dst), "l"(gmem), "r"(valid ? 8 : 0));
}

// One chunk of CH bytes (16, or 8 where a row is only 8-byte aligned).
template <int CH>
__device__ __forceinline__ void cp_chunk(void* smem, const void* gmem, bool valid) {
  if constexpr (CH == 16) {
    qa::cp_async16(smem, gmem, valid);
  } else {
    cp_async8(smem, gmem, valid);
  }
}

// The K and V page rows row0 .. row0 + kTile - 1 (below `stop`) of one tile
// in chunks of CH bytes, KCH a K row and VCH a V row (from column byte
// v_off on); chunks past the row's row_bytes, and rows at or past stop,
// are zero-filled.
template <int CH, int KCH, int VCH, typename PageRow>
__device__ __forceinline__ void fetch_rows(unsigned char* kt, int k_stride, unsigned char* vt,
                                           int v_stride, const unsigned char* kp,
                                           const unsigned char* vp, int row0, int stop,
                                           int row_bytes, int v_off, PageRow page_row) {
  for (int c = threadIdx.x; c < kTile * KCH; c += kThreads) {
    const int r = c / KCH, cc = c % KCH;
    const bool live = row0 + r < stop;
    const size_t base = live ? page_row(row0 + r) * row_bytes : 0;
    const bool k_ok = live && cc * CH < row_bytes;
    cp_chunk<CH>(kt + r * k_stride + cc * CH, kp + (k_ok ? base + cc * CH : 0), k_ok);
    if constexpr (KCH == VCH) {
      const bool v_ok = live && v_off + cc * CH < row_bytes;
      cp_chunk<CH>(vt + r * v_stride + cc * CH, vp + (v_ok ? base + v_off + cc * CH : 0), v_ok);
    }
  }
  if constexpr (KCH != VCH) {
    for (int c = threadIdx.x; c < kTile * VCH; c += kThreads) {
      const int r = c / VCH, cc = c % VCH;
      const bool v_ok = row0 + r < stop && v_off + cc * CH < row_bytes;
      const size_t off = v_ok ? page_row(row0 + r) * row_bytes + v_off + cc * CH : 0;
      cp_chunk<CH>(vt + r * v_stride + cc * CH, vp + off, v_ok);
    }
  }
}

__device__ __forceinline__ float i8f(const unsigned char* p) {
  return static_cast<float>(*reinterpret_cast<const signed char*>(p));
}

template <int W, bool Q8>
__global__ void __launch_bounds__(kThreads)
paged_span_kernel(const __nv_bfloat16* __restrict__ q, const unsigned char* __restrict__ kp,
                  const unsigned char* __restrict__ vp, const float* __restrict__ ksp,
                  const float* __restrict__ vsp, const int* __restrict__ lengths,
                  const int* __restrict__ table, float* __restrict__ part_acc,
                  float* __restrict__ part_ml, int Hq, int Hkv, int P, int ps, int pps, int D,
                  int span_pages, float score_scale) {
  using L = Layout<W, Q8>;
  constexpr int kDT = L::kVW / 8;  // 8-column output tiles
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem + L::kWorkBytes);

  const int span = blockIdx.x, h = blockIdx.y / L::kSplits, b = blockIdx.z;
  const int col0 = blockIdx.y % L::kSplits * L::kVW;  // this CTA's first output column
  const int nspan = gridDim.x;
  const int row_bytes = D * L::kElem;
  const int G = Hq / Hkv;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int len = min(lengths[b], pps * ps);
  const int start = span * span_pages * ps;
  const int stop = min(len, start + span_pages * ps);
  const size_t part = (static_cast<size_t>(b) * Hkv + h) * nspan + span;
  if (start >= len) {
    for (int r = tid; r < (col0 == 0 ? G : 0); r += kThreads) {
      part_ml[2 * (part * G + r)] = -INFINITY;
      part_ml[2 * (part * G + r) + 1] = 0.f;
    }
    return;
  }
  const int* trow = table + static_cast<size_t>(b) * pps;
  const size_t head_page0 = static_cast<size_t>(h) * P;

  // The physical row of the slot's row `row` (< stop): its page id from the
  // table (an id out of range is clamped: the table must never hold one).
  auto page_row = [&](int row) -> size_t {
    const int page = min(max(trow[row / ps], 0), P - 1);
    return (head_page0 + page) * ps + row % ps;
  };

  auto fetch = [&](int row0, int stage) {
    unsigned char* kt = smem + stage * L::kStageBytes;
    unsigned char* vt = kt + L::kKTileBytes;
    float* kst = reinterpret_cast<float*>(vt + L::kVTileBytes);
    if (row_bytes % 16 == 0) {
      fetch_rows<16, W * L::kElem / 16, L::kVW * L::kElem / 16>(
          kt, L::kKRowBytes, vt, L::kVRowBytes, kp, vp, row0, stop, row_bytes, col0 * L::kElem,
          page_row);
    } else {
      fetch_rows<8, W * L::kElem / 8, L::kVW * L::kElem / 8>(
          kt, L::kKRowBytes, vt, L::kVRowBytes, kp, vp, row0, stop, row_bytes, col0 * L::kElem,
          page_row);
    }
    if constexpr (Q8) {
      for (int r = tid; r < kTile; r += kThreads) {
        const bool ok = row0 + r < stop;
        const size_t off = ok ? page_row(row0 + r) : 0;
        cp_async4(kst + r, ksp + off, ok);
        cp_async4(kst + kTile + r, vsp + off, ok);
      }
    }
  };

  const int ntiles = (stop - start + kTile - 1) / kTile;
  fetch(start, 0);
  qa::cp_async_commit();

  // The group's query rows, zero rows up to 16 and zero columns past D.
  const size_t q_base = (static_cast<size_t>(b) * Hq + static_cast<size_t>(h) * G) * D;
  for (int i = tid; i < kMaxGroup * (W / 8); i += kThreads) {
    const int r = i / (W / 8), c = (i % (W / 8)) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (r < G && c < D) v = *reinterpret_cast<const uint4*>(q + q_base + static_cast<size_t>(r) * D + c);
    *reinterpret_cast<uint4*>(Qs + r * L::kQStride + c) = v;
  }

  // The query's A fragments, held in registers up to W = 128.
  constexpr bool kQRegs = W <= 128;
  uint32_t qf[kQRegs ? W / 16 : 1][4];
  float o[kDT][4];
#pragma unroll
  for (int j = 0; j < kDT; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;  // rows g, g + 8
  const int wrow = warp * 16;  // this warp's first row of a tile

  for (int it = 0; it < ntiles; ++it) {
    const int row0 = start + it * kTile;
    if (it + 1 < ntiles) {
      fetch(row0 + kTile, (it + 1) & 1);
      qa::cp_async_commit();
      qa::cp_async_wait<1>();
    } else {
      qa::cp_async_wait<0>();
    }
    __syncthreads();
    if (kQRegs && it == 0) {
#pragma unroll
      for (int kk = 0; kk < (kQRegs ? W / 16 : 0); ++kk) load_a_frag(qf[kk], Qs, L::kQStride, kk, g, t);
    }
    const unsigned char* kt = smem + (it & 1) * L::kStageBytes;
    const unsigned char* vt = kt + L::kKTileBytes;
    const float* kst = reinterpret_cast<const float*>(vt + L::kVTileBytes);
    const float* vst = kst + kTile;

    // S = Q K^T over the warp's 16 rows: two 8-column tiles.
    float s[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      const int kr = wrow + j * 8 + g;
#pragma unroll
      for (int kk = 0; kk < W / 16; ++kk) {
        uint32_t b0, b1;
        if constexpr (Q8) {
          const float sc = kst[kr];
          const unsigned char* r = kt + kr * L::kKRowBytes + kk * 16 + t * 2;
          b0 = pack_bf16(i8f(r) * sc, i8f(r + 1) * sc);
          b1 = pack_bf16(i8f(r + 8) * sc, i8f(r + 9) * sc);
        } else {
          load_b_nt(b0, b1, reinterpret_cast<const __nv_bfloat16*>(kt), L::kKRowBytes / 2,
                    warp * 2 + j, kk, g, t);
        }
        if constexpr (kQRegs) {
          mma_bf16(s[j], qf[kk], b0, b1);
        } else {
          uint32_t a[4];
          load_a_frag(a, Qs, L::kQStride, kk, g, t);
          mma_bf16(s[j], a, b0, b1);
        }
      }
    }

    // Scale, mask rows at or past the length, online softmax.
    float mx0 = qa::kMaskValue, mx1 = qa::kMaskValue;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool ok = row0 + wrow + j * 8 + t * 2 + e < stop;
        s[j][e] = ok ? s[j][e] * score_scale : qa::kMaskValue;
        s[j][2 + e] = ok ? s[j][2 + e] * score_scale : qa::kMaskValue;
        mx0 = fmaxf(mx0, s[j][e]);
        mx1 = fmaxf(mx1, s[j][2 + e]);
      }
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float a0 = exp2f(m0 - mn0), a1 = exp2f(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      s[j][0] = exp2f(s[j][0] - mn0);
      s[j][1] = exp2f(s[j][1] - mn0);
      s[j][2] = exp2f(s[j][2] - mn1);
      s[j][3] = exp2f(s[j][3] - mn1);
      sum0 += s[j][0] + s[j][1];
      sum1 += s[j][2] + s[j][3];
    }
    l0 = a0 * l0 + sum0;
    l1 = a1 * l1 + sum1;

    // O += P V: the score accumulators are P's A operand (depth = the 16 rows).
    uint32_t pa[4];
    pa[0] = pack_bf16(s[0][0], s[0][1]);
    pa[1] = pack_bf16(s[0][2], s[0][3]);
    pa[2] = pack_bf16(s[1][0], s[1][1]);
    pa[3] = pack_bf16(s[1][2], s[1][3]);
    const int vr = wrow + t * 2;  // V rows vr, vr + 1, vr + 8, vr + 9
    float vs0 = 1.f, vs1 = 1.f, vs8 = 1.f, vs9 = 1.f;
    if constexpr (Q8) {
      vs0 = vst[vr];
      vs1 = vst[vr + 1];
      vs8 = vst[vr + 8];
      vs9 = vst[vr + 9];
    }
#pragma unroll
    for (int j = 0; j < kDT; ++j) {
      o[j][0] *= a0;
      o[j][1] *= a0;
      o[j][2] *= a1;
      o[j][3] *= a1;
      uint32_t b0, b1;
      if constexpr (Q8) {
        const unsigned char* c = vt + vr * L::kVRowBytes + j * 8 + g;
        b0 = pack_bf16(i8f(c) * vs0, i8f(c + L::kVRowBytes) * vs1);
        b1 = pack_bf16(i8f(c + 8 * L::kVRowBytes) * vs8, i8f(c + 9 * L::kVRowBytes) * vs9);
      } else {
        load_b_nn(b0, b1, reinterpret_cast<const __nv_bfloat16*>(vt) + wrow * (L::kVRowBytes / 2),
                  L::kVRowBytes / 2, j, 0, g, t);
      }
      mma_bf16(o[j], pa, b0, b1);
    }
    __syncthreads();  // this stage is refilled two tiles on
  }

  // Each warp's full row sums, then its partials into shared memory (the
  // stages are free), then one (m, l, acc) for the span.
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  constexpr int kVW = L::kVW;
  float* wacc = reinterpret_cast<float*>(smem);      // [warp][row][kVW]
  float* wml = wacc + kWarps * kMaxGroup * kVW;       // [warp][row][2]
  const int r0 = g, r1 = g + 8;
#pragma unroll
  for (int j = 0; j < kDT; ++j) {
    const int c = j * 8 + t * 2;
    if (r0 < G) {
      wacc[(warp * kMaxGroup + r0) * kVW + c] = o[j][0];
      wacc[(warp * kMaxGroup + r0) * kVW + c + 1] = o[j][1];
    }
    if (r1 < G) {
      wacc[(warp * kMaxGroup + r1) * kVW + c] = o[j][2];
      wacc[(warp * kMaxGroup + r1) * kVW + c + 1] = o[j][3];
    }
  }
  if (t == 0) {
    if (r0 < G) {
      wml[2 * (warp * kMaxGroup + r0)] = m0;
      wml[2 * (warp * kMaxGroup + r0) + 1] = l0;
    }
    if (r1 < G) {
      wml[2 * (warp * kMaxGroup + r1)] = m1;
      wml[2 * (warp * kMaxGroup + r1) + 1] = l1;
    }
  }
  __syncthreads();
  for (int i = tid; i < G * kVW; i += kThreads) {
    const int r = i / kVW, c = i % kVW;
    if (col0 + c >= D) continue;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, wml[2 * (w * kMaxGroup + r)]);
    float acc = 0.f, l = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float wt = exp2f(wml[2 * (w * kMaxGroup + r)] - mx);
      acc += wt * wacc[(w * kMaxGroup + r) * kVW + c];
      l += wt * wml[2 * (w * kMaxGroup + r) + 1];
    }
    part_acc[(part * G + r) * D + col0 + c] = acc;
    if (col0 + c == 0) {
      part_ml[2 * (part * G + r)] = mx;
      part_ml[2 * (part * G + r) + 1] = l;
    }
  }
}

// Merge the spans of one (KV head, slot) in order: O = sum_s 2^(m_s - M)
// acc_s / sum_s 2^(m_s - M) l_s; zeros for an empty slot.
__global__ void __launch_bounds__(kThreads)
paged_merge_kernel(const float* __restrict__ part_acc, const float* __restrict__ part_ml,
                   const int* __restrict__ lengths, __nv_bfloat16* __restrict__ out, int Hq,
                   int Hkv, int D, int nspan) {
  const int G = Hq / Hkv;
  const int h = blockIdx.x, b = blockIdx.y;
  const size_t part0 = (static_cast<size_t>(b) * Hkv + h) * nspan;
  const size_t q_base = (static_cast<size_t>(b) * Hq + static_cast<size_t>(h) * G) * D;
  const bool empty = lengths[b] <= 0;
  for (int i = threadIdx.x; i < G * D; i += kThreads) {
    const int r = i / D;
    float mx = -INFINITY;
    for (int s = 0; s < nspan; ++s) mx = fmaxf(mx, part_ml[2 * ((part0 + s) * G + r)]);
    float num = 0.f, den = 0.f;
    if (mx != -INFINITY) {
      for (int s = 0; s < nspan; ++s) {
        const float ls = part_ml[2 * ((part0 + s) * G + r) + 1];
        if (ls == 0.f) continue;
        const float w = exp2f(part_ml[2 * ((part0 + s) * G + r)] - mx);
        num += w * part_acc[(part0 + s) * G * D + i];
        den += w * ls;
      }
    }
    out[q_base + i] = __float2bfloat16_rn(!empty && den != 0.f ? num / den : 0.f);
  }
}

template <int W, bool Q8>
cudaError_t launch_spans(const void* q, const void* k, const void* v, const void* ks,
                         const void* vs, const void* lengths, const void* table, void* part_acc,
                         void* part_ml, int B, int Hq, int Hkv, int P, int ps, int pps, int D,
                         int span_pages, int nspan, float score_scale, cudaStream_t stream) {
  using L = Layout<W, Q8>;
  cudaError_t err = cudaFuncSetAttribute(paged_span_kernel<W, Q8>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(L::kSmem));
  if (err != cudaSuccess) return err;
  paged_span_kernel<W, Q8><<<dim3(nspan, Hkv * L::kSplits, B), kThreads, L::kSmem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const unsigned char*>(k),
      static_cast<const unsigned char*>(v), static_cast<const float*>(ks),
      static_cast<const float*>(vs), static_cast<const int*>(lengths),
      static_cast<const int*>(table), static_cast<float*>(part_acc),
      static_cast<float*>(part_ml), Hq, Hkv, P, ps, pps, D, span_pages, score_scale);
  return cudaGetLastError();
}

template <int W>
cudaError_t launch_spans_w(bool q8, const void* q, const void* k, const void* v, const void* ks,
                           const void* vs, const void* lengths, const void* table,
                           void* part_acc, void* part_ml, int B, int Hq, int Hkv, int P, int ps,
                           int pps, int D, int span_pages, int nspan, float score_scale,
                           cudaStream_t stream) {
  return q8 ? launch_spans<W, true>(q, k, v, ks, vs, lengths, table, part_acc, part_ml, B, Hq,
                                    Hkv, P, ps, pps, D, span_pages, nspan, score_scale, stream)
            : launch_spans<W, false>(q, k, v, ks, vs, lengths, table, part_acc, part_ml, B, Hq,
                                     Hkv, P, ps, pps, D, span_pages, nspan, score_scale, stream);
}

}  // namespace

// Pages one CTA of qa_paged_decode covers at page size ps.
extern "C" int qa_paged_span_pages(int ps) {
  return ps >= kSpanRows ? 1 : kSpanRows / ps;
}

// q (B, Hq, D) bf16; k, v (Hkv, P, ps, D) int8 (kv_code 3, with fp32 token
// scales (Hkv, P, ps)) or bf16 (kv_code 0, scales null); lengths (B,) int32;
// table (B, pps) int32 page ids; out (B, Hq, D) bf16; part_acc
// (B, Hkv, nspan, G, D) and part_ml (B, Hkv, nspan, G, 2) fp32 scratch with
// nspan = ceil(pps / qa_paged_span_pages(ps)). score_scale = sm_scale *
// log2(e). D is a multiple of 8 up to 512, G = Hq / Hkv at most 16, ps a
// multiple of 16 up to 256.
extern "C" int qa_paged_decode(const void* q, const void* k, const void* v, const void* k_scale,
                               const void* v_scale, const void* lengths, const void* table,
                               void* out, void* part_acc, void* part_ml, int B, int Hq, int Hkv,
                               int P, int ps, int pps, int D, int kv_code, float score_scale,
                               void* stream) {
  if (B == 0) return 0;
  const int width = qa::kernel_width(D);
  if (Hkv <= 0 || Hq % Hkv != 0 || Hq / Hkv > kMaxGroup || ps <= 0 || ps % 16 != 0 ||
      ps > 256 || pps <= 0 || P <= 0 || width == 0 ||
      (kv_code != qa::kI8 && kv_code != qa::kBF16) ||
      ((kv_code == qa::kI8) != (k_scale != nullptr && v_scale != nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int span_pages = qa_paged_span_pages(ps);
  const int nspan = (pps + span_pages - 1) / span_pages;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool q8 = kv_code == qa::kI8;
  cudaError_t err;
  switch (width) {
    case 64:
      err = launch_spans_w<64>(q8, q, k, v, k_scale, v_scale, lengths, table, part_acc, part_ml,
                               B, Hq, Hkv, P, ps, pps, D, span_pages, nspan, score_scale, s);
      break;
    case 128:
      err = launch_spans_w<128>(q8, q, k, v, k_scale, v_scale, lengths, table, part_acc, part_ml,
                                B, Hq, Hkv, P, ps, pps, D, span_pages, nspan, score_scale, s);
      break;
    case 256:
      err = launch_spans_w<256>(q8, q, k, v, k_scale, v_scale, lengths, table, part_acc, part_ml,
                                B, Hq, Hkv, P, ps, pps, D, span_pages, nspan, score_scale, s);
      break;
    default:
      err = launch_spans_w<512>(q8, q, k, v, k_scale, v_scale, lengths, table, part_acc, part_ml,
                                B, Hq, Hkv, P, ps, pps, D, span_pages, nspan, score_scale, s);
      break;
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  paged_merge_kernel<<<dim3(Hkv, B), kThreads, 0, s>>>(
      static_cast<const float*>(part_acc), static_cast<const float*>(part_ml),
      static_cast<const int*>(lengths), static_cast<__nv_bfloat16*>(out), Hq, Hkv, D, nspan);
  return static_cast<int>(cudaGetLastError());
}
