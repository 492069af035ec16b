// K1: fused attention forward for Hopper (sm_90a).
//
// Replaces the Pallas kernel quantumattention_tpu/ops/flash.py::_flash_kernel
// (flash.py:123; host entry flash_attention, flash.py:701). Same math:
// S = Q.K^T with scale_q * scale_k * sm_scale * log2(e) folded into the
// scores, an exp2-domain online softmax with fp32 running max / sum /
// accumulator, P rounded to bf16 for P.V with fp32 accumulation, top-left
// causal and ragged-KV-tail masks with MASK_VALUE (not -inf), GQA by
// KV-head index (q head hq reads KV head hq / G). With a position offset
// (chunked prefill: q's row 0 sits at global position q_offset over a
// longer K/V) the causal mask is q_offset + i >= j (flash.py:862-870).
//
// What bounds it on the H100: the two products, 4*S^2*D flops per head
// (half of it under the causal mask), which the tensor cores run at up to
// 989 TFLOP/s in bf16, and only through wgmma fed by TMA. This version is
// the simple FlashAttention-2 structure on mma.sync: one CTA of 4 warps per
// (b, q head, 64-row Q block), each warp owning 16 Q rows whose Q fragments,
// scores, probabilities and output accumulator all stay in registers (the
// m16n8k16 accumulator layout of S is the A-operand layout of P, so P never
// leaves them). Each 64-row K/V tile is loaded once per CTA into shared
// memory with 8-element vector loads and converted to bf16 on the way:
// e4m3 and int8 are exact in bf16, which is what _compute_cast
// (flash.py:109) does on the TPU. KV tiles wholly above the causal
// diagonal (shifted by q_offset) are never loaded. TMA, wgmma, fp8
// operands, cp.async pipelining and warp specialisation are later work
// (ROADMAP queue 2).
#include "common.cuh"

namespace {

using qa::load_a_frag;
using qa::load_b_nn;
using qa::load_b_nt;
using qa::mma_bf16;
using qa::pack_bf16;

constexpr int kBM = 64;       // Q rows per CTA
constexpr int kBN = 64;       // KV rows per tile
constexpr int kWarps = 4;     // each warp owns 16 Q rows
constexpr int kThreads = kWarps * 32;
constexpr int kPad = 8;       // bf16 elements of row padding (bank spread)

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(__nv_bfloat16) * (kBM + 2 * kBN) * (D + kPad) + sizeof(float) * kBN;
}

template <int D>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const void* src, int code,
                                          size_t base, int row0, int valid) {
  qa::load_tile<kBN, D, kThreads, kPad>(dst, src, code, base, row0, valid);
}

// scaling: 0 none, 1 head-wise (B, H), 2 token-wise (B, H, S).
// m_out / l_out (B, Hq, Sq) fp32, both or neither: the residuals of the
// backward (K2/K3), i.e. each row's final running max and softmax sum in
// the exp2 domain of the folded scores (flash.py:586-588).
// kOffset: a q_offset may be nonzero. The q_offset = 0 instantiation is the
// kernel without offsets: the offset's arithmetic cost two registers a
// thread, past the 168 at which three CTAs fit on an SM (~17% slower at
// B = 1, S = 1536, measured in chip_smoke's k1 phase).
template <int D, bool kOffset>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const void* __restrict__ q, const void* __restrict__ k,
                 const void* __restrict__ v, const float* __restrict__ scale_q,
                 const float* __restrict__ scale_k, void* __restrict__ out,
                 int Hq, int Hkv, int Sq, int Skv, int q_code, int k_code,
                 int v_code, int out_code, int scaling, int causal,
                 float score_scale, int q_offset_arg, float* __restrict__ m_out,
                 float* __restrict__ l_out) {
  const int q_offset = kOffset ? q_offset_arg : 0;
  static_assert(kBM == kBN, "the Q tile reuses the tile loader");
  constexpr int kStride = D + kPad;
  constexpr int kNT = kBN / 8;   // 8-column score tiles per KV tile
  constexpr int kDT = D / 8;     // 8-column output tiles
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Ks = Qs + kBM * kStride;
  __nv_bfloat16* Vs = Ks + kBN * kStride;
  float* col_scale = reinterpret_cast<float*>(Vs + kBN * kStride);

  const int mb = blockIdx.x, hq = blockIdx.y, b = blockIdx.z;
  const int hk = hq / (Hq / Hkv);
  const int q0 = mb * kBM;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;  // mma fragment row group / column pair
  const size_t q_base = static_cast<size_t>(b * Hq + hq) * Sq * D;
  const size_t kv_base = static_cast<size_t>(b * Hkv + hk) * Skv * D;

  // This thread's two Q rows and their folded score scales.
  const int row0 = q0 + warp * 16 + g, row1 = row0 + 8;
  float rs0 = score_scale, rs1 = score_scale;
  if (scaling == 1) {
    const float s = scale_q[b * Hq + hq];
    rs0 *= s;
    rs1 *= s;
  } else if (scaling == 2) {
    const size_t sb = static_cast<size_t>(b * Hq + hq) * Sq;
    rs0 *= row0 < Sq ? scale_q[sb + row0] : 0.f;
    rs1 *= row1 < Sq ? scale_q[sb + row1] : 0.f;
  }
  const float head_k_scale = scaling == 1 ? scale_k[b * Hkv + hk] : 1.f;

  load_tile<D>(Qs, q, q_code, q_base, q0, Sq);
  __syncthreads();
  uint32_t qf[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) load_a_frag(qf[kk], Qs + warp * 16 * kStride, kStride, kk, g, t);

  float o[kDT][4];
#pragma unroll
  for (int j = 0; j < kDT; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;  // l: this thread's partial sums

  // Causal: rows q0..q0+63 see columns < q_offset + q0 + 64 at most.
  const int kv_end = causal ? min(Skv, q_offset + q0 + kBM) : Skv;
  for (int n0 = 0; n0 < kv_end; n0 += kBN) {
    __syncthreads();  // the previous tile is no longer read
    load_tile<D>(Ks, k, k_code, kv_base, n0, Skv);
    load_tile<D>(Vs, v, v_code, kv_base, n0, Skv);
    for (int c = threadIdx.x; c < kBN; c += kThreads) {
      const int col = n0 + c;
      col_scale[c] = scaling == 2
          ? (col < Skv ? scale_k[static_cast<size_t>(b * Hkv + hk) * Skv + col] : 0.f)
          : head_k_scale;
    }
    __syncthreads();

    // S = Q K^T: 16 rows x 64 columns per warp.
    float s[kNT][4];
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t b0, b1;
        load_b_nt(b0, b1, Ks, kStride, j, kk, g, t);
        mma_bf16(s[j], qf[kk], b0, b1);
      }
    }

    // Scale, mask, online softmax (rows row0 and row1 of this thread). The
    // causal test q_offset + row >= col runs as row >= col - q_offset, so
    // the offset stays in the warp-uniform column term.
    const int c0 = n0 - q_offset;
    float mx0 = qa::kMaskValue, mx1 = qa::kMaskValue;
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int cl = j * 8 + t * 2 + e;
        const int col = n0 + cl;
        const float cs = col_scale[cl];
        const bool in = col < Skv;
        s[j][e] = in && (!causal || c0 + cl <= row0) ? s[j][e] * rs0 * cs : qa::kMaskValue;
        s[j][2 + e] = in && (!causal || c0 + cl <= row1) ? s[j][2 + e] * rs1 * cs : qa::kMaskValue;
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
    for (int j = 0; j < kNT; ++j) {
      s[j][0] = exp2f(s[j][0] - mn0);
      s[j][1] = exp2f(s[j][1] - mn0);
      s[j][2] = exp2f(s[j][2] - mn1);
      s[j][3] = exp2f(s[j][3] - mn1);
      sum0 += s[j][0] + s[j][1];
      sum1 += s[j][2] + s[j][3];
    }
    l0 = a0 * l0 + sum0;
    l1 = a1 * l1 + sum1;
#pragma unroll
    for (int j = 0; j < kDT; ++j) {
      o[j][0] *= a0;
      o[j][1] *= a0;
      o[j][2] *= a1;
      o[j][3] *= a1;
    }

    // O += P V. The score accumulators of tiles 2kk, 2kk+1 are P's A operand.
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int j = 0; j < kDT; ++j) {
        uint32_t b0, b1;
        load_b_nn(b0, b1, Vs, kStride, j, kk, g, t);
        mma_bf16(o[j], pa, b0, b1);
      }
    }
  }

  // Epilogue: full row sums, normalise, store; padded Q rows are never stored.
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float inv0 = l0 == 0.f ? 0.f : 1.f / l0;
  const float inv1 = l1 == 0.f ? 0.f : 1.f / l1;
  if (m_out != nullptr && t == 0) {  // the four lanes of a row hold equal m, l
    const size_t rb = static_cast<size_t>(b * Hq + hq) * Sq;
    if (row0 < Sq) {
      m_out[rb + row0] = m0;
      l_out[rb + row0] = l0;
    }
    if (row1 < Sq) {
      m_out[rb + row1] = m1;
      l_out[rb + row1] = l1;
    }
  }
#pragma unroll
  for (int j = 0; j < kDT; ++j) {
    const int c = j * 8 + t * 2;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = half ? row1 : row0;
      if (row >= Sq) continue;
      const float inv = half ? inv1 : inv0;
      const float x0 = o[j][2 * half] * inv, x1 = o[j][2 * half + 1] * inv;
      const size_t idx = q_base + static_cast<size_t>(row) * D + c;
      if (out_code == qa::kF16) {
        *reinterpret_cast<__half2*>(static_cast<__half*>(out) + idx) = __floats2half2_rn(x0, x1);
      } else {
        *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(out) + idx) =
            __floats2bfloat162_rn(x0, x1);
      }
    }
  }
}

template <int D, bool kOffset>
int launch(const void* q, const void* k, const void* v, const float* sq,
           const float* sk, void* out, int B, int Hq, int Hkv, int Sq, int Skv,
           int q_code, int k_code, int v_code, int out_code, int scaling,
           int causal, float score_scale, int q_offset, float* m_out, float* l_out,
           cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<D, kOffset>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((Sq + kBM - 1) / kBM, Hq, B);
  flash_fwd_kernel<D, kOffset><<<grid, kThreads, smem, stream>>>(
      q, k, v, sq, sk, out, Hq, Hkv, Sq, Skv, q_code, k_code, v_code,
      out_code, scaling, causal, score_scale, q_offset, m_out, l_out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// score_scale = sm_scale * log2(e). Tensors are contiguous (B, H, S, D) and
// 16-byte aligned. q_offset >= 0: the global position of q's row 0 (the
// causal mask is q_offset + i >= j). m_out / l_out: (B, Hq, Sq) fp32
// residuals, or both null.
extern "C" int qa_flash_fwd(const void* q, const void* k, const void* v,
                            const void* scale_q, const void* scale_k, void* out,
                            int B, int Hq, int Hkv, int Sq, int Skv, int D,
                            int q_code, int k_code, int v_code, int out_code,
                            int scaling, int causal, float score_scale,
                            int q_offset, void* m_out, void* l_out, void* stream) {
  const float* sq = static_cast<const float*>(scale_q);
  const float* sk = static_cast<const float*>(scale_k);
  float* mo = static_cast<float*>(m_out);
  float* lo = static_cast<float*>(l_out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Sq == 0 || B == 0) return 0;
  if (q_offset < 0) return static_cast<int>(cudaErrorInvalidValue);
  const bool offset = causal && q_offset != 0;
  switch (D) {
    case 64:
      return (offset ? launch<64, true> : launch<64, false>)(
          q, k, v, sq, sk, out, B, Hq, Hkv, Sq, Skv, q_code, k_code, v_code, out_code,
          scaling, causal, score_scale, q_offset, mo, lo, s);
    case 128:
      return (offset ? launch<128, true> : launch<128, false>)(
          q, k, v, sq, sk, out, B, Hq, Hkv, Sq, Skv, q_code, k_code, v_code, out_code,
          scaling, causal, score_scale, q_offset, mo, lo, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
