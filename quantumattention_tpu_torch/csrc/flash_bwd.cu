// K2 (dQ) and K3 (dK, dV): blockwise flash-attention backward for Hopper
// (sm_90a).
//
// Replace the Pallas kernels quantumattention_tpu/ops/flash_bwd.py::_dq_kernel
// (flash_bwd.py:112) and ::_dkv_kernel (flash_bwd.py:150); host entry
// flash_attention_bwd (flash_bwd.py:197). Same math (flash_bwd.py:9-15),
// with P recomputed per tile from the forward's saved row max m and row sum
// l, both in the exp2 domain of the scores times score_scale
// (= sm_scale * log2(e)):
//
//   P  = exp2(Q.K^T * score_scale - m) / l      (l == 0 -> P = 0)
//   dP = dO.V^T,  dS = P o (dP - D),  D = rowsum(dO o O) (given)
//   dQ = sm_scale * dS.K      dK = sm_scale * dS^T.Q      dV = P^T.dO
//
// with top-left causal and ragged-tail masks (masked P = 0), GQA by KV-head
// index, P and dS rounded to bf16 as product operands (as the TPU kernels
// do) and fp32 accumulation.
//
// What bounds them on the H100: the products, 2.5x the forward's flops
// (five S x S x D products, two of them recomputing the forward's), which
// only wgmma fed by TMA runs at the tensor cores' full rate. These are the
// simple versions on mma.sync:
//
// - K2: one CTA of 4 warps per (b, q head, 64-row Q block); each warp owns
//   16 Q rows. Q and dO stay in shared memory, each K/V tile of KV head
//   hq / G is loaded once per CTA, tiles wholly above the causal diagonal
//   are skipped, and S, dP, dS and the dQ accumulator live in registers (the
//   accumulator layout of dS is the A operand of dS.K). The heaviest Q
//   blocks are scheduled first under the causal mask.
// - K3: one CTA of 4 warps per (b, KV head, 64-row KV block); each warp
//   owns 16 KV rows. It loops over the G query heads that share the KV
//   head and, for each, over 32-row Q tiles from the causal diagonal down,
//   so the GQA group sum happens in registers: no (B, Hq, S, D) buffers, no
//   atomics, deterministic results (the TPU kernel writes per-q-head dK/dV
//   and sums the group outside, flash_bwd.py:345-351). It computes the
//   transposed scores S^T = K.Q^T directly, whose accumulator layout is the
//   A operand of P^T.dO and dS^T.Q. The 32-row Q tile keeps the two fp32
//   D-wide accumulators plus S^T and dP^T inside the register budget.
//   At D = 256 the two accumulators alone would be 256 fp32 a thread, past
//   the 255-register cap: two CTAs share each KV block, each recomputing
//   S^T and dP^T over the full D from shared memory and owning half of the
//   dK / dV columns (128 accumulators a thread). Recomputing is the cheaper
//   of the choices: two passes (dV, then dK) would recompute the same
//   products, and 8 KV rows a warp would halve the m16 MMA's rows. K2 keeps
//   its 128-float dQ accumulator a thread at D = 256 unsplit.
//
// TMA, wgmma, cp.async pipelining and ldmatrix loads are later work
// (ROADMAP queue 2). The window mode of the TPU kernels is not ported
// (the wrapper refuses it).
#include "common.cuh"

namespace {

using qa::load_a_frag;
using qa::load_b_nn;
using qa::load_b_nt;
using qa::mma_bf16;
using qa::pack_bf16;

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kPad = 8;    // bf16 elements of row padding (bank spread)
constexpr int kBQ2 = 64;   // K2: Q rows per CTA (16 per warp)
constexpr int kBN2 = 64;   // K2: KV rows per tile
constexpr int kBN3 = 64;   // K3: KV rows per CTA (16 per warp)
constexpr int kBQ3 = 32;   // K3: Q rows per tile

template <int D>
constexpr size_t dq_smem_bytes() {
  return sizeof(__nv_bfloat16) * (2 * kBQ2 + 2 * kBN2) * (D + kPad);
}

// CTAs that share one K3 KV block, each owning D / splits dK / dV columns.
template <int D>
constexpr int kDkvSplits = D > 128 ? 2 : 1;

template <int D>
constexpr size_t dkv_smem_bytes() {
  return sizeof(__nv_bfloat16) * (2 * kBN3 + 2 * kBQ3) * (D + kPad) + sizeof(float) * 3 * kBQ3;
}

// Row statistics of Q row `row` (padded rows: l = 0, so P = 0).
__device__ __forceinline__ void row_stats(const float* m, const float* l, const float* delta,
                                          size_t base, int row, int Sq, float& mr, float& lr_inv,
                                          float& dr) {
  mr = 0.f;
  lr_inv = 0.f;
  dr = 0.f;
  if (row < Sq) {
    const float lv = l[base + row];
    mr = m[base + row];
    lr_inv = lv == 0.f ? 0.f : 1.f / lv;
    dr = delta[base + row];
  }
}

__device__ __forceinline__ void store2(void* p, int code, size_t idx, float x0, float x1) {
  if (code == qa::kF16) {
    *reinterpret_cast<__half2*>(static_cast<__half*>(p) + idx) = __floats2half2_rn(x0, x1);
  } else {
    *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(p) + idx) =
        __floats2bfloat162_rn(x0, x1);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const void* __restrict__ q, const void* __restrict__ k,
                    const void* __restrict__ v, const void* __restrict__ dout,
                    const float* __restrict__ m, const float* __restrict__ l,
                    const float* __restrict__ delta, void* __restrict__ dq, int Hq,
                    int Hkv, int Sq, int Skv, int code, int causal, float score_scale,
                    float sm_scale) {
  constexpr int kStride = D + kPad;
  constexpr int kNT = kBN2 / 8;  // 8-column score tiles per KV tile
  constexpr int kDT = D / 8;     // 8-column dQ tiles
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* dOs = Qs + kBQ2 * kStride;
  __nv_bfloat16* Ks = dOs + kBQ2 * kStride;
  __nv_bfloat16* Vs = Ks + kBN2 * kStride;

  // Under the causal mask the last Q blocks see the most KV tiles: run them first.
  const int mb = causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int hq = blockIdx.y, b = blockIdx.z;
  const int hk = hq / (Hq / Hkv);
  const int q0 = mb * kBQ2;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const size_t q_base = static_cast<size_t>(b * Hq + hq) * Sq * D;
  const size_t kv_base = static_cast<size_t>(b * Hkv + hk) * Skv * D;
  const size_t r_base = static_cast<size_t>(b * Hq + hq) * Sq;

  const int row0 = q0 + warp * 16 + g, row1 = row0 + 8;
  float m0, li0, d0, m1, li1, d1;
  row_stats(m, l, delta, r_base, row0, Sq, m0, li0, d0);
  row_stats(m, l, delta, r_base, row1, Sq, m1, li1, d1);

  qa::load_tile<kBQ2, D, kThreads, kPad>(Qs, q, code, q_base, q0, Sq);
  qa::load_tile<kBQ2, D, kThreads, kPad>(dOs, dout, code, q_base, q0, Sq);
  const __nv_bfloat16* Qw = Qs + warp * 16 * kStride;
  const __nv_bfloat16* dOw = dOs + warp * 16 * kStride;

  float acc[kDT][4];
#pragma unroll
  for (int j = 0; j < kDT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  const int kv_end = causal ? min(Skv, q0 + kBQ2) : Skv;
  for (int n0 = 0; n0 < kv_end; n0 += kBN2) {
    __syncthreads();  // the previous tile is no longer read
    qa::load_tile<kBN2, D, kThreads, kPad>(Ks, k, code, kv_base, n0, Skv);
    qa::load_tile<kBN2, D, kThreads, kPad>(Vs, v, code, kv_base, n0, Skv);
    __syncthreads();

    // S = Q.K^T and dP = dO.V^T: 16 rows x 64 columns per warp.
    float s[kNT][4], dp[kNT][4];
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      dp[j][0] = dp[j][1] = dp[j][2] = dp[j][3] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t aq[4], ado[4];
      load_a_frag(aq, Qw, kStride, kk, g, t);
      load_a_frag(ado, dOw, kStride, kk, g, t);
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        uint32_t b0, b1;
        load_b_nt(b0, b1, Ks, kStride, j, kk, g, t);
        mma_bf16(s[j], aq, b0, b1);
        load_b_nt(b0, b1, Vs, kStride, j, kk, g, t);
        mma_bf16(dp[j], ado, b0, b1);
      }
    }

    // P from the saved (m, l), then dS = P o (dP - D), kept in s.
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = n0 + j * 8 + t * 2 + e;
        const bool in = col < Skv;
        const float p0 = in && (!causal || col <= row0) && li0 != 0.f
            ? exp2f(s[j][e] * score_scale - m0) * li0 : 0.f;
        const float p1 = in && (!causal || col <= row1) && li1 != 0.f
            ? exp2f(s[j][2 + e] * score_scale - m1) * li1 : 0.f;
        s[j][e] = p0 * (dp[j][e] - d0);
        s[j][2 + e] = p1 * (dp[j][2 + e] - d1);
      }
    }

    // dQ += dS.K: the dS accumulators of tiles 2kk, 2kk+1 are the A operand.
#pragma unroll
    for (int kk = 0; kk < kBN2 / 16; ++kk) {
      uint32_t a[4];
      a[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      a[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      a[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      a[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int j = 0; j < kDT; ++j) {
        uint32_t b0, b1;
        load_b_nn(b0, b1, Ks, kStride, j, kk, g, t);
        mma_bf16(acc[j], a, b0, b1);
      }
    }
  }

#pragma unroll
  for (int j = 0; j < kDT; ++j) {
    const int c = j * 8 + t * 2;
    if (row0 < Sq)
      store2(dq, code, q_base + static_cast<size_t>(row0) * D + c, acc[j][0] * sm_scale,
             acc[j][1] * sm_scale);
    if (row1 < Sq)
      store2(dq, code, q_base + static_cast<size_t>(row1) * D + c, acc[j][2] * sm_scale,
             acc[j][3] * sm_scale);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const void* __restrict__ q, const void* __restrict__ k,
                     const void* __restrict__ v, const void* __restrict__ dout,
                     const float* __restrict__ m, const float* __restrict__ l,
                     const float* __restrict__ delta, void* __restrict__ dk,
                     void* __restrict__ dv, int Hq, int Hkv, int Sq, int Skv, int code,
                     int causal, float score_scale, float sm_scale) {
  constexpr int kStride = D + kPad;
  constexpr int kNT = kBQ3 / 8;                // 8-column tiles of S^T per Q tile
  constexpr int kDT = D / kDkvSplits<D> / 8;  // 8-column dK / dV tiles this CTA owns
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Vs = Ks + kBN3 * kStride;
  __nv_bfloat16* Qs = Vs + kBN3 * kStride;
  __nv_bfloat16* dOs = Qs + kBQ3 * kStride;
  float* m_s = reinterpret_cast<float*>(dOs + kBQ3 * kStride);
  float* li_s = m_s + kBQ3;
  float* d_s = li_s + kBQ3;

  const int nb = blockIdx.x / kDkvSplits<D>, hk = blockIdx.y, b = blockIdx.z;
  const int jt0 = (blockIdx.x % kDkvSplits<D>) * kDT;  // this CTA's first output tile
  const int group = Hq / Hkv;
  const int n0 = nb * kBN3;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const size_t kv_base = static_cast<size_t>(b * Hkv + hk) * Skv * D;
  const int kv0 = n0 + warp * 16 + g, kv1 = kv0 + 8;  // this thread's two KV rows

  qa::load_tile<kBN3, D, kThreads, kPad>(Ks, k, code, kv_base, n0, Skv);
  qa::load_tile<kBN3, D, kThreads, kPad>(Vs, v, code, kv_base, n0, Skv);
  const __nv_bfloat16* Kw = Ks + warp * 16 * kStride;
  const __nv_bfloat16* Vw = Vs + warp * 16 * kStride;

  float dk_acc[kDT][4], dv_acc[kDT][4];
#pragma unroll
  for (int j = 0; j < kDT; ++j) {
    dk_acc[j][0] = dk_acc[j][1] = dk_acc[j][2] = dk_acc[j][3] = 0.f;
    dv_acc[j][0] = dv_acc[j][1] = dv_acc[j][2] = dv_acc[j][3] = 0.f;
  }

  // Top-left causal: Q rows above n0 see none of this block's columns.
  const int q_begin = causal ? (n0 / kBQ3) * kBQ3 : 0;
  for (int h = 0; h < group; ++h) {
    const int hq = hk * group + h;
    const size_t q_base = static_cast<size_t>(b * Hq + hq) * Sq * D;
    const size_t r_base = static_cast<size_t>(b * Hq + hq) * Sq;
    for (int q0 = q_begin; q0 < Sq; q0 += kBQ3) {
      __syncthreads();  // the previous Q tile is no longer read
      qa::load_tile<kBQ3, D, kThreads, kPad>(Qs, q, code, q_base, q0, Sq);
      qa::load_tile<kBQ3, D, kThreads, kPad>(dOs, dout, code, q_base, q0, Sq);
      for (int i = threadIdx.x; i < kBQ3; i += kThreads)
        row_stats(m, l, delta, r_base, q0 + i, Sq, m_s[i], li_s[i], d_s[i]);
      __syncthreads();

      // S^T = K.Q^T and dP^T = V.dO^T: 16 KV rows x 32 Q columns per warp.
      float st[kNT][4], dpt[kNT][4];
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        st[j][0] = st[j][1] = st[j][2] = st[j][3] = 0.f;
        dpt[j][0] = dpt[j][1] = dpt[j][2] = dpt[j][3] = 0.f;
      }
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t ak[4], av[4];
        load_a_frag(ak, Kw, kStride, kk, g, t);
        load_a_frag(av, Vw, kStride, kk, g, t);
#pragma unroll
        for (int j = 0; j < kNT; ++j) {
          uint32_t b0, b1;
          load_b_nt(b0, b1, Qs, kStride, j, kk, g, t);
          mma_bf16(st[j], ak, b0, b1);
          load_b_nt(b0, b1, dOs, kStride, j, kk, g, t);
          mma_bf16(dpt[j], av, b0, b1);
        }
      }

      // P^T (kept in st) and dS^T = P^T o (dP^T - D) (kept in dpt).
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int cl = j * 8 + t * 2 + e;
          const int qc = q0 + cl;
          const float mq = m_s[cl], liq = li_s[cl], dq_ = d_s[cl];
          const bool qin = liq != 0.f;  // zero for padded Q rows
          const float p0 = qin && kv0 < Skv && (!causal || kv0 <= qc)
              ? exp2f(st[j][e] * score_scale - mq) * liq : 0.f;
          const float p1 = qin && kv1 < Skv && (!causal || kv1 <= qc)
              ? exp2f(st[j][2 + e] * score_scale - mq) * liq : 0.f;
          st[j][e] = p0;
          st[j][2 + e] = p1;
          dpt[j][e] = p0 * (dpt[j][e] - dq_);
          dpt[j][2 + e] = p1 * (dpt[j][2 + e] - dq_);
        }
      }

      // dV += P^T.dO and dK += dS^T.Q (the depth is the 32 Q rows).
#pragma unroll
      for (int kk = 0; kk < kBQ3 / 16; ++kk) {
        uint32_t pa[4], sa[4];
        pa[0] = pack_bf16(st[2 * kk][0], st[2 * kk][1]);
        pa[1] = pack_bf16(st[2 * kk][2], st[2 * kk][3]);
        pa[2] = pack_bf16(st[2 * kk + 1][0], st[2 * kk + 1][1]);
        pa[3] = pack_bf16(st[2 * kk + 1][2], st[2 * kk + 1][3]);
        sa[0] = pack_bf16(dpt[2 * kk][0], dpt[2 * kk][1]);
        sa[1] = pack_bf16(dpt[2 * kk][2], dpt[2 * kk][3]);
        sa[2] = pack_bf16(dpt[2 * kk + 1][0], dpt[2 * kk + 1][1]);
        sa[3] = pack_bf16(dpt[2 * kk + 1][2], dpt[2 * kk + 1][3]);
#pragma unroll
        for (int j = 0; j < kDT; ++j) {
          uint32_t b0, b1;
          load_b_nn(b0, b1, dOs, kStride, jt0 + j, kk, g, t);
          mma_bf16(dv_acc[j], pa, b0, b1);
          load_b_nn(b0, b1, Qs, kStride, jt0 + j, kk, g, t);
          mma_bf16(dk_acc[j], sa, b0, b1);
        }
      }
    }
  }

#pragma unroll
  for (int j = 0; j < kDT; ++j) {
    const int c = (jt0 + j) * 8 + t * 2;
    if (kv0 < Skv) {
      const size_t idx = kv_base + static_cast<size_t>(kv0) * D + c;
      store2(dk, code, idx, dk_acc[j][0] * sm_scale, dk_acc[j][1] * sm_scale);
      store2(dv, code, idx, dv_acc[j][0], dv_acc[j][1]);
    }
    if (kv1 < Skv) {
      const size_t idx = kv_base + static_cast<size_t>(kv1) * D + c;
      store2(dk, code, idx, dk_acc[j][2] * sm_scale, dk_acc[j][3] * sm_scale);
      store2(dv, code, idx, dv_acc[j][2], dv_acc[j][3]);
    }
  }
}

template <typename Kernel>
int set_smem(Kernel kernel, size_t bytes) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes)));
}

template <int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout, const float* m,
              const float* l, const float* delta, void* dq, int B, int Hq, int Hkv, int Sq,
              int Skv, int code, int causal, float score_scale, float sm_scale,
              cudaStream_t stream) {
  constexpr size_t smem = dq_smem_bytes<D>();
  if (int err = set_smem(flash_bwd_dq_kernel<D>, smem)) return err;
  dim3 grid((Sq + kBQ2 - 1) / kBQ2, Hq, B);
  flash_bwd_dq_kernel<D><<<grid, kThreads, smem, stream>>>(
      q, k, v, dout, m, l, delta, dq, Hq, Hkv, Sq, Skv, code, causal, score_scale, sm_scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout, const float* m,
               const float* l, const float* delta, void* dk, void* dv, int B, int Hq, int Hkv,
               int Sq, int Skv, int code, int causal, float score_scale, float sm_scale,
               cudaStream_t stream) {
  constexpr size_t smem = dkv_smem_bytes<D>();
  if (int err = set_smem(flash_bwd_dkv_kernel<D>, smem)) return err;
  dim3 grid((Skv + kBN3 - 1) / kBN3 * kDkvSplits<D>, Hkv, B);
  flash_bwd_dkv_kernel<D><<<grid, kThreads, smem, stream>>>(
      q, k, v, dout, m, l, delta, dk, dv, Hq, Hkv, Sq, Skv, code, causal, score_scale,
      sm_scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Shared by both entries: q, dout (B, Hq, Sq, D) and k, v (B, Hkv, Skv, D)
// contiguous, 16-byte aligned, all of element type `code` (bf16 or fp16);
// m, l, delta (B, Hq, Sq) fp32; score_scale = sm_scale * log2(e), the fold
// under which m and l were saved. D is 64, 128 or 256.
extern "C" int qa_flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                               const void* m, const void* l, const void* delta, void* dq,
                               int B, int Hq, int Hkv, int Sq, int Skv, int D, int code,
                               int causal, float score_scale, float sm_scale, void* stream) {
  const float* mf = static_cast<const float*>(m);
  const float* lf = static_cast<const float*>(l);
  const float* df = static_cast<const float*>(delta);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Sq == 0 || B == 0) return 0;
  switch (D) {
    case 64:
      return launch_dq<64>(q, k, v, dout, mf, lf, df, dq, B, Hq, Hkv, Sq, Skv, code, causal,
                           score_scale, sm_scale, s);
    case 128:
      return launch_dq<128>(q, k, v, dout, mf, lf, df, dq, B, Hq, Hkv, Sq, Skv, code, causal,
                            score_scale, sm_scale, s);
    case 256:
      return launch_dq<256>(q, k, v, dout, mf, lf, df, dq, B, Hq, Hkv, Sq, Skv, code, causal,
                            score_scale, sm_scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int qa_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                                const void* m, const void* l, const void* delta, void* dk,
                                void* dv, int B, int Hq, int Hkv, int Sq, int Skv, int D,
                                int code, int causal, float score_scale, float sm_scale,
                                void* stream) {
  const float* mf = static_cast<const float*>(m);
  const float* lf = static_cast<const float*>(l);
  const float* df = static_cast<const float*>(delta);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Skv == 0 || B == 0) return 0;
  switch (D) {
    case 64:
      return launch_dkv<64>(q, k, v, dout, mf, lf, df, dk, dv, B, Hq, Hkv, Sq, Skv, code,
                            causal, score_scale, sm_scale, s);
    case 128:
      return launch_dkv<128>(q, k, v, dout, mf, lf, df, dk, dv, B, Hq, Hkv, Sq, Skv, code,
                             causal, score_scale, sm_scale, s);
    case 256:
      return launch_dkv<256>(q, k, v, dout, mf, lf, df, dk, dv, B, Hq, Hkv, Sq, Skv, code,
                             causal, score_scale, sm_scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
