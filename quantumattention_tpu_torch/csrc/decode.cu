// K4: one-token GQA decode attention over a ragged slot cache (sm_90a).
//
// Replaces the Pallas kernel quantumattention_tpu/ops/decode.py::_decode_kernel
// (decode.py:56; host entry decode_attention, decode.py:321). Same math:
// scores q.k (int8 K taken as its integer value) times sm_scale * log2(e)
// times the token's K scale, exp2-domain online softmax in fp32, P times the
// token's V scale rounded to bf16 for P.V with fp32 accumulation, a bf16
// output, and exact zeros for a slot of length 0 (the engine decodes over
// every slot, active or not).
//
// What bounds it on the H100: bytes. Each step reads every valid cache row
// of K and V once (1 byte per element for int8) and does only 4*G*D flops
// per row, far below the card's ~295 flops/byte balance point. So each K/V
// tile is read once for the whole GQA group: a CTA holds the G query heads
// that share one KV head and loads 64-row K/V tiles into shared memory
// (dequantization folded into the scores and P). The TPU kernel walks the
// sequence in one grid dimension; here the rows of a slot are split into
// chunks of kChunk rows, one CTA per (KV head, slot, chunk), so a few slots
// x 8 KV heads still fill the card's 132 SMs (split-KV, "flash decoding").
// Chunks at or past lengths[slot] exit at once. A second, small kernel
// merges the chunks' (max, sum, accumulator) partials with the same exp2
// rescaling as the online softmax.
#include "common.cuh"

namespace {

constexpr int kBN = 64;       // rows per shared-memory tile
constexpr int kChunk = 256;   // rows per CTA
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

size_t smem_bytes(int G, int D) {
  return sizeof(float) * (static_cast<size_t>(G) * D      // q
                          + kBN * (D + 1)                   // K tile, padded rows
                          + kBN * D                         // V tile
                          + G * kBN                         // scores / P
                          + G * D                           // accumulator
                          + 3 * G);                         // m, l, alpha
}

// Four consecutive cache elements as floats (16-byte aligned rows, D % 4 == 0).
__device__ __forceinline__ void load4(const void* p, int code, size_t i, float* out) {
  if (code == qa::kI8) {
    const char4 c = *reinterpret_cast<const char4*>(static_cast<const signed char*>(p) + i);
    out[0] = c.x; out[1] = c.y; out[2] = c.z; out[3] = c.w;
  } else {
    const uint2 u = *reinterpret_cast<const uint2*>(static_cast<const __nv_bfloat16*>(p) + i);
    const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&u.x);
    const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&u.y);
    out[0] = __low2float(lo); out[1] = __high2float(lo);
    out[2] = __low2float(hi); out[3] = __high2float(hi);
  }
}

__global__ void __launch_bounds__(kThreads)
decode_chunk_kernel(const __nv_bfloat16* __restrict__ q, const void* __restrict__ k,
                    const void* __restrict__ v, const float* __restrict__ k_scale,
                    const float* __restrict__ v_scale, const int* __restrict__ lengths,
                    float* __restrict__ part_acc, float* __restrict__ part_ml,
                    int Hq, int Hkv, int Smax, int D, int kv_code, float score_scale) {
  extern __shared__ __align__(16) float sm[];
  const int G = Hq / Hkv;
  const int h = blockIdx.x, b = blockIdx.y, split = blockIdx.z;
  const int nsplit = gridDim.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  float* qs = sm;
  float* kt = qs + G * D;
  float* vt = kt + kBN * (D + 1);
  float* st = vt + kBN * D;
  float* acc = st + G * kBN;
  float* m = acc + G * D;
  float* l = m + G;
  float* alpha = l + G;

  const int len = min(lengths[b], Smax);
  const int start = split * kChunk;
  const int stop = min(len, start + kChunk);
  const size_t part = (static_cast<size_t>(b) * Hkv + h) * nsplit + split;
  if (start >= len) {
    for (int g = tid; g < G; g += kThreads) {
      part_ml[2 * (part * G + g)] = -INFINITY;
      part_ml[2 * (part * G + g) + 1] = 0.f;
    }
    return;
  }
  const size_t q_base = (static_cast<size_t>(b) * Hq + static_cast<size_t>(h) * G) * D;
  const size_t kv_base = (static_cast<size_t>(b) * Hkv + h) * Smax * D;
  const size_t sc_base = (static_cast<size_t>(b) * Hkv + h) * Smax;

  for (int i = tid; i < G * D; i += kThreads) {
    qs[i] = __bfloat162float(q[q_base + i]);
    acc[i] = 0.f;
  }
  for (int g = tid; g < G; g += kThreads) {
    m[g] = -INFINITY;
    l[g] = 0.f;
  }
  __syncthreads();

  for (int n0 = start; n0 < stop; n0 += kBN) {
    for (int i = tid * 4; i < kBN * D; i += kThreads * 4) {
      const int r = i / D, c = i % D;
      float kv4[4] = {0.f, 0.f, 0.f, 0.f}, vv4[4] = {0.f, 0.f, 0.f, 0.f};
      if (n0 + r < stop) {
        const size_t off = kv_base + static_cast<size_t>(n0 + r) * D + c;
        load4(k, kv_code, off, kv4);
        load4(v, kv_code, off, vv4);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        kt[r * (D + 1) + c + e] = kv4[e];
        vt[i + e] = vv4[e];
      }
    }
    __syncthreads();

    for (int i = tid; i < G * kBN; i += kThreads) {
      const int g = i / kBN, c = i % kBN, col = n0 + c;
      float s = 0.f;
      for (int d = 0; d < D; ++d) s += qs[g * D + d] * kt[c * (D + 1) + d];
      const bool ok = col < stop;
      const float ks = k_scale != nullptr && ok ? k_scale[sc_base + col] : 1.f;
      st[i] = ok ? s * score_scale * ks : qa::kMaskValue;
    }
    __syncthreads();

    for (int g = warp; g < G; g += kWarps) {
      float mx = qa::kMaskValue;
      for (int c = lane; c < kBN; c += 32) mx = fmaxf(mx, st[g * kBN + c]);
      for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_prev = m[g];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int c = lane; c < kBN; c += 32) {
        const int col = n0 + c;
        const float p = exp2f(st[g * kBN + c] - m_new);
        sum += p;
        const float vs = v_scale != nullptr && col < stop ? v_scale[sc_base + col] : 1.f;
        st[g * kBN + c] = qa::round_bf16(p * vs);
      }
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane == 0) {
        const float a = exp2f(m_prev - m_new);
        alpha[g] = a;
        l[g] = a * l[g] + sum;
        m[g] = m_new;
      }
    }
    __syncthreads();

    for (int i = tid; i < G * D; i += kThreads) {
      const int g = i / D, d = i % D;
      float a = acc[i] * alpha[g];
      for (int c = 0; c < kBN; ++c) a += st[g * kBN + c] * vt[c * D + d];
      acc[i] = a;
    }
    __syncthreads();  // tiles and P are rewritten next iteration
  }

  for (int i = tid; i < G * D; i += kThreads) part_acc[part * G * D + i] = acc[i];
  for (int g = tid; g < G; g += kThreads) {
    part_ml[2 * (part * G + g)] = m[g];
    part_ml[2 * (part * G + g) + 1] = l[g];
  }
}

// Merge the chunks of one (KV head, slot): O = sum_s 2^(m_s - M) acc_s /
// sum_s 2^(m_s - M) l_s, zeros for an empty slot.
__global__ void __launch_bounds__(kThreads)
decode_merge_kernel(const float* __restrict__ part_acc, const float* __restrict__ part_ml,
                    const int* __restrict__ lengths, __nv_bfloat16* __restrict__ out,
                    int Hq, int Hkv, int D, int nsplit) {
  const int G = Hq / Hkv;
  const int h = blockIdx.x, b = blockIdx.y;
  const size_t part0 = (static_cast<size_t>(b) * Hkv + h) * nsplit;
  const size_t q_base = (static_cast<size_t>(b) * Hq + static_cast<size_t>(h) * G) * D;
  const bool empty = lengths[b] <= 0;
  for (int i = threadIdx.x; i < G * D; i += kThreads) {
    const int g = i / D;
    float mx = -INFINITY;
    for (int s = 0; s < nsplit; ++s) mx = fmaxf(mx, part_ml[2 * ((part0 + s) * G + g)]);
    float num = 0.f, den = 0.f;
    if (mx != -INFINITY) {
      for (int s = 0; s < nsplit; ++s) {
        const float ls = part_ml[2 * ((part0 + s) * G + g) + 1];
        if (ls == 0.f) continue;
        const float w = exp2f(part_ml[2 * ((part0 + s) * G + g)] - mx);
        num += w * part_acc[(part0 + s) * G * D + i];
        den += w * ls;
      }
    }
    out[q_base + i] = __float2bfloat16_rn(!empty && den != 0.f ? num / den : 0.f);
  }
}

}  // namespace

extern "C" int qa_decode_num_splits(int Smax) { return (Smax + kChunk - 1) / kChunk; }

// q (B, Hq, D) bf16; k, v (B, Hkv, Smax, D) int8 (kv_code 3, with fp32
// token scales (B, Hkv, Smax)) or bf16 (kv_code 0, scales null);
// lengths (B,) int32; out (B, Hq, D) bf16; part_acc (B, Hkv, nsplit, G, D)
// and part_ml (B, Hkv, nsplit, G, 2) fp32 scratch, nsplit from
// qa_decode_num_splits. score_scale = sm_scale * log2(e).
extern "C" int qa_decode(const void* q, const void* k, const void* v,
                         const void* k_scale, const void* v_scale,
                         const void* lengths, void* out, void* part_acc,
                         void* part_ml, int B, int Hq, int Hkv, int Smax, int D,
                         int kv_code, float score_scale, void* stream) {
  if (B == 0) return 0;
  if (D % 4 != 0) return static_cast<int>(cudaErrorInvalidValue);
  const int nsplit = qa_decode_num_splits(Smax);
  const size_t smem = smem_bytes(Hq / Hkv, D);
  cudaError_t err = cudaFuncSetAttribute(
      decode_chunk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  decode_chunk_kernel<<<dim3(Hkv, B, nsplit), kThreads, smem, s>>>(
      static_cast<const __nv_bfloat16*>(q), k, v,
      static_cast<const float*>(k_scale), static_cast<const float*>(v_scale),
      static_cast<const int*>(lengths), static_cast<float*>(part_acc),
      static_cast<float*>(part_ml), Hq, Hkv, Smax, D, kv_code, score_scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  decode_merge_kernel<<<dim3(Hkv, B), kThreads, 0, s>>>(
      static_cast<const float*>(part_acc), static_cast<const float*>(part_ml),
      static_cast<const int*>(lengths), static_cast<__nv_bfloat16*>(out), Hq, Hkv,
      D, nsplit);
  return static_cast<int>(cudaGetLastError());
}
