// Shared helpers of the hand-written kernels: the dtype codes of
// ops/_native.py (0 bf16, 1 fp16, 2 e4m3, 3 int8; 4 fp32 as an output
// only), the attention kernels' instantiated widths, the mma.sync fragment
// helpers, the quantized weight helpers, the tail product's interface
// (csrc/tail.cu) that K8 and K9 share, and the K5/K6/K7 product's
// (csrc/qgemm.cu).
#pragma once

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>

namespace qa {

// -0.7 * FLT_MAX: the JAX package's MASK_VALUE (ops/flash.py:52). A masked
// logit flushes exp2 to 0 without the NaN of (-inf) - (-inf).
constexpr float kMaskValue = -0.7f * 3.402823466e38f;

enum ElemCode { kBF16 = 0, kF16 = 1, kE4M3 = 2, kI8 = 3, kF32 = 4 };

// The instantiated width of the attention kernels (K1, K2, K3, K4, K10) that a
// runtime head dim D rounds up to: 64, 128, 256 or 512 (whose output
// columns CTAs share); 0 when D is not a multiple of 8 in 8..512.
inline int kernel_width(int D) {
  if (D <= 0 || D % 8 != 0 || D > 512) return 0;
  return D <= 64 ? 64 : D <= 128 ? 128 : D <= 256 ? 256 : 512;
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// ---------------------------------------------------------------------------
// mma.sync helpers (K5-K10).
//
// m16n8k16 fragments, lane = 4 * g + t: an accumulator tile C (16 x 8)
// holds c[0..1] at row g, columns 2t, 2t+1 and c[2..3] at row g + 8. The
// A operand (16 x 16, row-major) holds a[0] = A[g][2t..2t+1],
// a[1] = A[g+8][2t..], a[2] = A[g][2t+8..], a[3] = A[g+8][2t+8..]; so the
// accumulators of two neighbouring 8-column tiles are, packed to bf16, the
// A operand of the next product (no trip through shared memory).
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// D = A(16x16 bf16, row) * B(16x8 bf16, col) + C, fp32 accumulate.
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_f16(float lo, float hi) {
  __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// D = A(16x16 fp16, row) * B(16x8 fp16, col) + C, fp32 accumulate.
__device__ __forceinline__ void mma_f16(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four int8 (byte i of v is element i) -> bf16 pairs (0, 1) and (2, 3),
// exactly, on the integer and fp32 pipes: each byte, offset to unsigned,
// becomes the low mantissa byte of 2^23 (0x4B000000 + u), minus 2^23 + 128
// gives the integer as a float, and a float holding an integer of at most
// 8 significant bits is its bf16 in the upper half. No I2F or F2F
// conversion instruction is issued.
__device__ __forceinline__ void i8x4_to_bf16(uint32_t v, uint32_t& lo, uint32_t& hi) {
  const uint32_t u = v ^ 0x80808080u;
  const float f0 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540)) - 8388736.f;
  const float f1 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7541)) - 8388736.f;
  const float f2 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7542)) - 8388736.f;
  const float f3 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7543)) - 8388736.f;
  lo = __byte_perm(__float_as_uint(f0), __float_as_uint(f1), 0x7632);
  hi = __byte_perm(__float_as_uint(f2), __float_as_uint(f3), 0x7632);
}

// Eight consecutive elements (any input code) -> eight bf16 in a uint4.
__device__ __forceinline__ uint4 load8_bf16(const void* p, int code, size_t i) {
  float f[8];
  if (code == kBF16) {
    return *reinterpret_cast<const uint4*>(static_cast<const __nv_bfloat16*>(p) + i);
  } else if (code == kF16) {
    const uint4 u = *reinterpret_cast<const uint4*>(static_cast<const __half*>(p) + i);
    const __half* h = reinterpret_cast<const __half*>(&u);
#pragma unroll
    for (int e = 0; e < 8; ++e) f[e] = __half2float(h[e]);
  } else {
    const uint2 u = *reinterpret_cast<const uint2*>(static_cast<const unsigned char*>(p) + i);
    const unsigned char* c = reinterpret_cast<const unsigned char*>(&u);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      if (code == kE4M3) {
        __nv_fp8_e4m3 x;
        x.__x = c[e];
        f[e] = static_cast<float>(x);
      } else {
        f[e] = static_cast<float>(static_cast<signed char>(c[e]));
      }
    }
  }
  uint4 out;
  out.x = pack_bf16(f[0], f[1]);
  out.y = pack_bf16(f[2], f[3]);
  out.z = pack_bf16(f[4], f[5]);
  out.w = pack_bf16(f[6], f[7]);
  return out;
}

// A operand of rows 0..15 of a bf16 smem tile (row stride `stride`),
// columns 16 kk .. 16 kk + 15.
__device__ __forceinline__ void load_a_frag(uint32_t* a, const __nv_bfloat16* tile, int stride,
                                            int kk, int g, int t) {
  const int c = kk * 16 + t * 2;
  a[0] = *reinterpret_cast<const uint32_t*>(tile + g * stride + c);
  a[1] = *reinterpret_cast<const uint32_t*>(tile + (g + 8) * stride + c);
  a[2] = *reinterpret_cast<const uint32_t*>(tile + g * stride + c + 8);
  a[3] = *reinterpret_cast<const uint32_t*>(tile + (g + 8) * stride + c + 8);
}

// ---------------------------------------------------------------------------
// Quantized weights (K5-K8). int8 codes convert to bf16 exactly. A packed
// int4 byte of row r in 256-row block g holds original row 256g + r in its
// low nibble and 256g + 128 + r in its high nibble
// (models/quantized.pack_int4_rows); the nibble times its fp32 group scale
// is rounded to bf16 (ops/qmm.py:99-115 of the JAX package).
// ---------------------------------------------------------------------------

__device__ __forceinline__ float int4_lo(unsigned char b) {
  return static_cast<float>(static_cast<signed char>(b << 4) >> 4);
}

__device__ __forceinline__ float int4_hi(unsigned char b) {
  return static_cast<float>(static_cast<signed char>(b) >> 4);
}

// 16 bytes from device memory to shared memory, asynchronously; zeros
// when !valid (the source is then not read).
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(gmem), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// A quantized (K, N) matrix: int8 codes with N fp32 column scales, or
// packed int4 codes (K/2, N) with (K/128, N) fp32 group scales.
struct QMat {
  const void* q;
  const float* s;
  int int4;
};

// The tail product of K8 and K9 (csrc/tail.cu). Units of 128 weight
// columns by 128 unpacked rows; activation rows rounded up to a width of
// 8..256 (0: more rows than the tail takes).
constexpr int kTailBN = 128;
constexpr int kTailKB = 128;
constexpr int kTailMaxRows = 256;

// The persistent schedule of a product (ops/qmlp.tail_schedule in Python):
// min(tail_ctas_per_sm(width) * SMs, units) CTAs; units u = tile * kblocks
// + kblock; CTA c takes `base` units, plus one when c < rem, from c * base
// + min(c, rem) on.
struct TailSched {
  int tiles, kblocks, ctas, base, rem;
};

int num_sms();
int tail_width(int M);
// CTAs an SM at activation width `width`: 2 up to 64, else 1.
int tail_ctas_per_sm(int width);
TailSched tail_schedule(int M, int N, int K, int sms);
// fp32 entries of one product's partial sums: a (M, 128) slab per slot.
size_t tail_partial_floats(int M, int N, int K);
// The product of x (M, K) bf16 and w (K, N): fp32 partial sums of each
// (CTA, column tile) into `partial`; *sched receives its schedule.
cudaError_t tail_product(const __nv_bfloat16* x, QMat w, int M, int N, int K, float* partial,
                         TailSched* sched, cudaStream_t stream);
// out (M, N) bf16 = the product's sums, times scale (nullable), cast once.
cudaError_t tail_reduce_out(const float* partial, const TailSched& sched, const float* scale,
                            __nv_bfloat16* out, int M, int N, cudaStream_t stream);

// K8's stages, shared with K9 (csrc/megastep.cu): with attn, x1 = x +
// cast(attn @ wo) (else x1 = x), h = RMSNorm(x1); act = SwiGLU of h @
// w_gate_up; out = x1 + cast(act @ w_down); with w_qkv, the next layer's
// RMSNorm and QKV -> qkv_out. Every product runs on the tail product, every
// reduction in a fixed order. Adds the kernels it launched to *launched.
cudaError_t layer_tail(const __nv_bfloat16* x, const __nv_bfloat16* attn, QMat wo, const float* norm,
                       QMat gu, QMat wd, const float* next_norm, QMat wqkv, __nv_bfloat16* out,
                       __nv_bfloat16* qkv_out, __nv_bfloat16* x1, __nv_bfloat16* h,
                       __nv_bfloat16* act, float* partial, int M, int E, int Q, int I, int F,
                       float eps, int* launched, cudaStream_t stream);
// fp32 entries of `partial` that layer_tail needs (Q = 0: no wo product).
size_t layer_tail_workspace(int M, int E, int Q, int I, int F);

// The register-A product of K5, K6 and K7 (csrc/qgemm.cu). Up to
// kQgemmRows activation rows run stream-K over (128-column tile, 128-row
// k-block) units, rows rounded up to a width of 8..128, their fp32 partial
// sums reduced by tail_reduce_out; more rows run whole (256-column,
// 128-row) output tiles. ops/qmm.qgemm_schedule is the same schedule in
// Python.
constexpr int kQgemmRows = 128;

struct QgemmSched {
  int whole;                // 1: whole output tiles; 0: stream-K
  int width;                // wgmma N: 8..128
  int row_tiles, col_tiles;  // output tiles (stream-K: one row tile, 128-column tiles)
  TailSched sk;             // stream-K: units, CTAs and shares; whole: kblocks and CTAs
};

// CTAs an SM: 4 at widths up to 32, 2 at 64 and 128 (stream-K), 1 (whole tiles).
int qgemm_ctas_per_sm(int width, bool whole);
QgemmSched qgemm_schedule(int M, int N, int K, int sms);
// fp32 entries of the stream-K partial sums (0 for whole tiles).
size_t qgemm_partial_floats(int M, int N, int K);
// The weight column (of a consumer's 128) that row r of m64 tile mt of the
// product holds: thread (warp w, lane 4g + t) owns rows 16w + g and 16w + g
// + 8 of both tiles, the four columns 4(8w + g) .. + 3.
__host__ __device__ inline int qgemm_column(int mt, int r) {
  return 4 * (8 * (r >> 4) + (r & 7)) + 2 * mt + ((r >> 3) & 1);
}
// out (M, N) bf16 = x (M, K) bf16 @ w, int8 scaled per column or int4;
// `partial` holds qgemm_partial_floats entries (null for whole tiles).
cudaError_t qgemm(const __nv_bfloat16* x, QMat w, int M, int N, int K, float* partial,
                  __nv_bfloat16* out, cudaStream_t stream);

}  // namespace qa
