// K8: fused quantized decoder-layer tail, sm_90a.
//
// Replaces the Pallas kernel quantumattention_tpu/ops/qmlp.py::_tail_kernel
// (qmlp.py:93; host fused_layer_tail, :294):
//   x1  = x + cast(attn @ wo)                  (optional)
//   h   = cast(x1 * rsqrt(mean(x1^2) + eps) * norm)
//   act = cast(silu(cast(h @ w_gate))) * cast(h @ w_up)      (in bf16)
//   out = x1 + cast(act @ w_down)
//   qkv = cast(rmsnorm(out, next_norm) @ w_qkv)              (optional)
// with each matrix int8 or int4 on its own, and the JAX kernel's rounding
// points (qmlp.py:123-153): every projection cast to bf16 before its
// residual add, x1/h/gate/up/act in bf16, the down product summed in fp32.
//
// What bounds it on the H100: bytes. At decode row counts every product
// is a weight stream (at Llama-3-8B widths wo 16.8 MB, w_gate_up 117 MB,
// w_down 58.7 MB, w_qkv 25.2 MB in int8, half in int4) with a few flops per
// byte; the activations are kilobytes.
//
// Design. The TPU kernel carries x1, h and an fp32 accumulator across a
// sequential grid over I-blocks in VMEM. On the H100 blocks run in
// parallel, and RMSNorm and the down product's sum over I are grid-wide
// dependencies, so qa_layer_tail runs a fixed sequence of kernels on one
// stream, with no host work between them:
//   (a) the wo product (csrc/qmm.cu's quantized tile kernel, split-K fp32
//       partials), then one CTA per row sums the partials in order, scales,
//       casts, adds x, and applies RMSNorm -> x1, h;
//   (b) the gate/up product (partials) -> silu(gate) * up -> act;
//   (c) the down product over I (split-K partials), then the row kernel
//       sums them in order, adds x1 -> out, and, with a fold, applies the
//       next layer's RMSNorm -> h';
//   (d) optionally h' @ w_qkv -> qkv.
// Stages (a)'s row kernel through (d) are qa::layer_tail_stages, which K9
// (csrc/megastep.cu) also runs after its attention + wo kernel.
// Five to eight launches a tail (qa_layer_tail reports the count); every
// product streams its weights through the shared quantized tile kernel
// (K5/K7's), split over K where the output tiles are fewer than the SMs. A
// single persistent cooperative kernel is later work.
#include <algorithm>

#include "common.cuh"

namespace {

constexpr int kRowThreads = 256;
constexpr int kActThreads = 256;

// One CTA per row m. With `partial`: x1 = cast(resid + cast(sum_z
// partial[z][m] * scale)) is written to x1_out; without: x1 = resid. With
// `norm`: h = cast(x1 * rsqrt(mean(x1^2) + eps) * norm) -> h_out.
__global__ void __launch_bounds__(kRowThreads)
residual_norm_kernel(const float* __restrict__ partial, int splits, const float* __restrict__ scale,
                     const __nv_bfloat16* __restrict__ resid, __nv_bfloat16* __restrict__ x1_out,
                     const float* __restrict__ norm, float eps, __nv_bfloat16* __restrict__ h_out,
                     int M, int E) {
  __shared__ float red[kRowThreads / 32];
  const int m = blockIdx.x;
  const size_t row = static_cast<size_t>(m) * E;
  float ss = 0.f;
  for (int n = threadIdx.x; n < E; n += kRowThreads) {
    float v = __bfloat162float(resid[row + n]);
    if (partial != nullptr) {
      float acc = 0.f;
      for (int z = 0; z < splits; ++z) acc += partial[(static_cast<size_t>(z) * M + m) * E + n];
      if (scale != nullptr) acc *= scale[n];
      v = qa::round_bf16(v + qa::round_bf16(acc));
      x1_out[row + n] = __float2bfloat16_rn(v);
    }
    ss += v * v;
  }
  if (norm == nullptr) return;  // uniform over the CTA
  for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = ss;
  __syncthreads();
  float total = 0.f;
  for (int i = 0; i < kRowThreads / 32; ++i) total += red[i];
  const float rstd = rsqrtf(total / E + eps);
  const __nv_bfloat16* x1 = partial != nullptr ? x1_out : resid;
  for (int n = threadIdx.x; n < E; n += kRowThreads) {
    // Each thread reads back the x1 entries it wrote itself.
    h_out[row + n] = __float2bfloat16_rn(__bfloat162float(x1[row + n]) * rstd * norm[n]);
  }
}

// act[m][n] = cast(cast(silu(g)) * u), g and u the bf16-cast sums (times
// their int8 column scales) of columns n and I + n of the gate/up product.
__global__ void __launch_bounds__(kActThreads)
swiglu_kernel(const float* __restrict__ partial, int splits, const float* __restrict__ scale,
              __nv_bfloat16* __restrict__ act, int M, int I) {
  const size_t total = static_cast<size_t>(M) * I;
  const size_t slab = 2 * total;  // one split's (M, 2I) partial sums
  for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x; i < total;
       i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    const size_t m = i / I;
    const int n = static_cast<int>(i % I);
    const size_t gi = m * 2 * I + n;
    float g = 0.f, u = 0.f;
    for (int z = 0; z < splits; ++z) {
      g += partial[z * slab + gi];
      u += partial[z * slab + gi + I];
    }
    if (scale != nullptr) {
      g *= scale[n];
      u *= scale[I + n];
    }
    const float gb = qa::round_bf16(g), ub = qa::round_bf16(u);
    const float a = qa::round_bf16(gb / (1.f + expf(-gb)));
    act[i] = __float2bfloat16_rn(a * ub);
  }
}

int grid_for(size_t n, int threads) {
  return static_cast<int>(std::min<size_t>((n + threads - 1) / threads, 132 * 16));
}

}  // namespace

namespace qa {

size_t layer_tail_workspace(int M, int E, int Q, int I, int F) {
  size_t need = static_cast<size_t>(qgemm_splits(M, 2 * I, E, 0)) * M * 2 * I;
  need = std::max(need, static_cast<size_t>(qgemm_splits(M, E, I, 0)) * M * E);
  if (Q > 0) need = std::max(need, static_cast<size_t>(qgemm_splits(M, E, Q, 0)) * M * E);
  if (F > 0) need = std::max(need, static_cast<size_t>(qgemm_splits(M, F, E, 0)) * M * F);
  return need;
}

cudaError_t layer_tail_stages(const float* wo_partial, int wo_splits, const float* wo_scale,
                              const __nv_bfloat16* x, const float* norm, QMat gu, QMat wd,
                              const float* next_norm, QMat wqkv, __nv_bfloat16* out,
                              __nv_bfloat16* qkv_out, __nv_bfloat16* x1_buf, __nv_bfloat16* h,
                              __nv_bfloat16* act, float* partial, int M, int E, int I, int F,
                              float eps, int* launched, cudaStream_t stream) {
  const auto int8_scale = [](const QMat& w) { return w.int4 ? nullptr : w.s; };
  cudaError_t err;

  // (a) x1 = x + cast(sum of the wo partials); h = rmsnorm(x1).
  const __nv_bfloat16* x1 = x;
  if (wo_partial != nullptr) {
    x1 = x1_buf;
    residual_norm_kernel<<<M, kRowThreads, 0, stream>>>(wo_partial, wo_splits, wo_scale, x, x1_buf,
                                                        norm, eps, h, M, E);
  } else {
    residual_norm_kernel<<<M, kRowThreads, 0, stream>>>(nullptr, 0, nullptr, x, nullptr, norm, eps,
                                                        h, M, E);
  }
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ++*launched;

  // (b) act = silu(cast(h @ w_gate)) * cast(h @ w_up).
  int splits = qgemm_splits(M, 2 * I, E, 0);
  err = qgemm_partial(h, gu, M, 2 * I, E, splits, partial, stream);
  if (err != cudaSuccess) return err;
  ++*launched;
  swiglu_kernel<<<grid_for(static_cast<size_t>(M) * I, kActThreads), kActThreads, 0, stream>>>(
      partial, splits, int8_scale(gu), act, M, I);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ++*launched;

  // (c) out = x1 + cast(act @ w_down); with a fold, h' = rmsnorm(out).
  splits = qgemm_splits(M, E, I, 0);
  err = qgemm_partial(act, wd, M, E, I, splits, partial, stream);
  if (err != cudaSuccess) return err;
  ++*launched;
  residual_norm_kernel<<<M, kRowThreads, 0, stream>>>(partial, splits, int8_scale(wd), x1, out,
                                                      next_norm, eps, h, M, E);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ++*launched;

  // (d) qkv = cast(h' @ w_qkv): one launch, two with a split-K reduction.
  if (qkv_out == nullptr) return cudaSuccess;
  splits = qgemm_splits(M, F, E, 0);
  err = qgemm_out(h, wqkv, M, F, E, splits, partial, qkv_out, stream);
  if (err == cudaSuccess) *launched += splits > 1 ? 2 : 1;
  return err;
}

}  // namespace qa

extern "C" int qa_layer_tail_workspace(int M, int E, int Q, int I, int F) {
  return static_cast<int>(qa::layer_tail_workspace(M, E, Q, I, F));
}

// x (M, E) bf16; attn (M, Q) bf16 with wo (Q, E), or both null (Q = 0);
// norm (E,) fp32; w_gate_up (E, 2I); w_down (I, E); next_norm (E,) fp32
// and w_qkv (E, F), or both null (F = 0). Each matrix is codes, scales and
// an int4 flag (QMat). out (M, E) and qkv_out (M, F) bf16. Scratch: x1
// (M, E) bf16 (with wo), h (M, E) bf16, act (M, I) bf16, partial fp32 of
// qa_layer_tail_workspace entries. n_launches (nullable) receives the
// number of kernels launched.
extern "C" int qa_layer_tail(const void* x, const void* attn, const void* wo_q, const void* wo_s,
                             int wo4, const void* norm, const void* gu_q, const void* gu_s, int gu4,
                             const void* d_q, const void* d_s, int d4, const void* next_norm,
                             const void* qkv_q, const void* qkv_s, int qkv4, void* out,
                             void* qkv_out, void* x1_buf, void* h_buf, void* act_buf,
                             void* partial_buf, int M, int E, int Q, int I, int F, float eps,
                             int* n_launches, void* stream_ptr) {
  int launched = 0;  // kernels launched so far, reported through n_launches
  const auto done = [&](cudaError_t e) {
    if (n_launches != nullptr) *n_launches = launched;
    return static_cast<int>(e);
  };
  if (M == 0) return done(cudaSuccess);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  auto* partial = static_cast<float*>(partial_buf);
  const qa::QMat wo{wo_q, static_cast<const float*>(wo_s), wo4};
  const qa::QMat gu{gu_q, static_cast<const float*>(gu_s), gu4};
  const qa::QMat wd{d_q, static_cast<const float*>(d_s), d4};
  const qa::QMat wqkv{qkv_q, static_cast<const float*>(qkv_s), qkv4};

  // The wo product's split-K partial sums; the row kernel of the shared
  // stages adds them in order, scales, casts and adds x.
  int splits = 0;
  if (attn != nullptr) {
    splits = qa::qgemm_splits(M, E, Q, 0);
    const cudaError_t err = qa::qgemm_partial(static_cast<const __nv_bfloat16*>(attn), wo, M, E, Q,
                                              splits, partial, stream);
    if (err != cudaSuccess) return done(err);
    ++launched;
  }
  return done(qa::layer_tail_stages(
      attn != nullptr ? partial : nullptr, splits, wo.int4 ? nullptr : wo.s, xb,
      static_cast<const float*>(norm), gu, wd, static_cast<const float*>(next_norm), wqkv,
      static_cast<__nv_bfloat16*>(out), static_cast<__nv_bfloat16*>(qkv_out),
      static_cast<__nv_bfloat16*>(x1_buf), static_cast<__nv_bfloat16*>(h_buf),
      static_cast<__nv_bfloat16*>(act_buf), partial, M, E, I, F, eps, &launched, stream));
}
