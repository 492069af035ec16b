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
// dependencies, so the tail is a fixed sequence of kernels on one stream,
// qa::layer_tail (csrc/tail.cu), which K9 shares: each product is the
// persistent TMA + wgmma tail product over the whole card, and each is
// followed by the kernel that adds its partial sums in a fixed order and
// applies what comes next (residual + RMSNorm, SwiGLU, the cast). Every
// kernel is launched with programmatic dependent launch, so a product's
// first weight stages load while the reduction before it runs. Six to
// eight kernels a tail (qa_layer_tail reports the count).
#include "common.cuh"

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
  cudaError_t err = cudaSuccess;
  if (M > 0) {
    err = qa::layer_tail(
        static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(attn),
        qa::QMat{wo_q, static_cast<const float*>(wo_s), wo4}, static_cast<const float*>(norm),
        qa::QMat{gu_q, static_cast<const float*>(gu_s), gu4},
        qa::QMat{d_q, static_cast<const float*>(d_s), d4}, static_cast<const float*>(next_norm),
        qa::QMat{qkv_q, static_cast<const float*>(qkv_s), qkv4}, static_cast<__nv_bfloat16*>(out),
        static_cast<__nv_bfloat16*>(qkv_out), static_cast<__nv_bfloat16*>(x1_buf),
        static_cast<__nv_bfloat16*>(h_buf), static_cast<__nv_bfloat16*>(act_buf),
        static_cast<float*>(partial_buf), M, E, Q, I, F, eps, &launched,
        static_cast<cudaStream_t>(stream_ptr));
  }
  if (n_launches != nullptr) *n_launches = launched;
  return static_cast<int>(err);
}
