// K9: one fused decode layer over the int8 slot cache, sm_90a.
//
// Replaces the Pallas kernel quantumattention_tpu/ops/megastep.py::_mega_kernel
// (megastep.py:72; host fused_decode_layer, :430), which runs a whole
// decode layer in one call:
//   A  per KV head h, online-softmax attention of the group's queries over
//      that head's int8 cache rows [lo, length) of each slot: scores q.k
//      times sm_scale * log2(e) times the token's K scale, exp2 softmax in
//      fp32, P times the token's V scale rounded to bf16 for P.V, fp32
//      accumulation; each normalized output row rounded to bf16 and
//      multiplied by wo into an fp32 sum (megastep.py:215-225); exact zeros
//      for a slot of length 0;
//   B  x1 = x + cast(acc * wo_scale), RMSNorm, the SwiGLU MLP and its
//      residual, with K8's rounding points (megastep.py:229-248);
//   C  optionally the next layer's RMSNorm and QKV product (:250-262).
//
// What bounds it on the H100: bytes. At Llama-3-8B's layer and 64 slots a
// call streams 218 MB of int8 weights (wo 16.8, w_gate_up 117.4, w_down
// 58.7, next w_qkv 25.2) and the cache rows of every slot (1 byte per
// element plus an fp32 scale per row), about 52 MB at a mean length of 384,
// for about 2 flops per weight byte: far below the card's ~295 flops/byte.
//
// Design. The TPU kernel is one sequential grid with the layer's state in
// VMEM. Here qa_decode_layer runs a fixed sequence of kernels on one stream
// with no host work between them:
//   (1) attn_kernel: one CTA per (KV head, slot), so 16 slots of Llama-3-8B
//       give 128 CTAs and 64 give 512, over the whole card. The CTA's four
//       warps split the slot's 32-row tiles of [lo, length) (tile i to warp
//       i mod 4); each warp streams its tiles by TMA (a 2-D map over the
//       (B * Hkv * S, D) cache, 128-B swizzled, so the fragment reads are
//       conflict-free) through its own two-stage mbarrier ring, with the
//       token scales by coalesced loads a tile ahead. The group's queries
//       (padded to the 16 rows of an mma.sync tile) stay in registers as A
//       fragments; scores, m, l and the output in fp32 registers. The
//       warps' (m, l, acc) merge in shared memory in warp order, and the
//       normalized bf16 rows (B, Hq * D) go to device memory: 0.5 MB at 64
//       slots, which stays in L2.
//   (2) K8's stages (csrc/tail.cu, qa::layer_tail) with those rows as the
//       attention input: the wo product over Hq * D on the tail product, the
//       residual + RMSNorm in its reduction, then SwiGLU, the down product,
//       its residual, and the next layer's QKV. The result is deterministic
//       and equals lean decode + K8 up to the fp32 association of the
//       attention's softmax and of the wo sum (JAX sums each head's and
//       group row's products in turn, megastep.py:217-225; one product over
//       Hq * D sums the same terms in another order).
// Every int8 operand of the attention becomes bf16 on the integer and fp32
// pipes (i8x4_to_bf16), not through the narrower conversion instructions.
#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int kD = 128;                 // head_dim
constexpr int kBN = 32;                 // cache rows per tile
constexpr int kTile = kBN * kD;         // one K or V tile: 4 KB, 128-B swizzled
constexpr int kStages = 2;              // per-warp ring
constexpr int kWarpRing = kStages * 2 * kTile;
constexpr int kMaxGroup = 8;            // query heads per KV head
constexpr int kOStride = kD + 4;        // fp32 per merged output row
constexpr int kMaxDevices = 64;

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kBarOff = kWarps * kWarpRing;
constexpr int kSmem = kBarOff + kWarps * kStages * 8 + 1024;  // + alignment slack
static_assert(kWarps * kMaxGroup * (kOStride + 2) * 4 <= kBarOff, "the merge fits in the rings");

// Byte offset of (row, byte column) in a 128-B-swizzled tile of 128-byte rows.
__device__ __forceinline__ int sw(int row, int col) {
  return row * 128 + ((((col >> 4) ^ row) & 7) << 4) + (col & 15);
}

// Grid (Hkv, B): one CTA per (KV head, slot). q (B, Hq, D) bf16; the
// caches through tm_k / tm_v, 2-D maps over (B * Hkv * S, D) int8 with
// boxes of 32 rows; (B, Hkv, S) fp32 token scales; lengths (B,) the
// post-append lengths; window_left < 0 for no window. Writes the
// normalized rows attn (B, Hq * D) bf16.
//
// Q . K^T contracts over D in any order, so the kernel pairs logical depth
// indices (2t, 2t+1, 2t+8, 2t+9) of each 16-deep step with physical columns
// (4t .. 4t+3): each lane then reads its four K bytes of a row with one
// 32-bit load, and its q pairs with one 64-bit load.
__global__ void __launch_bounds__(kThreads)
attn_kernel(const __grid_constant__ CUtensorMap tm_k, const __grid_constant__ CUtensorMap tm_v,
            const __nv_bfloat16* __restrict__ q, const float* __restrict__ ks,
            const float* __restrict__ vs, const int* __restrict__ lengths, int window_left,
            __nv_bfloat16* __restrict__ attn, int Hkv, int group, int S, float score_scale) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (qa::smem_addr(smem_raw) & 1023)) & 1023);
  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;
  qa::pdl_launch_dependents();
  __nv_bfloat16* out = attn + (static_cast<size_t>(b) * Hkv + h) * group * kD;
  const int len = min(lengths[b], S);
  if (len <= 0) {  // an empty slot: zero rows
    for (int c = tid * 8; c < group * kD; c += kThreads * 8)
      *reinterpret_cast<uint4*>(out + c) = make_uint4(0u, 0u, 0u, 0u);
    return;
  }
  const int lo = window_left >= 0 ? max(0, len - 1 - window_left) : 0;
  const int t0 = (lo / kBN) * kBN;
  const int n_tiles = (len - t0 + kBN - 1) / kBN;
  const int n_mine = n_tiles > warp ? (n_tiles - warp + kWarps - 1) / kWarps : 0;
  const int bh = b * Hkv + h;
  const size_t kv_row0 = static_cast<size_t>(bh) * S;
  unsigned char* ring = smem + warp * kWarpRing;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kBarOff) + warp * kStages;

  if (lane == 0) {
    for (int s = 0; s < kStages; ++s) qa::mbar_init(&full[s], 1);
    qa::mbar_init_fence();
  }
  __syncwarp();
  auto issue = [&](int j) {  // lane 0: tile j of this warp into stage j % 2
    const int s = j % kStages;
    const int row = static_cast<int>(kv_row0) + t0 + (warp + kWarps * j) * kBN;
    qa::mbar_expect_tx(&full[s], 2 * kTile);
    qa::tma_load_2d(ring + s * 2 * kTile, &tm_k, &full[s], 0, row);
    qa::tma_load_2d(ring + s * 2 * kTile + kTile, &tm_v, &full[s], 0, row);
    qa::mbar_arrive(&full[s]);
  };
  if (lane == 0) {
    for (int j = 0; j < min(n_mine, kStages); ++j) issue(j);
  }

  // The group's queries, rows >= group zero: A fragments of Q . K^T in
  // the permuted depth order.
  uint32_t qf[kD / 16][4];
  const __nv_bfloat16* qb = q + (static_cast<size_t>(b) * Hkv * group + h * group) * kD;
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk) {
    const int c = kk * 16 + tq * 4;
    const uint2 r0v = gq < group ? *reinterpret_cast<const uint2*>(qb + gq * kD + c)
                                 : make_uint2(0u, 0u);
    const uint2 r8v = gq + 8 < group ? *reinterpret_cast<const uint2*>(qb + (gq + 8) * kD + c)
                                     : make_uint2(0u, 0u);
    qf[kk][0] = r0v.x;
    qf[kk][1] = r8v.x;
    qf[kk][2] = r0v.y;
    qf[kk][3] = r8v.y;
  }
  // Lane r holds the K and V scales of row r of the warp's next tile.
  auto scales = [&](int j, float& k_sc, float& v_sc) {
    const int row = t0 + (warp + kWarps * j) * kBN + lane;
    const bool ok = j < n_mine && row < len;
    k_sc = ok ? __ldg(ks + kv_row0 + row) : 0.f;
    v_sc = ok ? __ldg(vs + kv_row0 + row) : 0.f;
  };
  float k_next, v_next;
  scales(0, k_next, v_next);

  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};
  float o[kD / 8][4];
#pragma unroll
  for (int n = 0; n < kD / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;

  for (int j = 0; j < n_mine; ++j) {
    const int r0 = t0 + (warp + kWarps * j) * kBN;
    const float k_sc = k_next, v_sc = v_next;
    scales(j + 1, k_next, v_next);
    const int s = j % kStages;
    qa::mbar_wait(&full[s], (j / kStages) & 1);
    const unsigned char* kt = ring + s * 2 * kTile;
    const unsigned char* vt = kt + kTile;

    // S = Q . K^T over the tile's rows (column tiles of 8).
    float sc[kBN / 8][4];
#pragma unroll
    for (int jj = 0; jj < kBN / 8; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[jj][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) {
#pragma unroll
      for (int jj = 0; jj < kBN / 8; ++jj) {
        uint32_t b0v, b1v;
        qa::i8x4_to_bf16(*reinterpret_cast<const uint32_t*>(kt + sw(jj * 8 + gq, kk * 16 + 4 * tq)),
                         b0v, b1v);
        qa::mma_bf16(sc[jj], qf[kk], b0v, b1v);
      }
    }
    // Scale, mask, online softmax (rows gq and gq + 8 of the tile).
    float mx[2] = {qa::kMaskValue, qa::kMaskValue};
#pragma unroll
    for (int jj = 0; jj < kBN / 8; ++jj) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = jj * 8 + 2 * tq + (e & 1);
        const int row = r0 + col;
        const bool ok = row >= lo && row < len;
        const float kscale = __shfl_sync(0xffffffffu, k_sc, col);
        sc[jj][e] = ok ? sc[jj][e] * score_scale * kscale : qa::kMaskValue;
        mx[e >> 1] = fmaxf(mx[e >> 1], sc[jj][e]);
      }
    }
    float alpha[2];
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      mx[hf] = fmaxf(mx[hf], __shfl_xor_sync(0xffffffffu, mx[hf], 1));
      mx[hf] = fmaxf(mx[hf], __shfl_xor_sync(0xffffffffu, mx[hf], 2));
      const float m_new = fmaxf(m_run[hf], mx[hf]);
      alpha[hf] = exp2f(m_run[hf] - m_new);
      m_run[hf] = m_new;
    }
    // P (fp32 into l), P times the V scale rounded to bf16 as the A
    // fragments of P . V (two neighbouring column tiles per 16 keys).
    float lsum[2] = {0.f, 0.f};
    uint32_t pf[kBN / 16][4];
#pragma unroll
    for (int jj = 0; jj < kBN / 8; ++jj) {
      const int col = jj * 8 + 2 * tq;
      const float p0 = exp2f(sc[jj][0] - m_run[0]), p1 = exp2f(sc[jj][1] - m_run[0]);
      const float p2 = exp2f(sc[jj][2] - m_run[1]), p3 = exp2f(sc[jj][3] - m_run[1]);
      lsum[0] += p0 + p1;
      lsum[1] += p2 + p3;
      const float v0 = __shfl_sync(0xffffffffu, v_sc, col);
      const float v1 = __shfl_sync(0xffffffffu, v_sc, col + 1);
      pf[jj >> 1][(jj & 1) * 2] = qa::pack_bf16(p0 * v0, p1 * v1);
      pf[jj >> 1][(jj & 1) * 2 + 1] = qa::pack_bf16(p2 * v0, p3 * v1);
    }
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      lsum[hf] += __shfl_xor_sync(0xffffffffu, lsum[hf], 1);
      lsum[hf] += __shfl_xor_sync(0xffffffffu, lsum[hf], 2);
      l_run[hf] = alpha[hf] * l_run[hf] + lsum[hf];
    }
#pragma unroll
    for (int n = 0; n < kD / 8; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk) {
      const int r = kk * 16 + 2 * tq;
#pragma unroll
      for (int n = 0; n < kD / 8; ++n) {
        const int c = n * 8 + gq;
        const uint32_t x0 = vt[sw(r, c)], x1 = vt[sw(r + 1, c)];
        const uint32_t x2 = vt[sw(r + 8, c)], x3 = vt[sw(r + 9, c)];
        uint32_t b0v, b1v;
        qa::i8x4_to_bf16(__byte_perm(__byte_perm(x0, x1, 0x0040), __byte_perm(x2, x3, 0x0040), 0x5410),
                         b0v, b1v);
        qa::mma_bf16(o[n], pf[kk], b0v, b1v);
      }
    }
    __syncwarp();  // every lane has read the stage before it is refilled
    if (lane == 0 && j + kStages < n_mine) issue(j + kStages);
  }

  // Merge the warps' (m, l, acc) of the group rows in warp order. The rings
  // are free: every warp waited for all of its loads.
  __syncthreads();
  float* m_sh = reinterpret_cast<float*>(smem);
  float* l_sh = m_sh + kWarps * kMaxGroup;
  float* o_sh = l_sh + kWarps * kMaxGroup;
  if (gq < group) {
    if (tq == 0) {
      m_sh[warp * kMaxGroup + gq] = m_run[0];
      l_sh[warp * kMaxGroup + gq] = l_run[0];
    }
    float* orow = o_sh + (warp * kMaxGroup + gq) * kOStride;
#pragma unroll
    for (int n = 0; n < kD / 8; ++n)
      *reinterpret_cast<float2*>(orow + n * 8 + 2 * tq) = make_float2(o[n][0], o[n][1]);
  }
  __syncthreads();
  for (int idx = tid; idx < group * kD; idx += kThreads) {
    const int r = idx / kD, col = idx % kD;
    float m_all = -INFINITY;
    for (int w = 0; w < kWarps; ++w) m_all = fmaxf(m_all, m_sh[w * kMaxGroup + r]);
    float l_all = 0.f, acc = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      const float f = exp2f(m_sh[w * kMaxGroup + r] - m_all);  // 0 for a warp without tiles
      l_all += l_sh[w * kMaxGroup + r] * f;
      acc += o_sh[(w * kMaxGroup + r) * kOStride + col] * f;
    }
    out[idx] = __float2bfloat16_rn(l_all == 0.f ? 0.f : acc / l_all);
  }
}

}  // namespace

extern "C" int qa_decode_layer_workspace(int B, int Q, int E, int I, int F) {
  return static_cast<int>(qa::layer_tail_workspace(B, E, Q, I, F));
}

// x (B, E) bf16 residual stream; q (B, Hq, D) bf16 rotated queries, D =
// 128; k/v caches (B, Hkv, S, D) int8 with (B, Hkv, S) fp32 token scales,
// already holding this step's token; lengths (B,) int32 post-append
// lengths; window_left < 0 for no window. Weights int8 with fp32 column
// scales: wo (Hq * D, E), w_gate_up (E, 2I), w_down (I, E); norm (E,) fp32;
// next_norm (E,) fp32 and w_qkv (E, F), or both null (F = 0). out (B, E)
// and qkv_out (B, F) bf16. Scratch: attn (B, Hq * D), x1, h (B, E) and act
// (B, I) bf16, partial fp32 of qa_decode_layer_workspace entries.
// score_scale = sm_scale * log2(e). n_launches (nullable) receives the
// number of kernels launched.
extern "C" int qa_decode_layer(const void* x, const void* q, const void* k_cache,
                               const void* v_cache, const void* k_scale, const void* v_scale,
                               const void* lengths, int window_left, const void* wo_q,
                               const void* wo_s, const void* norm, const void* gu_q,
                               const void* gu_s, const void* d_q, const void* d_s,
                               const void* next_norm, const void* qkv_q, const void* qkv_s,
                               void* out, void* qkv_out, void* attn, void* x1, void* h, void* act,
                               void* partial_buf, int B, int Hq, int Hkv, int S, int D, int E,
                               int I, int F, float score_scale, float eps, int* n_launches,
                               void* stream_ptr) {
  int launched = 0;  // kernels launched so far, reported through n_launches
  const auto done = [&](cudaError_t e) {
    if (n_launches != nullptr) *n_launches = launched;
    return static_cast<int>(e);
  };
  if (B == 0) return done(cudaSuccess);
  if (D != kD || Hkv <= 0 || Hq % Hkv != 0 || Hq / Hkv > kMaxGroup || E % qa::kTailBN != 0 ||
      I % qa::kTailBN != 0 || F % qa::kTailBN != 0 || B > qa::kTailMaxRows)
    return done(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  // Raise the dynamic shared-memory limit once per device (not on every
  // launch: a launch may be captured into a CUDA graph).
  static bool configured[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess && dev >= kMaxDevices) err = cudaErrorInvalidDevice;
  if (err == cudaSuccess && !configured[dev]) {
    err = cudaFuncSetAttribute(attn_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    configured[dev] = err == cudaSuccess;
  }
  CUtensorMap tm_k, tm_v;
  const int rows = B * Hkv * S;
  if (err == cudaSuccess) err = qa::tensor_map_2d(&tm_k, k_cache, qa::kI8, kD, rows, kD, kD, kBN, true);
  if (err == cudaSuccess) err = qa::tensor_map_2d(&tm_v, v_cache, qa::kI8, kD, rows, kD, kD, kBN, true);
  if (err != cudaSuccess) return done(err);
  attn_kernel<<<dim3(Hkv, B), kThreads, kSmem, stream>>>(
      tm_k, tm_v, static_cast<const __nv_bfloat16*>(q), static_cast<const float*>(k_scale),
      static_cast<const float*>(v_scale), static_cast<const int*>(lengths), window_left,
      static_cast<__nv_bfloat16*>(attn), Hkv, Hq / Hkv, S, score_scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return done(err);
  ++launched;
  const qa::QMat wo{wo_q, static_cast<const float*>(wo_s), 0};
  const qa::QMat gu{gu_q, static_cast<const float*>(gu_s), 0};
  const qa::QMat wd{d_q, static_cast<const float*>(d_s), 0};
  const qa::QMat wqkv{qkv_q, static_cast<const float*>(qkv_s), 0};
  return done(qa::layer_tail(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(attn), wo,
      static_cast<const float*>(norm), gu, wd, static_cast<const float*>(next_norm), wqkv,
      static_cast<__nv_bfloat16*>(out), static_cast<__nv_bfloat16*>(qkv_out),
      static_cast<__nv_bfloat16*>(x1), static_cast<__nv_bfloat16*>(h),
      static_cast<__nv_bfloat16*>(act), static_cast<float*>(partial_buf), B, E, Hq * kD, I, F, eps,
      &launched, stream));
}
