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
//      multiplied by the head's (group * D, E) int8 row block of wo into an
//      fp32 accumulator (megastep.py:215-225); exact zeros for a slot of
//      length 0;
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
//   (1) attn_wo_kernel, new here: a thread-block cluster of 1-8 CTAs per
//       (KV head, 16 slots). Each CTA's eight warps take one slot at a time
//       (rank r of the cluster the slots r, r + cluster, ...) and stream that
//       slot's int8 K/V rows through a two-stage cp.async ring in shared
//       memory, 32 rows a tile; the group's queries (padded to the 16 rows
//       of an mma.sync tile) stay in registers as A fragments, scores, m, l
//       and the output accumulator in fp32 registers. Tiles past the slot's
//       length (or before its window) are never read. The normalized bf16
//       output rows land in a (16 slots, group * D) tile in shared memory;
//       the cluster's CTAs copy each other's rows through distributed shared
//       memory, so the attention output never goes to device memory. Each
//       CTA then multiplies the 16 rows by its share of the head's wo
//       columns, streamed 64 x 128 at a time through a four-stage ring (its
//       first stages land while the attention runs), and writes an fp32
//       per-head partial (Hkv, B, E) without atomics.
//   (2)-(5) K8's stages (csrc/qmlp.cu, qa::layer_tail_stages): the row
//       kernel sums the Hkv head partials in a fixed order, scales, casts,
//       adds x and applies RMSNorm; then SwiGLU, the split-K down product,
//       its residual, and the next layer's QKV. The result is deterministic
//       and equals lean decode + K8 up to the fp32 association of the wo sum
//       and of the attention's online softmax.
// Every int8 operand becomes bf16 on the integer and fp32 pipes
// (i8x4_to_bf16), not through the narrower conversion instructions. A first
// version (four warps, 64-row tiles, one CTA per head and 16 slots, I2F
// conversions) took 0.555 ms a call at 64 slots, this one 0.355 (PERF.md).
// What still bounds it: the fragments of V and wo gather four bytes from
// four rows each, and K8's stages take more than half of the call at 64
// slots. TMA, wgmma and int8 tensor-core operands are later work.
#include <algorithm>

#include <cooperative_groups.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kD = 128;                  // head_dim
constexpr int kBN = 32;                  // cache rows per tile
constexpr int kRowStride = kD + 16;      // bytes per cache row in shared memory (bank spread)
constexpr int kTile = kBN * kRowStride;  // one K or V tile
constexpr int kKvStages = 2;             // per-warp cache ring
constexpr int kWarpStage = 2 * kTile + 2 * kBN * 4;  // K and V tiles and their scales
constexpr int kSlots = 16;               // slots per cluster: the M rows of the wo product
constexpr int kMaxGroup = 8;             // query heads per KV head
constexpr int kWoBN = 128;               // wo columns per stage
constexpr int kWoBK = 64;                // wo rows per stage
constexpr int kWoStride = kWoBN + 16;
constexpr int kWoStage = kWoBK * kWoStride;
constexpr int kWoStages = 4;
constexpr int kMaxDevices = 64;

constexpr size_t smem_bytes(int group) {
  return static_cast<size_t>(kWarps) * kKvStages * kWarpStage    // cache rings
         + static_cast<size_t>(kWoStages) * kWoStage              // wo ring
         + static_cast<size_t>(kSlots) * (group * kD + 8) * 2;    // attention output tile
}

// 4 bytes from device memory to shared memory, asynchronously; zeros when
// !valid (the source is then not read).
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, bool valid) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(gmem), "r"(valid ? 4 : 0));
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

// The B fragment of a product whose depth runs down the rows of an int8
// tile in shared memory (row stride `stride`): rows r, r + 1 (b0) and
// r + 8, r + 9 (b1) of column c, at p = tile + r * stride + c.
__device__ __forceinline__ void b_frag_rows(const unsigned char* p, int stride, uint32_t& b0,
                                            uint32_t& b1) {
  const uint32_t x0 = p[0], x1 = p[stride], x2 = p[8 * stride], x3 = p[9 * stride];
  i8x4_to_bf16(__byte_perm(__byte_perm(x0, x1, 0x0040), __byte_perm(x2, x3, 0x0040), 0x5410),
               b0, b1);
}

// Grid (Hkv, ceil(B / 16), cluster) in clusters of (1, 1, cluster) CTAs:
// a cluster owns one KV head and 16 slots. q (B, Hq, D) bf16; caches
// (B, Hkv, S, D) int8 with (B, Hkv, S) fp32 token scales; lengths (B,) the
// post-append lengths; window_left < 0 for no window; wo (Hq * D, E) int8.
// CTA rank r of the cluster attends over slots r, r + cluster, ...; the
// CTAs then copy each other's bf16 output rows through distributed shared
// memory, and rank r multiplies all 16 rows by wo columns [r E / cluster,
// (r + 1) E / cluster) of head h, writing partial[h][b][cols] unscaled.
//
// Q . K^T contracts over D in any order, so the kernel pairs logical depth
// indices (2t, 2t+1, 2t+8, 2t+9) of each 16-deep step with physical columns
// (4t .. 4t+3): each lane then reads its four K bytes of a row with one
// 32-bit load, and its q pairs with one 64-bit load.
__global__ void __launch_bounds__(kThreads)
attn_wo_kernel(const __nv_bfloat16* __restrict__ q, const signed char* __restrict__ kc,
               const signed char* __restrict__ vc, const float* __restrict__ ks,
               const float* __restrict__ vs, const int* __restrict__ lengths, int window_left,
               const signed char* __restrict__ wo, float* __restrict__ partial, int B, int Hkv,
               int group, int S, int E, float score_scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int n_ranks = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int h = blockIdx.x, b0 = blockIdx.y * kSlots;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const int qg = group * kD;  // wo rows of this head
  const int a_stride = qg + 8;
  unsigned char* wo_ring = smem + kWarps * kKvStages * kWarpStage;
  __nv_bfloat16* out_tile = reinterpret_cast<__nv_bfloat16*>(wo_ring + kWoStages * kWoStage);

  const int k_iters = qg / kWoBK;
  const int e_cols = E / n_ranks, e0 = rank * e_cols;
  const int n_wo = (e_cols / kWoBN) * k_iters;
  auto load_wo = [&](int buf, int i) {
    const int c0 = e0 + (i / k_iters) * kWoBN;
    const size_t r0 = static_cast<size_t>(h) * qg + (i % k_iters) * kWoBK;
    unsigned char* dst = wo_ring + buf * kWoStage;
    for (int c = tid; c < kWoBK * 8; c += kThreads) {
      const int r = c >> 3, col = (c & 7) * 16;
      qa::cp_async16(dst + r * kWoStride + col, wo + (r0 + r) * E + c0 + col, true);
    }
  };
  // The first wo stages stream in while the attention runs.
#pragma unroll
  for (int st = 0; st < kWoStages - 1; ++st) {
    if (st < n_wo) load_wo(st, st);
    qa::cp_async_commit();
  }

  // ---- attention: one slot per warp at a time ----------------------------
  unsigned char* ring = smem + warp * kKvStages * kWarpStage;
  for (int li = warp; li * n_ranks < kSlots; li += kWarps) {
    const int sl = li * n_ranks + rank, b = b0 + sl;
    __nv_bfloat16* orow = out_tile + sl * a_stride;
    const int len = b < B ? min(lengths[b], S) : 0;
    if (len <= 0) {  // empty slot, or past B: a zero row
      for (int c = lane * 8; c < qg; c += 32 * 8)
        *reinterpret_cast<uint4*>(orow + c) = make_uint4(0u, 0u, 0u, 0u);
      continue;
    }
    const int lo = window_left >= 0 ? max(0, len - 1 - window_left) : 0;
    const int t0 = (lo / kBN) * kBN;
    const int n_tiles = (len - t0 + kBN - 1) / kBN;
    const size_t kv_row0 = (static_cast<size_t>(b) * Hkv + h) * S;

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

    auto load_kv = [&](int buf, int r0) {
      unsigned char* st = ring + buf * kWarpStage;
      float* kst = reinterpret_cast<float*>(st + 2 * kTile);
      for (int c = lane; c < kBN * 8; c += 32) {
        const int r = c >> 3, col = (c & 7) * 16;
        const bool ok = r0 + r < len;
        const size_t off = (kv_row0 + (ok ? r0 + r : 0)) * kD + col;
        qa::cp_async16(st + r * kRowStride + col, kc + off, ok);
        qa::cp_async16(st + kTile + r * kRowStride + col, vc + off, ok);
      }
      {
        const int r = lane;  // kBN == 32: one row's scales a lane
        const bool ok = r0 + r < len;
        const size_t off = kv_row0 + (ok ? r0 + r : 0);
        cp_async4(kst + r, ks + off, ok);
        cp_async4(kst + kBN + r, vs + off, ok);
      }
    };

    float m_run[2] = {-INFINITY, -INFINITY};
    float l_run[2] = {0.f, 0.f};
    float o[kD / 8][4];
#pragma unroll
    for (int n = 0; n < kD / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[n][e] = 0.f;

    load_kv(0, t0);
    qa::cp_async_commit();
    for (int it = 0; it < n_tiles; ++it) {
      const int r0 = t0 + it * kBN;
      if (it + 1 < n_tiles) load_kv((it + 1) & 1, r0 + kBN);
      qa::cp_async_commit();
      qa::cp_async_wait<1>();
      __syncwarp();
      const unsigned char* kt = ring + (it & 1) * kWarpStage;
      const unsigned char* vt = kt + kTile;
      const float* kst = reinterpret_cast<const float*>(kt + 2 * kTile);
      const float* vst = kst + kBN;

      // S = Q . K^T over the tile's rows (column tiles of 8).
      float s[kBN / 8][4];
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk) {
#pragma unroll
        for (int j = 0; j < kBN / 8; ++j) {
          uint32_t b0v, b1v;
          i8x4_to_bf16(*reinterpret_cast<const uint32_t*>(kt + (j * 8 + gq) * kRowStride + kk * 16 + 4 * tq),
                       b0v, b1v);
          qa::mma_bf16(s[j], qf[kk], b0v, b1v);
        }
      }
      // Scale, mask, online softmax (rows gq and gq + 8 of the tile).
      float mx[2] = {qa::kMaskValue, qa::kMaskValue};
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = j * 8 + 2 * tq + (e & 1);
          const int row = r0 + col;
          const bool ok = row >= lo && row < len;
          s[j][e] = ok ? s[j][e] * score_scale * kst[col] : qa::kMaskValue;
          mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
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
      for (int j = 0; j < kBN / 8; ++j) {
        const int col = j * 8 + 2 * tq;
        const float p0 = exp2f(s[j][0] - m_run[0]), p1 = exp2f(s[j][1] - m_run[0]);
        const float p2 = exp2f(s[j][2] - m_run[1]), p3 = exp2f(s[j][3] - m_run[1]);
        lsum[0] += p0 + p1;
        lsum[1] += p2 + p3;
        const float v0 = vst[col], v1 = vst[col + 1];
        pf[j >> 1][(j & 1) * 2] = qa::pack_bf16(p0 * v0, p1 * v1);
        pf[j >> 1][(j & 1) * 2 + 1] = qa::pack_bf16(p2 * v0, p3 * v1);
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
#pragma unroll
        for (int n = 0; n < kD / 8; ++n) {
          uint32_t b0v, b1v;
          b_frag_rows(vt + (kk * 16 + 2 * tq) * kRowStride + n * 8 + gq, kRowStride, b0v, b1v);
          qa::mma_bf16(o[n], pf[kk], b0v, b1v);
        }
      }
      __syncwarp();  // the next iteration's load reuses this stage
    }

    // Normalized output rows (acc * (1 / l)), rounded to bf16, into the tile.
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int row = gq + 8 * hf;
      if (row >= group) continue;
      const float inv = l_run[hf] == 0.f ? 0.f : 1.f / l_run[hf];
#pragma unroll
      for (int n = 0; n < kD / 8; ++n) {
        *reinterpret_cast<uint32_t*>(orow + row * kD + n * 8 + 2 * tq) =
            qa::pack_bf16(o[n][2 * hf] * inv, o[n][2 * hf + 1] * inv);
      }
    }
  }

  // ---- every rank's rows into every rank's tile ---------------------------
  cluster.sync();  // all rows written
  for (int sl = 0; sl < kSlots; ++sl) {
    const int owner = sl % n_ranks;
    if (owner == rank) continue;
    const uint4* src = reinterpret_cast<const uint4*>(
        cluster.map_shared_rank(out_tile + sl * a_stride, owner));
    uint4* dst = reinterpret_cast<uint4*>(out_tile + sl * a_stride);
    for (int c = tid; c < qg / 8; c += kThreads) dst[c] = src[c];
  }
  cluster.sync();  // all copies done: no rank reads a peer that has moved on

  // ---- the head's wo product: (16 slot rows, group * D) x (group * D,
  // this rank's columns); eight warps of 16 columns each per 128-column stage.
  qa::cp_async_wait<0>();
  __syncthreads();
  float acc[2][4];
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  for (int i = 0; i < n_wo; ++i) {
    qa::cp_async_wait<kWoStages - 2>();
    __syncthreads();  // stage i landed; stage i - 1's buffer is free
    const int nxt = i + kWoStages - 1;
    if (nxt < n_wo) load_wo(nxt % kWoStages, nxt);
    qa::cp_async_commit();

    const unsigned char* ws = wo_ring + (i % kWoStages) * kWoStage;
    const int ki = i % k_iters;
#pragma unroll
    for (int kk = 0; kk < kWoBK / 16; ++kk) {
      uint32_t a[4];
      qa::load_a_frag(a, out_tile, a_stride, ki * (kWoBK / 16) + kk, gq, tq);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        uint32_t b0v, b1v;
        b_frag_rows(ws + (kk * 16 + 2 * tq) * kWoStride + warp * 16 + j * 8 + gq, kWoStride, b0v,
                    b1v);
        qa::mma_bf16(acc[j], a, b0v, b1v);
      }
    }
    if (ki == k_iters - 1) {  // a 128-column tile is complete
      const int c0 = e0 + (i / k_iters) * kWoBN;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int b = b0 + gq + 8 * hf;
          if (b < B) {
            const int col = c0 + warp * 16 + j * 8 + 2 * tq;
            *reinterpret_cast<float2*>(partial + (static_cast<size_t>(h) * B + b) * E + col) =
                make_float2(acc[j][2 * hf], acc[j][2 * hf + 1]);
          }
          acc[j][2 * hf] = 0.f;
          acc[j][2 * hf + 1] = 0.f;
        }
      }
    }
  }
  qa::cp_async_wait<0>();
}

// CTAs per cluster: the fewest of 1, 2, 4, 8 that give at least kMinCtas
// CTAs and divide E into 128-column stages. Measured at Llama-3-8B's layer
// (PERF.md): 64 slots ran fastest at 2 (64 CTAs; at 4 each CTA attends
// over 4 slots and half its warps idle), 16 slots at 8 (64 CTAs).
constexpr int kMinCtas = 64;

int cluster_size(int B, int Hkv, int E, int requested) {
  const int ctas = Hkv * ((B + kSlots - 1) / kSlots);
  int n = requested > 0 ? requested : 1;
  while (requested <= 0 && n < 8 && ctas * n < kMinCtas) n *= 2;
  while (n > 1 && E % (n * kWoBN) != 0) n /= 2;
  return n;
}

size_t workspace(int B, int Hkv, int E, int I, int F) {
  return std::max(static_cast<size_t>(Hkv) * B * E, qa::layer_tail_workspace(B, E, 0, I, F));
}

}  // namespace

extern "C" int qa_decode_layer_workspace(int B, int Hkv, int E, int I, int F) {
  return static_cast<int>(workspace(B, Hkv, E, I, F));
}

// x (B, E) bf16 residual stream; q (B, Hq, D) bf16 rotated queries, D =
// 128; k/v caches (B, Hkv, S, D) int8 with (B, Hkv, S) fp32 token scales,
// already holding this step's token; lengths (B,) int32 post-append
// lengths; window_left < 0 for no window. Weights int8 with fp32 column
// scales: wo (Hq * D, E), w_gate_up (E, 2I), w_down (I, E); norm (E,) fp32;
// next_norm (E,) fp32 and w_qkv (E, F), or both null (F = 0). out (B, E)
// and qkv_out (B, F) bf16. Scratch: x1, h (B, E) bf16, act (B, I) bf16 and
// partial fp32 of qa_decode_layer_workspace entries. score_scale = sm_scale
// * log2(e). requested_cluster: CTAs per cluster of the attention kernel
// (1, 2, 4 or 8; 0 = the card's rule). n_launches (nullable) receives the
// number of kernels launched.
extern "C" int qa_decode_layer(const void* x, const void* q, const void* k_cache,
                               const void* v_cache, const void* k_scale, const void* v_scale,
                               const void* lengths, int window_left, const void* wo_q,
                               const void* wo_s, const void* norm, const void* gu_q,
                               const void* gu_s, const void* d_q, const void* d_s,
                               const void* next_norm, const void* qkv_q, const void* qkv_s,
                               void* out, void* qkv_out, void* x1, void* h, void* act,
                               void* partial_buf, int B, int Hq, int Hkv, int S, int D, int E,
                               int I, int F, float score_scale, float eps, int requested_cluster,
                               int* n_launches, void* stream_ptr) {
  int launched = 0;  // kernels launched so far, reported through n_launches
  const auto done = [&](cudaError_t e) {
    if (n_launches != nullptr) *n_launches = launched;
    return static_cast<int>(e);
  };
  if (B == 0) return done(cudaSuccess);
  if (D != kD || Hkv <= 0 || Hq % Hkv != 0 || Hq / Hkv > kMaxGroup || E % kWoBN != 0 ||
      I % 128 != 0 || F % 128 != 0)
    return done(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  // Raise the dynamic shared-memory limit once per device (not on every
  // launch: a launch may be captured into a CUDA graph).
  static bool configured[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return done(err);
  if (dev >= kMaxDevices) return done(cudaErrorInvalidDevice);
  if (!configured[dev]) {
    err = cudaFuncSetAttribute(attn_wo_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem_bytes(kMaxGroup)));
    if (err != cudaSuccess) return done(err);
    configured[dev] = true;
  }
  const int group = Hq / Hkv;
  const int ranks = cluster_size(B, Hkv, E, requested_cluster);
  auto* partial = static_cast<float*>(partial_buf);
  cudaLaunchConfig_t launch = {};
  launch.gridDim = dim3(Hkv, (B + kSlots - 1) / kSlots, ranks);
  launch.blockDim = dim3(kThreads);
  launch.dynamicSmemBytes = smem_bytes(group);
  launch.stream = stream;
  cudaLaunchAttribute cluster_dims[1];
  cluster_dims[0].id = cudaLaunchAttributeClusterDimension;
  cluster_dims[0].val.clusterDim.x = 1;
  cluster_dims[0].val.clusterDim.y = 1;
  cluster_dims[0].val.clusterDim.z = ranks;
  launch.attrs = cluster_dims;
  launch.numAttrs = 1;
  err = cudaLaunchKernelEx(&launch, attn_wo_kernel, static_cast<const __nv_bfloat16*>(q),
                           static_cast<const signed char*>(k_cache),
                           static_cast<const signed char*>(v_cache),
                           static_cast<const float*>(k_scale), static_cast<const float*>(v_scale),
                           static_cast<const int*>(lengths), window_left,
                           static_cast<const signed char*>(wo_q), partial, B, Hkv, group, S, E,
                           score_scale);
  if (err != cudaSuccess || (err = cudaGetLastError()) != cudaSuccess) return done(err);
  ++launched;
  const qa::QMat gu{gu_q, static_cast<const float*>(gu_s), 0};
  const qa::QMat wd{d_q, static_cast<const float*>(d_s), 0};
  const qa::QMat wqkv{qkv_q, static_cast<const float*>(qkv_s), 0};
  return done(qa::layer_tail_stages(
      partial, Hkv, static_cast<const float*>(wo_s), static_cast<const __nv_bfloat16*>(x),
      static_cast<const float*>(norm), gu, wd, static_cast<const float*>(next_norm), wqkv,
      static_cast<__nv_bfloat16*>(out), static_cast<__nv_bfloat16*>(qkv_out),
      static_cast<__nv_bfloat16*>(x1), static_cast<__nv_bfloat16*>(h),
      static_cast<__nv_bfloat16*>(act), partial, B, E, I, F, eps, &launched, stream));
}
