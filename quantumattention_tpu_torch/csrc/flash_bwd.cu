// K2 (dQ) and K3 (dK, dV): blockwise flash-attention backward for Hopper
// (sm_90a), on TMA and wgmma.
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
// with top-left causal, sliding-window and ragged-tail masks (masked P = 0;
// a window (left, right) keeps the keys [i - left, i + right] of row i, the
// right extent inactive under the causal mask, flash_bwd.py:225-226), GQA by KV-head
// index, P and dS rounded to the inputs' 16-bit type (bf16, as the TPU
// kernels round them, or fp16 for fp16 inputs) as product operands, and
// fp32 accumulation.
//
// What bounds them on the H100: operations. The backward is five S x S x D
// products a head (K2 three: S, dP, dS.K; K3 four: S^T, dP^T, P^T.dO,
// dS^T.Q; the two score products run in both), 2.5x the forward's, far
// above the card's balance point at any S worth a kernel. So both kernels
// feed the tensor cores by TMA and wgmma only:
//  - one or two consumer warpgroups of 64 rows each and no producer
//    warpgroup: thread 0 issues every TMA load, two tiles ahead through a
//    three-stage ring with full and empty mbarriers (every wait traps when
//    it can never complete, hopper.cuh). ptxas compiles every thread's code
//    under the launch bound's cap of 65536 / threads registers, rounded to
//    whole warpgroups, whatever setmaxnreg grants later: a producer
//    warpgroup (or warp) beside two consumers leaves them 168, where K3's
//    two 64 x 128 fp32 accumulators beside S^T and dP^T spilled kilobytes
//    a thread; two consumers alone get 255. The loads are 128-byte swizzled
//    64-column boxes of 3-D tensor maps over (D, S, B * H): rows past S and
//    columns past D read as zeros, never as the next head's rows;
//  - each Q row's m, 1/l and D come packed as (B * H, Sq_pad, 4) fp32 rows
//    (the wrapper packs them), so that K3's tile of them is one bulk copy;
//  - K2: one CTA per (q head, batch, 64 rows a consumer of Q), the heaviest
//    causal blocks first. Q and dO load once; the K and V tiles of KV head
//    hq / G that the block's rows can see (from the lowest row's window edge
//    to the highest row's diagonal or right edge) stream through the ring. Each consumer runs S = Q.K^T and
//    dP = dO.V^T as SS wgmma (both K-major), P and dS in registers (masks
//    only on diagonal and ragged tiles), then dS packed to 16 bits is the
//    register A operand of dQ += dS.K, whose B is the K tile read MN-major
//    through the transpose bit, the way K1 reads V;
//  - K3: one CTA per (KV block, q head), which fills the card (384 CTAs of
//    128 KV rows at B = 1, Hq = 32, S = 1536, heaviest causal blocks first,
//    where one CTA per 64-row KV block walking its G = 4 q heads gave 192
//    and at most 76% of the SMs under the causal triangle). The KV block's K
//    and V load once; Q and dO tiles of the rows that can see the block
//    (down to the diagonal or the right window edge, up to the last row
//    whose window reaches the block) and their statistics stream through
//    the ring. Each consumer owns 64 KV rows and computes
//    S^T = K.Q^T and dP^T = V.dO^T directly, so that the accumulators have
//    KV rows as M and P^T and dS^T are the register A operands of
//    dV += P^T.dO and dK += dS^T.Q (dO and Q read MN-major);
//  - the GQA group sum of K3 is deterministic and uses no float atomics:
//    the G CTAs of one KV block's group form a thread-block cluster (one
//    per q head), each writes its fp32 dK and dV into its own shared memory,
//    and after a cluster barrier CTA r sums rows r / G of the block over the
//    G CTAs' shared memory in rank order and stores them. Chosen over fp32
//    per-head partials and a second summing pass (the TPU kernel's layout,
//    flash_bwd.py:345-351) because those would move ~50 MB of partials
//    through device memory at the shape above, a third of the kernel's
//    bound. Above the portable cluster size of 8, or where G has no divisor
//    in 2..8, a CTA walks G / c q heads in a fixed order inside (c the
//    largest divisor of G up to 8) and the cluster of c sums the rest;
//  - head dims: any multiple of 8 up to 512, rounded up to an instantiated
//    width W of 64, 128, 256 or 512 (qa::kernel_width): the tensor maps'
//    inner extent is D, so the columns past D are zeros (a box wholly past
//    D reads as zeros too), and only D columns are stored. The score
//    products run over all of W: a depth cut at D between wgmma instructions
//    made ptxas serialise every wgmma of the kernel (its warning C7515; K2
//    0.115 against 0.088 ms, K3 0.173 against 0.143 at B = 1, Hq = 32,
//    S = 1536, D = 128 on the H100), so D = 96 spends a quarter of them on
//    zero columns, D = 72 and 320 close to half. The
//    fp32 accumulators bound the output columns a CTA owns: K2 splits dQ's
//    columns over two CTAs at W = 512 (256 each); K3 splits dK and dV into
//    128-column parts above W = 128 (two CTAs at 256, four at 512). Each CTA
//    of a split recomputes the score products over the full D.
// Not here: position offsets (nor has the TPU kernel them), fp8 products,
// and one fused pass with dQ summed by atomics (FA3's design, which would
// make dQ nondeterministic).
#include <cooperative_groups.h>

#include "common.cuh"
#include "hopper.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kStages = 3;
constexpr int kAhead = kStages - 1;  // tiles in flight ahead of the one computed

// 16-bit rows of the instantiated width W in 64-column blocks of 128-byte
// swizzled rows (one TMA box each).
template <int W>
struct Rows {
  static constexpr int kBlocks = W / 64;
  static constexpr int kRowBytes = W * 2;
};

// K2 tiles and shared memory at width W.
template <int W>
struct DqCfg {
  static constexpr int kOD = W > 256 ? 256 : W;  // dQ columns a CTA owns
  static constexpr int kSplits = W / kOD;
  static constexpr int kConsumers = W > 256 ? 1 : 2;
  static constexpr int kBN = W <= 128 ? 64 : W == 256 ? 32 : 16;  // KV rows a tile
  static constexpr int kThreads = 128 * kConsumers;
  static constexpr int kBM = 64 * kConsumers;  // Q rows per CTA
  static constexpr int kQBytes = kBM * Rows<W>::kRowBytes;
  static constexpr int kKBytes = kBN * Rows<W>::kRowBytes;
  static constexpr int kDOOff = kQBytes;
  static constexpr int kKOff = 2 * kQBytes;
  static constexpr int kVOff = kKOff + kStages * kKBytes;
  static constexpr int kBarOff = kVOff + kStages * kKBytes;
  static constexpr int kSmem = kBarOff + (1 + 2 * kStages) * 8 + 1024;  // + alignment slack
  static_assert(kQBytes % 1024 == 0 && kKBytes % 1024 == 0 && kBN * 128 % 1024 == 0,
                "1024-byte boxes");
  static_assert(kSmem <= 232448, "shared memory of one CTA");
};

// K3 tiles and shared memory at width W.
template <int W>
struct DkvCfg {
  static constexpr int kOD = W > 128 ? 128 : W;  // dK / dV columns a CTA owns
  static constexpr int kSplits = W / kOD;
  static constexpr int kConsumers = W <= 128 ? 2 : 1;
  // Q rows a tile: 64 at W <= 128 (kept although it spills some 60 bytes
  // at 255 registers: 32-row tiles spill nothing and ran slower on the H100).
  static constexpr int kBQ = W <= 128 ? 64 : W == 256 ? 32 : 16;
  static constexpr int kThreads = 128 * kConsumers;
  static constexpr int kBM = 64 * kConsumers;  // KV rows per CTA
  static constexpr int kKBytes = kBM * Rows<W>::kRowBytes;
  static constexpr int kQBytes = kBQ * Rows<W>::kRowBytes;
  static constexpr int kStatBytes = kBQ * 16;  // (m, 1/l, D, 0) of a tile's rows
  static constexpr int kVOff = kKBytes;
  static constexpr int kQOff = 2 * kKBytes;
  static constexpr int kDOOff = kQOff + kStages * kQBytes;
  static constexpr int kStatOff = kDOOff + kStages * kQBytes;
  static constexpr int kRedStride = kOD + 4;                  // fp32, padded against bank conflicts
  static constexpr int kRedBytes = 2 * kBM * kRedStride * 4;  // dK then dV, after the loop
  static constexpr int kLayout = kStatOff + kStages * kStatBytes;
  static constexpr int kBarOff = kLayout > kRedBytes ? kLayout : kRedBytes;
  static constexpr int kSmem = kBarOff + (1 + 2 * kStages) * 8 + 1024;
  static_assert(kKBytes % 1024 == 0 && kQBytes % 1024 == 0 && kBQ * 128 % 1024 == 0,
                "1024-byte boxes");
  static_assert(kSmem <= 232448, "shared memory of one CTA");
};

template <int T>
__device__ __forceinline__ uint32_t pack16(float lo, float hi) {
  if constexpr (T == qa::kF16) {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  } else {
    return qa::pack_bf16(lo, hi);
  }
}

// acc (64 x N) = A . B^T over W columns in 16-column depth steps: A's 64
// rows and B's N rows K-major in 64-column blocks (64 * 128 and N * 128
// bytes apart).
template <int N, int T, int W>
__device__ __forceinline__ void ss_product(float (&acc)[N / 2], uint32_t a_addr, uint32_t b_addr) {
#pragma unroll
  for (int st = 0; st < W / 16; ++st) {
    const int blk = st / 4, within = st % 4 * 32;
    const uint64_t a = qa::wgmma_desc(a_addr + blk * 64 * 128 + within, 16, 1024, qa::kSwizzle128);
    const uint64_t b = qa::wgmma_desc(b_addr + blk * N * 128 + within, 16, 1024, qa::kSwizzle128);
    qa::WgmmaSS<N, T>::run(acc, a, b, st > 0);
  }
}

// The two score products of a tile, S = A1 . B1^T and dP = A2 . B2^T, in
// one wgmma group.
template <int N, int T, int W>
__device__ __forceinline__ void score_products(float (&s)[N / 2], float (&dp)[N / 2],
                                               uint32_t a1, uint32_t b1, uint32_t a2,
                                               uint32_t b2) {
  qa::fence_regs(s);
  qa::fence_regs(dp);
  qa::wgmma_fence();
  ss_product<N, T, W>(s, a1, b1);
  ss_product<N, T, W>(dp, a2, b2);
  qa::wgmma_commit();
  qa::wgmma_wait<0>();
  qa::fence_regs(s);
  qa::fence_regs(dp);
}

// acc (64 x N) += A . B: A (64 x DEPTH) packed 16-bit in registers, B the
// DEPTH rows of a tile from the column block at b_addr on, read MN-major
// (64-column blocks DEPTH * 128 bytes apart, 8-row groups 1024).
template <int N, int T, int DEPTH>
__device__ __forceinline__ void rs_product(float (&acc)[N / 2], const uint32_t (&pa)[DEPTH / 16][4],
                                           uint32_t b_addr) {
#pragma unroll
  for (int kk = 0; kk < DEPTH / 16; ++kk) {
    const uint64_t b = qa::wgmma_desc(b_addr + kk * 16 * 128, DEPTH * 128, 1024, qa::kSwizzle128);
    qa::WgmmaRS<N, T>::run(acc, pa[kk], b, 1);
  }
}

// The accumulators of columns 16kk .. 16kk + 15, packed: a k16 A operand.
template <int N, int T>
__device__ __forceinline__ void pack_a(uint32_t (&pa)[N / 16][4], const float (&x)[N / 2]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
#pragma unroll
    for (int r = 0; r < 4; ++r) pa[kk][r] = pack16<T>(x[8 * kk + 2 * r], x[8 * kk + 2 * r + 1]);
  }
}

template <int T>
__device__ __forceinline__ void store2(void* p, size_t idx, float x0, float x1) {
  if constexpr (T == qa::kF16) {
    *reinterpret_cast<__half2*>(static_cast<__half*>(p) + idx) = __floats2half2_rn(x0, x1);
  } else {
    *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(p) + idx) =
        __floats2bfloat162_rn(x0, x1);
  }
}

// K2. tm_q / tm_do map (B * Hq, Sq, D), tm_k / tm_v (B * Hkv, Skv, D), all
// of element type T; stats (B * Hq, Sq_pad, 4) fp32 rows (m, 1/l, D, 0),
// zero past Sq; dq (B, Hq, Sq, D) of T.
template <int W, int T>
__global__ void __launch_bounds__(DqCfg<W>::kThreads, 1)
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_do,
                    const float4* __restrict__ stats, void* __restrict__ dq, int Hq, int Hkv,
                    int Sq, int Sq_pad, int Skv, int D, int causal, int left, int right,
                    float score_scale, float sm_scale) {
  using C = DqCfg<W>;
  constexpr int kBN = C::kBN, kOD = C::kOD;
  constexpr int kBlocks = Rows<W>::kBlocks;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (qa::smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* Qs = smem;
  unsigned char* dOs = smem + C::kDOOff;
  unsigned char* Ks = smem + C::kKOff;
  unsigned char* Vs = smem + C::kVOff;
  uint64_t* full_q = reinterpret_cast<uint64_t*>(smem + C::kBarOff);
  uint64_t* full = full_q + 1;
  uint64_t* empty = full + kStages;

  const int hq = blockIdx.x / C::kSplits, b = blockIdx.y;
  const int col0 = blockIdx.x % C::kSplits * kOD;  // this CTA's first dQ column
  // Under the causal mask the last Q blocks see the most KV tiles: run them first.
  const int mb = causal ? gridDim.z - 1 - blockIdx.z : blockIdx.z;
  const int hk = hq / (Hq / Hkv);
  const int q0 = mb * C::kBM;
  const int bh_q = b * Hq + hq, bh_k = b * Hkv + hk;
  // The KV rows the block's rows can see: [kv_begin, kv_end).
  const int up = causal ? 0 : right;
  const int kv_begin = max(0, q0 - left);
  const int kv_end = min(Skv, max(0, q0 + C::kBM + up));
  const int tile0 = kv_begin / kBN;
  const int ntiles = max(0, (kv_end + kBN - 1) / kBN - tile0);

  // Thread 0 loads tile i (KV rows from (tile0 + i) * kBN) into stage
  // i % kStages once the consumers have released the tile that used it before.
  auto load_tile = [&](int i) {
    const int s = i % kStages;
    const int n0 = (tile0 + i) * kBN;
    qa::mbar_wait(&empty[s], ((i / kStages) & 1) ^ 1);
    qa::mbar_expect_tx(&full[s], 2 * kBlocks * kBN * 128);
    for (int c = 0; c < kBlocks; ++c) {
      qa::tma_load_3d(Ks + s * C::kKBytes + c * kBN * 128, &tm_k, &full[s], c * 64, n0, bh_k);
      qa::tma_load_3d(Vs + s * C::kKBytes + c * kBN * 128, &tm_v, &full[s], c * 64, n0, bh_k);
    }
    qa::mbar_arrive(&full[s]);
  };

  if (threadIdx.x == 0) {
    qa::mbar_init(full_q, 1);
    for (int s = 0; s < kStages; ++s) {
      qa::mbar_init(&full[s], 1);
      qa::mbar_init(&empty[s], C::kThreads);
    }
    qa::mbar_init_fence();
    qa::tma_prefetch(&tm_q);
    qa::tma_prefetch(&tm_k);
    qa::tma_prefetch(&tm_v);
    qa::tma_prefetch(&tm_do);
    qa::mbar_expect_tx(full_q, 2 * C::kConsumers * kBlocks * 64 * 128);
    for (int w = 0; w < C::kConsumers; ++w) {
      for (int c = 0; c < kBlocks; ++c) {
        const int off = (w * kBlocks + c) * 64 * 128;
        qa::tma_load_3d(Qs + off, &tm_q, full_q, c * 64, q0 + 64 * w, bh_q);
        qa::tma_load_3d(dOs + off, &tm_do, full_q, c * 64, q0 + 64 * w, bh_q);
      }
    }
    qa::mbar_arrive(full_q);
    for (int i = 0; i < min(kAhead, ntiles); ++i) load_tile(i);
  }
  __syncthreads();

  // Consumer warpgroup cw: Q rows q0 + 64 cw .. + 63; this thread's rows
  // row0 and row1 (the accumulator layout of hopper.cuh).
  const int cw = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int r_base = q0 + 64 * cw;
  const int row0 = r_base + warp * 16 + g, row1 = row0 + 8;
  const size_t rb = static_cast<size_t>(bh_q) * Sq;
  const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);
  const float4 st0 = row0 < Sq ? stats[static_cast<size_t>(bh_q) * Sq_pad + row0] : zero4;
  const float4 st1 = row1 < Sq ? stats[static_cast<size_t>(bh_q) * Sq_pad + row1] : zero4;
  // Warpgroup-uniform tile classes: this warpgroup's rows are p_lo .. p_hi.
  const bool active = r_base < Sq;
  const int p_lo = r_base, p_hi = min(r_base + 63, Sq - 1);
  const uint32_t q_addr = qa::smem_addr(Qs + cw * kBlocks * 64 * 128);
  const uint32_t do_addr = qa::smem_addr(dOs + cw * kBlocks * 64 * 128);

  float acc[kOD / 2];
#pragma unroll
  for (int i = 0; i < kOD / 2; ++i) acc[i] = 0.f;

  qa::mbar_wait(full_q, 0);
  for (int i = 0; i < ntiles; ++i) {
    const int s = i % kStages;
    const int n0 = (tile0 + i) * kBN;
    const bool skip = !active || n0 > p_hi + up || n0 + kBN - 1 < p_lo - left;
    const bool unmasked = n0 + kBN - 1 <= p_lo + up && n0 >= p_hi - left && n0 + kBN <= Skv;
    qa::mbar_wait(&full[s], (i / kStages) & 1);
    if (!skip) {
      const uint32_t k_addr = qa::smem_addr(Ks + s * C::kKBytes);
      const uint32_t v_addr = qa::smem_addr(Vs + s * C::kKBytes);
      float sc[kBN / 2], dp[kBN / 2];
      score_products<kBN, T, W>(sc, dp, q_addr, k_addr, do_addr, v_addr);
      // P from the saved (m, l), then dS = P o (dP - D), kept in sc.
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float p0 = exp2f(sc[4 * j + e] * score_scale - st0.x) * st0.y;
          float p1 = exp2f(sc[4 * j + 2 + e] * score_scale - st1.x) * st1.y;
          if (!unmasked) {
            const int col = n0 + j * 8 + t * 2 + e;
            const bool in = col < Skv;
            p0 = in && col <= row0 + up && col >= row0 - left && st0.y != 0.f ? p0 : 0.f;
            p1 = in && col <= row1 + up && col >= row1 - left && st1.y != 0.f ? p1 : 0.f;
          }
          sc[4 * j + e] = p0 * (dp[4 * j + e] - st0.z);
          sc[4 * j + 2 + e] = p1 * (dp[4 * j + 2 + e] - st1.z);
        }
      }
      // dQ += dS.K: dS packed is the A operand.
      uint32_t pa[kBN / 16][4];
      pack_a<kBN, T>(pa, sc);
      qa::fence_regs(pa);
      qa::fence_regs(acc);
      qa::wgmma_fence();
      rs_product<kOD, T, kBN>(acc, pa, k_addr + col0 / 64 * kBN * 128);
      qa::wgmma_commit();
      qa::wgmma_wait<0>();
      qa::fence_regs(acc);
    }
    qa::mbar_arrive(&empty[s]);
    if (threadIdx.x == 0 && i + kAhead < ntiles) load_tile(i + kAhead);
    __syncwarp();
  }

#pragma unroll
  for (int j = 0; j < kOD / 8; ++j) {
    const int c = col0 + j * 8 + t * 2;
    if (c >= D) continue;
    if (row0 < Sq) store2<T>(dq, (rb + row0) * D + c, acc[4 * j] * sm_scale, acc[4 * j + 1] * sm_scale);
    if (row1 < Sq) {
      store2<T>(dq, (rb + row1) * D + c, acc[4 * j + 2] * sm_scale, acc[4 * j + 3] * sm_scale);
    }
  }
}

// K3. Maps as K2's; stats as K2's; dk, dv (B, Hkv, Skv, D) of T. Launched
// in clusters of (c, 1, 1) CTAs along x = hk * c + rank; each CTA covers the
// q heads hk * G + rank * heads + 0 .. heads - 1 (G = c * heads).
template <int W, int T>
__global__ void __launch_bounds__(DkvCfg<W>::kThreads, 1)
flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_do,
                     const float4* __restrict__ stats, void* __restrict__ dk, void* __restrict__ dv,
                     int Hq, int Hkv, int Sq, int Sq_pad, int Skv, int D, int causal, int left,
                     int right, float score_scale, float sm_scale, int heads) {
  using C = DkvCfg<W>;
  constexpr int kBQ = C::kBQ, kOD = C::kOD;
  constexpr int kBlocks = Rows<W>::kBlocks;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (qa::smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* Ks = smem;
  unsigned char* Vs = smem + C::kVOff;
  unsigned char* Qs = smem + C::kQOff;
  unsigned char* dOs = smem + C::kDOOff;
  unsigned char* Ss = smem + C::kStatOff;
  uint64_t* full_kv = reinterpret_cast<uint64_t*>(smem + C::kBarOff);
  uint64_t* full = full_kv + 1;
  uint64_t* empty = full + kStages;

  cg::cluster_group cluster = cg::this_cluster();
  const int ranks = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int hk = blockIdx.x / ranks, b = blockIdx.z;
  const int nb = blockIdx.y / C::kSplits;  // the heaviest causal KV blocks come first
  const int col0 = blockIdx.y % C::kSplits * kOD;
  const int h_first = hk * (Hq / Hkv) + rank * heads;
  const int n0 = nb * C::kBM;
  const int bh_k = b * Hkv + hk;
  // The Q rows that can see this block's columns: from the diagonal (top-left
  // causal) or the right window edge down to the last row whose window
  // reaches the block's last column.
  const int up = causal ? 0 : right;
  const int q_begin = max(0, n0 - up) / kBQ * kBQ;
  const int q_end = min(Sq, n0 + C::kBM + left);
  const int nq = q_end > q_begin ? (q_end - q_begin + kBQ - 1) / kBQ : 0;
  const int ntiles = heads * nq;

  // Thread 0 loads tile i (q head h_first + i / nq, Q rows from
  // q_begin + (i % nq) * kBQ) with its rows' statistics.
  auto load_tile = [&](int i) {
    const int s = i % kStages;
    const int bh_q = b * Hq + h_first + i / nq;
    const int q0 = q_begin + i % nq * kBQ;
    qa::mbar_wait(&empty[s], ((i / kStages) & 1) ^ 1);
    qa::mbar_expect_tx(&full[s], 2 * kBlocks * kBQ * 128 + C::kStatBytes);
    for (int c = 0; c < kBlocks; ++c) {
      qa::tma_load_3d(Qs + s * C::kQBytes + c * kBQ * 128, &tm_q, &full[s], c * 64, q0, bh_q);
      qa::tma_load_3d(dOs + s * C::kQBytes + c * kBQ * 128, &tm_do, &full[s], c * 64, q0, bh_q);
    }
    qa::bulk_load(Ss + s * C::kStatBytes, stats + static_cast<size_t>(bh_q) * Sq_pad + q0,
                  C::kStatBytes, &full[s]);
    qa::mbar_arrive(&full[s]);
  };

  if (threadIdx.x == 0) {
    qa::mbar_init(full_kv, 1);
    for (int s = 0; s < kStages; ++s) {
      qa::mbar_init(&full[s], 1);
      qa::mbar_init(&empty[s], C::kThreads);
    }
    qa::mbar_init_fence();
    qa::tma_prefetch(&tm_q);
    qa::tma_prefetch(&tm_k);
    qa::tma_prefetch(&tm_v);
    qa::tma_prefetch(&tm_do);
    qa::mbar_expect_tx(full_kv, 2 * C::kConsumers * kBlocks * 64 * 128);
    for (int w = 0; w < C::kConsumers; ++w) {
      for (int c = 0; c < kBlocks; ++c) {
        const int off = (w * kBlocks + c) * 64 * 128;
        qa::tma_load_3d(Ks + off, &tm_k, full_kv, c * 64, n0 + 64 * w, bh_k);
        qa::tma_load_3d(Vs + off, &tm_v, full_kv, c * 64, n0 + 64 * w, bh_k);
      }
    }
    qa::mbar_arrive(full_kv);
    for (int i = 0; i < min(kAhead, ntiles); ++i) load_tile(i);
  }
  __syncthreads();

  // Consumer warpgroup cw: KV rows n0 + 64 cw .. + 63; this thread's rows
  // kv0 and kv1. Columns of its accumulators are Q rows of the tile.
  const int cw = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int k_lo = n0 + 64 * cw;
  const int kv0 = k_lo + warp * 16 + g, kv1 = kv0 + 8;
  const bool active = k_lo < Skv;
  const uint32_t k_addr = qa::smem_addr(Ks + cw * kBlocks * 64 * 128);
  const uint32_t v_addr = qa::smem_addr(Vs + cw * kBlocks * 64 * 128);

  float dk_acc[kOD / 2], dv_acc[kOD / 2];
#pragma unroll
  for (int i = 0; i < kOD / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;

  qa::mbar_wait(full_kv, 0);
  for (int i = 0; i < ntiles; ++i) {
    const int s = i % kStages;
    const int q0 = q_begin + i % nq * kBQ;
    // Warpgroup-uniform classes: every (kv, q) of the tile masked, or none.
    const bool skip = !active || q0 + kBQ - 1 + up < k_lo || q0 - left > k_lo + 63;
    const bool unmasked = q0 + up >= k_lo + 63 && q0 + kBQ - 1 - left <= k_lo && k_lo + 64 <= Skv &&
                          q0 + kBQ <= Sq;
    qa::mbar_wait(&full[s], (i / kStages) & 1);
    if (!skip) {
      const uint32_t qt_addr = qa::smem_addr(Qs + s * C::kQBytes);
      const uint32_t dot_addr = qa::smem_addr(dOs + s * C::kQBytes);
      const float4* qst = reinterpret_cast<const float4*>(Ss + s * C::kStatBytes);
      float st[kBQ / 2], dpt[kBQ / 2];
      score_products<kBQ, T, W>(st, dpt, k_addr, qt_addr, v_addr, dot_addr);
      // P^T (kept in st) and dS^T = P^T o (dP^T - D) (kept in dpt).
#pragma unroll
      for (int j = 0; j < kBQ / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int cl = j * 8 + t * 2 + e;
          const float4 sq = qst[cl];
          float p0 = exp2f(st[4 * j + e] * score_scale - sq.x) * sq.y;
          float p1 = exp2f(st[4 * j + 2 + e] * score_scale - sq.x) * sq.y;
          if (!unmasked) {
            const int qc = q0 + cl;
            p0 = sq.y != 0.f && kv0 < Skv && kv0 <= qc + up && kv0 >= qc - left ? p0 : 0.f;
            p1 = sq.y != 0.f && kv1 < Skv && kv1 <= qc + up && kv1 >= qc - left ? p1 : 0.f;
          }
          st[4 * j + e] = p0;
          st[4 * j + 2 + e] = p1;
          dpt[4 * j + e] = p0 * (dpt[4 * j + e] - sq.z);
          dpt[4 * j + 2 + e] = p1 * (dpt[4 * j + 2 + e] - sq.z);
        }
      }
      uint32_t pa[kBQ / 16][4], sa[kBQ / 16][4];
      pack_a<kBQ, T>(pa, st);
      pack_a<kBQ, T>(sa, dpt);
      qa::fence_regs(pa);
      qa::fence_regs(sa);
      qa::fence_regs(dv_acc);
      qa::fence_regs(dk_acc);
      qa::wgmma_fence();
      rs_product<kOD, T, kBQ>(dv_acc, pa, dot_addr + col0 / 64 * kBQ * 128);
      rs_product<kOD, T, kBQ>(dk_acc, sa, qt_addr + col0 / 64 * kBQ * 128);
      qa::wgmma_commit();
      qa::wgmma_wait<0>();
      qa::fence_regs(dv_acc);
      qa::fence_regs(dk_acc);
    }
    qa::mbar_arrive(&empty[s]);
    if (threadIdx.x == 0 && i + kAhead < ntiles) load_tile(i + kAhead);
    __syncwarp();
  }

  // Every consumer is past its last product: the tiles' shared memory
  // takes this CTA's fp32 dK (times sm_scale) and dV rows.
  __syncthreads();
  float* red = reinterpret_cast<float*>(smem);
  const int r0 = 64 * cw + warp * 16 + g;
#pragma unroll
  for (int j = 0; j < kOD / 8; ++j) {
    const int c = j * 8 + t * 2;
    *reinterpret_cast<float2*>(red + r0 * C::kRedStride + c) =
        make_float2(dk_acc[4 * j] * sm_scale, dk_acc[4 * j + 1] * sm_scale);
    *reinterpret_cast<float2*>(red + (r0 + 8) * C::kRedStride + c) =
        make_float2(dk_acc[4 * j + 2] * sm_scale, dk_acc[4 * j + 3] * sm_scale);
    *reinterpret_cast<float2*>(red + (C::kBM + r0) * C::kRedStride + c) =
        make_float2(dv_acc[4 * j], dv_acc[4 * j + 1]);
    *reinterpret_cast<float2*>(red + (C::kBM + r0 + 8) * C::kRedStride + c) =
        make_float2(dv_acc[4 * j + 2], dv_acc[4 * j + 3]);
  }

  // The group sum: after the cluster barrier every rank's rows are in its
  // shared memory; rank r sums its share of the rows over ranks 0, 1, ...
  // in order and stores them. The second barrier keeps each CTA's shared
  // memory alive until its peers have read it.
  cluster.sync();
  const int per = (C::kBM + ranks - 1) / ranks;
  const int r_lo = rank * per, r_hi = min(C::kBM, r_lo + per);
  const int n_rows = max(0, r_hi - r_lo);
  constexpr int kC4 = kOD / 4;
  for (int idx = threadIdx.x; idx < 2 * n_rows * kC4; idx += C::kThreads) {
    const int which = idx / (n_rows * kC4), rem = idx % (n_rows * kC4);
    const int row = r_lo + rem / kC4, c4 = rem % kC4;
    const int grow = n0 + row, col = col0 + 4 * c4;
    if (grow >= Skv || col >= D) continue;
    const float* src = red + (which * C::kBM + row) * C::kRedStride + 4 * c4;
    float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int r = 0; r < ranks; ++r) {
      const float4 x = *reinterpret_cast<const float4*>(cluster.map_shared_rank(src, r));
      sum.x += x.x;
      sum.y += x.y;
      sum.z += x.z;
      sum.w += x.w;
    }
    const size_t o = (static_cast<size_t>(bh_k) * Skv + grow) * D + col;
    void* dst = which ? dv : dk;
    store2<T>(dst, o, sum.x, sum.y);
    store2<T>(dst, o + 2, sum.z, sum.w);
  }
  cluster.sync();
}

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// The four tensor maps of one launch: Q and dO in boxes of q_rows rows,
// K and V in boxes of kv_rows.
cudaError_t encode_maps(CUtensorMap (&tm)[4], const void* q, const void* k, const void* v,
                        const void* dout, int code, int B, int Hq, int Hkv, int Sq, int Skv, int D,
                        int q_rows, int kv_rows) {
  cudaError_t err = qa::encode_tensor_map(&tm[0], q, code, D, Sq, B * Hq, 64, q_rows, 128);
  if (err == cudaSuccess) err = qa::encode_tensor_map(&tm[1], k, code, D, Skv, B * Hkv, 64, kv_rows, 128);
  if (err == cudaSuccess) err = qa::encode_tensor_map(&tm[2], v, code, D, Skv, B * Hkv, 64, kv_rows, 128);
  if (err == cudaSuccess) err = qa::encode_tensor_map(&tm[3], dout, code, D, Sq, B * Hq, 64, q_rows, 128);
  return err;
}

// Arguments shared by both kernels' launches.
struct Args {
  const void *q, *k, *v, *dout;
  const float4* stats;
  int B, Hq, Hkv, Sq, Sq_pad, Skv, D, causal, left, right;
  float score_scale, sm_scale;
  cudaStream_t stream;
};

template <int W, int T>
int launch_dq(const Args& a, void* dq) {
  using C = DqCfg<W>;
  CUtensorMap tm[4];
  cudaError_t err = encode_maps(tm, a.q, a.k, a.v, a.dout, T, a.B, a.Hq, a.Hkv, a.Sq, a.Skv, a.D,
                                64, C::kBN);
  if (err == cudaSuccess) err = set_smem(flash_bwd_dq_kernel<W, T>, C::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(a.Hq * C::kSplits, a.B, (a.Sq + C::kBM - 1) / C::kBM);
  flash_bwd_dq_kernel<W, T><<<grid, C::kThreads, C::kSmem, a.stream>>>(
      tm[0], tm[1], tm[2], tm[3], a.stats, dq, a.Hq, a.Hkv, a.Sq, a.Sq_pad, a.Skv, a.D, a.causal,
      a.left, a.right, a.score_scale, a.sm_scale);
  return static_cast<int>(cudaGetLastError());
}

// CTAs per cluster of K3: the largest divisor of the group G up to the
// portable cluster size 8.
int dkv_cluster(int G) {
  for (int c = G < 8 ? G : 8; c > 1; --c) {
    if (G % c == 0) return c;
  }
  return 1;
}

template <int W, int T>
int launch_dkv(const Args& a, void* dk, void* dv) {
  using C = DkvCfg<W>;
  CUtensorMap tm[4];
  cudaError_t err = encode_maps(tm, a.q, a.k, a.v, a.dout, T, a.B, a.Hq, a.Hkv, a.Sq, a.Skv, a.D,
                                C::kBQ, 64);
  if (err == cudaSuccess) err = set_smem(flash_bwd_dkv_kernel<W, T>, C::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int G = a.Hq / a.Hkv;
  const int ranks = dkv_cluster(G);
  cudaLaunchConfig_t launch = {};
  launch.gridDim = dim3(a.Hkv * ranks, (a.Skv + C::kBM - 1) / C::kBM * C::kSplits, a.B);
  launch.blockDim = dim3(C::kThreads, 1, 1);
  launch.dynamicSmemBytes = C::kSmem;
  launch.stream = a.stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = ranks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  launch.attrs = attr;
  launch.numAttrs = 1;
  err = cudaLaunchKernelEx(&launch, flash_bwd_dkv_kernel<W, T>, tm[0], tm[1], tm[2], tm[3],
                           a.stats, dk, dv, a.Hq, a.Hkv, a.Sq, a.Sq_pad, a.Skv, a.D, a.causal,
                           a.left, a.right, a.score_scale, a.sm_scale, G / ranks);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <int W>
int launch_dq_t(int code, const Args& a, void* dq) {
  return code == qa::kF16 ? launch_dq<W, qa::kF16>(a, dq) : launch_dq<W, qa::kBF16>(a, dq);
}

template <int W>
int launch_dkv_t(int code, const Args& a, void* dk, void* dv) {
  return code == qa::kF16 ? launch_dkv<W, qa::kF16>(a, dk, dv)
                          : launch_dkv<W, qa::kBF16>(a, dk, dv);
}

bool bad_args(int code, int D, int Hq, int Hkv, int Sq, int Sq_pad) {
  return (code != qa::kBF16 && code != qa::kF16) || qa::kernel_width(D) == 0 || Hkv <= 0 ||
         Hq % Hkv != 0 || Sq_pad < Sq || Sq_pad % 64 != 0;
}

}  // namespace

// Shared by both entries: q, dout (B, Hq, Sq, D) and k, v (B, Hkv, Skv, D)
// contiguous, 16-byte aligned, all of element type `code` (bf16 or fp16);
// stats (B, Hq, Sq_pad, 4) fp32 rows (m, 1/l, D, 0) of each Q row, zero
// past Sq, Sq_pad a multiple of 64 at least Sq: the forward's residuals in
// the exp2 domain of score_scale = sm_scale * log2(e), 1/l = 0 where l = 0,
// and D = rowsum(dO o O). D (the head dim) is a multiple of 8 up to 512.
// left, right: the window's extents (row i sees keys [i - left, i + right]),
// 1 << 30 for an unbounded side; the causal mask ignores right.
extern "C" int qa_flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                               const void* stats, void* dq, int B, int Hq, int Hkv, int Sq,
                               int Sq_pad, int Skv, int D, int code, int causal, int left,
                               int right, float score_scale, float sm_scale, void* stream) {
  if (Sq == 0 || B == 0) return 0;
  if (bad_args(code, D, Hq, Hkv, Sq, Sq_pad) || Skv <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{q, k, v, dout, static_cast<const float4*>(stats), B, Hq, Hkv, Sq, Sq_pad, Skv, D,
               causal, left, right, score_scale, sm_scale, static_cast<cudaStream_t>(stream)};
  switch (qa::kernel_width(D)) {
    case 64:
      return launch_dq_t<64>(code, a, dq);
    case 128:
      return launch_dq_t<128>(code, a, dq);
    case 256:
      return launch_dq_t<256>(code, a, dq);
    default:
      return launch_dq_t<512>(code, a, dq);
  }
}

extern "C" int qa_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                                const void* stats, void* dk, void* dv, int B, int Hq, int Hkv,
                                int Sq, int Sq_pad, int Skv, int D, int code, int causal,
                                int left, int right, float score_scale, float sm_scale,
                                void* stream) {
  if (Skv == 0 || B == 0) return 0;
  if (bad_args(code, D, Hq, Hkv, Sq, Sq_pad)) return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k, v, dout, static_cast<const float4*>(stats), B, Hq, Hkv, Sq, Sq_pad, Skv, D,
               causal, left, right, score_scale, sm_scale, static_cast<cudaStream_t>(stream)};
  switch (qa::kernel_width(D)) {
    case 64:
      return launch_dkv_t<64>(code, a, dk, dv);
    case 128:
      return launch_dkv_t<128>(code, a, dk, dv);
    case 256:
      return launch_dkv_t<256>(code, a, dk, dv);
    default:
      return launch_dkv_t<512>(code, a, dk, dv);
  }
}
