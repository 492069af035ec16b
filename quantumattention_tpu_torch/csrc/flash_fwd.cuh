// K1: fused attention forward for Hopper (sm_90a), warp-specialised. The
// kernel template; its C entry is in flash_fwd.cu.
//
// Replaces the Pallas kernel quantumattention_tpu/ops/flash.py::_flash_kernel
// (flash.py:123; host entry flash_attention, flash.py:701). Same math:
// S = Q.K^T with scale_q * scale_k * sm_scale * log2(e) folded into the
// scores, an exp2-domain online softmax with fp32 running max / sum /
// accumulator, P rounded to bf16 (fp16 when V is fp16) for P.V with fp32
// accumulation, top-left causal and ragged-KV-tail masks with MASK_VALUE
// (not -inf), GQA by KV-head index (q head hq reads KV head hq / G). With a
// position offsets (chunked prefill: q's row 0 sits at global position
// q_offset, K's row 0 at kv_offset) every mask compares global positions,
// q_offset + i >= kv_offset + j under the causal mask (flash.py:862-875).
// A sliding window (left, right) keeps the keys at positions
// [p - left, p + right] of query position p (flash.py:398-409; the right
// extent is inactive under the causal mask, where the wrapper passes it
// unbounded, 1 << 30). A row that sees no key stores zeros, as JAX's kernel
// does by its running max (flash.py:573-578). JAX's per-block mode, which
// quantizes each Q and K tile inside the kernel (flash.py:227-318), runs
// here as the token-wise mode over the row scales of the pre-pass
// block_quant.cu: S = (q8 . k8^T) * (s_q * score_scale) * s_k, the JAX
// function up to the order of that fp32 product, at any block size.
// Three modes ride on runtime pointers, null when off (flash.py:163-177,
// :413-450, :501-515): segment ids (a key is kept when its id equals the
// query's), a block-sparse bitmap of 128 x 128 granules (kGranule) walked
// through a per-Q-block list of the KV tiles that hold an active granule
// (ops/flash.block_table, built on the device), and an int8 V with
// per-channel scales (B, Hkv, D) applied to the output's columns. A call
// with any of them runs flash_fwd_modes_kernel (flash_fwd_modes.cu), the
// same body compiled with the modes in; every other call runs
// flash_fwd_kernel, compiled without them. One kernel for both cost dense
// calls 7% on the H100 (fp8 head-wise at B = 1, 32/8 heads, S = 1536,
// D = 128: 0.0575 against 0.0538 ms), ptxas spilling under the 128
// registers of 512 threads.
//
// What bounds it on the H100: operations. Q.K^T runs at the tensor cores'
// fp8 (or int8) peak of 1979 TFLOP/s when Q and K are 8-bit, P.V at bf16's
// 989; each is 2 * S^2 * D flops a head (half under the causal mask), far
// above the card's balance point at any S worth a kernel. The design feeds
// the tensor cores through TMA and wgmma only:
//  - one CTA per (q head, batch, Q block), the heaviest causal Q blocks
//    first; a producer warpgroup that lowers its registers
//    (setmaxnreg.dec) and three consumer warpgroups (two at D = 256) that
//    raise theirs (setmaxnreg.inc), each consumer owning 64 Q rows. At
//    widths 64 and 128 a second tile configuration (two consumers, KV
//    tiles of 128 rows; flash_fwd_q2.cu) runs where the autotuner's cache
//    names it for the shape class (ops/flash.py, autotune.py);
//  - one producer thread starts every TMA load: Q once, then K and V tiles
//    into a two-stage ring with full and empty mbarriers. The tensor maps
//    are 3-D over (D, S, B * H), so rows past S read as zeros, never as the
//    next head's rows, and only the ragged last tile needs a column mask.
//    128-byte swizzled boxes (64 bytes for an 8-bit D = 64) match the wgmma
//    descriptors. KV tiles wholly above the causal diagonal (shifted by
//    the offsets) or outside the window of every row of the CTA are never
//    loaded: a Q block's KV range starts at the first tile that its lowest
//    row can see and ends after the last that its highest row can;
//  - Q.K^T is wgmma on the operands' own type, both K-major in shared
//    memory: e4m3 x e4m3 and int8 x int8 (exact int32) at k32, bf16 and
//    fp16 at k16. No 8-bit operand is widened;
//  - the scores stay in registers: scales, masks (only on diagonal,
//    window-edge and ragged tiles; tiles wholly inside every row's range
//    run without them) and
//    the online softmax, then P packed to 16 bits is the register A operand
//    of P.V, whose B is the V tile read MN-major through the transpose bit;
//  - an e4m3 V (fp8 wgmma takes K-major B only) is widened to bf16 in
//    shared memory by the producer warpgroup, in the same swizzled layout;
//  - token-wise column scales, and the KV segment ids, come into shared
//    memory with their tile, by plain loads of the producer warpgroup (a
//    (B * H, Skv) fp32 row is not 16-byte aligned for a bulk copy); each
//    consumer thread keeps its two rows' q ids in registers, and a tile
//    with segment ids always takes the masked arm of the scores;
//  - a block mask: the producer and the consumers walk the CTA's entries of
//    the tile list in place of its KV range, so tiles with no active
//    granule are neither loaded nor computed. A consumer's 64 Q rows and a
//    KV tile (32, 64 or 128 keys) lie inside one granule, so the bitmap
//    is one bit per (consumer, tile): a consumer whose bit is off leaves
//    its accumulator as it is (it still waits and arrives on the
//    barriers), and no element mask is needed;
//  - an int8 V is widened to bf16 in shared memory like an e4m3 V (its
//    codes are exact in bf16), P stays bf16, and the epilogue multiplies
//    each output column by its scale. JAX rounds P to round(127 p) int8
//    there for the TPU's 8-bit matrix unit; the port keeps P in bf16;
//  - head dims: any multiple of 8 up to 512, as the JAX package takes. The
//    kernel is instantiated at widths 64, 128, 256 and 512 (qa::kernel_width
//    rounds D up). The tensor maps' inner extent is D itself and the boxes
//    keep the instantiated width, so TMA writes zeros into the columns past
//    D (a box wholly past D reads as zeros too): they change neither Q.K^T
//    nor P.V, and stores write the D real columns only. Both products run
//    over the whole instantiated width, so they waste (W - D) / W of their
//    work (D = 72 or 96 at W = 128: 44% or 25%; D = 160 at 256: 38%): a
//    depth cut at D between wgmma instructions made this kernel 29% slower
//    at D = 128 on the H100 (0.0686 against 0.0532 ms at B = 1, Hq = 32,
//    S = 1536, fp8 head-wise, causal), as it made ptxas serialise K2/K3's. At
//    W = 512 one CTA's 64 x 512 fp32 accumulator would need 256 registers
//    a thread: two CTAs share each Q block, each computing Q.K^T and the
//    softmax over the full D and P.V for its 256 output columns (one
//    consumer warpgroup: Q 64 KB, K 32 KB and V's half 16 KB a stage). That
//    doubles the Q.K^T work at those widths; D = 320 wastes 37.5% of P.V
//    besides. A tensor map's row stride must be a multiple of 16 bytes, so
//    8-bit Q/K of D % 16 == 8 come zero-padded to D + 8 from the wrapper
//    (ops/flash.py).
// Left for later (ROADMAP queue 2): ping-pong scheduling of the consumers,
// overlap of one tile's softmax with the next tile's Q.K^T inside a
// warpgroup, a persistent grid, and fp8 P.V.
#pragma once

#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"

namespace qa {
namespace k1 {

constexpr int kStages = 2;
// The block mask's granule, in rows and keys (JAX's MASK_GRANULE).
constexpr int kGranule = 128;

// Tile sizes and the shared-memory layout for the instantiated width W, the
// element code QK of Q and K, and the tile configuration V: 0 the default,
// 1 (W = 64 and 128 only, instantiated in flash_fwd_q2.cu) two consumer
// warpgroups (128 Q rows a CTA) over KV tiles of 128 rows, the autotuner's
// other candidate (autotune.K1_TILES mirrors both).
template <int W, int QK, int V = 0>
struct Cfg {
  static_assert(V == 0 || (V == 1 && W <= 128), "tile configuration");
  static constexpr int kEs = (QK == qa::kBF16 || QK == qa::kF16) ? 2 : 1;
  static constexpr int kOD = W > 256 ? 256 : W;      // output columns a CTA owns
  static constexpr int kSplits = W / kOD;            // CTAs sharing a Q block
  // Consumer warpgroups (64 Q rows each) and KV rows per tile, chosen by
  // measurement on the H100 (PERF.md): three consumers at W = 64 and 128
  // (tiles of 64 rows at 128, to fit 160 registers), two at 256, whose
  // 128-float accumulator leaves room for tiles of 32 rows only (64 spill
  // three times as much), one at 512 (Q alone is 64 KB a warpgroup).
  static constexpr int kConsumers = V == 1 ? 2 : W == 512 ? 1 : W == 256 ? 2 : 3;
  static constexpr int kBN = V == 1 || W == 64 ? 128 : W == 128 ? 64 : 32;
  static constexpr int kThreads = 128 * (kConsumers + 1);
  // setmaxnreg: the producer gives its registers to the consumers. ptxas
  // compiles every warpgroup's code under the launch bound's cap (168
  // registers at 384 threads, 128 at 512), so the consumers' code never
  // uses more than that; one consumer (256 threads) has the full 255 and
  // no need to move registers.
  static constexpr bool kRealloc = kConsumers > 1;
  static constexpr int kProducerRegs = kConsumers == 3 ? 32 : 24;
  static constexpr int kConsumerRegs = kConsumers == 3 ? 160 : 240;
  static_assert(!kRealloc || kProducerRegs * 128 + kConsumerRegs * 128 * kConsumers <= 65536,
                "register file of one SM");
  static constexpr int kBM = 64 * kConsumers;        // Q rows per CTA
  static constexpr int kRowBytes = W * kEs;          // a Q or K row
  static constexpr int kSpan = kRowBytes < 128 ? kRowBytes : 128;  // swizzle span
  static constexpr int kSwizzle = kSpan == 128 ? qa::kSwizzle128 : qa::kSwizzle64;
  static constexpr int kSpanElems = kSpan / kEs;     // TMA box columns of Q and K
  static constexpr int kBlocks = kRowBytes / kSpan;  // column blocks of a Q or K row
  static constexpr int kSteps = kRowBytes / 32;      // wgmma depth steps of Q.K^T
  static constexpr int kQBytes = kBM * kRowBytes;
  static constexpr int kKBytes = kBN * kRowBytes;
  static constexpr int kVBytes = kBN * kOD * 2;      // V in shared memory is 16-bit
  static constexpr int kKOff = kQBytes;
  static constexpr int kVOff = kKOff + kStages * kKBytes;
  static constexpr int kScaleOff = kVOff + kStages * kVBytes;
  static constexpr int kBarOff = kScaleOff + kStages * kBN * 4;
  static constexpr int kSegOff = kBarOff + (1 + 3 * kStages) * 8;  // KV segment ids (modes only)
  static constexpr int kSmem = kSegOff + 1024;                      // + alignment slack
  static constexpr int kSmemModes = kSmem + kStages * kBN * 4;
  static_assert(kQBytes % 1024 == 0 && kKBytes % 1024 == 0 && kVBytes % 1024 == 0, "1024-byte tiles");
  static_assert(kSmemModes <= 232448, "shared memory of one CTA");
  // A consumer's 64 rows and a KV tile lie inside one granule: the block
  // mask is one bit per (consumer, tile).
  static_assert(kGranule % 64 == 0 && kGranule % kBN == 0, "granule");
};

// Accumulator type of Q.K^T.
template <int QK>
using ScoreAcc = typename std::conditional<QK == qa::kI8, int, float>::type;

template <int W, int QK, int V>
__device__ __forceinline__ void qk_product(ScoreAcc<QK> (&acc)[Cfg<W, QK, V>::kBN / 2],
                                           uint32_t q_addr, uint32_t k_addr) {
  using C = Cfg<W, QK, V>;
  qa::fence_regs(acc);
  qa::wgmma_fence();
#pragma unroll
  for (int st = 0; st < C::kSteps; ++st) {
    const int blk = st * 32 / C::kSpan, within = st * 32 % C::kSpan;
    const uint64_t a = qa::wgmma_desc(q_addr + blk * 64 * C::kSpan + within, 16, 8 * C::kSpan,
                                      C::kSwizzle);
    const uint64_t b = qa::wgmma_desc(k_addr + blk * C::kBN * C::kSpan + within, 16,
                                      8 * C::kSpan, C::kSwizzle);
    qa::WgmmaSS<C::kBN, QK>::run(acc, a, b, st > 0);
  }
  qa::wgmma_commit();
  qa::wgmma_wait<0>();
  qa::fence_regs(acc);
}

// O += P.V over one tile: P (64 x BN) in registers, V (BN x D) 16-bit in
// shared memory in 64-column 128-byte swizzled blocks.
template <int D, int BN, int T>
__device__ __forceinline__ void pv_product(float (&o)[D / 2], const uint32_t (&pa)[BN / 16][4],
                                           uint32_t v_addr) {
  qa::fence_regs(o);
  qa::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk) {
    const uint64_t b = qa::wgmma_desc(v_addr + kk * 16 * 128, BN * 128, 1024, qa::kSwizzle128);
    qa::WgmmaRS<D, T>::run(o, pa[kk], b, 1);
  }
  qa::wgmma_commit();
  qa::wgmma_wait<0>();
  qa::fence_regs(o);
}

// Eight e4m3 or int8 codes (`code`) to eight bf16 in a uint4 (both exact).
__device__ __forceinline__ uint4 widen8_bf16(uint2 u, int code) {
  const unsigned char* c = reinterpret_cast<const unsigned char*>(&u);
  float f[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    if (code == qa::kE4M3) {
      __nv_fp8_e4m3 x;
      x.__x = c[e];
      f[e] = static_cast<float>(x);
    } else {
      f[e] = static_cast<float>(static_cast<signed char>(c[e]));
    }
  }
  return make_uint4(qa::pack_bf16(f[0], f[1]), qa::pack_bf16(f[2], f[3]), qa::pack_bf16(f[4], f[5]),
                    qa::pack_bf16(f[6], f[7]));
}

// This thread's scores of one tile in the exp2 domain: times the row scale
// (and the token-wise column scale `cs`, or none), masked entries at
// MASK_VALUE when kMask; returns each row's maximum over the thread's
// columns. Column cl of the tile is kept when cl < valid and
// row - left <= c0 + cl <= row + up, c0 = kv_offset + n0 - q_offset (up 0
// under the causal mask, else the window's right extent), and, with the
// tile's KV segment ids `ks`, when ks[cl] is the row's id (qs0, qs1).
template <int BN, bool kMask>
__device__ __forceinline__ void fold_scores(float (&s)[BN / 2], const float* cs, const int* ks,
                                            int qs0, int qs1, float rs0, float rs1, int t,
                                            int valid, int c0, int up, int left, int row0,
                                            int row1, float& mx0, float& mx1) {
  mx0 = qa::kMaskValue;
  mx1 = qa::kMaskValue;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int cl = j * 8 + t * 2 + e;
      const float c = cs != nullptr ? cs[cl] : 1.f;
      float x0 = s[4 * j + e] * rs0 * c, x1 = s[4 * j + 2 + e] * rs1 * c;
      if (kMask) {
        const int c = c0 + cl;
        const bool in = cl < valid;
        const int kid = ks != nullptr ? ks[cl] : 0;
        x0 = in && c <= row0 + up && c >= row0 - left && kid == qs0 ? x0 : qa::kMaskValue;
        x1 = in && c <= row1 + up && c >= row1 - left && kid == qs1 ? x1 : qa::kMaskValue;
      }
      s[4 * j + e] = x0;
      s[4 * j + 2 + e] = x1;
      mx0 = fmaxf(mx0, x0);
      mx1 = fmaxf(mx1, x1);
    }
  }
}

// scaling: 0 none, 1 head-wise (B, H), 2 token-wise (B, H, S). v8: an e4m3
// V (B, Hkv, Skv, D) that the producer widens, or null when tm_v maps a
// 16-bit V. pv_f16: P.V in fp16 (V is fp16), else bf16. m_out / l_out
// (B, Hq, Sq) fp32, both or neither: the residuals of the backward (K2/K3),
// each row's final running max and softmax sum in the exp2 domain of the
// folded scores (flash.py:586-588). D <= W is the tensors' head dim.
// left / right: the window's extents, 1 << 30 for an unbounded side (right
// unbounded under the causal mask). v8_code: v8's element code, kE4M3 or
// kI8; scale_v (B, Hkv, D) fp32, the int8 V's per-channel scales, else
// null. q_seg / kv_seg: (B, Sq) / (B, Skv) int32 segment ids, both or
// neither. tile_count / tile_list (gridDim.z, list_stride) int32: the
// block mask's tile list of each Q block (its first tile_count[mb]
// entries, ascending), with granules (ceil(Sq / 128), granule_cols) uint8,
// the bitmap; all three or none.
// The kernel's body; kModes compiles the three modes in. Without it the
// body is the dense kernel's code alone: each mode test folds away.
#define QA_K1_PARAMS                                                                           \
  const unsigned char *__restrict__ v8, const float *__restrict__ scale_q,                     \
      const float *__restrict__ scale_k, void *__restrict__ out, int Hq, int Hkv, int Sq,       \
      int Skv, int D, int pv_f16, int out_code, int scaling, int causal, float score_scale,     \
      int q_offset, int kv_offset, int left, int right, float *__restrict__ m_out,              \
      float *__restrict__ l_out, int v8_code, const float *__restrict__ scale_v,               \
      const int *__restrict__ q_seg, const int *__restrict__ kv_seg,                           \
      const int *__restrict__ tile_count, const int *__restrict__ tile_list, int list_stride,  \
      const unsigned char *__restrict__ granules, int granule_cols
#define QA_K1_ARGS                                                                             \
  v8, scale_q, scale_k, out, Hq, Hkv, Sq, Skv, D, pv_f16, out_code, scaling, causal,            \
      score_scale, q_offset, kv_offset, left, right, m_out, l_out, v8_code, scale_v, q_seg,     \
      kv_seg, tile_count, tile_list, list_stride, granules, granule_cols

template <int W, int QK, int V, bool kModes>
__device__ __forceinline__ void flash_fwd_body(const CUtensorMap& tm_q, const CUtensorMap& tm_k,
                                               const CUtensorMap& tm_v, QA_K1_PARAMS) {
  using C = Cfg<W, QK, V>;
  constexpr int kBN = C::kBN;
  constexpr int kOD = C::kOD;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (qa::smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* Qs = smem;
  unsigned char* Ks = smem + C::kKOff;
  unsigned char* Vs = smem + C::kVOff;
  float* col_scale = reinterpret_cast<float*>(smem + C::kScaleOff);
  int* seg_s = reinterpret_cast<int*>(smem + C::kSegOff);
  uint64_t* full_q = reinterpret_cast<uint64_t*>(smem + C::kBarOff);
  uint64_t* full_k = full_q + 1;
  uint64_t* full_v = full_k + kStages;
  uint64_t* empty = full_v + kStages;

  const int hq = blockIdx.x / C::kSplits, b = blockIdx.y;
  const int col0 = blockIdx.x % C::kSplits * kOD;  // this CTA's first output column
  // Under the causal mask the last Q blocks see the most KV tiles: run them first.
  const int mb = causal ? gridDim.z - 1 - blockIdx.z : blockIdx.z;
  const int hk = hq / (Hq / Hkv);
  const int q0 = mb * C::kBM;
  const int bh_q = b * Hq + hq, bh_k = b * Hkv + hk;
  // Rows q0 .. q0 + kBM - 1 (positions q_offset + q0 ..) see the K rows
  // [kv_begin, kv_end) at most: from the lowest row's window edge to the
  // highest row's diagonal (causal) or right window edge.
  const int up = causal ? 0 : right;
  const int kv_begin = max(0, q_offset + q0 - left - kv_offset);
  const int kv_end = min(Skv, max(0, q_offset + q0 + C::kBM + up - kv_offset));
  const int tile0 = kv_begin / kBN;
  // Under a block mask the CTA walks its Q block's tile list instead.
  const int* list =
      kModes && tile_list != nullptr ? tile_list + static_cast<size_t>(mb) * list_stride : nullptr;
  const int ntiles = list != nullptr ? tile_count[mb] : max(0, (kv_end + kBN - 1) / kBN - tile0);

  if (threadIdx.x == 0) {
    qa::mbar_init(full_q, 1);
    for (int s = 0; s < kStages; ++s) {
      qa::mbar_init(&full_k[s], 128);
      qa::mbar_init(&full_v[s], 128);
      qa::mbar_init(&empty[s], 128 * C::kConsumers);
    }
    qa::mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  if (wg == 0) {
    // Producer: every producer thread arrives on each full barrier once a
    // tile (after its share of the column scales or of the widened V);
    // thread 0 adds the TMA bytes first.
    if constexpr (C::kRealloc) qa::reg_dealloc<C::kProducerRegs>();
    if (tid == 0) {
      qa::tma_prefetch(&tm_q);
      qa::tma_prefetch(&tm_k);
      if (v8 == nullptr) qa::tma_prefetch(&tm_v);
      qa::mbar_expect_tx(full_q, C::kQBytes);
      for (int w = 0; w < C::kConsumers; ++w) {
        for (int c = 0; c < C::kBlocks; ++c) {
          qa::tma_load_3d(Qs + (w * C::kBlocks + c) * 64 * C::kSpan, &tm_q, full_q,
                          c * C::kSpanElems, q0 + 64 * w, bh_q);
        }
      }
      qa::mbar_arrive(full_q);
    }
    for (int i = 0; i < ntiles; ++i) {
      const int s = i % kStages;
      const int n0 = (list != nullptr ? list[i] : tile0 + i) * kBN;
      qa::mbar_wait(&empty[s], ((i / kStages) & 1) ^ 1);
      if (tid == 0) {
        qa::mbar_expect_tx(&full_k[s], C::kKBytes);
        for (int c = 0; c < C::kBlocks; ++c) {
          qa::tma_load_3d(Ks + s * C::kKBytes + c * kBN * C::kSpan, &tm_k, &full_k[s],
                          c * C::kSpanElems, n0, bh_k);
        }
        if (v8 == nullptr) {
          qa::mbar_expect_tx(&full_v[s], C::kVBytes);
          for (int c = 0; c < kOD / 64; ++c) {
            qa::tma_load_3d(Vs + s * C::kVBytes + c * kBN * 128, &tm_v, &full_v[s],
                            col0 + c * 64, n0, bh_k);
          }
        }
      }
      if (scaling == 2) {
        const float* ks_row = scale_k + static_cast<size_t>(bh_k) * Skv;
#pragma unroll 1
        for (int r = tid; r < kBN; r += 128) {
          col_scale[s * kBN + r] = n0 + r < Skv ? ks_row[n0 + r] : 0.f;
        }
      }
      if (kModes && kv_seg != nullptr) {
        const int* seg_row = kv_seg + static_cast<size_t>(b) * Skv;
#pragma unroll 1
        for (int r = tid; r < kBN; r += 128) {
          seg_s[s * kBN + r] = n0 + r < Skv ? seg_row[n0 + r] : -1;
        }
      }
      qa::mbar_arrive(&full_k[s]);
      if (v8 != nullptr) {
        // e4m3 or int8 V rows to bf16, 8 columns a step, into the swizzled layout
        // a 128-byte-swizzled TMA box would have; rows past Skv and
        // columns past D are zeros.
        const unsigned char* v_head = v8 + static_cast<size_t>(bh_k) * Skv * D;
        unsigned char* vt = Vs + s * C::kVBytes;
        if constexpr (kModes) {
          // Four loads in flight before their conversion: one at a time,
          // the loads' latency bounds the producer (an int8 V took 1.8x as
          // long). The dense kernel keeps its loop: the grouped one, though
          // it never runs there without an e4m3 V, cost dense calls 5%
          // through ptxas's register allocation on the H100.
          constexpr int kChunks = kBN * (kOD / 8), kGroup = 4;
          static_assert(kChunks % (128 * kGroup) == 0, "whole groups of chunks");
#pragma unroll 1
          for (int base = tid; base < kChunks; base += 128 * kGroup) {
            uint2 raw[kGroup];
#pragma unroll
            for (int u = 0; u < kGroup; ++u) {
              const int idx = base + u * 128;
              const int r = idx / (kOD / 8), col = col0 + idx % (kOD / 8) * 8;
              raw[u] = n0 + r < Skv && col < D
                           ? *reinterpret_cast<const uint2*>(v_head + static_cast<size_t>(n0 + r) * D + col)
                           : make_uint2(0u, 0u);
            }
#pragma unroll
            for (int u = 0; u < kGroup; ++u) {
              const int idx = base + u * 128;
              const int r = idx / (kOD / 8), c8 = idx % (kOD / 8);
              *reinterpret_cast<uint4*>(vt + (c8 / 8) * kBN * 128 + r * 128 + ((c8 % 8) ^ (r % 8)) * 16) =
                  widen8_bf16(raw[u], v8_code);
            }
          }
        } else {
#pragma unroll 1
          for (int idx = tid; idx < kBN * (kOD / 8); idx += 128) {
            const int r = idx / (kOD / 8), c8 = idx % (kOD / 8);
            const int col = col0 + c8 * 8;
            uint4 x = make_uint4(0u, 0u, 0u, 0u);
            if (n0 + r < Skv && col < D) {
              x = qa::load8_bf16(v_head, qa::kE4M3, static_cast<size_t>(n0 + r) * D + col);
            }
            *reinterpret_cast<uint4*>(vt + (c8 / 8) * kBN * 128 + r * 128 + ((c8 % 8) ^ (r % 8)) * 16) = x;
          }
        }
        qa::fence_proxy_async();
      }
      qa::mbar_arrive(&full_v[s]);
    }
  } else {
    // Consumer warpgroup cw: Q rows q0 + 64 cw .. + 63; this thread's rows
    // row0 and row1 (the accumulator layout of hopper.cuh).
    if constexpr (C::kRealloc) qa::reg_alloc<C::kConsumerRegs>();
    const int cw = wg - 1;
    const int warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, t = lane % 4;
    const int r_base = q0 + 64 * cw;
    const int row0 = r_base + warp * 16 + g, row1 = row0 + 8;
    float rs0 = score_scale, rs1 = score_scale;
    if (scaling == 1) {
      const float sc = scale_q[bh_q] * scale_k[bh_k];
      rs0 *= sc;
      rs1 *= sc;
    } else if (scaling == 2) {
      const size_t sb = static_cast<size_t>(bh_q) * Sq;
      rs0 *= row0 < Sq ? scale_q[sb + row0] : 0.f;
      rs1 *= row1 < Sq ? scale_q[sb + row1] : 0.f;
    }
    // Warpgroup-uniform tile classes: this warpgroup's rows sit at global
    // positions p_lo .. p_hi, a tile's columns at kv_offset + n0 ...
    const bool active = r_base < Sq;
    // This thread's rows' segment ids, and the granule row of the
    // warpgroup's 64 rows (valid where active).
    int qs0 = 0, qs1 = 0;
    if (kModes && q_seg != nullptr) {
      const int* qs_row = q_seg + static_cast<size_t>(b) * Sq;
      qs0 = row0 < Sq ? qs_row[row0] : -1;
      qs1 = row1 < Sq ? qs_row[row1] : -1;
    }
    const unsigned char* grow = kModes && granules != nullptr
                                    ? granules + static_cast<size_t>(r_base / kGranule) * granule_cols
                                    : nullptr;
    const int p_lo = q_offset + r_base;
    const int p_hi = q_offset + min(r_base + 63, Sq - 1);
    const uint32_t q_addr = qa::smem_addr(Qs + cw * 64 * C::kRowBytes);

    float o[kOD / 2];
#pragma unroll
    for (int i = 0; i < kOD / 2; ++i) o[i] = 0.f;
    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;  // l: this thread's partial sums

    qa::mbar_wait(full_q, 0);
    for (int i = 0; i < ntiles; ++i) {
      const int s = i % kStages;
      const uint32_t ph = (i / kStages) & 1;
      const int n0 = (list != nullptr ? list[i] : tile0 + i) * kBN;
      const int c_lo = kv_offset + n0, c_hi = c_lo + kBN - 1;
      const bool skip = !active || c_lo > p_hi + up || c_hi < p_lo - left ||
                        (grow != nullptr && grow[n0 / kGranule] == 0);
      const bool unmasked = !(kModes && kv_seg != nullptr) && c_hi <= p_lo + up &&
                            c_lo >= p_hi - left && n0 + kBN <= Skv;
      qa::mbar_wait(&full_k[s], ph);
      if (!skip) {
        float sc[kBN / 2];
        if constexpr (QK == qa::kI8) {
          int acc[kBN / 2];
          qk_product<W, QK, V>(acc, q_addr, qa::smem_addr(Ks + s * C::kKBytes));
#pragma unroll
          for (int j = 0; j < kBN / 2; ++j) sc[j] = static_cast<float>(acc[j]);
        } else {
          qk_product<W, QK, V>(sc, q_addr, qa::smem_addr(Ks + s * C::kKBytes));
        }
        const float* cs = scaling == 2 ? col_scale + s * kBN : nullptr;
        float mx0, mx1;
        if (unmasked) {
          fold_scores<kBN, false>(sc, cs, nullptr, 0, 0, rs0, rs1, t, 0, 0, 0, 0, 0, 0, mx0, mx1);
        } else {
          fold_scores<kBN, true>(sc, cs, kModes && kv_seg != nullptr ? seg_s + s * kBN : nullptr,
                                 qs0, qs1, rs0, rs1, t, Skv - n0, c_lo - q_offset, up, left,
                                 row0, row1, mx0, mx1);
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
        for (int j = 0; j < kBN / 8; ++j) {
          sc[4 * j] = exp2f(sc[4 * j] - mn0);
          sc[4 * j + 1] = exp2f(sc[4 * j + 1] - mn0);
          sc[4 * j + 2] = exp2f(sc[4 * j + 2] - mn1);
          sc[4 * j + 3] = exp2f(sc[4 * j + 3] - mn1);
          sum0 += sc[4 * j] + sc[4 * j + 1];
          sum1 += sc[4 * j + 2] + sc[4 * j + 3];
        }
        l0 = a0 * l0 + sum0;
        l1 = a1 * l1 + sum1;
#pragma unroll
        for (int j = 0; j < kOD / 8; ++j) {
          o[4 * j] *= a0;
          o[4 * j + 1] *= a0;
          o[4 * j + 2] *= a1;
          o[4 * j + 3] *= a1;
        }
        // P's A operand: the accumulators of columns 16kk .. 16kk + 15.
        uint32_t pa[kBN / 16][4];
#pragma unroll
        for (int kk = 0; kk < kBN / 16; ++kk) {
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const float x0 = sc[8 * kk + 2 * r], x1 = sc[8 * kk + 2 * r + 1];
            pa[kk][r] = pv_f16 ? qa::pack_f16(x0, x1) : qa::pack_bf16(x0, x1);
          }
        }
        qa::mbar_wait(&full_v[s], ph);
        const uint32_t v_addr = qa::smem_addr(Vs + s * C::kVBytes);
        if (pv_f16) {
          pv_product<kOD, kBN, qa::kF16>(o, pa, v_addr);
        } else {
          pv_product<kOD, kBN, qa::kBF16>(o, pa, v_addr);
        }
      } else {
        qa::mbar_wait(&full_v[s], ph);
      }
      qa::mbar_arrive(&empty[s]);
    }

    // Epilogue: full row sums, normalise (times the column's scale for an
    // int8 V), store; padded Q rows and columns past D are never stored,
    // and the residuals by the first split only.
    // A row that saw no key (no tile ran, or every score it met was
    // masked: its running max is at most half MASK_VALUE) stores zeros.
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, off);
      l1 += __shfl_xor_sync(0xffffffffu, l1, off);
    }
    const float inv0 = l0 == 0.f || m0 <= 0.5f * qa::kMaskValue ? 0.f : 1.f / l0;
    const float inv1 = l1 == 0.f || m1 <= 0.5f * qa::kMaskValue ? 0.f : 1.f / l1;
    const size_t rb = static_cast<size_t>(bh_q) * Sq;
    if (m_out != nullptr && t == 0 && col0 == 0) {  // the four lanes of a row hold equal m, l
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
    for (int j = 0; j < kOD / 8; ++j) {
      const int c = col0 + j * 8 + t * 2;
      if (c >= D) continue;
      float sv0 = 1.f, sv1 = 1.f;
      if (kModes && scale_v != nullptr) {
        sv0 = scale_v[static_cast<size_t>(bh_k) * D + c];
        sv1 = scale_v[static_cast<size_t>(bh_k) * D + c + 1];
      }
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = half ? row1 : row0;
        if (row >= Sq) continue;
        const float inv = half ? inv1 : inv0;
        float x0 = o[4 * j + 2 * half] * inv, x1 = o[4 * j + 2 * half + 1] * inv;
        if constexpr (kModes) {
          x0 *= sv0;
          x1 *= sv1;
        }
        const size_t idx = (rb + row) * D + c;
        if (out_code == qa::kF32) {
          *reinterpret_cast<float2*>(static_cast<float*>(out) + idx) = make_float2(x0, x1);
        } else if (out_code == qa::kF16) {
          *reinterpret_cast<__half2*>(static_cast<__half*>(out) + idx) = __floats2half2_rn(x0, x1);
        } else {
          *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(out) + idx) =
              __floats2bfloat162_rn(x0, x1);
        }
      }
    }
  }
}

// K1 without the modes (their pointers are null).
template <int W, int QK, int V>
__global__ void __launch_bounds__(Cfg<W, QK, V>::kThreads, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                 const __grid_constant__ CUtensorMap tm_v, QA_K1_PARAMS) {
  flash_fwd_body<W, QK, V, false>(tm_q, tm_k, tm_v, QA_K1_ARGS);
}

// K1 with its modes, in tile configuration 0 only (flash_fwd_modes.cu).
template <int W, int QK>
__global__ void __launch_bounds__(Cfg<W, QK, 0>::kThreads, 1)
flash_fwd_modes_kernel(const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v, QA_K1_PARAMS) {
  flash_fwd_body<W, QK, 0, true>(tm_q, tm_k, tm_v, QA_K1_ARGS);
}

#undef QA_K1_PARAMS
#undef QA_K1_ARGS

// The arguments of one launch.
struct Args {
  const void *q, *k, *v;
  const float *sq, *sk;
  void* out;
  int B, Hq, Hkv, Sq, Skv, D, v_code, out_code, scaling, causal;
  float score_scale;
  int q_offset, kv_offset, left, right;
  float *m_out, *l_out;
  const float* scale_v;                 // int8 V's (B, Hkv, D) scales, or null
  const int *q_seg, *kv_seg;            // segment ids, or null
  const int *tile_count, *tile_list;    // the block mask's tile lists, or null
  int list_stride;
  const unsigned char* granules;        // the block mask's bitmap, or null
  int granule_cols;
  cudaStream_t stream;
};

// The kernel a launch takes; only that one is instantiated.
template <int W, int QK, int V, bool kModes>
constexpr auto k1_kernel() {
  if constexpr (kModes) {
    return &flash_fwd_modes_kernel<W, QK>;
  } else {
    return &flash_fwd_kernel<W, QK, V>;
  }
}

template <int W, int QK, int V, bool kModes = false>
int launch(const Args& a) {
  using C = Cfg<W, QK, V>;
  static_assert(!kModes || V == 0, "the modes run in configuration 0");
  CUtensorMap tm_q, tm_k, tm_v = {};
  cudaError_t err =
      qa::encode_tensor_map(&tm_q, a.q, QK, a.D, a.Sq, a.B * a.Hq, C::kSpanElems, 64, C::kSpan);
  if (err == cudaSuccess) {
    err = qa::encode_tensor_map(&tm_k, a.k, QK, a.D, a.Skv, a.B * a.Hkv, C::kSpanElems, C::kBN,
                                C::kSpan);
  }
  const bool v8 = a.v_code == qa::kE4M3 || a.v_code == qa::kI8;  // widened by the producer
  if (err == cudaSuccess && !v8) {
    err = qa::encode_tensor_map(&tm_v, a.v, a.v_code, a.D, a.Skv, a.B * a.Hkv, 64, C::kBN, 128);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto kernel = k1_kernel<W, QK, V, kModes>();
  const int smem = kModes ? C::kSmemModes : C::kSmem;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(a.Hq * C::kSplits, a.B, (a.Sq + C::kBM - 1) / C::kBM);
  kernel<<<grid, C::kThreads, smem, a.stream>>>(
      tm_q, tm_k, tm_v, v8 ? static_cast<const unsigned char*>(a.v) : nullptr, a.sq, a.sk,
      a.out, a.Hq, a.Hkv, a.Sq, a.Skv, a.D, a.v_code == qa::kF16, a.out_code, a.scaling, a.causal,
      a.score_scale, a.q_offset, a.kv_offset, a.left, a.right, a.m_out, a.l_out, a.v_code,
      a.scale_v, a.q_seg, a.kv_seg, a.tile_count, a.tile_list, a.list_stride, a.granules,
      a.granule_cols);
  return static_cast<int>(cudaGetLastError());
}

template <int W, int V, bool kModes = false>
int launch_w(int qk_code, const Args& a) {
  switch (qk_code) {
    case qa::kBF16:
      return launch<W, qa::kBF16, V, kModes>(a);
    case qa::kF16:
      return launch<W, qa::kF16, V, kModes>(a);
    case qa::kE4M3:
      return launch<W, qa::kE4M3, V, kModes>(a);
    default:
      return launch<W, qa::kI8, V, kModes>(a);
  }
}

template <int W, int V>
int smem_w(int qk_code) {
  switch (qk_code) {
    case qa::kBF16:
      return Cfg<W, qa::kBF16, V>::kSmem;
    case qa::kF16:
      return Cfg<W, qa::kF16, V>::kSmem;
    case qa::kE4M3:
      return Cfg<W, qa::kE4M3, V>::kSmem;
    default:
      return Cfg<W, qa::kI8, V>::kSmem;
  }
}

// Tile configuration 1 at W = 64 and 128 (flash_fwd_q2.cu): a launch, and
// its shared-memory bytes (0 where it does not exist).
int launch_q2(int W, int qk_code, const Args& a);
int smem_q2(int W, int qk_code);
// The modes kernel at width W (flash_fwd_modes.cu).
int launch_modes(int W, int qk_code, const Args& a);

}  // namespace k1
}  // namespace qa

