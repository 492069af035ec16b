// K5, K6 and K7 on Hopper, sm_90a: out = x @ W for bf16 activation rows x
// (M, K) and an int8 weight (K, N) with fp32 column scales, or a packed
// int4 weight (K/2, N) with fp32 group scales (K/128, N).
//
// Replaces the Pallas kernels of quantumattention_tpu/ops/qmm.py:
//   K5 _qmm_kernel (qmm.py:49; host quantized_matmul, :191);
//   K6 _qmm_kernel_ms (qmm.py:70): K5's math over disjoint K ranges, summed
//      in a fixed order. On the TPU the split feeds several DMA streams;
//      here it is stream-K's split of each column tile's k-blocks over the
//      CTAs, which a decode product of few column tiles needs to fill the
//      SMs, reduced as K5's and K7's stream-K splits are (below);
//   K7 _qmm4_kernel (qmm.py:118; host quantized_matmul4, :323).
// Every bf16 product of the three runs here; csrc/qmm.cu keeps the float32
// rows.
// Numerics as in JAX: an int8 code becomes bf16 exactly, products sum in
// fp32, the int8 column scale applies once to the sum, which is cast once;
// an int4 nibble times its fp32 group scale is rounded to bf16 before the
// product (dequant4_tile, qmm.py:99-115), with no epilogue scale.
//
// What bounds it on the H100. At decode rows (up to 128): bytes. A product
// does 2*M operations per int8 weight byte, below the card's ~295 a byte,
// so every SM has to stream weights at the memory rate. What held the
// earlier kernels below that rate was converting the codes, not memory:
// four scalar byte loads a fragment and each int4 byte read twice
// (csrc/qmm.cu's qgemm_kernel), or the converted tile's round trip through
// shared memory with its proxy fence and barrier (csrc/tail.cu). At prefill
// rows (more than 128): operations, so the tensor cores have to be kept fed
// with converted weights while each weight byte leaves device memory once.
//
// Design.
//  * Swap A and B: out^T = W^T . x^T. 64 weight columns are wgmma's M and
//    the activation rows its N: 8/16/32/64/128 up to 128 rows (decode rows
//    never pad to 64), 128-row tiles above.
//  * The weights are A, from registers. TMA brings the raw int8 codes (or
//    packed int4 bytes) in 128-byte-swizzled boxes into a ring of stages
//    that one producer warp keeps in flight. A consumer warpgroup owns 128
//    weight columns, two m64 tiles, with A's rows permuted: thread (warp w,
//    lane 4g + t) holds rows 16w + g and 16w + g + 8 of both tiles, which
//    are the weight columns 4(8w + g) .. + 3 (qa::qgemm_column), so one
//    conflict-free 32-bit shared load at a depth feeds four fragments, and
//    one packed int4 byte both of its nibbles' steps. Codes become bf16 by
//    PRMT into a 2^23 magic number, an FADD and cvt.rn.bf16x2.f32 (int4:
//    nibbles masked once a word, times the fp32 group scale before the
//    cvt). The fragments go straight into wgmma: no shared-memory round
//    trip, fence or barrier between conversion and product. Two fragment
//    buffers let one k16 step's conversion overlap the step before's
//    products; a unit's last step waits for its products and frees the
//    stage at once. The epilogue writes each row's four columns in one
//    store, undoing the permutation.
//  * The activations are B: K-major bf16 boxes of 64 depth columns, 128-byte
//    swizzled, rows past M zero-filled, as the tail product loads them;
//    tensor maps are cached on the host (qa::tensor_map_2d). Stream-K's
//    weight boxes use 128-byte L2 promotion: at 256 bytes every 128-byte
//    row fetched the neighbouring tile's row too, which another CTA reads
//    much later, and w_gate_up at M = 4 took 59 us instead of 44 (PERF.md).
//  * A persistent grid. Up to 128 rows, stream-K over (128-column tile,
//    128-row k-block) units: four CTAs an SM at widths up to 32, two above,
//    each an equal share of the units in a fixed order; one fp32 partial a
//    (CTA, tile) segment, added in CTA order by the tail product's
//    reduction (qa::tail_reduce_out): bitwise repeatable, no atomics. (A
//    reduction inside the launch, per-tile arrival counters and each tile's
//    CTAs summing it once all had arrived, was slower at every K6 decode
//    shape measured: PERF.md.) Above
//    128 rows, whole output tiles of 256 columns (two consumer warpgroups)
//    by 128 rows, one CTA an SM, row tiles fastest, so that the CTAs
//    resident at once share each weight tile through L2.
//    ops/qmm.qgemm_schedule is the same schedule in Python.
//  * Programmatic dependent launch: the first stages' weights stream while
//    the kernel before still runs.
#include <algorithm>

#include "common.cuh"
#include "hopper.cuh"

namespace qa {

int qgemm_ctas_per_sm(int width, bool whole) { return whole ? 1 : width <= 32 ? 4 : 2; }

QgemmSched qgemm_schedule(int M, int N, int K, int sms) {
  QgemmSched s{};
  s.whole = M > kQgemmRows;
  s.width = 8;
  while (s.width < M && s.width < kQgemmRows) s.width *= 2;
  s.sk.kblocks = K / kTailKB;
  if (s.whole) {
    s.row_tiles = (M + kQgemmRows - 1) / kQgemmRows;
    s.col_tiles = (N + 2 * kTailBN - 1) / (2 * kTailBN);
    s.sk.tiles = s.col_tiles;
    s.sk.ctas = std::max(1, std::min(sms, s.row_tiles * s.col_tiles));
    return s;
  }
  s.row_tiles = 1;
  s.col_tiles = s.sk.tiles = N / kTailBN;
  const int units = s.sk.tiles * s.sk.kblocks;
  s.sk.ctas = std::max(1, std::min(qgemm_ctas_per_sm(s.width, false) * sms, units));
  s.sk.base = units / s.sk.ctas;
  s.sk.rem = units % s.sk.ctas;
  return s;
}

size_t qgemm_partial_floats(int M, int N, int K) {
  const QgemmSched s = qgemm_schedule(M, N, K, num_sms());
  return s.whole ? 0 : static_cast<size_t>(s.sk.ctas + s.sk.tiles) * M * kTailBN;
}

}  // namespace qa

namespace {

using qa::QgemmSched;

constexpr int kCols = 128;         // weight columns of a consumer warpgroup
constexpr int kKB = qa::kTailKB;   // unpacked weight rows of a unit
constexpr int kSmemSM = 233472;    // shared memory of an SM
constexpr int kSmemMax = 232448;   // of one CTA
constexpr int kMaxDevices = 64;

template <int W, bool INT4, bool WHOLE>
struct Cfg {
  static constexpr int kCons = WHOLE ? 2 : 1;       // consumer warpgroups
  static constexpr int kThreads = kCons * 128 + 32;  // + the producer warp
  static constexpr int kCtasPerSm = WHOLE ? 1 : (W <= 32 ? 4 : 2);
  static constexpr int kWRows = INT4 ? kKB / 2 : kKB;  // weight rows a unit stages
  static constexpr int kWBox = kWRows * kCols;         // one consumer's codes
  static constexpr int kXBox = W * 128;                // 64 bf16 depth columns of W rows
  static constexpr int kStage = kCons * kWBox + 2 * kXBox;
  static constexpr int kPerCta = kSmemSM / kCtasPerSm - 1024;  // each CTA reserves 1 KB
  static constexpr int kRoom = (kPerCta < kSmemMax ? kPerCta : kSmemMax) - 1024 - 128;
  static constexpr int kFit = kRoom / kStage;
  static constexpr int kStages = kFit < 6 ? kFit : 6;
  static constexpr int kBarOff = kStages * kStage;
  static constexpr int kSmem = kBarOff + 2 * kStages * 8 + 1024;  // + alignment slack
  static_assert(kStages >= 2, "two stages at least");
  static_assert(kWBox % 1024 == 0 && kXBox % 1024 == 0, "1024-byte boxes");
};

// What a CTA's i-th unit covers: the weight columns from col0 (a consumer
// takes col0 + 128 wg on), activation rows from row0, k-block kb; seg is
// the output tile (stream-K: the column tile) whose sums it adds to.
struct Unit {
  int col0, row0, kb, seg;
};

__device__ __forceinline__ int sk_start(const QgemmSched& s, int c) {
  return c * s.sk.base + min(c, s.sk.rem);
}

template <bool WHOLE>
__device__ __forceinline__ int cta_units(const QgemmSched& s, int c) {
  if (WHOLE) return ((s.row_tiles * s.col_tiles - 1 - c) / s.sk.ctas + 1) * s.sk.kblocks;
  return sk_start(s, c + 1) - sk_start(s, c);
}

template <bool WHOLE>
__device__ __forceinline__ Unit unit_of(const QgemmSched& s, int c, int i) {
  if (WHOLE) {
    const int tile = c + (i / s.sk.kblocks) * s.sk.ctas;  // row tiles fastest
    return {(tile / s.row_tiles) * 2 * kCols, (tile % s.row_tiles) * qa::kQgemmRows,
            i % s.sk.kblocks, tile};
  }
  const int u = sk_start(s, c) + i, t = u / s.sk.kblocks;
  return {t * kCols, 0, u - t * s.sk.kblocks, t};
}

// The 32-bit word of weight columns 4q .. 4q + 3 at depth row r of a
// consumer's 128-byte-swizzled box. Per load the lanes of a warp read four
// rows 2t (+1, +8, +9) of two 16-byte chunks each, whose swizzled chunks
// differ: no bank conflicts.
__device__ __forceinline__ uint32_t word_at(const unsigned char* box, int r, int q) {
  return *reinterpret_cast<const uint32_t*>(box + r * 128 + (((q >> 2) ^ (r & 7)) << 4) +
                                            4 * (q & 3));
}

// The words at depths r0 + 2t, + 1, + 8, + 9: the four depths of one
// thread's fragments in a k16 step.
__device__ __forceinline__ void load_words(const unsigned char* box, int r0, int q, int tq,
                                           uint32_t (&wd)[4]) {
  wd[0] = word_at(box, r0 + 2 * tq, q);
  wd[1] = word_at(box, r0 + 2 * tq + 1, q);
  wd[2] = word_at(box, r0 + 2 * tq + 8, q);
  wd[3] = word_at(box, r0 + 2 * tq + 9, q);
}

// Byte j of u as the float 2^23 + byte.
__device__ __forceinline__ float magic(uint32_t u, int j) {
  return __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540 + j));
}

// The A fragments of both m64 tiles from f[i][j]: depth i of the four
// (2t, 2t+1, 2t+8, 2t+9), column 4q + j = tile j >> 1, row half j & 1.
__device__ __forceinline__ void pack_frags(const float (&f)[4][4], uint32_t (&a)[2][4]) {
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    a[mt][0] = qa::pack_bf16(f[0][2 * mt], f[1][2 * mt]);
    a[mt][1] = qa::pack_bf16(f[0][2 * mt + 1], f[1][2 * mt + 1]);
    a[mt][2] = qa::pack_bf16(f[2][2 * mt], f[3][2 * mt]);
    a[mt][3] = qa::pack_bf16(f[2][2 * mt + 1], f[3][2 * mt + 1]);
  }
}

// int8 codes -> bf16 fragments, exactly: a byte offset to unsigned in the
// low mantissa byte of 2^23, minus 2^23 + 128.
__device__ __forceinline__ void frags_i8(const uint32_t (&wd)[4], uint32_t (&a)[2][4]) {
  float f[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t u = wd[i] ^ 0x80808080u;
#pragma unroll
    for (int j = 0; j < 4; ++j) f[i][j] = magic(u, j) - 8388736.f;
  }
  pack_frags(f, a);
}

// The low (or high) nibbles of packed int4 words times the group scale of
// their column, each rounded once to bf16: a nibble offset to unsigned in
// the low mantissa byte of 2^23, minus 2^23 + 8, times the fp32 scale.
template <bool HIGH>
__device__ __forceinline__ void frags_i4(const uint32_t (&wd)[4], const float (&sc)[4],
                                         uint32_t (&a)[2][4]) {
  float f[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t u = ((HIGH ? wd[i] >> 4 : wd[i]) & 0x0F0F0F0Fu) ^ 0x08080808u;
#pragma unroll
    for (int j = 0; j < 4; ++j) f[i][j] = (magic(u, j) - 8388616.f) * sc[j];
  }
  pack_frags(f, a);
}

// The producer: lane 0 of the last warp loads unit i's codes and
// activations into stage i % kStages once the consumers have released the
// unit that used it before. The first stages' weights go out before the
// wait for the kernel before this one. A consumer whose columns lie past N
// (the last whole tile of an N % 256 == 128 product) gets no weights: it
// computes on stale codes and stores nothing.
template <int W, bool INT4, bool WHOLE>
__device__ __forceinline__ void produce(const CUtensorMap* tm_w, const CUtensorMap* tm_x,
                                        uint64_t* full, uint64_t* empty, unsigned char* stages,
                                        const QgemmSched& sch, int c, int n_units, int N) {
  using C = Cfg<W, INT4, WHOLE>;
  qa::tma_prefetch(tm_w);
  qa::tma_prefetch(tm_x);
  auto load_w = [&](int i) {
    const Unit u = unit_of<WHOLE>(sch, c, i);
    const int s = i % C::kStages;
    const int cons = min(C::kCons, (N - u.col0) / kCols);
    qa::mbar_expect_tx(&full[s], C::kStage - (C::kCons - cons) * C::kWBox);
    for (int wg = 0; wg < cons; ++wg) {
      qa::tma_load_2d(stages + s * C::kStage + wg * C::kWBox, tm_w, &full[s], u.col0 + wg * kCols,
                      u.kb * C::kWRows);
    }
  };
  const int pre = min(n_units, C::kStages);
  for (int i = 0; i < pre; ++i) load_w(i);  // weights only: no wait needed
  qa::pdl_wait();
  for (int i = 0; i < n_units; ++i) {
    const int s = i % C::kStages;
    if (i >= pre) {
      qa::mbar_wait(&empty[s], ((i / C::kStages) - 1) & 1);
      load_w(i);
    }
    const Unit u = unit_of<WHOLE>(sch, c, i);
    // int8: depths [128 kb, +128); int4: the packing block's rows
    // [256g + 64j, +64) (low nibbles) and [256g + 128 + 64j, +64) (high).
    int k0 = u.kb * kKB, k1 = k0 + 64;
    if (INT4) {
      k0 = (u.kb >> 1) * 256 + (u.kb & 1) * 64;
      k1 = k0 + 128;
    }
    unsigned char* xs = stages + s * C::kStage + C::kCons * C::kWBox;
    qa::tma_load_2d(xs, tm_x, &full[s], k0, u.row0);
    qa::tma_load_2d(xs + C::kXBox, tm_x, &full[s], k1, u.row0);
    qa::mbar_arrive(&full[s]);
  }
}

// One k16 step: both tiles' products over activation depth step kk of the
// stage. Then wait until at most this step's products run, which frees the
// other fragment buffer; at the unit's last step (LAST) wait for all of
// them and free the stage (one arrival a warp).
template <int W, bool LAST>
__device__ __forceinline__ void step(float (&acc)[2][W / 2], uint32_t (&a)[2][4], uint64_t b0,
                                     int kk, int xbox, bool& fresh, uint64_t* empty, int lane) {
  const uint64_t b = b0 + ((kk >> 2) * xbox + (kk & 3) * 32) / 16;
  qa::fence_regs(a);
  qa::wgmma_fence();
  qa::WgmmaRK<W>::run(acc[0], a[0], b, !fresh);
  qa::WgmmaRK<W>::run(acc[1], a[1], b, !fresh);
  fresh = false;
  qa::wgmma_commit();
  if (LAST) {
    qa::wgmma_wait<0>();
    if (lane == 0) qa::mbar_arrive(empty);
  } else {
    qa::wgmma_wait<1>();
  }
}

// The end of a segment (its products are done): store this thread's sums,
// stream-K into partial[slot][m][128] (fp32, the four columns in one
// 16-byte store), whole tiles into out (times the int8 scale, cast once,
// one 8-byte store).
template <int W, bool INT4, bool WHOLE>
__device__ __forceinline__ void finish(float (&acc)[2][W / 2], const Unit& u, int wg, int q, int tq,
                                       const float* __restrict__ scale, float* __restrict__ partial,
                                       int slot, __nv_bfloat16* __restrict__ out, int M, int N) {
  qa::fence_regs(acc[0]);
  qa::fence_regs(acc[1]);
  if (!WHOLE) {
#pragma unroll
    for (int j = 0; j < W / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int m = 8 * j + 2 * tq + e;
        if (m < M) {
          float* p = partial + (static_cast<size_t>(slot) * M + m) * kCols + 4 * q;
          *reinterpret_cast<float4*>(p) = make_float4(acc[0][4 * j + e], acc[0][4 * j + 2 + e],
                                                      acc[1][4 * j + e], acc[1][4 * j + 2 + e]);
        }
      }
    }
    return;
  }
  const int col = u.col0 + wg * kCols + 4 * q;
  if (col >= N) return;
  float4 sc = make_float4(1.f, 1.f, 1.f, 1.f);
  if (!INT4) sc = __ldg(reinterpret_cast<const float4*>(scale + col));
#pragma unroll
  for (int j = 0; j < W / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int m = u.row0 + 8 * j + 2 * tq + e;
      if (m < M) {
        uint2 v;
        v.x = qa::pack_bf16(acc[0][4 * j + e] * sc.x, acc[0][4 * j + 2 + e] * sc.y);
        v.y = qa::pack_bf16(acc[1][4 * j + e] * sc.z, acc[1][4 * j + 2 + e] * sc.w);
        *reinterpret_cast<uint2*>(out + static_cast<size_t>(m) * N + col) = v;
      }
    }
  }
}

// A consumer warpgroup: weight columns [128 wg, +128) of each unit.
template <int W, bool INT4, bool WHOLE>
__device__ __forceinline__ void consume(unsigned char* stages, uint64_t* full, uint64_t* empty,
                                        const float* __restrict__ scale, float* __restrict__ partial,
                                        __nv_bfloat16* __restrict__ out, const QgemmSched& sch,
                                        int c, int n_units, int M, int N, int wg, int lt) {
  using C = Cfg<W, INT4, WHOLE>;
  const int warp = lt >> 5, lane = lt & 31, tq = lane & 3;
  const int q = 8 * warp + (lane >> 2);  // this thread's columns: 4q .. 4q + 3
  float acc[2][W / 2];
  uint32_t a[2][2][4];  // two fragment buffers of both tiles
  bool fresh = true;
  Unit cur{-1, 0, 0, -1};
  for (int i = 0; i < n_units; ++i) {
    const Unit u = unit_of<WHOLE>(sch, c, i);
    const int s = i % C::kStages;
    if (u.seg != cur.seg) {
      if (cur.seg >= 0) {
        finish<W, INT4, WHOLE>(acc, cur, wg, q, tq, scale, partial, c + cur.seg, out, M, N);
      }
      cur = u;
      fresh = true;  // the segment's first products overwrite the sums
    }
    float s_lo[4] = {0.f, 0.f, 0.f, 0.f}, s_hi[4] = {0.f, 0.f, 0.f, 0.f};
    const int col = u.col0 + wg * kCols + 4 * q;
    if (INT4 && col < N) {
      const size_t g2 = static_cast<size_t>(u.kb >> 1) * 2;
      const float4 lo = __ldg(reinterpret_cast<const float4*>(scale + g2 * N + col));
      const float4 hi = __ldg(reinterpret_cast<const float4*>(scale + (g2 + 1) * N + col));
      s_lo[0] = lo.x; s_lo[1] = lo.y; s_lo[2] = lo.z; s_lo[3] = lo.w;
      s_hi[0] = hi.x; s_hi[1] = hi.y; s_hi[2] = hi.z; s_hi[3] = hi.w;
    }
    qa::mbar_wait(&full[s], (i / C::kStages) & 1);
    const unsigned char* box = stages + s * C::kStage + wg * C::kWBox;
    const uint64_t b0 = qa::wgmma_desc(qa::smem_addr(stages + s * C::kStage + C::kCons * C::kWBox),
                                       16, 1024, qa::kSwizzle128);
    uint32_t wd[4];
    if (INT4) {
      // A packed row holds depth r (low nibble, step p) and r + 128 (high,
      // step p + 4): one load a word for both.
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        load_words(box, 16 * p, q, tq, wd);
        frags_i4<false>(wd, s_lo, a[0]);
        step<W, false>(acc, a[0], b0, p, C::kXBox, fresh, &empty[s], lane);
        frags_i4<true>(wd, s_hi, a[1]);
        if (p < 3) {
          step<W, false>(acc, a[1], b0, p + 4, C::kXBox, fresh, &empty[s], lane);
        } else {
          step<W, true>(acc, a[1], b0, p + 4, C::kXBox, fresh, &empty[s], lane);
        }
      }
    } else {
#pragma unroll
      for (int kk = 0; kk < kKB / 16; ++kk) {
        load_words(box, 16 * kk, q, tq, wd);
        frags_i8(wd, a[kk & 1]);
        if (kk < kKB / 16 - 1) {
          step<W, false>(acc, a[kk & 1], b0, kk, C::kXBox, fresh, &empty[s], lane);
        } else {
          step<W, true>(acc, a[kk & 1], b0, kk, C::kXBox, fresh, &empty[s], lane);
        }
      }
    }
  }
  if (cur.seg >= 0) {
    finish<W, INT4, WHOLE>(acc, cur, wg, q, tq, scale, partial, c + cur.seg, out, M, N);
  }
}

// The persistent product (see the file comment). tm_w: the codes (rows,
// N), 128-B-swizzled boxes of 128 columns x kWRows rows; tm_x: the (M, K)
// bf16 activations, boxes of 64 columns x W rows, 128-B swizzled. scale:
// the int8 column scales or the int4 group scales.
template <int W, bool INT4, bool WHOLE>
__global__ void __launch_bounds__(Cfg<W, INT4, WHOLE>::kThreads, Cfg<W, INT4, WHOLE>::kCtasPerSm)
qgemm_wgmma_kernel(const __grid_constant__ CUtensorMap tm_w, const __grid_constant__ CUtensorMap tm_x,
                   const float* __restrict__ scale, float* __restrict__ partial,
                   __nv_bfloat16* __restrict__ out, QgemmSched sch, int M, int N) {
  using C = Cfg<W, INT4, WHOLE>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (qa::smem_addr(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + C::kBarOff);
  uint64_t* empty = full + C::kStages;
  const int tid = threadIdx.x, c = blockIdx.x;
  const int n_units = cta_units<WHOLE>(sch, c);
  if (tid == 0) {
    for (int s = 0; s < C::kStages; ++s) {
      qa::mbar_init(&full[s], 1);
      qa::mbar_init(&empty[s], 4 * C::kCons);  // one arrival a consumer warp
    }
    qa::mbar_init_fence();
  }
  __syncthreads();
  qa::pdl_launch_dependents();
  // Warp-uniform roles: the warp index through a shuffle, so that ptxas
  // sees the consumers' wgmma region entered by whole warpgroups.
  const int warp_idx = __shfl_sync(0xffffffffu, tid >> 5, 0);
  if (warp_idx == C::kCons * 4) {
    if (tid == C::kCons * 128) produce<W, INT4, WHOLE>(&tm_w, &tm_x, full, empty, smem, sch, c, n_units, N);
  } else {
    qa::pdl_wait();  // before the outputs are written over
    consume<W, INT4, WHOLE>(smem, full, empty, scale, partial, out, sch, c, n_units, M, N,
                            warp_idx / 4, tid & 127);
  }
}

template <int W, bool INT4, bool WHOLE>
cudaError_t launch(const CUtensorMap& tm_w, const CUtensorMap& tm_x, const float* scale,
                   float* partial, __nv_bfloat16* out, const QgemmSched& sch, int M, int N,
                   cudaStream_t stream) {
  using C = Cfg<W, INT4, WHOLE>;
  // Raise the dynamic shared-memory limit once per device (a launch may be
  // captured into a CUDA graph).
  static bool configured[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!configured[dev]) {
    err = cudaFuncSetAttribute(qgemm_wgmma_kernel<W, INT4, WHOLE>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
    if (err != cudaSuccess) return err;
    configured[dev] = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(sch.sk.ctas);
  cfg.blockDim = dim3(C::kThreads);
  cfg.dynamicSmemBytes = C::kSmem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, qgemm_wgmma_kernel<W, INT4, WHOLE>, tm_w, tm_x, scale, partial, out,
                           sch, M, N);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <bool INT4>
cudaError_t launch_width(const QgemmSched& sch, const CUtensorMap& tm_w, const CUtensorMap& tm_x,
                         const float* scale, float* partial, __nv_bfloat16* out, int M, int N,
                         cudaStream_t stream) {
  if (sch.whole) return launch<128, INT4, true>(tm_w, tm_x, scale, partial, out, sch, M, N, stream);
  switch (sch.width) {
    case 8: return launch<8, INT4, false>(tm_w, tm_x, scale, partial, out, sch, M, N, stream);
    case 16: return launch<16, INT4, false>(tm_w, tm_x, scale, partial, out, sch, M, N, stream);
    case 32: return launch<32, INT4, false>(tm_w, tm_x, scale, partial, out, sch, M, N, stream);
    case 64: return launch<64, INT4, false>(tm_w, tm_x, scale, partial, out, sch, M, N, stream);
    case 128: return launch<128, INT4, false>(tm_w, tm_x, scale, partial, out, sch, M, N, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

namespace qa {

cudaError_t qgemm(const __nv_bfloat16* x, QMat w, int M, int N, int K, float* partial,
                  __nv_bfloat16* out, cudaStream_t stream) {
  if (M == 0) return cudaSuccess;
  if (K <= 0 || N % kTailBN != 0 || K % (w.int4 ? 256 : kTailKB) != 0) return cudaErrorInvalidValue;
  const QgemmSched sch = qgemm_schedule(M, N, K, num_sms());
  if (!sch.whole && partial == nullptr) return cudaErrorInvalidValue;
  CUtensorMap tm_w, tm_x;
  // Stream-K: a box's 128-byte rows at 128-byte promotion (the neighbouring
  // tile's rows are another CTA's, read much later); whole tiles load both
  // halves of 256 columns together.
  cudaError_t err = tensor_map_2d(&tm_w, w.q, kI8, N, w.int4 ? K / 2 : K, static_cast<size_t>(N),
                                  kCols, w.int4 ? kKB / 2 : kKB, true, sch.whole ? 256 : 128);
  if (err == cudaSuccess)
    err = tensor_map_2d(&tm_x, x, kBF16, K, M, static_cast<size_t>(K) * 2, 64,
                        sch.whole ? kQgemmRows : sch.width, true);
  if (err != cudaSuccess) return err;
  err = w.int4 ? launch_width<true>(sch, tm_w, tm_x, w.s, partial, out, M, N, stream)
               : launch_width<false>(sch, tm_w, tm_x, w.s, partial, out, M, N, stream);
  if (err != cudaSuccess || sch.whole) return err;
  return tail_reduce_out(partial, sch.sk, w.int4 ? nullptr : w.s, out, M, N, stream);
}

}  // namespace qa

// The schedule of an (M rows, N columns, K deep) K5/K6/K7 product on this
// card, for the tests: out[0..6] = whole, row tiles, column tiles,
// k-blocks, CTAs, base, rem; returns the activation width.
extern "C" int qa_qgemm_schedule(int M, int N, int K, int* out) {
  const qa::QgemmSched s = qa::qgemm_schedule(M, N, K, qa::num_sms());
  out[0] = s.whole;
  out[1] = s.row_tiles;
  out[2] = s.col_tiles;
  out[3] = s.sk.kblocks;
  out[4] = s.sk.ctas;
  out[5] = s.sk.base;
  out[6] = s.sk.rem;
  return s.width;
}

// The column permutation: out[64 mt + r] = the weight column (of a
// consumer's 128) that row r of m64 tile mt holds.
extern "C" void qa_qgemm_columns(int* out) {
  for (int mt = 0; mt < 2; ++mt)
    for (int r = 0; r < 64; ++r) out[64 * mt + r] = qa::qgemm_column(mt, r);
}

extern "C" int qa_qgemm_workspace(int M, int N, int K) {
  return static_cast<int>(qa::qgemm_partial_floats(M, N, K));
}

// x (M, K) bf16; w int8 (K, N) with scale (N,), or packed int4 (K/2, N)
// with scale (K/128, N); out (M, N) bf16; partial qa_qgemm_workspace fp32
// entries (null when that is 0).
extern "C" int qa_qgemm(const void* x, const void* w, const void* scale, void* out, void* partial,
                        int M, int N, int K, int int4, void* stream) {
  const qa::QMat mat{w, static_cast<const float*>(scale), int4};
  return static_cast<int>(qa::qgemm(static_cast<const __nv_bfloat16*>(x), mat, M, N, K,
                                    static_cast<float*>(partial), static_cast<__nv_bfloat16*>(out),
                                    static_cast<cudaStream_t>(stream)));
}
