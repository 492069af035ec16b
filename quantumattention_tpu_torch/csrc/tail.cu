// The tail product of K8 and K9, sm_90a: out = x @ W for a quantized weight
// W (int8 codes with fp32 column scales, or packed int4 with group scales)
// and a few bf16 activation rows, and the kernels that reduce its fp32
// partial sums into K8's stages (csrc/qmlp.cu, csrc/megastep.cu).
//
// Replaces, on K8's and K9's paths, the products of the Pallas kernels
// quantumattention_tpu/ops/qmlp.py::_tail_kernel (qmlp.py:93) and
// ops/megastep.py::_mega_kernel (megastep.py:72), with their rounding
// points (qmlp.py:123-153, megastep.py:215-262): an int8 code becomes bf16
// exactly, an int4 nibble times its fp32 group scale is rounded to bf16
// (qmm.py:99), products sum in fp32, the int8 column scale is applied once
// to the sum.
//
// What bounds it on the H100: bytes. At decode rows a product does 2*M
// flops per int8 weight byte, far below the card's ~295 flops per byte, so
// the kernel has to keep the weight stream at the memory rate on every SM.
//
// Design.
//  * Swap A and B: the product runs as out^T = W^T . x^T, so that 64 weight
//    columns are wgmma's M and the activation rows, rounded up to a width of
//    8/16/32/64/128/256, its N: the tensor cores do 2 * width operations per
//    weight, not 2 * 64, and the activation rows never pad to 64.
//  * A persistent grid: two CTAs an SM at widths up to 64, one above. The
//    work is (128-column tile, 128-row k-block) units, tile-major; CTA c
//    takes the units [c * U / P, ...), the shares differing by at most one
//    (stream-K). A CTA sums each tile it touches over its k-range in
//    registers and writes one fp32 partial per (CTA, tile) into slot c + t
//    (unique along the CTAs' monotone path), and the reduction kernels below
//    add a tile's slots in CTA order: the result is bitwise repeatable.
//    ops/qmlp.tail_schedule is the same schedule in Python, for the CPU
//    tests.
//  * Weights by TMA: one producer warp keeps a ring of stages in flight, each
//    stage one 128-B-swizzled box of the unit's 128 int8 rows (or 64 packed
//    int4 rows) by 128 columns, plus the activation tile (two 64-column
//    boxes of width rows, 128-B swizzled, rows past M zero-filled),
//    completing on one mbarrier. Its first weight loads are issued before it
//    waits for the kernel before it (programmatic dependent launch), so they
//    stream while the previous reduction runs.
//  * Two consumer warpgroups, one per 64-column half: each converts its half
//    of the staged codes with 16-byte shared loads into a 128-B-swizzled
//    MN-major bf16 tile, which wgmma reads through the transpose bit, as K1
//    reads V. int4 packing blocks of 256 rows never straddle a unit: a unit
//    is 64 packed rows, whose low nibbles are rows [256g + 64j, +64) and
//    high nibbles [256g + 128 + 64j, +64).
// What bounds it in practice: the conversion's instructions and latencies
// (the converted tile, its proxy fence and barrier, the products' wait) per
// unit, not the memory: at one CTA an SM (8 consumer warps) a unit took
// about 1 us, whether its weights came from memory or from L2; two CTAs an
// SM hide half of that (PERF.md). Repacking the weights into a
// fragment-ready layout would skip the conversion's round trip through
// shared memory; it changes the tree layout K5-K7 and the plain versions
// read (PERF.md, section 7).
#include <algorithm>
#include <cstring>
#include <mutex>
#include <unordered_map>

#include <cooperative_groups.h>

#include "common.cuh"
#include "hopper.cuh"

namespace qa {

namespace {

struct MapKey {
  const void* ptr;
  size_t pitch;
  int code, cols, rows, box_cols, box_rows, swizzle, promotion;
  bool operator==(const MapKey& o) const { return std::memcmp(this, &o, sizeof(MapKey)) == 0; }
};

struct MapKeyHash {
  size_t operator()(const MapKey& k) const {
    size_t h = reinterpret_cast<size_t>(k.ptr) ^ (k.pitch * 0x9E3779B97F4A7C15ull);
    for (int v : {k.code, k.cols, k.rows, k.box_cols, k.box_rows, k.swizzle, k.promotion})
      h = (h ^ static_cast<size_t>(v)) * 0x100000001B3ull;
    return h;
  }
};

constexpr size_t kMaxCachedMaps = 4096;

}  // namespace

cudaError_t tensor_map_2d(CUtensorMap* map, const void* ptr, int code, int cols, int rows,
                          size_t pitch, int box_cols, int box_rows, bool swizzle,
                          int l2_promotion) {
  static std::mutex mu;
  static std::unordered_map<MapKey, CUtensorMap, MapKeyHash> cache;
  MapKey key;
  std::memset(&key, 0, sizeof(key));  // the padding takes part in ==
  key.ptr = ptr;
  key.pitch = pitch;
  key.code = code;
  key.cols = cols;
  key.rows = rows;
  key.box_cols = box_cols;
  key.box_rows = box_rows;
  key.swizzle = swizzle;
  key.promotion = l2_promotion;
  std::lock_guard<std::mutex> lock(mu);
  const auto it = cache.find(key);
  if (it != cache.end()) {
    *map = it->second;
    return cudaSuccess;
  }
  const EncodeTiled fn = tensor_map_encoder();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(pitch)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols), static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t step[2] = {1, 1};
  const CUresult r = fn(map, code == kBF16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_UINT8,
                        2, const_cast<void*>(ptr), dims, strides, box, step,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        swizzle ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE,
                        l2_promotion == 128 ? CU_TENSOR_MAP_L2_PROMOTION_L2_128B
                                            : CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return cudaErrorInvalidValue;
  if (cache.size() >= kMaxCachedMaps) cache.clear();
  cache.emplace(key, *map);
  return cudaSuccess;
}

int num_sms() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms <= 0) sms = 132;
  }
  return sms;
}

int tail_width(int M) {
  int w = 8;
  while (w < M && w < kTailMaxRows) w *= 2;
  return M <= kTailMaxRows ? w : 0;
}

int tail_ctas_per_sm(int width) { return width <= 64 ? 2 : 1; }

TailSched tail_schedule(int M, int N, int K, int sms) {
  TailSched s;
  s.tiles = N / kTailBN;
  s.kblocks = K / kTailKB;
  const int units = s.tiles * s.kblocks;
  s.ctas = std::max(1, std::min(tail_ctas_per_sm(tail_width(M)) * sms, units));
  s.base = units / s.ctas;
  s.rem = units % s.ctas;
  return s;
}

size_t tail_partial_floats(int M, int N, int K) {
  const TailSched s = tail_schedule(M, N, K, num_sms());
  return static_cast<size_t>(s.ctas + s.tiles) * M * kTailBN;
}

}  // namespace qa

namespace {

using qa::TailSched;

constexpr int kBN = qa::kTailBN;  // columns per unit: two 64-column halves
constexpr int kKB = qa::kTailKB;  // unpacked weight rows per unit
constexpr int kConsumers = 2;
constexpr int kThreads = kConsumers * 128 + 32;  // + the producer warp
constexpr int kATile = kKB * 128;                // a converted (128 x 64) bf16 tile
constexpr int kSmemMax = 232448;
constexpr int kRowThreads = 1024;
constexpr int kMaxDevices = 64;

template <int N, bool INT4>
struct TailCfg {
  static constexpr int kWRows = INT4 ? kKB / 2 : kKB;  // weight rows a unit stages
  static constexpr int kWBytes = kWRows * kBN;         // one box, 128-B swizzled
  static constexpr int kXBox = N * 128;                // 64 bf16 columns of N rows
  static constexpr int kStage = kWBytes + 2 * kXBox;
  // Two CTAs an SM at widths up to 64 (16 consumer warps to hide the
  // conversion's latencies), each with one converted tile a consumer;
  // one CTA with two tiles a consumer (the next unit's conversion overlaps
  // this unit's products) at wider widths.
  static constexpr int kCtasPerSm = N <= 64 ? 2 : 1;
  static constexpr int kABufs = 3 - kCtasPerSm;
  static constexpr int kFixed = kConsumers * kABufs * kATile;
  static constexpr int kFit = (kSmemMax / kCtasPerSm - 1024 - kFixed - 1024 - 128) / kStage;
  static constexpr int kStages = kFit < 8 ? kFit : 8;
  static constexpr int kBarOff = kFixed + kStages * kStage;
  static constexpr int kSmem = kBarOff + 2 * kStages * 8 + 1024;  // + alignment slack
  static_assert(kStages >= 2, "two stages at least");
  static_assert(kWBytes % 1024 == 0 && kXBox % 1024 == 0, "1024-byte boxes");
};

__device__ __forceinline__ int cta_of(const TailSched& s, int u) {
  const int big = s.base + 1;
  return u < s.rem * big ? u / big : s.rem + (u - s.rem * big) / s.base;
}

__device__ __forceinline__ int cta_start(const TailSched& s, int c) {
  return c * s.base + min(c, s.rem);
}

// The CTAs whose slots hold tile t's partial sums: [*c0, *c1].
__device__ __forceinline__ void tile_ctas(const TailSched& s, int t, int* c0, int* c1) {
  *c0 = cta_of(s, t * s.kblocks);
  *c1 = cta_of(s, (t + 1) * s.kblocks - 1);
}

// Sum of row m, column `col` of tile t over its slots, in CTA (= k) order.
// The loads go out eight at a time, the adds follow in order (a slot past
// c1 adds an exact zero).
__device__ __forceinline__ float seg_sum(const float* __restrict__ partial, int c0, int c1, int t,
                                         int M, int m, int col) {
  float acc = 0.f;
  for (int c = c0; c <= c1; c += 8) {
    float v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j)
      v[j] = c + j <= c1 ? partial[(static_cast<size_t>(c + j + t) * M + m) * kBN + col] : 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) acc += v[j];
  }
  return acc;
}

// seg_sum of four neighbouring columns (col % 4 == 0) with 16-byte loads.
__device__ __forceinline__ float4 seg_sum4(const float* __restrict__ partial, int c0, int c1, int t,
                                           int M, int m, int col) {
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int c = c0; c <= c1; c += 8) {
    float4 v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      v[j] = c + j <= c1
                 ? *reinterpret_cast<const float4*>(partial + (static_cast<size_t>(c + j + t) * M + m) * kBN + col)
                 : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      acc.x += v[j].x;
      acc.y += v[j].y;
      acc.z += v[j].z;
      acc.w += v[j].w;
    }
  }
  return acc;
}

// 16 int8 codes -> 16 bf16 (two uint4), exactly: byte i of each word,
// offset to unsigned, becomes the low mantissa byte of 2^23; minus 2^23 +
// 128 gives the integer, whose float holds its bf16 in the upper half.
__device__ __forceinline__ void i8x16_to_bf16(uint4 v, uint4& lo, uint4& hi) {
  uint32_t w[4] = {v.x, v.y, v.z, v.w};
  uint32_t o[8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t u = w[i] ^ 0x80808080u;
    const float f0 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540)) - 8388736.f;
    const float f1 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7541)) - 8388736.f;
    const float f2 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7542)) - 8388736.f;
    const float f3 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7543)) - 8388736.f;
    o[2 * i] = __byte_perm(__float_as_uint(f0), __float_as_uint(f1), 0x7632);
    o[2 * i + 1] = __byte_perm(__float_as_uint(f2), __float_as_uint(f3), 0x7632);
  }
  lo = make_uint4(o[0], o[1], o[2], o[3]);
  hi = make_uint4(o[4], o[5], o[6], o[7]);
}

// 16 packed bytes -> their low (or high) nibbles times the 16 columns'
// group scales, each rounded to bf16.
template <bool HIGH>
__device__ __forceinline__ void i4x16_to_bf16(uint4 v, const float (&sc)[16], uint4& lo, uint4& hi) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
  uint32_t o[8];
#pragma unroll
  for (int e = 0; e < 16; e += 2) {
    // Byte e's nibble, sign-extended by an arithmetic shift of the word.
    const int sh0 = (HIGH ? 24 : 28) - 8 * (e & 3), sh1 = sh0 - 8;
    const float a = static_cast<float>(static_cast<int>(w[e >> 2] << sh0) >> 28);
    const float c = static_cast<float>(static_cast<int>(w[e >> 2] << sh1) >> 28);
    o[e / 2] = qa::pack_bf16(a * sc[e], c * sc[e + 1]);
  }
  lo = make_uint4(o[0], o[1], o[2], o[3]);
  hi = make_uint4(o[4], o[5], o[6], o[7]);
}

// Row `r` of a converted tile (128 bytes: 64 bf16 weight columns), 16-byte
// chunks `c` and c + 1 under the 128-byte swizzle.
__device__ __forceinline__ void store_row_pair(unsigned char* tile, int r, int c, uint4 lo, uint4 hi) {
  unsigned char* row = tile + r * 128;
  *reinterpret_cast<uint4*>(row + ((c ^ (r & 7)) << 4)) = lo;
  *reinterpret_cast<uint4*>(row + (((c + 1) ^ (r & 7)) << 4)) = hi;
}

// The end of a (CTA, tile) segment: wait for the last products, free
// their stage, and write the sums of rows m < M into partial[slot].
template <int N>
__device__ __forceinline__ void release_and_store(float (&acc)[N / 2], uint64_t* empty, int pending,
                                                  int lt, float* __restrict__ partial, int slot,
                                                  int M, int wg, int warp, int lane) {
  qa::wgmma_wait<0>();  // the stores below are memory operations: they stay after it
  if (pending >= 0 && lt == 0) qa::mbar_arrive(&empty[pending]);
  const int n_loc = 64 * wg + 16 * warp + (lane >> 2);
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int m = 8 * j + 2 * (lane & 3) + e;
      if (m < M) {
        float* p = partial + (static_cast<size_t>(slot) * M + m) * kBN + n_loc;
        p[0] = acc[4 * j + e];
        p[8] = acc[4 * j + 2 + e];
      }
    }
  }
}

// The producer: lane 0 of the last warp loads unit i's weights and
// activations into stage i % kStages once the consumers have released the
// unit that used it before. The first stages' weights go out before the
// wait for the kernel before this one (programmatic dependent launch).
template <int N, bool INT4>
__device__ __forceinline__ void produce(const CUtensorMap* tm_w, const CUtensorMap* tm_x,
                                        uint64_t* full, uint64_t* empty, unsigned char* stages,
                                        const TailSched& sch, int u0, int n_units) {
  using C = TailCfg<N, INT4>;
  qa::tma_prefetch(tm_w);
  qa::tma_prefetch(tm_x);
  auto load_w = [&](int i) {
    const int u = u0 + i, t = u / sch.kblocks, kb = u % sch.kblocks, s = i % C::kStages;
    qa::mbar_expect_tx(&full[s], C::kStage);
    qa::tma_load_2d(stages + s * C::kStage, tm_w, &full[s], t * kBN, kb * C::kWRows);
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
    const int kb = (u0 + i) % sch.kblocks;
    int k0 = kb * kKB, k1 = k0 + 64;
    if (INT4) {  // unit kb: rows [256g + 64j, +64) and [256g + 128 + 64j, +64)
      k0 = (kb >> 1) * 256 + (kb & 1) * 64;
      k1 = k0 + 128;
    }
    unsigned char* xs = stages + s * C::kStage + C::kWBytes;
    qa::tma_load_2d(xs, tm_x, &full[s], k0, 0);
    qa::tma_load_2d(xs + C::kXBox, tm_x, &full[s], k1, 0);
    qa::mbar_arrive(&full[s]);
  }
}

// A consumer warpgroup: weight columns [64 wg, 64 wg + 64) of each unit.
template <int N, bool INT4>
__device__ __forceinline__ void consume(unsigned char* smem, uint64_t* full, uint64_t* empty,
                                        const float* __restrict__ s4, float* __restrict__ partial,
                                        const TailSched& sch, int u0, int n_units, int M,
                                        int Ncols, int c, int wg, int lt) {
  using C = TailCfg<N, INT4>;
  // Conversion: lane l of warp w reads 16-byte chunk 4 wg + l / 8 (columns
  // 16 (l / 8) .. + 16 of this half) of rows 8 (w + 4 it) + l % 8: the eight
  // lanes of a shared-memory phase hit eight rows, whose swizzled chunks
  // differ, and write eight rows of the converted tile, likewise.
  const int warp = lt >> 5, lane = lt & 31, c16 = lane >> 3;
  unsigned char* a_tiles = smem + wg * C::kABufs * kATile;
  unsigned char* stages = smem + C::kFixed;
  float acc[N / 2];
  int cur_t = -1, pending = -1, fresh = 1;
  for (int i = 0; i < n_units; ++i) {
    const int u = u0 + i, t = u / sch.kblocks, kb = u % sch.kblocks, s = i % C::kStages;
    if (t != cur_t) {
      if (cur_t >= 0) {
        release_and_store<N>(acc, empty, pending, lt, partial, c + cur_t, M, wg, warp, lane);
        pending = -1;
      }
      cur_t = t;
      fresh = 1;  // the segment's first product overwrites the sums
    }
    float s_lo[16], s_hi[16];
    if (INT4) {
      const int col = t * kBN + 64 * wg + 16 * c16;
      const size_t g2 = static_cast<size_t>(kb >> 1) * 2;
      const float4* p_lo = reinterpret_cast<const float4*>(s4 + g2 * Ncols + col);
      const float4* p_hi = reinterpret_cast<const float4*>(s4 + (g2 + 1) * Ncols + col);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float4 a = __ldg(p_lo + q), b = __ldg(p_hi + q);
        s_lo[4 * q] = a.x; s_lo[4 * q + 1] = a.y; s_lo[4 * q + 2] = a.z; s_lo[4 * q + 3] = a.w;
        s_hi[4 * q] = b.x; s_hi[4 * q + 1] = b.y; s_hi[4 * q + 2] = b.z; s_hi[4 * q + 3] = b.w;
      }
    }
    qa::mbar_wait(&full[s], (i / C::kStages) & 1);

    // Convert this half's codes into the bf16 tile (rows = depth).
    unsigned char* a_tile = a_tiles + (C::kABufs == 2 ? (i & 1) * kATile : 0);
    const unsigned char* w = stages + s * C::kStage;
#pragma unroll
    for (int it = 0; it < C::kWRows / 32; ++it) {
      const int r = 8 * (warp + 4 * it) + (lane & 7);
      const uint4 v = *reinterpret_cast<const uint4*>(w + r * 128 + (((4 * wg + c16) ^ (r & 7)) << 4));
      uint4 lo, hi;
      if (INT4) {
        i4x16_to_bf16<false>(v, s_lo, lo, hi);
        store_row_pair(a_tile, r, 2 * c16, lo, hi);
        i4x16_to_bf16<true>(v, s_hi, lo, hi);
        store_row_pair(a_tile, 64 + r, 2 * c16, lo, hi);
      } else {
        i8x16_to_bf16(v, lo, hi);
        store_row_pair(a_tile, r, 2 * c16, lo, hi);
      }
    }
    qa::fence_proxy_async();
    qa::named_barrier(1 + wg, 128);

    // Descriptors step by adding to their address field (16-byte units;
    // shared addresses stay below 2^18, so the field never carries).
    const uint64_t a0 = qa::wgmma_desc(qa::smem_addr(a_tile), kATile, 1024, qa::kSwizzle128);
    const uint64_t b0 = qa::wgmma_desc(qa::smem_addr(stages + s * C::kStage + C::kWBytes), 16, 1024,
                                       qa::kSwizzle128);
    qa::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kKB / 16; ++kk) {
      qa::WgmmaTA<N>::run(acc, a0 + kk * (16 * 128 / 16),
                          b0 + ((kk >> 2) * C::kXBox + (kk & 3) * 32) / 16, kk > 0 || !fresh);
    }
    fresh = 0;
    qa::wgmma_commit();
    // With two tiles, the previous unit's products are done; with one, this
    // unit's (the tile is converted into next).
    if (C::kABufs == 2) {
      qa::wgmma_wait<1>();
      if (pending >= 0 && lt == 0) qa::mbar_arrive(&empty[pending]);
      pending = s;
    } else {
      qa::wgmma_wait<0>();
      if (lt == 0) qa::mbar_arrive(&empty[s]);
    }
  }
  if (cur_t >= 0) release_and_store<N>(acc, empty, pending, lt, partial, c + cur_t, M, wg, warp, lane);
}

// The persistent product (see the file comment). tm_w: the (rows, N) codes,
// 128-B-swizzled boxes of 128 columns x kWRows rows; tm_x: the (M, K) bf16 activations,
// boxes of 64 columns x N rows, 128-B swizzled. s4: int4 group scales
// (K / 128, Ncols) or null. Writes partial[slot][m][128] for m < M.
template <int N, bool INT4>
__global__ void __launch_bounds__(kThreads, TailCfg<N, INT4>::kCtasPerSm)
tail_gemm_kernel(const __grid_constant__ CUtensorMap tm_w, const __grid_constant__ CUtensorMap tm_x,
                 const float* __restrict__ s4, float* __restrict__ partial, TailSched sch, int M,
                 int Ncols) {
  using C = TailCfg<N, INT4>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (qa::smem_addr(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + C::kBarOff);
  uint64_t* empty = full + C::kStages;
  const int tid = threadIdx.x, c = blockIdx.x;
  const int u0 = cta_start(sch, c), n_units = cta_start(sch, c + 1) - u0;
  if (tid == 0) {
    for (int s = 0; s < C::kStages; ++s) {
      qa::mbar_init(&full[s], 1);
      qa::mbar_init(&empty[s], kConsumers);
    }
    qa::mbar_init_fence();
  }
  __syncthreads();
  qa::pdl_launch_dependents();
  // Warp-uniform roles: the warp index through a shuffle, so that ptxas
  // sees the consumers' wgmma region entered by whole warpgroups.
  const int warp_idx = __shfl_sync(0xffffffffu, tid >> 5, 0);
  if (warp_idx == kConsumers * 4) {
    if (tid == kConsumers * 128)
      produce<N, INT4>(&tm_w, &tm_x, full, empty, smem + C::kFixed, sch, u0, n_units);
  } else {
    qa::pdl_wait();  // before the partial sums are written over
    consume<N, INT4>(smem, full, empty, s4, partial, sch, u0, n_units, M, Ncols, c, warp_idx / 4,
                     tid & 127);
  }
}

// out (M, N) bf16 = the tile sums times scale (nullable), cast once.
// Grid (N / 128, ceil(M / 4)): a tile's columns over four rows, four
// neighbouring columns a thread.
__global__ void __launch_bounds__(kBN)
reduce_out_kernel(const float* __restrict__ partial, TailSched sch, const float* __restrict__ scale,
                  __nv_bfloat16* __restrict__ out, int M, int N) {
  qa::pdl_launch_dependents();
  qa::pdl_wait();
  const int t = blockIdx.x, m = blockIdx.y * 4 + threadIdx.x / 32, col = 4 * (threadIdx.x % 32);
  if (m >= M) return;
  const int n = t * kBN + col;
  int c0, c1;
  tile_ctas(sch, t, &c0, &c1);
  float4 v = seg_sum4(partial, c0, c1, t, M, m, col);
  if (scale != nullptr) {
    const float4 s = *reinterpret_cast<const float4*>(scale + n);
    v.x *= s.x; v.y *= s.y; v.z *= s.z; v.w *= s.w;
  }
  __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(out + static_cast<size_t>(m) * N + n);
  o[0] = __floats2bfloat162_rn(v.x, v.y);
  o[1] = __floats2bfloat162_rn(v.z, v.w);
}

__device__ __forceinline__ float swiglu(float g, float u) {
  const float gb = qa::round_bf16(g), ub = qa::round_bf16(u);
  return qa::round_bf16(gb / (1.f + expf(-gb))) * ub;
}

// act[m][n] = cast(cast(silu(g)) * u): g and u the bf16-cast sums (times
// their int8 column scales) of columns n and I + n of the gate/up product.
// Grid (I / 128, ceil(M / 4)), as reduce_out_kernel.
__global__ void __launch_bounds__(kBN)
swiglu_kernel(const float* __restrict__ partial, TailSched sch, const float* __restrict__ scale,
              __nv_bfloat16* __restrict__ act, int M, int I) {
  qa::pdl_launch_dependents();
  qa::pdl_wait();
  const int t = blockIdx.x, tu = t + I / kBN, m = blockIdx.y * 4 + threadIdx.x / 32;
  const int col = 4 * (threadIdx.x % 32), n = t * kBN + col;
  if (m >= M) return;
  int c0, c1, u0, u1;
  tile_ctas(sch, t, &c0, &c1);
  tile_ctas(sch, tu, &u0, &u1);
  float4 g = seg_sum4(partial, c0, c1, t, M, m, col);
  float4 u = seg_sum4(partial, u0, u1, tu, M, m, col);
  if (scale != nullptr) {
    const float4 gs = *reinterpret_cast<const float4*>(scale + n);
    const float4 us = *reinterpret_cast<const float4*>(scale + I + n);
    g.x *= gs.x; g.y *= gs.y; g.z *= gs.z; g.w *= gs.w;
    u.x *= us.x; u.y *= us.y; u.z *= us.z; u.w *= us.w;
  }
  __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(act + static_cast<size_t>(m) * I + n);
  o[0] = __floats2bfloat162_rn(swiglu(g.x, u.x), swiglu(g.y, u.y));
  o[1] = __floats2bfloat162_rn(swiglu(g.z, u.z), swiglu(g.w, u.w));
}

// A cluster of R CTAs per row m, CTA r over columns [r E / R, (r + 1) E /
// R), one a thread. With `partial`: x1 = cast(resid + cast(tile sums *
// scale)) is written to x1_out; without: x1 = resid. With `norm`: h =
// cast(x1 * rsqrt(mean(x1^2) + eps) * norm) -> h_out, the sum of squares
// taken per CTA and added over the cluster's CTAs in rank order through
// distributed shared memory. Grid (R, M), E / R <= kRowThreads columns.
__global__ void __launch_bounds__(kRowThreads)
residual_norm_kernel(const float* __restrict__ partial, TailSched sch, const float* __restrict__ scale,
                     const __nv_bfloat16* __restrict__ resid, __nv_bfloat16* __restrict__ x1_out,
                     const float* __restrict__ norm, float eps, __nv_bfloat16* __restrict__ h_out,
                     int M, int E) {
  __shared__ float red[kRowThreads / 32];
  __shared__ float cta_ss;
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  qa::pdl_launch_dependents();
  qa::pdl_wait();
  const int ranks = static_cast<int>(cluster.num_blocks());
  const int m = blockIdx.y, per = E / ranks;
  const int n = static_cast<int>(cluster.block_rank()) * per + threadIdx.x;
  const bool mine = static_cast<int>(threadIdx.x) < per;
  const size_t idx = static_cast<size_t>(m) * E + n;
  float v = 0.f;
  if (mine) {
    v = __bfloat162float(resid[idx]);
    if (partial != nullptr) {
      const int t = n / kBN;
      int c0, c1;
      tile_ctas(sch, t, &c0, &c1);
      float acc = seg_sum(partial, c0, c1, t, M, m, n % kBN);
      if (scale != nullptr) acc *= scale[n];
      v = qa::round_bf16(v + qa::round_bf16(acc));
      x1_out[idx] = __float2bfloat16_rn(v);
    }
  }
  if (norm == nullptr) return;  // uniform over the cluster
  float ss = v * v;
  for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = ss;
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = 0.f;
    for (int i = 0; i < static_cast<int>(blockDim.x) / 32; ++i) s += red[i];
    cta_ss = s;
  }
  cluster.sync();  // every CTA's sum is written
  float total = 0.f;
  for (int r = 0; r < ranks; ++r) total += *cluster.map_shared_rank(&cta_ss, r);
  cluster.sync();  // no CTA leaves while a peer may still read its sum
  if (mine) h_out[idx] = __float2bfloat16_rn(v * rsqrtf(total / E + eps) * norm[n]);
}

// A launch with programmatic stream serialization (see qa::pdl_wait), in
// clusters of `cluster` CTAs along x when cluster > 1.
template <typename... Params, typename... Args>
cudaError_t launch_pdl(void (*kernel)(Params...), dim3 grid, int threads, size_t smem,
                       cudaStream_t stream, int cluster, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  attr[1].id = cudaLaunchAttributeClusterDimension;
  attr[1].val.clusterDim.x = cluster;
  attr[1].val.clusterDim.y = 1;
  attr[1].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cluster > 1 ? 2 : 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// The row kernel over M rows of E columns: clusters of R CTAs a row, R the
// largest divisor of E / 128 up to 8, E / R columns (one a thread) a CTA.
cudaError_t launch_rows(const float* partial, const TailSched& sch, const float* scale,
                        const __nv_bfloat16* resid, __nv_bfloat16* x1_out, const float* norm,
                        float eps, __nv_bfloat16* h_out, int M, int E, cudaStream_t stream) {
  const int tiles = E / kBN;
  int ranks = 8;
  while (tiles % ranks != 0) --ranks;
  const int per = E / ranks;
  if (per > kRowThreads) return cudaErrorInvalidValue;
  return launch_pdl(residual_norm_kernel, dim3(ranks, M), (per + 31) / 32 * 32, 0, stream, ranks,
                    partial, sch, scale, resid, x1_out, norm, eps, h_out, M, E);
}

template <int N, bool INT4>
cudaError_t launch_product(const CUtensorMap& tm_w, const CUtensorMap& tm_x, const float* s4,
                           float* partial, const TailSched& sch, int M, int Ncols,
                           cudaStream_t stream) {
  using C = TailCfg<N, INT4>;
  // Raise the dynamic shared-memory limit once per device (a launch may be
  // captured into a CUDA graph).
  static bool configured[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!configured[dev]) {
    err = cudaFuncSetAttribute(tail_gemm_kernel<N, INT4>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
    if (err != cudaSuccess) return err;
    configured[dev] = true;
  }
  return launch_pdl(tail_gemm_kernel<N, INT4>, dim3(sch.ctas), kThreads, C::kSmem, stream, 1,
                    tm_w, tm_x, s4, partial, sch, M, Ncols);
}

template <bool INT4>
cudaError_t launch_width(int width, const CUtensorMap& tm_w, const CUtensorMap& tm_x,
                         const float* s4, float* partial, const TailSched& sch, int M, int Ncols,
                         cudaStream_t stream) {
  switch (width) {
    case 8: return launch_product<8, INT4>(tm_w, tm_x, s4, partial, sch, M, Ncols, stream);
    case 16: return launch_product<16, INT4>(tm_w, tm_x, s4, partial, sch, M, Ncols, stream);
    case 32: return launch_product<32, INT4>(tm_w, tm_x, s4, partial, sch, M, Ncols, stream);
    case 64: return launch_product<64, INT4>(tm_w, tm_x, s4, partial, sch, M, Ncols, stream);
    case 128: return launch_product<128, INT4>(tm_w, tm_x, s4, partial, sch, M, Ncols, stream);
    case 256: return launch_product<256, INT4>(tm_w, tm_x, s4, partial, sch, M, Ncols, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

namespace qa {

cudaError_t tail_product(const __nv_bfloat16* x, QMat w, int M, int N, int K, float* partial,
                         TailSched* sched, cudaStream_t stream) {
  const int width = tail_width(M);
  if (width == 0 || N % kTailBN != 0 || K % (w.int4 ? 256 : kTailKB) != 0) return cudaErrorInvalidValue;
  *sched = tail_schedule(M, N, K, num_sms());
  CUtensorMap tm_w, tm_x;
  const int w_rows = w.int4 ? K / 2 : K;
  cudaError_t err = tensor_map_2d(&tm_w, w.q, kI8, N, w_rows, static_cast<size_t>(N), kTailBN,
                                  w.int4 ? kTailKB / 2 : kTailKB, true);
  if (err == cudaSuccess)
    err = tensor_map_2d(&tm_x, x, kBF16, K, M, static_cast<size_t>(K) * 2, 64, width, true);
  if (err != cudaSuccess) return err;
  return w.int4 ? launch_width<true>(width, tm_w, tm_x, w.s, partial, *sched, M, N, stream)
                : launch_width<false>(width, tm_w, tm_x, nullptr, partial, *sched, M, N, stream);
}

cudaError_t tail_reduce_out(const float* partial, const TailSched& sched, const float* scale,
                            __nv_bfloat16* out, int M, int N, cudaStream_t stream) {
  return launch_pdl(reduce_out_kernel, dim3(N / kTailBN, (M + 3) / 4), kTailBN, 0, stream, 1,
                    partial, sched, scale, out, M, N);
}

size_t layer_tail_workspace(int M, int E, int Q, int I, int F) {
  size_t need = std::max(tail_partial_floats(M, 2 * I, E), tail_partial_floats(M, E, I));
  if (Q > 0) need = std::max(need, tail_partial_floats(M, E, Q));
  if (F > 0) need = std::max(need, tail_partial_floats(M, F, E));
  return need;
}

cudaError_t layer_tail(const __nv_bfloat16* x, const __nv_bfloat16* attn, QMat wo, const float* norm,
                       QMat gu, QMat wd, const float* next_norm, QMat wqkv, __nv_bfloat16* out,
                       __nv_bfloat16* qkv_out, __nv_bfloat16* x1_buf, __nv_bfloat16* h,
                       __nv_bfloat16* act, float* partial, int M, int E, int Q, int I, int F,
                       float eps, int* launched, cudaStream_t stream) {
  const auto int8_scale = [](const QMat& w) { return w.int4 ? nullptr : w.s; };
  TailSched sch{};
  cudaError_t err;

  // (a) x1 = x + cast(attn @ wo); h = rmsnorm(x1).
  const __nv_bfloat16* x1 = x;
  if (attn != nullptr) {
    if ((err = tail_product(attn, wo, M, E, Q, partial, &sch, stream)) != cudaSuccess) return err;
    ++*launched;
    x1 = x1_buf;
    err = launch_rows(partial, sch, int8_scale(wo), x, x1_buf, norm, eps, h, M, E, stream);
  } else {
    err = launch_rows(nullptr, sch, nullptr, x, nullptr, norm, eps, h, M, E, stream);
  }
  if (err != cudaSuccess) return err;
  ++*launched;

  // (b) act = silu(cast(h @ w_gate)) * cast(h @ w_up).
  if ((err = tail_product(h, gu, M, 2 * I, E, partial, &sch, stream)) != cudaSuccess) return err;
  ++*launched;
  err = launch_pdl(swiglu_kernel, dim3(I / kTailBN, (M + 3) / 4), kTailBN, 0, stream, 1,
                   static_cast<const float*>(partial), sch, int8_scale(gu), act, M, I);
  if (err != cudaSuccess) return err;
  ++*launched;

  // (c) out = x1 + cast(act @ w_down); with a fold, h' = rmsnorm(out).
  if ((err = tail_product(act, wd, M, E, I, partial, &sch, stream)) != cudaSuccess) return err;
  ++*launched;
  err = launch_rows(partial, sch, int8_scale(wd), x1, out, next_norm, eps, h, M, E, stream);
  if (err != cudaSuccess) return err;
  ++*launched;

  // (d) qkv = cast(h' @ w_qkv).
  if (qkv_out == nullptr) return cudaSuccess;
  if ((err = tail_product(h, wqkv, M, F, E, partial, &sch, stream)) != cudaSuccess) return err;
  ++*launched;
  err = tail_reduce_out(partial, sch, int8_scale(wqkv), qkv_out, M, F, stream);
  if (err == cudaSuccess) ++*launched;
  return err;
}

}  // namespace qa

// The schedule of a (M rows, N columns, K deep) tail product on this card,
// for the tests: out[0..4] = CTAs, units per CTA (base), CTAs with one more
// (rem), column tiles, k-blocks; returns the activation width.
extern "C" int qa_tail_schedule(int M, int N, int K, int* out) {
  const qa::TailSched s = qa::tail_schedule(M, N, K, qa::num_sms());
  out[0] = s.ctas;
  out[1] = s.base;
  out[2] = s.rem;
  out[3] = s.tiles;
  out[4] = s.kblocks;
  return qa::tail_width(M);
}

extern "C" int qa_tail_workspace(int M, int N, int K) {
  return static_cast<int>(qa::tail_partial_floats(M, N, K));
}

// One tail product: out (M, N) bf16 = x (M, K) bf16 @ w (int8 codes (K, N)
// with (N,) scales, or packed int4 (K/2, N) with (K/128, N) group scales),
// through `partial` (qa_tail_workspace floats). Two launches.
extern "C" int qa_tail_matmul(const void* x, const void* w, const void* scale, int int4, void* out,
                              void* partial, int M, int N, int K, void* stream_ptr) {
  if (M == 0) return 0;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const qa::QMat mat{w, static_cast<const float*>(scale), int4};
  qa::TailSched sch{};
  auto* p = static_cast<float*>(partial);
  cudaError_t err = qa::tail_product(static_cast<const __nv_bfloat16*>(x), mat, M, N, K, p, &sch, stream);
  if (err == cudaSuccess)
    err = qa::tail_reduce_out(p, sch, int4 ? nullptr : mat.s, static_cast<__nv_bfloat16*>(out), M, N,
                              stream);
  return static_cast<int>(err);
}
