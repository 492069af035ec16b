// The split-KV decode-attention core of K4 (csrc/decode.cu, a contiguous
// slot cache) and K10 (csrc/paged.cu, KV pages through a page table),
// sm_90a.
//
// Both compute GQA decode attention: per (slot b, KV head h) the G query
// heads of the group, each with T query tokens (T = 1 for a decode step;
// T > 1 verifies T speculative candidates, whose rows are packed
// t-fastest, G * T rows, and candidate t sees the rows
// [0, lengths[b] - (T - 1 - t))), against the cache rows [0, lengths[b])
// (with a sliding window of left extent window_left, only the rows from
// lengths[b] - 1 - window_left - (T - 1 - t) on, decode.py:200-207),
// an exp2 online softmax in fp32, P.V with fp32 accumulation, a bf16
// output, and exact zeros for a slot of length 0. They differ in the row
// source (locate below) and in where a token scale enters (Mode). The cache
// elements (Kind): int8 or e4m3 codes with fp32 token scales, bf16, fp16 or
// fp32 rows, or int4 codes packed two a byte with token scales, in K4's slot cache along
// the head dim (byte d: element d low, d + D/2 high; the S product splits
// its depth in halves, the output columns of P.V come in the same halves)
// and in K10's pages along a page's tokens (byte row i of a page of ps
// tokens: token i low, i + ps/2 high; the tile follows the tokens, each
// tile row holding the byte row of its token and taking its nibble).
//
// What bounds it on the H100: bytes. Every valid row of K and V is read
// once (1 byte an element for int8 and e4m3, half a byte for int4, plus a
// 4-byte scale; 2 or 4 bytes for fp16 and fp32) for 4 * G * T * D flops,
// far below the card's ~295 flops/byte.
// The design:
//  - a persistent grid, sized from the SM count and the kernel's occupancy
//    (never from the lengths, so nothing is read back to the host and a
//    call can be captured in a CUDA graph). The work is the 64-row tiles of
//    every segment, a segment being (slot, KV head, query split, column
//    split), in that order. A slot's tiles start at the first that its
//    lowest query row can see (tile 0 without a window; with one,
//    (lengths[b] - T - window_left) / 64, candidate 0's first row), so the
//    boxes and pages below a window are never fetched nor looked up: a
//    window model streams about a window of rows a step, not the whole
//    cache (the port of JAX's block skip, decode.py:110-121, :464-477).
//    Each CTA sums the tiles of the B lengths itself
//    and takes an equal contiguous share of them (shares differ by at most
//    one tile; at least kMinTiles a CTA where there are enough, so fewer
//    CTAs take part in a short call), which may span segments.
//    ops/decode.decode_schedule is the same schedule in Python;
//  - one producer warp streams each tile into an mbarrier ring of 2-4
//    stages: TMA boxes of 16 rows from a 2-D map over the (rows, row
//    bytes) cache or page pool, 128-byte swizzled. The page of a 16-row box
//    is read from the table once, and only for rows below the length;
//    boxes at or past the length are never fetched. Where a box cannot be
//    a TMA box (a row stride that is not a multiple of 16 bytes, such as
//    int8 rows of D % 16 == 8 or int4 rows of D % 32 != 0; a page size that
//    is not a multiple of 16 tokens, or of 32 for int4 pages, so a box
//    would cross a page or a page's half) the warp's 32 lanes copy each
//    row below the length into the same swizzled layout by 16-, 8- or
//    4-byte cp.asyncs, a row's page (and K10's scales) read row by row;
//  - four consumer warps own 16 rows of every tile each, with swap-AB
//    mma.sync m16n8k16 products: S^T = K.Q^T (the cache rows are M, the
//    query rows N, rounded up to 8 or 16) and O^T = V^T.P^T (the output
//    columns are M). int8 and int4 codes become bf16 four at a time from
//    32-bit shared loads on the integer and fp32 pipes (a nibble masked
//    once a word), e4m3 codes by cvt.rn.f16x2.e4m3x2, exactly in every
//    case; fp16 rows enter fp16 products (the query rounded to fp16 by the
//    wrapper, exactly: it is bf16 already, and P rounded to fp16); fp32
//    rows are rounded to bf16 in registers for the bf16 products; P's
//    accumulators become P^T's B fragments by movmatrix.
//    Rows past the length may hold any bits (NaN codes of e4m3 or bf16
//    included): their scores are replaced by the mask value and their V
//    words by zeros. Each warp keeps
//    its own online softmax; at the end of a segment's run of tiles the
//    four merge in shared memory in warp order and one (m, l, acc) partial
//    is written, at index cta + segment;
//  - a merge kernel (csrc/decode_attn.cu) launched with programmatic
//    dependent launch sums each segment's partials in CTA order (bitwise
//    repeatable) and writes the bf16 output, zeros for an empty slot.
// The query rows of a segment are a runtime count up to 16 (more are split
// over segments: G * T rows give ceil(G * T / 16) query splits, each
// reading the slot's rows once) and the mask is one column limit per query
// row (row_shift), so the multi-query mode changes only the row count, the
// q and output offsets and each row's shift.
#pragma once

#include <cstring>

#include "common.cuh"
#include "hopper.cuh"

namespace qa {
namespace dattn {

constexpr int kRows = 64;      // cache rows per tile
constexpr int kBox = 16;       // rows per TMA box: one consumer warp's rows
constexpr int kConsumers = 4;  // consumer warps
constexpr int kThreads = (kConsumers + 1) * 32;
constexpr int kMaxQRows = 16;  // query rows of one segment
constexpr int kSmemCap = 232448;
constexpr int kTwoPerSm = 112 * 1024;  // shared memory of a CTA that lets two share an SM
constexpr int kMaxCtas = 256;          // CTAs of a call (the merge's weights a query row)

// Where a token scale enters (bf16 caches have none):
//   kScoreScale (K4, as JAX's _decode_kernel): exact codes in the products,
//     the K scale on the scores, P times the V scale rounded to bf16;
//   kElemScale (K10, as JAX's DMA path): code times the row's scale rounded
//     to bf16 per element, P rounded to bf16.
enum Mode { kScoreScale = 0, kElemScale = 1, kPlain16 = 2 };

// The cache elements (the kind codes of ops/decode.py): int8 and e4m3 rows
// of D codes, bf16, fp16 and fp32 rows of D values, int4 packed along the
// head dim (K4: rows of D/2 bytes) or along a page's tokens (K10: byte rows
// of D, two tokens each).
enum Kind { kKindI8 = 0, kKindF8 = 1, kKindBF16 = 2, kKindI4D = 3, kKindI4T = 4, kKindF16 = 5, kKindF32 = 6 };

struct Params {
  const void* q;           // (B, Hq, T, D): bf16 (fp16 for kKindF16)
  const float* ks;         // token scales, or null
  const float* vs;
  const int* lengths;      // (B,)
  const int* table;        // K10: (B, pps) page ids; K4: null
  const unsigned char* k;  // the rows for cp.async (tma == 0)
  const unsigned char* v;
  float* part_acc;         // (ctas + B * segs, qrows, ccols)
  float* part_ml;          // (ctas + B * segs, qrows, 2)
  int B, Hq, Hkv, D;
  int T;                   // query tokens a head (1: decode; > 1: verify)
  int smax;                // rows a slot can hold (K4: Smax; K10: pps * ps)
  int P, ps, pps;          // K10's pool (ps in tokens)
  int qsplits, csplits;    // query-row splits of 16 and column splits of VW
  int qrows, ccols;        // rows and columns of one split
  int vw;                  // columns of a split (the template's VW)
  int ctas;
  int tma;                 // 1: TMA boxes; 0: cp.async rows of `chunk` bytes
  int chunk;
  int half;                // head-dim-packed int4: W / 2 (the output halves); else 0
  int window_left;         // the window's left extent, -1 for none
  float score_scale;       // sm_scale * log2(e)
};

__host__ __device__ constexpr int elem_bytes(int kind) {
  return kind == kKindF32 ? 4 : (kind == kKindBF16 || kind == kKindF16) ? 2 : 1;
}

// The columns a CTA of width W owns (V and the output): all of W up to 256
// columns (fp32: up to 128); above, 256 for 1-byte codes and 64 for 2- and
// 4-byte rows (two to eight column splits, each scoring the full width), so
// two stages of K and V tiles fit the shared memory (fp32 at 512: one
// stage, see ring_stages). Head-dim-packed int4 splits its output columns
// in its two halves (low and high nibbles) at 512.
__host__ __device__ constexpr int v_cols(int W, int kind) {
  return kind == kKindF32 ? (W <= 128 ? W : 64) : W <= 256 ? W : (elem_bytes(kind) == 2 ? 64 : 256);
}

// The least stages a ring may have: two, so that a tile's copy overlaps
// the one before's products; one for fp32 rows at 512, whose 64-row K tile
// alone takes 128 KB.
__host__ __device__ constexpr int min_stages(int W, int kind) { return kind == kKindF32 && W == 512 ? 1 : 2; }

// Bytes of a cache row at width W, and of a K / V tile row in shared
// memory (whole 128-byte swizzle spans). Head-dim-packed int4 stages the
// whole packed row for V too.
__host__ __device__ constexpr int row_bytes(int W, int kind) {
  return kind == kKindI4D ? W / 2 : W * elem_bytes(kind);
}
__host__ __device__ constexpr int k_row_bytes(int W, int kind) {
  return row_bytes(W, kind) < 128 ? 128 : row_bytes(W, kind);
}
__host__ __device__ constexpr int v_row_bytes(int W, int kind) {
  return kind == kKindI4D ? k_row_bytes(W, kind)
                          : (v_cols(W, kind) * elem_bytes(kind) < 128 ? 128 : v_cols(W, kind) * elem_bytes(kind));
}
__host__ __device__ constexpr int stage_bytes(int W, int kind) {
  return kRows * (k_row_bytes(W, kind) + v_row_bytes(W, kind));
}
// Two buffers of query rows (bf16, rows 16 bytes apart beyond W), the
// warps' partials at the end of a segment, K10's token scales of each
// stage, the ring's barriers and the alignment slack.
__host__ __device__ constexpr int fixed_bytes(int W, int kind, int NG) {
  return 2 * NG * (2 * W + 16) + kConsumers * NG * (v_cols(W, kind) + 2) * 4 + 4 * 2 * kRows * 4 +
         2 * 4 * 8 + 1024;
}
// Stages of the ring: as many as fit, up to 4, in half an SM's shared
// memory (two CTAs an SM) where two fit there, else in all of it.
__host__ __device__ constexpr int ring_room(int W, int kind, int NG) {
  return (fixed_bytes(W, kind, NG) + 2 * stage_bytes(W, kind) <= kTwoPerSm ? kTwoPerSm : kSmemCap) -
         fixed_bytes(W, kind, NG);
}
__host__ __device__ constexpr int ring_stages(int W, int kind, int NG) {
  return ring_room(W, kind, NG) / stage_bytes(W, kind) > 4 ? 4 : ring_room(W, kind, NG) / stage_bytes(W, kind);
}
__host__ __device__ constexpr int smem_bytes(int W, int kind, int NG) {
  return ring_stages(W, kind, NG) * stage_bytes(W, kind) + fixed_bytes(W, kind, NG);
}

template <int W, int KIND, int NG>
struct Layout {
  static constexpr int kVW = v_cols(W, KIND);
  static constexpr int kKRow = k_row_bytes(W, KIND);
  static constexpr int kVRow = v_row_bytes(W, KIND);
  static constexpr int kKTile = kRows * kKRow;
  static constexpr int kStage = stage_bytes(W, KIND);
  static constexpr int kQStride = 2 * W + 16;  // bytes of a query row
  static constexpr int kQBytes = NG * kQStride;
  static constexpr int kScratch = kConsumers * NG * (kVW + 2) * 4;
  static constexpr int kStages = ring_stages(W, KIND, NG);
  static constexpr int kSmem = smem_bytes(W, KIND, NG);
  static constexpr int kPerSm = kSmem <= kTwoPerSm ? 2 : 1;
  static_assert(kStages >= min_stages(W, KIND) && kSmem <= kSmemCap, "the stages fit one CTA's shared memory");
};

// The rows of slot b: [0, min(lengths[b], smax)).
__device__ __forceinline__ int slot_len(const Params& p, int b) {
  return min(max(__ldg(p.lengths + b), 0), p.smax);
}

__device__ __forceinline__ int len_tiles(int len) { return (len + kRows - 1) / kRows; }

// The first 64-row tile of a slot of length len that any of its query rows
// can see: 0, or with a window the tile of candidate 0's first row.
__device__ __forceinline__ int first_tile(const Params& p, int len) {
  return p.window_left < 0 ? 0 : max(0, len - p.T - p.window_left) / kRows;
}

// The tiles a slot of length len runs: from first_tile to its last row's.
__device__ __forceinline__ int slot_tiles(const Params& p, int len) {
  return len_tiles(len) - first_tile(p, len);
}

// How far query row `qrow` of a KV head (rows packed t-fastest over the
// G * T rows of every split) sits before the last candidate: candidate
// t = qrow % T sees the slot's rows [0, len - (T - 1 - t)), so its column
// limit is len minus this shift; a one-token decode (T = 1) has shift 0.
// A limit <= 0 (only in an inactive slot shorter than T) masks every
// column of its row, whose output is then an average of V rows that no
// caller reads (JAX's kernel gives another average there; the tests leave
// such rows out). Only verify mode's kernels (MULTI) take it, once a
// segment: computed in the tile loop of every kernel it slowed the
// one-token step (K10 by 4% on an H100).
__device__ __forceinline__ int row_shift(const Params& p, int qrow) { return p.T - 1 - qrow % p.T; }

// The first of KV head h's G * T query rows of slot b (rows of D), in the
// (B, Hq, T, D) q and output.
__device__ __forceinline__ size_t head_row(const Params& p, int b, int h) {
  return (static_cast<size_t>(b) * p.Hq + static_cast<size_t>(h) * (p.Hq / p.Hkv)) * p.T;
}

// Where slot b's token r of KV head h lives: .x its row of the (rows, row
// bytes) view of the cache or pool, .y its token scale's index. K4: row
// (b * Hkv + h) * Smax + r; K10: token r % ps of page table[b][r / ps] (an
// id out of range is clamped), whose byte row in token-packed int4 pages is
// r % (ps / 2) of the page.
template <int KIND>
__device__ __forceinline__ int2 locate(const Params& p, int b, int h, int r) {
  if (p.table == nullptr) {
    const int x = (b * p.Hkv + h) * p.smax + r;
    return make_int2(x, x);
  }
  const int page = min(max(__ldg(p.table + b * p.pps + r / p.ps), 0), p.P - 1);
  const int o = r % p.ps, base = h * p.P + page;
  if constexpr (KIND == kKindI4T) {
    const int half = p.ps >> 1;
    return make_int2(base * half + (o < half ? o : o - half), base * p.ps + o);
  }
  return make_int2(base * p.ps + o, base * p.ps + o);
}

// The shift of token r's nibble in a token-packed int4 page: 4 in the
// page's second half.
__device__ __forceinline__ int nibble_shift(const Params& p, int r) {
  return r % p.ps >= (p.ps >> 1) ? 4 : 0;
}

// Byte offset of (row, byte column) in a tile of 128-byte-swizzled spans:
// span-major, 64 rows of 128 bytes a span (a TMA box's layout).
__device__ __forceinline__ int tile_off(int row, int col) {
  return (col >> 7) * (kRows * 128) + row * 128 + ((((col >> 4) ^ row) & 7) << 4) + (col & 15);
}

// The current tile of a CTA's share: slot b (length len, tiles i0 ..
// end - 1), segment j of the slot, tile i of the slot (its rows from
// i * 64 on).
struct TileIt {
  int b, j, i, len, i0, end;
};

// The share's tile after `it` (segments in order, empty slots skipped).
__device__ __forceinline__ void advance(const Params& p, int segs, TileIt& it) {
  if (++it.i < it.end) return;
  it.i = it.i0;
  if (++it.j < segs) return;
  it.j = 0;
  do {
    ++it.b;
    it.len = it.b < p.B ? slot_len(p, it.b) : 0;
    it.i0 = first_tile(p, it.len);
    it.end = len_tiles(it.len);
  } while (it.b < p.B && it.end == it.i0);
  it.i = it.i0;
}

// The CTAs that take part in a call of n tiles: each takes at least
// kMinTiles (fewer partials to merge), at most `ctas` of them.
constexpr int kMinTiles = 2;

__host__ __device__ __forceinline__ int active_ctas(int n, int ctas) {
  const int a = n / kMinTiles;
  return a < 1 ? 1 : (a < ctas ? a : ctas);
}

// The first tile of CTA c's share of n tiles, and its count: an equal
// contiguous share, one more for the first n % active CTAs.
__host__ __device__ __forceinline__ void share(int n, int ctas, int c, int& u0, int& count) {
  const int a = active_ctas(n, ctas);
  const int base = n / a, rem = n % a;
  u0 = c < a ? c * base + min(c, rem) : n;
  count = c < a ? base + (c < rem ? 1 : 0) : 0;
}

// The CTA whose share holds tile u.
__host__ __device__ __forceinline__ int owner(int n, int ctas, int u) {
  const int a = active_ctas(n, ctas);
  const int base = n / a, rem = n % a;
  const int big = rem * (base + 1);
  return u < big ? u / (base + 1) : rem + (u - big) / base;
}

// Every lane of a warp: CTA c's share of the call's tiles (its count; its
// first tile as `it` when the count is not 0). The lengths of the first 32
// slots stay in registers, so up to 32 slots are read once.
__device__ __forceinline__ void find_share(const Params& p, int segs, int c, TileIt& it, int& count) {
  const int lane = threadIdx.x & 31;
  const int len0 = lane < p.B ? slot_len(p, lane) : 0;
  auto slot = [&](int b0) { return b0 == 0 ? len0 : (b0 + lane < p.B ? slot_len(p, b0 + lane) : 0); };
  int total = 0;
  for (int b0 = 0; b0 < p.B; b0 += 32) {
    int x = slot_tiles(p, slot(b0)) * segs;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
    total += x;
  }
  int u;
  share(total, p.ctas, c, u, count);
  if (count == 0) return;
  int before = 0;
  for (int b0 = 0; b0 < p.B; b0 += 32) {
    const int len = slot(b0);
    const int x = slot_tiles(p, len) * segs;
    int inc = x;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, inc, o);
      if (lane >= o) inc += y;
    }
    if (u < before + __shfl_sync(0xffffffffu, inc, 31)) {
      const int L = __ffs(__ballot_sync(0xffffffffu, u < before + inc)) - 1;
      const int start = before + __shfl_sync(0xffffffffu, inc - x, L);
      const int lb = __shfl_sync(0xffffffffu, len, L);
      const int n = slot_tiles(p, lb);
      it.b = b0 + L;
      it.len = lb;
      it.i0 = first_tile(p, lb);
      it.end = it.i0 + n;
      it.j = (u - start) / n;
      it.i = it.i0 + (u - start) % n;
      return;
    }
    before += __shfl_sync(0xffffffffu, inc, 31);
  }
}

// ---------------------------------------------------------------------------
// Fragment helpers.
// ---------------------------------------------------------------------------

// e4m3 codes (byte i element i) as floats, exactly: cvt.rn.f16x2.e4m3x2
// (sm_89+) a pair at a time.
__device__ __forceinline__ void f8x4_to_float(uint32_t v, float (&f)[4]) {
  uint32_t h01, h23;
  asm("{\n.reg .b16 a, b;\nmov.b32 {a, b}, %2;\n"
      "cvt.rn.f16x2.e4m3x2 %0, a;\ncvt.rn.f16x2.e4m3x2 %1, b;\n}\n"
      : "=r"(h01), "=r"(h23) : "r"(v));
  const float2 x = __half22float2(*reinterpret_cast<const __half2*>(&h01));
  const float2 y = __half22float2(*reinterpret_cast<const __half2*>(&h23));
  f[0] = x.x;
  f[1] = x.y;
  f[2] = y.x;
  f[3] = y.y;
}

// Four codes of kind KIND in the bytes of v (int4: one nibble a byte, in
// the low four bits) as floats: integers offset to unsigned in the low
// mantissa byte of 2^23, minus 2^23 + the offset.
template <int KIND>
__device__ __forceinline__ void codes_to_float(uint32_t v, float (&f)[4]) {
  if constexpr (KIND == kKindF8) {
    f8x4_to_float(v, f);
  } else {
    constexpr bool kNib = KIND == kKindI4D || KIND == kKindI4T;
    const uint32_t u = v ^ (kNib ? 0x08080808u : 0x80808080u);
    const float off = kNib ? 8388616.f : 8388736.f;
#pragma unroll
    for (int e = 0; e < 4; ++e) f[e] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540 + e)) - off;
  }
}

// Four codes as bf16 pairs (0, 1) and (2, 3): exactly (every int8, int4
// and e4m3 value is a bf16), or with elements 0 and 2 times `sa`, 1 and 3
// times `sb`, each rounded once to bf16.
template <int KIND, bool SCALED>
__device__ __forceinline__ void codes_to_bf16(uint32_t v, float sa, float sb, uint32_t& lo, uint32_t& hi) {
  float f[4];
  codes_to_float<KIND>(v, f);
  if constexpr (SCALED) {
    lo = pack_bf16(f[0] * sa, f[1] * sb);
    hi = pack_bf16(f[2] * sa, f[3] * sb);
  } else {
    // An exact small integer or e4m3 value: its bf16 is the float's upper half.
    lo = __byte_perm(__float_as_uint(f[0]), __float_as_uint(f[1]), 0x7632);
    hi = __byte_perm(__float_as_uint(f[2]), __float_as_uint(f[3]), 0x7632);
  }
}

// The 16-bit products of kind KIND: fp16 for fp16 rows, bf16 for the rest
// (codes converted exactly, fp32 rows rounded).
template <int KIND>
__device__ __forceinline__ void mma16(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  if constexpr (KIND == kKindF16) {
    mma_f16(c, a, b0, b1);
  } else {
    mma_bf16(c, a, b0, b1);
  }
}
template <int KIND>
__device__ __forceinline__ uint32_t pack16(float lo, float hi) {
  if constexpr (KIND == kKindF16) {
    return pack_f16(lo, hi);
  } else {
    return pack_bf16(lo, hi);
  }
}

// The nibbles of a packed int4 word at shift `sh` (0 low, 4 high), one a byte.
__device__ __forceinline__ uint32_t nibbles(uint32_t v, int sh) { return (v >> sh) & 0x0F0F0F0Fu; }

// The 8x8 b16 matrix held as accumulator fragments (lane 4g + t: row g,
// columns 2t, 2t + 1), transposed in place.
__device__ __forceinline__ uint32_t movmatrix_trans(uint32_t a) {
  uint32_t d;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n" : "=r"(d) : "r"(a));
  return d;
}

// N (4, 8 or 16) bytes from device memory to shared memory,
// asynchronously; zeros when !valid (the source is then not read).
template <int N>
__device__ __forceinline__ void cp_async_n(void* smem, const void* gmem, bool valid = true) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n"
               :: "r"(smem_addr(smem)), "l"(gmem), "n"(N), "r"(valid ? N : 0));
}

// `bytes` bytes of a row (a multiple of `chunk`, both ends `chunk`-aligned)
// into row `row` of a swizzled tile.
__device__ __forceinline__ void copy_row(unsigned char* tile, int row, const unsigned char* src,
                                         int bytes, int chunk) {
  for (int c = 0; c < bytes; c += chunk) {
    if (chunk == 16) {
      cp_async_n<16>(tile + tile_off(row, c), src + c);
    } else if (chunk == 8) {
      cp_async_n<8>(tile + tile_off(row, c), src + c);
    } else {
      cp_async_n<4>(tile + tile_off(row, c), src + c);
    }
  }
}

// An arrival on `bar` once this thread's earlier cp.asyncs have landed.
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" :: "r"(smem_addr(bar))
               : "memory");
}


// ---------------------------------------------------------------------------
// The kernel. Grid: p.ctas CTAs of kThreads; warps 0-3 consume, warp 4
// produces. W: the instantiated width; NG: query rows of a segment rounded
// up to 8 or 16; MODE and KIND above; MULTI: T > 1 (verify mode, the
// per-row shifts), so that a one-token step runs no code of that mode.
// ---------------------------------------------------------------------------

template <int W, int NG, int MODE, int KIND, bool MULTI>
__global__ void __launch_bounds__(kThreads, Layout<W, KIND, NG>::kPerSm)
decode_attn_kernel(const __grid_constant__ CUtensorMap tm_k, const __grid_constant__ CUtensorMap tm_v,
                   const Params p) {
  constexpr int E = elem_bytes(KIND);
  constexpr int kMapE = KIND == kKindBF16 ? 2 : 1;  // bytes of a tensor-map element (fp16, fp32: bytes)
  constexpr bool kFloatCodes = KIND == kKindF8;     // 1-byte codes that may hold NaN bits
  using L = Layout<W, KIND, NG>;
  constexpr int kVW = L::kVW;
  constexpr int kNT = NG / 8;    // query n-tiles of 8
  constexpr int kKK = W / 16;    // depth steps of S^T
  constexpr int kCB = kVW / 32;  // pairs of 16-column output tiles
  constexpr int S = L::kStages;
  constexpr int kGroup = 8;      // tiles whose boxes the producer locates at once
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* ring = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* qbuf = ring + S * L::kStage;                    // two query buffers
  float* scratch = reinterpret_cast<float*>(qbuf + 2 * L::kQBytes);  // [warp][NG][kVW]
  float* scratch_ml = scratch + kConsumers * NG * kVW;           // [warp][NG][2]
  float* scale_ring = scratch_ml + kConsumers * NG * 2;          // [stage][K 64 | V 64] (K10)
  uint64_t* full = reinterpret_cast<uint64_t*>(scale_ring + 4 * 2 * kRows);
  uint64_t* empty = full + 4;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int splits = p.qsplits * p.csplits;
  const int segs = p.Hkv * splits;
  const int krow = KIND == kKindI4D ? p.D / 2 : p.D * E;  // bytes of a cache row
  pdl_launch_dependents();

  TileIt it;
  int count;
  find_share(p, segs, blockIdx.x, it, count);
  if (count == 0) return;
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], p.tma ? 1 : 32);
      mbar_init(&empty[s], kConsumers);
    }
    mbar_init_fence();
  }
  if (!p.tma) {
    // cp.async rows never write a K tile's bytes past the row: zero them
    // once (the query's zero columns meet them; stale e4m3 or bf16 bits
    // there could be NaN).
    const int words = (L::kKRow - krow) / 4;
    for (int x = threadIdx.x; x < S * kRows * words; x += kThreads) {
      const int s = x / (kRows * words), r = (x / words) % kRows, c = krow + 4 * (x % words);
      *reinterpret_cast<uint32_t*>(ring + s * L::kStage + tile_off(r, c)) = 0u;
    }
  }
  __syncthreads();

  if (warp == kConsumers) {
    // The producer. TMA: its lanes locate the 16-row boxes of kGroup tiles
    // at a time (lane 4a + x: box x of the group's tile a; K10 reads the
    // page table there, in parallel), then lane 0 streams each tile's boxes
    // below the length. cp.async: the lanes copy the tile's rows below the
    // length, a row each.
    if (p.tma && lane == 0) {
      tma_prefetch(&tm_k);
      tma_prefetch(&tm_v);
    }
    const int vcol = KIND == kKindI4D ? 0 : 1;  // V columns follow the split
    for (int k0 = 0; k0 < count; k0 += kGroup) {
      int2 mine_loc = make_int2(0, 0);
      if (p.tma) {
        TileIt mine = it;
        for (int a = 0; a < lane / 4 && k0 + a + 1 < count; ++a) advance(p, segs, mine);
        const int r_box = mine.i * kRows + (lane & 3) * kBox;
        if (k0 + lane / 4 < count && r_box < mine.len) mine_loc = locate<KIND>(p, mine.b, mine.j / splits, r_box);
      }
      for (int k = k0; k < min(k0 + kGroup, count); ++k) {
        const int s = k % S;
        if (k >= S) mbar_wait(&empty[s], (k / S + 1) & 1);
        const int cs = it.j % p.csplits;
        const int nrow = min(kRows, it.len - it.i * kRows);
        unsigned char* kt = ring + s * L::kStage;
        unsigned char* vt = kt + L::kKTile;
        float* st = scale_ring + s * 2 * kRows;
        if (p.tma) {
          const int nbox = (nrow + kBox - 1) / kBox;
          int rows[kRows / kBox], srows[kRows / kBox];
#pragma unroll
          for (int bx = 0; bx < kRows / kBox; ++bx) {
            rows[bx] = __shfl_sync(0xffffffffu, mine_loc.x, (k - k0) * 4 + bx);
            srows[bx] = __shfl_sync(0xffffffffu, mine_loc.y, (k - k0) * 4 + bx);
          }
          if (lane == 0) {
            uint32_t bytes = nbox * kBox * (L::kKRow + L::kVRow);
            if constexpr (MODE == kElemScale) bytes += nbox * 2 * kBox * 4;
            mbar_expect_tx(&full[s], bytes);
            for (int bx = 0; bx < nbox; ++bx) {
#pragma unroll
              for (int c = 0; c < L::kKRow / 128; ++c)
                tma_load_2d(kt + c * kRows * 128 + bx * kBox * 128, &tm_k, &full[s], c * (128 / kMapE),
                            rows[bx]);
#pragma unroll
              for (int c = 0; c < L::kVRow / 128; ++c)
                tma_load_2d(vt + c * kRows * 128 + bx * kBox * 128, &tm_v, &full[s],
                            vcol * cs * kVW * E / kMapE + c * (128 / kMapE), rows[bx]);
              if constexpr (MODE == kElemScale) {
                bulk_load(st + bx * kBox, p.ks + srows[bx], kBox * 4, &full[s]);
                bulk_load(st + kRows + bx * kBox, p.vs + srows[bx], kBox * 4, &full[s]);
              }
            }
            mbar_arrive(&full[s]);
          }
        } else {
          const int h = it.j / splits;
          const int v0 = KIND == kKindI4D ? 0 : cs * kVW * E;
          const int vbytes = KIND == kKindI4D ? krow : min(kVW, p.D - cs * kVW) * E;
          for (int r = lane; r < nrow; r += 32) {
            const int2 loc = locate<KIND>(p, it.b, h, it.i * kRows + r);
            copy_row(kt, r, p.k + static_cast<size_t>(loc.x) * krow, krow, p.chunk);
            copy_row(vt, r, p.v + static_cast<size_t>(loc.x) * krow + v0, vbytes, p.chunk);
            if constexpr (MODE == kElemScale) {
              cp_async_n<4>(st + r, p.ks + loc.y);
              cp_async_n<4>(st + kRows + r, p.vs + loc.y);
            }
          }
          cp_async_arrive(&full[s]);
        }
        advance(p, segs, it);
      }
    }
    return;
  }

  // The consumers. Lane 4g + t; this warp's rows of a tile are
  // wrow .. wrow + 15: S^T's rows wrow + g and wrow + g + 8, P^T's depth
  // rows wrow + 2t, +1, +8, +9.
  const int g = lane >> 2, t = lane & 3;
  const int wrow = warp * kBox;
  const int GT = p.Hq / p.Hkv * p.T;  // query rows of a KV head

  // A segment's query rows into query buffer `buf` by cp.asyncs: zero rows
  // up to NG, zero columns past D. Head-dim-packed int4 meets the low
  // nibbles with columns [0, W/2) of the buffer and the high nibbles with
  // [W/2, W): the query's columns [0, D/2) go to the first, [D/2, D) to the
  // second, 4 at a time (D/2 is a multiple of 4).
  auto load_q = [&](const TileIt& x, int buf) {
    const int h = x.j / splits, qs = (x.j / p.csplits) % p.qsplits;
    const int rows = min(kMaxQRows, GT - qs * kMaxQRows);
    const __nv_bfloat16* src =
        static_cast<const __nv_bfloat16*>(p.q) + (head_row(p, x.b, h) + qs * kMaxQRows) * p.D;
    unsigned char* dst = qbuf + buf * L::kQBytes;
    if constexpr (KIND == kKindI4D) {
      const int dh = p.D / 2;
      for (int i = threadIdx.x; i < NG * (W / 4); i += kConsumers * 32) {
        const int r = i / (W / 4), c = (i % (W / 4)) * 4;
        const int hc = c % (W / 2), sc = hc + (c >= W / 2 ? dh : 0);
        const bool ok = r < rows && hc < dh;
        cp_async_n<8>(dst + r * L::kQStride + c * 2, ok ? src + static_cast<size_t>(r) * p.D + sc : src, ok);
      }
    } else {
      for (int i = threadIdx.x; i < NG * (W / 8); i += kConsumers * 32) {
        const int r = i / (W / 8), c = (i % (W / 8)) * 8;
        const bool ok = r < rows && c < p.D;
        cp_async16(dst + r * L::kQStride + c * 2, ok ? src + static_cast<size_t>(r) * p.D + c : src, ok);
      }
    }
    cp_async_commit();
  };
  // K4's token scales of a tile, one load ahead (zero past the length): the
  // K and V scales of rows g, g + 8 of the warp's 16.
  auto load_scales = [&](const TileIt& x, float (&sc)[4]) {
    if constexpr (MODE == kScoreScale) {
      const int rbase = x.i * kRows + wrow;
      if (rbase < x.len) {
        const int pr = locate<KIND>(p, x.b, x.j / splits, rbase).y;
        sc[0] = rbase + g < x.len ? __ldg(p.ks + pr + g) : 0.f;
        sc[1] = rbase + g + 8 < x.len ? __ldg(p.ks + pr + g + 8) : 0.f;
        sc[2] = rbase + g < x.len ? __ldg(p.vs + pr + g) : 0.f;
        sc[3] = rbase + g + 8 < x.len ? __ldg(p.vs + pr + g + 8) : 0.f;
      }
    }
  };

  float o[2 * kCB][kNT][4];
  float m_run[kNT][2], l_run[kNT][2];  // per query 8j + 2t + e; l this lane's rows only
  auto reset = [&]() {
#pragma unroll
    for (int mt = 0; mt < 2 * kCB; ++mt)
#pragma unroll
      for (int j = 0; j < kNT; ++j) o[mt][j][0] = o[mt][j][1] = o[mt][j][2] = o[mt][j][3] = 0.f;
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      m_run[j][0] = m_run[j][1] = -INFINITY;
      l_run[j][0] = l_run[j][1] = 0.f;
    }
  };
  reset();
  // Verify mode: this lane's query rows' shifts (row_shift) in the current
  // segment.
  int shift[kNT][2];
  auto set_shift = [&](const TileIt& x) {
    if constexpr (MULTI) {
      const int qs = (x.j / p.csplits) % p.qsplits;
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) shift[j][e] = row_shift(p, qs * kMaxQRows + 8 * j + 2 * t + e);
    }
  };
  set_shift(it);
  int qcur = 0;
  load_q(it, 0);
  float sc[4] = {0.f, 0.f, 0.f, 0.f}, sc_next[4] = {0.f, 0.f, 0.f, 0.f};
  load_scales(it, sc);
  cp_async_wait<0>();
  named_barrier(1, kConsumers * 32);

  for (int k = 0; k < count; ++k) {
    const bool more = k + 1 < count;
    TileIt nx = it;
    if (more) {
      advance(p, segs, nx);
      load_scales(nx, sc_next);
    }
    const bool last = !more || nx.b != it.b || nx.j != it.j;  // of this segment's run
    if (last && more) load_q(nx, qcur ^ 1);
    const int s = k % S;
    const int rbase = it.i * kRows + wrow;  // the slot row of this warp's first row
    const int nvalid = it.len - rbase;      // of this warp's rows, those below the length
    if (nvalid > 0) {
      mbar_wait(&full[s], (k / S) & 1);
      const unsigned char* kt = ring + s * L::kStage;
      const unsigned char* vt = kt + L::kKTile;
      const unsigned char* qsm = qbuf + qcur * L::kQBytes;
      const int cs = it.j % p.csplits;
      // K10's scales of rows g, g + 8 (K) and 2t, 2t + 1, 2t + 8, 2t + 9
      // (V), zero past the length (the box's rows there may hold any bits).
      float ksa = 0.f, ksb = 0.f, vs0 = 0.f, vs1 = 0.f, vs8 = 0.f, vs9 = 0.f;
      if constexpr (MODE == kElemScale) {
        const float* st = scale_ring + s * 2 * kRows + wrow;
        ksa = g < nvalid ? st[g] : 0.f;
        ksb = g + 8 < nvalid ? st[g + 8] : 0.f;
        vs0 = 2 * t < nvalid ? st[kRows + 2 * t] : 0.f;
        vs1 = 2 * t + 1 < nvalid ? st[kRows + 2 * t + 1] : 0.f;
        vs8 = 2 * t + 8 < nvalid ? st[kRows + 2 * t + 8] : 0.f;
        vs9 = 2 * t + 9 < nvalid ? st[kRows + 2 * t + 9] : 0.f;
      }
      const int ra = wrow + g, rb = ra + 8;
      // Token-packed int4: the nibble of each row this lane converts.
      int sha = 0, shb = 0, sh0 = 0, sh1 = 0, sh8 = 0, sh9 = 0;
      if constexpr (KIND == kKindI4T) {
        const int r0 = it.i * kRows;
        sha = nibble_shift(p, r0 + ra);
        shb = nibble_shift(p, r0 + rb);
        sh0 = nibble_shift(p, rbase + 2 * t);
        sh1 = nibble_shift(p, rbase + 2 * t + 1);
        sh8 = nibble_shift(p, rbase + 2 * t + 8);
        sh9 = nibble_shift(p, rbase + 2 * t + 9);
      }

      // S^T = K . Q^T: K's depth in the order (4t, 4t+1 | 4t+2, 4t+3) of
      // each 16 columns, Q's B fragments in the same order; even and odd
      // depth steps (head-dim-packed int4: low and high halves) into two
      // sums, so two products are in flight.
      float sacc[kNT][4], sodd[kNT][4];
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sacc[j][e] = sodd[j][e] = 0.f;
      if constexpr (KIND == kKindI4D) {
#pragma unroll
        for (int kk = 0; kk < kKK / 2; ++kk) {
          const uint32_t wa = *reinterpret_cast<const uint32_t*>(kt + tile_off(ra, kk * 16 + 4 * t));
          const uint32_t wb = *reinterpret_cast<const uint32_t*>(kt + tile_off(rb, kk * 16 + 4 * t));
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            uint32_t a[4];
            codes_to_bf16<KIND, false>(nibbles(wa, 4 * hh), 1.f, 1.f, a[0], a[2]);
            codes_to_bf16<KIND, false>(nibbles(wb, 4 * hh), 1.f, 1.f, a[1], a[3]);
#pragma unroll
            for (int j = 0; j < kNT; ++j) {
              const uint2 qv = *reinterpret_cast<const uint2*>(
                  qsm + (8 * j + g) * L::kQStride + (hh * (W / 2) + kk * 16 + 4 * t) * 2);
              mma_bf16(hh ? sodd[j] : sacc[j], a, qv.x, qv.y);
            }
          }
        }
      } else {
#pragma unroll
        for (int kk = 0; kk < kKK; ++kk) {
          uint32_t a[4];
          if constexpr (E == 1) {
            uint32_t wa = *reinterpret_cast<const uint32_t*>(kt + tile_off(ra, kk * 16 + 4 * t));
            uint32_t wb = *reinterpret_cast<const uint32_t*>(kt + tile_off(rb, kk * 16 + 4 * t));
            if constexpr (KIND == kKindI4T) {
              wa = nibbles(wa, sha);
              wb = nibbles(wb, shb);
            }
            codes_to_bf16<KIND, MODE == kElemScale>(wa, ksa, ksa, a[0], a[2]);
            codes_to_bf16<KIND, MODE == kElemScale>(wb, ksb, ksb, a[1], a[3]);
          } else if constexpr (E == 4) {
            // fp32 rows: depth 4t .. 4t + 3 of the step, rounded to bf16.
            const float4 xa = *reinterpret_cast<const float4*>(kt + tile_off(ra, kk * 64 + 16 * t));
            const float4 xb = *reinterpret_cast<const float4*>(kt + tile_off(rb, kk * 64 + 16 * t));
            a[0] = pack_bf16(xa.x, xa.y);
            a[2] = pack_bf16(xa.z, xa.w);
            a[1] = pack_bf16(xb.x, xb.y);
            a[3] = pack_bf16(xb.z, xb.w);
          } else {
            const uint2 xa = *reinterpret_cast<const uint2*>(kt + tile_off(ra, kk * 32 + 8 * t));
            const uint2 xb = *reinterpret_cast<const uint2*>(kt + tile_off(rb, kk * 32 + 8 * t));
            a[0] = xa.x;
            a[2] = xa.y;
            a[1] = xb.x;
            a[3] = xb.y;
          }
#pragma unroll
          for (int j = 0; j < kNT; ++j) {
            const uint2 qv = *reinterpret_cast<const uint2*>(qsm + (8 * j + g) * L::kQStride + (kk * 16 + 4 * t) * 2);
            mma16<KIND>(kk & 1 ? sodd[j] : sacc[j], a, qv.x, qv.y);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sacc[j][e] += sodd[j][e];

      // Scale, mask (a slot row at or past its query row's limit, or below
      // its window), online softmax per query; P (times K4's V scale) as
      // P^T's B fragments.
      const int sa = it.i * kRows + ra, sb = sa + 8;  // slot rows of the accumulators
      // The first row the last candidate sees (-1: every row, no window).
      const int lo_last = p.window_left < 0 ? -1 : it.len - 1 - p.window_left;
      uint32_t pb[kNT][2];
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        float pv[2][2];  // [row a / b][query e]
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          int lim = it.len, lo = lo_last;
          if constexpr (MULTI) {
            lim -= shift[j][e];
            lo -= shift[j][e];
          }
          float x0 = sacc[j][e] * p.score_scale, x1 = sacc[j][2 + e] * p.score_scale;
          if constexpr (MODE == kScoreScale) {
            x0 *= sc[0];
            x1 *= sc[1];
          }
          x0 = sa < lim && sa >= lo ? x0 : kMaskValue;
          x1 = sb < lim && sb >= lo ? x1 : kMaskValue;
          float mx = fmaxf(x0, x1);
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 8));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 16));
          const float m_new = fmaxf(m_run[j][e], mx);
          const float alpha = exp2f(m_run[j][e] - m_new);
          m_run[j][e] = m_new;
          const float p0 = exp2f(x0 - m_new), p1 = exp2f(x1 - m_new);
          l_run[j][e] = alpha * l_run[j][e] + (p0 + p1);
#pragma unroll
          for (int mt = 0; mt < 2 * kCB; ++mt) {
            o[mt][j][e] *= alpha;
            o[mt][j][2 + e] *= alpha;
          }
          if constexpr (MODE == kScoreScale) {
            pv[0][e] = p0 * sc[2];
            pv[1][e] = p1 * sc[3];
          } else {
            pv[0][e] = p0;
            pv[1][e] = p1;
          }
        }
        pb[j][0] = movmatrix_trans(pack16<KIND>(pv[0][0], pv[0][1]));
        pb[j][1] = movmatrix_trans(pack16<KIND>(pv[1][0], pv[1][1]));
      }

      // O^T += V^T . P^T: output columns 32cb + 4g .. +3 of the split are
      // this lane's (rows g and g + 8 of output tiles 2cb and 2cb + 1).
      // Head-dim-packed int4: column f of the W-wide output frame is the
      // low nibble of packed byte f (f < W/2) or the high nibble of byte
      // f - W/2; the merge maps the frame onto the D columns.
      const int v0 = wrow + 2 * t;
      const bool partial = nvalid < kBox;
#pragma unroll
      for (int cb = 0; cb < kCB; ++cb) {
        uint32_t a0[4], a1[4];  // output tiles 2cb and 2cb + 1
        if constexpr (E == 1) {
          int col = 32 * cb + 4 * g;
          int shc = 0;
          if constexpr (KIND == kKindI4D) {
            const int f = cs * kVW + 32 * cb;
            shc = f >= W / 2 ? 4 : 0;
            col = f % (W / 2) + 4 * g;
          }
          uint32_t x0 = *reinterpret_cast<const uint32_t*>(vt + tile_off(v0, col));
          uint32_t x1 = *reinterpret_cast<const uint32_t*>(vt + tile_off(v0 + 1, col));
          uint32_t x8 = *reinterpret_cast<const uint32_t*>(vt + tile_off(v0 + 8, col));
          uint32_t x9 = *reinterpret_cast<const uint32_t*>(vt + tile_off(v0 + 9, col));
          if constexpr (KIND == kKindI4D) {
            x0 = nibbles(x0, shc);
            x1 = nibbles(x1, shc);
            x8 = nibbles(x8, shc);
            x9 = nibbles(x9, shc);
          } else if constexpr (KIND == kKindI4T) {
            x0 = nibbles(x0, sh0);
            x1 = nibbles(x1, sh1);
            x8 = nibbles(x8, sh8);
            x9 = nibbles(x9, sh9);
          } else if constexpr (kFloatCodes) {
            if (partial) {  // rows past the length may hold any bits: zero them
              x0 = 2 * t < nvalid ? x0 : 0u;
              x1 = 2 * t + 1 < nvalid ? x1 : 0u;
              x8 = 2 * t + 8 < nvalid ? x8 : 0u;
              x9 = 2 * t + 9 < nvalid ? x9 : 0u;
            }
          }
          const uint32_t y0 = __byte_perm(x0, x1, 0x5140), y1 = __byte_perm(x0, x1, 0x7362);
          const uint32_t y8 = __byte_perm(x8, x9, 0x5140), y9 = __byte_perm(x8, x9, 0x7362);
          constexpr bool kScaled = MODE == kElemScale;
          codes_to_bf16<KIND, kScaled>(y0, vs0, vs1, a0[0], a0[1]);
          codes_to_bf16<KIND, kScaled>(y1, vs0, vs1, a1[0], a1[1]);
          codes_to_bf16<KIND, kScaled>(y8, vs8, vs9, a0[2], a0[3]);
          codes_to_bf16<KIND, kScaled>(y9, vs8, vs9, a1[2], a1[3]);
        } else if constexpr (E == 4) {
          // fp32 rows: columns 4g .. 4g + 3 of the 32, rounded to bf16 (rows
          // past the length may hold any bits: zeroed).
          const int col = 128 * cb + 16 * g;
          float4 x0 = *reinterpret_cast<const float4*>(vt + tile_off(v0, col));
          float4 x1 = *reinterpret_cast<const float4*>(vt + tile_off(v0 + 1, col));
          float4 x8 = *reinterpret_cast<const float4*>(vt + tile_off(v0 + 8, col));
          float4 x9 = *reinterpret_cast<const float4*>(vt + tile_off(v0 + 9, col));
          if (partial) {
            const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
            x0 = 2 * t < nvalid ? x0 : z;
            x1 = 2 * t + 1 < nvalid ? x1 : z;
            x8 = 2 * t + 8 < nvalid ? x8 : z;
            x9 = 2 * t + 9 < nvalid ? x9 : z;
          }
          a0[0] = pack_bf16(x0.x, x1.x);
          a0[1] = pack_bf16(x0.y, x1.y);
          a0[2] = pack_bf16(x8.x, x9.x);
          a0[3] = pack_bf16(x8.y, x9.y);
          a1[0] = pack_bf16(x0.z, x1.z);
          a1[1] = pack_bf16(x0.w, x1.w);
          a1[2] = pack_bf16(x8.z, x9.z);
          a1[3] = pack_bf16(x8.w, x9.w);
        } else {
          const int col = 64 * cb + 8 * g;
          uint2 x0 = *reinterpret_cast<const uint2*>(vt + tile_off(v0, col));
          uint2 x1 = *reinterpret_cast<const uint2*>(vt + tile_off(v0 + 1, col));
          uint2 x8 = *reinterpret_cast<const uint2*>(vt + tile_off(v0 + 8, col));
          uint2 x9 = *reinterpret_cast<const uint2*>(vt + tile_off(v0 + 9, col));
          if (partial) {  // rows past the length may hold any bits: zero them
            const uint2 z = make_uint2(0u, 0u);
            x0 = 2 * t < nvalid ? x0 : z;
            x1 = 2 * t + 1 < nvalid ? x1 : z;
            x8 = 2 * t + 8 < nvalid ? x8 : z;
            x9 = 2 * t + 9 < nvalid ? x9 : z;
          }
          a0[0] = __byte_perm(x0.x, x1.x, 0x5410);
          a0[1] = __byte_perm(x0.x, x1.x, 0x7632);
          a0[2] = __byte_perm(x8.x, x9.x, 0x5410);
          a0[3] = __byte_perm(x8.x, x9.x, 0x7632);
          a1[0] = __byte_perm(x0.y, x1.y, 0x5410);
          a1[1] = __byte_perm(x0.y, x1.y, 0x7632);
          a1[2] = __byte_perm(x8.y, x9.y, 0x5410);
          a1[3] = __byte_perm(x8.y, x9.y, 0x7632);
        }
#pragma unroll
        for (int j = 0; j < kNT; ++j) {
          mma16<KIND>(o[2 * cb][j], a0, pb[j][0], pb[j][1]);
          mma16<KIND>(o[2 * cb + 1][j], a1, pb[j][0], pb[j][1]);
        }
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);

    if (last) {
      // The end of this segment's run: the warps' (m, l, acc) into shared
      // memory, merged in warp order into the partial at cta + segment.
      float* wacc = scratch + warp * NG * kVW;
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        const int q = 8 * j + 2 * t;
#pragma unroll
        for (int mt = 0; mt < 2 * kCB; ++mt) {
          const int col = 32 * (mt >> 1) + 4 * g + 2 * (mt & 1);
          *reinterpret_cast<float2*>(wacc + q * kVW + col) = make_float2(o[mt][j][0], o[mt][j][2]);
          *reinterpret_cast<float2*>(wacc + (q + 1) * kVW + col) = make_float2(o[mt][j][1], o[mt][j][3]);
        }
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float l = l_run[j][e];
          l += __shfl_xor_sync(0xffffffffu, l, 4);
          l += __shfl_xor_sync(0xffffffffu, l, 8);
          l += __shfl_xor_sync(0xffffffffu, l, 16);
          if (g == 0) {
            scratch_ml[2 * (warp * NG + q + e)] = m_run[j][e];
            scratch_ml[2 * (warp * NG + q + e) + 1] = l;
          }
        }
      }
      named_barrier(1, kConsumers * 32);
      const int qs = (it.j / p.csplits) % p.qsplits, cs = it.j % p.csplits;
      const int rows = min(kMaxQRows, GT - qs * kMaxQRows);
      const int cols = KIND == kKindI4D ? kVW : min(kVW, p.D - cs * kVW);
      const size_t piece = blockIdx.x + static_cast<size_t>(it.b) * segs + it.j;
      for (int i = threadIdx.x; i < rows * cols; i += kConsumers * 32) {
        const int q = i / cols, c = i % cols;
        float mx = -INFINITY;
#pragma unroll
        for (int w = 0; w < kConsumers; ++w) mx = fmaxf(mx, scratch_ml[2 * (w * NG + q)]);
        float acc = 0.f, l = 0.f;
#pragma unroll
        for (int w = 0; w < kConsumers; ++w) {
          const float f = exp2f(scratch_ml[2 * (w * NG + q)] - mx);  // 0 for a warp without rows
          acc += f * scratch[(w * NG + q) * kVW + c];
          l += f * scratch_ml[2 * (w * NG + q) + 1];
        }
        p.part_acc[(piece * p.qrows + q) * p.ccols + c] = acc;
        if (c == 0) {
          p.part_ml[2 * (piece * p.qrows + q)] = mx;
          p.part_ml[2 * (piece * p.qrows + q) + 1] = l;
        }
      }
      cp_async_wait<0>();  // the next segment's queries
      named_barrier(1, kConsumers * 32);
      qcur ^= 1;
      reset();
      set_shift(nx);
    }
    it = nx;
#pragma unroll
    for (int i = 0; i < 4; ++i) sc[i] = sc_next[i];
  }
}

// The merge of every segment's partials (csrc/decode_attn.cu): grid (segs,
// B), launched with programmatic dependent launch after the kernel above.
cudaError_t merge(const Params& p, __nv_bfloat16* out, cudaStream_t stream);

// The plan of one call: the instantiation, the grid, the splits and how the
// rows are copied.
struct Plan {
  int W, NG, ctas, qsplits, csplits, qrows, ccols, vw, segs, tma, chunk, half;
};

// Fills *pl for a call over B slots of Hq / Hkv heads, head dim D (a
// multiple of 8 up to 512), T query tokens a head, elements of `kind`,
// `smax` rows a slot, and (K10) pages of `ps` tokens (0 for K4). A KV
// head's G * T query rows are split into ceil(G * T / 16) query splits. The
// grid: as many CTAs as the card holds at once (two an SM where the shared
// memory allows), at most kMaxCtas and one a tile of the most the slots
// can hold.
inline cudaError_t plan(int kind, int B, int Hq, int Hkv, int D, int T, int smax, int ps, Plan* pl) {
  // The grid is sized from the most tiles the slots can hold, never from
  // their lengths (or window), so a call can be captured in a CUDA graph.
  const int W = kernel_width(D);
  if (W == 0 || Hkv <= 0 || Hq % Hkv != 0 || B <= 0 || T <= 0 || smax <= 0 || kind < kKindI8 ||
      kind > kKindF32 || (kind == kKindI4T && (ps <= 0 || ps % 2 != 0)))
    return cudaErrorInvalidValue;
  const int GT = Hq / Hkv * T;
  pl->W = W;
  pl->qsplits = (GT + kMaxQRows - 1) / kMaxQRows;
  pl->qrows = GT < kMaxQRows ? GT : kMaxQRows;
  pl->NG = pl->qrows <= 8 ? 8 : 16;
  pl->vw = v_cols(W, kind);
  pl->half = kind == kKindI4D ? W / 2 : 0;
  pl->csplits = kind == kKindI4D ? W / pl->vw : (D + pl->vw - 1) / pl->vw;
  pl->ccols = kind == kKindI4D ? pl->vw : (D < pl->vw ? D : pl->vw);
  pl->segs = Hkv * pl->qsplits * pl->csplits;
  // TMA boxes of 16 rows: 16-byte row strides, and (K10) boxes inside one
  // page (int4: one half of a page). Else rows by the widest cp.async
  // their bytes allow.
  const int rb = kind == kKindI4D ? D / 2 : D * elem_bytes(kind);
  const int box_tokens = kind == kKindI4T ? 2 * kBox : kBox;
  pl->tma = rb % 16 == 0 && (ps == 0 || ps % box_tokens == 0);
  pl->chunk = rb % 16 == 0 ? 16 : rb % 8 == 0 ? 8 : 4;
  const int per_sm = smem_bytes(W, kind, pl->NG) <= kTwoPerSm ? 2 : 1;
  const long long cap = static_cast<long long>(B) * pl->segs * ((smax + kRows - 1) / kRows);
  long long ctas = static_cast<long long>(per_sm) * num_sms();
  ctas = ctas < kMaxCtas ? ctas : kMaxCtas;
  pl->ctas = static_cast<int>(ctas < cap ? ctas : cap);
  return cudaSuccess;
}

// Launches the kernel of plan `pl` and the merge. k, v: the cache or pool as
// a (rows, row bytes) matrix.
template <int W, int NG, int MODE, int KIND, bool MULTI>
cudaError_t launch(Params p, const void* k, const void* v, int rows, __nv_bfloat16* out,
                   cudaStream_t stream) {
  constexpr int E = elem_bytes(KIND);
  constexpr int kMapE = KIND == kKindBF16 ? 2 : 1;  // fp16 and fp32 rows are mapped as bytes
  using L = Layout<W, KIND, NG>;
  constexpr int kMaxDevices = 64;
  // Raise the dynamic shared-memory limit once per device (not on every
  // launch: a launch may be captured into a CUDA graph).
  static bool configured[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess && dev >= kMaxDevices) err = cudaErrorInvalidDevice;
  if (err == cudaSuccess && !configured[dev]) {
    err = cudaFuncSetAttribute(decode_attn_kernel<W, NG, MODE, KIND, MULTI>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, L::kSmem);
    configured[dev] = err == cudaSuccess;
  }
  CUtensorMap tm_k, tm_v;
  std::memset(&tm_k, 0, sizeof(tm_k));
  std::memset(&tm_v, 0, sizeof(tm_v));
  const int code = kMapE == 1 ? kI8 : kBF16;
  const int cols = KIND == kKindI4D ? p.D / 2 : p.D * E / kMapE;  // map elements of a row
  if (err == cudaSuccess && p.tma)
    err = tensor_map_2d(&tm_k, k, code, cols, rows, static_cast<size_t>(cols) * kMapE, 128 / kMapE, kBox,
                        true);
  if (err == cudaSuccess && p.tma)
    err = tensor_map_2d(&tm_v, v, code, cols, rows, static_cast<size_t>(cols) * kMapE, 128 / kMapE, kBox,
                        true);
  if (err != cudaSuccess) return err;
  p.k = static_cast<const unsigned char*>(k);
  p.v = static_cast<const unsigned char*>(v);
  decode_attn_kernel<W, NG, MODE, KIND, MULTI><<<p.ctas, kThreads, L::kSmem, stream>>>(tm_k, tm_v, p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return merge(p, out, stream);
}

// The one-token or the verify-mode kernel, by T.
template <int W, int NG, int MODE, int KIND>
cudaError_t launch_t(const Params& p, const void* k, const void* v, int rows, __nv_bfloat16* out,
                     cudaStream_t stream) {
  return p.T > 1 ? launch<W, NG, MODE, KIND, true>(p, k, v, rows, out, stream)
                 : launch<W, NG, MODE, KIND, false>(p, k, v, rows, out, stream);
}

// The kernel of `mode` and `kind` at the plan's width and query rows.
template <int MODE, int KIND>
cudaError_t run(const Plan& pl, Params p, const void* k, const void* v, int rows,
                __nv_bfloat16* out, cudaStream_t stream) {
  p.qsplits = pl.qsplits;
  p.csplits = pl.csplits;
  p.qrows = pl.qrows;
  p.ccols = pl.ccols;
  p.vw = pl.vw;
  p.ctas = pl.ctas;
  p.tma = pl.tma;
  p.chunk = pl.chunk;
  p.half = pl.half;
  const bool wide = pl.NG == 16;
  switch (pl.W) {
    case 64:
      return wide ? launch_t<64, 16, MODE, KIND>(p, k, v, rows, out, stream)
                  : launch_t<64, 8, MODE, KIND>(p, k, v, rows, out, stream);
    case 128:
      return wide ? launch_t<128, 16, MODE, KIND>(p, k, v, rows, out, stream)
                  : launch_t<128, 8, MODE, KIND>(p, k, v, rows, out, stream);
    case 256:
      return wide ? launch_t<256, 16, MODE, KIND>(p, k, v, rows, out, stream)
                  : launch_t<256, 8, MODE, KIND>(p, k, v, rows, out, stream);
    default:
      return wide ? launch_t<512, 16, MODE, KIND>(p, k, v, rows, out, stream)
                  : launch_t<512, 8, MODE, KIND>(p, k, v, rows, out, stream);
  }
}

// The instantiations, one source each so that nvcc builds them in
// parallel: the bf16, fp16 and fp32 caches of K4 and K10 (csrc/decode_attn.cu,
// decode_f16.cu, decode_f32.cu: the two kernels share them); K4's int8,
// e4m3 and int4 (csrc/decode.cu, decode_e4m3.cu, decode_int4.cu); K10's
// (csrc/paged.cu, paged_e4m3.cu, paged_int4.cu).
cudaError_t run_plain16(const Plan& pl, const Params& p, const void* k, const void* v, int rows,
                        __nv_bfloat16* out, cudaStream_t stream);
cudaError_t run_f16(const Plan& pl, const Params& p, const void* k, const void* v, int rows,
                    __nv_bfloat16* out, cudaStream_t stream);
cudaError_t run_f32(const Plan& pl, const Params& p, const void* k, const void* v, int rows,
                    __nv_bfloat16* out, cudaStream_t stream);
cudaError_t run_k4_e4m3(const Plan& pl, const Params& p, const void* k, const void* v, int rows,
                        __nv_bfloat16* out, cudaStream_t stream);
cudaError_t run_k4_int4(const Plan& pl, const Params& p, const void* k, const void* v, int rows,
                        __nv_bfloat16* out, cudaStream_t stream);
cudaError_t run_k10_e4m3(const Plan& pl, const Params& p, const void* k, const void* v, int rows,
                         __nv_bfloat16* out, cudaStream_t stream);
cudaError_t run_k10_int4(const Plan& pl, const Params& p, const void* k, const void* v, int rows,
                         __nv_bfloat16* out, cudaStream_t stream);

}  // namespace dattn
}  // namespace qa
