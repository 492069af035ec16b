// K1's C entry and its default tile configuration (the kernel is in
// flash_fwd.cuh; configuration 1, two consumer warpgroups, in
// flash_fwd_q2.cu, which nvcc builds beside this file).
#include "flash_fwd.cuh"

// score_scale = sm_scale * log2(e). Tensors are contiguous (B, H, S, D) and
// 16-byte aligned; q and k of one element code, v bf16, fp16, e4m3 or int8
// (int8 with scale_v only), out
// bf16, fp16 or fp32. q_offset, kv_offset >= 0: the global positions of q's
// and k's row 0 (the causal mask is q_offset + i >= kv_offset + j). left,
// right: the window's extents (query position p sees keys at
// [p - left, p + right]), 1 << 30 for an unbounded side; the causal mask
// ignores right. m_out / l_out: (B, Hq, Sq) fp32
// residuals, or both null. D is a multiple of 8 up to 512, and of 16 for
// 8-bit Q/K (a tensor map's row stride is a multiple of 16 bytes). tiles:
// the tile configuration (Cfg's V), 0 the default, 1 at D <= 128 only.
// The modes, each null when off, and only in configuration 0: scale_v, the
// int8 V's (B, Hkv, D) fp32 scales; q_seg / kv_seg, (B, Sq) / (B, Skv)
// int32 segment ids, both or neither; tile_count (ceil(Sq / kBM)) and
// tile_list (ceil(Sq / kBM), list_stride) int32, each Q block's KV tiles
// under a block mask (ops/flash.block_table at Cfg's kBM and kBN), with
// granules (ceil(Sq / 128), granule_cols) uint8, the block mask's bitmap.
extern "C" int qa_flash_fwd(const void* q, const void* k, const void* v,
                            const void* scale_q, const void* scale_k, void* out,
                            int B, int Hq, int Hkv, int Sq, int Skv, int D,
                            int q_code, int k_code, int v_code, int out_code,
                            int scaling, int causal, float score_scale,
                            int q_offset, int kv_offset, int left, int right, void* m_out,
                            void* l_out, int tiles, const void* scale_v, const void* q_seg,
                            const void* kv_seg, const void* tile_count, const void* tile_list,
                            int list_stride, const void* granules, int granule_cols,
                            void* stream) {
  if (Sq == 0 || B == 0) return 0;
  const bool qk8 = q_code == qa::kE4M3 || q_code == qa::kI8;
  const bool mask = tile_list != nullptr;
  const bool modes = scale_v != nullptr || q_seg != nullptr || mask;
  if (q_offset < 0 || kv_offset < 0 || Skv <= 0 || q_code != k_code || q_code < qa::kBF16 ||
      q_code > qa::kI8 || v_code < qa::kBF16 || v_code > qa::kI8 ||
      (v_code == qa::kI8) != (scale_v != nullptr) ||
      (out_code != qa::kBF16 && out_code != qa::kF16 && out_code != qa::kF32) ||
      (qk8 && D % 16 != 0) || tiles < 0 || tiles > 1 || (tiles == 1 && (D > 128 || modes)) ||
      (q_seg == nullptr) != (kv_seg == nullptr) || mask != (tile_count != nullptr) ||
      mask != (granules != nullptr) || (mask && (list_stride <= 0 || granule_cols <= 0))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  using qa::k1::launch_w;
  const qa::k1::Args a{q, k, v, static_cast<const float*>(scale_q), static_cast<const float*>(scale_k),
               out, B, Hq, Hkv, Sq, Skv, D, v_code, out_code, scaling, causal, score_scale,
               q_offset, kv_offset, left, right, static_cast<float*>(m_out),
               static_cast<float*>(l_out), static_cast<const float*>(scale_v),
               static_cast<const int*>(q_seg), static_cast<const int*>(kv_seg),
               static_cast<const int*>(tile_count), static_cast<const int*>(tile_list),
               list_stride, static_cast<const unsigned char*>(granules), granule_cols,
               static_cast<cudaStream_t>(stream)};
  if (modes) return qa::k1::launch_modes(qa::kernel_width(D), q_code, a);
  if (tiles == 1) return qa::k1::launch_q2(qa::kernel_width(D), q_code, a);
  switch (qa::kernel_width(D)) {
    case 64:
      return launch_w<64, 0>(q_code, a);
    case 128:
      return launch_w<128, 0>(q_code, a);
    case 256:
      return launch_w<256, 0>(q_code, a);
    case 512:
      return launch_w<512, 0>(q_code, a);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Shared-memory bytes of K1's tile configuration `tiles` at width W and
// Q/K element code QK (ops/flash.k1_smem_bytes mirrors it), 0 where the
// configuration does not exist.
extern "C" int qa_flash_fwd_smem(int W, int QK, int tiles) {
  if (QK < qa::kBF16 || QK > qa::kI8) return 0;
  if (tiles == 1) return qa::k1::smem_q2(W, QK);
  if (tiles != 0) return 0;
  switch (W) {
    case 64:
      return qa::k1::smem_w<64, 0>(QK);
    case 128:
      return qa::k1::smem_w<128, 0>(QK);
    case 256:
      return qa::k1::smem_w<256, 0>(QK);
    case 512:
      return qa::k1::smem_w<512, 0>(QK);
    default:
      return 0;
  }
}
