// K1's tile configuration 1 (csrc/flash_fwd.cuh, Cfg's V = 1): two consumer
// warpgroups, 128 Q rows a CTA, KV tiles of 128 rows, at widths 64 and 128
// for every Q/K type. In a source of its own so that nvcc builds it beside
// flash_fwd.cu. The autotuner (autotune.py) times it against the default
// configuration for a shape class; nothing runs it otherwise.
#include "flash_fwd.cuh"

namespace qa {
namespace k1 {

int launch_q2(int W, int qk_code, const Args& a) {
  switch (W) {
    case 64:
      return launch_w<64, 1>(qk_code, a);
    case 128:
      return launch_w<128, 1>(qk_code, a);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

int smem_q2(int W, int qk_code) {
  switch (W) {
    case 64:
      return smem_w<64, 1>(qk_code);
    case 128:
      return smem_w<128, 1>(qk_code);
    default:
      return 0;
  }
}

}  // namespace k1
}  // namespace qa
