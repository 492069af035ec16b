// K1 with its modes (csrc/flash_fwd.cuh, flash_fwd_modes_kernel): segment
// ids, a block mask's tile lists and an int8 V, in tile configuration 0 at
// every width and Q/K type. In a source of its own so that nvcc builds it
// beside flash_fwd.cu; qa_flash_fwd launches it when any mode is given.
#include "flash_fwd.cuh"

namespace qa {
namespace k1 {

int launch_modes(int W, int qk_code, const Args& a) {
  switch (W) {
    case 64:
      return launch_w<64, 0, true>(qk_code, a);
    case 128:
      return launch_w<128, 0, true>(qk_code, a);
    case 256:
      return launch_w<256, 0, true>(qk_code, a);
    case 512:
      return launch_w<512, 0, true>(qk_code, a);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace k1
}  // namespace qa
