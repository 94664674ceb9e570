// The managed value (both two-phase BM reads of one segment sum), used by
// every managed read: #2 managed_mvm.cu, #3 conv_mvm.cu and the transpose
// read of #6/#7 bwd_update_mvm.cu, all through managed_gemm.cuh's product.
//
//     v   = W_seg x_seg / s                         (s: NM scale, per row)
//     y1  = sum_seg clip(v       + sigma * xi1, +-alpha)       (seed 1)
//     y2  = sum_seg clip(v / 16  + sigma * xi2, +-alpha)       (seed 2)
//     y   = mean_replicas( where(sat1, y2 * 16, y1) * s ),  residual = sat1&sat2
#pragma once

#include "analog_read.cuh"

namespace analog {

// Both reads of one segment sum v of (row m, column col): accumulate into
// y1/y2 and raise the flags (INLINE: see read_value).
template <bool INLINE = false>
__device__ __forceinline__ void managed_value(
    const ReadArgs& a, float v, float s, uint32_t seed1_m, uint32_t seed2_m,
    int two_phase, float retry_scale, uint32_t e, float& y1, float& y2,
    bool& f1, bool& f2) {
  const float v1 = __fdiv_rn(v, s);
  y1 = __fadd_rn(y1, read_value<INLINE>(v1, seed1_m, e, a, f1));
  if (two_phase)
    y2 = __fadd_rn(y2, read_value<INLINE>(__fdiv_rn(v1, retry_scale),
                                          seed2_m, e, a, f2));
}

}  // namespace analog
