// The managed value (both two-phase BM reads of one segment sum), used by
// every managed read: #2 managed_mvm.cu and #3 conv_mvm.cu through
// managed_gemm.cuh's product, and #6/#7 bwd_update_mvm.cu, whose transpose
// read still runs the older tile of analog_read.cuh through
// managed_tile_block below (per-row saturation flags ORed across blocks)
// and the select / rescale / #_d-average epilogue launch.
//
//     v   = W_seg x_seg / s                         (s: NM scale, per row)
//     y1  = sum_seg clip(v       + sigma * xi1, +-alpha)       (seed 1)
//     y2  = sum_seg clip(v / 16  + sigma * xi2, +-alpha)       (seed 2)
//     y   = mean_replicas( where(sat1, y2 * 16, y1) * s ),  residual = sat1&sat2
#pragma once

#include "analog_read.cuh"

namespace analog {

// Both reads of one segment sum v of (row m, column col): accumulate into
// y1/y2 and raise the flags.
__device__ __forceinline__ void managed_value(
    const ReadArgs& a, float v, float s, uint32_t seed1_m, uint32_t seed2_m,
    int two_phase, float retry_scale, uint32_t e, float& y1, float& y2,
    bool& f1, bool& f2) {
  const float v1 = __fdiv_rn(v, s);
  y1 = __fadd_rn(y1, read_value(v1, seed1_m, e, a, f1));
  if (two_phase)
    y2 = __fadd_rn(y2, read_value(__fdiv_rn(v1, retry_scale), seed2_m, e, a,
                                  f2));
}

// One 64 x 64 output tile (rows m0.., physical outputs n0..) of a managed
// read through the older tiled product: writes the acc1/acc2 partials and
// ORs the per-row flags with atomics.
__device__ __forceinline__ void managed_tile_block(
    Smem& sm, const ReadArgs& a, const float* __restrict__ nm,
    uint32_t seed1_m, uint32_t seed2_m, int two_phase, float retry_scale,
    float* __restrict__ acc1, float* __restrict__ acc2,
    int* __restrict__ sat1, int* __restrict__ sat2, int m0, int n0) {
  float seg[OWN], y1[OWN], y2[OWN];
  bool f1[OWN], f2[OWN];
#pragma unroll
  for (int o = 0; o < OWN; ++o) {
    y1[o] = 0.0f;
    y2[o] = 0.0f;
    f1[o] = false;
    f2[o] = false;
  }
  for (int si = 0; si < a.n_seg; ++si) {
    const int ks = si * a.seg_len;
    const int ke = min(a.K, ks + a.seg_len);
    segment_product(sm, a, m0, n0, ks, ke, seg);
#pragma unroll
    for (int o = 0; o < OWN; ++o) {
      int mm, nn;
      owned(o, mm, nn);
      const int m = m0 + mm, col = n0 + nn;
      if (m < a.B && col < a.out_dim)
        managed_value(a, seg[o], nm[m], seed1_m, seed2_m, two_phase,
                      retry_scale, counter(a, m, si, col), y1[o], y2[o],
                      f1[o], f2[o]);
    }
  }
#pragma unroll
  for (int o = 0; o < OWN; ++o) {
    int mm, nn;
    owned(o, mm, nn);
    const int m = m0 + mm, col = n0 + nn;
    if (m < a.B && col < a.out_dim) {
      const size_t i = (size_t)m * a.out_dim + col;
      acc1[i] = y1[o];
      if (two_phase) acc2[i] = y2[o];
      if (f1[o]) atomicOr(&sat1[m], 1);
      if (f2[o]) atomicOr(&sat2[m], 1);
    }
  }
}

// select_and_average: one thread per (row, logical output); residual flag
// written by column 0.
__global__ void managed_epilogue_kernel(
    const float* __restrict__ acc1, const float* __restrict__ acc2,
    const int* __restrict__ sat1, const int* __restrict__ sat2,
    const float* __restrict__ nm, float* __restrict__ y,
    int* __restrict__ residual, int B, int out_f, int d_avg, int two_phase,
    float retry_scale) {
  const size_t n = (size_t)B * out_f;
  for (size_t idx = blockIdx.x * (size_t)blockDim.x + threadIdx.x; idx < n;
       idx += (size_t)gridDim.x * blockDim.x) {
    const int b = (int)(idx / out_f), j = (int)(idx % out_f);
    const bool sel = two_phase && sat1[b] != 0;
    const float s = nm[b];
    const size_t row = (size_t)b * d_avg * out_f;
    float acc = 0.0f;
    for (int r = 0; r < d_avg; ++r) {
      const size_t i = row + (size_t)r * out_f + j;
      const float v = sel ? __fmul_rn(__fmul_rn(acc2[i], retry_scale), s)
                          : __fmul_rn(acc1[i], s);
      acc = (r == 0) ? v : __fadd_rn(acc, v);
    }
    y[idx] = d_avg > 1 ? __fdiv_rn(acc, (float)d_avg) : acc;
    if (j == 0)
      residual[b] = two_phase ? (sat1[b] != 0 && sat2[b] != 0)
                              : (sat1[b] != 0);
  }
}

// Launch the epilogue over (B, out_phys / d_avg) outputs.
inline void launch_managed_epilogue(const float* acc1, const float* acc2,
                                    const int* sat1, const int* sat2,
                                    const float* nm, float* y, int* residual,
                                    int B, int out_phys, int d_avg,
                                    int two_phase, float retry_scale,
                                    cudaStream_t s) {
  const int out_f = out_phys / d_avg;
  const size_t n = (size_t)B * out_f;
  const int threads = 256;
  const size_t want = (n + threads - 1) / threads;
  const int blocks = want < 4096 ? (want > 0 ? (int)want : 1) : 4096;
  managed_epilogue_kernel<<<blocks, threads, 0, s>>>(
      acc1, acc2, sat1, sat2, nm, y, residual, B, out_f, d_avg, two_phase,
      retry_scale);
}

}  // namespace analog
