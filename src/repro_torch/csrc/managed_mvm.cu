// managed_mvm: the fused managed analog read on Hopper.
//
// Replaces the TPU kernel managed_mvm_pallas (src/repro/kernels/managed_mvm.py,
// pallas_call at :284):
//     v   = W_seg x_seg / s                         (s: NM scale, per row)
//     y1  = sum_seg clip(v       + sigma * xi1, +-alpha)       (seed 1)
//     y2  = sum_seg clip(v / 16  + sigma * xi2, +-alpha)       (seed 2)
//     y   = mean_replicas( where(sat1, y2 * 16, y1) * s ),  residual = sat1&sat2
// Both reads come from ONE product (the digital scale commutes with the
// matmul), at the same noise counter with their own seeds.
//
// The TPU kernel keeps the whole replica-padded output row in one VMEM block
// so that one per-row flag gates the select.  At out = 11008 or 102400 three
// such f32 rows per batch row do not fit Hopper's 227 KB of shared memory,
// so here the read is two launches: the main kernel tiles (row-block,
// out-block) like noisy_mvm, writes the acc1/acc2 partials to global memory
// and ORs the per-row sat1/sat2 flags across blocks with atomics; a small
// epilogue launch then selects, rescales, averages the #_d replicas and
// writes the residual flag.
//
// Bound on the H100: as noisy_mvm (bytes of W at decode through the
// warp-per-column path, fp32 FMAs at prefill through the tiled path); the
// partials add 2 * B * out * 4 bytes of writes and reads, small against W at
// every shape of the serving path.
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

// Decode reads: one warp per output column (see analog_read.cuh).
__global__ void __launch_bounds__(THREADS)
    managed_gemv_kernel(ReadArgs a, const float* __restrict__ nm,
                        uint32_t seed1, uint32_t seed2, int two_phase,
                        float retry_scale, float* __restrict__ acc1,
                        float* __restrict__ acc2, int* __restrict__ sat1,
                        int* __restrict__ sat2) {
  const int lane = threadIdx.x & 31;
  const int o = blockIdx.x * GEMV_WARPS + (threadIdx.x >> 5);
  if (o >= a.out_dim) return;  // warp-uniform
  const uint32_t seed1_m = mix32(seed1), seed2_m = mix32(seed2);
  const float s = lane < a.B ? nm[lane] : 1.0f;
  float y1 = 0.0f, y2 = 0.0f;
  bool f1 = false, f2 = false;
  for (int si = 0; si < a.n_seg; ++si) {
    const int ks = si * a.seg_len;
    const int ke = min(a.K, ks + a.seg_len);
    const float v = gemv_segment(a, o, ks, ke, lane);
    if (lane < a.B)
      managed_value(a, v, s, seed1_m, seed2_m, two_phase, retry_scale,
                    counter(a, lane, si, o), y1, y2, f1, f2);
  }
  if (lane < a.B) {
    const size_t i = (size_t)lane * a.out_dim + o;
    acc1[i] = y1;
    if (two_phase) acc2[i] = y2;
    if (f1) atomicOr(&sat1[lane], 1);
    if (f2) atomicOr(&sat2[lane], 1);
  }
}

// Prefill and transposed reads: 64 x 64 output tiles.
__global__ void __launch_bounds__(THREADS)
    managed_tile_kernel(ReadArgs a, const float* __restrict__ nm,
                        uint32_t seed1, uint32_t seed2, int two_phase,
                        float retry_scale, float* __restrict__ acc1,
                        float* __restrict__ acc2, int* __restrict__ sat1,
                        int* __restrict__ sat2) {
  __shared__ Smem sm;
  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;
  const uint32_t seed1_m = mix32(seed1), seed2_m = mix32(seed2);

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

// select_and_average of the shared managed-read body: one thread per
// (row, logical output); residual flag written by column 0.
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

}  // namespace analog

// Outputs: y (B, out_f) f32 and residual (B,) int32.  Scratch: acc1/acc2
// (B, out_phys) f32 and sat1/sat2 (B,) int32, the flags zeroed by the caller
// (acc2 may alias acc1 when two_phase is 0).
extern "C" int managed_mvm_launch(
    const float* w, const float* x, const float* nm, float* y, int* residual,
    float* acc1, float* acc2, int* sat1, int* sat2, int B, int K,
    int out_phys, int d_avg, int n_seg, int seg_len, int transpose,
    float sigma, float alpha, int has_alpha, unsigned seed1, unsigned seed2,
    int two_phase, float retry_scale, unsigned row_offset, unsigned n_total,
    void* stream) {
  analog::ReadArgs a{w,     x,         B,     K,     out_phys,   n_seg,
                     seg_len, transpose, sigma, alpha, has_alpha,
                     row_offset, n_total};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!transpose && B <= analog::GEMV_MAXB) {
    const int blocks =
        (out_phys + analog::GEMV_WARPS - 1) / analog::GEMV_WARPS;
    analog::managed_gemv_kernel<<<blocks, analog::THREADS, 0, s>>>(
        a, nm, seed1, seed2, two_phase, retry_scale, acc1, acc2, sat1, sat2);
  } else {
    dim3 grid((out_phys + analog::BN - 1) / analog::BN,
              (B + analog::BM - 1) / analog::BM);
    analog::managed_tile_kernel<<<grid, analog::THREADS, 0, s>>>(
        a, nm, seed1, seed2, two_phase, retry_scale, acc1, acc2, sat1, sat2);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int out_f = out_phys / d_avg;
  const size_t n = (size_t)B * out_f;
  const int threads = 256;
  const int blocks = (int)((n + threads - 1) / threads < 4096
                               ? (n + threads - 1) / threads
                               : 4096);
  analog::managed_epilogue_kernel<<<blocks > 0 ? blocks : 1, threads, 0, s>>>(
      acc1, acc2, sat1, sat2, nm, y, residual, B, out_f, d_avg, two_phase,
      retry_scale);
  return static_cast<int>(cudaGetLastError());
}
