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
#include "managed_read.cuh"

namespace analog {

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
  managed_tile_block(sm, a, DenseX(), nm, mix32(seed1), mix32(seed2),
                     two_phase, retry_scale, acc1, acc2, sat1, sat2,
                     blockIdx.y * BM, blockIdx.x * BN);
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
  analog::launch_managed_epilogue(acc1, acc2, sat1, sat2, nm, y, residual, B,
                                  out_phys, d_avg, two_phase, retry_scale, s);
  return static_cast<int>(cudaGetLastError());
}
