// managed_mvm: the fused managed analog read on Hopper (kernel #2).
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
// so that one per-row flag gates the select.  Here the per-row flags are
// ORed across blocks with atomics into a scratch per device and stream, and
// the select waits for every block (managed_gemm.cuh):
//   Decode (forward, B <= 8): ONE cooperative launch.  The gemv streams W
//     with float4 loads (x through L1), meets at a grid-wide barrier once
//     every flag is raised, then every block runs its share of the select /
//     rescale / #_d average and the last one clears the flags.  Bound: the
//     bytes of W (2 B flops per 4 bytes).
//   Prefill and transposed reads: a SIMT SGEMM (128x128 or 64x128 tiles,
//     8x8 outputs per thread, 16-deep k-tiles through a 3-stage cp.async
//     ring, IEEE FMAs, no TF32; one block per tile and contraction
//     segment) writes both reads of each segment, then a grid-stride
//     epilogue launch sums the segments in order, selects and clears the
//     flags (the select of a row needs every column block).  Bound: fp32
//     FMAs at 67 TFLOP/s.
// Residual is written as bytes (0 or 1) that the wrapper views as bool.
#include "managed_gemm.cuh"

namespace {

using analog::ReadArgs;
using analog::Seed;
namespace g = analog::gemm;

template <int BM, int BN, bool VEC, bool TRANS>
int launch_tile(const ReadArgs& a, const float* nm, Seed seed1, Seed seed2,
                int two_phase, float retry_scale, float* acc1,
                float* acc2, int* sat1, int* sat2, cudaStream_t s) {
  using T = g::Tile<BM, BN, VEC, TRANS>;
  auto kern = g::tile_kernel<BM, BN, VEC, TRANS>;
  const cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)T::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.out_dim + BN - 1) / BN, (a.B + BM - 1) / BM, a.n_seg);
  kern<<<grid, T::THREADS, T::SMEM, s>>>(a, nm, seed1, seed2, two_phase,
                                         retry_scale, acc1, acc2, sat1, sat2);
  return static_cast<int>(cudaGetLastError());
}

template <int BM, int BN>
int launch_tile_v(const ReadArgs& a, int vec, const float* nm, Seed s1,
                  Seed s2, int tp, float rs, float* acc1, float* acc2,
                  int* sat1, int* sat2, cudaStream_t s) {
  if (vec)
    return a.transpose ? launch_tile<BM, BN, true, true>(
                             a, nm, s1, s2, tp, rs, acc1, acc2, sat1, sat2, s)
                       : launch_tile<BM, BN, true, false>(
                             a, nm, s1, s2, tp, rs, acc1, acc2, sat1, sat2, s);
  return a.transpose ? launch_tile<BM, BN, false, true>(
                           a, nm, s1, s2, tp, rs, acc1, acc2, sat1, sat2, s)
                     : launch_tile<BM, BN, false, false>(
                           a, nm, s1, s2, tp, rs, acc1, acc2, sat1, sat2, s);
}

template <int NCW, bool VEC>
int launch_gemv(ReadArgs a, const float* nm, Seed s1, Seed s2, int tp,
                float rs, float* acc1, float* acc2, int* sat1, int* sat2,
                int* ticket, float* y, uint8_t* residual, int d_avg,
                cudaStream_t s) {
  const void* kern = reinterpret_cast<const void*>(g::gemv_kernel<NCW, VEC>);
  // all of the SM's L1 for x (the kernel takes no shared memory)
  static const cudaError_t carve = cudaFuncSetAttribute(
      kern, cudaFuncAttributePreferredSharedMemoryCarveout, 0);
  if (carve != cudaSuccess) return static_cast<int>(carve);
  static const int fit = g::resident_blocks(kern);  // per instantiation
  if (fit <= 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int want = (a.out_dim + g::GW * NCW - 1) / (g::GW * NCW);
  const int blocks = want < fit ? want : fit;
  void* args[] = {&a,    &nm,   &s1,   &s2,     &tp, &rs,       &acc1,
                  &acc2, &sat1, &sat2, &ticket, &y,  &residual, &d_avg};
  return static_cast<int>(cudaLaunchCooperativeKernel(
      kern, dim3(blocks), dim3(g::GW * 32), args, 0, s));
}

template <int NCW>
int launch_gemv_v(const ReadArgs& a, int vec, const float* nm, Seed s1,
                  Seed s2, int tp, float rs, float* acc1, float* acc2,
                  int* sat1, int* sat2, int* ticket, float* y,
                  uint8_t* residual, int d_avg, cudaStream_t s) {
  return vec ? launch_gemv<NCW, true>(a, nm, s1, s2, tp, rs, acc1, acc2, sat1,
                                      sat2, ticket, y, residual, d_avg, s)
             : launch_gemv<NCW, false>(a, nm, s1, s2, tp, rs, acc1, acc2,
                                       sat1, sat2, ticket, y, residual, d_avg,
                                       s);
}

}  // namespace

// Outputs: y (B, out_phys / d_avg) f32 and residual (B,) bytes.  acc1/acc2:
// f32 partials, (B, out_phys) for the gemv and (n_seg, B, out_phys) for the
// tiles (acc2 may alias acc1 when two_phase is 0).
// scratch: int32 [ticket, 3 unused, sat1[cap], sat2[cap]], zero on entry and
// left zero on return; cap >= B.  The plan (path 0: gemv with ncw outputs per
// warp; path 1: tile_m x tile_n tiles; vec: 16-byte aligned rows of x and W)
// comes from the wrapper's plan(); shapes it does not allow are refused.
// seed1_at/seed2_at: the read seeds in device memory (a key schedule's seed
// table, read when the kernel runs, so a captured launch follows it); null:
// seed1/seed2 by value.
extern "C" int managed_mvm_launch(
    const float* w, const float* x, const float* nm, float* y,
    uint8_t* residual, float* acc1, float* acc2, int* scratch, int cap,
    int B, int K, int out_phys, int d_avg, int n_seg, int seg_len,
    int transpose, float sigma, float alpha, int has_alpha, unsigned seed1,
    unsigned seed2, int two_phase, float retry_scale, unsigned row_offset,
    unsigned n_total, int path, int tile_m, int tile_n, int ncw, int vec,
    const unsigned long long* seed1_at, const unsigned long long* seed2_at,
    void* stream) {
  if (B <= 0) return 0;
  if (cap < B || d_avg <= 0 || out_phys % d_avg != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const ReadArgs a{w,     x,         B,     K,     out_phys,   n_seg,
                   seg_len, transpose, sigma, alpha, has_alpha,
                   row_offset, n_total};
  const Seed s1{seed1, seed1_at}, s2{seed2, seed2_at};
  int* ticket = scratch;
  int* sat1 = scratch + 4;
  int* sat2 = scratch + 4 + cap;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (path == 0) {
    if (transpose || B > g::GEMV_MAXB)
      return static_cast<int>(cudaErrorInvalidValue);
    switch (ncw) {
      case 1:
        return launch_gemv_v<1>(a, vec, nm, s1, s2, two_phase,
                              retry_scale, acc1, acc2, sat1, sat2, ticket, y,
                              residual, d_avg, s);
      case 2:
        return launch_gemv_v<2>(a, vec, nm, s1, s2, two_phase,
                              retry_scale, acc1, acc2, sat1, sat2, ticket, y,
                              residual, d_avg, s);
    }
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int err;
  if (tile_m == 128 && tile_n == 128)
    err = launch_tile_v<128, 128>(a, vec, nm, s1, s2, two_phase,
                                  retry_scale, acc1, acc2, sat1, sat2, s);
  else if (tile_m == 64 && tile_n == 128)
    err = launch_tile_v<64, 128>(a, vec, nm, s1, s2, two_phase,
                                 retry_scale, acc1, acc2, sat1, sat2, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  if (err != 0) return err;
  const int out_f = out_phys / d_avg;
  const size_t want = ((size_t)B * out_f + 255) / 256;
  const int blocks = want < 4096 ? (want > 0 ? (int)want : 1) : 4096;
  g::finish_kernel<<<blocks, 256, 0, s>>>(acc1, acc2, sat1, sat2, nm, y,
                                          residual, B, out_f, d_avg, two_phase,
                                          retry_scale, ticket, n_seg);
  return static_cast<int>(cudaGetLastError());
}
