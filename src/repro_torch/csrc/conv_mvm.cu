// conv_mvm: the implicit-im2col managed conv read on Hopper.
//
// Replaces the TPU kernel conv_managed_mvm_pallas (src/repro/kernels/
// conv_mvm.py:157, pallas_call at :198): the forward read of a conv layer's
// crossbar, y[pos] = managed_read(W, patch[pos]) for every output position
// of every image, with NM scale, two-phase BM, clip and the #_d replica
// average (managed_read.cuh).
//
// The TPU kernel pulls one image into VMEM, assembles its patch tile from
// kh*kw strided tap slices and contracts it against a tap-major copy of W.
// Here the 64 x 64 tiled read of analog_read.cuh runs over the flattened
// position axis (img * OH*OW + pos) with a loader that builds each patch
// element by index from xpad while staging the k-tile in shared memory
// (conv_patch.cuh), so the patch matrix never exists in device memory, and
// W is read in its channel-major layout directly (no tap-major copy: the
// layout was a TPU choice, and the noise counters do not depend on it).
// Noise counters are (img * P + pos) * out_phys + o, n_total = B*P*out_phys:
// those of the materialized column matrix read by managed_mvm.
//
// Bound on the H100: at LeNet's shapes the work is tiny (K1: 4608 x 26 x 16,
// K2: 512 x 401 x 32 or x 416 FMAs per read, 0.06-0.3 us of fp32 FMA or of
// bytes), so the two launches (main + epilogue, about 3 us each) bound it;
// the design keeps the per-element index arithmetic in the k-tile staging,
// off the FMA loop.
#include "conv_patch.cuh"
#include "managed_read.cuh"

namespace analog {

__global__ void __launch_bounds__(THREADS)
    conv_managed_kernel(ReadArgs a, ConvGeomDev g, const float* __restrict__ nm,
                        uint32_t seed1, uint32_t seed2, int two_phase,
                        float retry_scale, float* __restrict__ acc1,
                        float* __restrict__ acc2, int* __restrict__ sat1,
                        int* __restrict__ sat2) {
  __shared__ Smem sm;
  managed_tile_block(sm, a, ConvX{g}, nm, mix32(seed1), mix32(seed2),
                     two_phase, retry_scale, acc1, acc2, sat1, sat2,
                     blockIdx.y * BM, blockIdx.x * BN);
}

}  // namespace analog

// w (out_phys, cols) channel-major, xpad (B, H, W, C), geom (host ints: B,
// H, W, C, kh, kw, sh, sw, dh, dw, oh, ow, bias), nm (P,) with P = B*OH*OW.
// Outputs: y (P, out_phys / d_avg) f32, residual (P,) int32.  Scratch:
// acc1/acc2 (P, out_phys) f32 (acc2 may alias acc1 when two_phase is 0) and
// sat1/sat2 (P,) int32, zeroed here.
extern "C" int conv_managed_mvm_launch(
    const float* w, const float* xpad, const int* geom, const float* nm,
    float* y, int* residual, float* acc1, float* acc2, int* sat1, int* sat2,
    int out_phys, int d_avg, float sigma, float alpha, int has_alpha,
    unsigned seed1, unsigned seed2, int two_phase, float retry_scale,
    void* stream) {
  const int P = analog::conv_positions(geom);
  const int cols = analog::conv_cols(geom);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaMemsetAsync(sat1, 0, sizeof(int) * (size_t)P, s);
  cudaMemsetAsync(sat2, 0, sizeof(int) * (size_t)P, s);
  analog::ReadArgs a{w,    nullptr,   P,     cols,  out_phys,
                     1,    cols,      0,     sigma, alpha,
                     has_alpha, 0u, (uint32_t)P * (uint32_t)out_phys};
  dim3 grid((out_phys + analog::BN - 1) / analog::BN,
            (P + analog::BM - 1) / analog::BM);
  analog::conv_managed_kernel<<<grid, analog::THREADS, 0, s>>>(
      a, analog::conv_geom(xpad, geom), nm, seed1, seed2, two_phase,
      retry_scale, acc1, acc2, sat1, sat2);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  analog::launch_managed_epilogue(acc1, acc2, sat1, sat2, nm, y, residual, P,
                                  out_phys, d_avg, two_phase, retry_scale, s);
  return static_cast<int>(cudaGetLastError());
}
