// pulse_update: one fused stochastic-pulse update cycle on Hopper.
//
// Replaces the TPU kernel pulse_update_pallas (src/repro/kernels/
// pulse_update.py:166, pallas_call at :191).  For signed pulse streams B
// (T, M) of the row drivers and A (T, N) of the column drivers:
//     count_up, count_dn = (|B|^T |A| +- B^T A) / 2
//     dw  = count_up * dw_up - count_dn * dw_dn
//         + ctoc * sqrt(count_up * dw_up^2 + count_dn * dw_dn^2) * xi
//     w'  = clip(w + dw, -bound, bound)
// with xi the counter-hash normal at e = row * N + col of the u32 seed
// (fastrng.normal_at(mix(seed), e, M * N)).
//
// The TPU kernel carries both f32 count tiles in VMEM across a serial T
// axis and finalizes at its last step.  Hopper blocks run in no order, so
// the count atomics of pulse_counts.cu would leave no block with the final
// count; here one block owns a 32 x 32 device tile over the whole T
// (count_range of pulse_stream.cuh: int8 streams in shared memory, int32
// counts in registers, exact) and applies maps, ctoc noise and the clip in
// the same block.  No atomics, so no second pass.  The finalize rounds each
// product and sum explicitly (no FMA contraction), as the plain PyTorch
// version's separate operations do.
//
// Bound on the H100: the bytes of the two f32 stream matrices and the five
// (M, N) tiles (w, dw_up, dw_dn, bound in; w' out); the count products are
// exact on the int8 tensor cores.  At LeNet's K2 with 13 devices per
// weight (416 x 401, T = 512) that is 5.0 MB, 1.5 us: one launch.  The
// design gives up the T split, so a small tile walks its T alone.
#include "pulse_stream.cuh"

namespace analog {

struct UpdateArgs {
  const float* w;
  const float* dw_up;
  const float* dw_dn;
  const float* bound;
  float* out;
  uint32_t seed;  // the u32 seed word
  float ctoc;
};

__global__ void __launch_bounds__(COUNT_THREADS)
    pulse_update_kernel(CountTile c, MemStreams src, UpdateArgs u) {
  __shared__ int stage[STAGE_INTS];
  const int m0 = (blockIdx.x / c.tiles_n) * CT;
  const int n0 = (blockIdx.x % c.tiles_n) * CT;
  int up[1][4], dn[1][4];
  count_range<COUNT_THREADS>(c, src, m0, n0, 0, c.T, stage, up, dn);
  const int m = m0 + CountLayout<COUNT_THREADS>::row0();
  const int nb = n0 + CountLayout<COUNT_THREADS>::col0();
  if (m >= c.M) return;
  const uint32_t n_total = (uint32_t)c.M * (uint32_t)c.N;
  const uint32_t seed_m = mix32(u.seed);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int n = nb + j;
    if (n >= c.N) continue;
    const size_t i = (size_t)m * c.N + n;
    const float cu = (float)up[0][j], cd = (float)dn[0][j];
    const float du = u.dw_up[i], dd = u.dw_dn[i];
    float dw = __fsub_rn(__fmul_rn(cu, du), __fmul_rn(cd, dd));
    if (u.ctoc > 0.0f) {
      const float var = __fadd_rn(__fmul_rn(__fmul_rn(cu, du), du),
                                  __fmul_rn(__fmul_rn(cd, dd), dd));
      const uint32_t e = (uint32_t)m * (uint32_t)c.N + (uint32_t)n;
      const float xi = normal_at(seed_m, e, n_total);
      dw = __fadd_rn(dw, __fmul_rn(__fmul_rn(u.ctoc, sqrtf(var)), xi));
    }
    const float b = u.bound[i];
    u.out[i] = fminf(fmaxf(__fadd_rn(u.w[i], dw), -b), b);
  }
}

}  // namespace analog

// w, dw_up, dw_dn, bound, out (M, N) f32; rows (T, M) and cols (T, N) f32
// in {0, +1, -1}; seed the u32 seed word.
extern "C" int pulse_update_launch(const float* w, const float* dw_up,
                                   const float* dw_dn, const float* bound,
                                   const float* rows, const float* cols,
                                   float* out, int T, int M, int N,
                                   unsigned int seed, float ctoc,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M <= 0 || N <= 0) return 0;
  const analog::CountTile c =
      analog::make_count_tile(M, N, T, nullptr, nullptr);
  const analog::UpdateArgs u{w, dw_up, dw_dn, bound, out, seed, ctoc};
  analog::pulse_update_kernel<<<c.tiles_m * c.tiles_n,
                                analog::COUNT_THREADS, 0, s>>>(
      c, analog::MemStreams{rows, cols, M, N}, u);
  return static_cast<int>(cudaGetLastError());
}
