// noisy_mvm: the raw analog array read on Hopper.
//
// Replaces the TPU kernel noisy_mvm_pallas (src/repro/kernels/noisy_mvm.py,
// pallas_call at :197):
//     y = sum_seg clip(W_seg x_seg + sigma * xi, +-alpha),  sat[b] = any clip
// forward or transpose, with contraction splits, the streaming row offset
// and the u32 wrap of the noise counters.
//
// Bound on the H100: at decode (B <= 8) the read moves all of W once and does
// 2*B flops per weight, far below the 67 TFLOP/s fp32 / 3.35 TB/s balance, so
// it is bound by the bytes of W: the warp-per-column path reads W exactly
// once with coalesced loads and no barrier; the noise is generated in
// registers, so y (B x out) is the only other traffic.  At prefill (B = 128)
// it is bound by fp32 FMA throughput: the tiled path uses 4x4 register
// tiles over 64x64 output blocks.  The saturation flag is ORed into a (B,) int32 with
// atomicOr, which replaces the TPU kernel's per-(row, out-block) map.
#include "analog_read.cuh"

namespace analog {

// Decode reads: one warp per output column (see analog_read.cuh).
__global__ void __launch_bounds__(THREADS)
    noisy_gemv_kernel(ReadArgs a, uint32_t seed, float* __restrict__ y,
                      int* __restrict__ sat) {
  const int lane = threadIdx.x & 31;
  const int o = blockIdx.x * GEMV_WARPS + (threadIdx.x >> 5);
  if (o >= a.out_dim) return;  // warp-uniform
  const uint32_t seed_m = mix32(seed);
  float out = 0.0f;
  bool flag = false;
  for (int si = 0; si < a.n_seg; ++si) {
    const int ks = si * a.seg_len;
    const int ke = min(a.K, ks + a.seg_len);
    const float v = gemv_segment(a, o, ks, ke, lane);
    if (lane < a.B)
      out = __fadd_rn(out, read_value(v, seed_m, counter(a, lane, si, o), a,
                                      flag));
  }
  if (lane < a.B) {
    y[(size_t)lane * a.out_dim + o] = out;
    if (flag) atomicOr(&sat[lane], 1);
  }
}

// Prefill and transposed reads: 64 x 64 output tiles.
__global__ void __launch_bounds__(THREADS)
    noisy_tile_kernel(ReadArgs a, uint32_t seed, float* __restrict__ y,
                      int* __restrict__ sat) {
  __shared__ Smem sm;
  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;
  const uint32_t seed_m = mix32(seed);

  float seg[OWN], out[OWN];
  bool flag[OWN];
#pragma unroll
  for (int o = 0; o < OWN; ++o) {
    out[o] = 0.0f;
    flag[o] = false;
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
        out[o] = __fadd_rn(
            out[o], read_value(seg[o], seed_m, counter(a, m, si, col), a,
                               flag[o]));
    }
  }
#pragma unroll
  for (int o = 0; o < OWN; ++o) {
    int mm, nn;
    owned(o, mm, nn);
    const int m = m0 + mm, col = n0 + nn;
    if (m < a.B && col < a.out_dim) {
      y[(size_t)m * a.out_dim + col] = out[o];
      if (flag[o]) atomicOr(&sat[m], 1);
    }
  }
}

}  // namespace analog

// y (B, out_dim) f32 and sat (B,) int32 (zeroed by the caller) are outputs.
extern "C" int noisy_mvm_launch(const float* w, const float* x, float* y,
                                int* sat, int B, int K, int out_dim,
                                int n_seg, int seg_len, int transpose,
                                float sigma, float alpha, int has_alpha,
                                unsigned seed, unsigned row_offset,
                                unsigned n_total, void* stream) {
  analog::ReadArgs a{w,     x,         B,     K,     out_dim,    n_seg,
                     seg_len, transpose, sigma, alpha, has_alpha,
                     row_offset, n_total};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!transpose && B <= analog::GEMV_MAXB) {
    const int blocks = (out_dim + analog::GEMV_WARPS - 1) / analog::GEMV_WARPS;
    analog::noisy_gemv_kernel<<<blocks, analog::THREADS, 0, s>>>(a, seed, y,
                                                                  sat);
  } else {
    dim3 grid((out_dim + analog::BN - 1) / analog::BN,
              (B + analog::BM - 1) / analog::BM);
    analog::noisy_tile_kernel<<<grid, analog::THREADS, 0, s>>>(a, seed, y,
                                                                sat);
  }
  return static_cast<int>(cudaGetLastError());
}
