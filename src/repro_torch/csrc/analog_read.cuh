// Shared numbers of every analog array-read kernel: the counter-hash read
// noise, one physical read of a segment sum (read_value) and the noise
// counter.  Every read (#1 noisy_mvm.cu, #2 managed_mvm.cu, #3 conv_mvm.cu
// and the transpose read of #6/#7 bwd_update_mvm.cu) multiplies through
// the product of managed_gemm.cuh.
//
// A physical array read
//     y = sum_seg clip(W_seg x_seg + sigma * xi, +-alpha)
// adds, at each contraction-segment boundary (the 4096-column physical array
// limit), the segment sum's read noise, saturation flag and integrator clip
// before the digital sum over segments.  Products are fp32 FMAs on the CUDA
// cores (no TF32, no tensor cores).
//
// Noise: splitmix32 counter hash + Box-Muller with logf/cosf/sqrtf (no fast
// math), at the reference counter e = (row * n_seg + seg) * out + col in u32
// arithmetic (row includes the streaming row offset), u2 at e + n_total —
// the same numbers as repro_torch.utils.fastrng.normal_at.  The noise add,
// the managed-read scales and the clip use explicitly rounded intrinsics so
// the compiler cannot contract them into FMAs: they round exactly as the
// plain PyTorch versions do.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace analog {

__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x += 0x9E3779B9u;
  x = (x ^ (x >> 16)) * 0x21F0AAADu;
  x = (x ^ (x >> 15)) * 0x735A2D97u;
  return x ^ (x >> 15);
}

__device__ __forceinline__ float uniform24(uint32_t b) {
  return __fmul_rn((float)(b >> 8), 5.9604644775390625e-08f);  // 2^-24
}

// Standard normal at flat counter e (fastrng.normal-compatible).
__device__ __forceinline__ float normal_value(uint32_t seed_m, uint32_t e,
                                              uint32_t n_total) {
  const float u1 = fmaxf(uniform24(mix32(e ^ seed_m)), 1e-7f);
  const float u2 = uniform24(mix32((e + n_total) ^ seed_m));
  return __fmul_rn(sqrtf(__fmul_rn(-2.0f, logf(u1))),
                   cosf(__fmul_rn(6.2831855f, u2)));
}

// The same, not inlined: a tile's epilogue reads up to 128 outputs per
// thread, and 128 inlined copies of logf/cosf made the kernels' code too
// large for the instruction cache.  A loop over one output at a time
// inlines normal_value instead, so its draws overlap.
__device__ __noinline__ float normal_at(uint32_t seed_m, uint32_t e,
                                        uint32_t n_total) {
  return normal_value(seed_m, e, n_total);
}

struct ReadArgs {
  const float* w;      // (R, C) physical weights, row-major
  const float* x;      // (B, K) inputs
  int B, K, out_dim;   // K = C (forward) or R (transpose)
  int n_seg, seg_len;  // contraction segments of seg_len (last may be short)
  int transpose;       // 1: contraction over W's rows
  float sigma, alpha;
  int has_alpha;       // alpha finite
  uint32_t row_offset, n_total;
};

// A u32 seed word: the value ``v``, or, when ``at`` is set, the word a key
// schedule (key_schedule.cu) left in device memory (zero-extended in a
// 64-bit entry), read when the kernel runs, so that a captured launch
// follows the table.
struct Seed {
  uint32_t v;
  const unsigned long long* at;
  __device__ __forceinline__ uint32_t mixed() const {
    return mix32(at ? static_cast<uint32_t>(*at) : v);
  }
};

// One physical read of a segment sum: noise, saturation flag, clip
// (INLINE: the noise through normal_value, else normal_at).
template <bool INLINE = false>
__device__ __forceinline__ float read_value(float v, uint32_t seed_m,
                                            uint32_t e, const ReadArgs& a,
                                            bool& sat) {
  if (a.sigma > 0.0f) {
    const float xi = INLINE ? normal_value(seed_m, e, a.n_total)
                            : normal_at(seed_m, e, a.n_total);
    v = __fadd_rn(v, __fmul_rn(a.sigma, xi));
  }
  if (a.has_alpha) {
    if (fabsf(v) >= a.alpha) sat = true;
    v = fminf(fmaxf(v, -a.alpha), a.alpha);
  }
  return v;
}

// Flat noise counter of (batch row m, segment si, output col) — u32 wrap.
__device__ __forceinline__ uint32_t counter(const ReadArgs& a, int m, int si,
                                            int col) {
  const uint32_t row = a.row_offset + (uint32_t)m;
  return (row * (uint32_t)a.n_seg + (uint32_t)si) * (uint32_t)a.out_dim +
         (uint32_t)col;
}

}  // namespace analog
