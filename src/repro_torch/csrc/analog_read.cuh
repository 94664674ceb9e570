// Shared numbers of every analog array-read kernel: the counter-hash read
// noise, one physical read of a segment sum (read_value) and the noise
// counter.  #1 noisy_mvm.cu, #2 managed_mvm.cu and #3 conv_mvm.cu multiply
// through the product of managed_gemm.cuh; #6/#7 bwd_update_mvm.cu still
// read through the older 64 x 64 tile kept at the end of this file (with
// managed_read.cuh's managed tile block and epilogue launch).
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

// Standard normal at flat counter e (fastrng.normal-compatible).  Not
// inlined: a tile's epilogue reads up to 128 outputs per thread, and 128
// inlined copies of logf/cosf made the kernels' code too large for the
// instruction cache.
__device__ __noinline__ float normal_at(uint32_t seed_m, uint32_t e,
                                        uint32_t n_total) {
  const float u1 = fmaxf(uniform24(mix32(e ^ seed_m)), 1e-7f);
  const float u2 = uniform24(mix32((e + n_total) ^ seed_m));
  return __fmul_rn(sqrtf(__fmul_rn(-2.0f, logf(u1))),
                   cosf(__fmul_rn(6.2831855f, u2)));
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

// One physical read of a segment sum: noise, saturation flag, clip.
__device__ __forceinline__ float read_value(float v, uint32_t seed_m,
                                            uint32_t e, const ReadArgs& a,
                                            bool& sat) {
  if (a.sigma > 0.0f)
    v = __fadd_rn(v, __fmul_rn(a.sigma, normal_at(seed_m, e, a.n_total)));
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

// ---------------------------------------------------------------------------
// The older tile (#6/#7's transpose read): one block computes a 64 x 64
// tile of outputs, 4 x 4 per thread, staging 16-deep k-tiles of W and x
// through shared memory with scalar loads and no prefetch.
// ---------------------------------------------------------------------------

constexpr int BM = 64, BN = 64, BK = 16, TM = 4, TN = 4, PAD = 4;
constexpr int THREADS = 256;
constexpr int TX = BN / TN;  // threads along outputs
constexpr int OWN = TM * TN;
static_assert(TX * (BM / TM) == THREADS, "256 threads per block");

struct Smem {
  alignas(16) float ws[BK][BN + PAD];
  alignas(16) float xs[BK][BM + PAD];
};

// Stage one k-tile [kb, ke) of W (tile columns n0..n0+BN) and x (rows
// m0..m0+BM) into shared memory, zero-filling out-of-range entries.
__device__ __forceinline__ void load_tile(Smem& sm, const ReadArgs& a,
                                          int m0, int n0, int kb, int ke) {
  const int t = threadIdx.x;
  const int C = a.transpose ? a.out_dim : a.K;  // physical column count
#pragma unroll
  for (int i = 0; i < (BN * BK) / THREADS; ++i) {
    const int idx = t + i * THREADS;
    int kk, nn;
    if (a.transpose) {  // W[k, o]: outputs contiguous
      kk = idx / BN;
      nn = idx % BN;
    } else {            // W[o, k]: contraction contiguous
      nn = idx / BK;
      kk = idx % BK;
    }
    const int k = kb + kk, o = n0 + nn;
    float v = 0.0f;
    if (k < ke && o < a.out_dim)
      v = a.transpose ? a.w[(size_t)k * C + o] : a.w[(size_t)o * C + k];
    sm.ws[kk][nn] = v;
  }
#pragma unroll
  for (int i = 0; i < (BM * BK) / THREADS; ++i) {
    const int idx = t + i * THREADS;
    const int mm = idx / BK, kk = idx % BK;
    const int k = kb + kk, m = m0 + mm;
    sm.xs[kk][mm] = (k < ke && m < a.B) ? a.x[(size_t)m * a.K + k] : 0.0f;
  }
}

// The contraction of one segment [ks, ke) into this thread's 4 x 4 outputs.
__device__ __forceinline__ void segment_product(Smem& sm, const ReadArgs& a,
                                                int m0, int n0, int ks,
                                                int ke, float (&seg)[OWN]) {
  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
#pragma unroll
  for (int o = 0; o < OWN; ++o) seg[o] = 0.0f;
  for (int kb = ks; kb < ke; kb += BK) {
    __syncthreads();  // previous tile fully consumed
    load_tile(sm, a, m0, n0, kb, ke);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float xa[TM], wb[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) xa[i] = sm.xs[kk][ty * TM + i];
#pragma unroll
      for (int j = 0; j < TN; ++j) wb[j] = sm.ws[kk][tx * TN + j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j)
          seg[i * TN + j] = fmaf(xa[i], wb[j], seg[i * TN + j]);
    }
  }
}

// Tile coordinates (row, col) of the o-th output this thread owns.
__device__ __forceinline__ void owned(int o, int& mm, int& nn) {
  mm = (threadIdx.x / TX) * TM + o / TN;
  nn = (threadIdx.x % TX) * TN + o % TN;
}

}  // namespace analog
