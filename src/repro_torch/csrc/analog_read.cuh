// Shared body of the analog array-read kernels #1 noisy_mvm.cu and, through
// managed_read.cuh, #3 conv_mvm.cu and #6/#7 bwd_update_mvm.cu.  Kernel #2
// managed_mvm.cu has its own product (managed_gemm.cuh: 8x8 register tiles
// with float4 loads prefetched a k-tile ahead, and a one-launch decode
// gemv) and takes only the noise, the read and the managed value from here
// and managed_read.cuh.  Moving #1, #3, #6 and #7 onto #2's product is open
// work (ROADMAP.md, Queue 2).
//
// A physical array read
//     y = sum_seg clip(W_seg x_seg + sigma * xi, +-alpha)
// walks the whole contraction in a loop inside the block; at each
// contraction-segment boundary (the 4096-column physical array limit) the
// segment sum receives its read noise, saturation flag and integrator clip
// before the digital sum over segments.  This loop replaces the TPU kernel's
// serial k grid axis.  Products are fp32 FMAs on the CUDA cores (no TF32, no
// tensor cores).
//
// Noise: splitmix32 counter hash + Box-Muller with logf/cosf/sqrtf (no fast
// math), at the reference counter e = (row * n_seg + seg) * out + col in u32
// arithmetic (row includes the streaming row offset), u2 at e + n_total —
// the same numbers as repro_torch.utils.fastrng.normal_at.  The noise add,
// the managed-read scales and the clip use explicitly rounded intrinsics so
// the compiler cannot contract them into FMAs: they round exactly as the
// plain PyTorch versions do.
//
// Two product paths of this older body, chosen from the shapes:
//   Warp-per-column (forward reads with B <= 8).  One warp walks one row of
//     W with coalesced 128-byte loads, lanes along the contraction, each
//     lane accumulating all B input rows (one scalar load of W and B of x
//     per element: bound by load issue rather than bytes); a butterfly
//     shuffle reduces each row's sum at the segment end and lane b then
//     reads row b.
//   Tiled (everything else: prefill, transpose).  One block computes a
//     64 x 64 tile of outputs, 4 x 4 per thread, staging 16-deep k-tiles of
//     W and x through shared memory with scalar loads and no prefetch (two
//     FMAs per shared load).  Its x loader is a template parameter, so the
//     conv read builds patch elements by index from the activation volume
//     (implicit im2col) in the same loop.
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
__device__ __forceinline__ float normal_at(uint32_t seed_m, uint32_t e,
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
// Warp-per-column path (forward, B <= GEMV_MAXB)
// ---------------------------------------------------------------------------

constexpr int GEMV_MAXB = 8;
constexpr int GEMV_WARPS = 8;  // output columns per 256-thread block

// The segment [ks, ke) of output column o: lane b (b < B) returns the full
// sum W[o, ks:ke] . x[b, ks:ke]; the other lanes return 0.
__device__ __forceinline__ float gemv_segment(const ReadArgs& a, int o,
                                              int ks, int ke, int lane) {
  float acc[GEMV_MAXB];
#pragma unroll
  for (int b = 0; b < GEMV_MAXB; ++b) acc[b] = 0.0f;
  const float* wrow = a.w + (size_t)o * a.K;
#pragma unroll 4
  for (int k = ks + lane; k < ke; k += 32) {
    const float wv = __ldg(wrow + k);
#pragma unroll
    for (int b = 0; b < GEMV_MAXB; ++b)
      if (b < a.B) acc[b] = fmaf(__ldg(a.x + (size_t)b * a.K + k), wv, acc[b]);
  }
  float mine = 0.0f;
#pragma unroll
  for (int b = 0; b < GEMV_MAXB; ++b) {
    if (b < a.B) {
      float v = acc[b];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        v += __shfl_xor_sync(0xffffffffu, v, off);
      if (lane == b) mine = v;
    }
  }
  return mine;
}

// ---------------------------------------------------------------------------
// Tiled path
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

// Input element (row m, contraction index k) of a dense row-major x.
struct DenseX {
  __device__ __forceinline__ float operator()(const ReadArgs& a, int m,
                                              int k) const {
    return a.x[(size_t)m * a.K + k];
  }
};

// Stage one k-tile [kb, ke) of W (tile columns n0..n0+BN) and x (rows
// m0..m0+BM) into shared memory, zero-filling out-of-range entries.  The
// loader xl reads x(m, k): dense rows, or a patch built by index (conv).
template <class XL = DenseX>
__device__ __forceinline__ void load_tile(Smem& sm, const ReadArgs& a,
                                          int m0, int n0, int kb, int ke,
                                          const XL& xl = XL()) {
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
    sm.xs[kk][mm] = (k < ke && m < a.B) ? xl(a, m, k) : 0.0f;
  }
}

// The contraction of one segment [ks, ke) into this thread's 4 x 4 outputs.
template <class XL = DenseX>
__device__ __forceinline__ void segment_product(Smem& sm, const ReadArgs& a,
                                                int m0, int n0, int ks,
                                                int ke, float (&seg)[OWN],
                                                const XL& xl = XL()) {
  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
#pragma unroll
  for (int o = 0; o < OWN; ++o) seg[o] = 0.0f;
  for (int kb = ks; kb < ke; kb += BK) {
    __syncthreads();  // previous tile fully consumed
    load_tile(sm, a, m0, n0, kb, ke, xl);
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
