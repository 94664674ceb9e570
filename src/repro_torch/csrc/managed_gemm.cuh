// The Hopper product of the analog array reads: a SIMT SGEMM tile for
// prefill, transposed and conv reads, and a gemv walk for decode reads,
// plus the last-block tickets, the select / rescale / #_d-average epilogue
// and the flag-clearing epilogue launch of #2's tiled path.
//
// Which kernel uses which part:
//   #2 managed_mvm.cu: Tile (DenseX, 8x8 outputs per thread) with
//     tile_kernel + finish_kernel (2 launches), and gemv_walk in the
//     cooperative gemv_kernel below (1).
//   #1 noisy_mvm.cu: Tile (DenseX; 8x8, or 4x4 for short contractions) and
//     gemv_walk, with read_value in place of the managed value; each read
//     one launch.
//   #3 conv_mvm.cu: Tile (4x4) with the implicit-im2col loader ConvX
//     (conv_patch.cuh), the select in the block or in the last block of a
//     row tile; each read one launch.
//   #6/#7 bwd_update_mvm.cu: Tile (DenseX, 32x32, transposed, 4x4) for the
//     transpose read beside the count blocks of pulse_stream.cuh, the
//     select in the block or in the last block of a row tile; each call
//     one launch.
// The noise, read_value and counter of analog_read.cuh and managed_value
// of managed_read.cuh are shared, so every kernel reads with the same
// numbers.
//
// Flags: per-row saturation flags and tickets live in a scratch per device
// and stream that every call leaves zeroed.  The last block to finish (a
// __threadfence and an atomic ticket) reads and clears them, so no fill
// launch runs before a read.  One read at a time may use a scratch: the
// wrappers keep one per (device, stream) and launch on that stream, whose
// reads run in order.
#pragma once

#include <cooperative_groups.h>

#include "managed_read.cuh"

namespace analog {
namespace gemm {

// ---------------------------------------------------------------------------
// Epilogue body: select, rescale, #_d average, residual
// ---------------------------------------------------------------------------

// Outputs [start, B * out_f) in steps of `step`; acc1/acc2 and the flags
// were written by other blocks, so they are read through L2 (__ldcg).
// With n_planes > 1, acc1/acc2 hold each contraction segment's reads in a
// plane of B * out_f * d_avg, summed here in segment order, as one thread
// walking the segments would sum them.
__device__ __forceinline__ void select_rows(
    const float* acc1, const float* acc2, const int* sat1, const int* sat2,
    const float* __restrict__ nm, float* __restrict__ y,
    uint8_t* __restrict__ residual, int B, int out_f, int d_avg,
    int two_phase, float retry_scale, size_t start, size_t step,
    int n_planes = 1) {
  const size_t n = (size_t)B * out_f;
  const size_t plane = n * d_avg;
  for (size_t idx = start; idx < n; idx += step) {
    const int b = (int)(idx / out_f), j = (int)(idx % out_f);
    const int f1 = __ldcg(sat1 + b);
    const bool sel = two_phase && f1 != 0;
    const float* part = sel ? acc2 : acc1;
    const float s = nm[b];
    const size_t row = (size_t)b * d_avg * out_f;
    float acc = 0.0f;
    for (int r = 0; r < d_avg; ++r) {
      const size_t i = row + (size_t)r * out_f + j;
      float t = __ldcg(part + i);
      for (int p = 1; p < n_planes; ++p)
        t = __fadd_rn(t, __ldcg(part + p * plane + i));
      const float v = sel ? __fmul_rn(__fmul_rn(t, retry_scale), s)
                          : __fmul_rn(t, s);
      acc = (r == 0) ? v : __fadd_rn(acc, v);
    }
    y[idx] = d_avg > 1 ? __fdiv_rn(acc, (float)d_avg) : acc;
    if (j == 0)
      residual[b] = two_phase ? (f1 != 0 && __ldcg(sat2 + b) != 0)
                              : (f1 != 0);
  }
}

// True in every thread of the block that arrived last of n at the ticket.
// Every thread fences its own writes before the barrier; the winner fences
// again before it reads what the others wrote.
__device__ __forceinline__ bool last_block(int* ticket, int n) {
  __shared__ int s_last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) s_last = atomicAdd(ticket, 1) == n - 1;
  __syncthreads();
  if (s_last) __threadfence();
  return s_last;
}

// Leave the scratch zeroed for the next read (called by the last block
// after a barrier that follows its last read of the flags).
__device__ __forceinline__ void clear_flags(int* ticket, int* sat1, int* sat2,
                                            int B) {
  for (int b = threadIdx.x; b < B; b += blockDim.x) {
    sat1[b] = 0;
    sat2[b] = 0;
  }
  if (threadIdx.x == 0) *ticket = 0;
}

// The tiled path's epilogue launch: every block selects a grid-stride
// share of the outputs (summing the n_planes segment planes); the last one
// clears the flags.
__global__ void __launch_bounds__(256) finish_kernel(
    const float* acc1, const float* acc2, int* sat1, int* sat2,
    const float* __restrict__ nm, float* __restrict__ y,
    uint8_t* __restrict__ residual, int B, int out_f, int d_avg,
    int two_phase, float retry_scale, int* ticket, int n_planes) {
  select_rows(acc1, acc2, sat1, sat2, nm, y, residual, B, out_f, d_avg,
              two_phase, retry_scale,
              blockIdx.x * (size_t)blockDim.x + threadIdx.x,
              (size_t)gridDim.x * blockDim.x, n_planes);
  if (last_block(ticket, gridDim.x)) clear_flags(ticket, sat1, sat2, B);
}

__device__ __forceinline__ float4 ldg4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

// A float4 read once: bypasses L1, which stays free for the reused x.
__device__ __forceinline__ float4 ldg4_stream(const float* p) {
  float4 v;
  asm("ld.global.nc.L1::no_allocate.v4.f32 {%0, %1, %2, %3}, [%4];\n"
      : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
      : "l"(p));
  return v;
}

// Zero the components of v (elements k0..k0+3) outside [ks, ke).
__device__ __forceinline__ float4 mask4(float4 v, int k0, int ks, int ke) {
  if (k0 < ks || k0 + 4 > ke) {
    v.x = (k0 >= ks && k0 < ke) ? v.x : 0.0f;
    v.y = (k0 + 1 >= ks && k0 + 1 < ke) ? v.y : 0.0f;
    v.z = (k0 + 2 >= ks && k0 + 2 < ke) ? v.z : 0.0f;
    v.w = (k0 + 3 >= ks && k0 + 3 < ke) ? v.w : 0.0f;
  }
  return v;
}

// ---------------------------------------------------------------------------
// Tiled path: prefill and transposed reads
// ---------------------------------------------------------------------------
//
// A block computes a BM x BN tile of outputs (rows of x by physical
// outputs), TM x TM per thread.  At TM = 8: rows ty * 4 + {0..3} and BM/2 +
// ty * 4 + {0..3}, columns likewise, so per k two float4 loads of x and two
// of W feed 64 FMAs (a rank-1 update); at TM = 4 (the conv read's small
// tiles: more threads, a shorter chain and epilogue per thread) one float4
// of each feeds 16.  The next k's loads are in flight while this k's FMAs
// run.  The contraction walks 16-deep k-tiles: a 3-stage cp.async ring
// copies them as they lie in device memory (two tiles in flight while one
// is multiplied); each thread then moves the chunks it copied itself into
// a k-major double buffer (zeroing x outside the segment on the way), so
// one barrier per k-tile suffices.  k-tiles start at multiples of 16, not
// at the segment start: x is zero outside the segment, so unaligned
// segment bounds (wo's seg_len 3670) keep the 16-byte copies, and W outside
// it is never summed.  Rows of x or W that are not 16-byte aligned (LeNet's
// 401, 513, 129, 26) take aligned scalar loads (VEC false) into registers
// instead of the ring: the next k-tile's loads are issued before this
// k-tile is multiplied and land in the k-major buffer after it.  x comes
// through the loader XL: DenseX for a dense x, ConvX (conv_patch.cuh) for
// patches built by index.  Each output's sum over [ks, ke) is one FMA
// chain in one thread, ascending in k: deterministic.

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// x loader of the Tile's scalar path for a dense row-major x (B, K): the
// chunk of row m at columns c.k0..c.k0+3, zero outside the matrix.
struct DenseX {
  const float* x;
  int B, K;
  struct Cols {
    int k0;
  };
  __device__ __forceinline__ Cols columns(int k0, int) const {
    return Cols{k0};
  }
  __device__ __forceinline__ void load4(int, int m, const Cols& c,
                                        float* dst) const {
    const float* src = x + (size_t)m * K + c.k0;
#pragma unroll
    for (int e = 0; e < 4; ++e)
      dst[e] = (m < B && c.k0 + e < K) ? __ldg(src + e) : 0.0f;
  }
};

template <int BM, int BN, bool VEC, bool TRANS, class XL = DenseX,
          int TM = 8>
struct Tile {
  static_assert(TM == 4 || TM == 8, "4x4 or 8x8 outputs per thread");
  static constexpr int H = TM / 4;  // float4 per operand, thread and k
  static constexpr int THREADS = (BM / TM) * (BN / TM);
  static constexpr int TX = BN / TM;
  static constexpr int BK = 16, STAGES = 3;
  static constexpr int CX = BM * BK / 4;  // 16-byte chunks of x per k-tile
  static constexpr int CW = BN * BK / 4;  // and of W
  static constexpr int NX = CX / THREADS, NW = CW / THREADS;  // per thread
  static_assert(NX >= 1 && NW >= 1 && NX * THREADS == CX &&
                    NW * THREADS == CW,
                "chunk split");
  static_assert(THREADS % 32 == 0, "whole warps");  // row flags: shuffles
  static constexpr int RING = (BM + BN) * BK;         // floats per stage
  static constexpr int XLD = BM + 4, WLD = BN + 4;    // k-major rows
  static constexpr int BUF = BK * (XLD + WLD);        // floats per buffer
  static constexpr size_t SMEM =
      ((VEC ? STAGES * RING : 0) + 2 * BUF) * sizeof(float);

  static __device__ __forceinline__ int row(int ty, int i) {
    return (i / 4) * (BM / H) + ty * 4 + (i & 3);
  }
  static __device__ __forceinline__ int col(int tx, int j) {
    return (j / 4) * (BN / H) + tx * 4 + (j & 3);
  }
  // chunk c of a k-tile: x chunks are (row, 4 k) with k fastest; W chunks
  // are (output, 4 k) forward and (k, 4 outputs) transposed
  static __device__ __forceinline__ void x_chunk(int c, int& r, int& q) {
    r = c / (BK / 4);
    q = (c % (BK / 4)) * 4;
  }
  static __device__ __forceinline__ void w_chunk(int c, int& r, int& q) {
    if (TRANS) {
      r = c / (BN / 4);
      q = (c % (BN / 4)) * 4;
    } else {
      r = c / (BK / 4);
      q = (c % (BK / 4)) * 4;
    }
  }

  // This thread's chunks of one k-tile.
  struct Chunks {
    float4 x[NX], w[NW];
  };

  // Copy k-tile kb into ring stage st (VEC: 16-byte cp.async).
  static __device__ __forceinline__ void issue(float* st, const ReadArgs& a,
                                               int m0, int n0, int kb) {
#pragma unroll
    for (int l = 0; l < NX; ++l) {
      const int c = threadIdx.x + l * THREADS;
      int r, q;
      x_chunk(c, r, q);
      const int m = m0 + r, k0 = kb + q;
      const bool ok = m < a.B && k0 < a.K;
      cp_async16(st + c * 4, ok ? a.x + (size_t)m * a.K + k0 : a.x,
                 ok ? 16 : 0);
    }
#pragma unroll
    for (int l = 0; l < NW; ++l) {
      const int c = threadIdx.x + l * THREADS;
      int r, q;
      w_chunk(c, r, q);
      const int o = TRANS ? n0 + q : n0 + r, k0 = TRANS ? kb + r : kb + q;
      const bool ok = o < a.out_dim && k0 < a.K;
      cp_async16(st + CX * 4 + c * 4,
                 ok ? (TRANS ? a.w + (size_t)k0 * a.out_dim + o
                             : a.w + (size_t)o * a.K + k0)
                    : a.w,
                 ok ? 16 : 0);
    }
  }

  // This thread's chunks of ring stage st.
  static __device__ __forceinline__ void staged(Chunks& ch, const float* st) {
#pragma unroll
    for (int l = 0; l < NX; ++l)
      ch.x[l] = *reinterpret_cast<const float4*>(
          st + (threadIdx.x + l * THREADS) * 4);
#pragma unroll
    for (int l = 0; l < NW; ++l)
      ch.w[l] = *reinterpret_cast<const float4*>(
          st + CX * 4 + (threadIdx.x + l * THREADS) * 4);
  }

  // Load this thread's chunks of k-tile kb into registers (scalar path).
  // Every x chunk of a thread starts at the same k (THREADS is a multiple
  // of BK / 4), so the loader resolves the columns once per k-tile.
  static __device__ __forceinline__ void fetch(Chunks& ch, const ReadArgs& a,
                                               int m0, int n0, int kb,
                                               const XL& xl) {
    const typename XL::Cols cols =
        xl.columns(kb + (threadIdx.x % (BK / 4)) * 4, a.K);
#pragma unroll
    for (int l = 0; l < NX; ++l) {
      int r, q;
      x_chunk(threadIdx.x + l * THREADS, r, q);
      float v[4];
      xl.load4(l, m0 + r, cols, v);
      ch.x[l] = make_float4(v[0], v[1], v[2], v[3]);
    }
#pragma unroll
    for (int l = 0; l < NW; ++l) {
      int r, q;
      w_chunk(threadIdx.x + l * THREADS, r, q);
      const int o = TRANS ? n0 + q : n0 + r, k0 = TRANS ? kb + r : kb + q;
      const float* src = TRANS ? a.w + (size_t)k0 * a.out_dim + o
                               : a.w + (size_t)o * a.K + k0;
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool ok = TRANS ? (k0 < a.K && o + e < a.out_dim)
                              : (o < a.out_dim && k0 + e < a.K);
        v[e] = ok ? __ldg(src + e) : 0.0f;
      }
      ch.w[l] = make_float4(v[0], v[1], v[2], v[3]);
    }
  }

  // Move this thread's chunks of k-tile kb into the k-major buffer buf, x
  // zeroed outside the segment [ks, ke).
  static __device__ __forceinline__ void put(const Chunks& ch, float* buf,
                                             int kb, int ks, int ke) {
    float* xs = buf;
    float* ws = buf + BK * XLD;
#pragma unroll
    for (int l = 0; l < NX; ++l) {
      int r, q;
      x_chunk(threadIdx.x + l * THREADS, r, q);
      float4 v = ch.x[l];
      const int k0 = kb + q;  // branch-free: every tile, not just the ends
      v.x = (k0 >= ks && k0 < ke) ? v.x : 0.0f;
      v.y = (k0 + 1 >= ks && k0 + 1 < ke) ? v.y : 0.0f;
      v.z = (k0 + 2 >= ks && k0 + 2 < ke) ? v.z : 0.0f;
      v.w = (k0 + 3 >= ks && k0 + 3 < ke) ? v.w : 0.0f;
      xs[q * XLD + r] = v.x;
      xs[(q + 1) * XLD + r] = v.y;
      xs[(q + 2) * XLD + r] = v.z;
      xs[(q + 3) * XLD + r] = v.w;
    }
#pragma unroll
    for (int l = 0; l < NW; ++l) {
      int r, q;
      w_chunk(threadIdx.x + l * THREADS, r, q);
      const float4 v = ch.w[l];
      if (TRANS) {
        *reinterpret_cast<float4*>(ws + r * WLD + q) = v;
      } else {
        ws[q * WLD + r] = v.x;
        ws[(q + 1) * WLD + r] = v.y;
        ws[(q + 2) * WLD + r] = v.z;
        ws[(q + 3) * WLD + r] = v.w;
      }
    }
  }

  // 16 rank-1 updates of this thread's TM x TM outputs from buffer buf.
  static __device__ __forceinline__ void multiply(const float* buf, int tx,
                                                  int ty,
                                                  float (&acc)[TM][TM]) {
    const float* xs = buf + ty * 4;
    const float* ws = buf + BK * XLD + tx * 4;
    float4 xa[2][H], wb[2][H];  // [k parity][part]
    auto frag = [&](int k, int p) {
#pragma unroll
      for (int h = 0; h < H; ++h) {
        xa[p][h] =
            *reinterpret_cast<const float4*>(xs + k * XLD + h * (BM / H));
        wb[p][h] =
            *reinterpret_cast<const float4*>(ws + k * WLD + h * (BN / H));
      }
    };
    frag(0, 0);
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      const int p = k & 1;
      if (k + 1 < BK) frag(k + 1, p ^ 1);
      float av[TM], bv[TM];
#pragma unroll
      for (int h = 0; h < H; ++h) {
        av[4 * h] = xa[p][h].x;
        av[4 * h + 1] = xa[p][h].y;
        av[4 * h + 2] = xa[p][h].z;
        av[4 * h + 3] = xa[p][h].w;
        bv[4 * h] = wb[p][h].x;
        bv[4 * h + 1] = wb[p][h].y;
        bv[4 * h + 2] = wb[p][h].z;
        bv[4 * h + 3] = wb[p][h].w;
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TM; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }

  // The contraction [ks, ke) of this thread's TM x TM outputs into acc.
  static __device__ __forceinline__ void segment(float* smem,
                                                 const ReadArgs& a, int m0,
                                                 int n0, int ks, int ke,
                                                 float (&acc)[TM][TM]) {
    segment(smem, a, m0, n0, ks, ke, acc, DenseX{a.x, a.B, a.K});
  }
  static __device__ __forceinline__ void segment(float* smem,
                                                 const ReadArgs& a, int m0,
                                                 int n0, int ks, int ke,
                                                 float (&acc)[TM][TM],
                                                 const XL& xl) {
    const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TM; ++j) acc[i][j] = 0.0f;
    const int kb0 = ks - ks % BK;
    const int nt = (ke - kb0 + BK - 1) / BK;
    Chunks ch;
    if (VEC) {
      float* ring = smem;
      float* bufs = smem + STAGES * RING;
#pragma unroll
      for (int s = 0; s < STAGES - 1; ++s) {
        if (s < nt) issue(ring + s * RING, a, m0, n0, kb0 + s * BK);
        cp_commit();
      }
      for (int t = 0; t < nt; ++t) {
        cp_wait<STAGES - 2>();  // this thread's copies of tile t landed
        float* buf = bufs + (t & 1) * BUF;
        staged(ch, ring + (t % STAGES) * RING);
        put(ch, buf, kb0 + t * BK, ks, ke);
        __syncthreads();  // buffer t complete; tile t - 1's multiply done
        const int tn = t + STAGES - 1;
        if (tn < nt)
          issue(ring + (tn % STAGES) * RING, a, m0, n0, kb0 + tn * BK);
        cp_commit();
        multiply(buf, tx, ty, acc);
      }
    } else {
      if (nt > 0) fetch(ch, a, m0, n0, kb0, xl);
      for (int t = 0; t < nt; ++t) {
        float* buf = smem + (t & 1) * BUF;
        put(ch, buf, kb0 + t * BK, ks, ke);
        __syncthreads();  // buffer t complete; tile t - 1's multiply done
        if (t + 1 < nt) fetch(ch, a, m0, n0, kb0 + (t + 1) * BK, xl);
        multiply(buf, tx, ty, acc);
      }
    }
  }
};

// The managed read of one BM x BN tile for one contraction segment
// (blockIdx.z): writes both reads of the segment sums into that segment's
// plane of acc1/acc2 (n_seg x B x out_phys) and ORs the per-row flags.
// Segments are independent reads, so they run as blocks of their own; the
// epilogue adds the planes in segment order.
template <int BM, int BN, bool VEC, bool TRANS>
__global__ void __launch_bounds__((BM / 8) * (BN / 8), 2)
    tile_kernel(ReadArgs a, const float* __restrict__ nm, Seed seed1,
                Seed seed2, int two_phase, float retry_scale,
                float* __restrict__ acc1, float* __restrict__ acc2,
                int* __restrict__ sat1, int* __restrict__ sat2) {
  using T = Tile<BM, BN, VEC, TRANS>;
  extern __shared__ __align__(16) float smem[];
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN, si = blockIdx.z;
  const int tx = threadIdx.x % T::TX, ty = threadIdx.x / T::TX;
  const size_t plane = (size_t)si * a.B * a.out_dim;
  const int ks = si * a.seg_len;
  const int ke = min(a.K, ks + a.seg_len);
  float acc[8][8];
  T::segment(smem, a, m0, n0, ks, ke, acc);
  const uint32_t seed1_m = seed1.mixed(), seed2_m = seed2.mixed();
  uint32_t f1 = 0, f2 = 0;  // bit i: owned row i saturated
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + T::row(ty, i);
    if (m >= a.B) continue;
    const float s = nm[m];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = n0 + T::col(tx, j);
      if (col >= a.out_dim) continue;
      const size_t idx = plane + (size_t)m * a.out_dim + col;
      float y1 = 0.0f, y2 = 0.0f;
      bool b1 = false, b2 = false;
      managed_value(a, acc[i][j], s, seed1_m, seed2_m, two_phase,
                    retry_scale, counter(a, m, si, col), y1, y2, b1, b2);
      acc1[idx] = y1;
      if (two_phase) acc2[idx] = y2;
      f1 |= (uint32_t)b1 << i;
      f2 |= (uint32_t)b2 << i;
    }
  }
  // the TX threads of a row group are consecutive lanes: OR their flags,
  // then one of them raises each row's flag
#pragma unroll
  for (int off = T::TX / 2; off > 0; off >>= 1) {
    f1 |= __shfl_xor_sync(0xffffffffu, f1, off);
    f2 |= __shfl_xor_sync(0xffffffffu, f2, off);
  }
  if (tx == 0) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int m = m0 + T::row(ty, i);
      if ((f1 >> i) & 1) atomicOr(&sat1[m], 1);
      if ((f2 >> i) & 1) atomicOr(&sat2[m], 1);
    }
  }
}

// ---------------------------------------------------------------------------
// Decode path: forward reads with B <= 8, one launch per read
// ---------------------------------------------------------------------------
//
// Blocks of 8 warps; each warp walks column groups of NCW outputs
// (grid-stride).  Lanes lie along the contraction: per step a lane holds U
// float4 of W for each of its NCW columns (8 float4 in all), and the next
// step's 8 are in flight while this step is multiplied; W bypasses L1, so
// the B rows of x stay there for every warp of the SM, and one load of x
// feeds 4 NCW FMAs.  No barrier stalls the stream of W.
// Quads start at multiples of 4 and x is zero outside the segment, so an
// unaligned segment bound (seg_len 3670) keeps the vector loads.  A
// butterfly reduces each (column, row) sum at the segment end; lane
// c * 8 + b reads the pair.  What a read does with the sums is its reader
// RD: rd.begin(ok, b, o) at each group (ok: this lane owns column o, row
// b), rd.segment(si, v) at each segment end and rd.end() after the last,
// in every lane (v is meaningful where ok).

constexpr int GEMV_MAXB = 8;
constexpr int GW = 8;  // warps per block

// Blocks of GW warps of a kernel that fit on the card at once (0 when the
// runtime cannot say).
inline int resident_blocks(const void* kern) {
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, GW * 32,
                                                    0) != cudaSuccess)
    return 0;
  return sms * per_sm;
}

template <int NCW, bool VEC, class RD>
__device__ __forceinline__ void gemv_walk(const ReadArgs& a, RD& rd) {
  constexpr int U = 8 / NCW;  // float4 of W per column and step
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int B = a.B;
  const int myc = lane >> 3, myb = lane & 7;
  const int n_groups = (a.out_dim + NCW - 1) / NCW;
  for (int grp = blockIdx.x * GW + warp; grp < n_groups;
       grp += gridDim.x * GW) {
    const int o0 = grp * NCW;
    rd.begin(myc < NCW && myb < B && o0 + myc < a.out_dim, myb, o0 + myc);
    for (int si = 0; si < a.n_seg; ++si) {
      const int ks = si * a.seg_len;
      const int ke = min(a.K, ks + a.seg_len);
      float acc[NCW][GEMV_MAXB];
#pragma unroll
      for (int c = 0; c < NCW; ++c)
#pragma unroll
        for (int b = 0; b < GEMV_MAXB; ++b) acc[c][b] = 0.0f;
      if (VEC) {
        // W for step kb of column c: U float4 per lane, k = kb + 128 u
        auto load_w = [&](float4 (&wv)[NCW][U], int kb) {
#pragma unroll
          for (int c = 0; c < NCW; ++c)
#pragma unroll
            for (int u = 0; u < U; ++u) {
              const int k0 = kb + 128 * u;
              wv[c][u] = (k0 < ke && o0 + c < a.out_dim)
                             ? ldg4_stream(a.w + (size_t)(o0 + c) * a.K + k0)
                             : make_float4(0.f, 0.f, 0.f, 0.f);
            }
        };
        const int kstart = (ks & ~3) + lane * 4;
        float4 wn[NCW][U];
        load_w(wn, kstart);
        for (int kb = kstart; kb < ke; kb += 128 * U) {
          float4 wv[NCW][U];
#pragma unroll
          for (int c = 0; c < NCW; ++c)
#pragma unroll
            for (int u = 0; u < U; ++u) wv[c][u] = wn[c][u];
          load_w(wn, kb + 128 * U);  // the next step's W, in flight now
#pragma unroll
          for (int u = 0; u < U; ++u) {
            const int k0 = kb + 128 * u;
            const bool ok = k0 < ke;
            float4 xv[GEMV_MAXB];
#pragma unroll
            for (int b = 0; b < GEMV_MAXB; ++b)
              xv[b] = (b < B && ok) ? ldg4(a.x + (size_t)b * a.K + k0)
                                    : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
            for (int b = 0; b < GEMV_MAXB; ++b) {
              if (b >= B) break;
              const float4 xm = mask4(xv[b], k0, ks, ke);
#pragma unroll
              for (int c = 0; c < NCW; ++c) {
                float t = acc[c][b];
                t = fmaf(xm.x, wv[c][u].x, t);
                t = fmaf(xm.y, wv[c][u].y, t);
                t = fmaf(xm.z, wv[c][u].z, t);
                acc[c][b] = fmaf(xm.w, wv[c][u].w, t);
              }
            }
          }
        }
      } else {
        // scalar loads (rows not 16-byte aligned): 4 steps of 32 columns,
        // all their loads issued before their FMAs
        for (int kb = ks + lane; kb < ke; kb += 32 * 4) {
          float wv[4][NCW], xv[4][GEMV_MAXB];
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int k = kb + 32 * u;
#pragma unroll
            for (int c = 0; c < NCW; ++c)
              wv[u][c] = k < ke && o0 + c < a.out_dim
                             ? __ldg(a.w + (size_t)(o0 + c) * a.K + k)
                             : 0.0f;
#pragma unroll
            for (int b = 0; b < GEMV_MAXB; ++b)
              xv[u][b] = k < ke && b < B ? __ldg(a.x + (size_t)b * a.K + k)
                                         : 0.0f;
          }
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            if (kb + 32 * u >= ke) break;
#pragma unroll
            for (int b = 0; b < GEMV_MAXB; ++b) {
              if (b >= B) break;
#pragma unroll
              for (int c = 0; c < NCW; ++c)
                acc[c][b] = fmaf(xv[u][b], wv[u][c], acc[c][b]);
            }
          }
        }
      }
      float mine = 0.0f;
#pragma unroll
      for (int c = 0; c < NCW; ++c)
#pragma unroll
        for (int b = 0; b < GEMV_MAXB; ++b) {
          if (b >= B) break;
          float v = acc[c][b];
#pragma unroll
          for (int off = 16; off > 0; off >>= 1)
            v += __shfl_xor_sync(0xffffffffu, v, off);
          if (lane == c * 8 + b) mine = v;
        }
      rd.segment(si, mine);
    }
    rd.end();
  }
}

// Rows whose lanes raised a ballot: lane c * 8 + b holds row b, so fold the
// ballot onto the low 8 bits.
__device__ __forceinline__ uint32_t ballot_rows(uint32_t r) {
  return r | (r >> 8) | (r >> 16) | (r >> 24);
}

// #2's reader: both two-phase reads of each segment sum into (y1, y2),
// the partials to acc1/acc2 and ballots of the saturated lanes.
struct ManagedGemvRead {
  const ReadArgs& a;
  const float* __restrict__ nm;
  uint32_t seed1_m, seed2_m;
  int two_phase;
  float retry_scale;
  float* acc1;
  float* acc2;
  uint32_t r1 = 0, r2 = 0;
  bool ok = false, fl1 = false, fl2 = false;
  int b = 0, o = 0;
  float s = 1.0f, y1 = 0.0f, y2 = 0.0f;

  __device__ __forceinline__ void begin(bool ok_, int b_, int o_) {
    ok = ok_;
    b = b_;
    o = o_;
    s = ok ? nm[b] : 1.0f;
    y1 = y2 = 0.0f;
    fl1 = fl2 = false;
  }
  __device__ __forceinline__ void segment(int si, float v) {
    if (ok)
      managed_value(a, v, s, seed1_m, seed2_m, two_phase, retry_scale,
                    counter(a, b, si, o), y1, y2, fl1, fl2);
  }
  __device__ __forceinline__ void end() {
    if (ok) {
      const size_t i = (size_t)b * a.out_dim + o;
      acc1[i] = y1;
      if (two_phase) acc2[i] = y2;
    }
    r1 |= __ballot_sync(0xffffffffu, ok && fl1);
    r2 |= __ballot_sync(0xffffffffu, ok && fl2);
  }
};

// #2's decode read: a cooperative launch of as many blocks as fit on the
// card at once.  After a grid-wide barrier every block selects its share of
// the outputs, and the last block to finish clears the flags.
template <int NCW, bool VEC>
__global__ void __launch_bounds__(GW * 32) gemv_kernel(
    ReadArgs a, const float* __restrict__ nm, Seed seed1, Seed seed2,
    int two_phase, float retry_scale, float* acc1, float* acc2, int* sat1,
    int* sat2, int* ticket, float* __restrict__ y,
    uint8_t* __restrict__ residual, int d_avg) {
  const int lane = threadIdx.x & 31;
  ManagedGemvRead rd{a,         nm,          seed1.mixed(), seed2.mixed(),
                     two_phase, retry_scale, acc1,          acc2};
  gemv_walk<NCW, VEC>(a, rd);
  const uint32_t r1 = ballot_rows(rd.r1), r2 = ballot_rows(rd.r2);
  if (lane < a.B) {
    if ((r1 >> lane) & 1) atomicOr(&sat1[lane], 1);
    if ((r2 >> lane) & 1) atomicOr(&sat2[lane], 1);
  }
  __threadfence();
  cooperative_groups::this_grid().sync();
  select_rows(acc1, acc2, sat1, sat2, nm, y, residual, a.B,
              a.out_dim / d_avg, d_avg, two_phase, retry_scale,
              blockIdx.x * (size_t)blockDim.x + threadIdx.x,
              (size_t)gridDim.x * blockDim.x);
  if (last_block(ticket, gridDim.x)) clear_flags(ticket, sat1, sat2, a.B);
}

}  // namespace gemm
}  // namespace analog
