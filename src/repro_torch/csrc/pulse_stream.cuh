// Stochastic pulse streams and their coincidence counts, shared by
// pulse_counts.cu (streams read from memory) and bwd_update_mvm.cu (streams
// regenerated in the kernel from the counter hash).
//
// A driver with value v and gain g fires in one pulse slot with probability
// p = min(|g v|, 1), at polarity sign(v).  The Bernoulli draw at flat
// counter e is  uniform24(mix32(e ^ mix32(seed))) < p : the counter-hash
// uniform of repro_torch.utils.fastrng.uniform, so a stream regenerated here
// equals update.sample_signed_streams' element for element.
//
// Counts: with signed streams B (T, M) of the row drivers and A (T, N) of
// the column drivers (entries 0, +1, -1),
//     count_up[i, j] = #{t : B[t, i] * A[t, j] = +1}
//     count_dn[i, j] = #{t : B[t, i] * A[t, j] = -1}
// i.e. (|B|^T|A| +- B^T A) / 2.  count_range counts a CT x CT tile of
// devices over a range of stream slots: it stages CR slots of both streams
// in shared memory as int8 and counts in int32 registers (exact).
// count_block gives each block a tile and CPAIRS slots and adds its integer
// totals to the f32 outputs with atomics.  Integer-valued f32 sums are exact
// below 2^24 in any order, so the result is bitwise the plain two-matmul
// version whatever order the blocks run in.  pulse_update.cu runs one block
// per tile over all T and applies the update in the block.
#pragma once

#include "analog_read.cuh"

namespace analog {

// One pulse slot: +1 / -1 when the driver fires, 0 otherwise.
__device__ __forceinline__ int pulse(float v, float gain, uint32_t seed_m,
                                     uint32_t e) {
  const float p = fminf(fabsf(__fmul_rn(gain, v)), 1.0f);
  if (!(uniform24(mix32(e ^ seed_m)) < p)) return 0;
  return v > 0.0f ? 1 : (v < 0.0f ? -1 : 0);
}

constexpr int CT = 32;       // count tile: CT x CT devices per block
constexpr int CR = 32;       // stream slots staged per round
constexpr int CPAIRS = 256;  // stream slots per block (the T split)
static_assert(THREADS == CT * CT / 4, "4 devices per thread");

struct CountTile {
  int M, N, T;             // rows, columns, stream slots
  int tiles_m, tiles_n;
  float* up;               // (M, N) zeroed by the launcher
  float* dn;
};

inline int count_blocks(const CountTile& c) {
  if (c.T <= 0 || c.M <= 0 || c.N <= 0) return 0;
  return c.tiles_m * c.tiles_n * ((c.T + CPAIRS - 1) / CPAIRS);
}

inline CountTile make_count_tile(int M, int N, int T, float* up, float* dn) {
  return CountTile{M, N, T, (M + CT - 1) / CT, (N + CT - 1) / CT, up, dn};
}

// Streams read from memory: rows (T, M) and cols (T, N), f32 in {0, +-1}.
struct MemStreams {
  const float* rows;  // (T, M)
  const float* cols;  // (T, N)
  int M, N;
  __device__ __forceinline__ int a(int t, int j) const {
    return (int)__ldg(cols + (size_t)t * N + j);
  }
  __device__ __forceinline__ int b(int t, int i) const {
    return (int)__ldg(rows + (size_t)t * M + i);
  }
};

// Counts of the CT x CT device tile at (m0, n0) over stream slots [q0, q1):
// thread t holds devices (m0 + t / 8, n0 + 4 (t % 8) + j), j < 4.  SRC gives
// the stream entries: src.a(t, j) of column j, src.b(t, i) of row i.
template <class SRC>
__device__ __forceinline__ void count_range(const CountTile& c,
                                            const SRC& src, int m0, int n0,
                                            int q0, int q1, int up[4],
                                            int dn[4]) {
  __shared__ signed char sa[CR][CT];
  __shared__ signed char sb[CR][CT];
  const int t = threadIdx.x;
  const int mm = t / (CT / 4), nn = (t % (CT / 4)) * 4;
  for (int j = 0; j < 4; ++j) up[j] = dn[j] = 0;
  for (int qs = q0; qs < q1; qs += CR) {
    __syncthreads();  // previous round fully consumed
    for (int i = t; i < CR * CT; i += THREADS) {
      const int r = i / CT, col = i % CT, q = qs + r;
      signed char va = 0, vb = 0;
      if (q < q1) {
        if (n0 + col < c.N) va = (signed char)src.a(q, n0 + col);
        if (m0 + col < c.M) vb = (signed char)src.b(q, m0 + col);
      }
      sa[r][col] = va;
      sb[r][col] = vb;
    }
    __syncthreads();
    const int nr = min(CR, q1 - qs);
    for (int r = 0; r < nr; ++r) {
      const int b = sb[r][mm];
      if (b == 0) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int prod = b * (int)sa[r][nn + j];
        up[j] += prod > 0;
        dn[j] += prod < 0;
      }
    }
  }
}

// Block bid of the count grid: (slot range, row tile, column tile); its
// counts are added to c.up / c.dn.
template <class SRC>
__device__ __forceinline__ void count_block(const CountTile& c,
                                            const SRC& src, int bid) {
  const int tiles = c.tiles_m * c.tiles_n;
  const int split = bid / tiles, tile = bid - split * tiles;
  const int m0 = (tile / c.tiles_n) * CT, n0 = (tile % c.tiles_n) * CT;
  const int q0 = split * CPAIRS, q1 = min(c.T, q0 + CPAIRS);
  int up[4], dn[4];
  count_range(c, src, m0, n0, q0, q1, up, dn);
  const int t = threadIdx.x;
  const int m = m0 + t / (CT / 4), nb = n0 + (t % (CT / 4)) * 4;
  if (m >= c.M) return;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int n = nb + j;
    if (n >= c.N) continue;
    const size_t i = (size_t)m * c.N + n;
    if (up[j]) atomicAdd(&c.up[i], (float)up[j]);
    if (dn[j]) atomicAdd(&c.dn[i], (float)dn[j]);
  }
}

}  // namespace analog
