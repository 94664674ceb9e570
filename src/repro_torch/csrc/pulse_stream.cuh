// Stochastic pulse streams and their coincidence counts, shared by
// pulse_counts.cu (streams read from memory), pulse_update.cu and
// bwd_update_mvm.cu (streams regenerated in the kernel from the counter
// hash).
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
// in shared memory as int8 (what the elements of a slot, a column or a row
// share is made once, not per element), each device's row of slots packed
// four to a word, and sums net = B^T A and tot = |B|^T |A| with __dp4a
// (four slots per instruction; |v| of a packed {0, +-1} byte is v & 1),
// exact in int32.
// A thread holds DM x 4 devices of the tile: DM = 1 in a block of
// COUNT_THREADS (pulse_counts.cu, pulse_update.cu), DM = 4 in
// bwd_update_mvm.cu's 64-thread blocks.  count_block gives each block of
// pulse_counts.cu a tile and CPAIRS slots and adds its integer totals to
// the f32 outputs with atomics: integer-valued f32 sums are exact below
// 2^24 in any order, so the result is bitwise the plain two-matmul version
// whatever order the blocks run in.  pulse_update.cu runs one block per
// tile over all T and applies the update in the block; bwd_update_mvm.cu
// adds a tile's slot parts in an int32 scratch.
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

constexpr int CT = 32;              // count tile: CT x CT devices
constexpr int CR = 64;              // stream slots staged per round
constexpr int CRW = CR / 4 + 1;     // words per staged row (+1: no bank
                                    // conflict between a thread's rows)
constexpr int STAGE_INTS = 2 * CT * CRW + 4 * CR;  // both streams of one
                                                   // round, slot data
constexpr int COUNT_THREADS = 256;  // pulse_counts.cu / pulse_update.cu
constexpr int CPAIRS = 256;         // pulse_counts.cu: slots per block

struct CountTile {
  int M, N, T;             // rows, columns, stream slots
  int tiles_m, tiles_n;
  float* up;               // (M, N) zeroed by the launcher (pulse_counts)
  float* dn;
};

inline int count_blocks(const CountTile& c) {
  if (c.T <= 0 || c.M <= 0 || c.N <= 0) return 0;
  return c.tiles_m * c.tiles_n * ((c.T + CPAIRS - 1) / CPAIRS);
}

inline CountTile make_count_tile(int M, int N, int T, float* up, float* dn) {
  return CountTile{M, N, T, (M + CT - 1) / CT, (N + CT - 1) / CT, up, dn};
}

// A stream source SRC gives, for slot q, the data its elements share
// (src.slot(q): a Slot of at most 16 bytes, made once per slot and round
// by one thread), for column j of A and row i of B the data their
// elements share (src.col_a(j), src.col_b(i): made once per thread), and
// the entries src.a(slot, col_a) of A and src.b(slot, col_b) of B.

// Streams read from memory: rows (T, M) and cols (T, N), f32 in {0, +-1}.
struct MemStreams {
  const float* rows;  // (T, M)
  const float* cols;  // (T, N)
  int M, N;
  struct Slot {
    int t;
  };
  __device__ __forceinline__ Slot slot(int q) const { return Slot{q}; }
  __device__ __forceinline__ int col_a(int j) const { return j; }
  __device__ __forceinline__ int col_b(int i) const { return i; }
  __device__ __forceinline__ int a(const Slot& s, int j) const {
    return (int)__ldg(cols + (size_t)s.t * N + j);
  }
  __device__ __forceinline__ int b(const Slot& s, int i) const {
    return (int)__ldg(rows + (size_t)s.t * M + i);
  }
};

// The devices a thread of a THREADS-thread block holds in a CT x CT tile:
// rows row0() + i (i < DM), columns col0() + j (j < 4).
template <int THREADS>
struct CountLayout {
  static constexpr int DM = CT * CT / (4 * THREADS);
  static_assert(DM >= 1 && DM * 4 * THREADS == CT * CT, "devices per thread");
  static __device__ __forceinline__ int row0() {
    return (int)(threadIdx.x / (CT / 4)) * DM;
  }
  static __device__ __forceinline__ int col0() {
    return (int)(threadIdx.x % (CT / 4)) * 4;
  }
};

// Counts of the CT x CT device tile at (m0, n0) over stream slots [q0, q1)
// into this thread's devices (CountLayout).  SRC gives the stream entries
// (see MemStreams).  stage: STAGE_INTS ints of shared memory.  A thread
// stages column t % CT of A and row t % CT of B in every round.
template <int THREADS, class SRC>
__device__ __forceinline__ void count_range(
    const CountTile& c, const SRC& src, int m0, int n0, int q0, int q1,
    int* stage, int (&up)[CountLayout<THREADS>::DM][4],
    int (&dn)[CountLayout<THREADS>::DM][4]) {
  using L = CountLayout<THREADS>;
  using Slot = typename SRC::Slot;
  constexpr int DM = L::DM;
  static_assert(THREADS % CT == 0 && sizeof(Slot) <= 16, "staging layout");
  int* sa = stage;             // [column][word], 4 slots a word
  int* sb = stage + CT * CRW;  // [row][word]
  Slot* slots = reinterpret_cast<Slot*>(stage + 2 * CT * CRW);
  signed char* ba = reinterpret_cast<signed char*>(sa);
  signed char* bb = reinterpret_cast<signed char*>(sb);
  const int t = threadIdx.x, mr = L::row0(), nc = L::col0();
  const int col = t % CT;
  const bool oka = n0 + col < c.N, okb = m0 + col < c.M;
  const auto ca = src.col_a(oka ? n0 + col : 0);
  const auto cb = src.col_b(okb ? m0 + col : 0);
  int net[DM][4], tot[DM][4];
#pragma unroll
  for (int i = 0; i < DM; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) net[i][j] = tot[i][j] = 0;
  for (int qs = q0; qs < q1; qs += CR) {
    __syncthreads();  // previous round fully consumed
    for (int r = t; r < CR && qs + r < q1; r += THREADS)
      slots[r] = src.slot(qs + r);
    __syncthreads();
    constexpr int STEP = THREADS / CT;
#pragma unroll 8  // the loads of 8 slots in flight together
    for (int k = 0; k < CR / STEP; ++k) {
      const int r = t / CT + k * STEP;
      const bool ok = qs + r < q1;  // no branch: every load in bounds
      const Slot sl = slots[ok ? r : 0];
      const int va = src.a(sl, ca), vb = src.b(sl, cb);
      ba[col * CRW * 4 + r] = (signed char)(ok && oka ? va : 0);
      bb[col * CRW * 4 + r] = (signed char)(ok && okb ? vb : 0);
    }
    __syncthreads();
    const int nw = (min(CR, q1 - qs) + 3) / 4;  // slots past q1 are 0
    for (int w = 0; w < nw; ++w) {
      int av[4], aa[4], bv[DM], ab[DM];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        av[j] = sa[(nc + j) * CRW + w];
        aa[j] = av[j] & 0x01010101;
      }
#pragma unroll
      for (int i = 0; i < DM; ++i) {
        bv[i] = sb[(mr + i) * CRW + w];
        ab[i] = bv[i] & 0x01010101;
      }
#pragma unroll
      for (int i = 0; i < DM; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          net[i][j] = __dp4a(bv[i], av[j], net[i][j]);
          tot[i][j] = __dp4a(ab[i], aa[j], tot[i][j]);
        }
    }
  }
#pragma unroll
  for (int i = 0; i < DM; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      up[i][j] = (tot[i][j] + net[i][j]) >> 1;
      dn[i][j] = (tot[i][j] - net[i][j]) >> 1;
    }
}

// Block bid of pulse_counts.cu's grid: (slot range, row tile, column
// tile); its counts are added to c.up / c.dn.
template <class SRC>
__device__ __forceinline__ void count_block(const CountTile& c,
                                            const SRC& src, int bid) {
  __shared__ int stage[STAGE_INTS];
  const int tiles = c.tiles_m * c.tiles_n;
  const int split = bid / tiles, tile = bid - split * tiles;
  const int m0 = (tile / c.tiles_n) * CT, n0 = (tile % c.tiles_n) * CT;
  const int q0 = split * CPAIRS, q1 = min(c.T, q0 + CPAIRS);
  int up[1][4], dn[1][4];
  count_range<COUNT_THREADS>(c, src, m0, n0, q0, q1, stage, up, dn);
  const int m = m0 + CountLayout<COUNT_THREADS>::row0();
  const int nb = n0 + CountLayout<COUNT_THREADS>::col0();
  if (m >= c.M) return;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int n = nb + j;
    if (n >= c.N) continue;
    const size_t i = (size_t)m * c.N + n;
    if (up[0][j]) atomicAdd(&c.up[i], (float)up[0][j]);
    if (dn[0][j]) atomicAdd(&c.dn[i], (float)dn[0][j]);
  }
}

}  // namespace analog
