// noisy_mvm: the raw analog array read on Hopper (kernel #1).
//
// Replaces the TPU kernel noisy_mvm_pallas (src/repro/kernels/noisy_mvm.py,
// pallas_call at :197):
//     y = sum_seg clip(W_seg x_seg + sigma * xi, +-alpha),  sat[b] = any clip
// forward or transpose, with contraction splits, the streaming row offset
// and the u32 wrap of the noise counters.
//
// It runs on #2's product (managed_gemm.cuh) with read_value in place of
// the managed value; every read is ONE ordinary launch (no fill, no grid
// barrier).  The seed is an analog::Seed (by value, or read from a key
// schedule's seed table when the kernel runs), and `go`, when not null, is
// a device byte: zero makes every block return at once, before it touches
// the outputs or the scratch.  That is a predicated bound-management retry
// (core/management.py): a captured step holds all of a read's retries and
// the card decides which of them run.  Both are kernel arguments beside
// ReadArgs, whose by-value layout the decode's time depends on.  The
// per-row flags are ORed into a scratch per device and stream that every
// call leaves zeroed; the last block to finish writes the (B,) flags as
// bytes (the wrapper views them as bool) and clears it.
//   Decode (forward, B <= 8): gemv_walk streams W with float4 loads (x
//     through L1), as many 8-warp blocks as fit on the card walking the
//     column groups grid-stride; a warp owns whole columns over every
//     segment, so it adds the noise, clips and writes y itself.  Bound:
//     the bytes of W (2 B flops per 4 bytes).
//   Prefill and transposed reads: the SIMT SGEMM tile (8x8 outputs per
//     thread, 3-stage cp.async ring, IEEE FMAs, no TF32).  One block per
//     tile, contraction segment and part: with one segment and one part
//     the block reads, clips and writes y; otherwise each block writes its
//     partial sums to a plane and the last block of the tile (a ticket per
//     tile) adds the parts of each segment in order, reads the segment
//     sums and adds them in segment order.  Splitting a segment's
//     contraction into ordered parts balances the grid where the tiles
//     alone would leave SMs idle or run a short second wave (deepseek's
//     B = 128: 64 or 172 tiles on 132 SMs); a tile's parts are dispatched
//     together, so its last block's additions overlap other tiles' work.
//     Bound: fp32 FMAs at 67 TFLOP/s.
#include "managed_gemm.cuh"

namespace analog {
namespace gemm {

// #1's decode reader: the read of each segment sum added to out, the
// output written at the end, and a ballot of the saturated lanes.
struct RawGemvRead {
  const ReadArgs& a;
  uint32_t seed_m;
  float* __restrict__ y;
  uint32_t r = 0;
  bool ok = false, fl = false;
  int b = 0, o = 0;
  float out = 0.0f;

  __device__ __forceinline__ void begin(bool ok_, int b_, int o_) {
    ok = ok_;
    b = b_;
    o = o_;
    out = 0.0f;
    fl = false;
  }
  __device__ __forceinline__ void segment(int si, float v) {
    if (ok)
      out = __fadd_rn(out, read_value(v, seed_m, counter(a, b, si, o), a, fl));
  }
  __device__ __forceinline__ void end() {
    if (ok) y[(size_t)b * a.out_dim + o] = out;
    r |= __ballot_sync(0xffffffffu, ok && fl);
  }
};

// The last block of the read writes the (B,) flags and clears the scratch.
__device__ __forceinline__ void finish_flags(int* ticket, int* sat, int B,
                                             uint8_t* __restrict__ flags,
                                             int blocks) {
  if (!last_block(ticket, blocks)) return;
  for (int b0 = threadIdx.x; b0 < B; b0 += 8 * blockDim.x) {
    int v[8];  // 8 loads in flight before the stores
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int b = b0 + u * blockDim.x;
      v[u] = b < B ? __ldcg(sat + b) : 0;
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int b = b0 + u * blockDim.x;
      if (b < B) {
        flags[b] = v[u] != 0;
        sat[b] = 0;
      }
    }
  }
  if (threadIdx.x == 0) *ticket = 0;
}

template <int NCW, bool VEC>
__global__ void __launch_bounds__(GW * 32)
    raw_gemv_kernel(ReadArgs a, Seed seed, const uint8_t* __restrict__ go,
                    float* __restrict__ y, int* sat, int* ticket,
                    uint8_t* __restrict__ flags) {
  if (go != nullptr && *go == 0) return;
  const int lane = threadIdx.x & 31;
  RawGemvRead rd{a, seed.mixed(), y};
  gemv_walk<NCW, VEC>(a, rd);
  const uint32_t r = ballot_rows(rd.r);
  if (lane < a.B && ((r >> lane) & 1)) atomicOr(&sat[lane], 1);
  finish_flags(ticket, sat, a.B, flags, gridDim.x);
}

// One BM x BN tile (blockIdx.y: column tile, blockIdx.z: row tile) of one
// part (blockIdx.x = segment * split + part) of one segment, TM x TM
// outputs per thread: the parts of a tile are dispatched together.  part:
// (n_seg * split, B, out) planes of partial sums, used when gridDim.x > 1;
// tickets: one per tile.
template <int BM, int BN, bool VEC, bool TRANS, int TM>
__global__ void __launch_bounds__((BM / TM) * (BN / TM), 2)
    raw_tile_kernel(ReadArgs a, Seed seed, const uint8_t* __restrict__ go,
                    int split, float* __restrict__ part,
                    float* __restrict__ y, int* sat, int* tickets,
                    int* ticket, uint8_t* __restrict__ flags) {
  if (go != nullptr && *go == 0) return;
  using T = Tile<BM, BN, VEC, TRANS, DenseX, TM>;
  extern __shared__ __align__(16) float smem[];
  const int m0 = blockIdx.z * BM, n0 = blockIdx.y * BN;
  const int tx = threadIdx.x % T::TX, ty = threadIdx.x / T::TX;
  const int si = blockIdx.x / split, sp = blockIdx.x % split;
  const int ks = si * a.seg_len;
  const int ke = min(a.K, ks + a.seg_len);
  const int len = ((ke - ks + split - 1) / split + T::BK - 1) & ~(T::BK - 1);
  const int cs = min(ke, ks + sp * len), ce = min(ke, cs + len);
  float acc[TM][TM];
  T::segment(smem, a, m0, n0, cs, ce, acc);
  const uint32_t seed_m = seed.mixed();
  const size_t plane = (size_t)a.B * a.out_dim;
  uint32_t f = 0;  // bit i: owned row i saturated
  if (gridDim.x == 1) {
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int m = m0 + T::row(ty, i);
#pragma unroll
      for (int j = 0; j < TM; ++j) {
        const int col = n0 + T::col(tx, j);
        if (m >= a.B || col >= a.out_dim) continue;
        bool fl = false;
        y[(size_t)m * a.out_dim + col] = __fadd_rn(
            0.0f, read_value(acc[i][j], seed_m, counter(a, m, 0, col), a, fl));
        f |= (uint32_t)fl << i;
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int m = m0 + T::row(ty, i);
#pragma unroll
      for (int j = 0; j < TM; ++j) {
        const int col = n0 + T::col(tx, j);
        if (m < a.B && col < a.out_dim)
          part[blockIdx.x * plane + (size_t)m * a.out_dim + col] = acc[i][j];
      }
    }
    const int tile = blockIdx.z * gridDim.y + blockIdx.y;
    if (!last_block(tickets + tile, gridDim.x)) return;
    if (threadIdx.x == 0) tickets[tile] = 0;
    // The tile's last block, four of a thread's rows at a time (4 x TM
    // loads of a part in flight together): per segment add the parts in
    // order, read, and add the reads in segment order.
#pragma unroll
    for (int h = 0; h < TM / 4; ++h) {
      float out[4][TM], v[4][TM];
      for (int s = 0; s < a.n_seg; ++s) {
        for (int q = 0; q < split; ++q) {
          const float* p = part + (size_t)(s * split + q) * plane;
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int m = m0 + T::row(ty, 4 * h + i);
#pragma unroll
            for (int j = 0; j < TM; ++j) {
              const int col = n0 + T::col(tx, j);
              if (m >= a.B || col >= a.out_dim) continue;
              const float t = __ldcg(p + (size_t)m * a.out_dim + col);
              v[i][j] = q == 0 ? t : __fadd_rn(v[i][j], t);
            }
          }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int m = m0 + T::row(ty, 4 * h + i);
#pragma unroll
          for (int j = 0; j < TM; ++j) {
            const int col = n0 + T::col(tx, j);
            if (m >= a.B || col >= a.out_dim) continue;
            bool fl = false;
            const float r = read_value(v[i][j], seed_m, counter(a, m, s, col),
                                       a, fl);
            out[i][j] = __fadd_rn(s == 0 ? 0.0f : out[i][j], r);
            f |= (uint32_t)fl << (4 * h + i);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int m = m0 + T::row(ty, 4 * h + i);
#pragma unroll
        for (int j = 0; j < TM; ++j) {
          const int col = n0 + T::col(tx, j);
          if (m < a.B && col < a.out_dim)
            y[(size_t)m * a.out_dim + col] = out[i][j];
        }
      }
    }
  }
  // the TX threads of a row group are consecutive lanes: OR their flags,
  // then one of them raises each row's flag
#pragma unroll
  for (int off = T::TX / 2; off > 0; off >>= 1)
    f |= __shfl_xor_sync(0xffffffffu, f, off);
  if (tx == 0) {
#pragma unroll
    for (int i = 0; i < TM; ++i)
      if ((f >> i) & 1) atomicOr(&sat[m0 + T::row(ty, i)], 1);
  }
  finish_flags(ticket, sat, a.B, flags, gridDim.y * gridDim.z);
}

}  // namespace gemm
}  // namespace analog

namespace {

using analog::ReadArgs;
using analog::Seed;
namespace g = analog::gemm;

template <int BM, int BN, bool VEC, bool TRANS, int TM>
int launch_tile(const ReadArgs& a, Seed seed, const uint8_t* go, int split,
                float* part, float* y, int* sat, int* tickets, int* ticket,
                uint8_t* flags, cudaStream_t s) {
  using T = g::Tile<BM, BN, VEC, TRANS, g::DenseX, TM>;
  auto kern = g::raw_tile_kernel<BM, BN, VEC, TRANS, TM>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)T::SMEM);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid(a.n_seg * split, (a.out_dim + BN - 1) / BN,
                  (a.B + BM - 1) / BM);
  kern<<<grid, T::THREADS, T::SMEM, s>>>(a, seed, go, split, part, y, sat,
                                         tickets, ticket, flags);
  return static_cast<int>(cudaGetLastError());
}

template <int BM, int BN, int TM>
int launch_tile_v(const ReadArgs& a, int vec, Seed seed, const uint8_t* go,
                  int split, float* part, float* y, int* sat, int* tickets,
                  int* ticket, uint8_t* flags, cudaStream_t s) {
  if (vec)
    return a.transpose ? launch_tile<BM, BN, true, true, TM>(
                             a, seed, go, split, part, y, sat, tickets,
                             ticket, flags, s)
                       : launch_tile<BM, BN, true, false, TM>(
                             a, seed, go, split, part, y, sat, tickets,
                             ticket, flags, s);
  return a.transpose ? launch_tile<BM, BN, false, true, TM>(
                           a, seed, go, split, part, y, sat, tickets, ticket,
                           flags, s)
                     : launch_tile<BM, BN, false, false, TM>(
                           a, seed, go, split, part, y, sat, tickets, ticket,
                           flags, s);
}

// As many blocks as fit on the card at once (at most one per 8 column
// groups); their warps walk the groups grid-stride, so no block waits for
// another to retire.
template <int NCW, bool VEC>
int launch_gemv(const ReadArgs& a, Seed seed, const uint8_t* go, float* y,
                int* sat, int* ticket, uint8_t* flags, cudaStream_t s) {
  auto kern = g::raw_gemv_kernel<NCW, VEC>;
  // all of the SM's L1 for x (the kernel takes no shared memory)
  static const cudaError_t carve = cudaFuncSetAttribute(
      kern, cudaFuncAttributePreferredSharedMemoryCarveout, 0);
  if (carve != cudaSuccess) return static_cast<int>(carve);
  static const int fit =
      g::resident_blocks(reinterpret_cast<const void*>(kern));
  if (fit <= 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int want = (a.out_dim + g::GW * NCW - 1) / (g::GW * NCW);
  kern<<<want < fit ? want : fit, g::GW * 32, 0, s>>>(a, seed, go, y, sat,
                                                      ticket, flags);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Outputs: y (B, out_dim) f32 and flags (B,) bytes.  scratch: int32
// [ticket, 3 unused, sat[B], one ticket per tile], zero on entry and left
// zero on return.  part: f32 (n_seg * split, B, out_dim) partial planes of
// the tiled path when n_seg * split > 1.  The plan (path 0: gemv with ncw
// outputs per warp; path 1: tile_m x tile_n tiles, each segment's
// contraction in `split` ordered parts; vec: 16-byte aligned rows of x and
// W) comes from the wrapper's plan(); shapes it does not allow are refused.
// seed_at: the seed in device memory (a key schedule's seed table), else
// null and `seed` by value; go: the read's predicate byte, or null.
extern "C" int noisy_mvm_launch(const float* w, const float* x, float* y,
                                uint8_t* flags, int* scratch, float* part,
                                int B, int K, int out_dim, int n_seg,
                                int seg_len, int transpose, float sigma,
                                float alpha, int has_alpha, unsigned seed,
                                unsigned row_offset, unsigned n_total,
                                int path, int tile_m, int tile_n, int ncw,
                                int vec, int split,
                                const unsigned long long* seed_at,
                                const uint8_t* go, void* stream) {
  if (B <= 0) return 0;
  if (split < 1) return static_cast<int>(cudaErrorInvalidValue);
  const ReadArgs a{w,     x,         B,     K,     out_dim,    n_seg,
                   seg_len, transpose, sigma, alpha, has_alpha,
                   row_offset, n_total};
  const Seed sd{seed, seed_at};
  int* ticket = scratch;
  int* sat = scratch + 4;
  int* tickets = scratch + 4 + B;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (path == 0) {
    if (transpose || B > g::GEMV_MAXB)
      return static_cast<int>(cudaErrorInvalidValue);
    if (ncw == 1)
      return vec ? launch_gemv<1, true>(a, sd, go, y, sat, ticket, flags, s)
                 : launch_gemv<1, false>(a, sd, go, y, sat, ticket, flags, s);
    if (ncw == 2)
      return vec ? launch_gemv<2, true>(a, sd, go, y, sat, ticket, flags, s)
                 : launch_gemv<2, false>(a, sd, go, y, sat, ticket, flags, s);
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (tile_m == 128 && tile_n == 128)
    return launch_tile_v<128, 128, 8>(a, vec, sd, go, split, part, y, sat,
                                      tickets, ticket, flags, s);
  if (tile_m == 64 && tile_n == 128)
    return launch_tile_v<64, 128, 8>(a, vec, sd, go, split, part, y, sat,
                                     tickets, ticket, flags, s);
  if (tile_m == 32 && tile_n == 32)  // short contractions: 4x4 per thread
    return launch_tile_v<32, 32, 4>(a, vec, sd, go, split, part, y, sat,
                                    tickets, ticket, flags, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
