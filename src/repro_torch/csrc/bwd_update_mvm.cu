// bwd_update_mvm: the backward and update cycles of one analog layer in one
// kernel launch on Hopper (dense entry and conv entry).
//
// Replaces the TPU kernels bwd_update_mvm_pallas (src/repro/kernels/
// bwd_update_mvm.py:222, pallas_call at :276) and conv_bwd_update_pallas
// (:473, pallas_call at :526).  One launch computes
//   * the managed transpose read z = f_mgmt(W^T delta) of the replicated
//     error rows delta (B, m_phys) (managed_read.cuh, one segment), and
//   * the update's integer coincidence counts of the signed pulse streams
//     A (B*BL, n_cols) of the column drivers and B (B*BL, m_phys) of the
//     row drivers -delta, regenerated in the kernel from the counter hash
//     (pulse_stream.cuh) and never stored:
//       A at e = ((row0 + row) * BL + slot) * n_cols + col   (seed k_a)
//       B at e = ((row0 + row) * BL + slot) * m_phys + i      (seed k_b).
// The dense entry's column drivers are the activations x (B, n_cols); the
// conv entry's are the patch elements of the position rows, built by index
// from xpad (conv_patch.cuh) at the channel-major column c * kh*kw + t, so
// the counts come out in the parameter matrix's layout directly.
//
// The TPU grid runs in order and carries both count matrices in VMEM
// across every (row-block, contraction-block) step.  Hopper blocks run in
// no order, so the one grid holds two kinds of 64-thread block, and every
// call is ONE launch with no memset:
//   * read blocks: managed_gemm.cuh's 32 x 32 transposed tile (4 x 4
//     outputs per thread, the next k-tile loaded while this one is
//     multiplied: LeNet's rows are not 16-byte multiples).  A deep
//     contraction (K2 with 13 devices per weight: 416) is split into
//     ordered parts, blocks of their own that write partial planes; the
//     last part of a tile to finish (a ticket per tile) adds them in
//     order.  The tile's sums then go through shared memory, so the read
//     noise of its valid outputs is spread over every thread (B = 8 fills
//     a quarter of a tile's rows) with the draws of two outputs in flight,
//     and the row flags are ORed there.  Where the block holds every
//     column of its rows (K1's 26) it selects and writes the residual
//     bytes itself.  Otherwise it writes z = y1 * s and the second read's
//     outputs, ORs the row flags into the scratch, and the last block of
//     each row tile (a ticket per row tile) rewrites the rows whose first
//     read saturated, writes the residual bytes and clears the flags.
//   * count blocks: a 32 x 32 device tile over a range of stream slots
//     (count_range: int8 streams in shared memory, __dp4a, exact int32).
//     The slot split is the wrapper's plan (enough blocks for the card);
//     with one part the block stores the f32 counts.  Otherwise the last
//     part of a device tile to finish (a ticket per tile) stores them
//     from int32 sums: where at most 4 parts meet (K2 with 13 devices per
//     weight at BL 1: 169 tiles x 4) each part writes a plane and the last
//     adds them; where more meet (K1: 72 or 360 parts at one tile) they
//     add with atomics into sums left zeroed, which the last clears.
//     Chosen by time on an H100 (a diagnostic run): planes were faster at
//     the first (1.4 M atomics), atomics far faster at K1, where the last
//     block would add 72 planes.  Integer sums are exact in any order, so
//     the counts are bitwise the plain two-matmul version.
// Flags, tickets and the atomic count sums live in the int32 scratch per
// device and stream that every call leaves zeroed (kernels/gemm.py:
// scratch); the read's partial planes, the second read's outputs and the
// count planes in its float scratch, written before they are read.
//
// Gains (C_x, C_d) arrive as two device scalars: under update management
// they come from device-side maxima, and reading them on the host would
// stall.
//
// Bound on the H100: at LeNet's shapes the read (K2 with 13 devices per
// weight: 512 x 416 x 401 = 85 M FMAs, 2.5 us at 67 TFLOP/s) and the
// counts (the same 85 M device-slot pairs, exact on the int8 tensor cores
// at far below a microsecond) are small; the launch, the serial k-tile
// chain of a read block, the Box-Muller noise of its outputs and the
// stream hashes (each stream element once per device tile that uses it,
// what a slot or a column shares made once per round) bound it, at 7-50
// us on the device, below the host's enqueue of a call but at K2 with 13
// devices per weight.
#include "conv_patch.cuh"
#include "managed_gemm.cuh"
#include "pulse_stream.cuh"

namespace analog {

// Column-driver values x[row, n]: activations (dense) or patch elements
// (conv), as a row offset (row), a column (col) and the element (value).
struct DenseA {
  const float* x;
  int N;
  struct Col {
    int n, off;
  };
  __device__ __forceinline__ int row(int r) const { return r * N; }
  __device__ __forceinline__ Col col(int n) const { return Col{n, n}; }
  __device__ __forceinline__ float value(int xr, const Col& c) const {
    return __ldg(x + xr + c.off);
  }
};

struct ConvA {
  ConvGeomDev g;
  struct Col {
    int n, off;  // off -1: the bias column
  };
  __device__ __forceinline__ int row(int r) const { return patch_row(g, r); }
  __device__ __forceinline__ Col col(int n) const {
    return Col{n, patch_col(g, n)};
  }
  __device__ __forceinline__ float value(int xr, const Col& c) const {
    return c.off < 0 ? 1.0f : __ldg(g.xpad + xr + c.off);
  }
};

// Streams regenerated from the counter hash (a stream source of
// pulse_stream.cuh); slot q = row * BL + slot, counter base
// e = (row0 + row) * BL + slot.
template <class AV>
struct GenStreams {
  AV av;
  const float* d;  // (rows, M) replicated error; row drivers are -d
  int M, N, bl;
  uint32_t row0, seed_a_m, seed_b_m;
  float ga, gb;
  struct Slot {
    int row, xr;  // error row, its offset in the column drivers
    uint32_t e;
  };
  __device__ __forceinline__ Slot slot(int q) const {
    const int row = q / bl;
    return Slot{row, av.row(row),
                (row0 + (uint32_t)row) * (uint32_t)bl +
                    (uint32_t)(q - row * bl)};
  }
  __device__ __forceinline__ typename AV::Col col_a(int n) const {
    return av.col(n);
  }
  __device__ __forceinline__ int col_b(int i) const { return i; }
  __device__ __forceinline__ int a(const Slot& s,
                                   const typename AV::Col& c) const {
    return pulse(av.value(s.xr, c), ga, seed_a_m,
                 s.e * (uint32_t)N + (uint32_t)c.n);
  }
  __device__ __forceinline__ int b(const Slot& s, int i) const {
    return pulse(-__ldg(d + (size_t)s.row * M + i), gb, seed_b_m,
                 s.e * (uint32_t)M + (uint32_t)i);
  }
};

namespace fused {

constexpr int BM = 32, BN = 32, TM = 4, LD = BN + 1;  // LD: staged rows
using RT = gemm::Tile<BM, BN, false, true, gemm::DenseX, TM>;
constexpr int THREADS = RT::THREADS;  // 64: read and count blocks alike
using CL = CountLayout<THREADS>;
constexpr size_t cmax(size_t a, size_t b) { return a > b ? a : b; }
constexpr size_t SMEM = cmax(cmax(RT::SMEM, 2 * BM * LD * sizeof(float)),
                             STAGE_INTS * sizeof(int));

struct Args {
  // transpose read: x = delta (B, K = m_phys), out_dim = n_cols
  ReadArgs a;
  const float* nm;
  Seed seed1, seed2;  // the two reads'
  int two_phase;
  float retry_scale;
  float* z;
  uint8_t* residual;
  float* acc2;    // (B, n_cols) second reads (cross-block select)
  float* planes;  // (read_parts, B, n_cols) partial sums
  int* sat1;
  int* sat2;
  int* row_tickets;
  int* tile_tickets;
  int col_tiles, read_len, read_parts, read_blocks;
  // counts: up/dn (M, N) f32 outputs, sums (2, M, N) int32 scratch
  CountTile c;
  int* sums;     // (2, M, N), zeroed between calls
  int* cplanes;  // (slot_parts, 2, M, N) in the float scratch
  int* count_tickets;
  int slot_len, slot_parts, sum_planes;
  const float* gx;
  const float* gd;
  Seed seed_a, seed_b;  // the two streams'
  uint32_t row0;
  int bl;
};

// Read block bid: part bid % read_parts of tile bid / read_parts (the
// parts of a tile are dispatched together).
template <bool ONE>
__device__ __forceinline__ void read_block(const Args& p, float* smem,
                                           int bid) {
  const ReadArgs& a = p.a;
  const int part = bid % p.read_parts, tile = bid / p.read_parts;
  const int rt = tile / p.col_tiles;
  const int m0 = rt * BM, n0 = (tile - rt * p.col_tiles) * BN;
  const int tx = threadIdx.x % RT::TX, ty = threadIdx.x / RT::TX;
  const int cs = min(a.K, part * p.read_len), ce = min(a.K, cs + p.read_len);
  float acc[TM][TM];
  RT::segment(smem, a, m0, n0, cs, ce, acc);
  if (p.read_parts > 1) {
    const size_t plane = (size_t)a.B * a.out_dim;
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int m = m0 + RT::row(ty, i);
#pragma unroll
      for (int j = 0; j < TM; ++j) {
        const int col = n0 + RT::col(tx, j);
        if (m < a.B && col < a.out_dim)
          p.planes[part * plane + (size_t)m * a.out_dim + col] = acc[i][j];
      }
    }
    if (!gemm::last_block(p.tile_tickets + tile, p.read_parts)) return;
    if (threadIdx.x == 0) p.tile_tickets[tile] = 0;
    for (int q = 0; q < p.read_parts; ++q) {  // the parts in order
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const int m = m0 + RT::row(ty, i);
#pragma unroll
        for (int j = 0; j < TM; ++j) {
          const int col = n0 + RT::col(tx, j);
          if (m >= a.B || col >= a.out_dim) continue;
          const float t =
              __ldcg(p.planes + q * plane + (size_t)m * a.out_dim + col);
          acc[i][j] = q == 0 ? t : __fadd_rn(acc[i][j], t);
        }
      }
    }
  }
  // The sums to shared memory, then the managed values of the tile's valid
  // outputs spread over every thread (B = 8 fills a quarter of the rows).
  float* st1 = smem;            // sums, then the first reads
  float* st2 = smem + BM * LD;  // the second reads
  __shared__ int rowf[BM];      // bit 0: first read saturated; 1: second
  __syncthreads();              // every thread is done with the buffers
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TM; ++j)
      st1[RT::row(ty, i) * LD + RT::col(tx, j)] = acc[i][j];
  if (threadIdx.x < BM) rowf[threadIdx.x] = 0;
  __syncthreads();
  const int rows = min(BM, a.B - m0), cols = min(BN, a.out_dim - n0);
  const uint32_t seed1_m = p.seed1.mixed(), seed2_m = p.seed2.mixed();
#pragma unroll 2  // the draws of two outputs overlap
  for (int idx = threadIdx.x; idx < rows * cols; idx += THREADS) {
    const int r = idx / cols, c = idx - r * cols;
    const int m = m0 + r, col = n0 + c;
    const float s = p.nm[m];
    float y1 = 0.0f, y2 = 0.0f;
    bool b1 = false, b2 = false;
    managed_value<true>(a, st1[r * LD + c], s, seed1_m, seed2_m, p.two_phase,
                        p.retry_scale, counter(a, m, 0, col), y1, y2, b1,
                        b2);
    if (ONE) {
      st1[r * LD + c] = y1;
      st2[r * LD + c] = y2;
    } else {  // z as if no row saturated; the row tile's last block fixes
      const size_t i = (size_t)m * a.out_dim + col;
      p.z[i] = __fmul_rn(y1, s);
      if (p.two_phase) p.acc2[i] = y2;
    }
    if (b1 || b2) atomicOr(&rowf[r], (int)b1 | ((int)b2 << 1));
  }
  __syncthreads();
  if (ONE) {  // the block holds every column: its flags are the rows'
    for (int idx = threadIdx.x; idx < rows * cols; idx += THREADS) {
      const int r = idx / cols, c = idx - r * cols, m = m0 + r;
      const float s = p.nm[m];
      p.z[(size_t)m * a.out_dim + n0 + c] =
          p.two_phase && (rowf[r] & 1)
              ? __fmul_rn(__fmul_rn(st2[r * LD + c], p.retry_scale), s)
              : __fmul_rn(st1[r * LD + c], s);
    }
    for (int r = threadIdx.x; r < rows; r += THREADS)
      p.residual[m0 + r] = p.two_phase ? rowf[r] == 3 : (rowf[r] & 1);
    return;
  }
  for (int r = threadIdx.x; r < rows; r += THREADS) {
    if (rowf[r] & 1) atomicOr(&p.sat1[m0 + r], 1);
    if (rowf[r] & 2) atomicOr(&p.sat2[m0 + r], 1);
  }
  if (!gemm::last_block(p.row_tickets + rt, p.col_tiles)) return;
  // the row tile's last block: flags, residual, then the selected rows
  for (int r = threadIdx.x; r < rows; r += THREADS) {
    const int r1 = __ldcg(p.sat1 + m0 + r), r2 = __ldcg(p.sat2 + m0 + r);
    rowf[r] = p.two_phase && r1;
    p.residual[m0 + r] = p.two_phase ? (r1 && r2) : (r1 != 0);
    p.sat1[m0 + r] = 0;
    p.sat2[m0 + r] = 0;
  }
  if (threadIdx.x == 0) p.row_tickets[rt] = 0;
  __syncthreads();
  for (int r = 0; r < rows; ++r) {
    if (!rowf[r]) continue;  // block-uniform
    const int m = m0 + r;
    const float s = p.nm[m];
    const size_t row = (size_t)m * a.out_dim;
#pragma unroll 4
    for (int col = threadIdx.x; col < a.out_dim; col += THREADS)
      p.z[row + col] = __fmul_rn(
          __fmul_rn(__ldcg(p.acc2 + row + col), p.retry_scale), s);
  }
}

// Count block bid: slot part bid % slot_parts of device tile bid /
// slot_parts.
template <class AV>
__device__ __forceinline__ void count_part(const Args& p, const AV& av,
                                           int* stage, int bid) {
  const CountTile& c = p.c;
  const int part = bid % p.slot_parts, tile = bid / p.slot_parts;
  const int m0 = (tile / c.tiles_n) * CT, n0 = (tile % c.tiles_n) * CT;
  const int q0 = part * p.slot_len, q1 = min(c.T, q0 + p.slot_len);
  const GenStreams<AV> src{av,          p.a.x,          c.M,
                           c.N,         p.bl,           p.row0,
                           p.seed_a.mixed(), p.seed_b.mixed(), __ldg(p.gx),
                           __ldg(p.gd)};
  int up[CL::DM][4], dn[CL::DM][4];
  count_range<THREADS>(c, src, m0, n0, q0, q1, stage, up, dn);
  const int mr = m0 + CL::row0(), nc = n0 + CL::col0();
  const size_t plane = (size_t)c.M * c.N;
  if (p.slot_parts > 1) {
#pragma unroll
    for (int i = 0; i < CL::DM; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (mr + i >= c.M || nc + j >= c.N) continue;
        const size_t idx = (size_t)(mr + i) * c.N + nc + j;
        if (p.sum_planes) {  // this part's plane
          p.cplanes[part * 2 * plane + idx] = up[i][j];
          p.cplanes[part * 2 * plane + plane + idx] = dn[i][j];
        } else {
          if (up[i][j]) atomicAdd(p.sums + idx, up[i][j]);
          if (dn[i][j]) atomicAdd(p.sums + plane + idx, dn[i][j]);
        }
      }
    if (!gemm::last_block(p.count_tickets + tile, p.slot_parts)) return;
    if (threadIdx.x == 0) p.count_tickets[tile] = 0;
  }
#pragma unroll
  for (int i = 0; i < CL::DM; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (mr + i >= c.M || nc + j >= c.N) continue;
      const size_t idx = (size_t)(mr + i) * c.N + nc + j;
      if (p.slot_parts > 1 && p.sum_planes) {  // the planes in order
        up[i][j] = dn[i][j] = 0;
        for (int q = 0; q < p.slot_parts; ++q) {
          up[i][j] += __ldcg(p.cplanes + q * 2 * plane + idx);
          dn[i][j] += __ldcg(p.cplanes + q * 2 * plane + plane + idx);
        }
      } else if (p.slot_parts > 1) {  // this thread's own devices: clear
        up[i][j] = __ldcg(p.sums + idx);
        dn[i][j] = __ldcg(p.sums + plane + idx);
        p.sums[idx] = 0;
        p.sums[plane + idx] = 0;
      }
      c.up[idx] = (float)up[i][j];
      c.dn[idx] = (float)dn[i][j];
    }
}

template <class AV, bool ONE>
__global__ void __launch_bounds__(THREADS) kernel(Args p, AV av) {
  extern __shared__ __align__(16) float smem[];
  if ((int)blockIdx.x < p.read_blocks) {  // block-uniform branch
    read_block<ONE>(p, smem, blockIdx.x);
    return;
  }
  count_part(p, av, reinterpret_cast<int*>(smem),
             blockIdx.x - p.read_blocks);
}

}  // namespace fused

// The plan (one: the read block holds every column; read_len: the depth of
// a contraction part, a multiple of 16; slot_len: the stream slots of a
// count part; sum_planes: the parts' counts meet in planes, else in
// atomic sums) comes from the wrapper's plan().  Scratch: flags, int32
// [sat1[B], sat2[B], a ticket per row tile, per read tile and per device
// tile, the count sums (2, m_phys, n_cols)], zero on entry and left zero;
// part, f32 [the second reads (B, n_cols) when two_phase and not one, the
// partial planes (read parts, B, n_cols), the int32 count planes
// (slot parts, 2, m_phys, n_cols) with sum_planes], written before read.
template <class AV>
int launch(const float* w, const float* d, AV av, const float* nm,
           const float* gx, const float* gd, float* z, uint8_t* residual,
           float* counts, int* flags, float* part, int B, int m_phys,
           int n_cols, int bl, float sigma, float alpha, int has_alpha,
           Seed rseed1, Seed rseed2, int two_phase, float retry_scale,
           Seed seed_a, Seed seed_b, unsigned row0, int one, int read_len,
           int slot_len, int sum_planes, cudaStream_t s) {
  using fused::BM;
  using fused::BN;
  if (B < 0 || m_phys <= 0 || n_cols <= 0 || bl <= 0 || read_len <= 0 ||
      read_len % 16 != 0 || slot_len <= 0 || (one && n_cols > BN) || !flags ||
      !part)
    return static_cast<int>(cudaErrorInvalidValue);
  fused::Args p{};
  p.a = ReadArgs{w,      d,         B,     m_phys, n_cols,
                 1,      m_phys,    1,     sigma,  alpha,
                 has_alpha, 0u, (uint32_t)B * (uint32_t)n_cols};
  p.nm = nm;
  p.seed1 = rseed1;
  p.seed2 = rseed2;
  p.two_phase = two_phase;
  p.retry_scale = retry_scale;
  p.z = z;
  p.residual = residual;
  const int row_tiles = (B + BM - 1) / BM;
  p.col_tiles = (n_cols + BN - 1) / BN;
  p.read_len = read_len;
  p.read_parts = (m_phys + read_len - 1) / read_len;
  p.read_blocks = row_tiles * p.col_tiles * p.read_parts;
  p.c = make_count_tile(m_phys, n_cols, B * bl, counts,
                        counts + (size_t)m_phys * n_cols);
  const int count_tiles = p.c.tiles_m * p.c.tiles_n;
  p.slot_len = slot_len;
  p.slot_parts = p.c.T > slot_len ? (p.c.T + slot_len - 1) / slot_len : 1;
  p.sum_planes = sum_planes;
  p.sat1 = flags;
  p.sat2 = flags + B;
  p.row_tickets = flags + 2 * B;
  p.tile_tickets = p.row_tickets + row_tiles;
  p.count_tickets = p.tile_tickets + row_tiles * p.col_tiles;
  p.sums = p.count_tickets + count_tiles;
  p.acc2 = part;
  p.planes = part + (two_phase && !one ? (size_t)B * n_cols : 0);
  p.cplanes = reinterpret_cast<int*>(
      p.planes + (p.read_parts > 1 ? (size_t)p.read_parts * B * n_cols : 0));
  p.gx = gx;
  p.gd = gd;
  p.seed_a = seed_a;
  p.seed_b = seed_b;
  p.row0 = row0;
  p.bl = bl;
  const int grid = p.read_blocks + count_tiles * p.slot_parts;
  if (one)
    fused::kernel<AV, true><<<grid, fused::THREADS, fused::SMEM, s>>>(p, av);
  else
    fused::kernel<AV, false><<<grid, fused::THREADS, fused::SMEM, s>>>(p, av);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace analog

// Dense entry.  w (m_phys, n_cols), d (B, m_phys) replicated error, x (B,
// n_cols) activations, nm (B,) NM scale of d, gx/gd the device scalars C_x
// and C_d.  Outputs: z (B, n_cols) on physical columns, residual (B,)
// bytes, counts (2, m_phys, n_cols) f32 (up, dn).  The *_at pointers: the
// two read seeds and the two stream seeds in device memory (null: the
// value arguments), as managed_mvm_launch takes them.
extern "C" int bwd_update_dense_launch(
    const float* w, const float* d, const float* x, const float* nm,
    const float* gx, const float* gd, float* z, uint8_t* residual,
    float* counts, int* flags, float* part, int B, int m_phys, int n_cols,
    int bl, float sigma, float alpha, int has_alpha, unsigned rseed1,
    unsigned rseed2, int two_phase, float retry_scale, unsigned seed_a,
    unsigned seed_b, unsigned row0, int one, int read_len, int slot_len,
    int sum_planes, const unsigned long long* rseed1_at,
    const unsigned long long* rseed2_at, const unsigned long long* seed_a_at,
    const unsigned long long* seed_b_at, void* stream) {
  return analog::launch(w, d, analog::DenseA{x, n_cols}, nm, gx, gd, z,
                        residual, counts, flags, part, B, m_phys, n_cols, bl,
                        sigma, alpha, has_alpha, {rseed1, rseed1_at},
                        {rseed2, rseed2_at}, two_phase, retry_scale,
                        {seed_a, seed_a_at}, {seed_b, seed_b_at}, row0, one,
                        read_len, slot_len, sum_planes,
                        static_cast<cudaStream_t>(stream));
}

// Conv entry.  As the dense entry with B = P positions (B*OH*OW), d the
// replicated position errors (P, m_phys), and the column drivers the patch
// elements of xpad (B, H, W, C) under geom (host ints: B, H, W, C, kh, kw,
// sh, sw, dh, dw, oh, ow, bias); n_cols = C*kh*kw (+1 bias).
extern "C" int bwd_update_conv_launch(
    const float* w, const float* d, const float* xpad, const int* geom,
    const float* nm, const float* gx, const float* gd, float* z,
    uint8_t* residual, float* counts, int* flags, float* part, int m_phys,
    int bl, float sigma, float alpha, int has_alpha, unsigned rseed1,
    unsigned rseed2, int two_phase, float retry_scale, unsigned seed_a,
    unsigned seed_b, int one, int read_len, int slot_len, int sum_planes,
    const unsigned long long* rseed1_at, const unsigned long long* rseed2_at,
    const unsigned long long* seed_a_at, const unsigned long long* seed_b_at,
    void* stream) {
  return analog::launch(w, d, analog::ConvA{analog::conv_geom(xpad, geom)},
                        nm, gx, gd, z, residual, counts, flags, part,
                        analog::conv_positions(geom), m_phys,
                        analog::conv_cols(geom), bl, sigma, alpha, has_alpha,
                        {rseed1, rseed1_at}, {rseed2, rseed2_at}, two_phase,
                        retry_scale, {seed_a, seed_a_at}, {seed_b, seed_b_at},
                        0u, one, read_len, slot_len, sum_planes,
                        static_cast<cudaStream_t>(stream));
}
