// conv_mvm: the implicit-im2col managed conv read on Hopper (kernel #3).
//
// Replaces the TPU kernel conv_managed_mvm_pallas (src/repro/kernels/
// conv_mvm.py:157, pallas_call at :198): the forward read of a conv layer's
// crossbar, y[pos] = managed_read(W, patch[pos]) for every output position
// of every image, with NM scale, two-phase BM, clip and the #_d replica
// average (managed_read.cuh).
//
// The TPU kernel pulls one image into VMEM, assembles its patch tile from
// kh*kw strided tap slices and contracts it against a tap-major copy of W.
// Here #2's SIMT tile (managed_gemm.cuh, IEEE FMAs) runs over the flattened
// position axis (img * OH*OW + pos) with the loader ConvX (conv_patch.cuh),
// which builds each patch element by index from xpad while it loads the
// k-tile, so the patch matrix never exists in device memory, and W is read
// in its channel-major layout directly (no tap-major copy: the layout was a
// TPU choice, and the noise counters do not depend on it).  Noise counters
// are (img * P + pos) * out_phys + o, n_total = B*P*out_phys: those of the
// materialized column matrix read by managed_mvm.
//
// Every read is ONE launch with no memset.  Each thread owns 4 x 4 outputs
// (not #2's 8 x 8): the reads are small, and each output costs two
// Box-Muller draws, so more and shorter threads finish sooner.  The tile's
// width follows the physical outputs (64x16 for K1's 16, 32x32 for K2's
// 32), so no column block is mostly padding.  A long contraction (K2: 401)
// is split into ordered parts, blocks of their own that write partial sums
// to planes; the last part of a tile to finish (a ticket per tile) adds the
// planes in order and reads on, so the chain of k-tiles each thread walks
// is short.  Where one block holds every
// physical column of its rows (up to 64), it stages both reads of its
// outputs in shared memory, ORs the row flags there and runs the select /
// rescale / #_d average / residual itself.  Wider arrays (K2 with 13
// devices per weight: 416, 13 column blocks of 32) write both reads to
// partials and OR the row flags into a scratch per device and stream left
// zeroed; the last block of each row block (a ticket per row block) runs
// the select for those rows and clears their flags and its ticket.
//
// Bound on the H100: at LeNet's shapes the work is tiny (K1: 4608 x 26 x 16,
// K2: 512 x 401 x 32 or x 416 FMAs per read, 0.06-0.3 us of fp32 FMA or of
// bytes), so the launch, the k-tile chain of one thread (K2: 26 k-tiles of
// 16 x 16 FMAs) and the noise of its 16 outputs bound it.
#include "conv_patch.cuh"
#include "managed_gemm.cuh"

namespace analog {
namespace gemm {

// Outputs per thread along each side, and x chunks per thread and k-tile
// of a BM x BN tile.
constexpr int CONV_TM = 4;
template <int BM, int BN>
__host__ __device__ constexpr int conv_nx() {
  return (BM * 16 / 4) / ((BM / CONV_TM) * (BN / CONV_TM));
}

// One BM x BN tile (blockIdx.y: column tile, blockIdx.z: row tile) of one
// part (blockIdx.x) of the contraction.  ONE: the block holds every
// physical column of its rows (out_dim <= BN).  pp: (parts, B, out_dim)
// partial planes when gridDim.x > 1; tile_tickets: one per tile;
// row_tickets: one per row tile (cross-block select).
template <int BM, int BN, bool ONE>
__global__ void __launch_bounds__((BM / CONV_TM) * (BN / CONV_TM))
    conv_read_kernel(ReadArgs a, ConvGeomDev g, const float* __restrict__ nm,
                     Seed seed1, Seed seed2, int two_phase,
                     float retry_scale, int d_avg, float* __restrict__ y,
                     uint8_t* __restrict__ residual, float* acc1,
                     float* acc2, float* pp, int* sat1, int* sat2,
                     int* row_tickets, int* tile_tickets) {
  constexpr int TM = CONV_TM;
  using X = ConvX<conv_nx<BM, BN>()>;
  using T = Tile<BM, BN, false, false, X, TM>;
  static_assert(conv_nx<BM, BN>() == T::NX, "loader rows");
  constexpr int LD = BN + 1;  // staged row length
  extern __shared__ __align__(16) float smem[];
  __shared__ int rowf[ONE ? BM : 1];  // bit 0: first read saturated; 1: 2nd
  const int m0 = blockIdx.z * BM, n0 = blockIdx.y * BN;
  const int tx = threadIdx.x % T::TX, ty = threadIdx.x / T::TX;
  const int parts = gridDim.x;
  const int len = ((a.K + parts - 1) / parts + T::BK - 1) & ~(T::BK - 1);
  const int cs = min(a.K, (int)blockIdx.x * len), ce = min(a.K, cs + len);
  float acc[TM][TM];
  T::segment(smem, a, m0, n0, cs, ce, acc, X(g, a.B, m0, T::THREADS));
  if (parts > 1) {
    const size_t plane = (size_t)a.B * a.out_dim;
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int m = m0 + T::row(ty, i);
#pragma unroll
      for (int j = 0; j < TM; ++j) {
        const int col = n0 + T::col(tx, j);
        if (m < a.B && col < a.out_dim)
          pp[blockIdx.x * plane + (size_t)m * a.out_dim + col] = acc[i][j];
      }
    }
    const int tile = blockIdx.z * gridDim.y + blockIdx.y;
    if (!last_block(tile_tickets + tile, parts)) return;
    if (threadIdx.x == 0) tile_tickets[tile] = 0;
    for (int q = 0; q < parts; ++q) {  // the parts in order
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const int m = m0 + T::row(ty, i);
#pragma unroll
        for (int j = 0; j < TM; ++j) {
          const int col = n0 + T::col(tx, j);
          if (m >= a.B || col >= a.out_dim) continue;
          const float t = __ldcg(pp + q * plane + (size_t)m * a.out_dim + col);
          acc[i][j] = q == 0 ? t : __fadd_rn(acc[i][j], t);
        }
      }
    }
  }
  const uint32_t seed1_m = seed1.mixed(), seed2_m = seed2.mixed();
  const int out_f = a.out_dim / d_avg;
  float* st1 = smem;
  float* st2 = smem + BM * LD;
  if (ONE) __syncthreads();  // every thread is done with the buffers
  uint32_t f1 = 0, f2 = 0;   // bit i: owned row i saturated
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = T::row(ty, i), m = m0 + r;
    if (m >= a.B) continue;
    const float s = nm[m];
#pragma unroll
    for (int j = 0; j < TM; ++j) {
      const int col = n0 + T::col(tx, j);
      if (col >= a.out_dim) continue;
      float y1 = 0.0f, y2 = 0.0f;
      bool b1 = false, b2 = false;
      managed_value(a, acc[i][j], s, seed1_m, seed2_m, two_phase,
                    retry_scale, counter(a, m, 0, col), y1, y2, b1, b2);
      if (ONE) {
        st1[r * LD + col] = y1;
        st2[r * LD + col] = y2;
      } else {
        const size_t idx = (size_t)m * a.out_dim + col;
        acc1[idx] = y1;
        if (two_phase) acc2[idx] = y2;
      }
      f1 |= (uint32_t)b1 << i;
      f2 |= (uint32_t)b2 << i;
    }
  }
  // the TX threads of a row group are consecutive lanes: OR their flags
#pragma unroll
  for (int off = T::TX / 2; off > 0; off >>= 1) {
    f1 |= __shfl_xor_sync(0xffffffffu, f1, off);
    f2 |= __shfl_xor_sync(0xffffffffu, f2, off);
  }
  if (ONE) {
    if (tx == 0) {
#pragma unroll
      for (int i = 0; i < TM; ++i)
        rowf[T::row(ty, i)] = ((f1 >> i) & 1) | (((f2 >> i) & 1) << 1);
    }
    __syncthreads();
    for (int idx = threadIdx.x; idx < BM * out_f; idx += T::THREADS) {
      const int r = idx / out_f, j = idx - r * out_f, m = m0 + r;
      if (m >= a.B) break;  // rows ascend with idx
      const int fl = rowf[r];
      const bool sel = two_phase && (fl & 1);
      const float* st = (sel ? st2 : st1) + r * LD + j;
      const float s = nm[m];
      float sum = 0.0f;
      for (int rep = 0; rep < d_avg; ++rep) {
        const float t = st[rep * out_f];
        const float v = sel ? __fmul_rn(__fmul_rn(t, retry_scale), s)
                            : __fmul_rn(t, s);
        sum = rep == 0 ? v : __fadd_rn(sum, v);
      }
      y[(size_t)m * out_f + j] = d_avg > 1 ? __fdiv_rn(sum, (float)d_avg)
                                           : sum;
      if (j == 0) residual[m] = two_phase ? fl == 3 : (fl & 1);
    }
    return;
  }
  if (tx == 0) {
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int m = m0 + T::row(ty, i);
      if ((f1 >> i) & 1) atomicOr(&sat1[m], 1);
      if ((f2 >> i) & 1) atomicOr(&sat2[m], 1);
    }
  }
  if (!last_block(row_tickets + blockIdx.z, gridDim.y)) return;
  const int rows = min(BM, a.B - m0);
  select_rows(acc1, acc2, sat1, sat2, nm, y, residual, m0 + rows, out_f,
              d_avg, two_phase, retry_scale,
              (size_t)m0 * out_f + threadIdx.x, T::THREADS);
  __syncthreads();  // every thread has read the row flags
  for (int r = threadIdx.x; r < rows; r += T::THREADS) {
    sat1[m0 + r] = 0;
    sat2[m0 + r] = 0;
  }
  if (threadIdx.x == 0) row_tickets[blockIdx.z] = 0;
}

}  // namespace gemm
}  // namespace analog

namespace {

namespace g = analog::gemm;

struct Scratch {
  float *acc1, *acc2, *pp;
  int *sat1, *sat2, *row_tickets, *tile_tickets;
};

template <int BM, int BN, bool ONE>
int launch(const analog::ReadArgs& a, const analog::ConvGeomDev& geom,
           const float* nm, analog::Seed seed1, analog::Seed seed2,
           int two_phase, float retry_scale, int d_avg, float* y,
           uint8_t* residual, int parts, const Scratch& sc, cudaStream_t s) {
  if (ONE && a.out_dim > BN) return static_cast<int>(cudaErrorInvalidValue);
  using X = analog::ConvX<g::conv_nx<BM, BN>()>;
  using T = g::Tile<BM, BN, false, false, X, g::CONV_TM>;
  // the product's buffers, then both reads of the block's outputs staged
  constexpr size_t stage = ONE ? 2 * BM * (BN + 1) * sizeof(float) : 0;
  constexpr size_t smem = T::SMEM > stage ? T::SMEM : stage;
  auto kern = g::conv_read_kernel<BM, BN, ONE>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid(parts, (a.out_dim + BN - 1) / BN, (a.B + BM - 1) / BM);
  kern<<<grid, T::THREADS, smem, s>>>(
      a, geom, nm, seed1, seed2, two_phase, retry_scale, d_avg, y, residual,
      sc.acc1, sc.acc2, sc.pp, sc.sat1, sc.sat2, sc.row_tickets,
      sc.tile_tickets);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// w (out_phys, cols) channel-major, xpad (B, H, W, C), geom (host ints: B,
// H, W, C, kh, kw, sh, sw, dh, dw, oh, ow, bias), nm (P,) with P = B*OH*OW.
// Outputs: y (P, out_phys / d_avg) f32, residual (P,) bytes.  The plan
// (tile_m x tile_n; one: the block holds every physical column; parts of
// the contraction) comes from the wrapper's plan().  Scratch, used only
// when the plan needs it (not one, or parts > 1): part, f32 [acc1 (P,
// out_phys), acc2 (the same; when two_phase), the partial planes (parts,
// P, out_phys)], and flags, int32 [4 unused, sat1[P], sat2[P], a ticket per
// row tile, a ticket per tile], zero on entry and left zero on return.
// seed1_at/seed2_at: the read seeds in device memory (null: by value), as
// managed_mvm_launch takes them.
extern "C" int conv_managed_mvm_launch(
    const float* w, const float* xpad, const int* geom, const float* nm,
    float* y, uint8_t* residual, float* part, int* flags, int out_phys,
    int d_avg, float sigma, float alpha, int has_alpha, unsigned seed1,
    unsigned seed2, int two_phase, float retry_scale, int tile_m,
    int tile_n, int one, int parts, const unsigned long long* seed1_at,
    const unsigned long long* seed2_at, void* stream) {
  const int P = analog::conv_positions(geom);
  const int cols = analog::conv_cols(geom);
  if (P <= 0) return 0;
  if (d_avg <= 0 || out_phys % d_avg != 0 || parts < 1 || tile_m <= 0 ||
      tile_n <= 0 || ((!one || parts > 1) && (!part || !flags)))
    return static_cast<int>(cudaErrorInvalidValue);
  const analog::ReadArgs a{w,    nullptr,   P,     cols,  out_phys,
                           1,    cols,      0,     sigma, alpha,
                           has_alpha, 0u, (uint32_t)P * (uint32_t)out_phys};
  const analog::Seed s1{seed1, seed1_at}, s2{seed2, seed2_at};
  const analog::ConvGeomDev gd = analog::conv_geom(xpad, geom);
  const size_t n = (size_t)P * out_phys;
  const int row_tiles = (P + tile_m - 1) / tile_m;
  Scratch sc{};
  if (part) {
    sc.acc1 = part;
    sc.acc2 = two_phase ? part + n : part;
    sc.pp = part + (two_phase ? 2 : 1) * n;
    sc.sat1 = flags + 4;
    sc.sat2 = flags + 4 + P;
    sc.row_tickets = flags + 4 + 2 * P;
    sc.tile_tickets = flags + 4 + 2 * P + row_tiles;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define CONV_LAUNCH(BM, BN, ONE)                                             \
  if (tile_m == BM && tile_n == BN && one == ONE)                            \
    return launch<BM, BN, ONE>(a, gd, nm, s1, s2, two_phase,                 \
                               retry_scale, d_avg, y, residual, parts, sc, s);
  CONV_LAUNCH(64, 16, true)
  CONV_LAUNCH(32, 32, true)
  CONV_LAUNCH(64, 64, true)
  CONV_LAUNCH(32, 32, false)
#undef CONV_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}
