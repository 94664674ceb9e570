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
// no order, so the one grid holds two kinds of block: read blocks (the 64 x
// 64 tiles of the transpose read) and count blocks (a 32 x 32 device tile x
// 256 stream slots each, int32 counts in registers added to the f32 outputs
// with atomics).  Atomics over integer-valued f32 are exact below 2^24 in
// any order, so the counts are bitwise the plain two-matmul version while
// the read and count blocks run side by side; the T split keeps K1's single
// 16 x 26 device tile from serialising 4608 position rows in one block.  The
// read's select/average epilogue is a second, small launch.
//
// Gains (C_x, C_d) arrive as a device pointer: under update management they
// come from device-side maxima, and reading them on the host would stall.
//
// Bound on the H100: at LeNet's shapes the read (<= 0.3 MFMA) and the
// stream hashes (K1: 4608 x 42 per slot) are far below a microsecond of the
// card's rate; the launches (main + epilogue) bound it.
#include "conv_patch.cuh"
#include "managed_read.cuh"
#include "pulse_stream.cuh"

namespace analog {

// Column-driver values: activations (dense) or patch elements (conv).
struct DenseA {
  const float* x;
  int N;
  __device__ __forceinline__ float operator()(int row, int n) const {
    return __ldg(x + (size_t)row * N + n);
  }
};

struct ConvA {
  ConvGeomDev g;
  __device__ __forceinline__ float operator()(int row, int n) const {
    return patch_value(g, row, n);
  }
};

// Streams regenerated from the counter hash; slot q = row * BL + slot.
template <class AV>
struct GenStreams {
  AV av;
  const float* d;  // (rows, M) replicated error; row drivers are -d
  int M, N, bl;
  uint32_t row0, seed_a_m, seed_b_m;
  float ga, gb;
  __device__ __forceinline__ uint32_t base(int q) const {
    const int row = q / bl;
    return (row0 + (uint32_t)row) * (uint32_t)bl + (uint32_t)(q - row * bl);
  }
  __device__ __forceinline__ int a(int q, int n) const {
    return pulse(av(q / bl, n), ga, seed_a_m,
                 base(q) * (uint32_t)N + (uint32_t)n);
  }
  __device__ __forceinline__ int b(int q, int i) const {
    return pulse(-__ldg(d + (size_t)(q / bl) * M + i), gb, seed_b_m,
                 base(q) * (uint32_t)M + (uint32_t)i);
  }
};

template <class AV>
__global__ void __launch_bounds__(THREADS)
    bwd_update_kernel(ReadArgs a, const float* __restrict__ nm,
                      uint32_t rseed1, uint32_t rseed2, int two_phase,
                      float retry_scale, float* __restrict__ acc1,
                      float* __restrict__ acc2, int* __restrict__ sat1,
                      int* __restrict__ sat2, int read_tiles_n,
                      int read_blocks, CountTile c, AV av,
                      const float* __restrict__ gains, uint32_t seed_a,
                      uint32_t seed_b, uint32_t row0, int bl) {
  if ((int)blockIdx.x < read_blocks) {  // block-uniform branch
    __shared__ Smem sm;
    const int bx = blockIdx.x % read_tiles_n, by = blockIdx.x / read_tiles_n;
    managed_tile_block(sm, a, nm, mix32(rseed1), mix32(rseed2),
                       two_phase, retry_scale, acc1, acc2, sat1, sat2,
                       by * BM, bx * BN);
    return;
  }
  const GenStreams<AV> src{av,   a.x,  c.M,          c.N,          bl,
                           row0, mix32(seed_a), mix32(seed_b), gains[0],
                           gains[1]};
  count_block(c, src, blockIdx.x - read_blocks);
}

template <class AV>
int launch(const float* w, const float* d, AV av, const float* nm,
           const float* gains, float* z, int* residual, float* acc1,
           float* acc2, int* sat1, int* sat2, float* up, float* dn, int B,
           int m_phys, int n_cols, int bl, float sigma, float alpha,
           int has_alpha, unsigned rseed1, unsigned rseed2, int two_phase,
           float retry_scale, unsigned seed_a, unsigned seed_b, unsigned row0,
           cudaStream_t s) {
  cudaMemsetAsync(sat1, 0, sizeof(int) * (size_t)B, s);
  cudaMemsetAsync(sat2, 0, sizeof(int) * (size_t)B, s);
  cudaMemsetAsync(up, 0, sizeof(float) * (size_t)m_phys * n_cols, s);
  cudaMemsetAsync(dn, 0, sizeof(float) * (size_t)m_phys * n_cols, s);
  // transpose read: contraction over the m_phys rows, one segment
  const ReadArgs a{w,     d,     B,         m_phys, n_cols, 1,
                   m_phys, 1,    sigma,     alpha,  has_alpha,
                   0u,    (uint32_t)B * (uint32_t)n_cols};
  const int read_tiles_n = (n_cols + BN - 1) / BN;
  const int read_blocks = read_tiles_n * ((B + BM - 1) / BM);
  const CountTile c = make_count_tile(m_phys, n_cols, B * bl, up, dn);
  bwd_update_kernel<AV><<<read_blocks + count_blocks(c), THREADS, 0, s>>>(
      a, nm, rseed1, rseed2, two_phase, retry_scale, acc1, acc2, sat1, sat2,
      read_tiles_n, read_blocks, c, av, gains, seed_a, seed_b, row0, bl);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  launch_managed_epilogue(acc1, acc2, sat1, sat2, nm, z, residual, B, n_cols,
                          1, two_phase, retry_scale, s);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace analog

// Dense entry.  w (m_phys, n_cols), d (B, m_phys) replicated error, x (B,
// n_cols) activations, nm (B,) NM scale of d, gains (2,) device (C_x, C_d).
// Outputs: z (B, n_cols) on physical columns, residual (B,) int32, up/dn
// (m_phys, n_cols) f32 counts.  Scratch: acc1/acc2 (B, n_cols) f32 (acc2 may
// alias acc1 when two_phase is 0), sat1/sat2 (B,) int32.
extern "C" int bwd_update_dense_launch(
    const float* w, const float* d, const float* x, const float* nm,
    const float* gains, float* z, int* residual, float* acc1, float* acc2,
    int* sat1, int* sat2, float* up, float* dn, int B, int m_phys,
    int n_cols, int bl, float sigma, float alpha, int has_alpha,
    unsigned rseed1, unsigned rseed2, int two_phase, float retry_scale,
    unsigned seed_a, unsigned seed_b, unsigned row0, void* stream) {
  return analog::launch(w, d, analog::DenseA{x, n_cols}, nm, gains, z,
                        residual, acc1, acc2, sat1, sat2, up, dn, B, m_phys,
                        n_cols, bl, sigma, alpha, has_alpha, rseed1, rseed2,
                        two_phase, retry_scale, seed_a, seed_b, row0,
                        static_cast<cudaStream_t>(stream));
}

// Conv entry.  As the dense entry with B = P positions (B*OH*OW), d the
// replicated position errors (P, m_phys), and the column drivers the patch
// elements of xpad (B, H, W, C) under geom (host ints: B, H, W, C, kh, kw,
// sh, sw, dh, dw, oh, ow, bias); n_cols = C*kh*kw (+1 bias).
extern "C" int bwd_update_conv_launch(
    const float* w, const float* d, const float* xpad, const int* geom,
    const float* nm, const float* gains, float* z, int* residual,
    float* acc1, float* acc2, int* sat1, int* sat2, float* up, float* dn,
    int m_phys, int bl, float sigma, float alpha, int has_alpha,
    unsigned rseed1, unsigned rseed2, int two_phase, float retry_scale,
    unsigned seed_a, unsigned seed_b, void* stream) {
  return analog::launch(w, d, analog::ConvA{analog::conv_geom(xpad, geom)},
                        nm, gains, z, residual, acc1, acc2, sat1, sat2, up,
                        dn, analog::conv_positions(geom), m_phys,
                        analog::conv_cols(geom), bl, sigma, alpha, has_alpha,
                        rseed1, rseed2, two_phase, retry_scale, seed_a,
                        seed_b, 0u, static_cast<cudaStream_t>(stream));
}
