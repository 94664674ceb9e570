// pulse_counts: the update cycle's coincidence counts on Hopper.
//
// Replaces the TPU kernel pulse_counts_pallas (src/repro/kernels/
// pulse_update.py:112, pallas_call at :136):
//     count_up = (|B|^T |A| + B^T A) / 2,  count_dn = (|B|^T |A| - B^T A) / 2
// for signed pulse streams B (T, M) of the row drivers and A (T, N) of the
// column drivers, sampled digitally by update.sample_signed_streams.
//
// The TPU kernel runs two MXU matmuls per (bm, bn) tile with the T axis
// innermost and carries both f32 count tiles in VMEM across it.  Hopper
// blocks run in no order and the counts are exact integers, so here each
// block owns a 32 x 32 device tile and 256 of the T slots, counts
// coincidences in int32 registers from int8 copies of the streams in shared
// memory (four slots per __dp4a), and adds its totals to the outputs with
// f32 atomics: exact below 2^24 in any order, so bitwise the plain
// two-matmul version (pulse_stream.cuh).
//
// Bound on the H100: the bytes of the two f32 stream matrices (LeNet's K1 at
// BL = 10: 46080 x (16 + 26) x 4 = 7.7 MB, 2.3 us at 3.35 TB/s); at BL = 1
// every LeNet layer is below one launch's few microseconds.  Splitting T
// over blocks keeps the card busy when M x N is one tile (K1: 16 x 26).
#include "pulse_stream.cuh"

namespace analog {

__global__ void __launch_bounds__(COUNT_THREADS)
    pulse_counts_kernel(CountTile c, MemStreams src) {
  count_block(c, src, blockIdx.x);
}

}  // namespace analog

// rows (T, M) and cols (T, N) f32 in {0, +1, -1}; up/dn (M, N) f32 outputs,
// zeroed here unless accumulate is set (then the counts add to what they
// hold: a streaming update's later chunks, exact as the blocks' atomics).
extern "C" int pulse_counts_launch(const float* rows, const float* cols,
                                   float* up, float* dn, int T, int M, int N,
                                   int accumulate, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!accumulate) {
    cudaMemsetAsync(up, 0, sizeof(float) * (size_t)M * N, s);
    cudaMemsetAsync(dn, 0, sizeof(float) * (size_t)M * N, s);
  }
  const analog::CountTile c = analog::make_count_tile(M, N, T, up, dn);
  const int blocks = analog::count_blocks(c);
  if (blocks > 0)
    analog::pulse_counts_kernel<<<blocks, analog::COUNT_THREADS, 0, s>>>(
        c, analog::MemStreams{rows, cols, M, N});
  return static_cast<int>(cudaGetLastError());
}
