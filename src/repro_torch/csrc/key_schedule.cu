// key_schedule: every threefry key and read/stream seed of one training or
// evaluation step, derived on the card from the step counter in one launch.
//
// Not a port of a TPU kernel: the port's counterpart of the threefry that
// XLA runs inside the JAX package's jitted epoch (src/repro/train/engine.py,
// fold_in_keys at :53 and the split/fold_in tree under each step key).  A
// CUDA graph fixes its kernels' arguments when it is captured, so the seeds
// of a replayed step are read from device memory (the seed table below)
// and not passed by value.
//
// The tape (utils/prng.py KeyTape) is the step's key tree, recorded once
// per step function: op i derives slot i + 1 as
//     key[i + 1] = threefry2x32(key[parent[i]], (0, data[i]))
// (jax.random.split(k, n)[j] and fold_in(k, j) are both that block at
// counter (0, j) in threefry's partitionable mode), from the root
//     key[0] = threefry2x32(base, (0, counter))     (fold_in(base, counter))
// with counter the device step counter (epoch * steps_per_epoch + step, or
// an evaluation batch's first image).  Seed j is key_to_seed of slot
// seed_slot[j]: mix(mix(k0) ^ k1) (utils/fastrng.py).  Ops run level by
// level (level[i] = the op's depth below the root), one thread per op of a
// level: the LeNet step's tree is 44 ops in 3 levels with 28 seeds.  The
// keys live in shared memory while they fit in its 48 KB (6144 slots);
// a larger tree (an LM step whose SSD projections read once per position:
// ~47k ops in 16 levels) derives them in the output table in device
// memory, each level's writes made visible to the next by the barrier.
//
// Outputs: keys (n_ops + 1, 2) and seeds (n_seeds,) as zero-extended u32
// words in 64-bit entries (int64 tensors on the torch side).
// Bound: neither bytes (about 2 KB) nor operations (about 4000 integer
// operations): the chain of 3 x 20 dependent rounds and the launch set the
// time, a few microseconds on the device.
#include <cstdint>
#include <cuda_runtime.h>

#include "analog_read.cuh"

namespace keys {

constexpr int THREADS = 128;

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

// Threefry-2x32, 20 rounds, on the counter pair (x0, x1).
__device__ __forceinline__ uint2 threefry2x32(uint32_t k0, uint32_t k1,
                                              uint32_t x0, uint32_t x1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  x0 += ks[0];
  x1 += ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x0 += x1;
      x1 = rotl(x1, rot[i & 1][j]) ^ x0;
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + static_cast<uint32_t>(i + 1);
  }
  return make_uint2(x0, x1);
}

// The slots: in shared memory (kShared) or in the output table itself.
template <bool kShared>
struct Slots {
  uint2* smem;
  unsigned long long* table;
  __device__ __forceinline__ uint2 get(int s) const {
    if (kShared) return smem[s];
    return make_uint2(static_cast<uint32_t>(table[2 * s]),
                      static_cast<uint32_t>(table[2 * s + 1]));
  }
  __device__ __forceinline__ void set(int s, uint2 k) const {
    if (kShared) {
      smem[s] = k;
    } else {
      table[2 * s] = k.x;
      table[2 * s + 1] = k.y;
    }
  }
};

template <bool kShared>
__global__ void __launch_bounds__(THREADS) key_schedule_kernel(
    const long long* __restrict__ base, const long long* __restrict__ counter,
    const int* __restrict__ parent, const unsigned* __restrict__ data,
    const int* __restrict__ level, int n_ops, int n_levels,
    const int* __restrict__ seed_slot, int n_seeds,
    unsigned long long* keys_out, unsigned long long* __restrict__ seeds_out) {
  extern __shared__ uint2 smem[];  // n_ops + 1 slots when kShared
  const Slots<kShared> key{smem, keys_out};
  if (threadIdx.x == 0)
    key.set(0, threefry2x32(static_cast<uint32_t>(base[0]),
                            static_cast<uint32_t>(base[1]), 0u,
                            static_cast<uint32_t>(*counter)));
  __syncthreads();
  for (int l = 1; l <= n_levels; ++l) {
    for (int i = threadIdx.x; i < n_ops; i += THREADS)
      if (level[i] == l) {
        const uint2 k = key.get(parent[i]);
        key.set(i + 1, threefry2x32(k.x, k.y, 0u, data[i]));
      }
    __syncthreads();
  }
  if (kShared)
    for (int i = threadIdx.x; i <= n_ops; i += THREADS) {
      keys_out[2 * i] = smem[i].x;
      keys_out[2 * i + 1] = smem[i].y;
    }
  for (int j = threadIdx.x; j < n_seeds; j += THREADS) {
    const uint2 k = key.get(seed_slot[j]);
    seeds_out[j] = analog::mix32(analog::mix32(k.x) ^ k.y);
  }
}

}  // namespace keys

// base (2,) and counter (0-d) int64 on the device; the tape (parent, data,
// level: n_ops int32 each; seed_slot: n_seeds int32) on the device; keys
// (n_ops + 1, 2) and seeds (n_seeds,) int64 outputs.  One block.
extern "C" int key_schedule_launch(const long long* base,
                                   const long long* counter, const int* parent,
                                   const unsigned* data, const int* level,
                                   int n_ops, int n_levels,
                                   const int* seed_slot, int n_seeds,
                                   unsigned long long* keys,
                                   unsigned long long* seeds, void* stream) {
  if (n_ops < 0 || n_seeds < 0 || n_levels < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(uint2) * (static_cast<size_t>(n_ops) + 1);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (smem <= 48 * 1024)
    keys::key_schedule_kernel<true><<<1, keys::THREADS, smem, s>>>(
        base, counter, parent, data, level, n_ops, n_levels, seed_slot,
        n_seeds, keys, seeds);
  else
    keys::key_schedule_kernel<false><<<1, keys::THREADS, 0, s>>>(
        base, counter, parent, data, level, n_ops, n_levels, seed_slot,
        n_seeds, keys, seeds);
  return static_cast<int>(cudaGetLastError());
}
