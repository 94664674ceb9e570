// flash_attention: online-softmax attention forward on Hopper.
//
// Replaces the TPU kernel flash_attention (src/repro/kernels/
// flash_attention.py:83, pallas_call at :111).  q (B, Sq, H, D), k and v
// (B, Sk, Hkv, D) with H a multiple of Hkv (query head h reads kv head
// h / (H / Hkv), as repeat_kv would lay it out), out (B, Sq, H, D) in q's
// dtype; float32 or bfloat16; D in {16, 32, 64, 128}.
//
// The TPU kernel walks (batch*head, q block, k block) with the k axis
// serial, carrying the running max, sum and f32 accumulator of a 128-row q
// block in VMEM.  Here one block of 256 threads owns 64 query rows of one
// (batch, head) and walks the key blocks in a loop: the loop takes the place
// of the serial grid axis, and the carried state lives in registers (4 rows
// per thread; a row's 16 threads are one half-warp).  Per key block of
// block_k keys (64 or 128: the TPU's softmax block, kept so that P rounds
// at the same running max): stage K in 64-key sub-tiles in shared memory as
// f32, scores S = (Q K^T) * scale with f32 FMAs, masks by absolute position
// (padding k >= Sk, causal q >= k, window q - k < window) to the finite
// NEG_INF = -1e30, m' = max(m, max S), P = exp(S - m'), l = l exp(m - m') +
// sum P, P rounded to V's dtype, then acc = acc exp(m - m') + P V with V
// staged the same way.  out = acc / max(l, 1e-30).
//
// Masked blocks: with the finite NEG_INF a row that has seen no valid key
// has m = -1e30 and takes every slot of the block at weight 1; its first
// valid key multiplies that by exp(-1e30 - m') = 0 exactly, and a row with
// no valid key at all ends as the mean of V over the key slots padded to
// block_k, as on the TPU.  Key blocks strictly above the causal diagonal
// of the whole q tile change no row that has a valid key, so the caller
// lets the kernel skip them (skip_upper) when every row has one.
//
// Bound on the H100: operations.  At f32 the products must be IEEE (no
// TF32), so the bound is the 67 TFLOP/s of the CUDA cores; at bf16 it is
// the tensor cores' 989 TFLOP/s, with the bytes of q, k, v and out close
// behind.  This first design runs every product as a scalar f32 FMA, reads
// shared memory once per two FMAs and keeps one or two blocks per SM.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace flash {

constexpr int BQ = 64;        // query rows per block
constexpr int KT = 64;        // keys per staged K / V sub-tile
constexpr int BK_MAX = 128;   // largest softmax block (block_k)
constexpr int SP = BK_MAX + 4;  // P row stride: two half-warps, two banks
constexpr int THREADS = 256;  // 16 x 16: thread (ty, tx) owns rows 4ty..+3
constexpr float NEG_INF = -1e30f;

template <typename T>
struct Elem;

template <>
struct Elem<float> {
  static __device__ __forceinline__ float load(const float* p) {
    return __ldg(p);
  }
  static __device__ __forceinline__ void store(float* p, float v) { *p = v; }
  static __device__ __forceinline__ float round(float v) { return v; }
};

template <>
struct Elem<__nv_bfloat16> {
  static __device__ __forceinline__ float load(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
    *p = __float2bfloat16_rn(v);
  }
  // P rounds to V's dtype before the P V product, as on the TPU
  static __device__ __forceinline__ float round(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
};

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int Sq, Sk, H, Hkv;
  int causal, window, block_k, skip_upper;
  float scale;
};

// Rows [s0, s0 + rows) of head hh of x (B, S, nh, D) as f32 into dst (row
// stride D + 1: a column walk hits 32 banks); rows past S are zero.
template <typename T, int D>
__device__ __forceinline__ void stage(float* dst, const T* x, int b, int s0,
                                      int rows, int S, int nh, int hh) {
  for (int i = threadIdx.x; i < rows * D; i += THREADS) {
    const int r = i / D, c = i - r * D, s = s0 + r;
    dst[r * (D + 1) + c] =
        s < S ? Elem<T>::load(x + (((size_t)b * S + s) * nh + hh) * D + c)
              : 0.0f;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS) flash_kernel(Args a) {
  extern __shared__ float smem[];
  float* sq = smem;                // BQ x (D + 1): the query tile
  float* skv = sq + BQ * (D + 1);  // KT x (D + 1): a K or V sub-tile
  float* sp = skv + KT * (D + 1);  // BQ x SP: scores, then P
  constexpr int DC = D / 16;       // output columns per thread
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  T* o = static_cast<T*>(a.o);
  const int bh = blockIdx.y, b = bh / a.H, h = bh - b * a.H;
  const int hk = h / (a.H / a.Hkv);
  const int q0 = blockIdx.x * BQ;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  stage<T, D>(sq, q, b, q0, BQ, a.Sq, a.H, h);

  float m[4], l[4], acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < DC; ++j) acc[i][j] = 0.0f;
  }

  const int bk = a.block_k;
  const int sk_pad = (a.Sk + bk - 1) / bk * bk;
  int k_end = sk_pad;
  if (a.skip_upper) {
    const int last = min(q0 + BQ, a.Sq) - 1;
    k_end = min(sk_pad, (last / bk + 1) * bk);
  }
  for (int k0 = 0; k0 < k_end; k0 += bk) {
    // masked, scaled scores of the block into sp; thread (ty, tx) writes
    // rows 4ty..+3, keys = tx (mod 16): the entries it reads back below
    for (int ks = 0; ks < bk; ks += KT) {
      __syncthreads();  // the previous sub-tile fully consumed
      stage<T, D>(skv, k, b, k0 + ks, KT, a.Sk, a.Hkv, hk);
      __syncthreads();
      float s[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
#pragma unroll 8
      for (int c = 0; c < D; ++c) {
        float qv[4], kv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) qv[i] = sq[(4 * ty + i) * (D + 1) + c];
#pragma unroll
        for (int j = 0; j < 4; ++j) kv[j] = skv[(tx + 16 * j) * (D + 1) + c];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int r = 4 * ty + i, kk = ks + tx + 16 * j;
          const int qp = q0 + r, kp = k0 + kk;
          bool ok = kp < a.Sk;
          if (a.causal) ok = ok && qp >= kp;
          if (a.window > 0) ok = ok && qp - kp < a.window;
          sp[r * SP + kk] = ok ? __fmul_rn(s[i][j], a.scale) : NEG_INF;
        }
      }
    }
    // online softmax over the block, one half-warp per row
    float corr[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float* row = sp + (4 * ty + i) * SP;
      float mx = NEG_INF;
      for (int kk = tx; kk < bk; kk += 16) mx = fmaxf(mx, row[kk]);
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      corr[i] = expf(m[i] - m_new);
      float sum = 0.0f;
      for (int kk = tx; kk < bk; kk += 16) {
        const float p = expf(row[kk] - m_new);
        sum += p;
        row[kk] = Elem<T>::round(p);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = __fadd_rn(__fmul_rn(l[i], corr[i]), sum);
      m[i] = m_new;
    }
    // acc = acc * corr + P V
    float pv[4][DC];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < DC; ++j) pv[i][j] = 0.0f;
    for (int ks = 0; ks < bk; ks += KT) {
      __syncthreads();  // K consumed, P complete
      stage<T, D>(skv, v, b, k0 + ks, KT, a.Sk, a.Hkv, hk);
      __syncthreads();
#pragma unroll 4
      for (int kk = 0; kk < KT; ++kk) {
        float pr[4], vv[DC];
#pragma unroll
        for (int i = 0; i < 4; ++i) pr[i] = sp[(4 * ty + i) * SP + ks + kk];
#pragma unroll
        for (int j = 0; j < DC; ++j) vv[j] = skv[kk * (D + 1) + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < DC; ++j) pv[i][j] = fmaf(pr[i], vv[j], pv[i][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < DC; ++j)
        acc[i][j] = __fadd_rn(__fmul_rn(acc[i][j], corr[i]), pv[i][j]);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = q0 + 4 * ty + i;
    if (s >= a.Sq) continue;
    const float den = fmaxf(l[i], 1e-30f);
    T* orow = o + (((size_t)b * a.Sq + s) * a.H + h) * D;
#pragma unroll
    for (int j = 0; j < DC; ++j)
      Elem<T>::store(orow + tx + 16 * j, acc[i][j] / den);
  }
}

template <typename T, int D>
int launch(const Args& a, int B, cudaStream_t s) {
  const int smem = (int)sizeof(float) * ((BQ + KT) * (D + 1) + BQ * SP);
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.Sq + BQ - 1) / BQ, B * a.H);
  flash_kernel<T, D><<<grid, THREADS, smem, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_d(const Args& a, int B, int D, cudaStream_t s) {
  switch (D) {
    case 16: return launch<T, 16>(a, B, s);
    case 32: return launch<T, 32>(a, B, s);
    case 64: return launch<T, 64>(a, B, s);
    case 128: return launch<T, 128>(a, B, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace flash

// q (B, Sq, H, D), k / v (B, Sk, Hkv, D), o (B, Sq, H, D), contiguous, all
// float32 (bf16 = 0) or all bfloat16 (bf16 = 1).  block_k is 64 or 128.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int B, int Sq,
                                      int Sk, int H, int Hkv, int D,
                                      int causal, int window, int block_k,
                                      int skip_upper, float scale, int bf16,
                                      void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0) return 0;
  if (block_k % flash::KT != 0 || block_k > flash::BK_MAX || Hkv <= 0 ||
      H % Hkv != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const flash::Args a{q,      k,      v,       o,       Sq,
                      Sk,     H,      Hkv,     causal,  window,
                      block_k, skip_upper, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? flash::launch_d<__nv_bfloat16>(a, B, D, s)
              : flash::launch_d<float>(a, B, D, s);
}
