// flash_attention: online-softmax attention forward on Hopper (kernel #8).
//
// Replaces the TPU kernel flash_attention (src/repro/kernels/
// flash_attention.py:83, pallas_call at :111).  q (B, Sq, H, D), k and v
// (B, Sk, Hkv, D) with H a multiple of Hkv (query head h reads kv head
// h / (H / Hkv), as repeat_kv would lay it out), out (B, Sq, H, D) in q's
// dtype; float32 or bfloat16; D in {16, 32, 64, 128}.
//
// The TPU kernel walks (batch*head, q block, k block) with the k axis
// serial, carrying the running max, sum and f32 accumulator of a q block in
// VMEM.  Here one block owns 64 (bf16) or 128 (f32) query rows of one
// (batch, head) and walks the key blocks in a loop, the carried state in
// registers.  Per softmax
// block of block_k keys (64 or 128, the TPU's, so that P rounds at the same
// running max): S = (Q K^T) * scale, masked by absolute position (padding
// k >= Sk, causal q >= k, window q - k < window) to the finite NEG_INF =
// -1e30; m' = max(m, max S) over the WHOLE block; P = exp(S - m') (as
// exp2 of (S - m') log2 e); l = l
// exp(m - m') + sum P; P rounded to V's dtype; acc = acc exp(m - m') + P V.
// out = acc / max(l, 1e-30).  K and V arrive in 64-key chunks through a
// cp.async ring in shared memory (block_k / 64 slots each; rows past Sk
// zero-filled by src-size 0): the next block's K loads while this block's
// softmax and P V run, its V while the next S runs.  The scores never
// leave registers.
//
// bfloat16: both products on the tensor cores (mma.sync m16n8k16, bf16
// operands, f32 accumulation), FlashAttention-2's layout: 4 warps, each
// owns 16 query rows with its Q fragments in registers (ldmatrix); K and V
// fragments come by ldmatrix (V with .trans) from rows padded by 16 bytes,
// so the eight row addresses of each 8x8 matrix fall in distinct banks; S
// stays in the accumulator layout, and P is rounded to bf16 and repacked
// from it into the A fragments of P V.  Row max and sum: quad shuffles.
//
// float32: IEEE products on the CUDA cores (no TF32, no tensor cores).
// 128 query rows per block, 256 threads as 16 x 16: thread (ty, tx) holds
// scores of rows ty + 16i (8 rows) and keys tx + 16j of each chunk (8 x 4)
// and outputs of those rows in D/16 columns: per 4 of D, 12 float4 shared
// loads feed 128 FMAs of Q K^T; per key, 2 float4 loads of V and 8
// shuffles feed 64 FMAs of P V.  Row max and sum: half-warp shuffles; P V
// takes each P entry from its owner by a shuffle.
//
// Masked blocks: with the finite NEG_INF a row that has seen no valid key
// has m = -1e30 and takes every slot of the block at weight 1; its first
// valid key multiplies that by exp(-1e30 - m') = 0 exactly, and a row with
// no valid key at all ends as the mean of V over the key slots padded to
// block_k, as on the TPU.  Key blocks strictly above the causal diagonal
// of the whole q tile change no row that has a valid key, so the caller
// lets the kernel skip them (skip_upper) when every row has one.  Blocks
// that no mask touches skip the mask arithmetic.
//
// Bound on the H100: operations.  bf16: the tensor cores' 989 TFLOP/s, with
// the bytes of q, k, v and out close behind; f32: the CUDA cores' 67
// TFLOP/s.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace flash {

constexpr int BQ = 64;  // query rows per block (bf16)
constexpr int KT = 64;  // keys per staged chunk
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

// exp(x) as 2^(x log2 e): one multiply and the SFU's exp2 (within a few
// f32 ulp of expf; the plain version's expf agrees within the checks'
// tolerances, phase b8 holds it)
__device__ __forceinline__ float exp_(float x) { return exp2f(x * LOG2E); }

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int Sq, Sk, H, Hkv;
  int causal, window, block_k, skip_upper;
  float scale;
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Rows [s0, s0 + rows) of head hh of x (B, S, nh, D) into dst (row stride
// LD elements) by 16-byte cp.async; rows past S are zero-filled.
template <typename T, int D, int LD, int THREADS>
__device__ __forceinline__ void stage(T* dst, const T* x, int b, int s0,
                                      int rows, int S, int nh, int hh) {
  constexpr int EPC = 16 / sizeof(T);  // elements per 16-byte chunk
  constexpr int CPR = D / EPC;         // chunks per row
  for (int i = threadIdx.x; i < rows * CPR; i += THREADS) {
    const int r = i / CPR, c = i - r * CPR, s = s0 + r;
    const bool ok = s < S;
    const T* src =
        x + (((size_t)b * S + (ok ? s : 0)) * nh + hh) * D + c * EPC;
    cp_async16(dst + r * LD + c * EPC, src, ok);
  }
}

__device__ __forceinline__ bool keep(const Args& a, int qp, int kp) {
  bool ok = kp < a.Sk;
  if (a.causal) ok = ok && qp >= kp;
  if (a.window > 0) ok = ok && qp - kp < a.window;
  return ok;
}

// Does any entry of the (q rows from q0, keys [k0, k0 + bk)) block need a
// mask?
__device__ __forceinline__ bool needs_mask(const Args& a, int q0, int k0) {
  return k0 + a.block_k > a.Sk || a.window > 0 ||
         (a.causal && k0 + a.block_k - 1 > q0);
}

// End of the key loop: the padded key length, or the last causal block of
// the q tile when the caller allows skipping.
__device__ __forceinline__ int key_end(const Args& a, int q0, int rows) {
  const int bk = a.block_k;
  const int sk_pad = (a.Sk + bk - 1) / bk * bk;
  if (!a.skip_upper) return sk_pad;
  const int last = min(q0 + rows, a.Sq) - 1;
  return min(sk_pad, (last / bk + 1) * bk);
}

// ---------------------------------------------------------------------------
// bfloat16: mma.sync on the tensor cores
// ---------------------------------------------------------------------------

namespace tc {

constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}
// c += a b: 16x16 bf16 (row) by 16x8 bf16 (col), f32 accumulators
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

template <int D, int NK>
__global__ void __launch_bounds__(THREADS, 2) kernel(Args a) {
  constexpr int LD = D + 8;      // row stride (elements): +16 bytes
  constexpr int NT = NK * 8;     // 8-key score tiles per softmax block
  constexpr int DK = D / 16;     // 16-wide steps of the head dim
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sq = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sk = sq + BQ * LD;       // NK chunks of KT keys
  __nv_bfloat16* sv = sk + NK * KT * LD;  // NK chunks of KT keys
  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(a.q);
  const __nv_bfloat16* k = static_cast<const __nv_bfloat16*>(a.k);
  const __nv_bfloat16* v = static_cast<const __nv_bfloat16*>(a.v);
  __nv_bfloat16* o = static_cast<__nv_bfloat16*>(a.o);
  const int bh = blockIdx.y, b = bh / a.H, h = bh - b * a.H;
  const int hk = h / (a.H / a.Hkv);
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // longest rows first
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int bk = a.block_k;
  const int k_end = key_end(a, q0, BQ);

  stage<__nv_bfloat16, D, LD, THREADS>(sq, q, b, q0, BQ, a.Sq, a.H, h);
  cp_commit();
  for (int c = 0; c < NK; ++c)
    stage<__nv_bfloat16, D, LD, THREADS>(sk + c * KT * LD, k, b, c * KT, KT,
                                         a.Sk, a.Hkv, hk);
  cp_commit();
  for (int c = 0; c < NK; ++c)
    stage<__nv_bfloat16, D, LD, THREADS>(sv + c * KT * LD, v, b, c * KT, KT,
                                         a.Sk, a.Hkv, hk);
  cp_commit();

  uint32_t qf[DK][4];
  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.0f, 0.0f};
  const int r0 = q0 + warp * 16 + g;  // this thread's rows: r0, r0 + 8

  for (int k0 = 0; k0 < k_end; k0 += bk) {
    cp_wait<1>();  // Q and this block's K have landed
    __syncthreads();
    if (k0 == 0) {
#pragma unroll
      for (int kd = 0; kd < DK; ++kd)
        ldsm_x4(qf[kd], sq + (warp * 16 + (lane & 15)) * LD + kd * 16 +
                            (lane >> 4) * 8);
    }
    // S = Q K^T
    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.0f;
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      const __nv_bfloat16* kr =
          sk + (np * 16 + (lane & 7) + (lane >> 4) * 8) * LD +
          ((lane >> 3) & 1) * 8;
#pragma unroll
      for (int kd = 0; kd < DK; ++kd) {
        uint32_t kf[4];
        ldsm_x4(kf, kr + kd * 16);
        mma(s[2 * np], qf[kd], kf[0], kf[1]);
        mma(s[2 * np + 1], qf[kd], kf[2], kf[3]);
      }
    }
    __syncthreads();  // every warp is done with the K slots
    if (k0 + bk < k_end)
      for (int c = 0; c < NK; ++c)
        stage<__nv_bfloat16, D, LD, THREADS>(sk + c * KT * LD, k, b,
                                             k0 + bk + c * KT, KT, a.Sk,
                                             a.Hkv, hk);
    cp_commit();
    // scale, mask, online softmax over the whole block
    const bool masked = needs_mask(a, q0, k0);
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = __fmul_rn(s[j][e], a.scale);
        if (masked &&
            !keep(a, r0 + (e >> 1) * 8, k0 + j * 8 + 2 * t + (e & 1)))
          x = NEG_INF;
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float corr[2], sum[2] = {0.0f, 0.0f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      corr[r] = exp_(m[r] - m_new);
      m[r] = m_new;
    }
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp_(s[j][e] - m[e >> 1]);
        sum[e >> 1] += p;
        s[j][e] = p;
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
      l[r] = __fadd_rn(__fmul_rn(l[r], corr[r]), sum[r]);
    }
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        acc[j][e] = __fmul_rn(acc[j][e], corr[e >> 1]);
    cp_wait<1>();  // this block's V has landed
    __syncthreads();
    // acc += P V, P rounded to bf16 straight from the score registers
#pragma unroll
    for (int kk = 0; kk < NT / 2; ++kk) {
      const uint32_t pf[4] = {pack(s[2 * kk][0], s[2 * kk][1]),
                              pack(s[2 * kk][2], s[2 * kk][3]),
                              pack(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack(s[2 * kk + 1][2], s[2 * kk + 1][3])};
      const __nv_bfloat16* vr =
          sv + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
          (lane >> 4) * 8;
#pragma unroll
      for (int dp = 0; dp < DK; ++dp) {
        uint32_t vf[4];
        ldsm_x4_t(vf, vr + dp * 16);
        mma(acc[2 * dp], pf, vf[0], vf[1]);
        mma(acc[2 * dp + 1], pf, vf[2], vf[3]);
      }
    }
    __syncthreads();  // every warp is done with the V slots
    if (k0 + bk < k_end)
      for (int c = 0; c < NK; ++c)
        stage<__nv_bfloat16, D, LD, THREADS>(sv + c * KT * LD, v, b,
                                             k0 + bk + c * KT, KT, a.Sk,
                                             a.Hkv, hk);
    cp_commit();
  }
  cp_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int s_row = r0 + r * 8;
    if (s_row >= a.Sq) continue;
    const float den = fmaxf(l[r], 1e-30f);
    __nv_bfloat16* orow = o + (((size_t)b * a.Sq + s_row) * a.H + h) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(orow + j * 8 + 2 * t) =
          pack(acc[j][2 * r] / den, acc[j][2 * r + 1] / den);
  }
}

}  // namespace tc

// ---------------------------------------------------------------------------
// float32: register-tiled FMAs on the CUDA cores
// ---------------------------------------------------------------------------

namespace fp {

constexpr int THREADS = 256;  // 16 x 16
constexpr int BQF = 128;      // query rows per block
constexpr int RI = BQF / 16;  // rows per thread

template <int D>
struct Cols {
  static constexpr int DC = D / 16;             // output columns per thread
  static constexpr int CW = DC < 4 ? DC : 4;    // contiguous run
  static constexpr int NCH = DC / CW;           // runs (1, or 2 at D 128)
  // column of element e of run hh for thread tx
  static __device__ __forceinline__ int col(int hh, int tx, int e) {
    return hh * 16 * CW + tx * CW + e;
  }
};

template <int D, int NK>
__global__ void __launch_bounds__(THREADS, 1) kernel(Args a) {
  constexpr int LD = D + 4;  // row stride (floats): 16-byte rows, no bank
                             // conflicts across 8 consecutive rows
  using C = Cols<D>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sq = reinterpret_cast<float*>(smem_raw);
  float* sk = sq + BQF * LD;
  float* sv = sk + NK * KT * LD;
  const float* q = static_cast<const float*>(a.q);
  const float* k = static_cast<const float*>(a.k);
  const float* v = static_cast<const float*>(a.v);
  float* o = static_cast<float*>(a.o);
  const int bh = blockIdx.y, b = bh / a.H, h = bh - b * a.H;
  const int hk = h / (a.H / a.Hkv);
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQF;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int lane = threadIdx.x & 31;
  const int bk = a.block_k;
  const int k_end = key_end(a, q0, BQF);

  stage<float, D, LD, THREADS>(sq, q, b, q0, BQF, a.Sq, a.H, h);
  cp_commit();
  for (int c = 0; c < NK; ++c)
    stage<float, D, LD, THREADS>(sk + c * KT * LD, k, b, c * KT, KT, a.Sk,
                                 a.Hkv, hk);
  cp_commit();
  for (int c = 0; c < NK; ++c)
    stage<float, D, LD, THREADS>(sv + c * KT * LD, v, b, c * KT, KT, a.Sk,
                                 a.Hkv, hk);
  cp_commit();

  float acc[RI][C::DC];
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < C::DC; ++j) acc[i][j] = 0.0f;
  float m[RI], l[RI];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.0f;
  }

  for (int k0 = 0; k0 < k_end; k0 += bk) {
    cp_wait<1>();
    __syncthreads();
    // S = Q K^T: rows ty + 16i, keys c * KT + tx + 16j
    float s[NK][RI][4];
#pragma unroll
    for (int c = 0; c < NK; ++c)
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[c][i][j] = 0.0f;
#pragma unroll
    for (int c = 0; c < NK; ++c) {
      const float* kc = sk + c * KT * LD;
#pragma unroll 2
      for (int d = 0; d < D; d += 4) {
        float4 kv[4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          kv[j] =
              *reinterpret_cast<const float4*>(kc + (tx + 16 * j) * LD + d);
#pragma unroll
        for (int i = 0; i < RI; ++i) {
          const float4 qv =
              *reinterpret_cast<const float4*>(sq + (ty + 16 * i) * LD + d);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            float x = s[c][i][j];
            x = fmaf(qv.x, kv[j].x, x);
            x = fmaf(qv.y, kv[j].y, x);
            x = fmaf(qv.z, kv[j].z, x);
            s[c][i][j] = fmaf(qv.w, kv[j].w, x);
          }
        }
      }
    }
    __syncthreads();
    if (k0 + bk < k_end)
      for (int c = 0; c < NK; ++c)
        stage<float, D, LD, THREADS>(sk + c * KT * LD, k, b,
                                     k0 + bk + c * KT, KT, a.Sk, a.Hkv, hk);
    cp_commit();
    const bool masked = needs_mask(a, q0, k0);
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      float mx = NEG_INF;
#pragma unroll
      for (int c = 0; c < NK; ++c)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float x = __fmul_rn(s[c][i][j], a.scale);
          if (masked && !keep(a, q0 + ty + 16 * i, k0 + c * KT + tx + 16 * j))
            x = NEG_INF;
          s[c][i][j] = x;
          mx = fmaxf(mx, x);
        }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float corr = exp_(m[i] - m_new);
      float sum = 0.0f;
#pragma unroll
      for (int c = 0; c < NK; ++c)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float p = exp_(s[c][i][j] - m_new);
          sum += p;
          s[c][i][j] = p;
        }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = __fadd_rn(__fmul_rn(l[i], corr), sum);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < C::DC; ++j) acc[i][j] = __fmul_rn(acc[i][j], corr);
    }
    cp_wait<1>();
    __syncthreads();
    // acc += P V: P[row][key] comes from the lane that holds it
    const int half = lane & 16;
#pragma unroll
    for (int c = 0; c < NK; ++c) {
      const float* vc = sv + c * KT * LD;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll 2
        for (int src = 0; src < 16; ++src) {
          const float* vrow = vc + (j * 16 + src) * LD;
          float vv[C::DC];
#pragma unroll
          for (int hh = 0; hh < C::NCH; ++hh) {
            const float* vp = vrow + C::col(hh, tx, 0);
            if (C::CW == 4) {
              const float4 x = *reinterpret_cast<const float4*>(vp);
              vv[hh * 4] = x.x;
              vv[hh * 4 + 1] = x.y;
              vv[hh * 4 + 2] = x.z;
              vv[hh * 4 + 3] = x.w;
            } else {
#pragma unroll
              for (int e = 0; e < C::CW; ++e) vv[hh * C::CW + e] = vp[e];
            }
          }
#pragma unroll
          for (int i = 0; i < RI; ++i) {
            const float p = __shfl_sync(0xffffffffu, s[c][i][j], half | src);
#pragma unroll
            for (int e = 0; e < C::DC; ++e)
              acc[i][e] = fmaf(p, vv[e], acc[i][e]);
          }
        }
      }
    }
    __syncthreads();
    if (k0 + bk < k_end)
      for (int c = 0; c < NK; ++c)
        stage<float, D, LD, THREADS>(sv + c * KT * LD, v, b,
                                     k0 + bk + c * KT, KT, a.Sk, a.Hkv, hk);
    cp_commit();
  }
  cp_wait<0>();

#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int s_row = q0 + ty + 16 * i;
    if (s_row >= a.Sq) continue;
    const float den = fmaxf(l[i], 1e-30f);
    float* orow = o + (((size_t)b * a.Sq + s_row) * a.H + h) * D;
#pragma unroll
    for (int hh = 0; hh < C::NCH; ++hh)
#pragma unroll
      for (int e = 0; e < C::CW; ++e)
        orow[C::col(hh, tx, e)] = acc[i][hh * C::CW + e] / den;
  }
}

}  // namespace fp

template <typename KernelFn>
int launch_kernel(KernelFn kern, int threads, int rows, size_t smem,
                  const Args& a, int B, cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.Sq + rows - 1) / rows, B * a.H);
  kern<<<grid, threads, smem, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int D, int NK>
int launch(const Args& a, int B, int bf16, cudaStream_t s) {
  if (bf16) {
    const size_t smem = sizeof(__nv_bfloat16) * (BQ + 2 * NK * KT) * (D + 8);
    return launch_kernel(tc::kernel<D, NK>, tc::THREADS, BQ, smem, a, B, s);
  }
  const size_t smem = sizeof(float) * (fp::BQF + 2 * NK * KT) * (D + 4);
  return launch_kernel(fp::kernel<D, NK>, fp::THREADS, fp::BQF, smem, a, B,
                       s);
}

template <int D>
int launch_nk(const Args& a, int B, int bf16, cudaStream_t s) {
  return a.block_k == 128 ? launch<D, 2>(a, B, bf16, s)
                          : launch<D, 1>(a, B, bf16, s);
}

}  // namespace flash

// q (B, Sq, H, D), k / v (B, Sk, Hkv, D), o (B, Sq, H, D), contiguous and
// 16-byte aligned, all float32 (bf16 = 0) or all bfloat16 (bf16 = 1).
// block_k is 64 or 128.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int B, int Sq,
                                      int Sk, int H, int Hkv, int D,
                                      int causal, int window, int block_k,
                                      int skip_upper, float scale, int bf16,
                                      void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0) return 0;
  if ((block_k != 64 && block_k != 128) || Hkv <= 0 || H % Hkv != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const flash::Args a{q,      k,      v,       o,       Sq,
                      Sk,     H,      Hkv,     causal,  window,
                      block_k, skip_upper, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return flash::launch_nk<16>(a, B, bf16, s);
    case 32: return flash::launch_nk<32>(a, B, bf16, s);
    case 64: return flash::launch_nk<64>(a, B, bf16, s);
    case 128: return flash::launch_nk<128>(a, B, bf16, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
