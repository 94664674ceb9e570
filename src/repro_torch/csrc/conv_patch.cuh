// Implicit im2col: elements of the conv patch matrix, built by index from
// the padded activation volume xpad (B, H, W, C), so no patch matrix ever
// reaches device memory.  Row m is the global position img * OH*OW + pos,
// column k the channel-major feature c * kh*kw + ih * kw + iw of the
// parameter matrix; column `features` is the bias input (constant 1).
// Both users split an element's offset into a row part and a column part:
// patch_row / patch_col for #7's stream drivers (a row part per stream
// slot, a column part per staging thread), and ConvX, the x loader of
// managed_gemm.cuh's tile (#3's read), with a row part fixed for a thread's
// rows over the whole contraction and a column part shared by the rows it
// loads in one k-tile.
#pragma once

#include "analog_read.cuh"

namespace analog {

struct ConvGeomDev {
  const float* xpad;
  int H, W, C, kh, kw, sh, sw, dh, dw, oh, ow, features;
};

// geom (host): B, H, W, C, kh, kw, sh, sw, dh, dw, oh, ow, bias.
inline ConvGeomDev conv_geom(const float* xpad, const int* geom) {
  return ConvGeomDev{xpad,     geom[1], geom[2],  geom[3], geom[4],
                     geom[5],  geom[6], geom[7],  geom[8], geom[9],
                     geom[10], geom[11], geom[3] * geom[4] * geom[5]};
}

inline int conv_positions(const int* geom) {
  return geom[0] * geom[10] * geom[11];
}

inline int conv_cols(const int* geom) {
  return geom[3] * geom[4] * geom[5] + (geom[12] ? 1 : 0);
}

// Offset in xpad of the window of position row m (img * OH*OW + pos).
__device__ __forceinline__ int patch_row(const ConvGeomDev& g, int m) {
  const int per_img = g.oh * g.ow;
  const int img = m / per_img, pos = m - img * per_img;
  const int i = pos / g.ow, j = pos - i * g.ow;
  return ((img * g.H + i * g.sh) * g.W + j * g.sw) * g.C;
}

// Offset of column k inside a window; -1 for the bias column.
__device__ __forceinline__ int patch_col(const ConvGeomDev& g, int k) {
  if (k >= g.features) return -1;
  const int kk = g.kh * g.kw;
  const int c = k / kk, t = k - c * kk;
  const int ih = t / g.kw, iw = t - ih * g.kw;
  return (ih * g.dh * g.W + iw * g.dw) * g.C + c;
}

// x loader of managed_gemm.cuh's Tile (non-VEC path): a thread's x chunks
// of every k-tile lie in rows tid/4 + l * THREADS/4 (l < N) and columns
// k0..k0+3 with the same k0 for every l.  rb[l] is the offset of row l's
// window in xpad (-1 past the last position), off[e] that of column k0+e
// inside the window (-1 past the contraction, -2 the bias column).
template <int N>
struct ConvX {
  const float* xpad;
  int kk, kw, dhWC, dwC, features;
  int rb[N];

  struct Cols {
    int off[4];
  };

  __device__ __forceinline__ ConvX(const ConvGeomDev& g, int rows, int m0,
                                   int threads) {
    xpad = g.xpad;
    kk = g.kh * g.kw;
    kw = g.kw;
    dhWC = g.dh * g.W * g.C;
    dwC = g.dw * g.C;
    features = g.features;
    const int per_img = g.oh * g.ow;
#pragma unroll
    for (int l = 0; l < N; ++l) {
      const int m = m0 + (int)threadIdx.x / 4 + l * (threads / 4);
      const int img = m / per_img, pos = m - img * per_img;
      const int i = pos / g.ow, j = pos - i * g.ow;
      rb[l] = m < rows ? ((img * g.H + i * g.sh) * g.W + j * g.sw) * g.C : -1;
    }
  }

  __device__ __forceinline__ Cols columns(int k0, int K) const {
    Cols c;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int k = k0 + e;
      const int ch = k / kk, t = k - ch * kk;
      const int ih = t / kw, iw = t - ih * kw;
      c.off[e] = k >= K ? -1 : k >= features ? -2 : ih * dhWC + iw * dwC + ch;
    }
    return c;
  }

  __device__ __forceinline__ void load4(int l, int, const Cols& c,
                                        float* dst) const {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      dst[e] = (rb[l] < 0 || c.off[e] == -1) ? 0.0f
               : c.off[e] == -2              ? 1.0f
                                             : __ldg(xpad + rb[l] + c.off[e]);
  }
};

}  // namespace analog
