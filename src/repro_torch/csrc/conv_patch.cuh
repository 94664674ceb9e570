// Implicit im2col: one element of the conv patch matrix, built by index from
// the padded activation volume xpad (B, H, W, C), so no patch matrix ever
// reaches device memory.  Row m is the global position img * OH*OW + pos,
// column k the channel-major feature c * kh*kw + ih * kw + iw of the
// parameter matrix; column `features` is the bias input (constant 1).
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

__device__ __forceinline__ float patch_value(const ConvGeomDev& g, int m,
                                             int k) {
  if (k >= g.features) return 1.0f;  // bias column
  const int kk = g.kh * g.kw;
  const int c = k / kk, t = k - c * kk;
  const int ih = t / g.kw, iw = t - ih * g.kw;
  const int per_img = g.oh * g.ow;
  const int img = m / per_img, pos = m - img * per_img;
  const int i = pos / g.ow, j = pos - i * g.ow;
  const int row = i * g.sh + ih * g.dh, col = j * g.sw + iw * g.dw;
  return g.xpad[(((size_t)img * g.H + row) * g.W + col) * g.C + c];
}

// Loader of the tiled read (analog_read.cuh): x(m, k) = patch(m, k).
struct ConvX {
  ConvGeomDev g;
  __device__ __forceinline__ float operator()(const ReadArgs&, int m,
                                              int k) const {
    return patch_value(g, m, k);
  }
};

}  // namespace analog
