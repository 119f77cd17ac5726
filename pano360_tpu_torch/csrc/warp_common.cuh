// Device helpers shared by the two backward-warp kernels
// (backward_warp.cu, backward_warp_mip.cu): the mosaic pixel -> camera
// ray mapping of pano360_tpu/ops/pallas_warp.py (_tile_coords, _project),
// split into per-column and per-row terms, and the float-side clamps that
// keep every float-to-int cast defined.
//
// The ray of mosaic pixel (px, py) is (sin x, t, cos x) with x the
// column's azimuth (px folded at the periodic seam) and t = tan y (or the
// height y itself, cylindrical) of the row; K R times it gives
//   u = (p0 sin x + p1 t) + p2 cos x,  and v, z from rows 1, 2 of K R.
// Each product depends on the column alone or on the row alone
// (col_terms, row_terms), so the mip kernel computes sin/cos once per
// column and tan once per row of its tile into shared tables and each
// pixel only adds: three sums of the same rounded products in the same
// order as the plain version (the kernels build with -fmad=false), so
// the same bits. The exact kernel computes both per pixel.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace p360 {

// One region's parameters as the wrappers' prepare step packs them:
// K R (row-major) in [0, 9), the patch origin [x, y] in [9, 11), the true
// window [lo_x, lo_y, hi_x, hi_y) in [11, 15), the region's true image
// size [h, w] in [15, 17) (0, 0: the stack's own size; read by the exact
// kernel alone, for images of mixed sizes zero-padded into one stack),
// three pad floats.
constexpr int PARAM_FLOATS = 20;

// A launch's scalars, built once per plan on the host (the wrappers'
// ctypes structure of the same layout) and passed by value to the
// kernel.
struct View {
  int n, ph, pw;    // regions, patch height and width
  int period;       // full-turn width of a periodic canvas, or <= 0
  int cylindrical;  // t = y instead of tan y
  float res_x, res_y, rmin_x, rmin_y;
};

// A column's products of K R with sin x and cos x, and whether its px
// lies outside the region's window in x.
struct ColTerms {
  float ux, uz, vx, vz, zx, zz;
  int out;
  int pad;
};

// A row's products of K R with t, and whether its py lies outside the
// region's window in y.
struct alignas(16) RowTerms {
  float uy, vy, zy;
  int out;
};

// Patch column x's terms; `prm`: the region's PARAM_FLOATS.
__device__ __forceinline__ ColTerms col_terms(const float* __restrict__ prm,
                                              int x, const View& vw) {
  const float px = (float)x + prm[9];
  const float px_s =
      (vw.period > 0 && px >= (float)vw.period) ? px - (float)vw.period : px;
  const float xs = px_s * vw.res_x + vw.rmin_x;
  const float sx = sinf(xs);
  const float cx = cosf(xs);
  ColTerms c;
  c.ux = prm[0] * sx;
  c.uz = prm[2] * cx;
  c.vx = prm[3] * sx;
  c.vz = prm[5] * cx;
  c.zx = prm[6] * sx;
  c.zz = prm[8] * cx;
  c.out = (px < prm[11]) | (px >= prm[13]);
  c.pad = 0;
  return c;
}

// Patch row y's terms.
__device__ __forceinline__ RowTerms row_terms(const float* __restrict__ prm,
                                              int y, const View& vw) {
  const float py = (float)y + prm[10];
  const float ys = py * vw.res_y + vw.rmin_y;
  const float ty = vw.cylindrical ? ys : tanf(ys);
  RowTerms r;
  r.uy = prm[1] * ty;
  r.vy = prm[4] * ty;
  r.zy = prm[7] * ty;
  r.out = (py < prm[12]) | (py >= prm[14]);
  return r;
}

// A tile's tables: its TX columns' and TY rows' terms.
template <int TX, int TY>
struct Terms {
  ColTerms col[TX];
  RowTerms row[TY];
};

// Thread t < TX of the block builds column x0 + t's terms, thread
// TX <= t < TX + TY row y0 + t - TX's; the others do nothing. The caller
// synchronises the block afterwards.
template <int TX, int TY>
__device__ __forceinline__ void build_terms(Terms<TX, TY>& s,
                                            const float* __restrict__ prm,
                                            int x0, int y0, int t,
                                            const View& vw) {
  if (t < TX)
    s.col[t] = col_terms(prm, x0 + t, vw);
  else if (t < TX + TY)
    s.row[t - TX] = row_terms(prm, y0 + t - TX, vw);
}

// K R times the ray of one pixel, from its column's and row's terms.
struct Ray {
  float u, v, z;
};

__device__ __forceinline__ Ray pixel_ray(const ColTerms& c,
                                         const RowTerms& r) {
  Ray ray;
  ray.u = (c.ux + r.uy) + c.uz;
  ray.v = (c.vx + r.vy) + c.vz;
  ray.z = (c.zx + r.zy) + c.zz;
  return ray;
}

// v clamped into [-lim, lim] (NaN -> 0) before a floor and int cast; the
// callers pick lim so that every sample they keep is left unchanged.
__device__ __forceinline__ float clamp_coord(float v, float lim) {
  if (!(v == v)) return 0.0f;
  return fminf(fmaxf(v, -lim), lim);
}

__device__ __forceinline__ float4 lerp4(float4 a, float4 b, float f) {
  const float g = 1.0f - f;
  return make_float4(a.x * g + b.x * f, a.y * g + b.y * f,
                     a.z * g + b.z * f, a.w * g + b.w * f);
}

// One output pixel's four taps, fractions and validity, between the
// gather and the blend.
struct Taps {
  float4 t00, t01, t10, t11;
  float fx, fy;
  bool bad;
};

// One tap, through the read-only path.
__device__ __forceinline__ float4 load_tap(const float4* p) {
  return __ldg(p);
}

__device__ __forceinline__ float4 blend(const Taps& p) {
  const float4 top = lerp4(p.t00, p.t01, p.fx);
  const float4 bot = lerp4(p.t10, p.t11, p.fx);
  float4 out = lerp4(top, bot, p.fy);
  if (p.bad) out.w = 0.0f;
  return out;
}

}  // namespace p360
