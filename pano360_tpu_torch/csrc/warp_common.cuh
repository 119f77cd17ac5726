// Device helpers shared by the two backward-warp kernels
// (backward_warp.cu, backward_warp_mip.cu): the mosaic pixel -> camera
// ray mapping of pano360_tpu/ops/pallas_warp.py (_tile_coords, _project)
// and the float-side clamps that keep every float-to-int cast defined.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace p360 {

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

// K R times the ray of mosaic pixel (px, py): columns past the periodic
// seam (period > 0) sample at their final column's azimuth; the ray is
// (sin x, tan y, cos x) spherical, (sin x, y, cos x) cylindrical. Each
// product is rounded before its sum (the kernels build with -fmad=false),
// in the JAX package's order.
struct Ray {
  float u, v, z;
};

__device__ __forceinline__ Ray mosaic_ray(const float* p, float px, float py,
                                          float res_x, float res_y,
                                          float rmin_x, float rmin_y,
                                          int period, int cylindrical) {
  const float px_s =
      (period > 0 && px >= (float)period) ? px - (float)period : px;
  const float xs = px_s * res_x + rmin_x;
  const float ys = py * res_y + rmin_y;
  const float sx = sinf(xs);
  const float ty = cylindrical ? ys : tanf(ys);
  const float cx = cosf(xs);
  Ray ray;
  ray.u = p[0] * sx + p[1] * ty + p[2] * cx;
  ray.v = p[3] * sx + p[4] * ty + p[5] * cx;
  ray.z = p[6] * sx + p[7] * ty + p[8] * cx;
  return ray;
}

// The region's true window [lo_x, lo_y, hi_x, hi_y) in mosaic pixels.
__device__ __forceinline__ bool outside_window(const float* win, float px,
                                               float py) {
  return (px < win[0]) | (py < win[1]) | (px >= win[2]) | (py >= win[3]);
}

}  // namespace p360
