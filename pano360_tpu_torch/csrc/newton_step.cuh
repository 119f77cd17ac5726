// The packed Newton step of one DoG pixel, as the plain version's dense
// field holds it (features/sift.py _newton_step_field).
//
// Per pixel (l, y, x) of layers 1..S: the 3x3x3 finite differences (rolls
// along x and y, so the border pixels wrap around as torch.roll wraps),
// the Hessian's determinant, the closed-form adjugate solve on the
// 1e-12-regularised diagonal, and one int32 word: bit 0 converged (all
// |offset| < 0.5), bits 1-2 / 3-4 / 5-6 = clamp(round(offset), -1, 1) + 1
// for x, y, layer. Every operation is the plain version's, in its order,
// each rounded on its own (-fmad=false, IEEE division, rintf for
// torch.round, a NaN kept through the clamp and cast as PyTorch's kernels
// do), so the word equals the plain field's bit for bit.
#pragma once

#include <stdint.h>

#include <cuda_runtime.h>

namespace p360 {

__device__ __forceinline__ int32_t step_bits(float o) {
  // clamp(round(o), -1, 1).to(int32) + 1, with torch.clamp's NaN kept
  float r = rintf(o);
  if (!isnan(r)) r = fminf(fmaxf(r, -1.0f), 1.0f);
  return (int32_t)r + 1;
}

// dog: the (N, n_lay + 2, h, w) DoG stack; l in 1..n_lay, y in [0, h),
// x in [0, w)
__device__ __forceinline__ int32_t newton_word(const float* __restrict__ dog,
                                               int img, int n_lay, int l,
                                               int y, int x, int h, int w) {
  const size_t plane = (size_t)h * w;
  const float* cl = dog + ((size_t)img * (n_lay + 2) + (l - 1)) * plane;
  const float* cm = cl + plane;
  const float* cu = cm + plane;
  // torch.roll's wrap-around
  const int xp = x + 1 < w ? x + 1 : x + 1 - w;
  const int xm = x > 0 ? x - 1 : x - 1 + w;
  const size_t r0 = (size_t)y * w;
  const size_t rp = (size_t)(y + 1 < h ? y + 1 : y + 1 - h) * w;
  const size_t rm = (size_t)(y > 0 ? y - 1 : y - 1 + h) * w;

  const float c = cm[r0 + x];
  const float cxp = cm[r0 + xp], cxm = cm[r0 + xm];
  const float cyp = cm[rp + x], cym = cm[rm + x];
  const float u = cu[r0 + x], lo = cl[r0 + x];

  const float dx = (cxp - cxm) * 0.5f;
  const float dy = (cyp - cym) * 0.5f;
  const float ds = (u - lo) * 0.5f;
  const float dxx = (cxp - 2.0f * c) + cxm;
  const float dyy = (cyp - 2.0f * c) + cym;
  const float dss = (u - 2.0f * c) + lo;
  const float dxy =
      (((cm[rp + xp] - cm[rp + xm]) - cm[rm + xp]) + cm[rm + xm]) * 0.25f;
  const float dxs = (((cu[r0 + xp] - cu[r0 + xm]) - cl[r0 + xp]) +
                     cl[r0 + xm]) * 0.25f;
  const float dys = (((cu[rp + x] - cu[rm + x]) - cl[rp + x]) + cl[rm + x]) *
                    0.25f;

  const float det0 = (dxx * (dyy * dss - dys * dys) -
                      dxy * (dxy * dss - dys * dxs)) +
                     dxs * (dxy * dys - dyy * dxs);
  const float a = dxx + 1e-12f, e = dyy + 1e-12f, i = dss + 1e-12f;
  const float b = dxy, cc = dxs, f = dys;
  const float co00 = e * i - f * f, co01 = cc * f - b * i,
              co02 = b * f - cc * e;
  const float co10 = f * cc - b * i, co11 = a * i - cc * cc,
              co12 = cc * b - a * f;
  const float co20 = b * f - e * cc, co21 = b * cc - a * f,
              co22 = a * e - b * b;
  const float det = (a * co00 + b * co01) + cc * co02;
  const bool solve = fabsf(det0) > 1e-20f;
  const float ox = solve ? -((co00 * dx + co01 * dy) + co02 * ds) / det : 0.0f;
  const float oy = solve ? -((co10 * dx + co11 * dy) + co12 * ds) / det : 0.0f;
  const float ol = solve ? -((co20 * dx + co21 * dy) + co22 * ds) / det : 0.0f;
  const bool conv = fabsf(ox) < 0.5f && fabsf(oy) < 0.5f && fabsf(ol) < 0.5f;
  return (int32_t)conv | (step_bits(ox) << 1) | (step_bits(oy) << 3) |
         (step_bits(ol) << 5);
}

}  // namespace p360
