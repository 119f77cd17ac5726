// Newton refinement of SIFT's DoG candidates, each Newton step computed
// where a candidate's steps visit it.
//
// Replaces: pano360_tpu/features/sift.py, _newton_step_field (:403) and
// _refine_one (:488), vmapped over the candidates; XLA fuses them (no
// Pallas kernel lies behind them). The plain version is features/sift.py
// _refine on the dense field of _newton_step_field: per candidate,
// refine_iters steps, each taking the packed Newton step at (l, y, x)
// and, when it is not converged, moving by it clamped inside the border
// (the layer to [1, S]); then the 3x3x3 DoG cube at the final position
// (flat indices clamped into the image's planes, as the plain gather
// clamps them), its gradient and Hessian, geometry.det3x3, the adjugate
// inverse of geometry.inv3x3 on hess + 1e-12 I, the offsets (zero unless
// converged with |det| > 1e-20), the contrast and the edge and contrast
// tests. Every operation is the plain version's, in its order, rounded
// on its own (-fmad=false, IEEE division), so the two agree bit for bit.
//
// The step at a position is newton_step.cuh's newton_word, computed from
// the position's 19 stencil values in the DoG stack (with torch.roll's
// wrap at the image's edges, which only a candidate's first position can
// reach): the dense field of every pixel of layers 1..S, of which a
// candidate reads at most refine_iters words, is never made. A converged
// step does not move, and a step clamped to where it stands moves no
// more: either way every later step repeats it, so the loop ends there.
//
// What bounds it on an H100: neither bytes nor operations at its size
// (<= 2048 candidates an image and octave, each ~19 DoG values per
// position it visits and ~130 operations per step): the latency of a
// candidate's chain of dependent steps and of one launch. The plain
// version is ~150 full-size passes for the field and ~80 small operations
// for the steps per octave; this is one launch. The design: one thread
// per candidate, its stencils read straight from device memory.
#include <stdint.h>

#include <cuda_runtime.h>

#include "newton_step.cuh"

namespace {

constexpr int THREADS = 128;

__device__ __forceinline__ int64_t clamp64(int64_t v, int64_t lo,
                                           int64_t hi) {
  // torch.clamp on integers: min(max(v, lo), hi)
  v = v < lo ? lo : v;
  return v > hi ? hi : v;
}

__global__ void p360_sift_refine_kernel(
    const float* __restrict__ dog, const int64_t* __restrict__ l0,
    const int64_t* __restrict__ y0, const int64_t* __restrict__ x0,
    int64_t* __restrict__ lo,
    int64_t* __restrict__ yo, int64_t* __restrict__ xo,
    float* __restrict__ offs, float* __restrict__ contrast,
    uint8_t* __restrict__ ok, int n, int c, int s, int h, int w, int border,
    int iters, float contrast_thresh, float edge_r, float edge_k) {
  const int q = blockIdx.x * THREADS + threadIdx.x;
  if (q >= n * c) return;
  const int img = q / c;
  const int64_t hw = (int64_t)h * w;
  const float* dg = dog + (size_t)img * (s + 2) * hw;
  int64_t l = l0[q], y = y0[q], x = x0[q];
  bool conv = false;
  for (int it = 0; it < iters; ++it) {
    const int32_t word = p360::newton_word(dog, img, s, (int)l, (int)y,
                                           (int)x, h, w);
    conv = (word & 1) > 0;
    if (conv) break;
    const int64_t nx = clamp64(x + ((word >> 1) & 3) - 1, border,
                               w - 1 - border);
    const int64_t ny = clamp64(y + ((word >> 3) & 3) - 1, border,
                               h - 1 - border);
    const int64_t nl = clamp64(l + ((word >> 5) & 3) - 1, 1, s);
    if (nl == l && ny == y && nx == x) break;
    l = nl;
    y = ny;
    x = nx;
  }

  // the cube c[layer][row][col], the plain gather's clamped flat indices
  const int64_t last = (int64_t)(s + 2) * hw - 1;
  float cb[3][3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
#pragma unroll
      for (int k = 0; k < 3; ++k)
        cb[i][j][k] = dg[clamp64((l + i - 1) * hw + (y + j - 1) * w +
                                     (x + k - 1), 0, last)];

  const float dd0 = (cb[1][1][2] - cb[1][1][0]) * 0.5f;
  const float dd1 = (cb[1][2][1] - cb[1][0][1]) * 0.5f;
  const float dd2 = (cb[2][1][1] - cb[0][1][1]) * 0.5f;
  const float c111 = cb[1][1][1];
  const float dxx = (cb[1][1][2] - 2.0f * c111) + cb[1][1][0];
  const float dyy = (cb[1][2][1] - 2.0f * c111) + cb[1][0][1];
  const float dss = (cb[2][1][1] - 2.0f * c111) + cb[0][1][1];
  const float dxy =
      (((cb[1][2][2] - cb[1][2][0]) - cb[1][0][2]) + cb[1][0][0]) * 0.25f;
  const float dxs =
      (((cb[2][1][2] - cb[2][1][0]) - cb[0][1][2]) + cb[0][1][0]) * 0.25f;
  const float dys =
      (((cb[2][2][1] - cb[2][0][1]) - cb[0][2][1]) + cb[0][0][1]) * 0.25f;

  // geometry.det3x3 of [[dxx, dxy, dxs], [dxy, dyy, dys], [dxs, dys, dss]]
  const float det = (dxx * (dyy * dss - dys * dys) -
                     dxy * (dxy * dss - dys * dxs)) +
                    dxs * (dxy * dys - dyy * dxs);
  // geometry.inv3x3 of hess + 1e-12 * eye (the off-diagonal + 0 too)
  const float a = dxx + 1e-12f, b = dxy + 0.0f, cc = dxs + 0.0f;
  const float d = dxy + 0.0f, e = dyy + 1e-12f, f = dys + 0.0f;
  const float g = dxs + 0.0f, hh = dys + 0.0f, i = dss + 1e-12f;
  const float co00 = e * i - f * hh, co01 = cc * hh - b * i,
              co02 = b * f - cc * e;
  const float co10 = f * g - d * i, co11 = a * i - cc * g,
              co12 = cc * d - a * f;
  const float co20 = d * hh - e * g, co21 = b * g - a * hh,
              co22 = a * e - b * d;
  const float deti = (a * co00 + d * co01) + g * co02;
  const float inv[3][3] = {{co00 / deti, co01 / deti, co02 / deti},
                           {co10 / deti, co11 / deti, co12 / deti},
                           {co20 / deti, co21 / deti, co22 / deti}};
  const bool use = conv && fabsf(det) > 1e-20f;
  float o[3];
#pragma unroll
  for (int r = 0; r < 3; ++r)
    o[r] = use ? -((inv[r][0] * dd0 + inv[r][1] * dd1) + inv[r][2] * dd2)
               : 0.0f;
  const float con = c111 + 0.5f * ((dd0 * o[0] + dd1 * o[1]) + dd2 * o[2]);
  const float tr = dxx + dyy;
  const float det2 = dxx * dyy - dxy * dxy;
  const bool edge_ok = det2 > 0.0f && (tr * tr) * edge_r < edge_k * det2;
  const bool contrast_ok = fabsf(con) * (float)s >= contrast_thresh;

  lo[q] = l;
  yo[q] = y;
  xo[q] = x;
  offs[3 * (size_t)q] = o[0];
  offs[3 * (size_t)q + 1] = o[1];
  offs[3 * (size_t)q + 2] = o[2];
  contrast[q] = con;
  ok[q] = conv && edge_ok && contrast_ok;
}

}  // namespace

extern "C" int p360_sift_refine(const float* dog, const int64_t* l0,
                                const int64_t* y0, const int64_t* x0,
                                int64_t* l, int64_t* y, int64_t* x,
                                float* offs, float* contrast,
                                uint8_t* ok, int n, int c, int s, int h,
                                int w, int border, int iters,
                                float contrast_thresh, float edge_r,
                                float edge_k, void* stream) {
  if (n <= 0 || c <= 0 || s <= 0 || h <= 0 || w <= 0 || iters < 0)
    return (int)cudaErrorInvalidValue;
  const int blocks = (int)(((long long)n * c + THREADS - 1) / THREADS);
  p360_sift_refine_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      dog, l0, y0, x0, l, y, x, offs, contrast, ok, n, c, s, h, w,
      border, iters, contrast_thresh, edge_r, edge_k);
  return (int)cudaGetLastError();
}
