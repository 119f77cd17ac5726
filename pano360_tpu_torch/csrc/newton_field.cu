// The packed Newton step of every DoG pixel of layers 1..S.
//
// Replaces: pano360_tpu/features/sift.py, _newton_step_field (:403), which
// XLA fuses into one loop over the DoG stack; no Pallas kernel lies
// behind it. The plain version is features/sift.py _newton_step_field:
// per pixel the 3x3x3 finite differences (rolls along x and y, so the
// border pixels wrap around as torch.roll wraps), the Hessian's
// determinant, the closed-form adjugate solve on the 1e-12-regularised
// diagonal, and one int32 word: bit 0 converged (all |offset| < 0.5),
// bits 1-2 / 3-4 / 5-6 = clamp(round(offset), -1, 1) + 1 for x, y, layer.
// Every operation is the plain version's, in its order, each rounded on
// its own (-fmad=false, IEEE division, rintf for torch.round, a NaN kept
// through the clamp and cast as PyTorch's kernels do), so the two agree
// bit for bit on the card.
//
// What bounds it on an H100: bytes. A pixel reads its 19 stencil values
// from three DoG planes and writes one word: ~130 operations against
// (S+2)/S * 4 + 4 bytes, below the card's ~20 f32 operations per byte
// of device memory. The plain version makes ~150 full-size passes (24 of
// them rolls); this kernel reads the stack once and writes the field
// once. The design: one thread per output pixel, a row of a plane per
// block row, x fastest, so a warp's loads of each plane are contiguous
// and the neighbours' loads hit the same lines in L1 and L2.
#include <stdint.h>

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ int32_t step_bits(float o) {
  // clamp(round(o), -1, 1).to(int32) + 1, with torch.clamp's NaN kept
  float r = rintf(o);
  if (!isnan(r)) r = fminf(fmaxf(r, -1.0f), 1.0f);
  return (int32_t)r + 1;
}

__global__ void p360_newton_field_kernel(const float* __restrict__ dog,
                                         int32_t* __restrict__ field,
                                         int n_lay, int h, int w) {
  const int x = blockIdx.x * THREADS + threadIdx.x;
  if (x >= w) return;
  const int y = blockIdx.y;
  const int img = blockIdx.z / n_lay, l = blockIdx.z % n_lay;
  const size_t plane = (size_t)h * w;
  const float* cl = dog + ((size_t)img * (n_lay + 2) + l) * plane;
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
  field[(size_t)blockIdx.z * plane + r0 + x] =
      (int32_t)conv | (step_bits(ox) << 1) | (step_bits(oy) << 3) |
      (step_bits(ol) << 5);
}

}  // namespace

extern "C" int p360_newton_field(const float* dog, int32_t* field, int n,
                                 int nl, int h, int w, void* stream) {
  if (n <= 0 || nl < 3 || h <= 0 || w <= 0 || h > 65535 ||
      (long long)n * (nl - 2) > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((w + THREADS - 1) / THREADS, h, n * (nl - 2));
  p360_newton_field_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      dog, field, nl - 2, h, w);
  return (int)cudaGetLastError();
}
