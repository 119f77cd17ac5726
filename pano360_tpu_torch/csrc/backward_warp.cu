// Backward warp of every region into its bbox-padded mosaic patch.
//
// Replaces: pano360_tpu/ops/pallas_warp.py, pallas_backward_warp (the
// Pallas kernel _make_warp_kernel with _tile_coords and _project) at mip
// level 0, which computes what render.backward_warp_all computes. Per
// output pixel (n, y, x): mosaic pixel -> (theta, phi), with columns past
// the periodic seam sampling at their final azimuth; the spherical ray
// (sin theta, tan phi, cos theta), or the cylindrical one (sin theta, h,
// cos theta), times K R, divided by z; the pixel is invalid when z < 0,
// when it falls outside [0, w-1] x [0, h-1], or when it lies outside the
// region's true window (backward_warp_all's wins); then bilinear RGBA
// sampling with BORDER_REFLECT indexing (ops.warp.reflect_index), alpha
// zeroed where invalid. Images of mixed sizes come zero-padded into one
// (n, h, w) stack with each region's true (h_k, w_k) in its parameter
// row (backward_warp_all's shapes): the centre offset and the bounds
// test take the true size, the reflect indexing and the row stride the
// stack's.
//
// What bounds it on an H100: bytes, gathered from device memory. Each
// output pixel reads four RGBA taps (4 x 16 B) and writes 16 B plus a
// mask byte. At the bench layout (15 patches of 192x256 from 864x1152
// views, ~5x minification) the taps touch 2.80 M distinct texels (with
// the 12.5 MB of output, 57.3 MB: the bound) in 2.06 M distinct 32-byte
// sectors, 1.66 M 64-byte segments and 0.97 M 128-byte lines: at 5x
// minification no source row serves two output rows and neighbouring
// pixels' taps lie 5 texels apart, so a sector carries 1.4 used texels
// of its two. At the 4000-px cap (~1x) every sector's two texels are
// used and the kernel comes near its bound; at the bench layout it does
// not, and `chip_smoke.py` phase 4 prints both at the bench layout
// (device time with the L2 flushed, against the bound and the sector
// count).
//
// The design: one thread per output pixel, 128 pixels of one row per
// block, one 16-byte load per tap through the read-only path. The
// region's K R, patch origin and true window come from one packed
// parameter row and the launch's scalars by value (warp_kernel.
// prepare_warp builds both once per render), so a launch waits on no
// host copy; the mask is written as bool bytes. The mapping runs per
// pixel (warp_common.cuh col_terms, row_terms): a version with one block
// per 2-D tile, the trigonometry in per-column and per-row shared tables
// and eight tap loads in flight per thread measured no faster on the
// card, as the gather, not the per-pixel chain, sets the time. The TPU
// kernel's per-tile source windows and one-hot sampling matmuls (needed
// only because Mosaic has no vector gather) are gone: the card gathers
// directly, and the same kernel serves every resolution and both
// projections. Coordinates are clamped in float before the integer
// conversion, so a ray near z = 0 (huge or NaN x_pr) never hits an
// undefined cast; such pixels are invalid anyway.
#include <stdint.h>

#include "warp_common.cuh"

namespace {

constexpr int THREADS = 128;  // patch columns per block

__device__ __forceinline__ int reflect_idx(int i, int n) {
  // cv2.BORDER_REFLECT (fedcba|abcdef|fedcba), any distance
  if ((unsigned)i < (unsigned)n) return i;
  if (n == 1) return 0;
  const int period = 2 * n;
  int m = i % period;
  if (m < 0) m += period;
  return m < n ? m : period - 1 - m;
}

__global__ void __launch_bounds__(THREADS) backward_warp_kernel(
    const float4* __restrict__ imgs, const float* __restrict__ params,
    float4* __restrict__ patches, uint8_t* __restrict__ invalid, int h,
    int w, p360::View vw) {
  const int x = blockIdx.x * THREADS + threadIdx.x;
  const int y = blockIdx.y;
  const int r = blockIdx.z;
  if (x >= vw.pw) return;

  const float* prm = params + p360::PARAM_FLOATS * r;
  const p360::ColTerms col = p360::col_terms(prm, x, vw);
  const p360::RowTerms row = p360::row_terms(prm, y, vw);
  const p360::Ray ray = p360::pixel_ray(col, row);
  // the region's true size; a zero entry means the stack's
  const float hk = prm[15] > 0.0f ? prm[15] : (float)h;
  const float wk = prm[16] > 0.0f ? prm[16] : (float)w;
  const float x_pr = ray.u / ray.z + wk * 0.5f;
  const float y_pr = ray.v / ray.z + hk * 0.5f;
  p360::Taps tp;
  tp.bad = (ray.z < 0.0f) | (x_pr < 0.0f) | (x_pr > wk - 1.0f) |
           (y_pr < 0.0f) | (y_pr > hk - 1.0f) | (col.out != 0) |
           (row.out != 0);
  const float xc = p360::clamp_coord(x_pr, 4.0f * (float)w);
  const float yc = p360::clamp_coord(y_pr, 4.0f * (float)h);
  const float x0f = floorf(xc);
  const float y0f = floorf(yc);
  tp.fx = xc - x0f;
  tp.fy = yc - y0f;
  const int ix = (int)x0f;
  const int iy = (int)y0f;
  const int ix0 = reflect_idx(ix, w);
  const int ix1 = reflect_idx(ix + 1, w);
  const float4* img = imgs + (size_t)r * h * w;
  const float4* row0 = img + (size_t)reflect_idx(iy, h) * w;
  const float4* row1 = img + (size_t)reflect_idx(iy + 1, h) * w;
  tp.t00 = p360::load_tap(row0 + ix0);
  tp.t01 = p360::load_tap(row0 + ix1);
  tp.t10 = p360::load_tap(row1 + ix0);
  tp.t11 = p360::load_tap(row1 + ix1);
  const size_t o = ((size_t)r * vw.ph + y) * vw.pw + x;
  patches[o] = p360::blend(tp);
  invalid[o] = tp.bad ? 1 : 0;
}

}  // namespace

// vw: the plan's launch scalars (host); params: (n, PARAM_FLOATS)
// float32 per region on the device (K R, bottom, true window, true
// size; warp_kernel.prepare_warp packs both); imgs: (n, h, w, 4) float32;
// invalid: n * ph * pw bytes, written 0/1 (a torch.bool tensor).
extern "C" int p360_backward_warp(const p360::View* vw, const float* imgs,
                                  int h, int w, const float* params,
                                  float* patches, uint8_t* invalid,
                                  void* stream) {
  const int n = vw->n, ph = vw->ph, pw = vw->pw;
  if (n <= 0 || ph <= 0 || pw <= 0 || h <= 0 || w <= 0 || ph > 65535 ||
      n > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((pw + THREADS - 1) / THREADS, ph, n);
  backward_warp_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      reinterpret_cast<const float4*>(imgs), params,
      reinterpret_cast<float4*>(patches), invalid, h, w, *vw);
  return (int)cudaGetLastError();
}
