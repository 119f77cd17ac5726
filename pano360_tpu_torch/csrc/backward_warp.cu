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
// zeroed where invalid.
//
// What bounds it on an H100: bytes, in scattered 32-byte sectors. Each
// output pixel reads four RGBA taps (4 x 16 B, shared with neighbours
// through L2) and writes 16 B plus a mask byte; the ~60 flops of the
// projection (sinf/tanf/cosf) are small beside that. The design is one
// thread per output pixel with one 16-byte float4 load per tap straight
// from the (N, H, W, 4) stack: the card gathers directly, so the TPU
// kernel's per-tile source windows and one-hot sampling matmuls (needed
// only because Mosaic has no vector gather) are gone, and the same exact
// kernel serves every resolution and both projections. Coordinates are
// clamped in float before the integer conversion, so a ray near z = 0
// (huge or NaN x_pr) never hits an undefined cast; such pixels are
// invalid anyway.
#include <stdint.h>

#include "warp_common.cuh"

namespace {

__device__ __forceinline__ int reflect_idx(int i, int n) {
  // cv2.BORDER_REFLECT (fedcba|abcdef|fedcba), any distance
  if (n == 1) return 0;
  const int period = 2 * n;
  int m = i % period;
  if (m < 0) m += period;
  return m < n ? m : period - 1 - m;
}

__global__ void backward_warp_kernel(
    const float4* __restrict__ imgs, const float* __restrict__ projs,
    const float* __restrict__ bottoms, const float* __restrict__ wins,
    float4* __restrict__ patches, uint8_t* __restrict__ invalid, int h,
    int w, int ph, int pw, float res_x, float res_y, float rmin_x,
    float rmin_y, int period, int cylindrical) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y;
  const int r = blockIdx.z;
  if (x >= pw) return;

  const float px = (float)x + bottoms[2 * r];
  const float py = (float)y + bottoms[2 * r + 1];
  const p360::Ray ray = p360::mosaic_ray(projs + 9 * r, px, py, res_x, res_y,
                                         rmin_x, rmin_y, period, cylindrical);
  const float x_pr = ray.u / ray.z + (float)w * 0.5f;
  const float y_pr = ray.v / ray.z + (float)h * 0.5f;
  bool bad = ray.z < 0.0f;
  bad |= (x_pr < 0.0f) | (x_pr > (float)(w - 1)) | (y_pr < 0.0f) |
         (y_pr > (float)(h - 1));
  bad |= p360::outside_window(wins + 4 * r, px, py);

  const float xc = p360::clamp_coord(x_pr, 4.0f * (float)w);
  const float yc = p360::clamp_coord(y_pr, 4.0f * (float)h);
  const float x0f = floorf(xc);
  const float y0f = floorf(yc);
  const float fx = xc - x0f;
  const float fy = yc - y0f;
  const int x0 = (int)x0f;
  const int y0 = (int)y0f;
  const int ix0 = reflect_idx(x0, w);
  const int ix1 = reflect_idx(x0 + 1, w);
  const int iy0 = reflect_idx(y0, h);
  const int iy1 = reflect_idx(y0 + 1, h);
  const float4* img = imgs + (size_t)r * h * w;
  const float4 top = p360::lerp4(img[(size_t)iy0 * w + ix0],
                                 img[(size_t)iy0 * w + ix1], fx);
  const float4 bot = p360::lerp4(img[(size_t)iy1 * w + ix0],
                                 img[(size_t)iy1 * w + ix1], fx);
  float4 out = p360::lerp4(top, bot, fy);
  if (bad) out.w = 0.0f;
  const size_t o = ((size_t)r * ph + y) * pw + x;
  patches[o] = out;
  invalid[o] = bad ? 1 : 0;
}

}  // namespace

extern "C" int p360_backward_warp(const float* imgs, const float* projs,
                                  const float* bottoms, const float* wins,
                                  float* patches, uint8_t* invalid, int n,
                                  int h, int w, int ph, int pw, float res_x,
                                  float res_y, float rmin_x, float rmin_y,
                                  int period, int cylindrical, void* stream) {
  if (n <= 0 || ph <= 0 || pw <= 0 || ph > 65535 || n > 65535)
    return (int)cudaErrorInvalidValue;
  const int threads = 128;
  const dim3 grid((pw + threads - 1) / threads, ph, n);
  backward_warp_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      reinterpret_cast<const float4*>(imgs), projs, bottoms, wins,
      reinterpret_cast<float4*>(patches), invalid, h, w, ph, pw, res_x,
      res_y, rmin_x, rmin_y, period, cylindrical);
  return (int)cudaGetLastError();
}
