// Mip-sampled backward warp of every region into its mosaic patch.
//
// Replaces: pano360_tpu/ops/pallas_warp.py, pallas_backward_warp with
// n_levels > 1 (the `--warp pallas` path under minification): the Pallas
// kernel _make_warp_kernel, whose output tiles of TILE_Y x TILE_X = 32 x
// 128 pixels each sample one (win_y, win_x) source window of one level of
// a 2x box mip pyramid (build_mips), at the window origin and level that
// plan_windows chose for the tile. Per output pixel (n, y, x): the tile's
// (oy, ox, lvl) from `origins`; the mosaic ray as in the exact kernel;
// validity from z < 0, the TRUE level-0 image bounds and the region's
// true window (render._mask_and_blend's wins, folded in here); the level
// coordinate (x_pr + 0.5) * 2^-lvl - 0.5 - ox (every tile, level 0
// included); bilinear taps clamped into [0, win - 2] of the window, with
// the fraction of the unclamped coordinate, as the Pallas kernel's
// one-hot weights give; alpha zeroed where invalid.
//
// What bounds it on an H100: bytes, as in the exact kernel: four 16-byte
// taps and a 17-byte write per output pixel, the taps now from a level
// whose window the tile shares, so neighbouring threads hit the same
// sectors. The design is one thread per output pixel and one float4 load
// per tap from the interleaved (N, Hl, Wl, 4) level buffers, whose
// pointers and padded dims travel by value in the kernel's parameters.
// The TPU kernel DMAs the window into VMEM and samples it through one-hot
// matmuls only because Mosaic has no vector gather; the card gathers
// directly, so neither the copy nor the matmuls carry over. What the
// window still decides is the clamping of taps, which shapes the RGB left
// on invalid pixels (multiband blurs it into valid neighbours).
#include <stdint.h>

#include "warp_common.cuh"

namespace {

constexpr int TILE_Y = 32;
constexpr int TILE_X = 128;
constexpr int MAX_LEVELS = 16;
// |v| >= 2^23 holds only integers in float32, so clamping there keeps
// every fraction the unclamped coordinate has
constexpr float COORD_LIM = 16777216.0f;

struct MipLevels {
  const float4* ptr[MAX_LEVELS];  // (N, hp, wp, 4) float32 per level
  int hp[MAX_LEVELS];
  int wp[MAX_LEVELS];
};

__global__ void backward_warp_mip_kernel(
    MipLevels lv, const int* __restrict__ origins,
    const float* __restrict__ projs, const float* __restrict__ bottoms,
    const float* __restrict__ wins, float4* __restrict__ patches,
    uint8_t* __restrict__ invalid, int h, int w, int ph, int pw, int nty,
    int ntx, int win_y, int win_x, float res_x, float res_y, float rmin_x,
    float rmin_y, int period, int cylindrical) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y;
  const int r = blockIdx.z;
  if (x >= pw) return;

  const int* org = origins + (((size_t)r * nty + y / TILE_Y) * ntx +
                              x / TILE_X) * 3;
  const int oy = org[0];
  const int ox = org[1];
  const int lvl = org[2];

  const float px = (float)x + bottoms[2 * r];
  const float py = (float)y + bottoms[2 * r + 1];
  const p360::Ray ray = p360::mosaic_ray(projs + 9 * r, px, py, res_x, res_y,
                                         rmin_x, rmin_y, period, cylindrical);
  bool bad = ray.z < 0.0f;
  const float zs = fabsf(ray.z) > 1e-12f ? ray.z : 1e-12f;
  const float x_pr = ray.u / zs + (float)w * 0.5f;
  const float y_pr = ray.v / zs + (float)h * 0.5f;
  bad |= (x_pr < 0.0f) | (x_pr > (float)(w - 1)) | (y_pr < 0.0f) |
         (y_pr > (float)(h - 1));
  bad |= p360::outside_window(wins + 4 * r, px, py);

  const float scale = 1.0f / (float)(1 << lvl);
  const float lx = p360::clamp_coord(
      (x_pr + 0.5f) * scale - 0.5f - (float)ox, COORD_LIM);
  const float ly = p360::clamp_coord(
      (y_pr + 0.5f) * scale - 0.5f - (float)oy, COORD_LIM);
  const float x0f = floorf(lx);
  const float y0f = floorf(ly);
  const float fx = lx - x0f;
  const float fy = ly - y0f;
  const int x0 = min(max((int)x0f, 0), win_x - 2) + ox;
  const int y0 = min(max((int)y0f, 0), win_y - 2) + oy;

  const int wp = lv.wp[lvl];
  const float4* img = lv.ptr[lvl] + (size_t)r * lv.hp[lvl] * wp;
  const float4* row0 = img + (size_t)y0 * wp;
  const float4* row1 = row0 + wp;
  const float4 top = p360::lerp4(row0[x0], row0[x0 + 1], fx);
  const float4 bot = p360::lerp4(row1[x0], row1[x0 + 1], fx);
  float4 out = p360::lerp4(top, bot, fy);
  if (bad) out.w = 0.0f;
  const size_t o = ((size_t)r * ph + y) * pw + x;
  patches[o] = out;
  invalid[o] = bad ? 1 : 0;
}

}  // namespace

// level_ptrs: host array of n_levels device pointers; level_dims: host
// array (n_levels, 2) of padded (hp, wp). The wrapper has checked every
// tile origin: 0 <= lvl < n_levels, oy + win_y <= hp, ox + win_x <= wp.
extern "C" int p360_backward_warp_mip(
    const void* const* level_ptrs, const int* level_dims, int n_levels,
    const int* origins, const float* projs, const float* bottoms,
    const float* wins, float* patches, uint8_t* invalid, int n, int h, int w,
    int ph, int pw, int win_y, int win_x, float res_x, float res_y,
    float rmin_x, float rmin_y, int period, int cylindrical, void* stream) {
  if (n <= 0 || ph <= 0 || pw <= 0 || ph > 65535 || n > 65535 ||
      n_levels < 1 || n_levels > MAX_LEVELS || win_y < 2 || win_x < 2)
    return (int)cudaErrorInvalidValue;
  MipLevels lv = {};
  for (int l = 0; l < n_levels; ++l) {
    lv.ptr[l] = static_cast<const float4*>(level_ptrs[l]);
    lv.hp[l] = level_dims[2 * l];
    lv.wp[l] = level_dims[2 * l + 1];
    if (lv.hp[l] < win_y || lv.wp[l] < win_x)
      return (int)cudaErrorInvalidValue;
  }
  const int nty = (ph + TILE_Y - 1) / TILE_Y;
  const int ntx = (pw + TILE_X - 1) / TILE_X;
  const int threads = 128;
  const dim3 grid((pw + threads - 1) / threads, ph, n);
  backward_warp_mip_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      lv, origins, projs, bottoms, wins, reinterpret_cast<float4*>(patches),
      invalid, h, w, ph, pw, nty, ntx, win_y, win_x, res_x, res_y, rmin_x,
      rmin_y, period, cylindrical);
  return (int)cudaGetLastError();
}
