// Mip-sampled backward warp of every region into its mosaic patch.
//
// Replaces: pano360_tpu/ops/pallas_warp.py, pallas_backward_warp with
// n_levels > 1 (the `--warp pallas` path under minification): the Pallas
// kernel _make_warp_kernel, whose output tiles of TILE_Y x TILE_X = 32 x
// 128 pixels each sample one (win_y, win_x) source window of one level of
// a 2x box mip pyramid (build_mips), at the window origin and level that
// plan_windows chose for the tile. Per output pixel (n, y, x): the tile's
// (oy, ox, lvl); the mosaic ray as in the exact kernel; validity from
// z < 0, the TRUE level-0 image bounds and the region's true window
// (render._mask_and_blend's wins, folded in here); the level coordinate
// (x_pr + 0.5) * 2^-lvl - 0.5 - ox (every tile, level 0 included);
// bilinear taps clamped into [0, win - 2] of the window, with the
// fraction of the unclamped coordinate, as the Pallas kernel's one-hot
// weights give; alpha zeroed where invalid.
//
// What bounds it on an H100: bytes, as in the exact kernel: four 16-byte
// taps and a 17-byte write per output pixel. At the bench plan (15
// patches of 192x256, every tile at level 2, ~1.3x minification there)
// the taps touch 1.10 M distinct level texels (with the 12.5 MB of
// output, 30.2 MB: the bound) in 0.55 M 32-byte sectors, each sector's
// two texels both used: the sector floor is the bound. Timed with the L2
// flushed before each launch, the kernel reads its level from device
// memory and the bound applies; in the render, build_mips writes the 20
// MB level just before the launch, so the level is mostly in the 50 MB L2
// and the launch takes less than that bound. `chip_smoke.py` phase 7 B
// prints both times.
//
// The design: one block per 32x128 output tile of one region, the plan's
// own unit. One thread loads the tile's (oy, ox, lvl), level base
// pointer, row width and scale once into shared memory; they stay
// block-uniform. The mapping's trigonometry runs once per column and
// once per row into shared tables (warp_common.cuh); a thread owns a
// column and walks TILE_Y / RY rows. At most 64 registers, so two
// 512-thread blocks share an SM (the 180 tiles of the bench plan run in
// one wave); each thread has one pixel's four taps in flight through
// the read-only path (two pixels' measured slower at the same
// occupancy). Stores are write-back and coalesced along x. The level
// buffers are interleaved (N, Hl, Wl, 4) float32, their pointers and
// padded dims passed by value (at most MAX_LEVELS, whatever the region
// count). The TPU kernel DMAs the window into VMEM and samples it through
// one-hot matmuls only because Mosaic has no vector gather; the card
// gathers directly, so neither the copy nor the matmuls carry over. What
// the window still decides is the clamping of taps, which shapes the RGB
// left on invalid pixels (multiband blurs it into valid neighbours).
#include <stdint.h>

#include "warp_common.cuh"

namespace {

constexpr int TILE_Y = 32;
constexpr int TILE_X = 128;
constexpr int RY = 4;      // threads in y; each walks TILE_Y / RY rows
constexpr int MAX_LEVELS = 16;
// |v| >= 2^23 holds only integers in float32, so clamping there keeps
// every fraction the unclamped coordinate has
constexpr float COORD_LIM = 16777216.0f;
static_assert(TILE_X + TILE_Y < TILE_X * RY,
              "the tables and the tile's origin need TILE_X + TILE_Y + 1 "
              "threads");

struct MipLevels {
  const float4* ptr[MAX_LEVELS];  // (N, hp, wp, 4) float32 per level
  int hp[MAX_LEVELS];
  int wp[MAX_LEVELS];
};

}  // namespace

// A launch's scalars beyond the exact warp's, built once per plan on the
// host (warp_mip.prepare_mip_warp's ctypes structure of the same layout).
struct MipLaunch {
  p360::View vw;
  int h, w;           // the TRUE level-0 image
  int win_y, win_x;   // the window every tile samples
  int n_levels;
  int hp[MAX_LEVELS];  // each level's padded dims
  int wp[MAX_LEVELS];
};

namespace {

// The tile's level and window, the same for every thread of the block.
struct TileLevel {
  const float4* img;  // region r's buffer at the tile's level
  int wp, oy, ox;
  float scale;
};

__global__ void __launch_bounds__(TILE_X * RY, 2) backward_warp_mip_kernel(
    MipLevels lv, const int4* __restrict__ origins,
    const float* __restrict__ params, float4* __restrict__ patches,
    uint8_t* __restrict__ invalid, int h, int w, int ntx, int win_y,
    int win_x, p360::View vw) {
  __shared__ p360::Terms<TILE_X, TILE_Y> s;
  __shared__ TileLevel tl;
  const int r = blockIdx.y;
  const int x0 = (blockIdx.x % ntx) * TILE_X;
  const int y0 = (blockIdx.x / ntx) * TILE_Y;
  const int t = threadIdx.y * TILE_X + threadIdx.x;
  p360::build_terms(s, params + p360::PARAM_FLOATS * r, x0, y0, t, vw);
  if (t == TILE_X + TILE_Y) {
    const int4 org = origins[(size_t)r * gridDim.x + blockIdx.x];
    const int lvl = org.z;
    tl.img = lv.ptr[lvl] + (size_t)r * lv.hp[lvl] * lv.wp[lvl];
    tl.wp = lv.wp[lvl];
    tl.oy = org.x;
    tl.ox = org.y;
    tl.scale = 1.0f / (float)(1 << lvl);
  }
  __syncthreads();
  const int x = x0 + threadIdx.x;
  if (x >= vw.pw) return;

  const p360::ColTerms col = s.col[threadIdx.x];
  const TileLevel L = tl;
  const float half_w = (float)w * 0.5f;
  const float half_h = (float)h * 0.5f;
  const float wm1 = (float)(w - 1);
  const float hm1 = (float)(h - 1);
#pragma unroll
  for (int k = 0; k < TILE_Y / RY; ++k) {
    const int ly = threadIdx.y + RY * k;
    const int y = y0 + ly;
    if (y >= vw.ph) break;
    const p360::RowTerms row = s.row[ly];
    const p360::Ray ray = p360::pixel_ray(col, row);
    const float zs = fabsf(ray.z) > 1e-12f ? ray.z : 1e-12f;
    const float x_pr = ray.u / zs + half_w;
    const float y_pr = ray.v / zs + half_h;
    p360::Taps tp;
    tp.bad = (ray.z < 0.0f) | (x_pr < 0.0f) | (x_pr > wm1) | (y_pr < 0.0f) |
             (y_pr > hm1) | (col.out != 0) | (row.out != 0);
    const float lx = p360::clamp_coord(
        (x_pr + 0.5f) * L.scale - 0.5f - (float)L.ox, COORD_LIM);
    const float ly_f = p360::clamp_coord(
        (y_pr + 0.5f) * L.scale - 0.5f - (float)L.oy, COORD_LIM);
    const float x0f = floorf(lx);
    const float y0f = floorf(ly_f);
    tp.fx = lx - x0f;
    tp.fy = ly_f - y0f;
    const int ix = min(max((int)x0f, 0), win_x - 2) + L.ox;
    const int iy = min(max((int)y0f, 0), win_y - 2) + L.oy;
    const float4* row0 = L.img + (size_t)iy * L.wp + ix;
    const float4* row1 = row0 + L.wp;
    tp.t00 = p360::load_tap(row0);
    tp.t01 = p360::load_tap(row0 + 1);
    tp.t10 = p360::load_tap(row1);
    tp.t11 = p360::load_tap(row1 + 1);
    const size_t o = ((size_t)r * vw.ph + y) * vw.pw + x;
    patches[o] = p360::blend(tp);
    invalid[o] = tp.bad ? 1 : 0;
  }
}

}  // namespace

// a: the plan's launch scalars (host); level_ptrs: host array of
// a->n_levels device pointers; origins: (n, nty, ntx) int4 [oy, ox, lvl,
// 0] on the device and params (n, PARAM_FLOATS) float32 on the device,
// both packed by warp_mip.prepare_mip_warp, which has checked every tile
// origin: 0 <= lvl < n_levels, oy + win_y <= hp, ox + win_x <= wp.
// invalid: n * ph * pw bytes, written 0/1 (a torch.bool tensor).
extern "C" int p360_backward_warp_mip(const MipLaunch* a,
                                      const void* const* level_ptrs,
                                      const int* origins,
                                      const float* params, float* patches,
                                      uint8_t* invalid, void* stream) {
  const int n = a->vw.n, ph = a->vw.ph, pw = a->vw.pw;
  if (n <= 0 || ph <= 0 || pw <= 0 || n > 65535 || a->n_levels < 1 ||
      a->n_levels > MAX_LEVELS || a->win_y < 2 || a->win_x < 2)
    return (int)cudaErrorInvalidValue;
  MipLevels lv = {};
  for (int l = 0; l < a->n_levels; ++l) {
    lv.ptr[l] = static_cast<const float4*>(level_ptrs[l]);
    lv.hp[l] = a->hp[l];
    lv.wp[l] = a->wp[l];
    if (lv.hp[l] < a->win_y || lv.wp[l] < a->win_x)
      return (int)cudaErrorInvalidValue;
  }
  const int ntx = (pw + TILE_X - 1) / TILE_X;
  const long long tiles = (long long)ntx * ((ph + TILE_Y - 1) / TILE_Y);
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)tiles, n);
  const dim3 block(TILE_X, RY);
  backward_warp_mip_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      lv, reinterpret_cast<const int4*>(origins), params,
      reinterpret_cast<float4*>(patches), invalid, a->h, a->w, ntx,
      a->win_y, a->win_x, a->vw);
  return (int)cudaGetLastError();
}
