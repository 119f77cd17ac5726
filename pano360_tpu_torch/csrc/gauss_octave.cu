// One SIFT octave in one pass: the incremental Gaussian chain, the DoG
// stack and the extrema score, for a batch of octave bases.
//
// Replaces: pano360_tpu/ops/pallas_gauss.py, octave_stack (the Pallas
// kernel _make_kernel). Semantics are the Pallas kernel's: the base is
// reflect101-extended once by the chain's cumulative halo, then each
// layer is a separable blur of the previous one (taps from chain_taps,
// ascending-tap accumulation like ops.filters._conv_axis); the score is
// |DoG| at 26-neighbour extrema past +-thresh that pass the integer
// Hessian edge test and lie >= border px inside the image, else 0.
//
// What bounds it on an H100: device-memory traffic is small (14 f32
// planes written per pixel: 6 Gaussian, 5 DoG, 3 score; the base is read
// once per block), so the design keeps every intermediate layer in
// shared memory: one block loads its 32x64 tile plus a (halo + 1)-pixel
// ring of the base once, runs all blurs there (vertical pass into a
// second buffer, horizontal pass back in place, the valid margin
// shrinking by each layer's half width), and writes only the final
// planes. The DoG of a one-pixel ring around the tile stays in shared
// memory for the 3x3x3 score stencil, so the DoG is never read back.
// The price is the ring: a 43-px ring around a 32x64 tile makes each
// block blur a window 8.6x its tile, ~690 shared-memory tap reads (a
// multiply and an add each) per output pixel, so shared-memory
// bandwidth, not device memory, is the bound of this first version.
// Larger tiles per block (two blocks' rings shared) are the next step.
// No TPU-specific blocking (lane rolls, banded matmuls) is carried over.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int TY = 32;
constexpr int TX = 64;
constexpr int THREADS = 512;
constexpr int MAX_LAYERS = 8;
constexpr int MAX_TAPS = 64;

// Passed by value (2 KB of kernel parameters): the taps never change
// within a run, so no device buffer or host copy is needed per launch.
struct ChainSpec {
  float taps[MAX_LAYERS * MAX_TAPS];
  int half[MAX_LAYERS];
  int n_lay;
  int halo;
};

__device__ __forceinline__ int reflect101_clamped(int i, int n) {
  // one reflection is exact while the halo is below n; indices past it
  // only feed outputs outside the image, so a clamp keeps them in bounds
  if (i < 0) i = -i;
  if (i >= n) i = 2 * n - 2 - i;
  return min(max(i, 0), n - 1);
}

__global__ void __launch_bounds__(THREADS)
octave_stack_kernel(const float* __restrict__ base, float* __restrict__ gauss,
                    float* __restrict__ dog, float* __restrict__ score,
                    int h, int w, const __grid_constant__ ChainSpec spec,
                    float thresh, float edge_r, int border) {
  extern __shared__ float smem[];
  __shared__ float taps[MAX_LAYERS * MAX_TAPS];

  const int nl = spec.n_lay;
  const int m0 = spec.halo + 1;
  const int wy = TY + 2 * m0;
  const int wx = TX + 2 * m0;
  const int ry = TY + 2;
  const int rx = TX + 2;
  float* A = smem;                 // current layer (wy, wx)
  float* B = A + wy * wx;          // vertical-pass result (wy, wx)
  float* D = B + wy * wx;          // DoG ring region (nl, ry, rx)

  const int n = blockIdx.z;
  const int y0 = blockIdx.y * TY;
  const int x0 = blockIdx.x * TX;
  const size_t plane = (size_t)h * w;
  const float* src = base + (size_t)n * plane;
  float* g_out = gauss + (size_t)n * (nl + 1) * plane;
  float* d_out = dog + (size_t)n * nl * plane;

  for (int i = threadIdx.x; i < nl * MAX_TAPS; i += blockDim.x)
    taps[i] = spec.taps[i];
  for (int i = threadIdx.x; i < wy * wx; i += blockDim.x) {
    const int yy = i / wx;
    const int xx = i - yy * wx;
    const int gy = reflect101_clamped(y0 + yy - m0, h);
    const int gx = reflect101_clamped(x0 + xx - m0, w);
    A[i] = src[(size_t)gy * w + gx];
  }
  __syncthreads();

  for (int i = threadIdx.x; i < TY * TX; i += blockDim.x) {
    const int cy = i / TX;
    const int cx = i - cy * TX;
    const int gy = y0 + cy;
    const int gx = x0 + cx;
    if (gy < h && gx < w)
      g_out[(size_t)gy * w + gx] = A[(cy + m0) * wx + cx + m0];
  }

  int m = m0;  // margin around the tile where A holds valid values
  for (int li = 0; li < nl; ++li) {
    const int hh = spec.half[li];
    const int k = 2 * hh + 1;
    const float* t = taps + li * MAX_TAPS;
    const int mn = m - hh;
    const int n0 = m0 - mn;        // first row/col of the new margin
    const int rows = TY + 2 * mn;
    const int vx0 = m0 - m;
    const int vcols = TX + 2 * m;
    for (int i = threadIdx.x; i < rows * vcols; i += blockDim.x) {
      const int yy = n0 + i / vcols;
      const int xx = vx0 + i % vcols;
      const float* col = A + (yy - hh) * wx + xx;
      float acc = col[0] * t[0];
      for (int j = 1; j < k; ++j) acc = acc + col[j * wx] * t[j];
      B[yy * wx + xx] = acc;
    }
    __syncthreads();

    // horizontal pass; each thread reads and rewrites only its own
    // pixel of A, so the update can be in place
    const int hcols = TX + 2 * mn;
    for (int i = threadIdx.x; i < rows * hcols; i += blockDim.x) {
      const int yy = n0 + i / hcols;
      const int xx = n0 + i % hcols;
      const float* row = B + yy * wx + xx - hh;
      float acc = row[0] * t[0];
      for (int j = 1; j < k; ++j) acc = acc + row[j] * t[j];
      const float d = acc - A[yy * wx + xx];
      A[yy * wx + xx] = acc;
      const int cy = yy - m0;
      const int cx = xx - m0;
      if (cy >= -1 && cy <= TY && cx >= -1 && cx <= TX)
        D[(li * ry + cy + 1) * rx + cx + 1] = d;
      if (cy >= 0 && cy < TY && cx >= 0 && cx < TX) {
        const int gy = y0 + cy;
        const int gx = x0 + cx;
        if (gy < h && gx < w) {
          g_out[(size_t)(li + 1) * plane + (size_t)gy * w + gx] = acc;
          d_out[(size_t)li * plane + (size_t)gy * w + gx] = d;
        }
      }
    }
    __syncthreads();
    m = mn;
  }
  if (score == nullptr) return;

  float* s_out = score + (size_t)n * (nl - 2) * plane;
  const float r2 = (edge_r + 1.0f) * (edge_r + 1.0f);
  for (int i = threadIdx.x; i < TY * TX; i += blockDim.x) {
    const int cy = i / TX;
    const int cx = i - cy * TX;
    const int gy = y0 + cy;
    const int gx = x0 + cx;
    if (gy >= h || gx >= w) continue;
    const bool inside = gy >= border && gy < h - border && gx >= border &&
                        gx < w - border;
    for (int li = 1; li < nl - 1; ++li) {
      float sc = 0.0f;
      if (inside) {
        const float* c = D + (li * ry + cy + 1) * rx + cx + 1;
        const float cm = c[0];
        float mx = -INFINITY;
        float mn = INFINITY;
        for (int dl = -1; dl <= 1; ++dl)
          for (int dy = -1; dy <= 1; ++dy)
            for (int dx = -1; dx <= 1; ++dx) {
              const float v = c[(dl * ry + dy) * rx + dx];
              mx = fmaxf(mx, v);
              mn = fminf(mn, v);
            }
        const bool ext = (cm >= mx && cm > thresh) ||
                         (cm <= mn && cm < -thresh);
        const float dxx = c[1] - 2.0f * cm + c[-1];
        const float dyy = c[rx] - 2.0f * cm + c[-rx];
        const float dxy =
            (c[rx + 1] - c[rx - 1] - c[-rx + 1] + c[-rx - 1]) * 0.25f;
        const float tr = dxx + dyy;
        const float det = dxx * dyy - dxy * dxy;
        const bool edge_ok = det > 0.0f && tr * tr * edge_r < r2 * det;
        if (ext && edge_ok) sc = fabsf(cm);
      }
      s_out[(size_t)(li - 1) * plane + (size_t)gy * w + gx] = sc;
    }
  }
}

}  // namespace

extern "C" int p360_octave_stack(const float* base, float* gauss, float* dog,
                                 float* score, int n, int h, int w,
                                 const float* taps, const int* ksizes,
                                 int n_lay, float thresh, float edge_r,
                                 int border, void* stream) {
  // taps: host (n_lay, MAX_TAPS) row-major, zero past each layer's ksize
  if (n_lay < 3 || n_lay > MAX_LAYERS) return (int)cudaErrorInvalidValue;
  ChainSpec spec;
  spec.n_lay = n_lay;
  spec.halo = 0;
  for (int li = 0; li < n_lay; ++li) {
    const int k = ksizes[li];
    if (k < 1 || k > MAX_TAPS || k % 2 == 0) return (int)cudaErrorInvalidValue;
    spec.half[li] = k / 2;
    spec.halo += k / 2;
  }
  for (int i = 0; i < n_lay * MAX_TAPS; ++i) spec.taps[i] = taps[i];
  if (spec.halo >= h || spec.halo >= w) return (int)cudaErrorInvalidValue;
  const int m0 = spec.halo + 1;
  const size_t smem =
      (size_t)(2 * (TY + 2 * m0) * (TX + 2 * m0) + n_lay * (TY + 2) * (TX + 2)) *
      sizeof(float);
  // the opt-in shared-memory size is a per-device attribute: raise it
  // only when this launch needs more than was set before
  constexpr int MAX_DEVICES = 64;
  static size_t smem_set[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= MAX_DEVICES || smem > smem_set[dev]) {
    err = cudaFuncSetAttribute(octave_stack_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    if (dev < MAX_DEVICES) smem_set[dev] = smem;
  }
  const dim3 grid((w + TX - 1) / TX, (h + TY - 1) / TY, n);
  octave_stack_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      base, gauss, dog, score, h, w, spec, thresh, edge_r, border);
  return (int)cudaGetLastError();
}
