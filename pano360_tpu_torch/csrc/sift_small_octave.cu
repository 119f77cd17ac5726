// One small SIFT octave in one launch: the per-layer Gaussian chain, the
// DoG stack and the dense extrema score, a block per image.
//
// Replaces: pano360_tpu/features/sift.py:216, _gaussian_stack, and the
// dense score of :308, _octave_candidates, which XLA fuses inside the
// jitted extraction; no Pallas kernel lies behind them. It runs where the
// octave kernel's single reflect101 extension is not defined (the chain's
// halo, 42 at S = 3, reaches min(h, w): octaves 6-8 of the bench's
// 1728x2304 base, 27x36 down to 7x9). Semantics are the plain version's
// (ops/sift_front.py:small_octave_ref):
// - each layer is the blur of the one before (the chain_taps taps: 11,
//   13, 17, 21 and 27 at S = 3), along H, then along W, each pass folding
//   reflect101 on that layer's own h x w grid (pads wider than the image
//   included) and summing its taps from the first, a multiply then an add
//   each (built with -fmad=false), in ascending order;
// - DoG l is layer l + 1 minus layer l;
// - the score of DoG layers 1..S is |DoG| where the value is a 3x3x3
//   extremum (neighbours outside the image left out) past +-thresh, lies
//   >= border px inside the image and passes the edge test on its
//   integer derivatives, each 0 on the image's edge rows or columns (the
//   zero pads of gauss_octave._extrema_score); else +0.
// Bit-identical to the plain version. The octave kernel's score reads a
// reflected ring at the image's edge instead, so the two share no code.
//
// What bounds it on an H100: latency. An octave of the bench is a few
// hundred KB (27x36 x 4 views x 15 planes: 0.23 MB, 0.07 us at 3.35
// TB/s); its 10 passes and 3 score planes are a chain of dependent steps
// inside one block per image. So the whole chain is one launch, its
// passes separated by __syncthreads: where 6 planes of an image (the
// current and the next layer, the vertical pass, 3 DoG slots) fit a
// block's shared memory, they live there and only the outputs are
// written; a longer octave (a strip: min side <= 42, the other long)
// runs the same passes through device memory, each layer in its output
// plane and the vertical pass in a scratch plane. 1024 threads a block,
// a pixel each at the bench's 27x36 and smaller; the taps are copied to
// shared memory once.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int THREADS = 1024;
constexpr int MAX_LAYERS = 8;
constexpr int MAX_TAPS = 63;
constexpr int SMEM_PLANES = 6;
// the opt-in shared memory of a block, less the taps' static copy
constexpr size_t SMEM_MAX = 232448 - sizeof(float) * MAX_LAYERS * MAX_TAPS;

struct ChainSpec {
  float taps[MAX_LAYERS * MAX_TAPS];
  int k[MAX_LAYERS];
  int n_lay;
};

// cv2.BORDER_REFLECT_101 for any index (ops.filters.reflect101_index)
__device__ __forceinline__ int fold(int i, int n) {
  if (i >= 0 && i < n) return i;
  if (n == 1) return 0;
  const int period = 2 * n - 2;
  int m = i % period;
  if (m < 0) m += period;
  return m < n ? m : period - m;
}

// Buffers below are generic pointers into shared or device memory, read
// after the block wrote them (behind a barrier): no __restrict__, no
// read-only loads.

// t(y, x) = sum_i s(fold(y - K/2 + i), x) k[i]
__device__ void vertical(const float* s, float* t, int h, int w,
                         const float* k, int kk) {
  const int hh = kk / 2;
  for (int p = threadIdx.x; p < h * w; p += THREADS) {
    const int y = p / w;
    const int x = p - y * w;
    float acc = s[fold(y - hh, h) * w + x] * k[0];
#pragma unroll 4
    for (int i = 1; i < kk; ++i)
      acc = acc + s[fold(y - hh + i, h) * w + x] * k[i];
    t[p] = acc;
  }
}

// next(y, x) = sum_i t(y, fold(x - K/2 + i)) k[i], and its DoG against
// cur; each also into a second buffer where that is not the same (the
// outputs, when the layers live in shared memory)
__device__ void horizontal(const float* t, const float* cur, float* next,
                           float* next_out, float* d, float* d_out, int h,
                           int w, const float* k, int kk) {
  const int hh = kk / 2;
  for (int p = threadIdx.x; p < h * w; p += THREADS) {
    const int y = p / w;
    const int x = p - y * w;
    const float* row = t + y * w;
    float acc = row[fold(x - hh, w)] * k[0];
#pragma unroll 4
    for (int i = 1; i < kk; ++i) acc = acc + row[fold(x - hh + i, w)] * k[i];
    const float dg = acc - cur[p];
    next[p] = acc;
    d[p] = dg;
    if (next_out != next) next_out[p] = acc;
    if (d_out != d) d_out[p] = dg;
  }
}

// the score of DoG layer mid from its neighbours lo and hi
__device__ void score_plane(const float* lo, const float* mid, const float* hi,
                            float* out, int h, int w, float thresh,
                            float edge_r, int border) {
  const float r2 = (edge_r + 1.0f) * (edge_r + 1.0f);
  for (int p = threadIdx.x; p < h * w; p += THREADS) {
    const int y = p / w;
    const int x = p - y * w;
    const float c = mid[p];
    float mx = -INFINITY;
    float mn = INFINITY;
    for (int yy = max(y - 1, 0); yy <= min(y + 1, h - 1); ++yy)
      for (int xx = max(x - 1, 0); xx <= min(x + 1, w - 1); ++xx) {
        const int q = yy * w + xx;
        mx = fmaxf(mx, fmaxf(lo[q], fmaxf(mid[q], hi[q])));
        mn = fminf(mn, fminf(lo[q], fminf(mid[q], hi[q])));
      }
    float sc = 0.0f;
    const bool ext = ((c >= mx && c > thresh) || (c <= mn && c < -thresh)) &&
                     y >= border && y < h - border && x >= border &&
                     x < w - border;
    if (ext) {
      const bool in_x = x > 0 && x < w - 1;
      const bool in_y = y > 0 && y < h - 1;
      const float dxx = in_x ? mid[p + 1] - 2.0f * c + mid[p - 1] : 0.0f;
      const float dyy = in_y ? mid[p + w] - 2.0f * c + mid[p - w] : 0.0f;
      const float dxy = in_x && in_y
                            ? (mid[p + w + 1] - mid[p + w - 1] -
                               mid[p - w + 1] + mid[p - w - 1]) * 0.25f
                            : 0.0f;
      const float tr = dxx + dyy;
      const float det = dxx * dyy - dxy * dxy;
      if (det > 0.0f && tr * tr * edge_r < r2 * det) sc = fabsf(c);
    }
    out[p] = sc;
  }
}

__global__ void __launch_bounds__(THREADS)
p360_sift_small_octave_kernel(const float* __restrict__ base, float* gauss,
                              float* dog, float* score, float* scratch, int h,
                              int w, const __grid_constant__ ChainSpec spec,
                              float thresh, float edge_r, int border) {
  extern __shared__ float smem[];
  // the taps, read by every thread at every tap: a copy in shared memory
  __shared__ float taps[MAX_LAYERS * MAX_TAPS];
  const size_t plane = (size_t)h * w;
  const int nl = spec.n_lay;
  const int n = blockIdx.x;
  const float* src = base + n * plane;
  float* g_out = gauss + n * (nl + 1) * plane;
  float* d_out = dog + n * nl * plane;
  float* s_out = score + n * (nl - 2) * plane;
  const bool shared = scratch == nullptr;
  float* cur = shared ? smem : g_out;
  float* next = shared ? smem + plane : nullptr;
  float* t = shared ? smem + 2 * plane : scratch + n * plane;
  float* dring = smem + 3 * plane;  // the 3 DoG slots (shared only)

  for (int i = threadIdx.x; i < nl * MAX_TAPS; i += THREADS)
    taps[i] = spec.taps[i];
  for (int p = threadIdx.x; p < (int)plane; p += THREADS) {
    const float v = src[p];
    g_out[p] = v;
    if (shared) cur[p] = v;
  }
  __syncthreads();
  for (int li = 0; li < nl; ++li) {
    const float* k = taps + li * MAX_TAPS;
    float* g_next = g_out + (li + 1) * plane;
    float* d_li = d_out + li * plane;
    if (!shared) next = g_next;
    float* d = shared ? dring + (li % 3) * plane : d_li;
    vertical(cur, t, h, w, k, spec.k[li]);
    __syncthreads();
    horizontal(t, cur, next, g_next, d, d_li, h, w, k, spec.k[li]);
    __syncthreads();
    // the next layer writes a DoG slot only after its vertical pass's
    // barrier, so this needs none
    if (li >= 2) {
      const float* lo = shared ? dring + ((li - 2) % 3) * plane
                               : d_out + (li - 2) * plane;
      const float* mid = shared ? dring + ((li - 1) % 3) * plane
                                : d_out + (li - 1) * plane;
      score_plane(lo, mid, d, s_out + (li - 2) * plane, h, w, thresh, edge_r,
                  border);
    }
    float* done = cur;
    cur = next;
    if (shared) next = done;
  }
}

}  // namespace

extern "C" int p360_sift_small_octave(const float* base, float* gauss,
                                      float* dog, float* score,
                                      float* scratch, int n, int h, int w,
                                      const float* taps, const int* ksizes,
                                      int n_lay, float thresh, float edge_r,
                                      int border, void* stream) {
  // taps: host (n_lay, MAX_TAPS) row-major, zero past each layer's ksize;
  // scratch: an (n, h, w) device buffer, or null for the shared path
  if (n < 1 || h < 1 || w < 1 || n_lay < 3 || n_lay > MAX_LAYERS)
    return (int)cudaErrorInvalidValue;
  ChainSpec spec;
  spec.n_lay = n_lay;
  for (int li = 0; li < n_lay; ++li) {
    const int k = ksizes[li];
    if (k < 1 || k > MAX_TAPS || k % 2 == 0) return (int)cudaErrorInvalidValue;
    spec.k[li] = k;
  }
  for (int i = 0; i < n_lay * MAX_TAPS; ++i) spec.taps[i] = taps[i];
  size_t smem = 0;
  if (scratch == nullptr) {
    smem = SMEM_PLANES * sizeof(float) * (size_t)h * w;
    if (smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
  }
  // the opt-in shared-memory size is a per-device attribute: raise it
  // only when this launch needs more than was set before
  constexpr int MAX_DEVICES = 64;
  static size_t smem_set[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (smem > 48 * 1024 && (dev >= MAX_DEVICES || smem > smem_set[dev])) {
    err = cudaFuncSetAttribute(p360_sift_small_octave_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    if (dev < MAX_DEVICES) smem_set[dev] = smem;
  }
  p360_sift_small_octave_kernel<<<n, THREADS, smem, (cudaStream_t)stream>>>(
      base, gauss, dog, score, scratch, h, w, spec, thresh, edge_r, border);
  return (int)cudaGetLastError();
}
