// SIFT's base image: the exact 2x bilinear upsample and the Gaussian blur
// of a batch of gray images, in one pass.
//
// Replaces: pano360_tpu/features/sift.py:164, _base_image, which XLA
// fuses inside the jitted extraction (upsample2x_bilinear's shifted adds,
// then _conv_axis's shifted-slice sums); no Pallas kernel lies behind it.
// Semantics are the plain version's (ops/sift_front.py:base_image_ref):
// - the upsample runs along H, then along W: an even output is
//   0.75 x[i] + 0.25 x[i - 1], an odd one 0.75 x[i] + 0.25 x[i + 1], the
//   neighbour clamped at the edges, each two products and one add;
// - the blur (K taps) runs along H, then along W, each pass folding
//   reflect101 on the upsampled grid and summing its taps from the first,
//   a multiply then an add each (built with -fmad=false), in ascending
//   order.
// Without the upsample (upscale=False) the blur runs on the gray image.
// Bit-identical to the plain version.
//
// What bounds it on an H100: device memory. A batch of 4 views of
// 864x1152 reads 15.9 MB and writes 63.7 MB (0.024 ms at 3.35 TB/s);
// its 2 x (2K - 1) + 6 operations per output (K = 11) take 0.012 ms at
// the 67 TFLOP/s f32 peak. So the upsampled window of a tile lives only
// in shared memory: a block computes it from the gray rows it needs (at
// the folded indices, through the read-only cache), blurs it vertically
// into a second buffer, then horizontally into the output, which is the
// only device-memory write. Tile 32 x 128 outputs, a 256-thread block;
// each thread takes 4 adjacent rows of a column in the vertical pass
// from 4 + K - 1 values it loads once, the taps unrolled (K is a
// template argument, dispatched on the host).
#include <cuda_runtime.h>

namespace {

constexpr int MAX_TAPS = 31;
constexpr int TX = 128;            // tile width (outputs)
constexpr int TY = 32;             // tile height
constexpr int WARPS = 8;
constexpr int RV = TY / WARPS;     // rows per thread in the vertical pass

struct Taps {
  float k[MAX_TAPS];
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

template <int K, bool UP>
__global__ void __launch_bounds__(32 * WARPS)
p360_sift_base_kernel(const float* __restrict__ gray, float* __restrict__ out,
                      int h, int w, int oh, int ow,
                      const __grid_constant__ Taps taps) {
  constexpr int HH = K / 2;
  constexpr int PU = TX + 2 * HH;  // pitch of both buffers
  constexpr int RU = TY + 2 * HH;  // rows of the upsampled window
  extern __shared__ float smem[];
  float* U = smem;                 // (RU, PU): the window, upsampled
  float* V = smem + RU * PU;       // (TY, PU): its vertical pass
  const int lane = threadIdx.x;
  const int row = threadIdx.y;
  const int y0 = blockIdx.y * TY;
  const int x0 = blockIdx.x * TX;
  const float* g = gray + (size_t)blockIdx.z * h * w;

  for (int r = row; r < RU; r += WARPS) {
    const int Y = fold(y0 - HH + r, oh);
    // the H pass's two gray rows of upsampled row Y
    const int i = UP ? Y >> 1 : Y;
    const int ni = UP ? ((Y & 1) ? min(i + 1, h - 1) : max(i - 1, 0)) : Y;
    const float* gi = g + (size_t)i * w;
    const float* gn = g + (size_t)ni * w;
    for (int c = lane; c < PU; c += 32) {
      const int X = fold(x0 - HH + c, ow);
      float u;
      if (UP) {
        const int j = X >> 1;
        const int nj = (X & 1) ? min(j + 1, w - 1) : max(j - 1, 0);
        const float t = 0.75f * __ldg(gi + j) + 0.25f * __ldg(gn + j);
        const float tn = 0.75f * __ldg(gi + nj) + 0.25f * __ldg(gn + nj);
        u = 0.75f * t + 0.25f * tn;
      } else {
        u = __ldg(gi + X);
      }
      U[r * PU + c] = u;
    }
  }
  __syncthreads();

  // vertical: rows row * RV .. + RV - 1 of one column per thread
  for (int c = lane; c < PU; c += 32) {
    const float* src = U + row * RV * PU + c;
    float v[RV + K - 1];
#pragma unroll
    for (int i = 0; i < RV + K - 1; ++i) v[i] = src[i * PU];
#pragma unroll
    for (int o = 0; o < RV; ++o) {
      float acc = v[o] * taps.k[0];
#pragma unroll
      for (int j = 1; j < K; ++j) acc = acc + v[o + j] * taps.k[j];
      V[(row * RV + o) * PU + c] = acc;
    }
  }
  __syncthreads();

  // horizontal: lanes along x
  for (int o = 0; o < RV; ++o) {
    const int r = row * RV + o;
    const int Y = y0 + r;
    if (Y >= oh) break;
    float* dst = out + ((size_t)blockIdx.z * oh + Y) * ow;
    for (int c = lane; c < TX && x0 + c < ow; c += 32) {
      const float* src = V + r * PU + c;
      float acc = src[0] * taps.k[0];
#pragma unroll
      for (int j = 1; j < K; ++j) acc = acc + src[j] * taps.k[j];
      dst[x0 + c] = acc;
    }
  }
}

template <int K, bool UP>
int launch(const float* gray, float* out, int n, int h, int w, int oh,
           int ow, const Taps& taps, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (size_t)(TX + 2 * (K / 2)) * (2 * TY + 2 * (K / 2));
  // the opt-in shared-memory size is a per-device attribute of each
  // instance: raise it only when this launch needs more than was set
  constexpr int MAX_DEVICES = 64;
  static size_t smem_set[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (smem > 48 * 1024 && (dev >= MAX_DEVICES || smem > smem_set[dev])) {
    err = cudaFuncSetAttribute(p360_sift_base_kernel<K, UP>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    if (dev < MAX_DEVICES) smem_set[dev] = smem;
  }
  const dim3 grid((ow + TX - 1) / TX, (oh + TY - 1) / TY, n);
  p360_sift_base_kernel<K, UP><<<grid, dim3(32, WARPS), smem, stream>>>(
      gray, out, h, w, oh, ow, taps);
  return (int)cudaGetLastError();
}

template <int K>
int launch_k(const float* gray, float* out, int n, int h, int w, int upscale,
             const Taps& taps, cudaStream_t stream) {
  return upscale ? launch<K, true>(gray, out, n, h, w, 2 * h, 2 * w, taps,
                                   stream)
                 : launch<K, false>(gray, out, n, h, w, h, w, taps, stream);
}

}  // namespace

#define P360_K(K) \
  case K:         \
    return launch_k<K>(gray, out, n, h, w, upscale, spec, s);

extern "C" int p360_sift_base(const float* gray, float* out, int n, int h,
                              int w, int upscale, const float* taps, int k,
                              void* stream) {
  // taps: host, k of them (odd, <= MAX_TAPS)
  if (n < 1 || h < 1 || w < 1 || k < 1 || k > MAX_TAPS || k % 2 == 0)
    return (int)cudaErrorInvalidValue;
  Taps spec = {};
  for (int i = 0; i < k; ++i) spec.k[i] = taps[i];
  const cudaStream_t s = (cudaStream_t)stream;
  switch (k) {
    P360_K(1) P360_K(3) P360_K(5) P360_K(7) P360_K(9) P360_K(11)
    P360_K(13) P360_K(15) P360_K(17) P360_K(19) P360_K(21) P360_K(23)
    P360_K(25) P360_K(27) P360_K(29) P360_K(31)
    default:
      return (int)cudaErrorInvalidValue;
  }
}

#undef P360_K
