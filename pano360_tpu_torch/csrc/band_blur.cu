// The multiband blend's Gaussian blur of a patch stack: an (N, H, W, 4)
// float32 stack blurred along H, then along W, in two launches.
//
// Replaces: the per-level blur of pano360_tpu/render.py's blend_multiband
// (ops.filters.gaussian_blur, which XLA fuses inside the jitted render; no
// Pallas kernel lies behind it). In the port the plain version is
// ops/filters.py:gaussian_blur: conv_axis's sums of shifted slices of a
// reflect101-padded copy, one multiply and one add a tap, a few thousand
// elementwise launches a panorama.
// Semantics are the plain version's, bit for bit:
// - the rows (axis H) first, into a float32 intermediate, then its columns
//   (axis W); each channel on its own;
// - output i of an axis of n takes the K taps at the folded inputs
//   fold(i - (K - 1) / 2 + t, n), t = 0 .. K - 1, folded as
//   ops.filters.reflect101_index folds (pads wider than the axis too);
// - each sum begins with its first term, x[.] * k[0], and adds the others
//   in ascending tap order, a multiply then an add each (the _rn
//   intrinsics, never contracted).
//
// What bounds it on an H100: operations. The rig's stack (33 patches of
// 352 x 1408) holds 65 M floats; its four levels (33, 57, 73 and 87 taps)
// take 2 (2K - 1) operations a value, 65 G in all, against 2.1 GB read
// and written once (1.0 ms at the 67 TFLOP/s f32 peak, 0.6 ms of bytes).
// With no contraction each operation is an instruction, so instruction
// throughput is the floor, and every other instruction a tap needs counts
// against it.
// Design: a block stages its tile and the tile's halo along the filtered
// axis in shared memory (cp.async, 16 bytes a pixel: the four channels of
// a pixel in one float4). A thread keeps R = 8 outputs along that axis in
// registers and streams the R + K - 1 inputs they need in ascending order,
// each loaded once from shared memory into all the outputs it touches;
// ascending inputs are ascending taps of each output. So a tap of the
// steady state costs one float4 load for 8 outputs, and one broadcast load
// of the tap for 4 channels: 64 multiplies and adds against 9 loads.
// - rows: a block is 32 columns (a lane each) by 64 output rows (8 warps,
//   R rows each), staged as (64 + K - 1) rows of 32 pixels; lanes read
//   neighbouring pixels, so no bank conflict.
// - columns: a warp takes one row of the intermediate and 256 outputs of
//   it (R a lane), staged as 256 + K - 1 pixels with one pixel of padding
//   after every R, so that the 8 lanes of a quarter-warp, whose strips
//   start R pixels apart, read 8 distinct bank groups; the outputs go back
//   through the same buffer and leave in whole rows.
// The intermediate (the rows' output) is the only device memory besides
// the output; a fused pass would re-blur a halo of up to 63 rows a tile.
// Both kernels launch on the given stream, allocate nothing and read
// nothing on the host.
#include <cuda_runtime.h>

namespace {

constexpr int MAX_TAPS = 127;
constexpr int R = 8;                 // outputs a thread keeps
constexpr int WARPS = 8;             // warps a block
constexpr int ROWS_TX = 32;          // rows kernel: pixels a tile wide
constexpr int ROWS_TY = WARPS * R;   // rows kernel: output rows a tile
constexpr int COLS_TX = 32 * R;      // columns kernel: outputs a row tile

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

// one 16-byte copy from device memory to shared memory, not waited for
__device__ __forceinline__ void copy16(float4* dst, const float4* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void copies_done() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ float4 first(float4 v, float t) {
  return make_float4(__fmul_rn(v.x, t), __fmul_rn(v.y, t), __fmul_rn(v.z, t),
                     __fmul_rn(v.w, t));
}

__device__ __forceinline__ void add(float4& a, float4 v, float t) {
  a.x = __fadd_rn(a.x, __fmul_rn(v.x, t));
  a.y = __fadd_rn(a.y, __fmul_rn(v.y, t));
  a.z = __fadd_rn(a.z, __fmul_rn(v.z, t));
  a.w = __fadd_rn(a.w, __fmul_rn(v.w, t));
}

// R consecutive outputs from their R + K - 1 inputs load(0), load(1), ...:
// output o takes input j with tap j - o. Input j is loaded once and added
// to every output it reaches, in ascending j, so each output's terms come
// in ascending tap order, its first (j = o) begun as v * k[0].
template <class Load>
__device__ __forceinline__ void strip(float4 (&acc)[R], const float* tap,
                                      int k, Load load) {
  // inputs 0 .. R - 1: output j begins; j - o < k guards K < R
#pragma unroll
  for (int j = 0; j < R; ++j) {
    const float4 v = load(j);
#pragma unroll
    for (int o = 0; o < j; ++o)
      if (j - o < k) add(acc[o], v, tap[j - o]);
    acc[j] = first(v, tap[0]);
  }
  // inputs R .. K - 1: every output takes them
#pragma unroll 2
  for (int j = R; j < k; ++j) {
    const float4 v = load(j);
#pragma unroll
    for (int o = 0; o < R; ++o) add(acc[o], v, tap[j - o]);
  }
  // inputs K + d, d = 0 .. R - 2 (those not taken above): outputs past d
#pragma unroll
  for (int d = 0; d < R - 1; ++d) {
    const int j = k + d;
    if (j >= R) {
      const float4 v = load(j);
#pragma unroll
      for (int o = d + 1; o < R; ++o) add(acc[o], v, tap[j - o]);
    }
  }
}

__global__ void __launch_bounds__(32 * WARPS)
p360_band_blur_rows_kernel(const float4* __restrict__ in,
                           float4* __restrict__ out, int h, int w, int k,
                           const __grid_constant__ Taps taps) {
  extern __shared__ float4 tile[];     // (ROWS_TY + k - 1, ROWS_TX)
  __shared__ float tap[MAX_TAPS];
  const int lane = threadIdx.x;
  const int warp = threadIdx.y;
  const int x0 = blockIdx.x * ROWS_TX;
  const int y0 = blockIdx.y * ROWS_TY;
  const size_t plane = (size_t)h * w;
  const float4* src = in + blockIdx.z * plane;
  for (int i = warp * 32 + lane; i < k; i += 32 * WARPS) tap[i] = taps.k[i];
  // a lane past the stack's width copies the last column (never written)
  const int x = min(x0 + lane, w - 1);
  const int lo = (k - 1) / 2;
  const int rows = ROWS_TY + k - 1;
  for (int r = warp; r < rows; r += WARPS)
    copy16(tile + r * ROWS_TX + lane, src + (size_t)fold(y0 - lo + r, h) * w + x);
  copies_done();
  __syncthreads();

  float4 acc[R];
  const float4* col = tile + warp * R * ROWS_TX + lane;
  strip(acc, tap, k, [&](int j) { return col[j * ROWS_TX]; });
  if (x0 + lane >= w) return;
  float4* dst = out + blockIdx.z * plane + x0 + lane;
#pragma unroll
  for (int o = 0; o < R; ++o) {
    const int y = y0 + warp * R + o;
    if (y < h) dst[(size_t)y * w] = acc[o];
  }
}

// position of pixel q of a padded row: one pixel of padding after every R
__device__ __forceinline__ int padded(int q) { return q + q / R; }

__host__ __device__ constexpr int cols_pitch(int k) {
  return COLS_TX + k - 1 + (COLS_TX + k - 2) / R;
}

__global__ void __launch_bounds__(32 * WARPS)
p360_band_blur_cols_kernel(const float4* __restrict__ in,
                           float4* __restrict__ out, int h, int w, int k,
                           const __grid_constant__ Taps taps) {
  extern __shared__ float4 rows[];     // (WARPS, cols_pitch(k))
  __shared__ float tap[MAX_TAPS];
  const int lane = threadIdx.x;
  const int warp = threadIdx.y;
  const int x0 = blockIdx.x * COLS_TX;
  const int y = blockIdx.y * WARPS + warp;
  for (int i = warp * 32 + lane; i < k; i += 32 * WARPS) tap[i] = taps.k[i];
  float4* buf = rows + warp * cols_pitch(k);
  // a warp past the stack's height stages its last row (never written)
  const size_t row = ((size_t)blockIdx.z * h + min(y, h - 1)) * w;
  const int lo = (k - 1) / 2;
  const int need = COLS_TX + k - 1;
  for (int q = lane; q < need; q += 32)
    copy16(buf + padded(q), in + row + fold(x0 - lo + q, w));
  copies_done();
  __syncthreads();

  // this lane's strip starts at pixel R lane, position (R + 1) lane
  float4 acc[R];
  float4* own = buf + lane * (R + 1);
  strip(acc, tap, k, [&](int j) { return own[j + (unsigned)j / R]; });
  if (y >= h) return;
  __syncwarp();
#pragma unroll
  for (int o = 0; o < R; ++o) own[o] = acc[o];
  __syncwarp();
  for (int q = lane; q < COLS_TX && x0 + q < w; q += 32)
    out[row + x0 + q] = buf[padded(q)];
}

// raise a kernel's opt-in shared memory to what the largest K needs, once
// a device
template <class Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes, bool* set, int dev) {
  if (bytes <= 48 * 1024 || set[dev]) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess) set[dev] = true;
  return err;
}

constexpr int MAX_DEVICES = 64;

}  // namespace

extern "C" int p360_band_blur(const float* in, float* mid, float* out, int n,
                              int h, int w, const float* taps, int k,
                              void* stream) {
  // taps: host, k of them; in, mid, out: (n, h, w, 4) float32, 16-byte
  // aligned; mid takes the rows' blur, out the result
  if (n < 1 || h < 1 || w < 1 || k < 1 || k > MAX_TAPS || n > 65535 ||
      (h + WARPS - 1) / WARPS > 65535)
    return (int)cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  static bool rows_set[MAX_DEVICES] = {}, cols_set[MAX_DEVICES] = {};
  constexpr size_t ROWS_MAX = sizeof(float4) * (ROWS_TY + MAX_TAPS - 1) * ROWS_TX;
  constexpr size_t COLS_MAX = sizeof(float4) * WARPS * cols_pitch(MAX_TAPS);
  err = allow_smem(p360_band_blur_rows_kernel, ROWS_MAX, rows_set, dev);
  if (err != cudaSuccess) return (int)err;
  err = allow_smem(p360_band_blur_cols_kernel, COLS_MAX, cols_set, dev);
  if (err != cudaSuccess) return (int)err;

  Taps spec = {};
  for (int i = 0; i < k; ++i) spec.k[i] = taps[i];
  const cudaStream_t s = (cudaStream_t)stream;
  const dim3 block(32, WARPS);
  const dim3 rows_grid((w + ROWS_TX - 1) / ROWS_TX, (h + ROWS_TY - 1) / ROWS_TY,
                       n);
  p360_band_blur_rows_kernel<<<rows_grid, block,
                               sizeof(float4) * (ROWS_TY + k - 1) * ROWS_TX, s>>>(
      reinterpret_cast<const float4*>(in), reinterpret_cast<float4*>(mid), h,
      w, k, spec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 cols_grid((w + COLS_TX - 1) / COLS_TX, (h + WARPS - 1) / WARPS, n);
  p360_band_blur_cols_kernel<<<cols_grid, block,
                               sizeof(float4) * WARPS * cols_pitch(k), s>>>(
      reinterpret_cast<const float4*>(mid), reinterpret_cast<float4*>(out), h,
      w, k, spec);
  return (int)cudaGetLastError();
}
