// SIFT's grid descriptor: 16x16 rotated bilinear samples of a keypoint's
// gradient patch, binned trilinearly into 4x4x8, clipped and
// renormalised as cv2 does.
//
// Replaces: pano360_tpu/features/sift.py, _descriptor_from_patch (:658)
// with _trilinear_hist (:741), vmapped over keypoints and orientations;
// XLA fuses them, the binning as one contraction (no Pallas kernel lies
// behind them). The plain version is features/sift.py _descriptors: per
// sample s of the grid (gu, gv) = ((s % 16 + 0.5) / 4 - 2,
// (s / 16 + 0.5) / 4 - 2), the rotated position at 3 sigma per bin, its
// bilinear gx and gy from the patch (indices clamped as the plain gather
// clamps them), the in-bounds mask, magnitude sqrtf, angle atan2f less
// the orientation (float remainder 2 pi as PyTorch computes it), weight
// expf(-(gu^2 + gv^2) / 8); then sample s adds wrc[s, rc] * (val[s] *
// oh_o[s, o]) to bin (rc, o) of the inner 4x4 spatial bins, each bin
// summing its 256 terms in the halving tree's order (geometry.tree_sum),
// and the two norms over the 128 bins in the same order. Every operation
// is the plain version's, rounded on its own (-fmad=false, IEEE division
// and sqrt), so the two agree bit for bit on the card.
//
// What bounds it on an H100: bytes, the gradient texels that the taps of
// the in-bounds samples read (a rotated square of ~(12 sigma + 2)^2 of a
// patch's 4 096), at ~70 operations a sample. The plain version is ~80
// small operations over a chunk of (K, 2, 16, 256, 8) terms. The design:
// one block of 128 threads per keypoint and orientation. Each thread
// samples two grid points into shared memory (the sample's two nonzero
// orientation terms and its lower orientation bin); then each thread
// owns one of the 128 bins and sums the 256 samples in the halving
// tree's order: per column of the grid the tree over its 16 rows in
// registers, then the 16 column sums as a pairwise tree in bit-reversed
// order, computing each term from the shared samples and its bin's
// constant row and column weights. A warp's 32 bins share their spatial
// column, so a grid column whose weight is 0 there (half of them) adds
// +0 and is skipped by the whole warp: 2.1x less time on the card than
// computing every term. The norms are two more trees in shared memory
// and warp shuffles.
#include <math.h>
#include <stdint.h>

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;   // output bins of one (keypoint, orientation)
constexpr int S = 256;         // grid samples
constexpr int P = 16;          // samples per side
constexpr int NOB = 8;         // orientation bins

__device__ __forceinline__ float grid_coord(int i) {
  // (arange(16) + 0.5) / 16 * 4 - 2
  return ((float)i + 0.5f) / 16.0f * 4.0f - 2.0f;
}

__device__ __forceinline__ float remainder_f(float a, float b) {
  float mod = fmodf(a, b);
  if (mod != 0.0f && ((b < 0.0f) != (mod < 0.0f))) mod += b;
  return mod;
}

__device__ __forceinline__ float clamp_keep_nan(float v, float lo, float hi) {
  return isnan(v) ? v : fminf(fmaxf(v, lo), hi);
}

__device__ __forceinline__ long long clampi(long long v, long long lo,
                                            long long hi) {
  v = v < lo ? lo : v;
  return v > hi ? hi : v;
}

__device__ __forceinline__ float axis_weight(int i, int bin) {
  // the plain version's axis_w: bin `bin` of the 6 padded bins of grid
  // index i, (bin == a) * (1 - frac) + (bin == b) * frac
  const float binc = (grid_coord(i) + 2.0f) - 0.5f;
  const float i0f = floorf(binc);
  const float frac = binc - i0f;
  const long long i0 = (long long)i0f + 1;
  const long long a = clampi(i0, 0, 5), b = clampi(i0 + 1, 0, 5);
  return (bin == a ? 1.0f : 0.0f) * (1.0f - frac) +
         (bin == b ? 1.0f : 0.0f) * frac;
}

// the columns j of the grid in bit-reversed order: the halving tree's
// top four levels (strides 8 .. 1 over the 16 column subtrees) are the
// pairwise tree in this order
__constant__ int kColumnOrder[P] = {0, 8, 4, 12, 2, 10, 6, 14,
                                    1, 9, 5, 13, 3, 11, 7, 15};

__device__ __forceinline__ float norm128(float v, int q, float* red,
                                         float* out) {
  // sqrtf of the halving tree over the 128 bins' v (bin q's from each
  // thread): strides 64, 32 in shared memory, 16 .. 1 by shuffles
  const int t = threadIdx.x;
  red[q] = v;
  __syncthreads();
  if (t < 64) red[t] = red[t] + red[t + 64];
  __syncthreads();
  if (t < 32) {
    float r = red[t] + red[t + 32];
#pragma unroll
    for (int off = 16; off >= 1; off /= 2)
      r = r + __shfl_down_sync(0xffffffffu, r, off);
    if (t == 0) *out = sqrtf(r);
  }
  __syncthreads();
  return *out;
}

__global__ void __launch_bounds__(THREADS)
p360_sift_descr_kernel(const float* __restrict__ gx,
                       const float* __restrict__ gy,
                       const float* __restrict__ yfs,
                       const float* __restrict__ xfs,
                       const float* __restrict__ sigs,
                       const int64_t* __restrict__ pcy,
                       const int64_t* __restrict__ pcx,
                       const int64_t* __restrict__ ohs,
                       const int64_t* __restrict__ ows,
                       const float* __restrict__ angles,
                       float* __restrict__ desc, int no, int psg,
                       float two_pi, float obin_scale, float mag_thresh) {
  __shared__ float sa[S];     // val * (1 - fo): the term of bin o0
  __shared__ float sb[S];     // val * fo: the term of bin o0 + 1
  __shared__ int so0[S];
  __shared__ float red[THREADS];
  __shared__ float nrm[2];
  const int kj = blockIdx.x, k = kj / no, t = threadIdx.x;
  const size_t n2 = (size_t)psg * psg;
  const float* gxk = gx + (size_t)k * n2;
  const float* gyk = gy + (size_t)k * n2;
  const float yf = yfs[k], xf = xfs[k], hw = 3.0f * sigs[k];
  const float ox = (float)(pcx[k] + 1), oy = (float)(pcy[k] + 1);
  const float wmax = (float)(ows[k] - 2), hmax = (float)(ohs[k] - 2);
  const float angle = angles[kj];
  const float cosa = cosf(angle), sina = sinf(angle);
  const float pmax = (float)(psg - 2);

  for (int s = t; s < S; s += THREADS) {
    const float gu = grid_coord(s % P), gv = grid_coord(s / P);
    const float sx = xf + (gu * cosa - gv * sina) * hw;
    const float sy = yf + (gu * sina + gv * cosa) * hw;
    const float px = sx - ox, py = sy - oy;
    const float x0f = floorf(px), y0f = floorf(py);
    const float fx = px - x0f, fy = py - y0f;
    const long long x0 = (long long)clamp_keep_nan(x0f, -2.0f, psg + 1.0f);
    const long long y0 = (long long)clamp_keep_nan(y0f, -2.0f, psg + 1.0f);
    const long long xa = clampi(x0, 0, psg - 1);
    const long long xb = clampi(x0 + 1, 0, psg - 1);
    const long long ya = clampi(y0, 0, psg - 1);
    const long long yb = clampi(y0 + 1, 0, psg - 1);
    const float ify = 1.0f - fy, ifx = 1.0f - fx;
    const float gx0 = gxk[ya * psg + xa] * ify + gxk[yb * psg + xa] * fy;
    const float gx1 = gxk[ya * psg + xb] * ify + gxk[yb * psg + xb] * fy;
    const float sgx = gx0 * ifx + gx1 * fx;
    const float gy0 = gyk[ya * psg + xa] * ify + gyk[yb * psg + xa] * fy;
    const float gy1 = gyk[ya * psg + xb] * ify + gyk[yb * psg + xb] * fy;
    const float sgy = gy0 * ifx + gy1 * fx;
    const bool inb = px >= 0.0f && px <= pmax && py >= 0.0f && py <= pmax &&
                     sx >= 1.0f && sx <= wmax && sy >= 1.0f && sy <= hmax;
    const float mag = sqrtf(sgx * sgx + sgy * sgy);
    const float ori = remainder_f(atan2f(sgy, sgx) - angle, two_pi);
    const float wgt = expf(-(gu * gu + gv * gv) / 8.0f) * (inb ? 1.0f : 0.0f);
    const float obin = ori * obin_scale;
    const float o0f = floorf(obin);
    long long o0 = (long long)o0f % NOB;
    if (o0 < 0) o0 += NOB;
    // val * oh_o[o]: oh_o is (1 - fo) + 0 at o0, 0 + fo at o0 + 1 and
    // 0 elsewhere, each exact; so the term is one of these or +0
    const float val = mag * wgt, fo = obin - o0f;
    sa[s] = val * (1.0f - fo);
    sb[s] = val * fo;
    so0[s] = (int)o0;
  }
  __syncthreads();

  // bin q of thread t: inner spatial bin (r, c) in 1..4 (c the warp's),
  // orientation o. Its sum over the samples s = 16 i + j in the halving
  // tree's order: the tree over the rows i of each column j (strides
  // 128 .. 16), then over the columns (strides 8 .. 1), as a pairwise
  // tree in kColumnOrder with a stack of partial sums
  const int c = t / 32 + 1, r = t % 32 / NOB + 1, o = t % NOB;
  const int q = ((r - 1) * 4 + (c - 1)) * NOB + o;
  float wr[P];
#pragma unroll
  for (int i = 0; i < P; ++i) wr[i] = axis_weight(i, r);
  float stack[4];
  int top = 0;
#pragma unroll 1
  for (int col = 0; col < P; ++col) {
    const int j = kColumnOrder[col];
    const float wc = axis_weight(j, c);
    float node = 0.0f;   // wc = 0: every term is (wr * 0) * x = +0
    if (wc != 0.0f) {
      float v[P];
#pragma unroll
      for (int i = 0; i < P; ++i) {
        const int s = i * P + j, a0 = so0[s];
        const float x =
            o == a0 ? sa[s] : (o == (a0 + 1) % NOB ? sb[s] : 0.0f);
        v[i] = (wr[i] * wc) * x;
      }
#pragma unroll
      for (int m = P / 2; m >= 1; m /= 2)
#pragma unroll
        for (int i = 0; i < m; ++i) v[i] = v[i] + v[i + m];
      node = v[0];
    }
    for (int n = col + 1; (n & 1) == 0; n >>= 1) node = stack[--top] + node;
    stack[top++] = node;
  }
  const float acc = stack[0];

  const float n1 = norm128(acc * acc, q, red, &nrm[0]);
  const float clipped =
      fminf(acc, mag_thresh * fmaxf(n1, 1e-12f));  // no NaN: finite sums
  const float n2s = norm128(clipped * clipped, q, red, &nrm[1]);
  desc[(size_t)kj * THREADS + q] = clipped / fmaxf(n2s, 1e-12f);
}

}  // namespace

extern "C" int p360_sift_descr(const float* gx, const float* gy,
                               const float* yf, const float* xf,
                               const float* sig, const int64_t* pcy,
                               const int64_t* pcx, const int64_t* oh,
                               const int64_t* ow, const float* angle,
                               float* desc, int m, int no, int psg,
                               float two_pi, float obin_scale,
                               float mag_thresh, void* stream) {
  if (m <= 0 || no <= 0 || psg < 2 || (long long)m * no > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  p360_sift_descr_kernel<<<m * no, THREADS, 0, (cudaStream_t)stream>>>(
      gx, gy, yf, xf, sig, pcy, pcx, oh, ow, angle, desc, no, psg, two_pi,
      obin_scale, mag_thresh);
  return (int)cudaGetLastError();
}
