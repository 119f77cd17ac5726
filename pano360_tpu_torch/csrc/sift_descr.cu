// SIFT's grid descriptor: 16x16 rotated bilinear samples of a keypoint's
// gradient patch, binned trilinearly into 4x4x8, clipped and
// renormalised as cv2 does.
//
// Replaces: pano360_tpu/features/sift.py, _descriptor_from_patch (:658)
// with _trilinear_hist (:741), vmapped over keypoints and orientations;
// XLA fuses them, the binning as one contraction (no Pallas kernel lies
// behind them); that function turns the grid against the keypoint's angle,
// this kernel with it. The plain version is features/sift.py _descriptors: per
// sample s of the grid (gu, gv) = ((s % 16 + 0.5) / 4 - 2,
// (s / 16 + 0.5) / 4 - 2), the position turned by the keypoint's angle at
// 3 sigma per bin, (xf + (gu cos + gv sin) 3 sigma, yf + (gv cos - gu sin)
// 3 sigma): the angle is counter-clockwise on screen (gy is the row above
// less the row below), the pixels' y points down; its
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
// small operations over a chunk of (K, 2, 16, 256, 8) terms.
//
// Which terms can be nonzero. Every term (wr * wc) * x is >= +0 (weights,
// magnitudes and orientation fractions are, and no term is -0), so a node
// of the halving tree whose one side holds only +0 leaves equals its
// other side: the tree of the nonzero leaves alone, in their places,
// gives the same bits. The row weight of inner bin r is nonzero only on
// the grid rows 4r - 6 .. 4r + 1 (8 rows, 6 at the edge bins), the
// column weight likewise, and a sample's orientation term only at its
// bins o0 and o0 + 1. The tree's first level pairs row i with i + 8,
// of which a window of 8 rows holds exactly one: so each bin's row sum is
// the pairwise tree of 8 leaves by i mod 8 in bit-reversed order (0, 4,
// 2, 6, 1, 5, 3, 7), and its column sum the same tree over the window's
// columns; 64 leaves of the 256.
//
// The design: one warp per keypoint and orientation, several to a block,
// no block barrier. The warp samples its 256 grid points (8 a lane) into
// shared memory: each sample's two nonzero orientation terms and its
// lower orientation bin. Lane l = 8 (c - 1) + o owns the bins (r, c, o)
// of r = 1..4: per column of its window it reads the 16 samples (the 8
// lanes of a column read the same words), takes its orientation's term
// and adds it, weighted, to the row trees of the two bins whose windows
// hold the row; the column trees are a stack over the window's columns.
// Every lane runs the same loop. The norms' halving trees over the 128
// bins (q = 32 (r - 1) + l) are the in-lane sum (b[r=1] + b[r=3]) +
// (b[r=2] + b[r=4]) (strides 64 and 32), then warp shuffles (16 .. 1).
#include <math.h>
#include <stdint.h>

#include <cuda_runtime.h>

namespace {

constexpr int WARPS = 4;       // descriptors (keypoint, orientation) a block
constexpr int S = 256;         // grid samples
constexpr int P = 16;          // samples per side
constexpr int NOB = 8;         // orientation bins
constexpr int DIM = 128;       // 4 x 4 x 8 bins

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

__host__ __device__ constexpr int bit_reversed3(int k) {
  // the residue (mod 8) at position k of the pairwise tree over a
  // window's 8 leaves: 0, 4, 2, 6, 1, 5, 3, 7
  return ((k & 1) << 2) | (k & 2) | ((k & 4) >> 2);
}

__device__ __forceinline__ int window_index(int bin, int res) {
  // the grid index of residue res (mod 8) in inner bin bin's window of
  // grid indices 4 bin - 6 .. 4 bin + 1 (outside 0..15 at the edge bins)
  const int lo = 4 * bin - 6;
  return lo + ((res - lo) & 7);
}

__device__ __forceinline__ float tree8(const float* v) {
  // the pairwise tree of leaves v[residue] in bit-reversed order
  return ((v[0] + v[4]) + (v[2] + v[6])) + ((v[1] + v[5]) + (v[3] + v[7]));
}

__device__ __forceinline__ float warp_norm(float v) {
  // sqrtf of the halving tree over the 32 lanes' v (strides 16 .. 1), to
  // every lane
#pragma unroll
  for (int off = 16; off >= 1; off /= 2)
    v = v + __shfl_down_sync(0xffffffffu, v, off);
  return sqrtf(__shfl_sync(0xffffffffu, v, 0));
}

__global__ void __launch_bounds__(WARPS * 32)
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
                       float* __restrict__ desc, int total, int no, int psg,
                       float two_pi, float obin_scale, float mag_thresh) {
  __shared__ float2 sab_all[WARPS][S];   // (val (1 - fo), val fo): the
                                         // terms of bins o0 and o0 + 1
  __shared__ uint8_t so0_all[WARPS][S];  // o0
  const int wid = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int kj = blockIdx.x * WARPS + wid;
  if (kj >= total) return;               // the whole warp
  float2* sab = sab_all[wid];
  uint8_t* so0 = so0_all[wid];
  const int k = kj / no;
  const size_t n2 = (size_t)psg * psg;
  const float* gxk = gx + (size_t)k * n2;
  const float* gyk = gy + (size_t)k * n2;
  const float yf = yfs[k], xf = xfs[k], hw = 3.0f * sigs[k];
  const float ox = (float)(pcx[k] + 1), oy = (float)(pcy[k] + 1);
  const float wmax = (float)(ows[k] - 2), hmax = (float)(ohs[k] - 2);
  const float angle = angles[kj];
  const float cosa = cosf(angle), sina = sinf(angle);
  const float pmax = (float)(psg - 2);

  // sampling
  for (int s = lane; s < S; s += 32) {
    const float gu = grid_coord(s % P), gv = grid_coord(s / P);
    const float sx = xf + (gu * cosa + gv * sina) * hw;
    const float sy = yf + (gv * cosa - gu * sina) * hw;
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
    sab[s] = make_float2(val * (1.0f - fo), val * fo);
    so0[s] = (uint8_t)o0;
  }
  __syncwarp();

  // binning: lane (c, o) and its bins r = 1..4 (r - 1 below)
  const int c = lane / NOB + 1, o = lane % NOB;
  float wr[4][8];   // the row weight of bin r at its window's row res
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int res = 0; res < 8; ++res) {
      const int i = window_index(r + 1, res);
      wr[r][res] = i >= 0 && i < P ? axis_weight(i, r + 1) : 0.0f;
    }
  // the column tree's pending left nodes at levels 0-2, per bin
  float left[3][4], acc[4];
#pragma unroll
  for (int pos = 0; pos < 8; ++pos) {
    const int j = window_index(c, bit_reversed3(pos));
    float node[4] = {0.0f, 0.0f, 0.0f, 0.0f};   // a column outside: +0
    if (j >= 0 && j < P) {
      const float wc = axis_weight(j, c);
      // the leaves by row residue; rows outside 0..15 (edge bins) +0
      float v[4][8];
      v[0][6] = v[0][7] = v[3][0] = v[3][1] = 0.0f;
#pragma unroll
      for (int i = 0; i < P; ++i) {
        const float2 ab = sab[i * P + j];
        const int a0 = so0[i * P + j];
        const float x = o == a0 ? ab.x : (o == ((a0 + 1) & 7) ? ab.y : 0.0f);
#pragma unroll
        for (int r = 0; r < 4; ++r)
          if (i >= 4 * r - 2 && i <= 4 * r + 5)   // in bin r + 1's window
            v[r][i & 7] = (wr[r][i & 7] * wc) * x;
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) node[r] = tree8(v[r]);
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {   // pos is a constant: the tests fold
      float t = node[r];
      if (!(pos & 1)) { left[0][r] = t; continue; }
      t = left[0][r] + t;
      if (!(pos & 2)) { left[1][r] = t; continue; }
      t = left[1][r] + t;
      if (!(pos & 4)) { left[2][r] = t; continue; }
      acc[r] = left[2][r] + t;
    }
  }

  const float n1 = warp_norm((acc[0] * acc[0] + acc[2] * acc[2]) +
                             (acc[1] * acc[1] + acc[3] * acc[3]));
  const float lim = mag_thresh * fmaxf(n1, 1e-12f);
  float cl[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) cl[r] = fminf(acc[r], lim);  // finite sums
  const float n2s = warp_norm((cl[0] * cl[0] + cl[2] * cl[2]) +
                              (cl[1] * cl[1] + cl[3] * cl[3]));
  const float den = fmaxf(n2s, 1e-12f);
  float* out = desc + (size_t)kj * DIM + lane;
#pragma unroll
  for (int r = 0; r < 4; ++r) out[32 * r] = cl[r] / den;
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
  const int total = m * no;
  p360_sift_descr_kernel<<<(total + WARPS - 1) / WARPS, WARPS * 32, 0,
                           (cudaStream_t)stream>>>(
      gx, gy, yf, xf, sig, pcy, pcx, oh, ow, angle, desc, total, no, psg,
      two_pi, obin_scale, mag_thresh);
  return (int)cudaGetLastError();
}
