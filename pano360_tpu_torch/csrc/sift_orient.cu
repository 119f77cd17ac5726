// SIFT keypoint orientations: the 36-bin gradient histogram of each
// keypoint's window, cv2's circular smoothing and up to two interpolated
// peaks.
//
// Replaces: pano360_tpu/features/sift.py, _orientation_from_patch (:594)
// and _peak_angles (:635), vmapped over the keypoints; XLA fuses them,
// the histogram as one one-hot dot per keypoint (no Pallas kernel lies
// behind them). The plain versions are features/sift.py _orientation_hist
// and _peak_angles: per patch sample (gradient (gx, gy) at (pcy + 1 + i,
// pcx + 1 + j)) the magnitude sqrtf, the angle atan2f, the Gaussian
// weight expf(rr / (-2 (1.5 sigma)^2)) inside the window of radius
// rint(4.5 sigma) and the image's interior, and the bin
// rint(angle * 36 / 2 pi) mod 36; each bin sums its samples in the
// halving tree's order over the psg^2 samples zero-padded to L = 4096 or
// 8192 (geometry.tree_sum); then the 5-tap smoothing, the peaks (above
// both neighbours and >= 0.8 max), the two largest (a tie: the lower bin
// first, as the plain version's stable sort) and their parabolic
// interpolation, float remainder as PyTorch computes it. Every operation
// is the plain version's, rounded on its own (-fmad=false, IEEE division
// and sqrt), so the two agree bit for bit on the card.
//
// What bounds it on an H100: bytes, the two gradient patches' samples
// inside the window (~500 of a patch's 4 096 on the bench, ~1 000 at the
// largest sigma), at ~20 operations a sample. The plain version passes
// over a (K, L) chunk ~40 times a bin.
//
// Which sums can be left out. Every sample's term is >= +0 (magnitudes
// and weights are, and none is -0), so a node of the halving tree whose
// one side holds only +0 leaves equals its other side: x + 0 = x. Outside
// the window a sample's weight is +0, whatever its bin.
//
// The grid design (psg = 64, every grid-mode keypoint): one warp per
// keypoint, four to a block, no block barrier. The samples are j = 64 iy +
// ix, so the tree's strides 2048 .. 64 are a halving tree over the rows iy
// of each column and the strides 32 .. 1 one over the columns: each bin is
// a row tree inside a column tree. Lane l owns the columns l and l + 32
// and visits only those inside the window (one of the two when the window
// is at most 32 columns wide); a warp reads a row's 32 floats at once.
// The row tree: a window of at most 32 rows holds one row of each
// residue mod 32, so the tree's first level adds only +0 and its leaves
// are the 32 residues, each the window's one row there. The lane samples
// its column's window rows once (four rows' loads, then their math) into
// its slots of a staging tile in shared memory (value, and bin as a
// byte), loads the 32 leaves into registers, and for each bin present
// among them runs their tree with the other bins' leaves +0, depth first,
// adding it into its slot of a 36 x 32 shared tile (the column tree's
// stride 32: column l plus column l + 32, in either order). A wider
// window (sigma above ~3.4) keeps all 64 rows: the tree's last add joins
// its even rows' subtree and its odd rows', each a 32-leaf tree taken in
// turn (the even sums wait in the lane's local memory). Lane b then sums
// bin b's 32 partials in the halving order (lanes 0-3 also bins 32-35),
// and the smoothing, the maximum, the peak test and the two largest peaks
// (a (value, bin) maximum over the lanes' shuffles) run across the lanes;
// lanes 0 and 1 interpolate the two orientations. Variants timed on the
// bench's batch are in PERF.md (PR 12): the leaves sampled fully
// unrolled into registers (255 registers, spills), 8 or 16 rows' loads
// at once, all lanes sampling the window in row-major order, partials in
// local memory at 64 registers, the rows copied with cp.async.
//
// Other patch sides (the dense mode's psg = 80, L = 8192, whose samples do
// not split into rows and columns of a power of two) take the block
// design: one block of 256 threads per keypoint; thread t takes the
// samples t + 256 k, so the tree's first levels (strides L/2 .. 256) are
// adds inside a thread, for the bins its samples fall in, the next three
// go through shared memory (36 bins x 256 partial sums) and the last five
// are warp shuffles. Image coordinates are int32 here (the plain version's
// int64 values are small).
#include <math.h>
#include <stdint.h>

#include <cuda_runtime.h>

namespace {

constexpr int NB = 36;        // orientation bins
constexpr int NO = 2;         // orientations
constexpr int WARPS = 4;      // keypoints a block (grid design)
constexpr int PSG = 64;       // the grid design's patch side
constexpr int TILE = 33;      // a bin's 32 partials, padded: lane b reads
                              // row b without bank conflicts
constexpr int THREADS = 256;  // the block design
constexpr int NO_BIN = 0xff;  // a leaf's bin byte where it holds no sample

__device__ __forceinline__ float remainder_f(float a, float b) {
  // torch.remainder on floats: fmod, then the divisor added where the
  // signs differ
  float mod = fmodf(a, b);
  if (mod != 0.0f && ((b < 0.0f) != (mod < 0.0f))) mod += b;
  return mod;
}

__device__ __forceinline__ float sample(float gxv, float gyv, float rr,
                                        float denom, float bin_scale,
                                        int* bin) {
  // a sample inside the window: its weighted magnitude and its bin
  const float mag = sqrtf(gxv * gxv + gyv * gyv);
  const float ori = atan2f(gyv, gxv);
  const float wgt = expf(rr / denom);  // times inside: 1 here
  // rint(ori * 36 / 2 pi) lies in [-18, 18]: int32 holds it
  int b = (int)rintf(ori * bin_scale) % NB;
  if (b < 0) b += NB;
  *bin = b;
  return mag * wgt;
}

__device__ __forceinline__ void interpolate(const float* sm, int best,
                                            float peak, float bin_width,
                                            float* angle, uint8_t* valid) {
  // the parabolic interpolation of the smoothed histogram's peak at bin
  // `best` (value `peak`, -inf where it is no peak)
  const float hm1 = sm[(best + NB - 1) % NB], hi = sm[best];
  const float hp1 = sm[(best + 1) % NB];
  const float den = (hm1 - 2.0f * hi) + hp1;
  const bool big = fabsf(den) > 1e-12f;
  const float interp = big ? (0.5f * (hm1 - hp1)) / den : 0.0f;
  const float pos = remainder_f((float)best + interp, (float)NB);
  *angle = pos * bin_width;
  *valid = isfinite(peak);
}

// ---------------------------------------------------------------------------
// The grid design
// ---------------------------------------------------------------------------

constexpr int NL = 32;        // the row trees' leaves
constexpr int ROWS = 4;       // window rows a lane loads at once

template <int D, int R>
__device__ __forceinline__ float row_node(const float (&val)[NL],
                                          const int (&bin)[NL], int b) {
  // the row tree's node over the leaves q = R (mod D) with the leaves of
  // other bins +0: node(D, R) = node(2D, R) + node(2D, R + D), which is
  // the halving order (the last add joins the even and the odd leaves)
  if constexpr (D == NL) {
    return bin[R] == b ? val[R] : 0.0f;
  } else {
    return row_node<2 * D, R>(val, bin, b) +
           row_node<2 * D, R + D>(val, bin, b);
  }
}

struct Window {
  int y, x, oy, ox, oh, ow, rlo, rhi;
  float radius, denom, bin_scale;
};

struct Lane {   // a lane's leaves in the warp's staging tile: [q * 32]
  float* val;
  uint8_t* bin;
};

template <int N, bool PARITY>
__device__ __forceinline__ unsigned long long sample_rows(
    const float* gxk, const float* gyk, int c, const Window& w, int iy0,
    float dxc, bool col_in, Lane st) {
  // N window rows from iy0 (every one inside the window): their loads
  // first, then their samples, each kept where the plain version's test
  // holds. -> the bins present
  constexpr int STEP = PARITY ? 2 : 1;
  float gv[N], hv[N];
#pragma unroll
  for (int j = 0; j < N; ++j) {
    gv[j] = gxk[(iy0 + j * STEP) * PSG + c];
    hv[j] = gyk[(iy0 + j * STEP) * PSG + c];
  }
  unsigned long long present = 0;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const int iy = iy0 + j * STEP;
    const int q = PARITY ? iy >> 1 : iy & (NL - 1);
    const int ay = w.oy + iy;
    const float dyc = (float)(ay - w.y);
    int b;
    const float v = sample(gv[j], hv[j], dyc * dyc + dxc * dxc, w.denom,
                           w.bin_scale, &b);
    if (col_in && fabsf(dyc) <= w.radius && ay >= 1 && ay <= w.oh - 2) {
      st.val[q * 32] = v;
      st.bin[q * 32] = (uint8_t)b;
      present |= 1ull << b;
    }
  }
  return present;
}

template <bool PARITY>
__device__ __forceinline__ unsigned long long stage(const float* gxk,
                                                    const float* gyk, int c,
                                                    const Window& w, int p,
                                                    Lane st) {
  // column c's 32 row-tree leaves into the lane's staging slots, each a
  // sample's weighted magnitude and bin (+0 and NO_BIN where none): leaf
  // q is the window's row iy = q (mod 32), or with PARITY the row 2 q + p
  // (the even or the odd rows' subtree of the 64-leaf tree). -> the bins
  // present
#pragma unroll
  for (int q = 0; q < NL; ++q) {
    st.val[q * 32] = 0.0f;
    st.bin[q * 32] = NO_BIN;
  }
  unsigned long long present = 0;
  const int ax = w.ox + c;
  const float dxc = (float)(ax - w.x);
  const bool col_in = fabsf(dxc) <= w.radius && ax >= 1 && ax <= w.ow - 2;
  const int first = PARITY ? w.rlo + ((w.rlo ^ p) & 1) : w.rlo;
  constexpr int STEP = PARITY ? 2 : 1;
  // ROWS rows at a time, then the rest one by one: loads before math, and
  // no load inside the plain version's test, where each would wait for
  // the one before
  int iy0 = first;
  for (; iy0 + (ROWS - 1) * STEP <= w.rhi; iy0 += ROWS * STEP)
    present |= sample_rows<ROWS, PARITY>(gxk, gyk, c, w, iy0, dxc, col_in,
                                         st);
  for (; iy0 <= w.rhi; iy0 += STEP)
    present |= sample_rows<1, PARITY>(gxk, gyk, c, w, iy0, dxc, col_in, st);
  return present;
}

__device__ __forceinline__ void load(Lane st, float (&val)[NL],
                                     int (&bin)[NL]) {
#pragma unroll
  for (int q = 0; q < NL; ++q) {
    val[q] = st.val[q * 32];
    bin[q] = st.bin[q * 32];
  }
}

__device__ __forceinline__ void column_sums(const float* gxk,
                                            const float* gyk, int c,
                                            const Window& w, Lane st,
                                            float* slot) {
  // column c's row tree for each bin present in it, added into the bin's
  // partial (slot[b * TILE])
  float val[NL];
  int bin[NL];
  if (w.rhi - w.rlo < NL) {   // one row of each residue mod 32
    unsigned long long present = stage<false>(gxk, gyk, c, w, 0, st);
    load(st, val, bin);
    for (; present; present &= present - 1) {
      const int b = __ffsll(present) - 1;
      slot[b * TILE] = slot[b * TILE] + row_node<1, 0>(val, bin, b);
    }
    return;
  }
  // the 64-leaf tree's last add joins its even rows' subtree and its odd
  // rows', taken in turn; the even sums wait in `even`
  float even[NB];
  const unsigned long long pe = stage<true>(gxk, gyk, c, w, 0, st);
  load(st, val, bin);
  for (unsigned long long left = pe; left; left &= left - 1) {
    const int b = __ffsll(left) - 1;
    even[b] = row_node<1, 0>(val, bin, b);
  }
  const unsigned long long po = stage<true>(gxk, gyk, c, w, 1, st);
  load(st, val, bin);
  for (unsigned long long left = pe | po; left; left &= left - 1) {
    const int b = __ffsll(left) - 1;
    float v;
    if ((po >> b) & 1) {
      v = row_node<1, 0>(val, bin, b);
      if ((pe >> b) & 1) v = even[b] + v;
    } else {
      v = even[b];
    }
    slot[b * TILE] = slot[b * TILE] + v;
  }
}

__device__ __forceinline__ void take_better(float* v, int* i, float v2,
                                            int i2) {
  // the larger value, the lower bin on a tie (a stable descending sort)
  if (v2 > *v || (v2 == *v && i2 < *i)) {
    *v = v2;
    *i = i2;
  }
}

__device__ __forceinline__ void warp_best(float* v, int* i) {
  // take_better over the 32 lanes' candidates, to every lane
#pragma unroll
  for (int off = 16; off >= 1; off /= 2)
    take_better(v, i, __shfl_xor_sync(0xffffffffu, *v, off),
                __shfl_xor_sync(0xffffffffu, *i, off));
}

__global__ void __launch_bounds__(WARPS * 32, 5)
p360_sift_orient_kernel(const float* __restrict__ gx,
                        const float* __restrict__ gy,
                        const int64_t* __restrict__ ys,
                        const int64_t* __restrict__ xs,
                        const int64_t* __restrict__ pcy,
                        const int64_t* __restrict__ pcx,
                        const int64_t* __restrict__ ohs,
                        const int64_t* __restrict__ ows,
                        const float* __restrict__ sigs,
                        float* __restrict__ angles,
                        uint8_t* __restrict__ valid, int m,
                        float bin_scale, float bin_width) {
  __shared__ float tile_all[WARPS][NB][TILE];  // bin b's partial of lane l
  __shared__ float val_all[WARPS][NL][32];     // leaf q of lane l
  __shared__ uint8_t bin_all[WARPS][NL][32];
  __shared__ float hist_all[WARPS][NB];        // the sums
  __shared__ float sm_all[WARPS][NB];          // the smoothed histogram
  const int wid = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int k = blockIdx.x * WARPS + wid;
  if (k >= m) return;                          // the whole warp
  float(*tile)[TILE] = tile_all[wid];
  const Lane st = {&val_all[wid][0][lane], &bin_all[wid][0][lane]};
  float* hist = hist_all[wid];
  float* sm = sm_all[wid];
  const float* gxk = gx + (size_t)k * PSG * PSG;
  const float* gyk = gy + (size_t)k * PSG * PSG;
  Window w;
  w.y = (int)ys[k];
  w.x = (int)xs[k];
  w.oy = (int)pcy[k] + 1;
  w.ox = (int)pcx[k] + 1;
  w.oh = (int)ohs[k];
  w.ow = (int)ows[k];
  const float sig = sigs[k];
  w.radius = rintf(4.5f * sig);
  const float s15 = 1.5f * sig;
  w.denom = -2.0f * (s15 * s15);
  w.bin_scale = bin_scale;
  // the window's rows and columns in the patch (empty for a NaN radius;
  // a radius of 2^28 reaches every sample of any image int32 indexes)
  const int r = w.radius >= 0.0f ? (int)fminf(w.radius, 268435456.0f) : -1;
  w.rlo = max(max(0, 1 - w.oy), w.y - r - w.oy);
  w.rhi = min(min(PSG - 1, w.oh - 2 - w.oy), w.y + r - w.oy);
  const int clo = max(max(0, 1 - w.ox), w.x - r - w.ox);
  const int chi = min(min(PSG - 1, w.ow - 2 - w.ox), w.x + r - w.ox);

#pragma unroll
  for (int b = 0; b < NB; ++b) tile[b][lane] = 0.0f;
  const bool in0 = lane >= clo && lane <= chi;
  const bool in1 = lane + 32 >= clo && lane + 32 <= chi;
  const int ncols = (int)in0 + (int)in1;
  for (int i = 0; i < ncols; ++i) {
    const int c = i == 0 && in0 ? lane : lane + 32;
    column_sums(gxk, gyk, c, w, st, &tile[0][lane]);
  }
  __syncwarp();

  // the column tree's strides 16 .. 1: lane b over bin b's partials
  for (int b = lane; b < NB; b += 32) {
    float v[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) v[i] = tile[b][i];
#pragma unroll
    for (int s = 16; s >= 1; s /= 2)
#pragma unroll
      for (int i = 0; i < s; ++i) v[i] = v[i] + v[i + s];
    hist[b] = v[0];
  }
  __syncwarp();
  float mx = -INFINITY;
  for (int t = lane; t < NB; t += 32) {
    const float hm2 = hist[(t + NB - 2) % NB], hp2 = hist[(t + 2) % NB];
    const float hm1 = hist[(t + NB - 1) % NB], hp1 = hist[(t + 1) % NB];
    sm[t] = ((hm2 + hp2) * 0.0625f + (hm1 + hp1) * 0.25f) + hist[t] * 0.375f;
    mx = fmaxf(mx, sm[t]);
  }
#pragma unroll
  for (int off = 16; off >= 1; off /= 2)
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
  __syncwarp();
  // the peaks' values (-inf elsewhere) of bins lane and lane + 32
  float pv[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int t = lane + 32 * h;
    pv[h] = -INFINITY;
    if (t < NB) {
      const float s = sm[t];
      const bool peak = s > sm[(t + NB - 1) % NB] && s > sm[(t + 1) % NB] &&
                        s >= 0.8f * mx && mx > 0.0f;
      if (peak) pv[h] = s;
    }
  }
  // the largest, then the largest of the others
  float v0 = pv[0];
  int b0 = lane;
  if (lane + 32 < NB) take_better(&v0, &b0, pv[1], lane + 32);
  warp_best(&v0, &b0);
  float v1 = -INFINITY;
  int b1 = 1 << 20;   // no candidate: below any bin's
  if (lane != b0) take_better(&v1, &b1, pv[0], lane);
  if (lane + 32 < NB && lane + 32 != b0)
    take_better(&v1, &b1, pv[1], lane + 32);
  warp_best(&v1, &b1);
  if (lane < NO)
    interpolate(sm, lane == 0 ? b0 : b1, lane == 0 ? v0 : v1, bin_width,
                angles + (size_t)k * NO + lane,
                valid + (size_t)k * NO + lane);
}

// ---------------------------------------------------------------------------
// The block design (other patch sides)
// ---------------------------------------------------------------------------

template <int KT>   // samples per thread: L / 256
__global__ void __launch_bounds__(THREADS)
p360_sift_orient_block_kernel(const float* __restrict__ gx,
                              const float* __restrict__ gy,
                              const int64_t* __restrict__ ys,
                              const int64_t* __restrict__ xs,
                              const int64_t* __restrict__ pcy,
                              const int64_t* __restrict__ pcx,
                              const int64_t* __restrict__ ohs,
                              const int64_t* __restrict__ ows,
                              const float* __restrict__ sigs,
                              float* __restrict__ angles,
                              uint8_t* __restrict__ valid, int psg,
                              float bin_scale, float bin_width) {
  __shared__ float part[NB][THREADS];
  __shared__ float hist[NB];   // the sums, then the peaks' values
  __shared__ float sm[NB];     // the smoothed histogram
  const int k = blockIdx.x, t = threadIdx.x;
  const int n2 = psg * psg;
  const float* gxk = gx + (size_t)k * n2;
  const float* gyk = gy + (size_t)k * n2;
  const int y = (int)ys[k], x = (int)xs[k];
  const int cy = (int)pcy[k], cx = (int)pcx[k];
  const int oh = (int)ohs[k], ow = (int)ows[k];
  const float sig = sigs[k];
  const float radius = rintf(4.5f * sig);
  const float s15 = 1.5f * sig;
  const float denom = -2.0f * (s15 * s15);

  float val[KT];
  int bin[KT];
#pragma unroll
  for (int q = 0; q < KT; ++q) {
    const int j = t + THREADS * q;
    val[q] = 0.0f;
    bin[q] = -1;
    if (j < n2) {
      const int iy = j / psg, ix = j - iy * psg;
      const int ay = cy + 1 + iy, ax = cx + 1 + ix;
      const float dyc = (float)(ay - y), dxc = (float)(ax - x);
      const bool inside = fabsf(dyc) <= radius && fabsf(dxc) <= radius &&
                          ay >= 1 && ay <= oh - 2 && ax >= 1 && ax <= ow - 2;
      // outside the window the weight is expf(...) * 0 = +0, so the
      // sample adds +0 to every bin (finite gradients): skip its angle
      if (!inside) continue;
      val[q] = sample(gxk[j], gyk[j], dyc * dyc + dxc * dxc, denom,
                      bin_scale, &bin[q]);
    }
  }

  // the tree's levels of stride L/2 .. 256: inside the thread, for the
  // bins its samples fall in (every other bin's sum is +0)
  unsigned long long present = 0;
#pragma unroll
  for (int q = 0; q < KT; ++q)
    if (bin[q] >= 0) present |= 1ull << bin[q];
  for (int b = 0; b < NB; ++b) part[b][t] = 0.0f;
  while (present) {
    const int b = __ffsll(present) - 1;
    present &= present - 1;
    float v[KT];
#pragma unroll
    for (int q = 0; q < KT; ++q) v[q] = bin[q] == b ? val[q] : 0.0f;
#pragma unroll
    for (int m = KT / 2; m >= 1; m /= 2)
#pragma unroll
      for (int q = 0; q < m; ++q) v[q] = v[q] + v[q + m];
    part[b][t] = v[0];
  }
  // strides 128, 64, 32: across warps
#pragma unroll
  for (int stride = THREADS / 2; stride >= 32; stride /= 2) {
    __syncthreads();
    for (int e = t; e < NB * stride; e += THREADS) {
      const int b = e / stride, j = e % stride;
      part[b][j] = part[b][j] + part[b][j + stride];
    }
  }
  __syncthreads();
  // strides 16 .. 1: inside a warp, a bin per warp in turn
  const int lane = t & 31, warp = t >> 5;
  for (int b = warp; b < NB; b += THREADS / 32) {
    float v = part[b][lane];
#pragma unroll
    for (int off = 16; off >= 1; off /= 2)
      v = v + __shfl_down_sync(0xffffffffu, v, off);
    if (lane == 0) hist[b] = v;
  }
  __syncthreads();
  if (t < NB) {
    const float hm2 = hist[(t + NB - 2) % NB], hp2 = hist[(t + 2) % NB];
    const float hm1 = hist[(t + NB - 1) % NB], hp1 = hist[(t + 1) % NB];
    sm[t] = ((hm2 + hp2) * 0.0625f + (hm1 + hp1) * 0.25f) + hist[t] * 0.375f;
  }
  __syncthreads();
  // the peaks' values (-inf elsewhere), a bin per thread
  if (t < NB) {
    float mx = sm[0];
    for (int b = 1; b < NB; ++b) mx = fmaxf(mx, sm[b]);
    const float hm1 = sm[(t + NB - 1) % NB], hp1 = sm[(t + 1) % NB];
    const bool peak = sm[t] > hm1 && sm[t] > hp1 && sm[t] >= 0.8f * mx &&
                      mx > 0.0f;
    hist[t] = peak ? sm[t] : -INFINITY;
  }
  __syncthreads();
  if (t != 0) return;
  int taken = -1;
  for (int o = 0; o < NO; ++o) {
    // the largest value, the lower bin on a tie (a stable sort)
    int best = o == 0 || taken != 0 ? 0 : 1;
    for (int b = best + 1; b < NB; ++b)
      if (b != taken && hist[b] > hist[best]) best = b;
    taken = best;
    interpolate(sm, best, hist[best], bin_width,
                angles + (size_t)k * NO + o, valid + (size_t)k * NO + o);
  }
}

}  // namespace

extern "C" int p360_sift_orient(const float* gx, const float* gy,
                                const int64_t* y, const int64_t* x,
                                const int64_t* pcy, const int64_t* pcx,
                                const int64_t* oh, const int64_t* ow,
                                const float* sig, float* angles,
                                uint8_t* valid, int m, int psg,
                                float bin_scale, float bin_width,
                                void* stream) {
  // the grid design: 64 x 64 patches
  if (m <= 0 || psg != PSG) return (int)cudaErrorInvalidValue;
  p360_sift_orient_kernel<<<(m + WARPS - 1) / WARPS, WARPS * 32, 0,
                            (cudaStream_t)stream>>>(
      gx, gy, y, x, pcy, pcx, oh, ow, sig, angles, valid, m, bin_scale,
      bin_width);
  return (int)cudaGetLastError();
}

extern "C" int p360_sift_orient_block(const float* gx, const float* gy,
                                      const int64_t* y, const int64_t* x,
                                      const int64_t* pcy, const int64_t* pcx,
                                      const int64_t* oh, const int64_t* ow,
                                      const float* sig, float* angles,
                                      uint8_t* valid, int m, int psg,
                                      float bin_scale, float bin_width,
                                      void* stream) {
  // the block design: any patch of up to 8192 samples
  if (m <= 0 || psg <= 0 || psg * psg > 32 * THREADS)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (psg * psg <= 16 * THREADS)
    p360_sift_orient_block_kernel<16><<<m, THREADS, 0, st>>>(
        gx, gy, y, x, pcy, pcx, oh, ow, sig, angles, valid, psg, bin_scale,
        bin_width);
  else
    p360_sift_orient_block_kernel<32><<<m, THREADS, 0, st>>>(
        gx, gy, y, x, pcy, pcx, oh, ow, sig, angles, valid, psg, bin_scale,
        bin_width);
  return (int)cudaGetLastError();
}
