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
// What bounds it on an H100: bytes, the two gradient patches (the
// samples inside the window are what the function needs: ~1 000 of a
// patch's 4 096 at the largest sigma); ~20 operations a sample. The
// plain version passes over a (K, L) chunk ~40 times a bin. The design:
// one block of 256 threads per keypoint; thread t takes the samples
// t + 256 k, so the tree's first levels (strides L/2 .. 256) are adds
// inside a thread, the next three go through shared memory (36 bins x
// 256 partial sums) and the last five are warp shuffles. A bin's sum is
// the tree of its own samples with zeros elsewhere, which adds nothing:
// x + 0 = x; so a sample outside the window (weight +0) is left out, only
// the ~1 000 inside take the angle, weight and bin, and a thread runs its
// in-thread tree only for the few bins its samples fall in (the others'
// partial sums are +0): a loop over all 36 bins took 7x the time on the
// card. The block reads the samples once, coalesced along rows. Image
// coordinates are int32 here (the plain version's int64 values are
// small).
#include <math.h>
#include <stdint.h>

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int NB = 36;   // orientation bins
constexpr int NO = 2;    // orientations

__device__ __forceinline__ float remainder_f(float a, float b) {
  // torch.remainder on floats: fmod, then the divisor added where the
  // signs differ
  float mod = fmodf(a, b);
  if (mod != 0.0f && ((b < 0.0f) != (mod < 0.0f))) mod += b;
  return mod;
}

template <int KT>   // samples per thread: L / 256
__global__ void __launch_bounds__(THREADS)
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
      const float gxv = gxk[j], gyv = gyk[j];
      const float mag = sqrtf(gxv * gxv + gyv * gyv);
      const float ori = atan2f(gyv, gxv);
      const float rr = dyc * dyc + dxc * dxc;
      const float wgt = expf(rr / denom);  // times inside: 1 here
      // rint(ori * 36 / 2 pi) lies in [-18, 18]: int32 holds it
      int b = (int)rintf(ori * bin_scale) % NB;
      if (b < 0) b += NB;
      bin[q] = b;
      val[q] = mag * wgt;
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
    const float hm1 = sm[(best + NB - 1) % NB], hi = sm[best];
    const float hp1 = sm[(best + 1) % NB];
    const float den = (hm1 - 2.0f * hi) + hp1;
    const bool big = fabsf(den) > 1e-12f;
    const float interp = big ? (0.5f * (hm1 - hp1)) / den : 0.0f;
    const float pos = remainder_f((float)best + interp, (float)NB);
    angles[(size_t)k * NO + o] = pos * bin_width;
    valid[(size_t)k * NO + o] = isfinite(hist[best]);
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
  if (m <= 0 || psg <= 0 || psg * psg > 32 * THREADS)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (psg * psg <= 16 * THREADS)
    p360_sift_orient_kernel<16><<<m, THREADS, 0, st>>>(
        gx, gy, y, x, pcy, pcx, oh, ow, sig, angles, valid, psg, bin_scale,
        bin_width);
  else
    p360_sift_orient_kernel<32><<<m, THREADS, 0, st>>>(
        gx, gy, y, x, pcy, pcx, oh, ow, sig, angles, valid, psg, bin_scale,
        bin_width);
  return (int)cudaGetLastError();
}
