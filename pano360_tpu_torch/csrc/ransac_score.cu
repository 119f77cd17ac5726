// RANSAC's hypothesis scoring: every hypothesis of a chunk of pairs
// against every correspondence of its pair, and each pair's winner.
//
// Replaces: the scoring of pano360_tpu/match.py's parallel RANSAC, which
// XLA fuses inside the jitted match graph (no Pallas kernel lies behind
// it); in the port the plain version is ops/ransac.py:score_ref, about
// two dozen PyTorch elementwise operations that each write a
// (B, K, M) float tensor.
// Semantics are the plain version's, bit for bit:
// - a point's squared error is match.py's _reproj_errors operation by
//   operation: u, v and w each as (h0 x + h1 y) + h2, separate multiplies
//   and adds (the __f*_rn intrinsics are never contracted), the guard
//   |w| > 1e-12 (the float nearest 1e-12, as PyTorch compares a float
//   tensor with a scalar), the IEEE reciprocal of w (PyTorch's 1.0 / w
//   is reciprocal() then * 1.0), du = u (1 / w) - x2, the same for dv,
//   du du + dv dv; the guard's failures are inf;
// - a hypothesis's count is the number of valid points whose error is
//   < thresh^2; 0 where any of its 9 entries is not finite;
// - the winner is the first index of the largest count (torch.argmax),
//   index 0 when every count is 0; its mask is its points' inlier test.
//
// What bounds it on an H100: operations. A chunk of the rig (16 pairs,
// 2048 hypotheses, 2048 points) is 67 M (hypothesis, point) tests of
// 23 f32 operations each (1.5 GFLOP) on 0.9 MB of inputs: each test
// is a few dozen instructions with no contraction and the reciprocal's
// refinement, so the kernel is bound by instruction throughput, never by
// memory.
// Design: the score kernel takes a tile of 256 hypotheses (2 a thread,
// their 9 coefficients in registers) against a split of 256 points of
// one pair, staged in shared memory as float4 (x1, y1, x2, y2) with an
// invalid point's x2 and y2 made NaN (its error is then NaN or inf and
// never an inlier, which is the plain version's "& valid"); each thread
// reads the points as shared-memory broadcasts. The grid is (hypothesis
// tiles, point splits, pairs), so the smallest chunk of the main path
// (4 pairs at 4096 points: 8 x 16 x 4 blocks) still fills the card; each
// block writes its integer partial counts, which sum exactly in any
// order. The select kernel, a block per pair, sums a hypothesis's
// partials, zeroes the non-finite ones, takes the first largest (ties to
// the lower index, within a thread and in the reductions), copies the
// winner and recomputes its mask over the pair's points.
// Both launch on the given stream, allocate nothing and read nothing on
// the host, so a CUDA graph captures them.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;             // the score kernel's block
constexpr int HPT = 2;                   // hypotheses a thread
constexpr int HYPS = THREADS * HPT;      // hypotheses a block
constexpr int PTS = 256;                 // points a block (one split)
constexpr int SEL_THREADS = 256;         // the select kernel's block

// _reproj_errors's error of point (x, y) -> (px, py) under h, against t2
__device__ __forceinline__ bool inlier(const float* h, float x, float y,
                                       float px, float py, float t2) {
  const float u = __fadd_rn(__fadd_rn(__fmul_rn(h[0], x), __fmul_rn(h[1], y)),
                            h[2]);
  const float v = __fadd_rn(__fadd_rn(__fmul_rn(h[3], x), __fmul_rn(h[4], y)),
                            h[5]);
  const float w = __fadd_rn(__fadd_rn(__fmul_rn(h[6], x), __fmul_rn(h[7], y)),
                            h[8]);
  const bool okw = fabsf(w) > 1e-12f;
  const float inv_w = __frcp_rn(w);
  const float du = __fsub_rn(__fmul_rn(u, inv_w), px);
  const float dv = __fsub_rn(__fmul_rn(v, inv_w), py);
  return okw && __fadd_rn(__fmul_rn(du, du), __fmul_rn(dv, dv)) < t2;
}

__global__ void __launch_bounds__(THREADS)
p360_ransac_score_kernel(const float* __restrict__ homs,
                         const float* __restrict__ p1,
                         const float* __restrict__ p2,
                         const uint8_t* __restrict__ valid, int k, int m,
                         float t2, int* __restrict__ part) {
  __shared__ float4 pts[PTS];
  const int b = blockIdx.z;
  const int s = blockIdx.y;
  const int m0 = s * PTS;
  const int n = min(PTS, m - m0);
  for (int i = threadIdx.x; i < n; i += THREADS) {
    const size_t j = (size_t)b * m + m0 + i;
    const bool ok = valid[j] != 0;
    pts[i] = make_float4(p1[2 * j], p1[2 * j + 1], ok ? p2[2 * j] : NAN,
                         ok ? p2[2 * j + 1] : NAN);
  }
  float h[HPT][9];
  int cnt[HPT];
  const int k0 = blockIdx.x * HYPS + threadIdx.x;
#pragma unroll
  for (int q = 0; q < HPT; ++q) {
    const int kk = min(k0 + q * THREADS, k - 1);
    const float* src = homs + ((size_t)b * k + kk) * 9;
#pragma unroll
    for (int e = 0; e < 9; ++e) h[q][e] = src[e];
    cnt[q] = 0;
  }
  __syncthreads();
#pragma unroll 4
  for (int i = 0; i < n; ++i) {
    const float4 p = pts[i];
#pragma unroll
    for (int q = 0; q < HPT; ++q)
      cnt[q] += inlier(h[q], p.x, p.y, p.z, p.w, t2);
  }
  int* out = part + ((size_t)b * gridDim.y + s) * k;
#pragma unroll
  for (int q = 0; q < HPT; ++q)
    if (k0 + q * THREADS < k) out[k0 + q * THREADS] = cnt[q];
}

// (count, index) pairs: the larger count, ties to the lower index
__device__ __forceinline__ void better(int& c, int& i, int oc, int oi) {
  if (oc > c || (oc == c && oi < i)) {
    c = oc;
    i = oi;
  }
}

__global__ void __launch_bounds__(SEL_THREADS)
p360_ransac_select_kernel(const float* __restrict__ homs,
                          const float* __restrict__ p1,
                          const float* __restrict__ p2,
                          const uint8_t* __restrict__ valid,
                          const int* __restrict__ part, int k, int m,
                          int splits, float t2, float* __restrict__ best,
                          uint8_t* __restrict__ mask,
                          int* __restrict__ counts) {
  __shared__ int warp_c[SEL_THREADS / 32];
  __shared__ int warp_i[SEL_THREADS / 32];
  __shared__ int winner;
  const int b = blockIdx.x;
  int bc = -1, bi = 0;
  for (int kk = threadIdx.x; kk < k; kk += SEL_THREADS) {
    int c = 0;
    for (int s = 0; s < splits; ++s)
      c += part[((size_t)b * splits + s) * k + kk];
    const float* h = homs + ((size_t)b * k + kk) * 9;
    bool finite = true;
#pragma unroll
    for (int e = 0; e < 9; ++e) finite = finite && isfinite(h[e]);
    if (!finite) c = 0;
    if (counts) counts[(size_t)b * k + kk] = c;
    if (c > bc) {          // ascending indices: the first largest stays
      bc = c;
      bi = kk;
    }
  }
  for (int off = 16; off > 0; off >>= 1)
    better(bc, bi, __shfl_down_sync(0xffffffffu, bc, off),
           __shfl_down_sync(0xffffffffu, bi, off));
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  if (lane == 0) {
    warp_c[wid] = bc;
    warp_i[wid] = bi;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int c = warp_c[0], i = warp_i[0];
    for (int w = 1; w < SEL_THREADS / 32; ++w)
      better(c, i, warp_c[w], warp_i[w]);
    winner = i;
  }
  __syncthreads();
  float h[9];
  const float* src = homs + ((size_t)b * k + winner) * 9;
#pragma unroll
  for (int e = 0; e < 9; ++e) h[e] = src[e];
  if (threadIdx.x < 9) best[(size_t)b * 9 + threadIdx.x] = src[threadIdx.x];
  for (int i = threadIdx.x; i < m; i += SEL_THREADS) {
    const size_t j = (size_t)b * m + i;
    mask[j] = valid[j] != 0 &&
              inlier(h, p1[2 * j], p1[2 * j + 1], p2[2 * j], p2[2 * j + 1], t2);
  }
}

}  // namespace

// homs (B, K, 3, 3), p1 and p2 (B, M, 2) float32, valid (B, M) bool;
// part (B, ceil(M / PTS), K) int32 scratch (PTS is ops/ransac.py's
// SPLIT); best (B, 3, 3) float32, mask (B, M) bool; counts (B, K) int32
// or null
extern "C" int p360_ransac_score(const float* homs, const float* p1,
                                 const float* p2, const uint8_t* valid,
                                 int* part, float* best, uint8_t* mask,
                                 int* counts, int b, int k, int m, float t2,
                                 cudaStream_t stream) {
  const int splits = (m + PTS - 1) / PTS;
  const dim3 grid((k + HYPS - 1) / HYPS, splits, b);
  p360_ransac_score_kernel<<<grid, THREADS, 0, stream>>>(homs, p1, p2, valid,
                                                         k, m, t2, part);
  p360_ransac_select_kernel<<<b, SEL_THREADS, 0, stream>>>(
      homs, p1, p2, valid, part, k, m, splits, t2, best, mask, counts);
  return (int)cudaGetLastError();
}
