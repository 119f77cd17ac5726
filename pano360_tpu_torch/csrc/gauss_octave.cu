// One SIFT octave in one pass: the incremental Gaussian chain, the DoG
// stack and the extrema score, for a batch of octave bases.
//
// Replaces: pano360_tpu/ops/pallas_gauss.py, octave_stack (the Pallas
// kernel _make_kernel). Semantics are the Pallas kernel's: the base is
// reflect101-extended once by the chain's cumulative halo, then each
// layer is a separable blur of the previous one (vertical pass, then
// horizontal; taps from chain_taps, every output accumulated in
// ascending tap order, a multiply then an add, built with -fmad=false
// like ops.filters._conv_axis); the score is |DoG| at 26-neighbour
// extrema past +-thresh that pass the integer Hessian edge test and lie
// >= border px inside the image, else 0. Bit-identical to the plain
// version ops/gauss_octave.py:octave_stack_ref.
//
// What bounds it on an H100: device memory. At the bench (4 bases,
// octaves 0-5 of 1728x2304) the function reads 21.2 Mpx once and writes
// 14 f32 planes of it (6 Gaussian, 5 DoG, 3 score): 1.274 GB, 0.380 ms
// at 3.35 TB/s. Its 178 taps per pixel (a multiply and an add each) take
// 0.11 ms at the 67 TFLOP/s f32 peak. So every intermediate layer stays
// in shared memory and only the final planes are written, once.
//
// The price is the ring: a block blurs its tile plus a (halo + 1)-px
// ring of the base, and with -fmad=false every tap is two instructions,
// so the kernel is bound by instruction issue, not by bytes. The design
// keeps the overdraw, and the instructions per tap, small:
// - Tile 80x96 for the default chain (halo 42) at the first octaves,
//   chosen per launch (pick_tile) among the tiles whose buffers fit, by
//   an issue model of a block times its waves. Counted from the loop
//   bounds: 389.3 taps per output pixel on whole 80x96 tiles, 396.5 at
//   the bench's octave 0, against 687 for the 32x64 tile of the first
//   version (178 are needed).
// - One buffer A holds the current layer. The vertical pass runs in bands
//   of 16 rows into a small buffer B; the horizontal pass reads B and
//   writes the new layer back into A shifted up by the layer's half
//   width, so a band never overwrites a row a later band still reads.
//   The DoG of a one-pixel ring around the tile is kept for 3 layers
//   only (a rolling ring of 3 slots, all the 3x3x3 score stencil reads).
// - Register-blocked sliding windows: each thread computes R = 8 adjacent
//   outputs along the pass axis from R + K - 1 inputs it loads once, with
//   the layer's K weights in uniform registers (blur_layer<K, R>, a
//   switch over every odd K up to MAX_TAPS, fully unrolled). That is
//   (R + K - 1) / (R K) shared-memory loads per tap (0.16 at K = 27)
//   instead of 2, and R independent accumulators per thread.
// - Lanes run along x in the vertical pass and along rows in the
//   horizontal one, over a B pitch of 1 mod 32 words, so neither pass's
//   shared-memory reads conflict on banks; a 2-D thread mapping (32 x 16)
//   replaces the flat index's divisions.
// - A block takes 229,664 bytes of shared memory (default chain, 80x96),
//   so one 512-thread block runs per SM. ptxas -v (sm_90a): 128
//   registers (the launch bound), 0 bytes of spills or stack.
// No TPU-specific blocking (lane rolls, banded matmuls) is carried over.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 16;
constexpr int THREADS = 32 * WARPS;
constexpr int BAND = 16;          // rows of B and of a horizontal task
constexpr int R_MAX = 8;          // outputs per thread and pass
constexpr int MAX_LAYERS = 8;
constexpr int MAX_TAPS = 64;
constexpr int TILE_X_MAX = 192;  // tile widths: multiples of 32 up to this
constexpr int TILE_Y_MAX = 96;
constexpr size_t SMEM_MAX = 232448;  // opt-in shared memory of a block
constexpr int SMS = 132;          // SMs of an H100 SXM, for the tile model

// Passed by value (2 KB of kernel parameters): the taps never change
// within a run, so no device buffer or host copy is needed per launch.
struct ChainSpec {
  float taps[MAX_LAYERS * MAX_TAPS];
  int half[MAX_LAYERS];
  int n_lay;
  int halo;
};

// A block's geometry in floats: tile ty x tx, first margin m0 = halo + 1,
// pitches of A (the layer), B (the vertical band) and D (a DoG slot).
struct Tile {
  int ty, tx, m0, pa, pb, pd;
};

__host__ __device__ inline int b_pitch(int tx, int m0) {
  // >= the window, and 1 mod 32: 16 rows of a horizontal task (and the
  // chunk 16 words on) hit 32 distinct banks
  const int need = tx + 2 * m0;
  return need + ((33 - need % 32) % 32);
}

// A, the 3 DoG slots, and B with R_MAX floats after it for the last
// row's chunk overrun
__host__ __device__ inline size_t smem_bytes(int ty, int tx, int m0) {
  const size_t a = (size_t)(ty + 2 * m0) * (tx + 2 * m0);
  const size_t d = 3 * (size_t)(ty + 2) * (tx + 2);
  const size_t b = (size_t)BAND * b_pitch(tx, m0) + R_MAX;
  return (a + d + b) * sizeof(float);
}

__device__ __forceinline__ int reflect101_clamped(int i, int n) {
  // one reflection is exact while the halo is below n; indices past it
  // only feed outputs outside the image, so a clamp keeps them in bounds
  if (i < 0) i = -i;
  if (i >= n) i = 2 * n - 2 - i;
  return min(max(i, 0), n - 1);
}

// Copies 4 bytes from device to shared memory without holding a
// register: a thread's copies are all in flight at once.
__device__ __forceinline__ void cp_async_f32(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(__cvta_generic_to_global(src))
               : "memory");
}

// R outputs of a K-tap pass from its R + K - 1 inputs, each the sum in
// ascending tap order of input * weight (a multiply, then an add: the
// source is built with -fmad=false). Taps run in the outer loop, so each
// weight is read once, as a uniform constant, for R independent sums.
template <int K, int R>
__device__ __forceinline__ void accumulate(float (&acc)[R],
                                           const float (&v)[R + K - 1],
                                           const float* __restrict__ taps) {
  const float w0 = taps[0];
#pragma unroll
  for (int o = 0; o < R; ++o) acc[o] = v[o] * w0;
#pragma unroll
  for (int j = 1; j < K; ++j) {
    const float wj = taps[j];
#pragma unroll
    for (int o = 0; o < R; ++o) acc[o] = acc[o] + v[o + j] * wj;
  }
}

// One layer of the chain: A holds the previous layer in stored rows
// [0, ty + 2m) (window row y at stored row y - (m0 - m)), columns at
// window coordinates [m0 - m, m0 + tx + m). Afterwards A holds the new
// layer in stored rows [0, ty + 2mn), mn = m - K/2, columns [m0 - mn,
// m0 + tx + mn), and Dl its DoG on the tile's one-pixel ring. New row i
// is the vertical blur of old rows i .. i + K - 1 and replaces old row i,
// which only new rows <= i read. Ends synchronized.
template <int K, int R>
__device__ __forceinline__ void blur_layer(float* A, float* B, float* Dl,
                                           const Tile t, const float* taps,
                                           int m) {
  constexpr int HH = K / 2;
  constexpr int SUBS = BAND / R;   // vertical tasks per column and band
  constexpr int PAIR = 16 / R;     // chunks between a warp's two halves
  static_assert(BAND == 16 && 16 % R == 0, "a half-warp spans the band");
  const int lane = threadIdx.x;
  const int warp = threadIdx.y;

  const int mn = m - HH;
  const int rows = t.ty + 2 * mn;
  const int c0v = t.m0 - m;
  const int vcols = t.tx + 2 * m;
  const int c0h = t.m0 - mn;
  const int c1h = c0h + t.tx + 2 * mn;
  const int vtasks = (vcols + 31) / 32 * SUBS;
  const int nch = (c1h - c0h + R - 1) / R;
  const int htasks = (nch + 2 * PAIR - 1) / (2 * PAIR) * PAIR;
  const int hrow = lane & 15;

  for (int r0 = 0; r0 < rows; r0 += BAND) {
    const int nb = min(BAND, rows - r0);
    // vertical: R rows of one column per thread, lanes along x. Rows
    // past the band's end read up to R - 1 rows past the old layer, which
    // stay inside the shared allocation (A is followed by D), and land in
    // B's rows past the band, which no horizontal task reads.
    for (int task = warp; task < vtasks; task += WARPS) {
      const int i0 = (task % SUBS) * R;
      const int col = c0v + (task / SUBS) * 32 + lane;
      if (col >= c0v + vcols || i0 >= nb) continue;
      const float* src = A + (r0 + i0) * t.pa + col;
      float v[R + K - 1];
#pragma unroll
      for (int i = 0; i < R + K - 1; ++i) {
        v[i] = *src;
        src += t.pa;
      }
      float acc[R];
      accumulate<K, R>(acc, v, taps);
      float* dst = B + i0 * t.pb + col;
#pragma unroll
      for (int o = 0; o < R; ++o) dst[o * t.pb] = acc[o];
    }
    __syncthreads();

    // horizontal: R columns of one row per thread, lanes along the rows
    // (lanes 16-31 take the chunk PAIR chunks on). The new row i goes to
    // stored row i. On the tile's ring its DoG needs the old value of the
    // same pixel, old stored row i + HH, which the lane of new row i + HH
    // (in this half-warp) replaces: every lane reads before any writes.
    for (int task = warp; task < htasks; task += WARPS) {
      const int q = (task / PAIR) * 2 * PAIR + task % PAIR +
                    PAIR * (lane >> 4);
      const bool live = q < nch && hrow < nb;
      const int i = r0 + hrow;
      const int c = c0h + q * R;
      const int cy = i - mn;  // tile row of new row i
      const bool ring = live && cy >= -1 && cy <= t.ty;
      float acc[R];
      float old[R];
      if (live) {
        const float* src = B + hrow * t.pb + c - HH;
        float v[R + K - 1];
#pragma unroll
        for (int k = 0; k < R + K - 1; ++k) v[k] = src[k];
        accumulate<K, R>(acc, v, taps);
      }
      if (ring) {
        // a chunk's overrun columns read past the row, inside A or D
        const float* prev = A + (i + HH) * t.pa + c;
#pragma unroll
        for (int o = 0; o < R; ++o) old[o] = prev[o];
      }
      __syncwarp();
      if (live) {
        float* dst = A + i * t.pa + c;
#pragma unroll
        for (int o = 0; o < R; ++o)
          if (c + o < c1h) dst[o] = acc[o];
      }
      if (ring) {
        float* dl = Dl + (cy + 1) * t.pd + c - t.m0 + 1;
#pragma unroll
        for (int o = 0; o < R; ++o) {
          const int cx = c + o - t.m0;
          if (cx >= -1 && cx <= t.tx) dl[o] = acc[o] - old[o];
        }
      }
    }
    __syncthreads();
  }
}

// The tile's part of one output plane from a shared buffer whose tile
// pixel (0, 0) is at S, rows pitch apart.
__device__ __forceinline__ void store_plane(float* out, const float* S,
                                            int pitch, const Tile t, int y0,
                                            int x0, int h, int w) {
  for (int cy = threadIdx.y; cy < t.ty && y0 + cy < h; cy += WARPS) {
    float* row = out + (size_t)(y0 + cy) * w + x0;
    const float* srow = S + cy * pitch;
    for (int cx = threadIdx.x; cx < t.tx && x0 + cx < w; cx += 32)
      row[cx] = srow[cx];
  }
}

// Score plane of the middle one of three DoG slots. Each thread takes a
// column and SR rows: the max and min over 3 columns x 3 slots of each
// of its SR + 2 ring rows, once, then the 3-row maxima slide down.
__device__ __forceinline__ void score_plane(float* out, const float* lo,
                                            const float* mid,
                                            const float* hi, const Tile t,
                                            int y0, int x0, int h, int w,
                                            float thresh, float edge_r,
                                            int border) {
  constexpr int SR = 8;
  const float r2 = (edge_r + 1.0f) * (edge_r + 1.0f);
  const int rx = t.pd;
  const int groups = (t.tx + 31) / 32;
  const int tasks = groups * ((t.ty + SR - 1) / SR);
  for (int task = threadIdx.y; task < tasks; task += WARPS) {
    const int cx = (task % groups) * 32 + threadIdx.x;
    const int cy0 = (task / groups) * SR;
    const int gx = x0 + cx;
    if (cx >= t.tx || gx >= w) continue;
    // ring rows cy0 - 1 .. cy0 + SR; rows past the tile's ring read past
    // the slot, inside the shared allocation, and feed no stored score
    float rmx[SR + 2];
    float rmn[SR + 2];
#pragma unroll
    for (int r = 0; r < SR + 2; ++r) {
      const int at = (cy0 + r) * rx + cx;
      float mx = -INFINITY;
      float mn = INFINITY;
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
        const float a = lo[at + dx];
        const float b = mid[at + dx];
        const float c = hi[at + dx];
        mx = fmaxf(mx, fmaxf(a, fmaxf(b, c)));
        mn = fminf(mn, fminf(a, fminf(b, c)));
      }
      rmx[r] = mx;
      rmn[r] = mn;
    }
    const bool col_in = gx >= border && gx < w - border;
#pragma unroll
    for (int r = 0; r < SR; ++r) {
      const int cy = cy0 + r;
      const int gy = y0 + cy;
      if (cy >= t.ty || gy >= h) break;
      float sc = 0.0f;
      if (col_in && gy >= border && gy < h - border) {
        const float* c = mid + (cy + 1) * rx + cx + 1;
        const float cm = c[0];
        const float mx = fmaxf(rmx[r], fmaxf(rmx[r + 1], rmx[r + 2]));
        const float mnv = fminf(rmn[r], fminf(rmn[r + 1], rmn[r + 2]));
        const bool ext = (cm >= mx && cm > thresh) ||
                         (cm <= mnv && cm < -thresh);
        if (ext) {  // rare: the edge test runs for extrema only
          const float dxx = c[1] - 2.0f * cm + c[-1];
          const float dyy = c[rx] - 2.0f * cm + c[-rx];
          const float dxy =
              (c[rx + 1] - c[rx - 1] - c[-rx + 1] + c[-rx - 1]) * 0.25f;
          const float tr = dxx + dyy;
          const float det = dxx * dyy - dxy * dxy;
          if (det > 0.0f && tr * tr * edge_r < r2 * det) sc = fabsf(cm);
        }
      }
      out[(size_t)gy * w + gx] = sc;
    }
  }
}

#define P360_LAYER(K)                                              \
  case K:                                                          \
    blur_layer<K, (K <= 31 ? 8 : 4)>(A, B, Dl, t, taps, m);        \
    break;

__global__ void __launch_bounds__(THREADS, 1)
octave_stack_kernel(const float* __restrict__ base, float* __restrict__ gauss,
                    float* __restrict__ dog, float* __restrict__ score,
                    int h, int w, int ty, int tx,
                    const __grid_constant__ ChainSpec spec, float thresh,
                    float edge_r, int border) {
  extern __shared__ float smem[];
  Tile t;
  t.ty = ty;
  t.tx = tx;
  t.m0 = spec.halo + 1;
  t.pa = tx + 2 * t.m0;
  t.pb = b_pitch(tx, t.m0);
  t.pd = tx + 2;
  const int nl = spec.n_lay;
  const int dslot = (ty + 2) * t.pd;
  float* A = smem;                          // (ty + 2 m0, pa)
  float* D = A + (ty + 2 * t.m0) * t.pa;    // 3 DoG slots (ty + 2, pd)
  float* B = D + 3 * dslot;                 // (BAND, pb)

  const int n = blockIdx.z;
  const int y0 = blockIdx.y * ty;
  const int x0 = blockIdx.x * tx;
  const size_t plane = (size_t)h * w;
  const float* src = base + (size_t)n * plane;
  float* g_out = gauss + (size_t)n * (nl + 1) * plane;
  float* d_out = dog + (size_t)n * nl * plane;
  float* s_out = score == nullptr ? nullptr
                                  : score + (size_t)n * (nl - 2) * plane;

  for (int r = threadIdx.y; r < ty + 2 * t.m0; r += WARPS) {
    const float* srow =
        src + (size_t)reflect101_clamped(y0 + r - t.m0, h) * w;
    float* arow = A + r * t.pa;
    for (int c = threadIdx.x; c < t.pa; c += 32)
      cp_async_f32(arow + c, srow + reflect101_clamped(x0 + c - t.m0, w));
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
  store_plane(g_out, A + t.m0 * t.pa + t.m0, t.pa, t, y0, x0, h, w);

  int m = t.m0;
  for (int li = 0; li < nl; ++li) {
    const float* taps = spec.taps + li * MAX_TAPS;
    float* Dl = D + (li % 3) * dslot;
    switch (2 * spec.half[li] + 1) {
      P360_LAYER(1) P360_LAYER(3) P360_LAYER(5) P360_LAYER(7)
      P360_LAYER(9) P360_LAYER(11) P360_LAYER(13) P360_LAYER(15)
      P360_LAYER(17) P360_LAYER(19) P360_LAYER(21) P360_LAYER(23)
      P360_LAYER(25) P360_LAYER(27) P360_LAYER(29) P360_LAYER(31)
      P360_LAYER(33) P360_LAYER(35) P360_LAYER(37) P360_LAYER(39)
      P360_LAYER(41) P360_LAYER(43) P360_LAYER(45) P360_LAYER(47)
      P360_LAYER(49) P360_LAYER(51) P360_LAYER(53) P360_LAYER(55)
      P360_LAYER(57) P360_LAYER(59) P360_LAYER(61) P360_LAYER(63)
      default:
        break;  // the host admits odd K <= MAX_TAPS only
    }
    m -= spec.half[li];
    // the next layer's first write to A or to a DoG slot follows a
    // barrier, so these reads need none
    store_plane(g_out + (size_t)(li + 1) * plane, A + m * t.pa + t.m0, t.pa,
                t, y0, x0, h, w);
    store_plane(d_out + (size_t)li * plane, Dl + t.pd + 1, t.pd, t, y0, x0,
                h, w);
    if (s_out != nullptr && li >= 2)
      score_plane(s_out + (size_t)(li - 2) * plane, D + ((li - 2) % 3) * dslot,
                  D + ((li - 1) % 3) * dslot, Dl, t, y0, x0, h, w, thresh,
                  edge_r, border);
  }
}

#undef P360_LAYER

// Issue-time model of one block: per band and pass, the busiest of the
// SM's 4 schedulers runs ceil(tasks / 4) tasks of 2 R K + R + K
// instructions (the blur's multiplies and adds, its shared loads).
long long block_cost(int ty, int tx, const ChainSpec& spec) {
  long long cost = 0;
  int m = spec.halo + 1;
  for (int li = 0; li < spec.n_lay; ++li) {
    const int hh = spec.half[li];
    const int k = 2 * hh + 1;
    const int r = k <= 31 ? 8 : 4;
    const int mn = m - hh;
    const int vtasks = (tx + 2 * m + 31) / 32 * (BAND / r);
    const int nch = (tx + 2 * mn + r - 1) / r;
    const int pair = 16 / r;
    const int htasks = (nch + 2 * pair - 1) / (2 * pair) * pair;
    const int bands = (ty + 2 * mn + BAND - 1) / BAND;
    cost += (long long)bands * ((vtasks + 3) / 4 + (htasks + 3) / 4) *
            (2 * r * k + r + k);
    m = mn;
  }
  return cost;
}

// The tile (width a multiple of 32 up to 192, height a multiple of 8 up
// to 96) whose buffers fit and whose waves of blocks cost the least by
// block_cost: the bench's first octaves take 80x96, small octaves
// smaller tiles on more SMs.
bool pick_tile(const ChainSpec& spec, int n, int h, int w, int* ty, int* tx,
               size_t* smem) {
  const int m0 = spec.halo + 1;
  long long best = -1;
  for (int x = TILE_X_MAX; x >= 32; x -= 32)
    for (int y = TILE_Y_MAX; y >= 8; y -= 8) {
      const size_t bytes = smem_bytes(y, x, m0);
      if (bytes > SMEM_MAX) continue;
      const long long blocks =
          (long long)n * ((h + y - 1) / y) * ((w + x - 1) / x);
      const long long cost = (blocks + SMS - 1) / SMS * block_cost(y, x, spec);
      if (best < 0 || cost < best) {
        best = cost;
        *ty = y;
        *tx = x;
        *smem = bytes;
      }
    }
  return best >= 0;
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
  int ty = 0, tx = 0;
  size_t smem = 0;
  if (!pick_tile(spec, n, h, w, &ty, &tx, &smem))
    return (int)cudaErrorInvalidValue;
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
  const dim3 grid((w + tx - 1) / tx, (h + ty - 1) / ty, n);
  const dim3 block(32, WARPS);
  octave_stack_kernel<<<grid, block, smem, (cudaStream_t)stream>>>(
      base, gauss, dog, score, h, w, ty, tx, spec, thresh, edge_r, border);
  return (int)cudaGetLastError();
}
