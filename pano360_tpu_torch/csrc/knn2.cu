// The match's exact top-2 search: for each row of desc1 (B, M1, D) its
// nearest and second-nearest valid rows of desc2 (B, M2, D) by squared L2
// distance, and Lowe's ratio test on them, with no M1 x M2 tensor in
// device memory.
//
// Replaces: the brute-force top-2 of pano360_tpu/match.py:57 knn2_matches,
// which XLA fuses around one matrix product inside the jitted match graph
// (no Pallas kernel lies behind it). In the port the plain version is
// ops/knn2.py:knn2_ref, about eight PyTorch operations around one GEMM,
// each reading or writing a (B, M1, M2) float tensor: at MSOP's chunk
// (one pair of 8192 x 8192) 268 MB a pass, some 4 GB a chunk.
// Semantics are the plain version's arithmetic, in float32:
// - d2 = max((|a|^2 + |b|^2) - 2 a.b, 0) in float32: the norms float32
//   roundings of float64 sums, the dot product float32 FMAs (the plain
//   version sums both in other orders, so the two agree to float32
//   rounding, not bit for bit; fmaf(-2, a.b, s) is s - 2 a.b rounded once,
//   as the plain version's subtraction of the exact 2 a.b); an invalid
//   column is +inf;
// - the nearest is the first index of the smallest d2 (torch.min), index
//   0 where a row has no valid column; the second is the smallest d2 of
//   the other columns, so a second column at the nearest's distance makes
//   it equal to the nearest's;
// - good = valid1 & (sqrt(d1) < ratio * sqrt(d2)) & isfinite(sqrt(d2)),
//   the IEEE square root and one rounded multiply in float32.
// The float32 search keeps each row's two nearest (distance, index), and
// the two are then ranked again on their float64 distances (sum of
// (a - b)^2, first index on a tie), and the test takes the nearest
// float32 of those: where the float32 distances of a near tie or of a row
// on the ratio's line fall within their rounding of each other, the row
// gets float64's answer, and elsewhere the plain version's.
//
// What bounds it on an H100: operations. The cross term is 2 M1 N2 D
// float32 operations over the N2 valid columns (6.8 G at MSOP's 1 x 8192
// rows x ~6,500 valid columns x 64: 0.10 ms at the 67 TFLOP/s peak;
// ops/knn2.py:knn2_cost) against 4 MB of descriptors read; float32 FMAs
// only (no TF32 or bf16, which would lower the configuration's
// precision).
// Design: three launches. (1) A thread a row sums each row's squared norm
// in float64 and rounds it once (an invalid desc2 row's is +inf): the
// nearest float32 of the norm, where an ascending float32 chain of D
// terms drifts. (2) The search: a block takes 128 rows of desc1, staged
// whole (all D) in shared memory as float4 quads of k, and streams
// 64-column tiles of desc2 through a double-buffered ring of 32-k chunks
// (cp.async). Each of its 256 threads keeps an 8 x 4 register tile of dot
// products (rows ty + 16 r, columns tx + 16 c, so that the 16 threads of
// a row read neighbouring quads: no bank conflict), each in two float32
// FMA chains, the even quads of k and the odd, added at the end: half the
// chain's length, about a quarter of its rounding's variance, in the
// registers an 8 x 8 tile of single chains would take; per pair of k
// quads it loads 8 + 4 float4 for 128 FMAs. After a tile's last chunk the
// thread folds its 32 distances into a running (d1, i1, d2, i2) for each
// of its 8 rows, kept in shared memory; it visits its columns in ascending
// order, so a strict "<" keeps the first index (the two indices packed in
// 16 bits each: M2 < 65536). At the end the 16 threads of a row merge by
// warp shuffles, (d, index) compared as a pair. A
// pair's columns are cut into slices (grid x) so that MSOP's one pair of
// 64 row tiles still fills the card. Every block first finds the pair's
// last valid column and shares the tiles up to it among the slices: the
// padding behind the valid keypoints is never computed (its d2 is +inf by
// definition). (3) A thread a row merges the row's slices, ranks the two
// candidates on their float64 distances and runs the ratio test.
// The kernels launch on the given stream, allocate nothing and read
// nothing on the host, so a CUDA graph captures them.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int TX = 16, TY = 16;          // the threads of a block, 16 x 16
constexpr int RT = 8, CT = 4;            // rows and columns a thread
constexpr int BM = TY * RT;              // 128 rows a block
constexpr int BN = TX * CT;              // 64 columns a tile
constexpr int KC = 32;                   // k a staged chunk of a tile
constexpr int KQ = KC / 4;               // its float4 quads a column
constexpr int MAX_D = 128;
constexpr int APITCH = BM + 1;           // float4 a quad row of the rows
constexpr int BPITCH = BN + 1;           // float4 a quad row of a chunk
constexpr int ROW_THREADS = 256;         // the norms' and merge's blocks
constexpr int MAX_DEVICES = 64;

// shared memory of a block at width d: the rows (d / 4 quads), two chunks,
// the running (d1, d2, i1) of each thread's rows, the rows' and a tile's
// squared norms
constexpr size_t smem_bytes(int d) {
  return sizeof(float4) * ((size_t)(d / 4) * APITCH + 2 * KQ * BPITCH) +
         sizeof(float) * (3 * RT * THREADS + BM + BN);
}

// one 16-byte copy from device memory to shared memory, not waited for;
// zeros where !ok (nothing is read then)
__device__ __forceinline__ void copy16(float4* dst, const float4* src,
                                       bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// every group but the newest has landed
__device__ __forceinline__ void all_but_newest() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// (distance, index) pairs: is (d, i) before (e, j)?
__device__ __forceinline__ bool before(float d, int i, float e, int j) {
  return d < e || (d == e && i < j);
}

// two rows' two nearest, (d1, i1) before (d2, i2) and (e1, j1) before
// (e2, j2): -> the two first of the four, in (d1, i1, d2, i2)
__device__ __forceinline__ void merge(float& d1, int& i1, float& d2, int& i2,
                                      float e1, int j1, float e2, int j2) {
  if (before(e1, j1, d1, i1)) {
    if (!before(d1, i1, e2, j2)) {
      d1 = e2;
      i1 = j2;
    }
    d2 = d1;
    i2 = i1;
    d1 = e1;
    i1 = j1;
  } else if (before(e1, j1, d2, i2)) {
    d2 = e1;
    i2 = j1;
  }
}

constexpr int NONE = 0xffff;             // a packed index: no column yet

// the squared norm of each row of desc1 and desc2 (B, M1 + M2): a float64
// FMA chain in ascending k, rounded once; +inf for an invalid desc2 row
__global__ void __launch_bounds__(ROW_THREADS)
p360_knn2_norms_kernel(const float* __restrict__ desc1,
                       const float* __restrict__ desc2,
                       const uint8_t* __restrict__ valid2, int b, int m1,
                       int m2, int d, float* __restrict__ norms) {
  const long long i = (long long)blockIdx.x * ROW_THREADS + threadIdx.x;
  const int m = m1 + m2;
  if (i >= (long long)b * m) return;
  const long long pb = i / m;
  const int r = (int)(i % m);
  const bool second = r >= m1;
  const size_t row = second ? (size_t)pb * m2 + (r - m1) : (size_t)pb * m1 + r;
  const float4* src =
      reinterpret_cast<const float4*>((second ? desc2 : desc1) + row * d);
  double acc = 0.0;
  for (int q = 0; q < d / 4; ++q) {
    const float4 v = src[q];
    acc = fma((double)v.x, (double)v.x, acc);
    acc = fma((double)v.y, (double)v.y, acc);
    acc = fma((double)v.z, (double)v.z, acc);
    acc = fma((double)v.w, (double)v.w, acc);
  }
  norms[i] = second && !valid2[row] ? INFINITY : __double2float_rn(acc);
}

__global__ void __launch_bounds__(THREADS, 2)
p360_knn2_kernel(const float* __restrict__ desc1,
                 const float* __restrict__ desc2,
                 const uint8_t* __restrict__ valid2,
                 const float* __restrict__ norms, int m1, int m2, int d,
                 int slices, float4* __restrict__ part) {
  extern __shared__ float4 smem[];
  __shared__ int last;
  float4* rows = smem;                                  // (d / 4, APITCH)
  float4* chunks = rows + (d / 4) * APITCH;             // (2, KQ, BPITCH)
  float* st_d1 = reinterpret_cast<float*>(chunks + 2 * KQ * BPITCH);
  float* st_d2 = st_d1 + RT * THREADS;                  // (RT, THREADS)
  // i1 in the low 16 bits, i2 in the high
  unsigned* st_ix = reinterpret_cast<unsigned*>(st_d2 + RT * THREADS);
  float* sq1 = reinterpret_cast<float*>(st_ix + RT * THREADS);  // (BM)
  float* sq2 = sq1 + BM;                                         // (BN)

  const int tid = threadIdx.x, tx = tid % TX, ty = tid / TX;
  const int s = blockIdx.x, r0 = blockIdx.y * BM, b = blockIdx.z;
  const int dq = d / 4;
  const float* a = desc1 + ((size_t)b * m1 + r0) * d;
  const float* bb = desc2 + (size_t)b * m2 * d;
  const uint8_t* v2 = valid2 + (size_t)b * m2;
  const float* n1 = norms + (size_t)b * (m1 + m2);
  const float* n2 = n1 + m1;

  // the pair's last valid column, and this slice's share of the tiles up
  // to it
  if (tid == 0) last = -1;
  if (tid < BM) sq1[tid] = r0 + tid < m1 ? n1[r0 + tid] : 0.f;
#pragma unroll
  for (int r = 0; r < RT; ++r) {
    st_d1[r * THREADS + tid] = INFINITY;
    st_d2[r * THREADS + tid] = INFINITY;
    st_ix[r * THREADS + tid] = 0xffffffffu;
  }
  __syncthreads();
  int mine = -1;
  for (int j = tid; j < m2; j += THREADS)
    if (v2[j]) mine = j;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    mine = max(mine, __shfl_xor_sync(0xffffffffu, mine, off));
  if ((tid & 31) == 0 && mine >= 0) atomicMax(&last, mine);
  __syncthreads();
  const int tiles = (last + BN) / BN;
  const int t0 = (int)((long long)tiles * s / slices);
  const int t1 = (int)((long long)tiles * (s + 1) / slices);
  const int ch = d / KC;
  const int steps = (t1 - t0) * ch;

  // chunk c of tile t into buffer buf
  auto stage = [&](int t, int c, int buf) {
    const int col0 = t * BN, k0 = c * KC;
    float4* dst = chunks + buf * KQ * BPITCH;
#pragma unroll
    for (int i = tid; i < BN * KQ; i += THREADS) {
      const int n = i / KQ, q = i % KQ;
      const bool ok = col0 + n < m2;
      const float* src = ok ? bb + (size_t)(col0 + n) * d + k0 : desc2;
      copy16(dst + q * BPITCH + n, reinterpret_cast<const float4*>(src) +
                                       (ok ? q : 0), ok);
    }
  };

  if (steps > 0) {
    for (int i = tid; i < BM * dq; i += THREADS) {
      const int row = i / dq, q = i % dq;
      const bool ok = r0 + row < m1;
      const float* src = ok ? a + (size_t)row * d : desc1;
      copy16(rows + q * APITCH + row,
             reinterpret_cast<const float4*>(src) + (ok ? q : 0), ok);
    }
    stage(t0, 0, 0);
    commit();
  }

  // each dot product in two chains: the even quads of k, and the odd
  float acc[2][RT][CT];
  for (int st = 0; st < steps; ++st) {
    const int t = t0 + st / ch, c = st % ch, buf = st & 1;
    const int col0 = t * BN;
    if (st + 1 < steps) stage(t0 + (st + 1) / ch, (st + 1) % ch, buf ^ 1);
    commit();
    // a tile's last chunk: its columns' norms, read while the sums run
    const bool last_chunk = c == ch - 1;
    float norm2 = INFINITY;
    if (last_chunk && tid < BN && col0 + tid < m2) norm2 = n2[col0 + tid];
    all_but_newest();
    __syncthreads();
    if (c == 0) {
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int r = 0; r < RT; ++r)
#pragma unroll
          for (int cc = 0; cc < CT; ++cc) acc[h][r][cc] = 0.f;
    }
    const float4* bq = chunks + buf * KQ * BPITCH;
    const float4* aq = rows + c * KQ * APITCH;
#pragma unroll
    for (int q = 0; q < KQ; ++q) {
      const int h = q & 1;
      float4 bv[CT];
#pragma unroll
      for (int cc = 0; cc < CT; ++cc) bv[cc] = bq[q * BPITCH + tx + TX * cc];
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        const float4 av = aq[q * APITCH + ty + TY * r];
#pragma unroll
        for (int cc = 0; cc < CT; ++cc) {
          float& x = acc[h][r][cc];
          x = fmaf(av.x, bv[cc].x, x);
          x = fmaf(av.y, bv[cc].y, x);
          x = fmaf(av.z, bv[cc].z, x);
          x = fmaf(av.w, bv[cc].w, x);
        }
      }
    }
    if (last_chunk) {
      if (tid < BN) sq2[tid] = norm2;
      __syncthreads();
      float s2[CT];
#pragma unroll
      for (int cc = 0; cc < CT; ++cc) s2[cc] = sq2[tx + TX * cc];
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        const float s1 = sq1[ty + TY * r];
        const int k = r * THREADS + tid;
        float d1 = st_d1[k], d2 = st_d2[k];
        unsigned ix = st_ix[k];
#pragma unroll
        for (int cc = 0; cc < CT; ++cc) {
          const float dot = __fadd_rn(acc[0][r][cc], acc[1][r][cc]);
          const float dd = fmaxf(fmaf(-2.f, dot, __fadd_rn(s1, s2[cc])), 0.f);
          const unsigned j = col0 + tx + TX * cc;
          const bool nearer = dd < d1, second = dd < d2;
          // nearer: (j, i1) -> (i1, i2); else second: (i1, j)
          ix = nearer ? __byte_perm(j, ix, 0x5410)
                      : (second ? __byte_perm(ix, j, 0x5410) : ix);
          d2 = nearer ? d1 : fminf(d2, dd);
          d1 = fminf(d1, dd);
        }
        st_d1[k] = d1;
        st_d2[k] = d2;
        st_ix[k] = ix;
      }
    }
    __syncthreads();
  }

  // the 16 threads of a row (one half-warp) merge; one writes the slice's
  // (d1, i1, d2, i2)
#pragma unroll
  for (int r = 0; r < RT; ++r) {
    const int k = r * THREADS + tid;
    float d1 = st_d1[k], d2 = st_d2[k];
    int i1 = st_ix[k] & 0xffff, i2 = st_ix[k] >> 16;
#pragma unroll
    for (int off = TX / 2; off > 0; off >>= 1) {
      const float e1 = __shfl_xor_sync(0xffffffffu, d1, off);
      const int j1 = __shfl_xor_sync(0xffffffffu, i1, off);
      const float e2 = __shfl_xor_sync(0xffffffffu, d2, off);
      const int j2 = __shfl_xor_sync(0xffffffffu, i2, off);
      merge(d1, i1, d2, i2, e1, j1, e2, j2);
    }
    const int row = r0 + ty + TY * r;
    if (tx == 0 && row < m1)
      part[((size_t)b * slices + s) * m1 + row] =
          make_float4(d1, __int_as_float(i1), d2, __int_as_float(i2));
  }
}

// the float64 squared distance of two float32 rows of width d
__device__ double exact_dist(const float* a, const float* c, int d) {
  const float4* a4 = reinterpret_cast<const float4*>(a);
  const float4* c4 = reinterpret_cast<const float4*>(c);
  double acc = 0.0;
  for (int q = 0; q < d / 4; ++q) {
    const float4 u = a4[q], v = c4[q];
    const double x = (double)u.x - v.x, y = (double)u.y - v.y;
    const double z = (double)u.z - v.z, w = (double)u.w - v.w;
    acc = fma(x, x, acc);
    acc = fma(y, y, acc);
    acc = fma(z, z, acc);
    acc = fma(w, w, acc);
  }
  return acc;
}

__global__ void __launch_bounds__(ROW_THREADS)
p360_knn2_merge_kernel(const float4* __restrict__ part,
                       const float* __restrict__ desc1,
                       const float* __restrict__ desc2,
                       const uint8_t* __restrict__ valid1, int b, int m1,
                       int m2, int d, int slices, float ratio,
                       long long* __restrict__ best,
                       uint8_t* __restrict__ good) {
  const long long i = (long long)blockIdx.x * ROW_THREADS + threadIdx.x;
  if (i >= (long long)b * m1) return;
  const long long pb = i / m1, row = i % m1;
  float d1 = INFINITY, d2 = INFINITY;
  int i1 = NONE, i2 = NONE;
  for (int s = 0; s < slices; ++s) {
    const float4 p = part[((size_t)pb * slices + s) * m1 + row];
    merge(d1, i1, d2, i2, p.x, __float_as_int(p.y), p.z, __float_as_int(p.w));
  }
  // the two candidates on their float64 distances
  const float* a = desc1 + (size_t)i * d;
  const float* c = desc2 + (size_t)pb * m2 * d;
  const double e1 = d1 < INFINITY ? exact_dist(a, c + (size_t)i1 * d, d)
                                  : (double)INFINITY;
  const double e2 = d2 < INFINITY ? exact_dist(a, c + (size_t)i2 * d, d)
                                  : (double)INFINITY;
  const bool swap = e2 < e1 || (e2 == e1 && i2 < i1);
  const float f1 = __double2float_rn(swap ? e2 : e1);
  const float f2 = __double2float_rn(swap ? e1 : e2);
  const float first = __fsqrt_rn(f1), second = __fsqrt_rn(f2);
  // no valid column: torch.min's first index
  best[i] = d1 < INFINITY ? (swap ? i2 : i1) : 0;
  good[i] = valid1[i] != 0 && first < __fmul_rn(ratio, second) &&
            isfinite(second);
}

unsigned row_blocks(long long rows) {
  return (unsigned)((rows + ROW_THREADS - 1) / ROW_THREADS);
}

}  // namespace

// desc1 (B, M1, D), desc2 (B, M2, D) float32, 16-byte aligned, D a
// multiple of 32 up to 128, M2 < 65535; valid1 (B, M1), valid2 (B, M2)
// bool; norms (B, M1 + M2) and part (B, slices, M1, 4) float32 scratch;
// best (B, M1) int64, good (B, M1) bool
extern "C" int p360_knn2(const float* desc1, const float* desc2,
                         const uint8_t* valid1, const uint8_t* valid2,
                         float* norms, float* part, long long* best,
                         uint8_t* good, int b, int m1, int m2, int d,
                         int slices, float ratio, void* stream) {
  const int row_tiles = (m1 + BM - 1) / BM;
  if (b < 1 || m1 < 1 || m2 < 1 || m2 >= NONE || d < KC || d > MAX_D ||
      d % KC || slices < 1 || b > 65535 || row_tiles > 65535)
    return (int)cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  static bool set[MAX_DEVICES] = {};
  if (!set[dev]) {
    err = cudaFuncSetAttribute(p360_knn2_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem_bytes(MAX_D));
    if (err != cudaSuccess) return (int)err;
    set[dev] = true;
  }
  const cudaStream_t s = (cudaStream_t)stream;
  float4* p = reinterpret_cast<float4*>(part);
  p360_knn2_norms_kernel<<<row_blocks((long long)b * (m1 + m2)), ROW_THREADS,
                           0, s>>>(desc1, desc2, valid2, b, m1, m2, d, norms);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  p360_knn2_kernel<<<dim3(slices, row_tiles, b), THREADS, smem_bytes(d), s>>>(
      desc1, desc2, valid2, norms, m1, m2, d, slices, p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  p360_knn2_merge_kernel<<<row_blocks((long long)b * m1), ROW_THREADS, 0,
                           s>>>(p, desc1, desc2, valid1, b, m1, m2, d, slices,
                                ratio, best, good);
  return (int)cudaGetLastError();
}
