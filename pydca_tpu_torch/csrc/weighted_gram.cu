// Weighted one-hot co-occurrence (Gram) matrix of an alignment.
//
// Replaces pydca_tpu/ops/pallas_kernels.py::weighted_gram (body
// _gram_kernel), the counting layer of the mean-field engine
// (pydca_tpu/stats.py::weighted_gram, pydca_tpu/meanfield.py:97).  For the
// int8 (N, L) codes with states in [0, q) and the (N,) weights it computes,
// with K = L*q, r = (i, a) = i*q + a and c = (j, b) = j*q + b,
//
//     G[r, c] = sum_n w[n] * [codes[n, i] == a] * [codes[n, j] == b]
//
// i.e. X^T diag(w) X over the one-hot X, unnormalised: the caller divides
// by Meff, as with the TPU kernel.  Every product is w[n] or 0 exactly, and
// the sums run in full fp32 (or fp64) on the CUDA cores: no TF32, no bf16,
// as the TPU kernel pins Precision.HIGHEST because these sums feed a matrix
// inverse.
//
// What bounds it on an H100: fp32 FMA throughput on the CUDA cores.  The
// dense form is 2*N*K^2 flops; at N = 4096, K = 21000 the upper triangle
// alone is 9.0e11 FMA (1.8e12 flop) against 67 TFLOP/s of fp32 peak, while
// the only inputs read are the codes (4 MB) and weights; the output
// (K^2 * 4 bytes = 1.76 GB) is written once.  Only N*L^2/2 of those
// products are non-zero, q^2 = 441 times fewer: a later version can exploit
// that sparsity (a scatter over code pairs), or run a 3-pass bf16 wgmma
// split of the weights on the tensor cores.
//
// Design (simple and exact, first version):
//   - each block owns one 128 x 128 output tile; only tiles on or above
//     the diagonal are launched (a 1-D grid over the upper triangle), and
//     an off-diagonal tile is written to both halves: G is symmetric;
//   - the block loops over all N itself, 16 sequences per stage (this
//     replaces the TPU's sequential `nb` grid axis: nothing carries over
//     between GPU blocks).  Each thread builds one column of both operands
//     for 8 of the stage's rows in registers from the codes,
//     x = (codes[n, site(r)] == state(r)), the A operand times w[n], and
//     stores them to shared memory, so the (N, K) one-hot never exists in
//     device memory.  The next stage's codes and weights are fetched into
//     registers while the current stage is multiplied;
//   - each of the 256 threads accumulates an 8 x 8 register sub-tile
//     (rows ty*4 + {0..3, 64..67}, columns tx*4 + {0..3, 64..67}, read as
//     16-byte vectors from shared memory) in n order.  In fp32 the sums of
//     4 stages (64 sequences) go into a partial that is then added to the
//     total, which keeps the rounding error of long sums near sqrt(N/64)
//     instead of sqrt(N) half-ulps;
//   - no atomics: every output element is written by exactly one thread,
//     so the result is the same in every run;
//   - ragged K and N are masked: columns past K take the state -2 and
//     rows past N the code -1 and weight 0, which match nothing.  Output
//     offsets are 64-bit (K^2 passes 2^31 at L ~ 2200, q = 21).

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int TILE = 128;                       // output tile edge
constexpr int HALF = TILE / 2;
constexpr int BN = 16;                          // sequences per stage
constexpr int TX = 16;                          // threads along columns
constexpr int TY = 16;                          // threads along rows
constexpr int THREADS = TX * TY;
constexpr int BUILD_ROWS = BN * TILE / THREADS; // stage rows one thread builds
constexpr int ROW_STEP = THREADS / TILE;        // row stride of those rows
constexpr int SUB = 4;                          // fp32 stages per partial sum

__device__ __forceinline__ void load4(const float* p, float* o) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
}

__device__ __forceinline__ void load4(const double* p, double* o) {
  const double2 u = reinterpret_cast<const double2*>(p)[0];
  const double2 v = reinterpret_cast<const double2*>(p)[1];
  o[0] = u.x; o[1] = u.y; o[2] = v.x; o[3] = v.y;
}

// Codes at the two built columns and the weight, for this thread's rows of
// the stage that starts at sequence n0; rows past n take code -1, weight 0.
template <typename T>
__device__ __forceinline__ void fetch_stage(
    const int8_t* __restrict__ codes, const T* __restrict__ w, int n, int l,
    int n0, int row0, int site_a, int site_b, int (&ca)[BUILD_ROWS],
    int (&cb)[BUILD_ROWS], T (&wv)[BUILD_ROWS]) {
#pragma unroll
  for (int s = 0; s < BUILD_ROWS; ++s) {
    const int row = n0 + row0 + ROW_STEP * s;
    if (row < n) {
      const int8_t* p = codes + static_cast<size_t>(row) * l;
      ca[s] = p[site_a];
      cb[s] = p[site_b];
      wv[s] = w[row];
    } else {
      ca[s] = -1;
      cb[s] = -1;
      wv[s] = T(0);
    }
  }
}

// Offset of a thread's sub-tile row (or column) k in 0..7 within the tile.
__device__ __forceinline__ int sub_offset(int t, int k) {
  return (k < 4 ? 0 : HALF - 4) + 4 * t + k;
}

template <typename T, bool kPartial>
__global__ void __launch_bounds__(THREADS) weighted_gram_kernel(
    const int8_t* __restrict__ codes, const T* __restrict__ w,
    T* __restrict__ out, int n, int l, int q) {
  __shared__ __align__(16) T sa[BN][TILE];
  __shared__ __align__(16) T sb[BN][TILE];

  // upper-triangle tile (ti <= tj) of linear block t = tj*(tj+1)/2 + ti
  const long long t = blockIdx.x;
  long long tj = static_cast<long long>((sqrt(8.0 * t + 1.0) - 1.0) / 2.0);
  while (tj * (tj + 1) / 2 > t) --tj;
  while ((tj + 1) * (tj + 2) / 2 <= t) ++tj;
  const int ti = static_cast<int>(t - tj * (tj + 1) / 2);
  const int r0 = ti * TILE;
  const int c0 = static_cast<int>(tj) * TILE;
  const int k = l * q;

  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;

  // build role: column bc of both operands, stage rows row0 + ROW_STEP*s
  const int bc = tid % TILE;
  const int row0 = tid / TILE;
  const int ra = r0 + bc;
  const int rb = c0 + bc;
  const int site_a = ra < k ? ra / q : 0;
  const int state_a = ra < k ? ra % q : -2;
  const int site_b = rb < k ? rb / q : 0;
  const int state_b = rb < k ? rb % q : -2;

  T acc[8][8];
  T part[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      acc[i][j] = T(0);
      part[i][j] = T(0);
    }

  int ca[BUILD_ROWS], cb[BUILD_ROWS];
  T wv[BUILD_ROWS];
  fetch_stage(codes, w, n, l, 0, row0, site_a, site_b, ca, cb, wv);

  int stage = 0;
  for (int n0 = 0; n0 < n; n0 += BN) {
#pragma unroll
    for (int s = 0; s < BUILD_ROWS; ++s) {
      sa[row0 + ROW_STEP * s][bc] = ca[s] == state_a ? wv[s] : T(0);
      sb[row0 + ROW_STEP * s][bc] = cb[s] == state_b ? T(1) : T(0);
    }
    __syncthreads();
    if (n0 + BN < n)  // the next stage's loads overlap this stage's FMAs
      fetch_stage(codes, w, n, l, n0 + BN, row0, site_a, site_b, ca, cb, wv);

#pragma unroll
    for (int nn = 0; nn < BN; ++nn) {
      T a[8], b[8];
      load4(&sa[nn][4 * ty], a);
      load4(&sa[nn][HALF + 4 * ty], a + 4);
      load4(&sb[nn][4 * tx], b);
      load4(&sb[nn][HALF + 4 * tx], b + 4);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if constexpr (kPartial) {
            part[i][j] = fma(a[i], b[j], part[i][j]);
          } else {
            acc[i][j] = fma(a[i], b[j], acc[i][j]);
          }
        }
    }
    __syncthreads();

    if constexpr (kPartial) {
      if (++stage == SUB || n0 + BN >= n) {
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            acc[i][j] += part[i][j];
            part[i][j] = T(0);
          }
        stage = 0;
      }
    }
  }

  const bool mirror = ti != tj;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = r0 + sub_offset(ty, i);
    if (r >= k) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = c0 + sub_offset(tx, j);
      if (c >= k) continue;
      out[static_cast<size_t>(r) * k + c] = acc[i][j];
      if (mirror) out[static_cast<size_t>(c) * k + r] = acc[i][j];
    }
  }
}

template <typename T, bool kPartial>
int launch(const void* codes, const void* w, void* out, int n, int l, int q,
           void* stream) {
  const long long k = static_cast<long long>(l) * q;
  if (n < 0 || k <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long tiles = (k + TILE - 1) / TILE;
  const long long blocks = tiles * (tiles + 1) / 2;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  weighted_gram_kernel<T, kPartial>
      <<<static_cast<unsigned>(blocks), THREADS, 0,
         static_cast<cudaStream_t>(stream)>>>(
          static_cast<const int8_t*>(codes), static_cast<const T*>(w),
          static_cast<T*>(out), n, l, q);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C launchers (bound with ctypes).  `codes`: int8 (n, l), states in
// [0, q); `w`: (n,) weights; `out`: (l*q, l*q), every element written.
// Run on `stream` without synchronising; return cudaGetLastError() (0 on
// success, non-zero for a refused launch or invalid sizes).
extern "C" int weighted_gram_f32(const void* codes, const void* w, void* out,
                                 int n, int l, int q, void* stream) {
  return launch<float, true>(codes, w, out, n, l, q, stream);
}

extern "C" int weighted_gram_f64(const void* codes, const void* w, void* out,
                                 int n, int l, int q, void* stream) {
  return launch<double, false>(codes, w, out, n, l, q, stream);
}
