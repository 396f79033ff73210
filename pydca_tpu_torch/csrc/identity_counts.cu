// All-pairs sequence-identity neighbour counts for sequence reweighting.
//
// Replaces pydca_tpu/ops/pallas_kernels.py::identity_counts (body
// _make_identity_codes_kernel), the TPU kernel behind
// pydca_tpu.stats.sequence_weights.  For every row i of the int8 (N, L)
// code matrix it computes
//
//     out[i] = #{ j : valid[j] and (float)matches(i, j) > thr }
//     matches(i, j) = #{ k < L : codes[i, k] == codes[j, k] }
//
// Row i counts itself, as in the TPU kernel and the XLA scan
// (pydca_tpu/stats.py:107-130).  The threshold is compared in float32.
//
// What bounds it on an H100: integer compare throughput.  The work is
// N^2 * L byte compares (4 per __vcmpeq4) and the only memory traffic is
// the int8 codes, read once per (BI, BJ) tile pair, so it is far above the
// card's bytes-per-op line.  Neither the (N, L*q) one-hot nor the (N, N)
// count matrix exists in memory: counts live in registers and only the
// thresholded row sums leave the block.
//
// Design (simple and exact, first version):
//   - a 2-D grid of (BI, BJ) = (64, 64) row tiles; both tiles' codes are
//     staged in shared memory in chunks of 64 positions along L, packed 4
//     codes per 32-bit word;
//   - each of the 256 threads owns a 4 x 4 register tile of (i, j) counts;
//     __vcmpeq4 compares 4 codes at once, and the per-byte match flags
//     are summed in byte lanes (<= 16 per lane per chunk, no carries) and
//     folded into int32 counts once per chunk.  Every count is exact;
//   - padding never matches: positions past L and rows past N take the
//     byte 0xFF (-1) in the i tile and 0xFE (-2) in the j tile, and the
//     wrapper guarantees real codes lie in [0, q);
//   - the epilogue applies the float32 threshold and the valid mask,
//     reduces each row over the 16 threads that share it with warp
//     shuffles, and performs one integer atomicAdd per row and tile.
//     Integer atomics give the same sum in any order: deterministic.
//
// Later work: an int8 tensor-core (mma / wgmma) formulation on one-hot
// planes built in registers, and using the symmetry of matches(i, j).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int BI = 64;        // rows of the i tile
constexpr int BJ = 64;        // rows of the j tile
constexpr int KW = 16;        // 32-bit words per row per chunk (64 codes)
constexpr int TX = 16;        // threads along j
constexpr int TY = 16;        // threads along i
constexpr int THREADS = TX * TY;
constexpr int RI = BI / TY;   // i rows per thread
constexpr int RJ = BJ / TX;   // j rows per thread

// Pack codes[row, k0 .. k0+3] into one little-endian word; bytes past the
// row's end (k >= l) or past the last row (row >= n) take `pad`.
__device__ __forceinline__ uint32_t load_word(
    const int8_t* __restrict__ codes, int row, int n, int l, int k0,
    uint32_t pad) {
  uint32_t w = 0;
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    const int k = k0 + b;
    const uint32_t byte =
        (row < n && k < l)
            ? static_cast<uint32_t>(static_cast<uint8_t>(
                  codes[static_cast<size_t>(row) * l + k]))
            : pad;
    w |= byte << (8 * b);
  }
  return w;
}

__global__ void __launch_bounds__(THREADS) identity_counts_kernel(
    const int8_t* __restrict__ codes, const uint8_t* __restrict__ valid,
    int32_t* __restrict__ out, int n, int l, float thr) {
  // +1 word of padding per row keeps the j-tile reads conflict-free
  __shared__ uint32_t si[BI][KW + 1];
  __shared__ uint32_t sj[BJ][KW + 1];

  const int i0 = blockIdx.y * BI;
  const int j0 = blockIdx.x * BJ;
  const int tx = threadIdx.x % TX;
  const int ty = threadIdx.x / TX;

  int cnt[RI][RJ];
#pragma unroll
  for (int r = 0; r < RI; ++r)
#pragma unroll
    for (int c = 0; c < RJ; ++c) cnt[r][c] = 0;

  for (int k0 = 0; k0 < l; k0 += 4 * KW) {
    for (int idx = threadIdx.x; idx < BI * KW; idx += THREADS) {
      const int r = idx / KW;
      const int w = idx % KW;
      si[r][w] = load_word(codes, i0 + r, n, l, k0 + 4 * w, 0xFFu);
      sj[r][w] = load_word(codes, j0 + r, n, l, k0 + 4 * w, 0xFEu);
    }
    __syncthreads();

    // byte-lane match counters: each lane gains at most 1 per word, so
    // at most KW = 16 per chunk and never carries into its neighbour
    uint32_t acc[RI][RJ];
#pragma unroll
    for (int r = 0; r < RI; ++r)
#pragma unroll
      for (int c = 0; c < RJ; ++c) acc[r][c] = 0u;

#pragma unroll
    for (int w = 0; w < KW; ++w) {
      uint32_t a[RI], b[RJ];
#pragma unroll
      for (int r = 0; r < RI; ++r) a[r] = si[ty + TY * r][w];
#pragma unroll
      for (int c = 0; c < RJ; ++c) b[c] = sj[tx + TX * c][w];
#pragma unroll
      for (int r = 0; r < RI; ++r)
#pragma unroll
        for (int c = 0; c < RJ; ++c)
          acc[r][c] += __vcmpeq4(a[r], b[c]) & 0x01010101u;
    }
    // sum the four byte lanes into the top byte (<= 64: no overflow)
#pragma unroll
    for (int r = 0; r < RI; ++r)
#pragma unroll
      for (int c = 0; c < RJ; ++c)
        cnt[r][c] += static_cast<int>((acc[r][c] * 0x01010101u) >> 24);
    __syncthreads();
  }

  // epilogue: threshold + valid mask, row sum over the tile, one atomic
  // per row.  Threads tx = 0..15 of one ty are one half-warp, so xor
  // shuffles with offsets < 16 stay within the row's threads.
#pragma unroll
  for (int r = 0; r < RI; ++r) {
    const int i = i0 + ty + TY * r;
    int part = 0;
#pragma unroll
    for (int c = 0; c < RJ; ++c) {
      const int j = j0 + tx + TX * c;
      const bool ok = j < n && (valid == nullptr || valid[j] != 0);
      part += (ok && static_cast<float>(cnt[r][c]) > thr) ? 1 : 0;
    }
#pragma unroll
    for (int off = TX / 2; off > 0; off >>= 1)
      part += __shfl_xor_sync(0xffffffffu, part, off);
    if (tx == 0 && i < n && part != 0) atomicAdd(&out[i], part);
  }
}

}  // namespace

// Plain C launcher (bound with ctypes).  `out` must hold n zeros; `valid`
// may be null.  Runs on `stream` without synchronising and returns
// cudaGetLastError() (0 on success).
extern "C" int identity_counts_launch(const void* codes, const void* valid,
                                      void* out, int n, int l, float thr,
                                      void* stream) {
  if (n <= 0) return 0;
  const int tiles_i = (n + BI - 1) / BI;
  const int tiles_j = (n + BJ - 1) / BJ;
  const dim3 grid(tiles_j, tiles_i);
  identity_counts_kernel<<<grid, THREADS, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(codes), static_cast<const uint8_t*>(valid),
      static_cast<int32_t*>(out), n, l, thr);
  return static_cast<int>(cudaGetLastError());
}

// Largest n the launcher accepts: the i tiles ride on gridDim.y (<= 65535).
extern "C" int identity_counts_max_rows() { return 65535 * BI; }
