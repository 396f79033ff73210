// Weighted one-hot co-occurrence (Gram) matrix of an alignment.
//
// Replaces pydca_tpu/ops/pallas_kernels.py::weighted_gram (:176, body
// _gram_kernel at :158), the counting layer of the mean-field engine
// (pydca_tpu/stats.py::weighted_gram, pydca_tpu/meanfield.py:97).  For the
// (N, L) codes with states in [0, q) and the (N,) weights it computes, with
// K = L*q, r = (i, a) = i*q + a and c = (j, b) = j*q + b,
//
//     G[r, c] = sum_n w[n] * [codes[n, i] == a] * [codes[n, j] == b]
//
// i.e. X^T diag(w) X over the one-hot X, unnormalised: the caller divides
// by Meff, as with the TPU kernel.  A first pass (transpose_codes_kernel)
// copies the int8 codes transposed, (L, npad) with npad a multiple of 64,
// so the sequences of one site are contiguous, sets a flag for codes
// outside [0, q) that the launcher reads after waiting for this pass (the
// call's one host sync; the wrapper raises on it), and splits the weights.
//
// What bounds it on an H100 (700 W): writing the output.  K^2 * 4 bytes
// (1.76 GB at N = 4096, K = 21000) take 0.53 ms at 3.35 TB/s, while the
// non-zero products, N*L*(L+1)/2 adds on the upper triangle (2.0e9), take
// 0.06 ms at 67 TFLOP/s.  This design multiplies the one-hot densely
// instead: N*K*(K+1) flop (1.8e12), three exact bf16 passes (below) of
// 5.4e12 flop against 989 TFLOP/s, 5.5 ms.  A sparse formulation that adds
// each weight into its L*(L+1)/2 elements in a fixed order is what could
// reach the output bound.
//
// Design, float32 (gram_tc_kernel):
//   1. Exact fp32 from bf16 tensor cores.  Every product is w[n] or 0.  An
//      fp32 weight splits exactly into three bf16 pieces, w = w1 + w2 + w3
//      (w1 = bf16(w), w2 = bf16(w - w1), w3 = bf16(w - w1 - w2), each
//      difference exact in fp32: 3 x 8 significand bits = 24; bf16 has
//      fp32's exponent range).  The A operand is onehot * w_k in bf16, the
//      B operand the 0/1 one-hot, so every tensor-core product is exact and
//      the sums accumulate in fp32.  The three pieces are three k-slices
//      against the same B tile; the TPU kernel does the same with
//      Precision.HIGHEST (pallas_kernels.py:170-172).  The first pass splits
//      the weights once, into bf16 pairs laid out by 8-sequence chunk
//      (ops/cuda_kernels.py::_bf16_split states the same arithmetic).
//      Tensor-core fp32 accumulation is not round-to-nearest, so each
//      64-sequence stage starts a fresh accumulator (smallest piece first)
//      and is added into a separate fp32 total on the CUDA cores: the
//      rounding of a long sum stays that of N/64 ordinary adds.
//   2. wgmma.  One block of two warpgroups owns a 128 x 128 tile on or
//      above the diagonal; each warpgroup issues m64n128k16 bf16 -> f32
//      wgmma on its 64 rows, operands in shared memory in the 128-byte
//      swizzled K-major layout (one 128-byte row = the 64 sequences of a
//      stage).  The threads write the operand tiles, then
//      fence.proxy.async.shared::cta and a barrier make the writes visible
//      to the async proxy before the next wgmma reads them.
//   3. Codes as vectors.  A thread builds 8 consecutive sequences of 4 A
//      rows and 4 B rows: one 8-byte load of codes per row, a byte-wise
//      compare in 32-bit words (pair_masks), and 16-byte shared stores.
//      The one-hot never exists in device memory.  Operands are
//      double-buffered: the next stage is built, and the one after fetched
//      into registers, while the tensor cores run the current stage.
//   4. Split-N.  When the upper triangle has few tiles (small K), the
//      sequences are cut into `splits` chunks of whole 64-sequence stages,
//      one block per (tile, chunk) (gridDim.y); each writes its partial
//      tile to a workspace and gram_reduce_kernel sums the partials in
//      chunk order.  No atomics: the result is the same in every run.  The
//      plan is ops/cuda_kernels.py::_gram_plan.
//   5. Stores.  A finished tile is staged in shared memory; the tile and
//      its mirror are then written row by row with consecutive threads on
//      consecutive addresses (K need not be a multiple of 4, so 4-byte
//      stores).  On a diagonal tile only the elements r <= c are read and
//      written to both halves, so the output is bitwise symmetric.
//   Ragged edges: rows or columns past K take the state 0xFE (matches no
//   code); sequences past N take code -1 and weight 0.  Output offsets are
//   64-bit.
//
// float64 (gram_f64_kernel): the products stay exact f64 FMAs on the CUDA
// cores (one 8 x 8 register sub-tile a thread, 16 sequences a stage), with
// the same tiles, split-N, reduction pass and symmetric stores.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "sm90_common.cuh"

namespace {

constexpr int TILE = 128;                      // output tile edge
constexpr int STAGE = 64;                      // sequences per stage (and per chunk unit)
constexpr int THREADS = 256;                   // two warpgroups
constexpr int PIECES = 3;                      // bf16 pieces of an fp32 weight
constexpr int SLAB = TILE * STAGE * 2;         // one 128 x 64 bf16 operand: 16 KB
constexpr int BUF = (PIECES + 1) * SLAB;       // A pieces + B of one stage: 64 KB
constexpr int SMEM_TC = 2 * BUF + 1024;        // two buffers + 1024-byte alignment slack
constexpr int LDT = TILE + 1;                  // row stride of a staged tile (elements)
constexpr int RROWS = 8;                       // tile rows per reduction block
constexpr int RPER = RROWS * TILE / THREADS;   // elements per reduction thread
constexpr unsigned NO_STATE = 0xFEu;           // state of rows past K

// Writes rows [i0, i0 + rows) of a finished tile (staged at `tile`, row
// stride LDT, row i0 first) to G at (r0, c0) and its mirror at (c0, r0).
// Consecutive threads take consecutive addresses in both passes.  On a
// diagonal tile only i <= j is read, so both halves hold the same values.
template <typename T>
__device__ __forceinline__ void store_symmetric(T* __restrict__ out, const T* tile,
                                                int k, int r0, int c0, bool diag,
                                                int i0, int rows) {
  for (int e = threadIdx.x; e < rows * TILE; e += blockDim.x) {
    const int i = i0 + e / TILE, j = e % TILE;  // lanes along j
    const int r = r0 + i, c = c0 + j;
    if (r < k && c < k && !(diag && i > j))
      out[static_cast<size_t>(r) * k + c] = tile[(i - i0) * LDT + j];
  }
  for (int e = threadIdx.x; e < rows * TILE; e += blockDim.x) {
    const int i = i0 + e % rows, j = e / rows;  // lanes along i
    const int r = r0 + i, c = c0 + j;
    if (r < k && c < k && !(diag && i >= j))
      out[static_cast<size_t>(c) * k + r] = tile[(i - i0) * LDT + j];
  }
}

// ------------------------------------------------------------ fp32 path

// D (64 x 128, f32) = [D +] A (64 x 16, bf16) * B (16 x 128, bf16)
__device__ __forceinline__ void wgmma_128(float (&d)[64], uint64_t da, uint64_t db,
                                          int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// A thread's share of one stage: 8 consecutive sequences of 4 A rows
// (code[0..3]) and 4 B rows (code[4..7]), and the weight pieces of those
// sequences (wp[p] = the bf16 pairs of piece p, from split_weights).
struct Fetch {
  uint2 code[8];
  uint4 wp[PIECES];
};

__device__ __forceinline__ void fetch(const int8_t* __restrict__ ct,
                                      const uint4* __restrict__ wpk, int npad, int nb,
                                      const int (&site)[8], Fetch& f) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
    f.code[j] = __ldg(reinterpret_cast<const uint2*>(
        ct + static_cast<size_t>(site[j]) * npad + nb));
#pragma unroll
  for (int p = 0; p < PIECES; ++p) f.wp[p] = __ldg(wpk + (nb / 8) * PIECES + p);
}

// bf16 pair masks of a word of codes: 0xFFFF in the lanes of sequences
// (0, 1) (`lo`) and (2, 3) (`hi`) whose code byte equals the state byte.
__device__ __forceinline__ void pair_masks(uint32_t codes, uint32_t state4, uint32_t& lo,
                                           uint32_t& hi) {
  const uint32_t x = codes ^ state4;                            // byte 0 where equal
  const uint32_t t = ((x & 0x7F7F7F7Fu) + 0x7F7F7F7Fu) | x;   // bit 7 set where not
  const uint32_t z = ~t & 0x80808080u;                         // bit 7 set where equal
  // prmt with the selector's bit 3 set replicates the selected byte's sign
  asm("prmt.b32 %0, %1, 0, 0x9988;" : "=r"(lo) : "r"(z));
  asm("prmt.b32 %0, %1, 0, 0xBBAA;" : "=r"(hi) : "r"(z));
}

// Builds the stage held in `f` into the buffer at shared address `buf`:
// slabs 0..2 the A pieces (rows r0 + rg + 32j), slab 3 the B one-hot (rows
// c0 + rg + 32j), each at 16-byte chunk `chunk` of its row, swizzled.
__device__ __forceinline__ void build(uint32_t buf, const Fetch& f,
                                      const uint32_t (&state4)[8], int rg, int chunk) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    uint32_t h0, h1, h2, h3;
    pair_masks(f.code[j].x, state4[j], h0, h1);
    pair_masks(f.code[j].y, state4[j], h2, h3);
    const int row = rg + 32 * (j & 3);
    const uint32_t off = row * 128 + ((chunk ^ (row & 7)) << 4);
    if (j < 4) {
#pragma unroll
      for (int p = 0; p < PIECES; ++p)
        st_shared_v4(buf + p * SLAB + off, h0 & f.wp[p].x, h1 & f.wp[p].y,
                     h2 & f.wp[p].z, h3 & f.wp[p].w);
    } else {
      constexpr uint32_t ONE2 = 0x3F803F80u;  // bf16 1.0 twice
      st_shared_v4(buf + PIECES * SLAB + off, h0 & ONE2, h1 & ONE2, h2 & ONE2, h3 & ONE2);
    }
  }
}

__global__ void __launch_bounds__(THREADS, 1) gram_tc_kernel(
    const int8_t* __restrict__ ct, const uint4* __restrict__ wpk,
    float* __restrict__ out, float* __restrict__ ws, int n, int npad, int l, int q,
    int chunk_len) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sraw = smem_u32(smem_raw);
  const uint32_t sbase = (sraw + 1023u) & ~1023u;  // swizzle atoms are 1024-aligned
  float* tile = reinterpret_cast<float*>(smem_raw + (sbase - sraw));

  int ti, tj;
  tile_of(blockIdx.x, ti, tj);
  const int k = l * q, r0 = ti * TILE, c0 = tj * TILE;
  const int n_begin = blockIdx.y * chunk_len;
  const int n_end = min(n, n_begin + chunk_len);
  const int stages = n_end > n_begin ? (n_end - n_begin + STAGE - 1) / STAGE : 0;

  const int tid = threadIdx.x;
  const int chunk = tid & 7;       // 8-sequence chunk of a stage
  const int rg = tid >> 3;         // rows rg + 32j
  const int wg = tid >> 7;         // warpgroup: tile rows 64wg .. 64wg + 63
  int site[8];
  uint32_t state4[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int r = (j < 4 ? r0 : c0) + rg + 32 * (j & 3);
    site[j] = r < k ? r / q : 0;
    state4[j] = (r < k ? static_cast<unsigned>(r % q) : NO_STATE) * 0x01010101u;
  }

  float acc[64], tot[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = tot[i] = 0.0f;

  if (stages > 0) {
    Fetch f;
    fetch(ct, wpk, npad, n_begin + 8 * chunk, site, f);
    build(sbase, f, state4, rg, chunk);
    if (stages > 1) fetch(ct, wpk, npad, n_begin + STAGE + 8 * chunk, site, f);
    fence_proxy_async();
    __syncthreads();
    for (int s = 0; s < stages; ++s) {
      const uint32_t buf = sbase + (s & 1) * BUF;
      fence_acc(acc);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int p = PIECES - 1; p >= 0; --p)  // smallest piece first
#pragma unroll
        for (int kk = 0; kk < STAGE / 16; ++kk)
          wgmma_128(acc, make_desc(buf + p * SLAB + wg * 64 * 128 + kk * 32),
                    make_desc(buf + PIECES * SLAB + kk * 32),
                    p != PIECES - 1 || kk != 0);
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      if (s + 1 < stages) {  // overlaps the tensor cores
        build(sbase + ((s + 1) & 1) * BUF, f, state4, rg, chunk);
        if (s + 2 < stages)
          fetch(ct, wpk, npad, n_begin + (s + 2) * STAGE + 8 * chunk, site, f);
      }
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      fence_acc(acc);
#pragma unroll
      for (int i = 0; i < 64; ++i) tot[i] += acc[i];
      fence_proxy_async();
      __syncthreads();
    }
  }

  // stage the tile: accumulator element 4i + v of lane l of warp wl in the
  // warpgroup sits at row 16wl + l/4 + 8(v/2), column 8i + 2(l%4) + v%2
  const int wl = (tid & 127) >> 5, lane = tid & 31;
  const int row = 64 * wg + 16 * wl + (lane >> 2);
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int col = 8 * i + 2 * (lane & 3);
    tile[row * LDT + col] = tot[4 * i];
    tile[row * LDT + col + 1] = tot[4 * i + 1];
    tile[(row + 8) * LDT + col] = tot[4 * i + 2];
    tile[(row + 8) * LDT + col + 1] = tot[4 * i + 3];
  }
  __syncthreads();
  if (ws != nullptr) {  // split-N: this chunk's partial tile
    float* dst = ws + (static_cast<size_t>(blockIdx.y) * gridDim.x + blockIdx.x) * TILE * TILE;
    for (int e = tid; e < TILE * TILE; e += THREADS) dst[e] = tile[(e / TILE) * LDT + e % TILE];
  } else {
    store_symmetric(out, tile, k, r0, c0, ti == tj, 0, TILE);
  }
}

// ------------------------------------------------------------ fp64 path

constexpr int F64_BN = 16;                            // sequences per stage
constexpr int F64_TX = 16;                            // threads along columns
constexpr int F64_ROWS = F64_BN * TILE / THREADS;     // stage rows one thread builds
constexpr int F64_STEP = THREADS / TILE;              // row stride of those rows

__device__ __forceinline__ void load4(const double* p, double* o) {
  const double2 u = reinterpret_cast<const double2*>(p)[0];
  const double2 v = reinterpret_cast<const double2*>(p)[1];
  o[0] = u.x; o[1] = u.y; o[2] = v.x; o[3] = v.y;
}

// Offset of a thread's sub-tile row (or column) k in 0..7 within the tile.
__device__ __forceinline__ int sub_offset(int t, int k) {
  return (k < 4 ? 0 : TILE / 2 - 4) + 4 * t + k;
}

__device__ __forceinline__ void fetch_f64(
    const int8_t* __restrict__ ct, const double* __restrict__ w, int npad, int n_end,
    int n0, int row0, int site_a, int site_b, int (&ca)[F64_ROWS], int (&cb)[F64_ROWS],
    double (&wv)[F64_ROWS]) {
#pragma unroll
  for (int s = 0; s < F64_ROWS; ++s) {
    const int row = n0 + row0 + F64_STEP * s;
    if (row < n_end) {
      ca[s] = ct[static_cast<size_t>(site_a) * npad + row];
      cb[s] = ct[static_cast<size_t>(site_b) * npad + row];
      wv[s] = w[row];
    } else {
      ca[s] = -1;
      cb[s] = -1;
      wv[s] = 0.0;
    }
  }
}

__global__ void __launch_bounds__(THREADS) gram_f64_kernel(
    const int8_t* __restrict__ ct, const double* __restrict__ w,
    double* __restrict__ out, double* __restrict__ ws, int n, int npad, int l, int q,
    int chunk_len) {
  __shared__ __align__(16) double sa[F64_BN][TILE];
  __shared__ __align__(16) double sb[F64_BN][TILE];

  int ti, tj;
  tile_of(blockIdx.x, ti, tj);
  const int k = l * q, r0 = ti * TILE, c0 = tj * TILE;
  const int n_begin = blockIdx.y * chunk_len;
  const int n_end = min(n, n_begin + chunk_len);

  const int tid = threadIdx.x;
  const int tx = tid % F64_TX, ty = tid / F64_TX;
  // build role: column bc of both operands, stage rows row0 + F64_STEP*s
  const int bc = tid % TILE, row0 = tid / TILE;
  const int ra = r0 + bc, rb = c0 + bc;
  const int site_a = ra < k ? ra / q : 0;
  const int state_a = ra < k ? ra % q : -2;
  const int site_b = rb < k ? rb / q : 0;
  const int state_b = rb < k ? rb % q : -2;

  double acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0;

  int ca[F64_ROWS], cb[F64_ROWS];
  double wv[F64_ROWS];
  fetch_f64(ct, w, npad, n_end, n_begin, row0, site_a, site_b, ca, cb, wv);
  for (int n0 = n_begin; n0 < n_end; n0 += F64_BN) {
#pragma unroll
    for (int s = 0; s < F64_ROWS; ++s) {
      sa[row0 + F64_STEP * s][bc] = ca[s] == state_a ? wv[s] : 0.0;
      sb[row0 + F64_STEP * s][bc] = cb[s] == state_b ? 1.0 : 0.0;
    }
    __syncthreads();
    if (n0 + F64_BN < n_end)  // the next stage's loads overlap this stage's FMAs
      fetch_f64(ct, w, npad, n_end, n0 + F64_BN, row0, site_a, site_b, ca, cb, wv);
#pragma unroll
    for (int nn = 0; nn < F64_BN; ++nn) {
      double a[8], b[8];
      load4(&sa[nn][4 * ty], a);
      load4(&sa[nn][TILE / 2 + 4 * ty], a + 4);
      load4(&sb[nn][4 * tx], b);
      load4(&sb[nn][TILE / 2 + 4 * tx], b + 4);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fma(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  if (ws != nullptr) {  // split-N: this chunk's partial tile
    double* dst = ws + (static_cast<size_t>(blockIdx.y) * gridDim.x + blockIdx.x) * TILE * TILE;
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        dst[sub_offset(ty, i) * TILE + sub_offset(tx, j)] = acc[i][j];
    return;
  }
  const bool diag = ti == tj;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int li = sub_offset(ty, i), r = r0 + li;
    if (r >= k) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int lj = sub_offset(tx, j), c = c0 + lj;
      if (c >= k || (diag && li > lj)) continue;
      out[static_cast<size_t>(r) * k + c] = acc[i][j];
      if (r != c) out[static_cast<size_t>(c) * k + r] = acc[i][j];
    }
  }
}

// ------------------------------------------------------------ codes

__device__ __forceinline__ uint32_t bf16_bits(__nv_bfloat16 x) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(x));
}

// The exact three-piece split of the weights of sequences i0, i0 + 1 (0
// past n): w = w1 + w2 + w3, w1 = bf16(w), w2 = bf16(w - w1), w3 = bf16(w -
// w1 - w2), each difference exact in fp32 (ops/cuda_kernels.py::_bf16_split
// is the same arithmetic).  Stored as bf16 pairs, for each 8-sequence chunk
// c: words [12c + 4p, 12c + 4p + 4) hold piece p of sequences 8c .. 8c + 7.
__device__ __forceinline__ void split_weights(const float* __restrict__ w,
                                              uint32_t* __restrict__ wpk, int n, int i0) {
  uint32_t bits[2][PIECES];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float x = i0 + h < n ? w[i0 + h] : 0.0f;
    const __nv_bfloat16 b1 = __float2bfloat16_rn(x);
    const float x1 = x - __bfloat162float(b1);
    const __nv_bfloat16 b2 = __float2bfloat16_rn(x1);
    bits[h][0] = bf16_bits(b1);
    bits[h][1] = bf16_bits(b2);
    bits[h][2] = bf16_bits(__float2bfloat16_rn(x1 - __bfloat162float(b2)));
  }
  uint32_t* dst = wpk + static_cast<size_t>(i0 / 8) * 4 * PIECES + (i0 % 8) / 2;
#pragma unroll
  for (int p = 0; p < PIECES; ++p) dst[4 * p] = bits[0][p] | (bits[1][p] << 16);
}

// codes (n, l) -> ct (l, npad) through a 64 x 64 shared tile, both sides
// coalesced; sequences past n take code -1.  Sets *bad (host memory mapped
// into the device) when the block holds a code outside [0, q).  With `wpk`,
// the blocks of the first sites also split the float32 weights of their 64
// sequences into bf16 pieces (split_weights).
__global__ void __launch_bounds__(THREADS) transpose_codes_kernel(
    const int8_t* __restrict__ codes, int8_t* __restrict__ ct, volatile int* bad,
    const float* __restrict__ w, uint32_t* __restrict__ wpk, int n, int l, int npad,
    int q) {
  __shared__ int8_t t[STAGE][STAGE + 1];
  const int n0 = blockIdx.x * STAGE, s0 = blockIdx.y * STAGE;
  bool out_of_range = false;
#pragma unroll  // all loads in flight
  for (int m = 0; m < STAGE * STAGE / THREADS; ++m) {
    const int e = threadIdx.x + m * THREADS;
    const int dn = e / STAGE, ds = e % STAGE;  // lanes along sites
    int8_t v = -1;
    if (n0 + dn < n && s0 + ds < l) {
      v = codes[static_cast<size_t>(n0 + dn) * l + s0 + ds];
      out_of_range |= v < 0 || v >= q;
    }
    t[dn][ds] = v;
  }
  if (__syncthreads_or(out_of_range) && threadIdx.x == 0) *bad = 1;
#pragma unroll
  for (int m = 0; m < STAGE * STAGE / THREADS; ++m) {
    const int e = threadIdx.x + m * THREADS;
    const int ds = e / STAGE, dn = e % STAGE;  // lanes along sequences
    if (s0 + ds < l) ct[static_cast<size_t>(s0 + ds) * npad + n0 + dn] = t[dn][ds];
  }
  if (wpk != nullptr && blockIdx.y == 0 && threadIdx.x < STAGE / 2)
    split_weights(w, wpk, n, n0 + 2 * threadIdx.x);
}

// ------------------------------------------------------------ split-N reduction

// Block (tile, strip): sums the `splits` partial tiles of rows
// [RROWS * strip, +RROWS) in chunk order, then stores them symmetrically.
template <typename T>
__global__ void __launch_bounds__(THREADS) gram_reduce_kernel(
    const T* __restrict__ ws, T* __restrict__ out, int k, int splits) {
  __shared__ T strip[RROWS * LDT];
  int ti, tj;
  tile_of(blockIdx.x, ti, tj);
  const int i0 = blockIdx.y * RROWS;
  const size_t part = static_cast<size_t>(gridDim.x) * TILE * TILE;
  const T* src = ws + static_cast<size_t>(blockIdx.x) * TILE * TILE + i0 * TILE +
                 threadIdx.x;
  T s[RPER];  // independent sums, so many loads are in flight
#pragma unroll
  for (int m = 0; m < RPER; ++m) s[m] = src[m * THREADS];
#pragma unroll 4
  for (int p = 1; p < splits; ++p)
#pragma unroll
    for (int m = 0; m < RPER; ++m) s[m] += src[p * part + m * THREADS];
#pragma unroll
  for (int m = 0; m < RPER; ++m) {
    const int e = threadIdx.x + m * THREADS;
    strip[(e / TILE) * LDT + e % TILE] = s[m];
  }
  __syncthreads();
  store_symmetric(out, strip, k, ti * TILE, tj * TILE, ti == tj, i0, RROWS);
}

// The range check's flag: pinned host memory mapped into the device (the
// same address on both sides under unified addressing), one per host
// thread (a call waits for the pass that writes it before it returns).
int* range_flag() {
  thread_local int* flag = nullptr;
  if (flag == nullptr &&
      cudaHostAlloc(&flag, sizeof(int), cudaHostAllocMapped | cudaHostAllocPortable) !=
          cudaSuccess)
    flag = nullptr;
  return flag;
}

template <typename T>
int launch(const void* codes, const void* w, void* out, void* ct, void* wpk, void* ws,
           int n, int npad, int l, int q, int splits, int chunk_len, void* stream) {
  const long long k = static_cast<long long>(l) * q;
  if (n < 0 || k <= 0 || npad % STAGE != 0 || npad < n || splits < 1 || splits > 65535 ||
      (splits > 1) != (ws != nullptr) || (sizeof(T) == 4) != (wpk != nullptr) ||
      static_cast<long long>(splits) * chunk_len < n)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long side = (k + TILE - 1) / TILE;
  const long long tiles = side * (side + 1) / 2;
  if (tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  int* flag = range_flag();
  if (flag == nullptr) return static_cast<int>(cudaErrorMemoryAllocation);
  *reinterpret_cast<volatile int*>(flag) = 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  transpose_codes_kernel<<<dim3(npad / STAGE, (l + STAGE - 1) / STAGE), THREADS, 0, st>>>(
      static_cast<const int8_t*>(codes), static_cast<int8_t*>(ct), flag,
      sizeof(T) == 4 ? static_cast<const float*>(w) : nullptr, static_cast<uint32_t*>(wpk),
      n, l, npad, q);
  // the range check's host sync: after the first pass only, so the tile
  // kernel and the reduction run while the caller goes on
  cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess) err = cudaStreamSynchronize(st);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (*reinterpret_cast<volatile int*>(flag)) return -1;
  const dim3 grid(static_cast<unsigned>(tiles), static_cast<unsigned>(splits));
  T* ws_t = static_cast<T*>(ws);
  if constexpr (sizeof(T) == 4) {
    err = allow_dynamic_smem<gram_tc_kernel, SMEM_TC>();
    if (err != cudaSuccess) return static_cast<int>(err);
    gram_tc_kernel<<<grid, THREADS, SMEM_TC, st>>>(
        static_cast<const int8_t*>(ct), static_cast<const uint4*>(wpk),
        static_cast<float*>(out), ws_t, n, npad, l, q, chunk_len);
  } else {
    gram_f64_kernel<<<grid, THREADS, 0, st>>>(
        static_cast<const int8_t*>(ct), static_cast<const double*>(w),
        static_cast<double*>(out), ws_t, n, npad, l, q, chunk_len);
  }
  if (splits > 1)
    gram_reduce_kernel<T><<<dim3(static_cast<unsigned>(tiles), TILE / RROWS), THREADS, 0, st>>>(
        ws_t, static_cast<T*>(out), static_cast<int>(k), splits);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C launchers (bound with ctypes).  `codes`: int8 (n, l), row-major;
// `w`: (n,) weights; `out`: (l*q, l*q), every element written.  Scratch
// from the caller: `ct` (l, npad) bytes for the transposed codes (npad a
// multiple of 64, >= n), for float32 `wpk` (npad * 6 bytes, 16-aligned)
// for the weight pieces (null for float64), and, with splits > 1, `ws`, splits *
// tiles * 128^2 elements (tiles = the upper-triangle tile count; else
// null): `splits` chunks of `chunk_len` sequences (a multiple of 64) run as
// their own blocks and a second kernel sums their partial tiles.  Runs on
// `stream`; waits for the first pass to read the range check, and returns
// with the rest enqueued.  Returns 0, -1 when a code lies outside [0, q)
// (nothing past the first pass is launched then), or a non-zero CUDA error
// for a refused launch or invalid sizes.
extern "C" int weighted_gram_f32(const void* codes, const void* w, void* out, void* ct,
                                 void* wpk, void* ws, int n, int npad, int l, int q,
                                 int splits, int chunk_len, void* stream) {
  return launch<float>(codes, w, out, ct, wpk, ws, n, npad, l, q, splits, chunk_len, stream);
}

extern "C" int weighted_gram_f64(const void* codes, const void* w, void* out, void* ct,
                                 void* wpk, void* ws, int n, int npad, int l, int q,
                                 int splits, int chunk_len, void* stream) {
  return launch<double>(codes, w, out, ct, wpk, ws, n, npad, l, q, splits, chunk_len,
                        stream);
}
