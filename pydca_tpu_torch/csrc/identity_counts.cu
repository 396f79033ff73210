// All-pairs sequence-identity neighbour counts for sequence reweighting.
//
// Replaces pydca_tpu/ops/pallas_kernels.py::identity_counts (body
// _make_identity_codes_kernel), the TPU kernel behind
// pydca_tpu.stats.sequence_weights.  For every row i of the int8 (N, L)
// code matrix it computes
//
//     out[i] = #{ j < N : valid[j] and (float)matches(i, j) > thr }
//     matches(i, j) = #{ k < L : codes[i, k] == codes[j, k] }
//
// Row i counts itself, as in the TPU kernel and the XLA scan
// (pydca_tpu/stats.py:107-130).  The threshold is compared in float32;
// `valid` masks only the neighbour j.
//
// What bounds it on an H100 (700 W): int8 tensor-core operations.  As the
// TPU kernel does, matches(i, j) = sum_a sum_k [c_ik == a][c_jk == a] is a
// product of one-hot state planes, and it is symmetric, so the least work
// is the upper half of the (N, N) product over K = L*q:
// N(N+1)/2 * L*q * 2 operations at 1979 TOP/s (0.56 ms at N = 16384,
// L = 195, q = 21).  The bytes are the codes alone (N*L), far below that.
//
// Design (identity_tc_kernel):
//   1. Upper-triangle tiles.  A 1-D grid over the T(T+1)/2 tiles (I, J),
//      J >= I, of 128 x 128 rows (T = ceil(N / 128); block t is tile
//      J*(J+1)/2 + I, ops/cuda_kernels.py::_identity_tile_of is its twin).
//      One block of two warpgroups owns a tile; each warpgroup issues
//      wgmma m64n128k32 u8 x u8 -> s32 on its 64 rows.  Integer sums are
//      exact and order-free: the same counts in every run.
//   2. State planes built in shared memory.  The contraction runs over
//      (state a, position k): a stage is one plane a of a block of 128
//      positions, one 128-byte K-major row per sequence in the 128-byte
//      swizzle (the layout of weighted_gram.cu's bf16 operands, byte for
//      byte).  A thread loads 16 codes of 4 A rows and 4 B rows once per
//      position block (16-byte loads) and emits all q planes from them,
//      4 codes a word: x = c ^ a*0x01010101 has a zero byte where the code
//      is a; every byte of x is below 0x80 (codes < q <= 127, pad 0x7F), so
//      ~(x + 0x7F7F7F7F) & 0x80808080 is 0x80 exactly where x is 0, with
//      no carry between bytes.  A match contributes 0x80 * 0x80 = 2^14, so
//      matches = acc >> 14, exact for L < 2^17.  The one-hot never exists
//      in device memory.  On a diagonal tile A and B are the same rows:
//      built once, both descriptors on one slab.
//   3. Overlap.  Two stage buffers (A and B, 16 KiB each, 64 KiB in all):
//      the wgmmas of stage s are issued, stage s + 1 is built on the CUDA
//      cores while they run, then wait, fence.proxy.async and a barrier.
//      The next position block's codes are loaded right after the last
//      plane of the current one is built.  125 registers and 65 KiB hold
//      two blocks on an SM, so one block's barrier, prologue and epilogue
//      overlap the other's wgmmas (a third buffer, keeping one wgmma group
//      in flight across the barrier, measured no faster; PERF.md).
//   4. Epilogue.  On the s32 fragment (the f32 layout), t = float(matches)
//      > thr, compared as acc >= min_acc (the launcher says why).  Row sums
//      over the tile's valid columns j < N: a quad shuffle, one integer
//      atomicAdd per row.  Off-diagonal tiles also add column sums over the
//      valid rows i < N (byte-packed warp shuffles, then shared memory
//      across the 8 warps, one atomicAdd per column).  A diagonal tile holds
//      (i, j) and (j, i): row sums only.
//   Padding: a first pass (identity_pad_kernel) copies the codes into an
//   (npad, lpad) buffer, npad = 128 T, lpad = L rounded up to 128, with the
//   byte 0x7F (no state) in the pad; offsets are 64-bit.
//
// Left for later: packing four 32-position segments into one 128-byte row
// to cut the padding of L (195 -> 256: 24% of the stages' work is pad); a
// persistent or warp-specialised mainloop that hides a tile's prologue and
// epilogue (they weigh most at q = 5, five stages a tile); the A operand
// from registers, to cut the shared-memory traffic of the build.

#include <atomic>
#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int TILE = 128;                 // rows of a tile (A and B)
constexpr int KB = 128;                   // positions per stage: one 128-byte row
constexpr int THREADS = 256;              // two warpgroups
constexpr int SLAB = TILE * KB;           // one operand of a stage: 16 KiB
constexpr int BUF = 2 * SLAB;             // A and B of a stage
constexpr int SMEM = 2 * BUF + 1024;      // two stages + 1024-byte alignment slack
constexpr uint8_t PAD = 0x7F;             // the code of padding: no state
constexpr int SHIFT = 14;                 // a match adds 0x80 * 0x80 = 1 << 14
constexpr int MAX_LEN = (1 << 17) - 1;    // acc = matches << 14 fits in s32
constexpr int MAX_TILES_SIDE = 65535;     // T(T+1)/2 < 2^31 blocks

// upper-triangle tile (ti <= tj) of linear block t = tj*(tj+1)/2 + ti
__device__ __forceinline__ void tile_of(long long t, int& ti, int& tj) {
  long long j = static_cast<long long>((sqrt(8.0 * t + 1.0) - 1.0) / 2.0);
  while (j * (j + 1) / 2 > t) --j;
  while ((j + 1) * (j + 2) / 2 <= t) ++j;
  tj = static_cast<int>(j);
  ti = static_cast<int>(t - j * (j + 1) / 2);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void st_shared_v4(uint32_t addr, uint32_t a, uint32_t b,
                                             uint32_t c, uint32_t d) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n"
               :: "r"(addr), "r"(a), "r"(b), "r"(c), "r"(d) : "memory");
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// wgmma descriptor of a K-major operand in the 128-byte swizzle: rows of
// 128 bytes, 8-row atoms of 1024 bytes (SBO), atoms 1024-aligned.
__device__ __forceinline__ uint64_t make_desc(uint32_t saddr) {
  uint64_t d = static_cast<uint64_t>((saddr & 0x3FFFF) >> 4);
  d |= static_cast<uint64_t>(1) << 16;            // LBO: unused for swizzled K-major
  d |= static_cast<uint64_t>(1024 >> 4) << 32;    // SBO
  d |= static_cast<uint64_t>(1) << 62;            // 128-byte swizzle
  return d;
}

__device__ __forceinline__ void fence_acc(uint32_t (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// D (64 x 128, s32) += A (64 x 32, u8) * B (32 x 128, u8)
__device__ __forceinline__ void wgmma_128(uint32_t (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.u8.u8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]),
        "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(1));  // scale-d = 1: always accumulate
}

// 0x80 in each byte of a word of 4 codes that equals the state (a4 = the
// state in every byte), 0 elsewhere; see the header, point 2.
__device__ __forceinline__ uint32_t plane4(uint32_t codes, uint32_t a4) {
  return ~((codes ^ a4) + 0x7F7F7F7Fu) & 0x80808080u;
}

// 16 codes of the rows rg + 32j (j < 4) of one position block; `p` points at
// row rg's codes, `stride32` is 32 rows.
__device__ __forceinline__ void load_codes(const uint8_t* p, size_t stride32,
                                           uint4 (&c)[4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) c[j] = __ldg(reinterpret_cast<const uint4*>(p + j * stride32));
}

// Plane a4 of those 16 codes of 4 rows, into an operand slab at its
// swizzled chunk (`dst`, row rg; row rg + 32j is 4096j bytes on).
__device__ __forceinline__ void store_plane(uint32_t dst, const uint4 (&c)[4], uint32_t a4) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
    st_shared_v4(dst + j * 32 * KB, plane4(c[j].x, a4), plane4(c[j].y, a4),
                 plane4(c[j].z, a4), plane4(c[j].w, a4));
}

__global__ void __launch_bounds__(THREADS, 2) identity_tc_kernel(
    const uint8_t* __restrict__ cp, const uint8_t* __restrict__ valid,
    int32_t* __restrict__ out, int n, int lpad, int q, uint32_t min_acc) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint32_t vbits[2][TILE / 32];  // valid and < n: tile rows (0), columns (1)
  __shared__ uint32_t part[8 * 4 * 8];       // column sums: [warp][lane % 4][word]
  const uint32_t sraw = smem_u32(smem_raw);
  const uint32_t sbase = (sraw + 1023u) & ~1023u;  // swizzle atoms are 1024-aligned

  int ti, tj;
  tile_of(blockIdx.x, ti, tj);
  const bool diag = ti == tj;
  const int i0 = ti * TILE, j0 = tj * TILE;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wg = tid >> 7;                 // warpgroup: tile rows 64wg .. 64wg + 63
  const int chunk = tid & 7, rg = tid >> 3; // build role: chunk of rows rg + 32j

  const uint32_t soff = rg * KB + ((chunk ^ (rg & 7)) << 4);
  const size_t stride32 = static_cast<size_t>(32) * lpad;
  const uint8_t* pa = cp + static_cast<size_t>(i0 + rg) * lpad + 16 * chunk;
  const uint8_t* pb = cp + static_cast<size_t>(j0 + rg) * lpad + 16 * chunk;
  const uint32_t bslab = diag ? 0u : static_cast<uint32_t>(SLAB);
  const int nlb = lpad / KB, stages = nlb * q;

  uint4 ca[4], cb[4];
  if (stages > 0) {  // in flight while the masks are read
    load_codes(pa, stride32, ca);
    if (!diag) load_codes(pb, stride32, cb);
  }
  {  // warpgroup 0 masks the tile's rows, warpgroup 1 its columns
    const int r = (wg == 0 ? i0 : j0) + (tid & 127);
    const bool v = r < n && (valid == nullptr || valid[r] != 0);
    const uint32_t bits = __ballot_sync(0xffffffffu, v);
    if (lane == 0) vbits[wg][warp & 3] = bits;
  }

  uint32_t acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0u;

  int a = 0, lb = 0;  // plane and position block of the next stage to build
  // builds stage (a, lb) into `buf`, then steps (a, lb) and, after the last
  // plane of a position block, loads the next block's codes
  auto build_next = [&](uint32_t buf) {
    const uint32_t a4 = static_cast<uint32_t>(a) * 0x01010101u;
    store_plane(buf + soff, ca, a4);
    if (!diag) store_plane(buf + SLAB + soff, cb, a4);
    if (++a == q) {
      a = 0;
      if (++lb < nlb) {
        load_codes(pa + lb * KB, stride32, ca);
        if (!diag) load_codes(pb + lb * KB, stride32, cb);
      }
    }
  };

  if (stages > 0) build_next(sbase);
  fence_proxy_async();
  __syncthreads();
  for (int s = 0; s < stages; ++s) {
    const uint32_t buf = sbase + (s & 1) * BUF;
    fence_acc(acc);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < KB / 32; ++kk)
      wgmma_128(acc, make_desc(buf + wg * 64 * KB + kk * 32), make_desc(buf + bslab + kk * 32));
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    if (s + 1 < stages) build_next(sbase + ((s + 1) & 1) * BUF);  // overlaps the tensor cores
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence_acc(acc);
    fence_proxy_async();
    __syncthreads();
  }

  // epilogue: accumulator element 4i + v of lane l of warp wl in the
  // warpgroup sits at row 16wl + l/4 + 8(v/2), column 8i + 2(l%4) + v%2;
  // float(matches) > thr is acc >= min_acc (see the launcher)
  const int m = lane & 3;
  const int r0 = 64 * wg + 16 * (warp & 3) + (lane >> 2);  // rows r0, r0 + 8
  const uint32_t vr0 = (vbits[0][r0 >> 5] >> (r0 & 31)) & 1u;
  const uint32_t vr1 = (vbits[0][(r0 + 8) >> 5] >> ((r0 + 8) & 31)) & 1u;
  uint32_t rows = 0;     // row sums: row r0 in the low half, r0 + 8 in the high
  uint32_t cols[8];      // column sums over the two rows: byte 2i + b, column 8i + 2m + b
#pragma unroll
  for (int w = 0; w < 8; ++w) cols[w] = 0u;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const uint32_t vw = vbits[1][i >> 2];
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      const uint32_t vc = (vw >> ((8 * i + 2 * m + b) & 31)) & 1u;
      const uint32_t t0 = acc[4 * i + b] >= min_acc ? 1u : 0u;
      const uint32_t t1 = acc[4 * i + 2 + b] >= min_acc ? 1u : 0u;
      rows += (t0 & vc) | ((t1 & vc) << 16);
      cols[i >> 1] += ((t0 & vr0) + (t1 & vr1)) << (8 * (2 * (i & 1) + b));
    }
  }
  // a quad holds a row's 128 columns: <= 128 in each half
  rows += __shfl_xor_sync(0xffffffffu, rows, 1);
  rows += __shfl_xor_sync(0xffffffffu, rows, 2);
  if (m == 0) {
    const uint32_t lo = rows & 0xFFFFu, hi = rows >> 16;
    if (lo != 0 && i0 + r0 < n) atomicAdd(&out[i0 + r0], static_cast<int>(lo));
    if (hi != 0 && i0 + r0 + 8 < n) atomicAdd(&out[i0 + r0 + 8], static_cast<int>(hi));
  }
  if (diag) return;  // block-uniform

  // the 8 lanes of one m hold a column's 16 rows of the warp: <= 16 a byte
#pragma unroll
  for (int w = 0; w < 8; ++w) {
    cols[w] += __shfl_xor_sync(0xffffffffu, cols[w], 4);
    cols[w] += __shfl_xor_sync(0xffffffffu, cols[w], 8);
    cols[w] += __shfl_xor_sync(0xffffffffu, cols[w], 16);
  }
  if (lane < 4) {
#pragma unroll
    for (int w = 0; w < 8; ++w) part[(warp * 4 + m) * 8 + w] = cols[w];
  }
  __syncthreads();
  if (tid < TILE) {
    const int c = tid, i = c >> 3, mc = (c >> 1) & 3, b = c & 1;
    const int shift = 8 * (2 * (i & 1) + b);
    uint32_t sum = 0;
#pragma unroll
    for (int wp = 0; wp < 8; ++wp) sum += (part[(wp * 4 + mc) * 8 + (i >> 1)] >> shift) & 0xFFu;
    if (sum != 0 && j0 + c < n) atomicAdd(&out[j0 + c], static_cast<int>(sum));
  }
}

// codes (n, l) -> cp (npad, lpad), the pad byte PAD past l and past n; one
// 16-byte chunk of cp a thread, grid-stride.
__global__ void __launch_bounds__(THREADS) identity_pad_kernel(
    const uint8_t* __restrict__ codes, uint8_t* __restrict__ cp, int n, int l, int lpad,
    long long chunks) {
  const int per_row = lpad / 16;
  for (long long e = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; e < chunks;
       e += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long row = e / per_row;
    const int k0 = static_cast<int>(e % per_row) * 16;
    const uint8_t* src = codes + row * l;
    uint32_t w[4];
#pragma unroll
    for (int q4 = 0; q4 < 4; ++q4) {
      uint32_t x = 0;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int k = k0 + 4 * q4 + b;
        const uint32_t byte = (row < n && k < l) ? src[k] : PAD;
        x |= byte << (8 * b);
      }
      w[q4] = x;
    }
    reinterpret_cast<uint4*>(cp)[e] = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// identity_tc_kernel's shared memory above 48 KB, allowed once per device
cudaError_t allow_tc_smem() {
  static std::atomic<bool> done[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < 64 && done[dev].load())) return err;
  err = cudaFuncSetAttribute(identity_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SMEM);
  if (err == cudaSuccess && dev < 64) done[dev].store(true);
  return err;
}

int padded_len(int l) { return (l + KB - 1) / KB * KB; }

}  // namespace

// Bytes of the launcher's `padded` scratch: the codes as (npad, lpad), npad
// = n rounded up to the 128-row tile, lpad = l rounded up to 128 positions.
extern "C" long long identity_counts_scratch_bytes(int n, int l) {
  if (n <= 0 || l <= 0) return 0;
  return (static_cast<long long>(n) + TILE - 1) / TILE * TILE * padded_len(l);
}

// Plain C launcher (bound with ctypes).  `codes`: int8 (n, l), row-major,
// every code in [0, q) (the wrapper checks); `valid`: n bytes or null;
// `out`: n int32 zeros; `padded`: 16-byte-aligned scratch of
// identity_counts_scratch_bytes(n, l) bytes, the (npad, lpad) codes.  The
// float32 threshold comes as `min_acc`: a count m <= l < 2^17 is exact in
// float32, so float(m) > thr exactly when m >= floor(thr) + 1, i.e. when
// acc = m << 14 >= (floor(thr) + 1) << 14 (0 when every count passes,
// 0xFFFFFFFF when none does; ops/cuda_kernels.py::_identity_min_acc).
// Runs on `stream` without synchronising and returns cudaGetLastError() (0
// on success), or cudaErrorInvalidValue for sizes out of range.
extern "C" int identity_counts_launch(const void* codes, const void* valid, void* out,
                                      void* padded, int n, int l, int q, unsigned min_acc,
                                      void* stream) {
  if (n <= 0) return 0;
  const long long side = (n + TILE - 1) / TILE;
  if (l < 0 || l > MAX_LEN || q < 1 || q > 127 || side > MAX_TILES_SIDE)
    return static_cast<int>(cudaErrorInvalidValue);
  const int lpad = padded_len(l);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long chunks = identity_counts_scratch_bytes(n, l) / 16;
  if (chunks > 0) {
    const long long want = (chunks + THREADS - 1) / THREADS;
    identity_pad_kernel<<<static_cast<unsigned>(want < 65536 ? want : 65536), THREADS, 0, st>>>(
        static_cast<const uint8_t*>(codes), static_cast<uint8_t*>(padded), n, l, lpad, chunks);
  }
  cudaError_t err = allow_tc_smem();
  if (err != cudaSuccess) return static_cast<int>(err);
  identity_tc_kernel<<<static_cast<unsigned>(side * (side + 1) / 2), THREADS, SMEM, st>>>(
      static_cast<const uint8_t*>(padded), static_cast<const uint8_t*>(valid),
      static_cast<int32_t*>(out), n, lpad, q, min_acc);
  return static_cast<int>(cudaGetLastError());
}

// Largest n the launcher accepts: T = ceil(n / 128) row tiles give
// T(T+1)/2 blocks on a 1-D grid, below 2^31 (row offsets are 64-bit).
extern "C" int identity_counts_max_rows() { return MAX_TILES_SIDE * TILE; }
