// The elementwise passes of the fused plmDCA L-BFGS step over the (N, q, L)
// logits, each one pass over device memory.
//
// Replaces no TPU kernel: on the TPU, XLA fuses these passes of
// pydca_tpu/plm.py (_phi_dphi, _ct_gh and the in-place updates of
// _plm_fused_steps) by itself, while PyTorch runs each operation of the
// same composition as a kernel of its own, with an (N, q, L) temporary
// between each two: about 43 passes over 268 MB arrays an iteration at
// N = 16384, L = 195, q = 21.  The plain composition is in
// ops/cuda_kernels.py (plm_trial_reference, plm_update_grad_reference).
//
// Shapes: logits, u and ct are float32 (N, q, L), element (n, a, i) at
// (n*q + a)*L + i; picked is float32 (N, L); dh is the field part of the
// search direction, float32 (L, q), dh[i*q + a]; codes are uint8 (N, L), the
// observed state of each site, a code >= q picking no state (its one-hot
// row is zero, as the pick mask of an out-of-range code is); w is the
// (N,) float32 sequence weights.  u' = u + dh is the direction's image in
// logits space (u, the forward product, carries no fields).
//
// plm_trial_kernel: one line-search trial at step alpha,
//     t = logits + alpha*u',  lse = logsumexp_a t,  pk = picked + alpha*u'[c],
//     out = [ sum_n,i w_n (lse - pk),  sum_n,i w_n (E_softmax(t)[u'] - u'[c]) ].
// plm_update_grad_kernel: the step's update and the gradient's cotangent,
//     logits += alpha*u',  picked += alpha*u'[c]   (with u; in place),
//     ct = w_n (softmax_a(logits) - onehot(c)),  gh[a, i] = sum_n ct[n, a, i].
//
// What bounds them on an H100 (700 W): bytes.  A trial reads the logits and
// u (2 passes, 0.55 GB at 16384 x 195, q 21: 0.164 ms at 3.35 TB/s); the
// update and cotangent read the logits and u and write the logits and ct
// (4 passes, 1.09 GB: 0.325 ms).  Their q exponentials a site are far below
// the card's arithmetic rate.
//
// Design:
//   1. One thread per (n, i), a block per (column chunk of up to 256
//      consecutive sites, ROWS consecutive sequences).  A thread walks its
//      ROWS rows; for each it takes the site's q logits (and q values of u),
//      strided by L, so a warp's accesses to one state are consecutive
//      addresses.  A row's loads are all in flight before its arithmetic
//      and its stores, so a thread has 2q loads in flight: the kernels are
//      built for the two alphabets' q, 21 and 5, with loops of fixed length
//      (no other q is launched).  The q values stay in registers, indexed
//      only by unrolled loop counters;
//      the observed state's value is picked by compare-and-select, not by
//      an index.  The field direction of the thread's site and, in the
//      update, its column sums live in shared memory, out of the registers.
//   2. The update's row in shared memory.  A state's row segment is L
//      floats, so at L = 195 a warp's 128 bytes straddle two lines; such
//      stores doubled the pass's time (0.67 ms at L = 195 against 0.41 ms
//      at L = 192, where every segment starts a line).  Where one block
//      covers the whole row (L <= 256), the q*L logits and u of row r + 1
//      are copied into shared memory (cp.async, 4 bytes a thread, the warps
//      aligned to the 128-byte line of the row's first element) while row r
//      is computed there in place, and row r then leaves for the logits and
//      ct in whole lines (0.53 ms at L = 195).  Two blocks an SM
//      (__launch_bounds__) hold one block's copies in flight while the
//      other computes.  Wider rows take the direct path.  The trial only
//      loads, and loads straddling lines cost it 5%: it reads directly.
//   3. The arithmetic is the plain composition's, operation for operation
//      and in float32: accurate expf and logf, the division by the softmax
//      sum, the products and sums rounded where the composition rounds them
//      (__fmul_rn / __fadd_rn keep the compiler from fusing them), and the
//      in-place `x += alpha*y` of the update as the fused multiply-add that
//      the library's add kernel computes.  The sum over the q states runs in
//      state order.
//   4. Deterministic sums, no float atomics.  The trial's per-thread sums
//      run over its rows in four interleaved chains (the library's sum
//      keeps chains as short; one chain of 32 rows had 1.4x its rounding
//      error against float64), a block sums them in a fixed tree (warp
//      shuffles, then the warps' sums), writes its two partials, and the
//      last block to finish (an integer ticket) sums the partials in a fixed
//      order in float32 and resets the ticket: one launch a trial.  The
//      cotangent's column sums gh go the same way per block into a partial
//      slab (blocks along N, q, L); plm_gh_reduce_kernel then sums each of
//      the q*L columns over the blocks with one warp, each lane in block
//      order and the lanes in a fixed shuffle tree.  Two launches on the
//      same inputs agree to the bit.
// Row offsets are 64-bit.

#include <cmath>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include "sm90_common.cuh"

namespace {

constexpr int ROWS = 32;        // sequences a block walks
constexpr int MAX_COLS = 256;   // sites a block covers (its threads)
constexpr int MAX_WARPS = MAX_COLS / 32;
constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_Q = 21;
constexpr int GRAD_SMEM = 6 * MAX_Q * MAX_COLS * sizeof(float);  // the most, at q = 21

int col_threads(int l) {
  const int c = (l + 31) / 32 * 32;
  return c < MAX_COLS ? c : MAX_COLS;
}

// torch's max: a NaN wins
__device__ __forceinline__ float nan_max(float m, float x) {
  return (x > m || x != x) ? x : m;
}

// Sums a and b over the block (blockDim.x a multiple of 32, at most 256) in
// a fixed tree; thread 0 gets the totals.  sm holds 2 * MAX_WARPS floats.
__device__ __forceinline__ void block_sum2(float& a, float& b, float* sm) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    a = __fadd_rn(a, __shfl_xor_sync(FULL, a, o));
    b = __fadd_rn(b, __shfl_xor_sync(FULL, b, o));
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nw = blockDim.x >> 5;
  if (lane == 0) {
    sm[warp] = a;
    sm[MAX_WARPS + warp] = b;
  }
  __syncthreads();
  if (warp == 0) {
    a = lane < nw ? sm[lane] : 0.f;
    b = lane < nw ? sm[MAX_WARPS + lane] : 0.f;
#pragma unroll
    for (int o = MAX_WARPS / 2; o > 0; o >>= 1) {
      a = __fadd_rn(a, __shfl_xor_sync(FULL, a, o));
      b = __fadd_rn(b, __shfl_xor_sync(FULL, b, o));
    }
  }
  __syncthreads();  // sm may be written again
}

// Q: the kernels are built for q == Q, and every loop over the states has a
// fixed length.
template <int Q>
__global__ void __launch_bounds__(MAX_COLS) plm_trial_kernel(
    const float* __restrict__ logits, const float* __restrict__ picked,
    const float* __restrict__ u, const float* __restrict__ dh,
    const uint8_t* __restrict__ codes, const float* __restrict__ w, int n, int l,
    float alpha, float* __restrict__ partial, unsigned* __restrict__ ticket,
    float* __restrict__ out) {
  constexpr int q = Q;
  __shared__ float sm[2 * MAX_WARPS];
  __shared__ bool last;
  extern __shared__ float dyn[];  // the thread's dh: dyn[a * blockDim.x + threadIdx.x]
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int n0 = blockIdx.y * ROWS;
  const int n1 = min(n0 + ROWS, n);
  // four interleaved accumulators a thread, combined in a fixed tree: short
  // sequential chains, as the library's sum takes them, so that the
  // objective carries the plain composition's rounding and no more
  float acc_f[4] = {0.f, 0.f, 0.f, 0.f}, acc_d[4] = {0.f, 0.f, 0.f, 0.f};
  if (i < l) {
    float* dhi = dyn + threadIdx.x;
    for (int a = 0; a < q; ++a) dhi[a * blockDim.x] = dh[static_cast<long long>(i) * q + a];
    const long long ql = static_cast<long long>(q) * l;
    for (int r = n0; r < n1; ++r) {
      const float* lr = logits + r * ql + i;
      const float* ur = u + r * ql + i;
      const long long ri = static_cast<long long>(r) * l + i;
      float lv[Q], up[Q];
#pragma unroll
      for (int a = 0; a < Q; ++a) {
        lv[a] = lr[a * l];
        up[a] = ur[a * l];
      }
      const int c = codes[ri];
      const float pk0 = picked[ri], wr = w[r];
      float mx = -INFINITY, upc = 0.f;
#pragma unroll
      for (int a = 0; a < Q; ++a) {
        up[a] = __fadd_rn(up[a], dhi[a * blockDim.x]);
        lv[a] = __fadd_rn(lv[a], __fmul_rn(alpha, up[a]));
        mx = nan_max(mx, lv[a]);
        upc = a == c ? up[a] : upc;
      }
      float se = 0.f;
#pragma unroll
      for (int a = 0; a < Q; ++a) {
        lv[a] = expf(__fsub_rn(lv[a], mx));
        se = __fadd_rn(se, lv[a]);
      }
      float su = 0.f;
#pragma unroll
      for (int a = 0; a < Q; ++a) su = __fadd_rn(su, __fmul_rn(lv[a], up[a]));
      const float lse = __fadd_rn(mx, logf(se));
      const float pk = __fadd_rn(pk0, __fmul_rn(alpha, upc));
      const float tf = __fmul_rn(wr, __fsub_rn(lse, pk));
      const float td = __fmul_rn(wr, __fsub_rn(__fdiv_rn(su, se), upc));
#pragma unroll
      for (int k = 0; k < 4; ++k) {  // row r into chain (r - n0) mod 4, in registers
        acc_f[k] = k == ((r - n0) & 3) ? __fadd_rn(acc_f[k], tf) : acc_f[k];
        acc_d[k] = k == ((r - n0) & 3) ? __fadd_rn(acc_d[k], td) : acc_d[k];
      }
    }
  }
  float tot_f = __fadd_rn(__fadd_rn(acc_f[0], acc_f[1]), __fadd_rn(acc_f[2], acc_f[3]));
  float tot_d = __fadd_rn(__fadd_rn(acc_d[0], acc_d[1]), __fadd_rn(acc_d[2], acc_d[3]));
  block_sum2(tot_f, tot_d, sm);
  const unsigned nblocks = gridDim.x * gridDim.y;
  const unsigned b = blockIdx.y * gridDim.x + blockIdx.x;
  if (threadIdx.x == 0) {
    partial[2 * b] = tot_f;
    partial[2 * b + 1] = tot_d;
    __threadfence();
    last = atomicAdd(ticket, 1u) == nblocks - 1;
  }
  __syncthreads();
  if (!last) return;
  // the last block: every partial is written; sum them in block order
  float f = 0.f, d = 0.f;
  for (unsigned k = threadIdx.x; k < nblocks; k += blockDim.x) {
    f = __fadd_rn(f, __ldcg(partial + 2 * k));
    d = __fadd_rn(d, __ldcg(partial + 2 * k + 1));
  }
  block_sum2(f, d, sm);
  if (threadIdx.x == 0) {
    out[0] = f;
    out[1] = d;
    *ticket = 0;  // ready for the next launch on this stream
  }
}

// One site (n, i) of the update and cotangent: the q logits (and q values
// of u) at src_l[a * stride] (src_u[a * stride]), all loaded before any
// store; the new logits to dst_l[a * stride], ct to dst_c[a * stride], each
// ct added to g[a * bd]; picked[0] moved in place.
template <int Q, bool HAS_U>
__device__ __forceinline__ void update_site(const float* src_l, const float* src_u, float* dst_l,
                                            float* dst_c, int stride, int c, float wr,
                                            float alpha, const float* dhi, float* g, int bd,
                                            float* picked) {
  float x[Q], up[Q];
#pragma unroll
  for (int a = 0; a < Q; ++a) {
    x[a] = src_l[a * stride];
    if (HAS_U) up[a] = src_u[a * stride];
  }
  const float pk0 = HAS_U ? *picked : 0.f;
  float mx = -INFINITY, upc = 0.f;
#pragma unroll
  for (int a = 0; a < Q; ++a) {
    if (HAS_U) {
      up[a] = __fadd_rn(up[a], dhi[a * bd]);
      x[a] = fmaf(alpha, up[a], x[a]);
      dst_l[a * stride] = x[a];
      upc = a == c ? up[a] : upc;
    }
    mx = nan_max(mx, x[a]);
  }
  if (HAS_U) *picked = fmaf(alpha, upc, pk0);
  float se = 0.f;
#pragma unroll
  for (int a = 0; a < Q; ++a) {
    x[a] = expf(__fsub_rn(x[a], mx));
    se = __fadd_rn(se, x[a]);
  }
#pragma unroll
  for (int a = 0; a < Q; ++a) {
    const float v = __fmul_rn(__fsub_rn(__fdiv_rn(x[a], se), a == c ? 1.f : 0.f), wr);
    dst_c[a * stride] = v;
    g[a * bd] = __fadd_rn(g[a * bd], v);
  }
}

template <int Q, bool HAS_U>
__global__ void __launch_bounds__(MAX_COLS, 2) plm_update_grad_kernel(
    float* __restrict__ logits, float* __restrict__ picked, const float* __restrict__ u,
    const float* __restrict__ dh, const uint8_t* __restrict__ codes,
    const float* __restrict__ w, int n, int l, float alpha, float* __restrict__ ct,
    float* __restrict__ gh_part) {
  constexpr int q = Q;
  // dyn: the thread's dh, dyn[a * bd + t], and its column sums,
  // dyn[(q + a) * bd + t], out of the registers; when the block covers whole
  // rows (staged), then two row buffers of 2 q*l floats: a row's logits and
  // u, overwritten in place by its new logits and ct
  extern __shared__ float dyn[];
  const int bd = blockDim.x;
  const int i = blockIdx.x * bd + threadIdx.x;
  const bool active = i < l;
  const int n0 = blockIdx.y * ROWS;
  const int n1 = min(n0 + ROWS, n);
  float* dhi = dyn + threadIdx.x;
  float* g = dyn + q * bd + threadIdx.x;
  if (active) {
    for (int a = 0; a < q; ++a) {
      if (HAS_U) dhi[a * bd] = dh[static_cast<long long>(i) * q + a];
      g[a * bd] = 0.f;
    }
  }
  const long long ql = static_cast<long long>(q) * l;
  if (gridDim.x > 1) {
    // a block across part of the row (l > MAX_COLS): straight from and to
    // device memory
    if (active) {
      for (int r = n0; r < n1; ++r) {
        const long long ri = static_cast<long long>(r) * l + i;
        float* lr = logits + r * ql + i;
        update_site<Q, HAS_U>(lr, u + r * ql + i, lr, ct + r * ql + i, l, codes[ri], w[r],
                              alpha, dhi, g, bd, picked + ri);
      }
    }
  } else {
    // whole rows: row r + 1 is copied into shared memory (cp.async, 4 bytes a
    // thread, from the 128-byte line that holds the row's first element, so a
    // warp's copies are whole lines) while row r is computed there; row r
    // then leaves in whole lines too.
    float* buf = dyn + 2 * q * bd;
    auto fetch = [&](int r, float* dst) {
      const long long base = r * ql;
#pragma unroll 4
      for (long long e = (base & ~31LL) + threadIdx.x; e < base + ql; e += bd) {
        if (e < base) continue;
        __pipeline_memcpy_async(dst + (e - base), logits + e, sizeof(float));
        if (HAS_U) __pipeline_memcpy_async(dst + ql + (e - base), u + e, sizeof(float));
      }
      __pipeline_commit();
    };
    fetch(n0, buf);
    for (int r = n0; r < n1; ++r) {
      float* cur = buf + ((r - n0) & 1) * 2 * ql;
      __pipeline_wait_prior(0);
      // row r is in; every thread is done with row r - 1's buffer
      __syncthreads();
      if (r + 1 < n1) fetch(r + 1, buf + ((r + 1 - n0) & 1) * 2 * ql);
      if (active) {
        const long long ri = static_cast<long long>(r) * l + i;
        update_site<Q, HAS_U>(cur + i, cur + ql + i, cur + i, cur + ql + i, l, codes[ri],
                              w[r], alpha, dhi, g, bd, picked + ri);
      }
      __syncthreads();
      const long long base = r * ql;
#pragma unroll 4
      for (long long e = (base & ~31LL) + threadIdx.x; e < base + ql; e += bd) {
        if (e < base) continue;
        if (HAS_U) logits[e] = cur[e - base];
        ct[e] = cur[ql + e - base];
      }
    }
  }
  if (active) {
    float* gp = gh_part + static_cast<long long>(blockIdx.y) * ql + i;
    for (int a = 0; a < q; ++a) gp[a * l] = g[a * bd];
  }
}

// gh[o] = sum over the `parts` slabs of part[., o], o < outs: one warp a
// column, each lane over the slabs lane, lane + 32, ... in order, then a
// fixed shuffle tree.
__global__ void __launch_bounds__(256) plm_gh_reduce_kernel(const float* __restrict__ part,
                                                            int parts, int outs,
                                                            float* __restrict__ gh) {
  const long long o = (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  if (o >= outs) return;  // whole warps leave together
  const int lane = threadIdx.x & 31;
  float s = 0.f;
  for (int b = lane; b < parts; b += 32) s = __fadd_rn(s, part[static_cast<long long>(b) * outs + o]);
#pragma unroll
  for (int k = 16; k > 0; k >>= 1) s = __fadd_rn(s, __shfl_xor_sync(FULL, s, k));
  if (lane == 0) gh[o] = s;
}

template <int Q>
cudaError_t launch_trial(dim3 grid, int threads, cudaStream_t st, const float* logits,
                  const float* picked, const float* u, const float* dh, const uint8_t* codes,
                  const float* w, int n, int l, float alpha, float* partial,
                  unsigned* ticket, float* out) {
  plm_trial_kernel<Q><<<grid, threads, Q * threads * sizeof(float), st>>>(
      logits, picked, u, dh, codes, w, n, l, alpha, partial, ticket, out);
  return cudaSuccess;
}

template <int Q>
cudaError_t launch_grad(dim3 grid, int threads, cudaStream_t st, float* logits, float* picked,
                 const float* u, const float* dh, const uint8_t* codes, const float* w, int n,
                 int l, float alpha, float* ct, float* gh_part) {
  // dh and the column sums; with one block across the row, its two buffers
  const size_t smem = (2 * Q * threads + (grid.x == 1 ? 4 * Q * l : 0)) * sizeof(float);
  cudaError_t err = u != nullptr ? allow_dynamic_smem<plm_update_grad_kernel<Q, true>, GRAD_SMEM>()
                                 : allow_dynamic_smem<plm_update_grad_kernel<Q, false>, GRAD_SMEM>();
  if (err != cudaSuccess) return err;
  if (u != nullptr)
    plm_update_grad_kernel<Q, true><<<grid, threads, smem, st>>>(
        logits, picked, u, dh, codes, w, n, l, alpha, ct, gh_part);
  else
    plm_update_grad_kernel<Q, false><<<grid, threads, smem, st>>>(
        logits, picked, u, dh, codes, w, n, l, alpha, ct, gh_part);
  return cudaSuccess;
}

bool sizes_ok(int n, int q, int l) {
  return n > 0 && l > 0 && (q == 5 || q == 21) && (n + ROWS - 1) / ROWS <= 65535;
}

dim3 grid_of(int n, int l) {
  const int threads = col_threads(l);
  return dim3((l + threads - 1) / threads, (n + ROWS - 1) / ROWS);
}

}  // namespace

// Blocks of either pass at (n, l): the trial's `partial` scratch holds 2 floats a
// block.
extern "C" long long plm_passes_blocks(int n, int l) {
  if (n <= 0 || l <= 0) return 0;
  const dim3 g = grid_of(n, l);
  return static_cast<long long>(g.x) * g.y;
}

// Slabs of the gradient's `gh_part` scratch at n (each q*l floats).
extern "C" int plm_passes_row_blocks(int n) { return n <= 0 ? 0 : (n + ROWS - 1) / ROWS; }

// Plain C launchers (bound with ctypes); shapes and layouts in the header.
// Both run on `stream` without synchronising and return cudaGetLastError()
// (0 on success), or cudaErrorInvalidValue for n or l < 1, q other than 5
// and 21, or more than 65535 row blocks.
//
// plm_trial_launch: `out` receives the two float32 sums; `partial` is
// scratch of 2 * plm_passes_blocks(n, l) floats; `ticket` one unsigned that
// is 0 before the launch and is 0 again after it (launches that share a
// ticket must run in order, as on one stream).
extern "C" int plm_trial_launch(const void* logits, const void* picked, const void* u,
                                const void* dh, const void* codes, const void* w, int n, int q,
                                int l, float alpha, void* partial, void* ticket, void* out,
                                void* stream) {
  if (!sizes_ok(n, q, l)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid = grid_of(n, l);
  const int threads = col_threads(l);
  auto args = [&](auto launch) {
    return launch(grid, threads, st, static_cast<const float*>(logits),
           static_cast<const float*>(picked), static_cast<const float*>(u),
           static_cast<const float*>(dh), static_cast<const uint8_t*>(codes),
           static_cast<const float*>(w), n, l, alpha, static_cast<float*>(partial),
           static_cast<unsigned*>(ticket), static_cast<float*>(out));
  };
  const cudaError_t err = q == 21 ? args(launch_trial<21>) : args(launch_trial<5>);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

// plm_update_grad_launch: with `u` (and `dh`), logits and picked are
// updated in place by alpha*u'; without (null), they are only read and
// `picked` may be null.  Writes `ct` (n, q, l) and `gh` (q, l); `gh_part`
// is scratch of plm_passes_row_blocks(n) * q * l floats.
extern "C" int plm_update_grad_launch(void* logits, void* picked, const void* u,
                                      const void* dh, const void* codes, const void* w, int n,
                                      int q, int l, float alpha, void* ct, void* gh_part,
                                      void* gh, void* stream) {
  if (!sizes_ok(n, q, l)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid = grid_of(n, l);
  const int threads = col_threads(l);
  auto args = [&](auto launch) {
    return launch(grid, threads, st, static_cast<float*>(logits), static_cast<float*>(picked),
           static_cast<const float*>(u), static_cast<const float*>(dh),
           static_cast<const uint8_t*>(codes), static_cast<const float*>(w), n, l, alpha,
           static_cast<float*>(ct), static_cast<float*>(gh_part));
  };
  cudaError_t err = q == 21 ? args(launch_grad<21>) : args(launch_grad<5>);
  if (err == cudaSuccess) err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int outs = q * l;
  const long long threads_r = static_cast<long long>(outs) * 32;
  plm_gh_reduce_kernel<<<static_cast<unsigned>((threads_r + 255) / 256), 256, 0, st>>>(
      static_cast<const float*>(gh_part), static_cast<int>(grid.y), outs,
      static_cast<float*>(gh));
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// The fused step's L-BFGS algebra beside the history (plm._plm_fused_step).
//
// The history Z = [S; Y] is (2m, D) rows, float32 or bfloat16 (a resumed
// file that holds them; S in rows 0..m-1, Y in m..2m-1; step k writes slot
// k mod m); its float32 Gram zzt = Z Z^T (2m x 2m, row-major) and
// projections zg = Z g (2m) stay on the card beside it, so that the host
// decides nothing between a gradient and the next step's first trial.  As
// torch operations this algebra is some 130 launches of a few elements a
// step and four passes over the D-vectors where a device scalar rides along
// (0.25 ms of the card a step at m = 5, D = 8.3 M on an H100); here it is
// two launches of one thread and two plain passes.  The plain compositions
// are ops/cuda_kernels.py's lbfgs_coeffs_reference and
// lbfgs_history_reference.  The arithmetic is theirs, in float32.
//
// plm_lbfgs_coeffs_kernel: out = [gamma, dg0, |d|^2, c_0 .. c_2m-1] of the
//   direction d = -(gamma g + Z^T c) (Byrd-Nocedal-Schnabel: H0 = gamma I,
//   R the chronologically upper-triangular part of S Y^T over the filled
//   slots, an empty slot's diagonal 1), from zg, zzt, |g|^2 (*gg_dev, or
//   gg_host when gg_dev is null) and the iteration k; (1, -|g|^2, |g|^2, 0)
//   when the estimated directional derivative dg0 is not negative.  The two
//   triangular solves run in the slots' chronological order, oldest (slot
//   k mod m) first.
// A step of length alpha along d gives the rows s = alpha d, y = g' - g for
// slot `slot`, taken where s.y = (d.g' - dg0) alpha > 1e-10 (else the
// history stays as it is); dots = [g'.g', g.g', d.g'] and, for bfloat16
// rows, [s_r.g', y_r.g'] of the rows as stored (s.g' = alpha d.g' and y.g'
// = g'.g' - g.g' for float32 rows).
// plm_lbfgs_rows_kernel: where the step is taken, s_row = alpha d and y_row
//   = g' - g, rounded to nearest even for bfloat16 rows.
// plm_lbfgs_border_kernel: where the step is taken, borders zzt by the
//   identities Z s = alpha Z d = -alpha (gamma zg + zzt c) (-alpha zg after
//   the steepest-descent fallback, cfull null) and Z y = Z g' - Z g, and
//   sets zg to Z g' (zg_new, the old rows' Z g', bordered where taken), in
//   place; a2dn = alpha^2 |d|^2, gg = |g|^2.
// plm_lbfgs_finish_kernel: d = -(gamma g + d) in place, gamma = *gamma.

namespace {

constexpr int MAX_HIST = 32;  // m, the history's pairs
constexpr int PASS_THREADS = 256;

// s.y > 1e-10: whether the step's rows enter the history (both kernels)
__device__ __forceinline__ bool step_taken(const float* dots, float dg0, float alpha) {
  return __fmul_rn(__fsub_rn(dots[2], dg0), alpha) > 1e-10f;
}

__device__ __forceinline__ int wrap(int a, int m) {
  const int r = a % m;
  return r < 0 ? r + m : r;
}

__global__ void plm_lbfgs_coeffs_kernel(const float* __restrict__ zg,
                                        const float* __restrict__ zzt,
                                        const float* __restrict__ gg_dev, float gg_host, int k,
                                        int m, float* __restrict__ out) {
  const int n2 = 2 * m;
  const float gg = gg_dev != nullptr ? *gg_dev : gg_host;
  auto sy = [&](int i, int j) { return zzt[i * n2 + m + j]; };
  auto yy = [&](int i, int j) { return zzt[(m + i) * n2 + m + j]; };
  bool valid[MAX_HIST];
  int order[MAX_HIST];  // slots, oldest first
  for (int i = 0; i < m; ++i) valid[i] = sy(i, i) != 0.f;
  for (int a = 0; a < m; ++a) order[a] = wrap(k + a, m);
  const int newest = wrap(k - 1, m);
  const float yy_n = valid[newest] ? yy(newest, newest) : 0.f;
  const float gamma = (k > 0 && yy_n > 0.f) ? sy(newest, newest) / fmaxf(yy_n, 1e-30f) : 1.f;

  float x[MAX_HIST], t[MAX_HIST], inner[MAX_HIST], c[2 * MAX_HIST];
  for (int a = m - 1; a >= 0; --a) {  // R x = S g, R upper in chronological order
    const int i = order[a];
    float acc = zg[i];
    if (valid[i]) {
      for (int b = a + 1; b < m; ++b) {
        const int j = order[b];
        if (valid[j]) acc -= sy(i, j) * x[j];
      }
      acc /= sy(i, i);
    }
    x[i] = acc;
  }
  for (int i = 0; i < m; ++i) {
    float s = 0.f;
    if (valid[i])
      for (int j = 0; j < m; ++j)
        if (valid[j]) s += yy(i, j) * x[j];
    inner[i] = (valid[i] ? sy(i, i) * x[i] : 0.f) + gamma * s - gamma * zg[m + i];
  }
  for (int a = 0; a < m; ++a) {  // R^T t = inner, lower in chronological order
    const int i = order[a];
    float acc = inner[i];
    if (valid[i]) {
      for (int b = 0; b < a; ++b) {
        const int j = order[b];
        if (valid[j]) acc -= sy(j, i) * t[j];
      }
      acc /= sy(i, i);
    }
    t[i] = acc;
  }
  for (int i = 0; i < m; ++i) {
    c[i] = t[i];
    c[m + i] = gamma * -x[i];
  }
  float zgc = 0.f, czc = 0.f;
  for (int r = 0; r < n2; ++r) zgc += zg[r] * c[r];
  for (int r = 0; r < n2; ++r) {
    float s = 0.f;
    for (int q = 0; q < n2; ++q) s += zzt[r * n2 + q] * c[q];
    czc += c[r] * s;
  }
  const float dg0 = -(gamma * gg + zgc);
  const float dn2 = gamma * gamma * gg + 2.f * gamma * zgc + czc;
  const bool descent = !(dg0 >= 0.f);
  out[0] = descent ? gamma : 1.f;
  out[1] = descent ? dg0 : -gg;
  out[2] = descent ? fmaxf(dn2, 1e-30f) : gg;
  for (int r = 0; r < n2; ++r) out[3 + r] = descent ? c[r] : 0.f;
}

__global__ void plm_lbfgs_border_kernel(float* __restrict__ zzt, float* __restrict__ zg,
                                        const float* __restrict__ zg_new,
                                        const float* __restrict__ gamma,
                                        const float* __restrict__ cfull,
                                        const float* __restrict__ dots, int m, int slot,
                                        float alpha, float dg0, float a2dn, float gg,
                                        int rounded) {
  const int n2 = 2 * m;
  const float gg_new = dots[0], gog = dots[1], dgn = dots[2];
  const float sy = __fmul_rn(__fsub_rn(dgn, dg0), alpha);
  if (!step_taken(dots, dg0, alpha)) {
    for (int r = 0; r < n2; ++r) zg[r] = zg_new[r];
    return;
  }
  float zgu[2 * MAX_HIST], zs[2 * MAX_HIST], zy[2 * MAX_HIST];
  for (int r = 0; r < n2; ++r) zgu[r] = zg_new[r];
  zgu[slot] = rounded ? dots[3] : dgn * alpha;         // s . g'
  zgu[slot + m] = rounded ? dots[4] : gg_new - gog;   // y . g'
  for (int r = 0; r < n2; ++r) {
    float zd = -zg[r];  // Z d after the steepest-descent fallback (cfull null)
    if (cfull != nullptr) {
      float s = 0.f;
      for (int q = 0; q < n2; ++q) s += zzt[r * n2 + q] * cfull[q];
      zd = -(*gamma * zg[r] + s);
    }
    zs[r] = zd * alpha;
    zy[r] = zgu[r] - zg[r];
  }
  zs[slot] = a2dn;
  zs[slot + m] = sy;
  zy[slot] = sy;
  zy[slot + m] = gg_new - 2.f * gog + gg;
  for (int r = 0; r < n2; ++r) {
    zzt[slot * n2 + r] = zs[r];
    zzt[r * n2 + slot] = zs[r];
  }
  for (int r = 0; r < n2; ++r) {
    zzt[(slot + m) * n2 + r] = zy[r];
    zzt[r * n2 + slot + m] = zy[r];
  }
  for (int r = 0; r < n2; ++r) zg[r] = zgu[r];
}

__device__ __forceinline__ void store_row(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_row(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename Row>
__global__ void plm_lbfgs_rows_kernel(const float* __restrict__ d, const float* __restrict__ gn,
                                      const float* __restrict__ go, float alpha,
                                      const float* __restrict__ dots, float dg0,
                                      Row* __restrict__ s_row, Row* __restrict__ y_row,
                                      long long n) {
  if (!step_taken(dots, dg0, alpha)) return;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    store_row(s_row + i, __fmul_rn(alpha, d[i]));
    store_row(y_row + i, __fsub_rn(gn[i], go[i]));
  }
}

__global__ void plm_lbfgs_finish_kernel(float* __restrict__ d, const float* __restrict__ g,
                                        const float* __restrict__ gamma, long long n) {
  const float gm = *gamma;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += stride)
    d[i] = -__fmaf_rn(gm, g[i], d[i]);
}

unsigned pass_blocks(long long n) {
  const long long b = (n + 4LL * PASS_THREADS - 1) / (4LL * PASS_THREADS);  // 4 elements a thread
  return static_cast<unsigned>(b < 1 ? 1 : (b > 65535 ? 65535 : b));
}

}  // namespace

// Plain C launchers of the L-BFGS algebra (bound with ctypes); layouts
// above.  Each runs on `stream` without synchronising and returns
// cudaGetLastError() (0 on success), or cudaErrorInvalidValue for m outside
// [1, 32], a slot outside [0, m) or n < 0.  Rows are float32, or bfloat16
// where `bf16` (then the border takes dots[3], dots[4]: `rounded`).
extern "C" int plm_lbfgs_coeffs_launch(const void* zg, const void* zzt, const void* gg_dev,
                                       float gg_host, int k, int m, void* out, void* stream) {
  if (m < 1 || m > MAX_HIST || k < 0) return static_cast<int>(cudaErrorInvalidValue);
  plm_lbfgs_coeffs_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(zg), static_cast<const float*>(zzt),
      static_cast<const float*>(gg_dev), gg_host, k, m, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int plm_lbfgs_border_launch(void* zzt, void* zg, const void* zg_new, const void* gamma,
                                       const void* cfull, const void* dots, int m, int slot,
                                       float alpha, float dg0, float a2dn, float gg, int rounded,
                                       void* stream) {
  if (m < 1 || m > MAX_HIST || slot < 0 || slot >= m)
    return static_cast<int>(cudaErrorInvalidValue);
  plm_lbfgs_border_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(zzt), static_cast<float*>(zg), static_cast<const float*>(zg_new),
      static_cast<const float*>(gamma), static_cast<const float*>(cfull),
      static_cast<const float*>(dots), m, slot, alpha, dg0, a2dn, gg, rounded);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int plm_lbfgs_rows_launch(const void* d, const void* gn, const void* go, float alpha,
                                     const void* dots, float dg0, void* s_row, void* y_row,
                                     long long n, int bf16, void* stream) {
  if (n < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  const auto st = static_cast<cudaStream_t>(stream);
  const float* dp = static_cast<const float*>(d);
  const float* gp = static_cast<const float*>(gn);
  const float* op = static_cast<const float*>(go);
  const float* tp = static_cast<const float*>(dots);
  if (bf16)
    plm_lbfgs_rows_kernel<<<pass_blocks(n), PASS_THREADS, 0, st>>>(
        dp, gp, op, alpha, tp, dg0, static_cast<__nv_bfloat16*>(s_row),
        static_cast<__nv_bfloat16*>(y_row), n);
  else
    plm_lbfgs_rows_kernel<<<pass_blocks(n), PASS_THREADS, 0, st>>>(
        dp, gp, op, alpha, tp, dg0, static_cast<float*>(s_row), static_cast<float*>(y_row), n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int plm_lbfgs_finish_launch(void* d, const void* g, const void* gamma, long long n,
                                       void* stream) {
  if (n < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  plm_lbfgs_finish_kernel<<<pass_blocks(n), PASS_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(d), static_cast<const float*>(g), static_cast<const float*>(gamma), n);
  return static_cast<int>(cudaGetLastError());
}
