// Kernel lab T7: random row gathers, summed over `iters` shifted indices.
//
// Replaces: tools/bench_pallas_gather.py, kern_taa (take_along_axis over
// sublanes) and kern_onehot (one-hot bf16 matmul on the MXU) as launched by
// run(). Both compute, for a pool (S, 128) f32 and indices idx (R,) i32,
//   out[r] = 0 + sum over it < iters of term(k(r, it)), in iteration order,
//   k(r, it) = (idx[r] + it) mod S,
// where idx[r] + it wraps as int32 arithmetic does (two's complement) and
// mod is the floor modulo (Python's %). taa: term(k) = pool[k]. onehot: with
// b = bf16(pool) (round to nearest even), column by column
//   term(k)[c] = NaN  where b[s, c] is inf or NaN for some row s != k (the
//                     one-hot product adds 0 * b[s, c], and 0 * inf is NaN),
//                b[k, c] otherwise (NaN where b[k, c] is NaN),
// decided from one count a column of the non-finite b and the row of such a
// value (the row is read only where the count is 1). A finite pool gives
// the sum of the rounded rows. The kernel computes that function, not the
// MXU trick.
//
// Bound on the H100: bytes. The function reads idx once and the pool once
// and writes out once; 98% of it is out (R x 512 B at the tool's size).
//
// Design. out[r] depends on idx[r] only through the window of rows that
// starts at j = idx[r] mod S, unless idx[r] + it wraps. So where the window
// path moves fewer rows than the direct kernel reads (the wrapper decides
// from the shapes; bench_pallas_gather.py:uses_window has the rule):
//   1. window_kernel builds W[j] = the sum of the window that starts at j for
//      every j < S. A CTA takes kTile windows: it copies their kTile + iters
//      - 1 rows once into shared memory (cp.async), and each warp sums 4
//      windows in one pass over their rows, every term added in iteration
//      order, so W[j] is bit-equal to a direct sum from j. For onehot it
//      rounds the staged rows to bf16 and counts each column's non-finite b
//      over its own kTile rows (an atomic only where one is found) into
//      `stats`, zeroed by a memset first.
//   2. gather_kernel copies out[r] = W[j]: kRows rows a warp, the lane of a
//      row computing its j, the row loads in flight together, out written by
//      streaming stores (st.global.cs) so that 128 MiB of output do not evict
//      W from L2. For onehot it then sets to NaN the columns that the rule
//      makes NaN in every term: a count >= 1, unless the window is the one row
//      of a count of 1. A row whose idx + it wraps (idx > INT32_MAX -
//      (iters - 1), where S does not divide 2^32) takes the direct sum in the
//      same kernel.
// Otherwise direct_kernel sums the iters rows of each output row directly:
// one warp a row, a float4 a lane, kBatch row reads in flight, out by
// streaming stores (for onehot after a window_kernel launch that only
// counts). Rows of W and of the pool are 512 bytes, one coalesced
// transaction a warp. At the tool's size the gather pass writes out at the
// rate of a plain 128 MiB write, and the window pass and the launch
// boundaries take the rest (PERF.md).
//
// Numerics: no fast math and no FMA contraction (utils/build.py), so every
// sum rounds as the plain PyTorch version's running sum does: bit-equal, a
// NaN matching any NaN.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>

namespace {

constexpr int kCols = 128;
constexpr int kWarps = 8;
constexpr int kRows = 4;    // output rows a warp of the gather pass
constexpr int kBatch = 16;  // row reads in flight in a direct sum
constexpr int kTile = 32;   // windows a CTA of the window pass, 4 a warp
// the window pass stages kTile + iters - 1 rows of 512 bytes in at most
// 48 KiB of shared memory
constexpr int kMaxWindowIters = 96 - kTile + 1;
constexpr unsigned kFull = 0xffffffffu;

size_t tile_bytes(int iters) {
  return (size_t)(kTile + (iters > 1 ? iters : 1) - 1) * kCols * sizeof(float);
}

struct Stats {
  int count[kCols];  // non-finite b in each column
  int row[kCols];    // the row of one of them (read where count == 1)
};

__device__ __forceinline__ float to_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ int floor_mod(int x, int S) {
  const int r = x % S;
  return r < 0 ? r + S : r;
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// onehot's term for one column: NaN where a row other than k holds a
// non-finite b in the column
__device__ __forceinline__ float rule(float v, int n, int f, int k) {
  return (n >= 2 || (n == 1 && f != k)) ? __int_as_float(0x7fc00000) : v;
}

__device__ __forceinline__ float4 bf16x4(float4 v) {
  return make_float4(to_bf16(v.x), to_bf16(v.y), to_bf16(v.z), to_bf16(v.w));
}

// a pool row's float4 of this lane as a term: rounded to bf16 for onehot,
// and NaN in the columns that the rule makes NaN (kRule)
template <bool kOneHot, bool kRule>
__device__ __forceinline__ float4 as_term(float4 v, int k, int4 n, int4 f) {
  if (kOneHot) v = bf16x4(v);
  if (kRule) {
    v.x = rule(v.x, n.x, f.x, k); v.y = rule(v.y, n.y, f.y, k);
    v.z = rule(v.z, n.z, f.z, k); v.w = rule(v.w, n.w, f.w, k);
  }
  return v;
}

__device__ __forceinline__ float4 load_row(const float* __restrict__ pool,
                                           int k, int lane) {
  return __ldg(reinterpret_cast<const float4*>(pool + (size_t)k * kCols) + lane);
}

// 0 + sum over it < iters of term((i0 + it) mod S) in iteration order. The
// int32 wrap of i0 + it changes a row only for i0 > wrap_above; below it the
// rows follow one another mod S, read kBatch at a time, all in flight
// before the first is added.
template <bool kOneHot, bool kRule>
__device__ float4 row_sum(const float* __restrict__ pool, int i0, int S,
                          int iters, int wrap_above, int lane, int4 n, int4 f) {
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  if (i0 > wrap_above) {
    for (int it = 0; it < iters; ++it) {
      const int k = floor_mod((int)((unsigned)i0 + (unsigned)it), S);
      acc = add4(acc, as_term<kOneHot, kRule>(load_row(pool, k, lane), k, n, f));
    }
    return acc;
  }
  int k = floor_mod(i0, S), it = 0;
  for (; it + kBatch <= iters; it += kBatch) {
    float4 v[kBatch];
    int ks[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      ks[u] = k;
      v[u] = load_row(pool, k, lane);
      k = k + 1 == S ? 0 : k + 1;
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u)
      acc = add4(acc, as_term<kOneHot, kRule>(v[u], ks[u], n, f));
  }
  for (; it < iters; ++it) {
    acc = add4(acc, as_term<kOneHot, kRule>(load_row(pool, k, lane), k, n, f));
    k = k + 1 == S ? 0 : k + 1;
  }
  return acc;
}

__device__ __forceinline__ void load_stats(const Stats* stats, int lane,
                                           int4& n, int4& f) {
  n = reinterpret_cast<const int4*>(stats->count)[lane];
  f = reinterpret_cast<const int4*>(stats->row)[lane];
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src)
               : "memory");
}

// W[j] for the kTile windows j0 <= j < j0 + kTile of this CTA (kSums) and,
// for onehot, the count of non-finite b of each column over those rows j.
// The rows j0 .. j0 + kTile + iters - 2 (mod S) are copied once into shared
// memory (cp.async), rounded to bf16 there for onehot; warp w then sums its
// 4 windows j0 + 4w + u in one pass over their rows, each row added to the
// windows that hold it, in iteration order.
template <bool kOneHot, bool kSums>
__global__ void __launch_bounds__(kWarps * 32)
window_kernel(const float* __restrict__ pool, float* __restrict__ window,
              Stats* stats, int S, int iters) {
  extern __shared__ float4 rows[];  // staged rows, 32 float4 each
  const int j0 = blockIdx.x * kTile;
  const int n_win = min(kTile, S - j0);
  const int n_rows = kSums ? n_win + max(iters, 1) - 1 : n_win;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  for (int q = warp; q < n_rows; q += kWarps)
    cp_async16(rows + q * 32 + lane,
               pool + (size_t)((j0 + q) % S) * kCols + lane * 4);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  if (kOneHot) {  // each thread rounds the float4s it copied
    for (int q = warp; q < n_rows; q += kWarps) {
      const float4 b = bf16x4(rows[q * 32 + lane]);
      rows[q * 32 + lane] = b;
      if (q >= n_win) continue;
      const float c[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (!isfinite(c[e])) {
          atomicAdd(&stats->count[lane * 4 + e], 1);
          stats->row[lane * 4 + e] = j0 + q;
        }
      }
    }
  }
  if (!kSums) return;
  __syncthreads();
  const int t0 = warp * 4;
  float4 acc[4];
#pragma unroll
  for (int u = 0; u < 4; ++u) acc[u] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int r = 0; r < iters + 3; ++r) {
    const float4 v = rows[(t0 + r) * 32 + lane];
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (r - u >= 0 && r - u < iters) acc[u] = add4(acc[u], v);
  }
#pragma unroll
  for (int u = 0; u < 4; ++u)
    if (t0 + u < n_win)
      reinterpret_cast<float4*>(window + (size_t)(j0 + t0 + u) * kCols)[lane] = acc[u];
}

template <bool kOneHot>
__global__ void __launch_bounds__(kWarps * 32)
gather_kernel(const float* __restrict__ window, const Stats* stats,
              const float* __restrict__ pool, const int* __restrict__ idx,
              float* __restrict__ out, int R, int S, int iters, int wrap_above) {
  const int row0 = (blockIdx.x * kWarps + threadIdx.x / 32) * kRows;
  if (row0 >= R) return;
  const int lane = threadIdx.x % 32;
  // lane u < kRows reads row row0 + u's index and computes its window
  int i_own = 0;
  if (lane < kRows && row0 + lane < R) i_own = __ldcs(idx + row0 + lane);
  const int j_own = floor_mod(i_own, S);
  int4 n = make_int4(0, 0, 0, 0), f = n;
  if (kOneHot) load_stats(stats, lane, n, f);
  float4 v[kRows];
  int i[kRows], j[kRows];
#pragma unroll
  for (int u = 0; u < kRows; ++u) {
    i[u] = __shfl_sync(kFull, i_own, u);
    j[u] = __shfl_sync(kFull, j_own, u);
    v[u] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + u < R && i[u] <= wrap_above)
      v[u] = __ldg(reinterpret_cast<const float4*>(window + (size_t)j[u] * kCols) + lane);
  }
  const bool single = S == 1 || iters == 1;
  const float nan = __int_as_float(0x7fc00000);
#pragma unroll
  for (int u = 0; u < kRows; ++u) {
    if (row0 + u >= R) break;
    if (i[u] > wrap_above) {
      v[u] = row_sum<kOneHot, kOneHot>(pool, i[u], S, iters, wrap_above, lane, n, f);
    } else if (kOneHot && iters >= 1) {
      // NaN in every term but where the window is the one non-finite row
      if (n.x >= 1 && !(n.x == 1 && single && j[u] == f.x)) v[u].x = nan;
      if (n.y >= 1 && !(n.y == 1 && single && j[u] == f.y)) v[u].y = nan;
      if (n.z >= 1 && !(n.z == 1 && single && j[u] == f.z)) v[u].z = nan;
      if (n.w >= 1 && !(n.w == 1 && single && j[u] == f.w)) v[u].w = nan;
    }
    __stcs(reinterpret_cast<float4*>(out + (size_t)(row0 + u) * kCols) + lane, v[u]);
  }
}

template <bool kOneHot>
__global__ void __launch_bounds__(kWarps * 32)
direct_kernel(const float* __restrict__ pool, const Stats* stats,
              const int* __restrict__ idx, float* __restrict__ out, int R,
              int S, int iters, int wrap_above) {
  const int row = blockIdx.x * kWarps + threadIdx.x / 32;
  if (row >= R) return;
  const int lane = threadIdx.x % 32;
  int4 n = make_int4(0, 0, 0, 0), f = n;
  if (kOneHot) load_stats(stats, lane, n, f);
  const float4 acc = row_sum<kOneHot, kOneHot>(pool, __ldg(idx + row), S,
                                               iters, wrap_above, lane, n, f);
  __stcs(reinterpret_cast<float4*>(out + (size_t)row * kCols) + lane, acc);
}

template <bool kOneHot>
int launch(const float* pool, const int* idx, float* out, float* window,
           Stats* stats, int R, int S, int iters, cudaStream_t s) {
  // idx + it wraps for it < iters only above this; mod S the wrap changes
  // nothing where S divides 2^32
  const int wrap_above =
      (iters >= 1 && (S & (S - 1)) != 0) ? INT_MAX - (iters - 1) : INT_MAX;
  const int threads = kWarps * 32;
  const int tiles = (S + kTile - 1) / kTile;
  if (window && iters > kMaxWindowIters) return (int)cudaErrorInvalidValue;
  if (kOneHot) {
    cudaError_t err = cudaMemsetAsync(stats->count, 0, sizeof(stats->count), s);
    if (err != cudaSuccess) return (int)err;
  }
  if (window) {
    window_kernel<kOneHot, true><<<tiles, threads, tile_bytes(iters), s>>>(
        pool, window, stats, S, iters);
    const int per_cta = kWarps * kRows;
    gather_kernel<kOneHot><<<(R + per_cta - 1) / per_cta, threads, 0, s>>>(
        window, stats, pool, idx, out, R, S, iters, wrap_above);
  } else {
    if (kOneHot)
      window_kernel<true, false><<<tiles, threads, tile_bytes(1), s>>>(
          pool, nullptr, stats, S, iters);
    direct_kernel<kOneHot><<<(R + kWarps - 1) / kWarps, threads, 0, s>>>(
        pool, stats, idx, out, R, S, iters, wrap_above);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// out (R, 128) f32 <- the gather-sum of pool (S, 128) f32 at idx (R,) i32;
// onehot != 0 takes the bf16 terms and their NaN rule. window (S, 128) f32
// scratch selects the window path (nullptr: the direct kernel); stats (256
// int32 scratch) is needed for onehot; the window path takes at most
// kMaxWindowIters iterations. Launches on `stream`; returns the first CUDA
// error (0 on success).
int hydra_lab_gather(const float* pool, const int* idx, float* out,
                     float* window, int* stats, int R, int S, int iters,
                     int onehot, void* stream) {
  if (R <= 0) return 0;
  if (S <= 0 || iters < 0 || (onehot && !stats)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Stats* st = reinterpret_cast<Stats*>(stats);
  return onehot ? launch<true>(pool, idx, out, window, st, R, S, iters, s)
                : launch<false>(pool, idx, out, window, st, R, S, iters, s);
}

const char* hydra_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
