// Kernel lab T1: the cluster kernel's time split into its parts.
//
// Replaces: tools/exp_kernel_cost.py, the Pallas kernels built by build()
// from k_floor, mk_stagea(n) and mk_compact(n), and floor_multi(mult)'s
// kernel. Each is a cut-down cluster kernel (B1's shape) on ray blocks
// rays (G, 256, 8) f32 [o d t_lim active] with the octant of each block's
// first ray in oct (G,) i32 and the cluster boxes bounds_oct (8, 8, Cp) f32
// of each octant's order; each writes out (G, 256, 8) f32 and outi
// (G, 256, 8) i32:
//   floor      out = the rays, outi = 0 (I/O only); fmN: the same, N ray
//              blocks per CTA
//   stageaN    N times the box scan: for each of the (Cp / 128) * 128
//              positions of the block's octant, the tool's slab test
//                inv = 1 / where(|d| < 1e-12, +1e-12, d)  (unsigned eps,
//                unlike B1's signed safe_inv), hit = tf >= max(tn, 0) and
//                tn < t_lim (no liveness test of the ray),
//              OR-ed over the block's 256 rays into bit pos & 15 of
//              occupancy word pos >> 4; out = N * word 0, outi = 0. As in
//              B1, the scan ends where no ray of the block is live
//              (active > 0): a block without one has no bits set, which
//              the tool's kernel never meets (all its rays are active)
//   compactN   the scan once, then N sweeps that build the list of entered
//              positions from the words; out = N * (entered positions),
//              outi = 0
// min and max propagate NaN, as jnp.minimum / torch.minimum do.
//
// Bound on the H100: floor by bytes (96 bytes a ray: rays in, out and outi
// written); the scan by operations, 24 f32 operations per ray and position
// (6 mul-sub pairs, 10 min/max, 2 compares), so N * 24 * 256 per block and
// position against 6 floats of box read by the whole CTA.
//
// Design: as B1 (csrc/traverse_cluster.cu), one CTA of 256 threads per ray
// block, one thread per ray, the octant from oct, and at every cluster
// position the two __syncthreads_or that B1's scan pays there: the OR of
// liveness, which ends the scan, and the OR of the box test. The
// CTA-uniform result goes into a register word that thread 0 stores to
// shared memory every 16 positions (and where the scan ends; the words are
// zeroed before each scan). The compaction is
// warp 0's: a popcount and a warp prefix sum per 32 words place each
// entered position in a shared list (volatile, so that every sweep writes
// it).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRBlk = 256;
constexpr int kFloor = 0, kStageA = 1, kCompact = 2;

__device__ __forceinline__ float nan_min(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fminf(a, b);
}
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fmaxf(a, b);
}

__device__ __forceinline__ float inv_unsigned_eps(float d) {
  const float eps = 1e-12f;
  return 1.0f / (fabsf(d) < eps ? eps : d);
}

template <int kVariant>
__global__ void __launch_bounds__(kRBlk)
cost_kernel(const float* __restrict__ rays, const int* __restrict__ oct,
            const float* __restrict__ bounds_oct, float* __restrict__ out,
            int* __restrict__ outi, int Cp, int n_rep, int mult) {
  extern __shared__ int smem[];
  const int tid = threadIdx.x;

  if (kVariant == kFloor) {
    for (int b = 0; b < mult; ++b) {
      const size_t ray = ((size_t)blockIdx.x * mult + b) * kRBlk + tid;
      const float4* src = reinterpret_cast<const float4*>(rays + ray * 8);
      float4* dst = reinterpret_cast<float4*>(out + ray * 8);
      int4* dsti = reinterpret_cast<int4*>(outi + ray * 8);
      dst[0] = __ldg(src);
      dst[1] = __ldg(src + 1);
      dsti[0] = make_int4(0, 0, 0, 0);
      dsti[1] = make_int4(0, 0, 0, 0);
    }
    return;
  }

  const int n_pos = Cp / 128 * 128;
  const int n_words = n_pos / 16;
  int* words = smem;                                // n_words
  volatile int* lst = smem + n_words;               // n_pos + 8
  int* total_s = smem + n_words + n_pos + 8;        // 1

  const size_t ray = (size_t)blockIdx.x * kRBlk + tid;
  const float* r = rays + ray * 8;
  const float ox = r[0], oy = r[1], oz = r[2];
  const float ix = inv_unsigned_eps(r[3]);
  const float iy = inv_unsigned_eps(r[4]);
  const float iz = inv_unsigned_eps(r[5]);
  const float t_act = r[6];
  const bool live = r[7] > 0.0f;
  const float oxix = ox * ix, oyiy = oy * iy, oziz = oz * iz;
  const float* bo = bounds_oct + (size_t)__ldg(oct + blockIdx.x) * 8 * Cp;

  int acc = 0;
  const int scans = kVariant == kStageA ? n_rep : 1;
  for (int rep = 0; rep < scans; ++rep) {
    for (int w = tid; w < n_words; w += kRBlk) words[w] = 0;
    unsigned word = 0u;
    for (int pos = 0; pos < n_pos; ++pos) {
      // B1's first barrier (traverse_cluster.cu): the scan ends with the
      // block's last live ray
      if (!__syncthreads_or(live)) {
        if (tid == 0) words[pos >> 4] = (int)word;
        break;
      }
      const float tx0 = __ldg(bo + 0 * Cp + pos) * ix - oxix;
      const float ty0 = __ldg(bo + 1 * Cp + pos) * iy - oyiy;
      const float tz0 = __ldg(bo + 2 * Cp + pos) * iz - oziz;
      const float tx1 = __ldg(bo + 3 * Cp + pos) * ix - oxix;
      const float ty1 = __ldg(bo + 4 * Cp + pos) * iy - oyiy;
      const float tz1 = __ldg(bo + 5 * Cp + pos) * iz - oziz;
      const float tn = nan_max(nan_max(nan_min(tx0, tx1), nan_min(ty0, ty1)),
                               nan_min(tz0, tz1));
      const float tf = nan_min(nan_min(nan_max(tx0, tx1), nan_max(ty0, ty1)),
                               nan_max(tz0, tz1));
      const bool hit = (tf >= nan_max(tn, 0.0f)) && (tn < t_act);
      word |= (unsigned)(__syncthreads_or(hit) != 0) << (pos & 15);
      if ((pos & 15) == 15) {
        if (tid == 0) words[pos >> 4] = (int)word;
        word = 0u;
      }
    }
    __syncthreads();
    acc += words[0];
    __syncthreads();  // words[0] is read before the next scan rewrites it
  }

  if (kVariant == kCompact) {
    if (tid < 32) {
      const int lane = tid;
      int total = 0;
      for (int rep = 0; rep < n_rep; ++rep) {
        int n = 0;
        for (int base = 0; base < n_words; base += 32) {
          const int w_i = base + lane;
          unsigned w = w_i < n_words ? (unsigned)words[w_i] : 0u;
          const int c = __popc(w);
          int incl = c;
          for (int off = 1; off < 32; off <<= 1) {
            const int y = __shfl_up_sync(0xffffffffu, incl, off);
            if (lane >= off) incl += y;
          }
          int at = n + incl - c;
          while (w) {
            lst[at++] = w_i * 16 + (__ffs(w) - 1);
            w &= w - 1u;
          }
          n += __shfl_sync(0xffffffffu, incl, 31);
        }
        total += n;
        __syncwarp();
      }
      if (lane == 0) *total_s = total;
    }
    __syncthreads();
    acc = *total_s;
  }

  const float v = (float)acc;
  float4* dst = reinterpret_cast<float4*>(out + ray * 8);
  int4* dsti = reinterpret_cast<int4*>(outi + ray * 8);
  dst[0] = make_float4(v, v, v, v);
  dst[1] = make_float4(v, v, v, v);
  dsti[0] = make_int4(0, 0, 0, 0);
  dsti[1] = make_int4(0, 0, 0, 0);
}

}  // namespace

extern "C" {

// One of the lab's variants on G ray blocks of 256 rays: variant 0 floor
// (mult blocks per CTA, G a multiple of mult), 1 stage A (n_rep scans),
// 2 compaction (one scan, n_rep sweeps). Launches on `stream`; returns
// cudaGetLastError() right after the launch (0 on success).
int hydra_lab_cluster_cost(const float* rays, const int* oct,
                           const float* bounds_oct, float* out, int* outi,
                           int G, int Cp, int variant, int n_rep, int mult,
                           void* stream) {
  if (G <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (variant == kFloor) {
    if (mult <= 0 || G % mult != 0) return (int)cudaErrorInvalidValue;
    cost_kernel<kFloor><<<G / mult, kRBlk, 0, s>>>(rays, oct, bounds_oct, out,
                                                   outi, Cp, n_rep, mult);
    return (int)cudaGetLastError();
  }
  const int n_pos = Cp / 128 * 128;
  const size_t smem = (size_t)(n_pos / 16 + n_pos + 8 + 1) * sizeof(int);
  if (n_pos <= 0 || n_rep < 0 || smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  if (variant == kStageA)
    cost_kernel<kStageA><<<G, kRBlk, smem, s>>>(rays, oct, bounds_oct, out,
                                                outi, Cp, n_rep, 1);
  else if (variant == kCompact)
    cost_kernel<kCompact><<<G, kRBlk, smem, s>>>(rays, oct, bounds_oct, out,
                                                 outi, Cp, n_rep, 1);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

const char* hydra_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
