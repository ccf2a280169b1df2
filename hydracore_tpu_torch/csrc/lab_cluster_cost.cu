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
// Design. floor / fmN: one CTA of 256 threads per ray block (or mult of
// them), a float4 copy. stageaN / compactN (scan_kernel, redesigned in the
// way of csrc/lab_cluster.cu's stage A): one CTA of 256 threads per ray
// block with the cluster positions on the lanes, not one CTA barrier pair
// a position.
//  * The CTA copies the octant's 6 box rows (n_pos of each, row stride Cp)
//    into shared memory with cp.async, while each thread writes its ray's
//    [ix iy iz t_lim], [ox*ix oy*iy oz*iz 0] to its warp's table. One
//    __syncthreads_or of liveness then ends the copy and decides the block:
//    `live` does not change within a scan, so B1's per-position vote could
//    only end it at position 0, and a block without a live ray sets no bit.
//  * Lane l of a warp takes positions 4 l .. 4 l + 3 of each 128-position
//    tile (6 float4 of box from shared memory) and tests them against the
//    warp's 32 rays, read back as two float4 broadcasts a ray, OR-ing the
//    hits in a 4-bit register. Two xor shuffles merge four lanes' nibbles
//    into one 16-bit occupancy word; one shared atomicOr per word and warp
//    then sets the block's word. A scan pays two barriers, not 768.
//  * min and max propagate NaN as torch.minimum / torch.maximum do, by the
//    PTX min.NaN.f32 / max.NaN.f32 (sm_80 and later): one instruction each,
//    where a compare-and-select chain took several. The sign of a zero
//    result may differ from torch's, which no compare of the test can see.
//  * Every repeat is real work: stageaN zeroes the words, scans and reads
//    word 0 N times, barriers between (the atomics are side effects the
//    compiler must keep); compactN's N sweeps write the volatile list.
// The compaction is warp 0's: a popcount and a warp prefix sum per 32 words
// place each entered position in a shared list (volatile, so that every
// sweep writes it).
//
// Numerics: no fast math and no FMA contraction (utils/build.py): each
// t = box * ix - ox * ix is a product, then a subtraction, as in the tool.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRBlk = 256;
constexpr int kFloor = 0, kStageA = 1, kCompact = 2;
// CTAs an SM that scan_kernel's registers are capped for (64 a thread)
constexpr int kScanCtas = 4;
constexpr size_t kMaxSmem = 227 * 1024;

// min and max that return NaN when either operand is NaN
__device__ __forceinline__ float nan_min(float a, float b) {
  float d;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}
__device__ __forceinline__ float nan_max(float a, float b) {
  float d;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

__device__ __forceinline__ float inv_unsigned_eps(float d) {
  const float eps = 1e-12f;
  return 1.0f / (fabsf(d) < eps ? eps : d);
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src)
               : "memory");
}

__global__ void __launch_bounds__(kRBlk)
floor_kernel(const float* __restrict__ rays, float* __restrict__ out,
             int* __restrict__ outi, int mult) {
  const int tid = threadIdx.x;
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
}

// bytes of scan_kernel's dynamic shared memory: the ray tables, the box
// rows, the words, the list and its length
size_t scan_smem(int n_pos) {
  return (size_t)(8 * kRBlk + 6 * n_pos + n_pos / 16 + n_pos + 8 + 1) * 4;
}

template <int kVariant>
__global__ void __launch_bounds__(kRBlk, kScanCtas)
scan_kernel(const float* __restrict__ rays, const int* __restrict__ oct,
            const float* __restrict__ bounds_oct, float* __restrict__ out,
            int* __restrict__ outi, int Cp, int n_rep) {
  extern __shared__ float4 smem4[];  // 16-byte aligned for the float4 reads
  const int n_pos = Cp / 128 * 128;
  const int n_words = n_pos / 16;
  float* box = reinterpret_cast<float*>(smem4 + 2 * kRBlk);  // 6 x n_pos
  int* words = reinterpret_cast<int*>(box + 6 * n_pos);      // n_words
  volatile int* lst = words + n_words;                       // n_pos + 8
  int* total_s = words + n_words + n_pos + 8;                // 1
  const int tid = threadIdx.x;
  const int lane = tid & 31;

  const float* bo = bounds_oct + (size_t)__ldg(oct + blockIdx.x) * 8 * Cp;
  for (int r = 0; r < 6; ++r)
    for (int q = tid; q < n_pos; q += kRBlk)
      cp_async4(box + r * n_pos + q, bo + (size_t)r * Cp + q);
  asm volatile("cp.async.commit_group;\n" ::: "memory");

  const size_t ray = (size_t)blockIdx.x * kRBlk + tid;
  const float4 ra = __ldg(reinterpret_cast<const float4*>(rays + ray * 8));
  const float4 rb = __ldg(reinterpret_cast<const float4*>(rays + ray * 8) + 1);
  const float ix = inv_unsigned_eps(ra.w);
  const float iy = inv_unsigned_eps(rb.x);
  const float iz = inv_unsigned_eps(rb.y);
  smem4[2 * tid] = make_float4(ix, iy, iz, rb.z);
  smem4[2 * tid + 1] = make_float4(ra.x * ix, ra.y * iy, ra.z * iz, 0.0f);
  for (int w = tid; w < n_words; w += kRBlk) words[w] = 0;
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  // the rows, the tables and the zeroed words are in; B1's liveness vote
  const bool live = __syncthreads_or(rb.w > 0.0f) != 0;

  const float4* rt = smem4 + 2 * (tid & ~31);  // the warp's 32 rays
  const float4* b4 = reinterpret_cast<const float4*>(box);
  const int row4 = n_pos / 4;
  int acc = 0;
  const int scans = kVariant == kStageA ? n_rep : 1;
  for (int rep = 0; rep < scans; ++rep) {
    if (rep > 0) {
      for (int w = tid; w < n_words; w += kRBlk) words[w] = 0;
      __syncthreads();  // zeroed before any warp's atomicOr
    }
    for (int tile = 0; live && tile < n_pos / 128; ++tile) {
      const int g = tile * 32 + lane;  // positions 4 g .. 4 g + 3
      const float4 x0 = b4[0 * row4 + g], y0 = b4[1 * row4 + g],
                   z0 = b4[2 * row4 + g], x1 = b4[3 * row4 + g],
                   y1 = b4[4 * row4 + g], z1 = b4[5 * row4 + g];
      const float bx0[4] = {x0.x, x0.y, x0.z, x0.w};
      const float by0[4] = {y0.x, y0.y, y0.z, y0.w};
      const float bz0[4] = {z0.x, z0.y, z0.z, z0.w};
      const float bx1[4] = {x1.x, x1.y, x1.z, x1.w};
      const float by1[4] = {y1.x, y1.y, y1.z, y1.w};
      const float bz1[4] = {z1.x, z1.y, z1.z, z1.w};
      unsigned nib = 0u;
#pragma unroll 4
      for (int r = 0; r < 32; ++r) {
        const float4 iv = rt[2 * r], oi = rt[2 * r + 1];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float tx0 = bx0[q] * iv.x - oi.x;
          const float ty0 = by0[q] * iv.y - oi.y;
          const float tz0 = bz0[q] * iv.z - oi.z;
          const float tx1 = bx1[q] * iv.x - oi.x;
          const float ty1 = by1[q] * iv.y - oi.y;
          const float tz1 = bz1[q] * iv.z - oi.z;
          const float tn = nan_max(nan_max(nan_min(tx0, tx1), nan_min(ty0, ty1)),
                                   nan_min(tz0, tz1));
          const float tf = nan_min(nan_min(nan_max(tx0, tx1), nan_max(ty0, ty1)),
                                   nan_max(tz0, tz1));
          nib |= (tf >= nan_max(tn, 0.0f) && tn < iv.w) ? 1u << q : 0u;
        }
      }
      // four lanes' nibbles make word g / 4: lane g's at bits 4 (g & 3)
      unsigned w = nib << (4 * (lane & 3));
      w |= __shfl_xor_sync(0xffffffffu, w, 1);
      w |= __shfl_xor_sync(0xffffffffu, w, 2);
      if ((lane & 3) == 0 && w != 0u) atomicOr(words + (g >> 2), (int)w);
    }
    __syncthreads();  // every warp's words are in
    acc += words[0];
    __syncthreads();  // word 0 is read before the next scan rewrites it
  }

  if (kVariant == kCompact) {
    if (tid < 32) {
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

// the box rows take more than the 48 KiB a launch gets by default once
// Cp passes ~1,500: up to the 227 KiB of an SM, by the kernel's attribute
template <int kVariant>
cudaError_t launch_scan(const float* rays, const int* oct,
                        const float* bounds_oct, float* out, int* outi, int G,
                        int Cp, int n_rep, cudaStream_t s) {
  const size_t smem = scan_smem(Cp / 128 * 128);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        scan_kernel<kVariant>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
  }
  scan_kernel<kVariant><<<G, kRBlk, smem, s>>>(rays, oct, bounds_oct, out,
                                               outi, Cp, n_rep);
  return cudaGetLastError();
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
    floor_kernel<<<G / mult, kRBlk, 0, s>>>(rays, out, outi, mult);
    return (int)cudaGetLastError();
  }
  const int n_pos = Cp / 128 * 128;
  if (n_pos <= 0 || n_rep < 0 || scan_smem(n_pos) > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  if (variant == kStageA)
    return (int)launch_scan<kStageA>(rays, oct, bounds_oct, out, outi, G, Cp,
                                     n_rep, s);
  if (variant == kCompact)
    return (int)launch_scan<kCompact>(rays, oct, bounds_oct, out, outi, G, Cp,
                                      n_rep, s);
  return (int)cudaErrorInvalidValue;
}

const char* hydra_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
