// Kernel lab T5: a cluster per ray block against a cluster per band of rays.
//
// Replaces: tools/proto_subvisit.py, the Pallas kernels of make_plain(V) and
// make_sub(n_steps, n_bands, use_repeat) as launched by run(). For rays
// (G * 256, 8) f32, Woop blocks tris (C, 4, 384) f32 (rows x, y, z, c over
// lanes [u | v | w]) and a visit list lst (V,) i32, every ray keeps a
// lane-tagged t_cur, starting at BIG = 3e38; a step tests the ray against
// the 128 lanes of one block (_mt):
//   t = -ow / dw (IEEE division; a NaN fails t > 1e-5), hit when
//   t > 1e-5, t < t_cur, u >= 0, v >= 0 and u + v <= 1,
//   tp[l] = bits(hit ? t : BIG) & 0xFFFFFF80 | l,
//   t_cur = min(t_cur, min over l of tp[l])
// so t_cur carries the winning lane in its low 7 bits, and the first step
// rounds BIG down to its masked value even on a miss. With n_bands = 1 (the
// plain kernel) step i tests every ray of the block against lst[i], V
// steps. With n_bands = 4 or 8 (the sub kernels) step i tests the rays of
// group g against lst[n_bands * i + g], V / n_bands steps. The group of ray
// k of a block is k / (256 / n_bands) for the tool's concat operands
// (contiguous bands) and k % n_bands for its pltpu.repeat operands (which
// tile the stacked rows: interleaved groups).
//
// Bound on the H100: operations. A ray-step costs about 20 f32 operations
// for each of the 128 lanes (the w row, the divide, the range test; u and v
// only for candidates) against 6 KiB of block that the whole band shares.
// The bound counts an FMA as two operations, which a kernel that must round
// like its plain version cannot use (its dot products are separate
// multiplies and adds), so about half of it is the ceiling.
//
// Design: one CTA of 256 threads per ray block, one thread per ray. The
// threads of a group form a band of 256 / n_bands consecutive threads (for
// interleaved groups a thread takes the ray k = j * n_bands + g, so the
// band still shares one block): one warp per cluster at 8 bands, two at 4,
// the CTA for the plain kernel; a band waits only for itself (__syncwarp, a
// named barrier of its two warps, the CTA barrier).
//  * Staging. Every lane needs the w row; u and v only a kept lane's. The
//    band copies its block's w rows by 4-byte cp.async into shared memory,
//    lane-major (float4 [lane] = [x y z c]: one broadcast read a lane). The
//    plain kernel double-buffers (the next step's rows are in flight while
//    this step runs, and after the step's one barrier every thread is done
//    with the buffer the next copy overwrites); the sub kernels, whose band
//    waits only for itself, keep one buffer and copy after a second sync
//    (measured: 1.7% slower for plain, 2-4% faster for sub4 and sub8). A
//    kept lane's u and v rows are read from the block in global memory
//    (L1), once a lane and thread a step. A staged block serves 256 /
//    n_bands rays; its copy is 2 to 16 instructions a thread a step against
//    ~2,200 of tests, so CTAs are not made persistent over several blocks.
//  * The division only where it can matter. A lane first computes ow and
//    dw exactly as the plain version does, then s = fma(t_cur, dw, ow) and
//    the sign of ow * s. If ow * s > 0, the IEEE quotient fails t > 1e-5 or
//    t < t_cur, so the lane is a miss and no division runs: ow and s are
//    nonzero with one sign (an underflow to zero makes the product 0, which
//    is kept; an infinite s keeps its sign; a NaN fails > 0 and is kept).
//    The fma's sign is the exact sign of t_cur dw + ow. With dw > 0: both -
//    means -ow > t_cur dw, so -ow / dw > t_cur and its rounding is >= t_cur;
//    both + means -ow / dw < 0. With dw < 0: both + means ow > t_cur |dw|,
//    so the quotient is > t_cur; both - means it is < 0. With dw = +-0 the
//    quotient is infinite. The fma decides the test and never feeds a
//    value. A kept lane (~3.6% of the plain kernel's ray-lanes on the tool's
//    draws, ~18% of sub8's, half of them in the first step) is decided by
//    the plain version's arithmetic.
//  * The walk of kept lanes by lane, not by ray. A ray's kept lanes vary a
//    lot (a ray with no hit yet keeps half of them), so a walk by ray would
//    run, for the whole warp, as long as its busiest ray's (4.4x the mean in
//    a first build). Each lane's test is a warp ballot instead, stored for
//    the warp; then thread i walks lanes i, i + 32, i + 64, i + 96 over
//    every ray of the warp that kept it, reading the ray from a table of the
//    warp's rays in shared memory ([o t_cur] [d m]); a hit lowers the ray's
//    m by a shared atomicMin, and after the walk each ray takes its m.
//  * The misses' tags. A miss at lane l tags BIG's masked bits with l; a
//    hit has t < t_cur <= BIG, so its masked bits are at most BIG's. Lane 0
//    is a miss (tag BIG's masked bits) or a hit (a tag no larger), so the
//    step's minimum is the smaller of BIG's masked bits and the hits' tags:
//    m starts at BIG's masked bits and takes the hits' tags.
//
// Numerics: no fast math and no FMA contraction (utils/build.py), so the
// products and sums round as the plain PyTorch version's do.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kBig = 3.0e38f;
constexpr int kRBlk = 256;
constexpr int kLanes = 128;
constexpr int kRow = 3 * kLanes;  // one Woop row: [u | v | w] lanes
constexpr int kWoop = 4 * kRow;   // floats per block
constexpr unsigned kTagMask = 0xFFFFFF80u;
constexpr unsigned kFull = 0xffffffffu;

template <int kBands>
__device__ __forceinline__ void band_sync(int band) {
  if (kBands == 1) {
    __syncthreads();
  } else if (kBands == 8) {
    __syncwarp();
  } else {
    asm volatile("bar.sync %0, %1;" ::"r"(band + 1), "r"(kRBlk / kBands)
                 : "memory");
  }
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(s), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;" ::: "memory");
}

// thread j of a band of kBandRays copies the w rows of block `src` (4,
// 384) into dst, lane-major: dst[l] = [x y z c] of column 256 + l
template <int kBandRays>
__device__ __forceinline__ void stage(float4* dst, const float* src, int j) {
  float* d = reinterpret_cast<float*>(dst);
#pragma unroll
  for (int e = j; e < 4 * kLanes; e += kBandRays) {
    const int k = e / kLanes, l = e % kLanes;
    cp_async4(d + 4 * l + k, src + k * kRow + 2 * kLanes + l);
  }
  cp_async_commit();
}

// the ray's w-row test of one lane: true unless the IEEE t = -ow / dw
// provably fails t > 1e-5 or t < t_cur (see the header)
__device__ __forceinline__ bool kept(float4 w, float ox, float oy, float oz,
                                     float dx, float dy, float dz,
                                     float t_cur) {
  const float ow = ox * w.x + oy * w.y + oz * w.z + w.w;
  const float dw = dx * w.x + dy * w.y + dz * w.z;
  return !(ow * __fmaf_rn(t_cur, dw, ow) > 0.0f);
}

// a ray of the warp's table: [ox oy oz t_cur] [dx dy dz m], m the bits of
// the step's smallest tag so far
struct RayRow {
  float4 a, b;
};

template <int kBands, int kBufs, bool kProfile>
__global__ void __launch_bounds__(kRBlk)
subvisit_kernel(const float* __restrict__ rays, const float* __restrict__ tris,
                const int* __restrict__ lst, float* __restrict__ out,
                int n_steps, int interleave,
                unsigned long long* __restrict__ prof) {
  constexpr int kBandRays = kRBlk / kBands;
  constexpr int kWarps = kRBlk / 32;
  // [kBufs][kBands][128 lanes] float4: the w rows, lane-major
  __shared__ float4 wbuf[kBufs][kBands][kLanes];
  __shared__ unsigned bal[kWarps][kLanes];  // lane l: its kept rays' bits
  __shared__ RayRow table[kWarps][32];
  const int band = threadIdx.x / kBandRays;
  const int j = threadIdx.x % kBandRays;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int k = interleave ? j * kBands + band : threadIdx.x;
  const size_t ray = (size_t)blockIdx.x * kRBlk + k;
  const float4 r0 = __ldg(reinterpret_cast<const float4*>(rays + ray * 8));
  const float4 r1 = __ldg(reinterpret_cast<const float4*>(rays + ray * 8) + 1);
  const float ox = r0.x, oy = r0.y, oz = r0.z;
  const float dx = r0.w, dy = r1.x, dz = r1.y;
  const unsigned big_m = __float_as_uint(kBig) & kTagMask;
  auto block = [&](int i) {
    return tris + (size_t)__ldg(lst + kBands * i + band) * kWoop;
  };
  RayRow* my = &table[warp][lane];
  unsigned* m_of = reinterpret_cast<unsigned*>(&table[warp][0].b.w);

  float t_cur = kBig;
  unsigned long long n_walk = 0, n_kept = 0;  // the profile's counts
  if (n_steps > 0) stage<kBandRays>(wbuf[0][band], block(0), j);
  for (int i = 0; i < n_steps; ++i) {
    cp_async_wait_all();
    band_sync<kBands>(band);  // block i's w rows are in; i - 1 is done
    const float* blk = block(i);
    if (kBufs == 2 && i + 1 < n_steps)
      stage<kBandRays>(wbuf[(i + 1) & 1][band], block(i + 1), j);
    const float4* wrow = wbuf[kBufs == 2 ? i & 1 : 0][band];
    my->a = make_float4(ox, oy, oz, t_cur);
    my->b = make_float4(dx, dy, dz, __uint_as_float(big_m));

    // the tests: lane l's ballot holds the warp's rays that keep it
#pragma unroll 1
    for (int q = 0; q < 4; ++q) {
#pragma unroll
      for (int b = 0; b < 32; ++b)
        bal[warp][32 * q + b] = __ballot_sync(
            kFull, kept(wrow[32 * q + b], ox, oy, oz, dx, dy, dz, t_cur));
    }
    __syncwarp();  // the ballots and the table are in

    // the walk: thread `lane` takes lanes lane, lane + 32, lane + 64 and
    // lane + 96, each against every ray of the warp that kept it
#pragma unroll 1
    for (int q = 0; q < 4; ++q) {
      const int l = 32 * q + lane;
      unsigned kb = bal[warp][l];
      if (kProfile) {
        n_kept += __popc(kb);
        n_walk += __reduce_max_sync(kFull, (unsigned)__popc(kb));
      }
      if (kb == 0u) continue;
      const float4 w = wrow[l];
      float ua[4], va[4];  // lane l's u and v rows: x, y, z, c
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        ua[c] = __ldg(blk + c * kRow + l);
        va[c] = __ldg(blk + c * kRow + kLanes + l);
      }
      do {
        const int r = __ffs(kb) - 1;
        kb &= kb - 1u;
        const float4 ra = table[warp][r].a;
        const float4 rb = table[warp][r].b;
        const float ow = ra.x * w.x + ra.y * w.y + ra.z * w.z + w.w;
        const float dw = rb.x * w.x + rb.y * w.y + rb.z * w.z;
        const float t = -ow / dw;
        if (t > 1e-5f && t < ra.w) {
          const float u = (ra.x * ua[0] + ra.y * ua[1] + ra.z * ua[2] + ua[3])
                          + t * (rb.x * ua[0] + rb.y * ua[1] + rb.z * ua[2]);
          const float v = (ra.x * va[0] + ra.y * va[1] + ra.z * va[2] + va[3])
                          + t * (rb.x * va[0] + rb.y * va[1] + rb.z * va[2]);
          if (u >= 0.0f && v >= 0.0f && u + v <= 1.0f)
            atomicMin(m_of + 8 * r, (__float_as_uint(t) & kTagMask) | (unsigned)l);
        }
      } while (kb != 0u);
    }
    __syncwarp();  // every hit of the warp is in the table
    // positive finite floats order as their bits
    t_cur = __uint_as_float(min(__float_as_uint(t_cur), m_of[8 * lane]));
    if (kBufs == 1) {
      band_sync<kBands>(band);  // the band has read the block
      if (i + 1 < n_steps) stage<kBandRays>(wbuf[0][band], block(i + 1), j);
    }
  }
  out[ray] = t_cur;
  if (kProfile) {
    n_kept = __reduce_add_sync(kFull, (unsigned)n_kept);
    if (lane == 0) {
      atomicAdd(prof, n_walk);
      atomicAdd(prof + 1, n_kept);
    }
  }
}

template <int kBands, int kBufs>
cudaError_t launch(const float* rays, const float* tris, const int* lst,
                   float* out, int grid, int n_steps, int interleave,
                   unsigned long long* prof, cudaStream_t s) {
  if (prof != nullptr)
    subvisit_kernel<kBands, kBufs, true><<<grid, kRBlk, 0, s>>>(
        rays, tris, lst, out, n_steps, interleave, prof);
  else
    subvisit_kernel<kBands, kBufs, false><<<grid, kRBlk, 0, s>>>(
        rays, tris, lst, out, n_steps, interleave, nullptr);
  return cudaGetLastError();
}

// the kernel of n_bands: the plain one double-buffered, the sub ones not
cudaError_t run(const float* rays, const float* tris, const int* lst,
                float* out, int n_rays, int n_steps, int n_bands,
                int interleave, unsigned long long* prof, cudaStream_t s) {
  if (n_rays <= 0) return cudaSuccess;
  if (n_rays % kRBlk != 0 || n_steps < 0) return cudaErrorInvalidValue;
  const int grid = n_rays / kRBlk;
  switch (n_bands) {
    case 1:
      return launch<1, 2>(rays, tris, lst, out, grid, n_steps, interleave, prof, s);
    case 4:
      return launch<4, 1>(rays, tris, lst, out, grid, n_steps, interleave, prof, s);
    case 8:
      return launch<8, 1>(rays, tris, lst, out, grid, n_steps, interleave, prof, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// out (n_rays,) f32 <- per ray the minimum lane-tagged t over its visits;
// n_rays a multiple of 256, n_bands 1, 4 or 8, lst holding n_bands *
// n_steps entries in [0, C). Launches on `stream`; returns
// cudaGetLastError() right after the launch (0 on success).
int hydra_lab_subvisit(const float* rays, const float* tris, const int* lst,
                       float* out, int n_rays, int n_steps, int n_bands,
                       int interleave, void* stream) {
  return (int)run(rays, tris, lst, out, n_rays, n_steps, n_bands, interleave,
                  nullptr, static_cast<cudaStream_t>(stream));
}

// the profiling build of hydra_lab_subvisit's kernels: the same outputs,
// and it adds to prof[0] the walk's iterations of every warp (for each of
// its four groups of 32 lanes, as many as the thread with the most kept
// rays on its lane) and to prof[1] the kept ray-lanes, which the caller
// zeroes
int hydra_lab_subvisit_profile(const float* rays, const float* tris,
                               const int* lst, float* out, int n_rays,
                               int n_steps, int n_bands, int interleave,
                               unsigned long long* prof, void* stream) {
  if (prof == nullptr) return (int)cudaErrorInvalidValue;
  return (int)run(rays, tris, lst, out, n_rays, n_steps, n_bands, interleave,
                  prof, static_cast<cudaStream_t>(stream));
}

const char* hydra_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
