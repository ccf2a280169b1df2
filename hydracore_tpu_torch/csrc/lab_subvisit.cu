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
//
// Design: one CTA of 256 threads per ray block, one thread per ray. The
// threads of a group form a band of 256 / n_bands consecutive threads (for
// interleaved groups a thread takes the ray k = j * n_bands + g, so the
// band still shares one block), and each band stages its own 6 KiB block
// tris[lst[...]] in shared memory, then every thread runs the 128 lanes
// reading it as a broadcast. At 8 bands that is one warp per cluster and
// 8 x 6 KiB = 48 KiB of shared memory; a band waits only for itself
// (__syncwarp at 8 bands, a named barrier of its two warps at 4, the CTA
// barrier for the plain kernel).
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

template <int kBands>
__global__ void __launch_bounds__(kRBlk)
subvisit_kernel(const float* __restrict__ rays, const float* __restrict__ tris,
                const int* __restrict__ lst, float* __restrict__ out,
                int n_steps, int interleave) {
  __shared__ __align__(16) float woop[kBands * kWoop];
  constexpr int kBandRays = kRBlk / kBands;
  const int band = threadIdx.x / kBandRays;
  const int j = threadIdx.x % kBandRays;
  const int k = interleave ? j * kBands + band : threadIdx.x;
  const size_t ray = (size_t)blockIdx.x * kRBlk + k;
  const float* r = rays + ray * 8;
  const float ox = r[0], oy = r[1], oz = r[2];
  const float dx = r[3], dy = r[4], dz = r[5];
  float* blk = woop + band * kWoop;

  float t_cur = kBig;
  for (int i = 0; i < n_steps; ++i) {
    const int c = __ldg(lst + kBands * i + band);
    const float4* src = reinterpret_cast<const float4*>(tris + (size_t)c * kWoop);
    float4* dst = reinterpret_cast<float4*>(blk);
    for (int q = j; q < kWoop / 4; q += kBandRays) dst[q] = __ldg(src + q);
    band_sync<kBands>(band);

    float m = __int_as_float(0x7f800000);  // +inf: every lane's tp is finite
    for (int l = 0; l < kLanes; ++l) {
      const float bxw = blk[0 * kRow + 2 * kLanes + l];
      const float byw = blk[1 * kRow + 2 * kLanes + l];
      const float bzw = blk[2 * kRow + 2 * kLanes + l];
      const float bcw = blk[3 * kRow + 2 * kLanes + l];
      const float ow = ox * bxw + oy * byw + oz * bzw + bcw;
      const float dw = dx * bxw + dy * byw + dz * bzw;
      const float t = -ow / dw;
      float tm = kBig;
      if (t > 1e-5f && t < t_cur) {
        const float bxu = blk[0 * kRow + l], byu = blk[1 * kRow + l];
        const float bzu = blk[2 * kRow + l], bcu = blk[3 * kRow + l];
        const float bxv = blk[0 * kRow + kLanes + l];
        const float byv = blk[1 * kRow + kLanes + l];
        const float bzv = blk[2 * kRow + kLanes + l];
        const float bcv = blk[3 * kRow + kLanes + l];
        const float u = (ox * bxu + oy * byu + oz * bzu + bcu)
                        + t * (dx * bxu + dy * byu + dz * bzu);
        const float v = (ox * bxv + oy * byv + oz * bzv + bcv)
                        + t * (dx * bxv + dy * byv + dz * bzv);
        if (u >= 0.0f && v >= 0.0f && u + v <= 1.0f) tm = t;
      }
      const float tp = __uint_as_float((__float_as_uint(tm) & 0xFFFFFF80u) | (unsigned)l);
      m = fminf(m, tp);
    }
    t_cur = fminf(t_cur, m);
    band_sync<kBands>(band);  // the band has read the block before it is overwritten
  }
  out[ray] = t_cur;
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
  if (n_rays <= 0) return 0;
  if (n_rays % kRBlk != 0 || n_steps < 0) return (int)cudaErrorInvalidValue;
  const int grid = n_rays / kRBlk;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (n_bands) {
    case 1:
      subvisit_kernel<1><<<grid, kRBlk, 0, s>>>(rays, tris, lst, out, n_steps, interleave);
      break;
    case 4:
      subvisit_kernel<4><<<grid, kRBlk, 0, s>>>(rays, tris, lst, out, n_steps, interleave);
      break;
    case 8:
      subvisit_kernel<8><<<grid, kRBlk, 0, s>>>(rays, tris, lst, out, n_steps, interleave);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

const char* hydra_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
