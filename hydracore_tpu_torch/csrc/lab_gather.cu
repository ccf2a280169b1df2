// Kernel lab T7: random row gathers, summed over 16 shifted indices.
//
// Replaces: tools/bench_pallas_gather.py, kern_taa (take_along_axis over
// sublanes) and kern_onehot (one-hot bf16 matmul on the MXU) as launched by
// run(). Both compute, for a pool (S, 128) f32 and indices idx (R,) i32,
//   out[r] = sum over it < iters of pool[(idx[r] + it) mod S]
// in iteration order, starting from 0.0; the one-hot variant sums the rows
// rounded to bf16 (round to nearest even), which is what its bf16 matmul
// with f32 accumulation gives. The kernel computes that function, not the
// MXU trick.
//
// Bound on the H100: bytes. Each output row costs iters dependent-free
// 512-byte row reads and one 512-byte write; the pool (2 MiB at the tool's
// S = 4096) stays resident in the 50 MB L2, which is where the TPU's VMEM
// residency lands on Hopper, so device memory sees idx once, the pool once
// and out once.
//
// Design: one warp per output row, a float4 per lane (128 floats), so each
// row read is one coalesced 512-byte transaction; the 16 iterations are
// unrolled with the sum kept in registers. Eight warps per CTA.
//
// Numerics: no fast math and no FMA contraction (utils/build.py), so the sum
// rounds as the plain PyTorch version's running sum does: bit-equal.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCols = 128;
constexpr int kWarps = 8;

__device__ __forceinline__ float to_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

template <bool kOneHot>
__global__ void __launch_bounds__(kWarps * 32)
gather_kernel(const float* __restrict__ pool, const int* __restrict__ idx,
              float* __restrict__ out, int R, int S, int iters) {
  const int row = blockIdx.x * kWarps + threadIdx.x / 32;
  if (row >= R) return;
  const int lane = threadIdx.x % 32;
  const int i0 = __ldg(idx + row);
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 16
  for (int it = 0; it < iters; ++it) {
    int r = (i0 + it) % S;  // Python's floor modulo
    if (r < 0) r += S;
    float4 v = __ldg(reinterpret_cast<const float4*>(pool + (size_t)r * kCols) + lane);
    if (kOneHot) {
      v.x = to_bf16(v.x); v.y = to_bf16(v.y);
      v.z = to_bf16(v.z); v.w = to_bf16(v.w);
    }
    acc.x = acc.x + v.x; acc.y = acc.y + v.y;
    acc.z = acc.z + v.z; acc.w = acc.w + v.w;
  }
  reinterpret_cast<float4*>(out + (size_t)row * kCols)[lane] = acc;
}

}  // namespace

extern "C" {

// out (R, 128) f32 <- the gather-sum of pool (S, 128) f32 at idx (R,) i32;
// onehot != 0 sums bf16-rounded rows. Launches on `stream`; returns
// cudaGetLastError() right after the launch (0 on success).
int hydra_lab_gather(const float* pool, const int* idx, float* out, int R,
                     int S, int iters, int onehot, void* stream) {
  if (R <= 0) return 0;
  if (S <= 0 || iters < 0) return (int)cudaErrorInvalidValue;
  const int grid = (R + kWarps - 1) / kWarps;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (onehot)
    gather_kernel<true><<<grid, kWarps * 32, 0, s>>>(pool, idx, out, R, S, iters);
  else
    gather_kernel<false><<<grid, kWarps * 32, 0, s>>>(pool, idx, out, R, S, iters);
  return (int)cudaGetLastError();
}

const char* hydra_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
