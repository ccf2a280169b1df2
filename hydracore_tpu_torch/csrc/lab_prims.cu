// Kernel lab T6: ten small primitive probes.
//
// Replaces: tools/proto_prims.py, the Pallas kernels k1 ... k10 as launched
// by probe(). Each reads x (64, 128) f32 (and k4 also xi (64, 128) i32) and
// writes one row (1, 128) f32:
//   k1  x[3, 5] broadcast                      (scalar read, fixed index)
//   k2  x[sum(int(x[0, :8])) mod 60]            (reduction -> row index)
//   k3  sum(x[3, :8]) broadcast                 (one element of a row sum)
//   k4  x[xi[0, 2] mod 60]                      (int read -> row index)
//   k5  sum over k < 8 of x[2, 16 k] broadcast  (reshape (1,128) -> (8,16))
//   k6  x[(7 * 8) mod 60], the 7 written to and read back from shared memory
//   k7  15.0: a five-entry stack in shared memory popped in a loop
//   k8  sum over r < 8 of max(x[r, :]) broadcast (lane reduction)
//   k9  float(bits of x[0, :] as int32)          (bitcast)
//   k10 x[0, 0:128:16] padded with zeros to 128   (strided slice)
// Sums run in index order, min/max propagate NaN, mod is Python's floor
// modulo, as in the plain PyTorch versions (tools/proto_prims.py).
//
// Bound on the H100: launch latency. A probe reads at most 4 KiB of its
// inputs (k8; tools/proto_prims.py:NEEDS) and writes 512 bytes, which the
// card's memory rate covers in under 2 ns; a launch costs microseconds.
//
// Design: one kernel per probe, one CTA of 128 threads, thread j writing
// out[j]; reductions are done by every thread on its own (at most 1,024
// reads from L1), so no probe needs a barrier except those whose TPU
// primitive was a scratch-memory round trip (k6, k7).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCols = 128;

__device__ __forceinline__ int floor_mod(int a, int m) {
  const int r = a % m;
  return r < 0 ? r + m : r;
}

__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fmaxf(a, b);
}

template <int kProbe>
__global__ void __launch_bounds__(kCols)
prim_kernel(const float* __restrict__ x, const int* __restrict__ xi,
            float* __restrict__ out) {
  __shared__ int sm[16];
  const int j = threadIdx.x;
  float v = 0.0f;
  if (kProbe == 1) {
    v = x[3 * kCols + 5];
  } else if (kProbe == 2) {
    unsigned s = 0;  // int32 sum with wrap-around
    for (int c = 0; c < 8; ++c) s += (unsigned)(int)x[c];
    v = x[floor_mod((int)s, 60) * kCols + j];
  } else if (kProbe == 3) {
    v = x[3 * kCols];
    for (int c = 1; c < 8; ++c) v = v + x[3 * kCols + c];
  } else if (kProbe == 4) {
    v = x[floor_mod(xi[2], 60) * kCols + j];
  } else if (kProbe == 5) {
    v = x[2 * kCols];
    for (int k = 1; k < 8; ++k) v = v + x[2 * kCols + 16 * k];
  } else if (kProbe == 6) {
    if (j == 0) sm[3] = 7;
    __syncthreads();
    v = x[floor_mod(sm[3] * 8, 60) * kCols + j];
  } else if (kProbe == 7) {
    if (j == 0) { sm[0] = 5; sm[1] = 2; sm[2] = 3; sm[3] = 4; sm[4] = 1; }
    __syncthreads();
    int sp = 5, acc = 0;
    while (sp > 0) acc += sm[--sp];
    v = (float)acc;
  } else if (kProbe == 8) {
    for (int r = 0; r < 8; ++r) {
      float m = x[r * kCols];
      for (int c = 1; c < kCols; ++c) m = nan_max(m, x[r * kCols + c]);
      v = r == 0 ? m : v + m;
    }
    v = v + 0.0f;
  } else if (kProbe == 9) {
    v = __int2float_rn(__float_as_int(x[j]));
  } else if (kProbe == 10) {
    v = j < 8 ? x[16 * j] : 0.0f;
  }
  out[j] = v;
}

}  // namespace

extern "C" {

// out (1, 128) f32 <- probe `probe` (1 ... 10) of x (64, 128) f32 and xi
// (64, 128) i32. Launches on `stream`; returns cudaGetLastError() right
// after the launch (0 on success).
int hydra_lab_prim(int probe, const float* x, const int* xi, float* out,
                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (probe) {
    case 1: prim_kernel<1><<<1, kCols, 0, s>>>(x, xi, out); break;
    case 2: prim_kernel<2><<<1, kCols, 0, s>>>(x, xi, out); break;
    case 3: prim_kernel<3><<<1, kCols, 0, s>>>(x, xi, out); break;
    case 4: prim_kernel<4><<<1, kCols, 0, s>>>(x, xi, out); break;
    case 5: prim_kernel<5><<<1, kCols, 0, s>>>(x, xi, out); break;
    case 6: prim_kernel<6><<<1, kCols, 0, s>>>(x, xi, out); break;
    case 7: prim_kernel<7><<<1, kCols, 0, s>>>(x, xi, out); break;
    case 8: prim_kernel<8><<<1, kCols, 0, s>>>(x, xi, out); break;
    case 9: prim_kernel<9><<<1, kCols, 0, s>>>(x, xi, out); break;
    case 10: prim_kernel<10><<<1, kCols, 0, s>>>(x, xi, out); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

const char* hydra_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
