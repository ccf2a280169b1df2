// Dense traversal kernel for Hopper: every live ray against every triangle
// slot of a small scene, closest hit or any hit, in float32 or (under
// -double_rt) float64.
//
// Replaces: no Pallas kernel. The JAX package's dense route
// (hydracore_tpu/ops/traverse_dense.py:_traverse_dense) is XLA code, which
// fuses its (rays x slots) Moller-Trumbore into one pass. The port's eager
// version of it (ops/traverse_dense.py:traverse_dense_plain, kept as the
// plain version) writes and rereads ~20 (rays x slots) temporaries a slice
// of rays and sizes its slices with a host sync. This kernel computes the
// same function in one launch, with no temporary and no host sync.
//
// Contract (ops/traverse_dense.py:traverse_dense):
//   tri9f     (B, 8 * 16) f32 leaf rows: slot s = 8 b + l holds v0, e1, e2
//             in its first 9 floats (the other 7 unused)
//   slot_tri  (S,) i32, S = 8 B: slot -> triangle id
//   ray_o, ray_d (R, 3) f32; t_max (R,) f32 of stride 0 or 1, or a scalar
//             already rounded to f32; active (R,) bool, or null for all live
//   closest hit: t (R,) f32 (+inf on a miss), tri (R,) i64 (-1 on a miss),
//             u, v (R,) f32 (0 on a miss); any hit: occ (R,) bool
// A slot hits a ray when, in T (float, or double under -double_rt):
//   p = d x e2, det = e1 . p, inv = |det| > 1e-12 ? 1 / det : 0,
//   s = o - v0, u = (s . p) inv, q = s x e1, v = (d . q) inv,
//   t = (e2 . q) inv,
//   inv != 0, u >= 0, v >= 0, u + v <= 1, t > 1e-5 and t < cap,
// cap = min(t_max, 3e38f) with a NaN kept (torch.clamp). Each product is
// rounded and each dot product summed left to right (built with
// --fmad=false, utils/build.py), 1 / det is the IEEE division, and the
// constants are rounded to T as PyTorch rounds a scalar. The nearest hit
// wins, the first slot among equal t. Above BLOCK_SLOTS (2,048) slots the
// plain version takes blocks of 2,048 and rounds its running best t to f32
// at each block's end; so does this kernel (a no-op in float). A dead ray
// writes the miss record.
//
// Bound on the H100: operations. A (ray, slot) pair costs 51 f32
// operations (about 70 instructions with the division and the tests),
// reused by no other ray, against 28 bytes in and 16 out a ray:
// live rays x S x 51 over 67 TFLOP/s, 0.33 ms for a PT step's 4.99 M live
// rays over the Cornell box's 88 slots, against 0.07 ms of bytes.
//
// Design: one thread a ray, 256 threads a block. The block stages the 9
// used fields of up to 1,024 slots in shared memory, field-major; then every
// thread walks the same slots in the same order, so each read is a
// broadcast, four slots of a field in one float4, and no thread waits on
// another. A larger scene loops over chunks of 1,024 slots (a 2,048-slot
// block of the plain version is two chunks). The last chunk is padded to a
// multiple of 4 slots with NaN fields, which fail |det| > 1e-12 and so
// every test. A dead ray skips the walk; a warp walks while any of its rays
// is live. Any hit stops a ray at its first hit: the answer is a bool
// either way.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kRow = 16;           // floats a slot in tri9f
constexpr int kFields = 9;         // v0, e1, e2
constexpr int kChunk = 1024;       // slots staged at once
constexpr int kBlockSlots = 2048;  // ops/traverse_dense.py:BLOCK_SLOTS
constexpr int kThreads = 256;
constexpr float kBig = 3.0e38f;

template <typename T>
struct Ray {
  T ox, oy, oz, dx, dy, dz;
};

__device__ __forceinline__ float lane(const float4& c, int j) {
  return j == 0 ? c.x : j == 1 ? c.y : j == 2 ? c.z : c.w;
}

__device__ __forceinline__ float magnitude(float x) { return fabsf(x); }
__device__ __forceinline__ double magnitude(double x) { return fabs(x); }

// The plain version's _mt_block for one (ray, slot) pair, its cap `lim`.
template <typename T>
__device__ __forceinline__ bool hits(const Ray<T>& r, T v0x, T v0y, T v0z,
                                     T e1x, T e1y, T e1z, T e2x, T e2y,
                                     T e2z, T lim, T& t, T& u, T& v) {
  const T px = r.dy * e2z - r.dz * e2y;
  const T py = r.dz * e2x - r.dx * e2z;
  const T pz = r.dx * e2y - r.dy * e2x;
  const T det = e1x * px + e1y * py + e1z * pz;
  const T inv = magnitude(det) > T(1e-12) ? T(1) / det : T(0);
  const T sx = r.ox - v0x, sy = r.oy - v0y, sz = r.oz - v0z;
  u = (sx * px + sy * py + sz * pz) * inv;
  const T qx = sy * e1z - sz * e1y;
  const T qy = sz * e1x - sx * e1z;
  const T qz = sx * e1y - sy * e1x;
  v = (r.dx * qx + r.dy * qy + r.dz * qz) * inv;
  t = (e2x * qx + e2y * qy + e2z * qz) * inv;
  return inv != T(0) && u >= T(0) && v >= T(0) && u + v <= T(1) &&
         t > T(1e-5) && t < lim;
}

template <typename T, bool kAny>
__global__ void __launch_bounds__(kThreads)
dense_kernel(const float* __restrict__ tri9f, const int* __restrict__ slot_tri,
             const float* __restrict__ ray_o, const float* __restrict__ ray_d,
             const float* __restrict__ t_max, int tm_stride, float tm_scalar,
             const bool* __restrict__ active, int n_rays, int n_slots,
             int chunk, float* __restrict__ t_out,
             int64_t* __restrict__ tri_out, float* __restrict__ u_out,
             float* __restrict__ v_out, bool* __restrict__ occ_out) {
  extern __shared__ float4 smem[];
  float* sh = reinterpret_cast<float*>(smem);  // (kFields, chunk)
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const bool live = i < n_rays && (active == nullptr || active[i]);
  Ray<T> r{};
  float cap = 0.0f;
  if (live) {
    const size_t k = 3 * static_cast<size_t>(i);
    r = {T(ray_o[k]), T(ray_o[k + 1]), T(ray_o[k + 2]),
         T(ray_d[k]), T(ray_d[k + 1]), T(ray_d[k + 2])};
    cap = t_max != nullptr ? t_max[static_cast<size_t>(i) * tm_stride]
                           : tm_scalar;
    cap = cap > kBig ? kBig : cap;  // torch.clamp(max=BIG): a NaN stays
  }
  T best = T(cap), ub = T(0), vb = T(0);
  int slot = -1;
  bool walking = live;
  for (int lo = 0; lo < n_slots; lo += chunk) {
    const int n = min(chunk, n_slots - lo);
    const int n4 = (n + 3) & ~3;
    if (lo > 0) __syncthreads();  // every thread is done with the last chunk
    for (int k = threadIdx.x; k < n4 * kRow; k += kThreads) {
      const int s = k >> 4, f = k & (kRow - 1);
      if (f < kFields)
        sh[f * chunk + s] = s < n ? tri9f[static_cast<size_t>(lo + s) * kRow + f]
                                  : __int_as_float(0x7fc00000);
    }
    __syncthreads();
    for (int s = 0; walking && s < n4; s += 4) {
      float4 c[kFields];
#pragma unroll
      for (int f = 0; f < kFields; ++f)
        c[f] = *reinterpret_cast<const float4*>(sh + f * chunk + s);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        T t, u, v;
        if (hits(r, T(lane(c[0], j)), T(lane(c[1], j)), T(lane(c[2], j)),
                 T(lane(c[3], j)), T(lane(c[4], j)), T(lane(c[5], j)),
                 T(lane(c[6], j)), T(lane(c[7], j)), T(lane(c[8], j)), best,
                 t, u, v)) {
          slot = lo + s + j;
          if (kAny) {
            walking = false;
            break;
          }
          best = t;  // t < best: strictly nearer, so the first of equal t
          ub = u;
          vb = v;
        }
      }
    }
    if (sizeof(T) > sizeof(float) && (lo + n) % kBlockSlots == 0)
      best = T(static_cast<float>(best));  // the plain version's block end
  }
  if (i >= n_rays) return;
  const bool found = slot >= 0;
  if (kAny) {
    occ_out[i] = found;
  } else {
    t_out[i] = found ? static_cast<float>(best) : INFINITY;
    tri_out[i] = found ? static_cast<int64_t>(slot_tri[slot]) : -1;
    u_out[i] = found ? static_cast<float>(ub) : 0.0f;
    v_out[i] = found ? static_cast<float>(vb) : 0.0f;
  }
}

}  // namespace

extern "C" {

// Launches the dense walk on `stream`: closest hit (any_hit == 0; t_out,
// tri_out, u_out, v_out) or any hit (occ_out), in float64 when f64 != 0.
// t_max null takes tm_scalar for every ray. Returns cudaGetLastError()
// right after the launch (0 on success).
int hydra_dense_traverse(const float* tri9f, const int* slot_tri,
                         const float* ray_o, const float* ray_d,
                         const float* t_max, int tm_stride, float tm_scalar,
                         const bool* active, float* t_out, int64_t* tri_out,
                         float* u_out, float* v_out, bool* occ_out,
                         int n_rays, int n_slots, int f64, int any_hit,
                         void* stream) {
  if (n_rays <= 0) return 0;
  if (n_slots < 0 || (tm_stride != 0 && tm_stride != 1) ||
      (any_hit ? occ_out == nullptr
               : (t_out == nullptr || tri_out == nullptr ||
                  u_out == nullptr || v_out == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int chunk = n_slots < kChunk ? (n_slots + 3) & ~3 : kChunk;
  const size_t smem = sizeof(float) * kFields * chunk;
  const int grid = (n_rays + kThreads - 1) / kThreads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto go = [&](auto kernel) {
    kernel<<<grid, kThreads, smem, s>>>(tri9f, slot_tri, ray_o, ray_d, t_max,
                                        tm_stride, tm_scalar, active, n_rays,
                                        n_slots, chunk, t_out, tri_out, u_out,
                                        v_out, occ_out);
  };
  if (f64)
    any_hit ? go(dense_kernel<double, true>) : go(dense_kernel<double, false>);
  else
    any_hit ? go(dense_kernel<float, true>) : go(dense_kernel<float, false>);
  return static_cast<int>(cudaGetLastError());
}

const char* hydra_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
