// Cluster traversal kernels for Hopper: B1 (closest hit) and B2 (any hit)
// over a flat or partitioned pool, and B3 (both hit modes) over the
// two-level instanced layout.
//
// Replaces: hydracore_tpu/ops/traverse_cluster.py, _make_kernel as launched
// by _cluster_traverse (the Pallas TPU kernel), with any_hit_mode False (B1)
// and True (B2), and with inst_mode True (B3); and the chain of launches of
// _partitioned_traverse over the chunks of a partitioned pool.
//
// Contract (the same as the TPU kernel and the plain PyTorch twin in
// hydracore_tpu_torch/ops/traverse_cluster.py):
//   rays      (n_rays, 8) f32 [ox oy oz dx dy dz t_lim active], grouped in
//             blocks of r_blk rays; a block's direction octant is taken from
//             its first ray
//   bounds_oct (P, 8, 8, Cp) f32 cluster AABBs [xm ym zm xM yM zM 0 0] of
//             each of the P chunks in each octant's front-to-back order;
//             perm (P, 8, Cp) i32 the true ids within the chunk. A flat pool
//             is P = 1.
//   tris      (P, Cp, 4, 384) f32 Woop rows x, y, z, c over lanes [u | v | w]
//   t_out     (n_rays,) f32 best hit t; on a miss min(t_lim, BIG), -BIG for
//             inactive rays, and -BIG for occluded rays in any-hit mode
//   slot_out  (n_rays,) i32 (chunk * Cp + true_cluster) * 128 + lane, -1 on
//             a miss
// Instanced (B3; P = 1): bounds_oct and perm run over the Cp = Ci
// instance-clusters, world-space boxes; tris is the shared pool
// (Cpool, 4, 384) in mesh-local space; cl_map (2, Ci) i32 names each
// instance-cluster's [pool block; instance]; inst_woop (I, 4, 4) f32 holds
// A^T, A the affine world -> mesh-local matrix of the instance. The slot's
// cluster is the instance-cluster.
// A hit needs t = -ow/dw with t > 1e-5, t < current t, u >= 0, v >= 0,
// u + v <= 1 (_mt_block). Unlike the TPU kernel, t is exact: no lane bits in
// its mantissa.
//
// Design: one CTA per ray block, one thread per ray. The CTA walks the
// octant's front-to-back cluster order; each live thread slab-tests the
// cluster against its own current t, and __syncthreads_or decides whether
// the CTA stages the cluster's 6 KiB Woop block in shared memory. Threads
// whose box test passed then run the 128-lane Moller-Trumbore in Woop form
// (a broadcast read of shared memory, no bank conflicts). The per-cluster
// test against the current t is the TPU kernel's refilter, done at every
// cluster instead of every K visits. Any-hit retires a thread at its first
// hit; the CTA leaves when no thread is live.
//
// Partitioned pools: the TPU chains one launch per chunk because a chunk is
// what fits its on-chip memory, threading each ray's best t through the
// rays' t_lim between launches. Here the pool stays in device memory and L2,
// so the chain is a loop inside the kernel: chunk after chunk, each in its
// own front-to-back order, with the current t (and the any-hit retirement)
// carried in registers. The visit order and the pruning are the chain's; no
// host work lies between chunks.
//
// Instanced pools: the box test stays in world space. A thread that enters an
// instance-cluster moves its ray into mesh-local space once per visit,
// [o 1] A^T and [d 0] A^T with the direction left unnormalized, so t stays
// the world ray parameter; the Woop test then runs on the pool block as it
// is. (The TPU kernel folds A^T into the staged block instead: the same
// function, rounded differently. The twin uses this kernel's association.)
//
// Bound on the H100: operations. A visit costs ~30 f32 operations per lane
// (128 lanes per cluster) against ~40 bytes of ray in and out, so the work
// is far above the card's 20 operations per byte of f32 balance; the pool
// (a few MiB) stays in L2. What the design does about it: the box test
// prunes clusters behind the current hit per ray, so a ray runs the MT only
// on clusters it may still hit; a warp still steps through a cluster when
// any of its threads needs it, which costs divergence (idle lanes) on
// incoherent bounce rays — the ray sort by (octant, origin Morton) before
// each bounce keeps a CTA's rays together.
//
// Numerics: built without --use_fast_math, so -ow/dw keeps IEEE division
// and the inf/NaN results that make parallel rays fail the hit test, and
// with --fmad=false, so the sums round like the twin's separate multiply
// and add (utils/build.py holds the flags).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kBig = 3.0e38f;
constexpr int kLanes = 128;
constexpr int kRow = 3 * kLanes;   // one Woop row: [u | v | w] lanes
constexpr int kWoop = 4 * kRow;    // floats per cluster block
constexpr int kMaxBlock = 256;

__device__ __forceinline__ float safe_inv(float d) {
  const float eps = 1e-12f;
  const float e = fabsf(d) < eps ? (d < 0.0f ? -eps : eps) : d;
  return 1.0f / e;
}

template <bool kAnyHit, bool kInst>
__global__ void __launch_bounds__(kMaxBlock)
cluster_traverse_kernel(const float* __restrict__ rays,
                        const float* __restrict__ bounds_oct,
                        const float* __restrict__ tris,
                        const int* __restrict__ perm,
                        const int* __restrict__ cl_map,
                        const float* __restrict__ inst_woop,
                        float* __restrict__ t_out,
                        int* __restrict__ slot_out,
                        int n_rays, int r_blk, int Cp, int P) {
  __shared__ __align__(16) float woop[kWoop];

  const int first = blockIdx.x * r_blk;
  const int idx = first + threadIdx.x;
  const bool valid = idx < n_rays;  // ragged last block
  const float* r0 = rays + (size_t)first * 8;
  const int oct = (r0[3] > 0.0f) + 2 * (r0[4] > 0.0f) + 4 * (r0[5] > 0.0f);

  float ox = 0.f, oy = 0.f, oz = 0.f, dx = 1.f, dy = 1.f, dz = 1.f;
  float t_cur = -kBig;
  bool live = false;
  if (valid) {
    const float* r = rays + (size_t)idx * 8;
    ox = r[0]; oy = r[1]; oz = r[2];
    dx = r[3]; dy = r[4]; dz = r[5];
    if (r[7] > 0.0f) {
      t_cur = r[6] < kBig ? r[6] : kBig;
      live = true;
    }
  }
  const float ix = safe_inv(dx), iy = safe_inv(dy), iz = safe_inv(dz);
  const float oxix = ox * ix, oyiy = oy * iy, oziz = oz * iz;

  int slot = -1;
  bool done = false;

  for (int p = 0; p < P && !done; ++p) {
    const float* bo = bounds_oct + ((size_t)p * 8 + oct) * 8 * Cp;
    const int* po = perm + ((size_t)p * 8 + oct) * Cp;
    const float* pool = tris + (size_t)p * Cp * kWoop;
    for (int pos = 0; pos < Cp; ++pos) {
      // uniform over the CTA: every thread leaves both loops together
      if (!__syncthreads_or(live)) { done = true; break; }
      bool hit = false;
      if (live) {
        const float tx0 = __ldg(bo + 0 * Cp + pos) * ix - oxix;
        const float ty0 = __ldg(bo + 1 * Cp + pos) * iy - oyiy;
        const float tz0 = __ldg(bo + 2 * Cp + pos) * iz - oziz;
        const float tx1 = __ldg(bo + 3 * Cp + pos) * ix - oxix;
        const float ty1 = __ldg(bo + 4 * Cp + pos) * iy - oyiy;
        const float tz1 = __ldg(bo + 5 * Cp + pos) * iz - oziz;
        const float tn = fmaxf(fmaxf(fminf(tx0, tx1), fminf(ty0, ty1)),
                               fminf(tz0, tz1));
        const float tf = fminf(fminf(fmaxf(tx0, tx1), fmaxf(ty0, ty1)),
                               fmaxf(tz0, tz1));
        hit = (tf >= fmaxf(tn, 0.0f)) && (tn < t_cur);
      }
      // every thread has finished the previous cluster's MT past this barrier,
      // so the shared block may be overwritten below
      if (!__syncthreads_or(hit)) continue;

      const int c = __ldg(po + pos);
      // the ray the Woop test sees: the world ray, or for an instance-cluster
      // the ray in the instance's mesh-local space
      float lox = ox, loy = oy, loz = oz, ldx = dx, ldy = dy, ldz = dz;
      int blk = c;
      if (kInst) {
        blk = __ldg(cl_map + c);
        const float* a = inst_woop + (size_t)__ldg(cl_map + Cp + c) * 16;
        if (hit) {
          lox = ox * __ldg(a + 0) + oy * __ldg(a + 4) + oz * __ldg(a + 8) + __ldg(a + 12);
          loy = ox * __ldg(a + 1) + oy * __ldg(a + 5) + oz * __ldg(a + 9) + __ldg(a + 13);
          loz = ox * __ldg(a + 2) + oy * __ldg(a + 6) + oz * __ldg(a + 10) + __ldg(a + 14);
          ldx = dx * __ldg(a + 0) + dy * __ldg(a + 4) + dz * __ldg(a + 8);
          ldy = dx * __ldg(a + 1) + dy * __ldg(a + 5) + dz * __ldg(a + 9);
          ldz = dx * __ldg(a + 2) + dy * __ldg(a + 6) + dz * __ldg(a + 10);
        }
      }
      const float4* src = reinterpret_cast<const float4*>(pool + (size_t)blk * kWoop);
      float4* dst = reinterpret_cast<float4*>(woop);
      for (int i = threadIdx.x; i < kWoop / 4; i += blockDim.x) dst[i] = __ldg(src + i);
      __syncthreads();

      if (hit) {
        for (int l = 0; l < kLanes; ++l) {
          const float bxw = woop[0 * kRow + 2 * kLanes + l];
          const float byw = woop[1 * kRow + 2 * kLanes + l];
          const float bzw = woop[2 * kRow + 2 * kLanes + l];
          const float bcw = woop[3 * kRow + 2 * kLanes + l];
          const float ow = lox * bxw + loy * byw + loz * bzw + bcw;
          const float dw = ldx * bxw + ldy * byw + ldz * bzw;
          const float t = -ow / dw;
          if (!(t > 1e-5f && t < t_cur)) continue;
          const float bxu = woop[0 * kRow + l], byu = woop[1 * kRow + l];
          const float bzu = woop[2 * kRow + l], bcu = woop[3 * kRow + l];
          const float u = (lox * bxu + loy * byu + loz * bzu + bcu)
                          + t * (ldx * bxu + ldy * byu + ldz * bzu);
          if (!(u >= 0.0f)) continue;
          const float bxv = woop[0 * kRow + kLanes + l];
          const float byv = woop[1 * kRow + kLanes + l];
          const float bzv = woop[2 * kRow + kLanes + l];
          const float bcv = woop[3 * kRow + kLanes + l];
          const float v = (lox * bxv + loy * byv + loz * bzv + bcv)
                          + t * (ldx * bxv + ldy * byv + ldz * bzv);
          if (!(v >= 0.0f && u + v <= 1.0f)) continue;
          t_cur = t;
          slot = (p * Cp + c) * kLanes + l;
          if (kAnyHit) break;
        }
        if (kAnyHit && slot >= 0) {  // occluded: retire for all later chunks
          live = false;
          t_cur = -kBig;
        }
      }
    }
  }
  if (valid) {
    t_out[idx] = t_cur;
    slot_out[idx] = slot;
  }
}

template <bool kAnyHit, bool kInst>
void launch(int grid, cudaStream_t s, const float* rays,
            const float* bounds_oct, const float* tris, const int* perm,
            const int* cl_map, const float* inst_woop, float* t_out,
            int* slot_out, int n_rays, int r_blk, int Cp, int P) {
  cluster_traverse_kernel<kAnyHit, kInst><<<grid, r_blk, 0, s>>>(
      rays, bounds_oct, tris, perm, cl_map, inst_woop, t_out, slot_out,
      n_rays, r_blk, Cp, P);
}

}  // namespace

extern "C" {

// Launches the traversal on `stream`: B1 (any_hit == 0) or B2 over the P
// chunks of a pool, or B3 in either hit mode when cl_map and inst_woop are
// given (then P must be 1). Returns cudaGetLastError() right after the
// launch (0 on success).
int hydra_cluster_traverse(const float* rays, const float* bounds_oct,
                           const float* tris, const int* perm,
                           const int* cl_map, const float* inst_woop,
                           float* t_out, int* slot_out, int n_rays, int r_blk,
                           int Cp, int P, int any_hit, void* stream) {
  if (n_rays <= 0) return 0;
  if (r_blk <= 0 || r_blk > kMaxBlock || Cp <= 0 || P <= 0)
    return (int)cudaErrorInvalidValue;
  const bool inst = cl_map != nullptr;
  if (inst && (inst_woop == nullptr || P != 1)) return (int)cudaErrorInvalidValue;
  const int grid = (n_rays + r_blk - 1) / r_blk;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (inst) {
    if (any_hit)
      launch<true, true>(grid, s, rays, bounds_oct, tris, perm, cl_map,
                         inst_woop, t_out, slot_out, n_rays, r_blk, Cp, P);
    else
      launch<false, true>(grid, s, rays, bounds_oct, tris, perm, cl_map,
                          inst_woop, t_out, slot_out, n_rays, r_blk, Cp, P);
  } else {
    if (any_hit)
      launch<true, false>(grid, s, rays, bounds_oct, tris, perm, cl_map,
                          inst_woop, t_out, slot_out, n_rays, r_blk, Cp, P);
    else
      launch<false, false>(grid, s, rays, bounds_oct, tris, perm, cl_map,
                           inst_woop, t_out, slot_out, n_rays, r_blk, Cp, P);
  }
  return (int)cudaGetLastError();
}

const char* hydra_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
