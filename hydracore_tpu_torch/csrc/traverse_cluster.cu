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
// Instanced (B3, hydra_inst_traverse): tris is the shared pool (Cpool, 4,
// 384) in mesh-local space; cl_map (2, Ci) i32 names each instance-cluster's
// [pool block; instance]; inst_woop (I, 4, 4) f32 holds A^T, A the affine
// world -> mesh-local matrix of the instance; the instance level
// (bvh/instanced.py:instance_tables): inst_bounds (8, I) f32 world AABBs of
// the instances, inst_oct_perm (8, I) i32 their front-to-back order per
// octant, icl_oct (8, Ci) i32 per octant the instance-clusters grouped by
// instance (group i at [icl_start[i], icl_start[i + 1])), each group
// front-to-back, and icl_bounds (8, 8, Ci) f32 their world AABBs in that
// order. The slot's cluster is the instance-cluster.
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
// Instanced pools (B3), a two-level walk: the CTA walks the instances in
// the octant's front-to-back order; each live thread slab-tests the
// instance's world box against its own current t, and one vote decides
// whether the CTA walks the instance at all (closest hit so also drops
// whole instances behind every ray's hit). A thread that entered the box
// moves its ray into mesh-local space once per instance, [o 1] A^T and
// [d 0] A^T with the direction left unnormalized, so t stays the world ray
// parameter; the CTA then walks only that instance's group of
// instance-clusters, with the world-space box test, the vote and the Woop
// test of B1 on the pool block as it is; a thread outside the instance box
// skips its cluster tests. Each cluster box lies inside its instance box
// and the slab test is monotone under rounding, so the cull changes no box
// test: only the visit order (instance-major) differs from a walk over all
// instance-clusters, and with it the pick among equal t. (The TPU kernel
// walks every instance-cluster and folds A^T into the staged block: the
// same function, rounded differently. The twin moves the ray as here.)
// The Woop blocks are staged asynchronously into two shared buffers
// (cp.async, 16 bytes a thread): the vote for the next visited cluster is
// taken against each ray's t as it stands, its block copied while the
// current block's 128 lanes are tested; the test compares with the live t,
// so the nearest hit is the same.
//
// Bound on the H100: operations. A visit costs ~30 f32 operations per lane
// (128 lanes per cluster) against ~40 bytes of ray in and out, so the work
// is far above the card's 20 operations per byte of f32 balance; the pool
// (a few MiB) stays in L2. What the design does about it: the box test
// prunes clusters behind the current hit per ray, so a ray runs the MT only
// on clusters it may still hit; a warp still steps through a cluster when
// any of its threads needs it, which costs divergence (idle lanes) on
// incoherent bounce rays — the ray sort by (octant, origin Morton) before
// each bounce keeps a CTA's rays together. In B3 the instance cull leaves a
// block a few hundred positions of thousands (chip_smoke.py phase 6 logs
// them); what remains is mostly the Woop test of every cluster some ray of
// the block enters, run by each warp that holds one such ray.
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

// One ray's slab test of box `pos` of a (8, stride) bounds table against its
// current t (B1, B2 and B3 share it, so a box gives the same answer in all).
__device__ __forceinline__ bool enters(const float* __restrict__ b, int stride,
                                       int pos, float ix, float iy, float iz,
                                       float oxix, float oyiy, float oziz,
                                       float t_cur) {
  const float tx0 = __ldg(b + 0 * stride + pos) * ix - oxix;
  const float ty0 = __ldg(b + 1 * stride + pos) * iy - oyiy;
  const float tz0 = __ldg(b + 2 * stride + pos) * iz - oziz;
  const float tx1 = __ldg(b + 3 * stride + pos) * ix - oxix;
  const float ty1 = __ldg(b + 4 * stride + pos) * iy - oyiy;
  const float tz1 = __ldg(b + 5 * stride + pos) * iz - oziz;
  const float tn = fmaxf(fmaxf(fminf(tx0, tx1), fminf(ty0, ty1)),
                         fminf(tz0, tz1));
  const float tf = fminf(fminf(fmaxf(tx0, tx1), fmaxf(ty0, ty1)),
                         fmaxf(tz0, tz1));
  return (tf >= fmaxf(tn, 0.0f)) && (tn < t_cur);
}

// The 128-lane Woop test of the staged block `w` for one ray (o, d): the
// nearest hit in (1e-5, t_cur) sets t_cur and slot = slot_base + lane; any
// hit stops at the first.
template <bool kAnyHit>
__device__ __forceinline__ void woop_lanes(const float* w, float ox, float oy,
                                           float oz, float dx, float dy,
                                           float dz, float& t_cur, int& slot,
                                           int slot_base) {
  for (int l = 0; l < kLanes; ++l) {
    const float bxw = w[0 * kRow + 2 * kLanes + l];
    const float byw = w[1 * kRow + 2 * kLanes + l];
    const float bzw = w[2 * kRow + 2 * kLanes + l];
    const float bcw = w[3 * kRow + 2 * kLanes + l];
    const float ow = ox * bxw + oy * byw + oz * bzw + bcw;
    const float dw = dx * bxw + dy * byw + dz * bzw;
    const float t = -ow / dw;
    if (!(t > 1e-5f && t < t_cur)) continue;
    const float bxu = w[0 * kRow + l], byu = w[1 * kRow + l];
    const float bzu = w[2 * kRow + l], bcu = w[3 * kRow + l];
    const float u = (ox * bxu + oy * byu + oz * bzu + bcu)
                    + t * (dx * bxu + dy * byu + dz * bzu);
    if (!(u >= 0.0f)) continue;
    const float bxv = w[0 * kRow + kLanes + l];
    const float byv = w[1 * kRow + kLanes + l];
    const float bzv = w[2 * kRow + kLanes + l];
    const float bcv = w[3 * kRow + kLanes + l];
    const float v = (ox * bxv + oy * byv + oz * bzv + bcv)
                    + t * (dx * bxv + dy * byv + dz * bzv);
    if (!(v >= 0.0f && u + v <= 1.0f)) continue;
    t_cur = t;
    slot = slot_base + l;
    if (kAnyHit) break;
  }
}

template <bool kAnyHit>
__global__ void __launch_bounds__(kMaxBlock)
cluster_traverse_kernel(const float* __restrict__ rays,
                        const float* __restrict__ bounds_oct,
                        const float* __restrict__ tris,
                        const int* __restrict__ perm,
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
      const bool hit = live && enters(bo, Cp, pos, ix, iy, iz, oxix, oyiy,
                                      oziz, t_cur);
      // every thread has finished the previous cluster's MT past this barrier,
      // so the shared block may be overwritten below
      if (!__syncthreads_or(hit)) continue;

      const int c = __ldg(po + pos);
      const float4* src = reinterpret_cast<const float4*>(pool + (size_t)c * kWoop);
      float4* dst = reinterpret_cast<float4*>(woop);
      for (int i = threadIdx.x; i < kWoop / 4; i += blockDim.x) dst[i] = __ldg(src + i);
      __syncthreads();

      if (hit) {
        woop_lanes<kAnyHit>(woop, ox, oy, oz, dx, dy, dz, t_cur, slot,
                            (p * Cp + c) * kLanes);
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

// ---- B3: the two-level walk over an instanced pool

// Copy one 6 KiB Woop block into shared memory, 16 bytes a thread, as one
// cp.async group (committed empty when blk < 0, so that every thread always
// has the same number of groups in flight).
__device__ __forceinline__ void stage_async(float* dst, const float* pool,
                                            int blk) {
  if (blk >= 0) {
    const float* src = pool + (size_t)blk * kWoop;
    for (int i = threadIdx.x; i < kWoop / 4; i += blockDim.x) {
      const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst + 4 * i));
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                   :: "r"(s), "l"(src + 4 * i) : "memory");
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <bool kAnyHit>
__global__ void __launch_bounds__(kMaxBlock)
inst_traverse_kernel(const float* __restrict__ rays,
                     const float* __restrict__ tris,
                     const int* __restrict__ cl_map,
                     const float* __restrict__ inst_woop,
                     const float* __restrict__ inst_bounds,
                     const int* __restrict__ inst_oct_perm,
                     const int* __restrict__ icl_oct,
                     const float* __restrict__ icl_bounds,
                     const int* __restrict__ icl_start,
                     float* __restrict__ t_out,
                     int* __restrict__ slot_out,
                     int n_rays, int r_blk, int Ci, int I) {
  __shared__ __align__(16) float woop[2][kWoop];

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

  const int* io = inst_oct_perm + (size_t)oct * I;
  const float* bo = icl_bounds + (size_t)oct * 8 * Ci;
  const int* co = icl_oct + (size_t)oct * Ci;
  int slot = -1;
  bool done = false;

  for (int k = 0; k < I && !done; ++k) {
    const int inst = __ldg(io + k);
    const bool in_inst = live && enters(inst_bounds, I, inst, ix, iy, iz,
                                        oxix, oyiy, oziz, t_cur);
    if (!__syncthreads_or(in_inst)) continue;

    // the ray in the instance's mesh-local space, moved once
    float lox = 0.f, loy = 0.f, loz = 0.f, ldx = 0.f, ldy = 0.f, ldz = 0.f;
    if (in_inst) {
      const float* a = inst_woop + (size_t)inst * 16;
      lox = ox * __ldg(a + 0) + oy * __ldg(a + 4) + oz * __ldg(a + 8) + __ldg(a + 12);
      loy = ox * __ldg(a + 1) + oy * __ldg(a + 5) + oz * __ldg(a + 9) + __ldg(a + 13);
      loz = ox * __ldg(a + 2) + oy * __ldg(a + 6) + oz * __ldg(a + 10) + __ldg(a + 14);
      ldx = dx * __ldg(a + 0) + dy * __ldg(a + 4) + dz * __ldg(a + 8);
      ldy = dx * __ldg(a + 1) + dy * __ldg(a + 5) + dz * __ldg(a + 9);
      ldz = dx * __ldg(a + 2) + dy * __ldg(a + 6) + dz * __ldg(a + 10);
    }

    // the next position of [pos, end) whose box some thread enters, one
    // vote a position (uniform over the CTA), and this thread's own test
    const int end = __ldg(icl_start + inst + 1);
    auto next_visit = [&](int pos, bool* mine) {
      for (; pos < end; ++pos) {
        const bool e = in_inst && live && enters(bo, Ci, pos, ix, iy, iz,
                                                 oxix, oyiy, oziz, t_cur);
        if (__syncthreads_or(e)) { *mine = e; return pos; }
      }
      *mine = false;
      return end;
    };

    bool h_cur;
    int cur = next_visit(__ldg(icl_start + inst), &h_cur);
    int c_cur = cur < end ? __ldg(co + cur) : -1;
    stage_async(woop[0], tris, c_cur >= 0 ? __ldg(cl_map + c_cur) : -1);
    int b = 0;
    while (cur < end) {
      // the next visit is voted on against t as it stands and its block
      // copied while this one is tested
      bool h_nxt;
      const int nxt = next_visit(cur + 1, &h_nxt);
      const int c_nxt = nxt < end ? __ldg(co + nxt) : -1;
      stage_async(woop[b ^ 1], tris, c_nxt >= 0 ? __ldg(cl_map + c_nxt) : -1);
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
      __syncthreads();  // the current block has landed, every thread's part

      if (h_cur && live) {
        woop_lanes<kAnyHit>(woop[b], lox, loy, loz, ldx, ldy, ldz, t_cur, slot,
                            c_cur * kLanes);
        if (kAnyHit && slot >= 0) {  // occluded: retire
          live = false;
          t_cur = -kBig;
        }
      }
      // every thread is done with this buffer before the copy after next
      // lands in it; with no live ray left (any hit) the CTA leaves
      if (!__syncthreads_or(live)) { done = true; break; }
      cur = nxt;
      c_cur = c_nxt;
      h_cur = h_nxt;
      b ^= 1;
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
  }
  if (valid) {
    t_out[idx] = t_cur;
    slot_out[idx] = slot;
  }
}

}  // namespace

extern "C" {

// Launches B1 (any_hit == 0) or B2 on `stream` over the P chunks of a flat
// (P = 1) or partitioned pool. Returns cudaGetLastError() right after the
// launch (0 on success).
int hydra_cluster_traverse(const float* rays, const float* bounds_oct,
                           const float* tris, const int* perm, float* t_out,
                           int* slot_out, int n_rays, int r_blk, int Cp,
                           int P, int any_hit, void* stream) {
  if (n_rays <= 0) return 0;
  if (r_blk <= 0 || r_blk > kMaxBlock || Cp <= 0 || P <= 0)
    return (int)cudaErrorInvalidValue;
  const int grid = (n_rays + r_blk - 1) / r_blk;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (any_hit)
    cluster_traverse_kernel<true><<<grid, r_blk, 0, s>>>(
        rays, bounds_oct, tris, perm, t_out, slot_out, n_rays, r_blk, Cp, P);
  else
    cluster_traverse_kernel<false><<<grid, r_blk, 0, s>>>(
        rays, bounds_oct, tris, perm, t_out, slot_out, n_rays, r_blk, Cp, P);
  return (int)cudaGetLastError();
}

// Launches B3 in either hit mode on `stream` over an instanced pool of Ci
// instance-clusters and I instances. Returns cudaGetLastError() right after
// the launch (0 on success).
int hydra_inst_traverse(const float* rays, const float* tris,
                        const int* cl_map, const float* inst_woop,
                        const float* inst_bounds, const int* inst_oct_perm,
                        const int* icl_oct, const float* icl_bounds,
                        const int* icl_start, float* t_out, int* slot_out,
                        int n_rays, int r_blk, int Ci, int I, int any_hit,
                        void* stream) {
  if (n_rays <= 0) return 0;
  if (r_blk <= 0 || r_blk > kMaxBlock || Ci <= 0 || I <= 0)
    return (int)cudaErrorInvalidValue;
  const int grid = (n_rays + r_blk - 1) / r_blk;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (any_hit)
    inst_traverse_kernel<true><<<grid, r_blk, 0, s>>>(
        rays, tris, cl_map, inst_woop, inst_bounds, inst_oct_perm, icl_oct,
        icl_bounds, icl_start, t_out, slot_out, n_rays, r_blk, Ci, I);
  else
    inst_traverse_kernel<false><<<grid, r_blk, 0, s>>>(
        rays, tris, cl_map, inst_woop, inst_bounds, inst_oct_perm, icl_oct,
        icl_bounds, icl_start, t_out, slot_out, n_rays, r_blk, Ci, I);
  return (int)cudaGetLastError();
}

const char* hydra_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
