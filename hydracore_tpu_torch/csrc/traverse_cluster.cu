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
//   tris      (P, Cp, 4, 384) f32 Woop rows x, y, z, c over lanes [u | v | w]
//             of the P chunks of Cp clusters (a flat pool is P = 1)
//   t_out     (n_rays,) f32 best hit t; on a miss min(t_lim, BIG), -BIG for
//             inactive rays, and -BIG for occluded rays in any-hit mode
//   slot_out  (n_rays,) i32 (chunk * Cp + true_cluster) * 128 + lane, -1 on
//             a miss
// All three (hydra_cluster_traverse) read the pool through an upper level
// (ops/traverse_cluster.py:LEVEL_TABLES): lvl_bounds (8, N) f32 the AABBs
// of its N boxes, lvl_oct_perm (8, N) i32 per octant the boxes in one
// front-to-back order (B1/B2; B3 has none: (8, 0)), lvl_members (8, M)
// i32 per octant the members
// grouped by box (box u at [lvl_start[u], lvl_start[u + 1])), each group
// front to back, lvl_member_bounds (8, 8, M) f32 their AABBs in that
// order, and a tree over the N boxes: lvl_nodes (8, Nn * kTreeFan) i32 per
// octant the children of each of Nn inner nodes front to back (box u < N,
// inner node j as N + j, -1 none; node 0 the root) and lvl_node_bounds
// (8, Nn) f32 their AABBs. B1/B2's boxes (bvh/clusters.py:group_tables)
// are groups: runs of at most CL_GROUP (8) consecutive real clusters of one
// chunk, each box the union of its clusters', the groups of all chunks in
// one order (by their nearest cluster's centre key: a group comes up where
// its first cluster would in a walk over every cluster), and no tree
// (Nn = 0); a member is a pool block, chunk * Cp + cluster. Instanced (B3):
// the boxes are the instances' world AABBs under a tree
// (bvh/instanced.py:instance_tables), a member an instance-cluster; tris is
// the shared pool (Cpool, 4, 384) in mesh-local space, cl_map (2, Ci) i32
// names each instance-cluster's [pool block; instance] and inst_woop
// (I, 4, 4) f32 holds A^T, A the affine world -> mesh-local matrix of the
// instance. The slot's cluster is the member.
// A hit needs t = -ow/dw with t > 1e-5, t < current t, u >= 0, v >= 0,
// u + v <= 1 (_mt_block). Unlike the TPU kernel, t is exact: no lane bits in
// its mantissa.
//
// Design, one two-level walk for all three (two_level_kernel): one CTA
// per ray block, one thread per ray. B1/B2's CTA walks every group of
// clusters of all chunks in the octant's front-to-back order; B3's walks
// the tree over the instances from its root, with a stack of ids that
// every thread keeps alike (each decision is a CTA vote). Each popped box
// (group, node, instance) is one vote: each live thread slab-tests it
// against its own current t, and one __syncthreads_or decides whether the
// CTA goes below it. An entered inner node pushes its children far to
// near, so the nearest is walked first, and each is tested when popped,
// against the t its walk has shortened so far (testing a node's children
// in one pass with one vote on their mask took 5-14% longer on the H100:
// a child pushed on an older t is walked even where the live t rules it
// out). An entered group or instance has its members walked. So closest
// hit also drops whole groups (instances, subtrees) that lie behind every
// ray's hit, across chunks, and a block without a live ray leaves at its
// first vote (B3: the root). Exact: each box lies inside its node's (the
// float32 union of its children's) and the slab test is monotone under
// rounding, so a ray that enters an instance box enters every node above
// it, and the tree drops no instance that a vote on every instance would
// enter. Its bound: the stack holds at most depth x (kTreeFan - 1) + 1
// ids, which the build keeps within kTreeStack (64; the sphereflake's
// 7,382 instances need 30). Inside an entered box the CTA walks only its
// members (walk_members): one vote per member on the
// per-thread box test against the current t, and for each voted member the
// 128-lane Moller-Trumbore in Woop form by the threads whose test passed (a
// broadcast read of shared memory, no bank conflicts). The member's 6 KiB
// Woop block is staged asynchronously into one of two shared buffers
// (cp.async, 16 bytes a thread): the vote for the next member is taken
// against each ray's t as it stands and its block copied while the current
// block's 128 lanes are tested; in closest-hit mode a thread then tests the
// member's box once more against the live t before its Moller-Trumbore, so
// the early vote costs no Woop test that the t from the block before rules
// out, and the nearest hit is the same. Any hit retires a thread at its
// first hit; the CTA leaves when no thread is live. Each member box lies inside its upper
// box and the slab test is monotone under rounding, so the cull changes no
// box test: only the visit order differs from a walk over every cluster,
// and with it the pick among equal t.
//
// Partitioned pools: the TPU chains one launch per chunk because a chunk is
// what fits its on-chip memory. Here the pool stays in device memory and L2
// and one launch walks the groups of every chunk in one front-to-back
// order, with the current t (and the any-hit retirement) in registers: a
// group never straddles a chunk, so the slot keeps its chunk-major form.
//
// B3 only: a thread that entered an instance box moves its ray into
// mesh-local space once per instance, [o 1] A^T and [d 0] A^T with the
// direction left unnormalized, so t stays the world ray parameter; the
// member box tests stay in world space, the Woop test runs on the pool
// block as it is. (The TPU kernel walks every instance-cluster and folds
// A^T into the staged block: the same function, rounded differently. The
// twin moves the ray as here.)
//
// Bound on the H100: operations. A visit costs ~30 f32 operations per lane
// (128 lanes per cluster) against ~40 bytes of ray in and out, far above
// the card's 20 operations per byte of f32 balance; the pool (a few MiB)
// stays in L2. What the design does about it: the upper level cuts the
// positions a block walks (a box test and a CTA vote each, entered or not)
// from every cluster of every chunk to the groups (B3: the root and the
// children of the nodes its rays enter, ~50 of the sphereflake's 7,382
// instances a primary block) plus the members of the boxes its rays enter
// (chip_smoke.py phases 3, 6 and 7 log them; on the card the counter
// traverse_cluster.b3_upper_votes counts B3's votes); the
// member test prunes clusters behind each ray's current hit, so a ray runs
// the Moller-Trumbore only on clusters it may still hit; a warp still steps
// through a cluster when any of its threads needs it, which costs
// divergence (idle lanes) on incoherent bounce rays, and the ray sort by
// (octant, origin Morton) before each bounce keeps a CTA's rays together.
// What remains is mostly the Woop test of every cluster some ray of the
// block enters, and the busiest blocks of a wavefront set its time.
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
// children of a node of B3's tree (bvh/instanced.py:TREE_FAN) and the
// entries of its walk's stack (TREE_STACK, which the tree's build checks)
constexpr int kTreeFan = 4;
constexpr int kTreeStack = 64;

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

// This thread's ray (origin o, direction d) and its t limit as the current
// t; an inactive or missing ray (the ragged last block) is not live and
// keeps t = -kBig. Returns the block's direction octant, from its first ray.
__device__ __forceinline__ int load_ray(const float* __restrict__ rays,
                                        int first, int idx, bool valid,
                                        float (&o)[3], float (&d)[3],
                                        float& t_cur, bool& live) {
  o[0] = o[1] = o[2] = 0.f;
  d[0] = d[1] = d[2] = 1.f;
  t_cur = -kBig;
  live = false;
  if (valid) {
    const float* r = rays + (size_t)idx * 8;
    o[0] = r[0]; o[1] = r[1]; o[2] = r[2];
    d[0] = r[3]; d[1] = r[4]; d[2] = r[5];
    if (r[7] > 0.0f) {
      t_cur = r[6] < kBig ? r[6] : kBig;
      live = true;
    }
  }
  const float* r0 = rays + (size_t)first * 8;
  return (r0[3] > 0.0f) + 2 * (r0[4] > 0.0f) + 4 * (r0[5] > 0.0f);
}

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

// The lower level of both two-level walks: positions [beg, end) of the
// octant's member order `co` (boxes `bo`, row stride `stride`) that belong
// to one entered upper box (`in_up`: this thread entered it). One vote a
// position on the per-thread box test against the current t (uniform over
// the CTA); each voted member's Woop block (pool block blk_of[c], or c
// itself when blk_of is null) is staged into the other buffer while the
// current one is tested against (w_o, w_d), slot c * 128 + lane. Returns
// true when no thread of the CTA is live any more (any hit): the CTA leaves.
template <bool kAnyHit>
__device__ __forceinline__ bool walk_members(
    float (*woop)[kWoop], const float* __restrict__ tris,
    const int* __restrict__ blk_of, const int* __restrict__ co,
    const float* __restrict__ bo, int stride, int beg, int end, bool in_up,
    float ix, float iy, float iz, float oxix, float oyiy, float oziz,
    float wox, float woy, float woz, float wdx, float wdy, float wdz,
    bool& live, float& t_cur, int& slot) {
  // the next position of [pos, end) whose box some thread enters, and this
  // thread's own test
  auto next_visit = [&](int pos, bool* mine) {
    for (; pos < end; ++pos) {
      const bool e = in_up && live && enters(bo, stride, pos, ix, iy, iz,
                                             oxix, oyiy, oziz, t_cur);
      if (__syncthreads_or(e)) { *mine = e; return pos; }
    }
    *mine = false;
    return end;
  };
  auto block = [&](int c) {
    return c < 0 ? -1 : (blk_of != nullptr ? __ldg(blk_of + c) : c);
  };

  bool h_cur;
  int cur = next_visit(beg, &h_cur);
  int c_cur = cur < end ? __ldg(co + cur) : -1;
  stage_async(woop[0], tris, block(c_cur));
  int b = 0;
  bool done = false;
  while (cur < end) {
    // the next visit is voted on against t as it stands and its block
    // copied while this one is tested
    bool h_nxt;
    const int nxt = next_visit(cur + 1, &h_nxt);
    const int c_nxt = nxt < end ? __ldg(co + nxt) : -1;
    stage_async(woop[b ^ 1], tris, block(c_nxt));
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    __syncthreads();  // the current block has landed, every thread's part

    // the vote came before the previous block's test shortened t: a
    // closest-hit thread tests its box again against the live t, so that it
    // runs the Moller-Trumbore only where a nearer hit may still lie (any
    // hit keeps t_lim while live: the first test stands)
    if (h_cur && live &&
        (kAnyHit || enters(bo, stride, cur, ix, iy, iz, oxix, oyiy, oziz,
                           t_cur))) {
      woop_lanes<kAnyHit>(woop[b], wox, woy, woz, wdx, wdy, wdz, t_cur, slot,
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
  return done;
}

// ---- B1 / B2 / B3: the two-level walk. kInst (B3) moves each ray into an
// entered instance's mesh-local space and reads a member's pool block
// through cl_map; B1/B2's members are pool blocks themselves.

// One entered upper box u of the walk (in_up: this thread entered it): its
// members [lvl_start[u], lvl_start[u + 1]), B3's after the ray's move into
// instance u's mesh-local space. Returns true when the CTA is done (any hit:
// no live thread left).
template <bool kAnyHit, bool kInst>
__device__ __forceinline__ bool walk_box(
    float (*woop)[kWoop], const float* __restrict__ tris,
    const int* __restrict__ cl_map, const float* __restrict__ inst_woop,
    const int* __restrict__ co, const float* __restrict__ bo,
    const int* __restrict__ lvl_start, int M, int u, bool in_up,
    const float (&o)[3], const float (&d)[3], float ix, float iy, float iz,
    float oxix, float oyiy, float oziz, bool& live, float& t_cur, int& slot) {
  // the ray the members' Woop blocks are tested against: B3 moves it once
  // into the instance's mesh-local space (in scalars: an array cost B3
  // registers and a spill)
  float lox = o[0], loy = o[1], loz = o[2], ldx = d[0], ldy = d[1], ldz = d[2];
  if (kInst) {
    lox = 0.f; loy = 0.f; loz = 0.f; ldx = 0.f; ldy = 0.f; ldz = 0.f;
    if (in_up) {
      const float* a = inst_woop + (size_t)u * 16;
      lox = o[0] * __ldg(a + 0) + o[1] * __ldg(a + 4) + o[2] * __ldg(a + 8) + __ldg(a + 12);
      loy = o[0] * __ldg(a + 1) + o[1] * __ldg(a + 5) + o[2] * __ldg(a + 9) + __ldg(a + 13);
      loz = o[0] * __ldg(a + 2) + o[1] * __ldg(a + 6) + o[2] * __ldg(a + 10) + __ldg(a + 14);
      ldx = d[0] * __ldg(a + 0) + d[1] * __ldg(a + 4) + d[2] * __ldg(a + 8);
      ldy = d[0] * __ldg(a + 1) + d[1] * __ldg(a + 5) + d[2] * __ldg(a + 9);
      ldz = d[0] * __ldg(a + 2) + d[1] * __ldg(a + 6) + d[2] * __ldg(a + 10);
    }
  }
  return walk_members<kAnyHit>(woop, tris, kInst ? cl_map : nullptr, co, bo, M,
                               __ldg(lvl_start + u), __ldg(lvl_start + u + 1),
                               in_up, ix, iy, iz, oxix, oyiy, oziz, lox, loy,
                               loz, ldx, ldy, ldz, live, t_cur, slot);
}

template <bool kAnyHit, bool kInst>
__global__ void __launch_bounds__(kMaxBlock)
two_level_kernel(const float* __restrict__ rays,
                 const float* __restrict__ tris,
                 const int* __restrict__ cl_map,
                 const float* __restrict__ inst_woop,
                 const float* __restrict__ lvl_bounds,
                 const int* __restrict__ lvl_oct_perm,
                 const int* __restrict__ lvl_members,
                 const float* __restrict__ lvl_member_bounds,
                 const int* __restrict__ lvl_start,
                 const int* __restrict__ lvl_nodes,
                 const float* __restrict__ lvl_node_bounds,
                 float* __restrict__ t_out,
                 int* __restrict__ slot_out,
                 unsigned long long* __restrict__ votes_out,
                 int n_rays, int r_blk, int M, int N, int Nn) {
  __shared__ __align__(16) float woop[2][kWoop];

  const int first = blockIdx.x * r_blk;
  const int idx = first + threadIdx.x;
  const bool valid = idx < n_rays;  // ragged last block
  float o[3], d[3], t_cur;
  bool live;
  const int oct = load_ray(rays, first, idx, valid, o, d, t_cur, live);
  const float ix = safe_inv(d[0]), iy = safe_inv(d[1]), iz = safe_inv(d[2]);
  const float oxix = o[0] * ix, oyiy = o[1] * iy, oziz = o[2] * iz;

  const float* bo = lvl_member_bounds + (size_t)oct * 8 * M;
  const int* co = lvl_members + (size_t)oct * M;
  int slot = -1;

  if constexpr (kInst) {
    // B3: the tree over the instances from its root (inner node j is id
    // N + j, an instance its own id). Each popped id is one vote on its
    // box against each thread's live t; an entered inner node pushes its
    // children far to near (lvl_nodes holds them front to back), an
    // entered instance walks its members. The stack is the same in every
    // thread (every decision is a CTA vote), so each thread keeps it (one
    // in shared memory, every thread writing the same ids, ran within 4%
    // either way on the H100).
    const int* kids = lvl_nodes + (size_t)oct * Nn * kTreeFan;
    int stack[kTreeStack];
    int sp = 0;
    stack[sp++] = N;  // the root: a block without a live ray leaves here
    unsigned votes = 0;
    bool done = false;
    while (sp > 0 && !done) {
      const int id = stack[--sp];
      const bool inner = id >= N;
      const bool in_box =
          live && enters(inner ? lvl_node_bounds : lvl_bounds,
                         inner ? Nn : N, inner ? id - N : id, ix, iy, iz,
                         oxix, oyiy, oziz, t_cur);
      ++votes;
      if (!__syncthreads_or(in_box)) continue;
      if (inner) {
        const int* k = kids + (size_t)(id - N) * kTreeFan;
        for (int c = kTreeFan - 1; c >= 0; --c) {
          const int child = __ldg(k + c);
          if (child < 0) continue;
          if (sp == kTreeStack) __trap();  // deeper than the build allows
          stack[sp++] = child;
        }
        continue;
      }
      done = walk_box<kAnyHit, true>(woop, tris, cl_map, inst_woop, co, bo,
                                     lvl_start, M, id, in_box, o, d, ix, iy,
                                     iz, oxix, oyiy, oziz, live, t_cur, slot);
    }
    if (votes_out != nullptr && threadIdx.x == 0)
      atomicAdd(votes_out, (unsigned long long)votes);
  } else {
    // B1/B2: every group in the octant's front-to-back order; a block
    // without a live ray (the dead tail of a sorted wavefront) leaves at
    // once
    const int* uo = lvl_oct_perm + (size_t)oct * N;
    bool done = !__syncthreads_or(live);
    for (int k = 0; k < N && !done; ++k) {
      const int u = __ldg(uo + k);
      const bool in_up = live && enters(lvl_bounds, N, u, ix, iy, iz, oxix,
                                        oyiy, oziz, t_cur);
      if (!__syncthreads_or(in_up)) continue;
      done = walk_box<kAnyHit, false>(woop, tris, cl_map, inst_woop, co, bo,
                                      lvl_start, M, u, in_up, o, d, ix, iy,
                                      iz, oxix, oyiy, oziz, live, t_cur, slot);
    }
  }
  if (valid) {
    t_out[idx] = t_cur;
    slot_out[idx] = slot;
  }
}

}  // namespace

extern "C" {

// Launches the two-level walk on `stream` over an upper level of N boxes
// and M members: B1 (any_hit == 0) or B2 over a flat or partitioned pool
// (cl_map and inst_woop null, no tree: Nn == 0), B3 in either hit mode over
// an instanced one, walking its tree of Nn inner nodes of kTreeFan
// children.
// votes, where not null, gains the upper-level votes B3's blocks took.
// Returns cudaGetLastError() right after the launch (0 on success).
int hydra_cluster_traverse(const float* rays, const float* tris,
                           const int* cl_map, const float* inst_woop,
                           const float* lvl_bounds, const int* lvl_oct_perm,
                           const int* lvl_members,
                           const float* lvl_member_bounds,
                           const int* lvl_start, const int* lvl_nodes,
                           const float* lvl_node_bounds, float* t_out,
                           int* slot_out, unsigned long long* votes,
                           int n_rays, int r_blk, int M, int N, int Nn,
                           int any_hit, void* stream) {
  if (n_rays <= 0) return 0;
  const bool inst = cl_map != nullptr;
  if (r_blk <= 0 || r_blk > kMaxBlock || M < 0 || N < 0 ||
      (cl_map == nullptr) != (inst_woop == nullptr) ||
      (inst ? Nn < 1 || lvl_nodes == nullptr ||
                  lvl_node_bounds == nullptr
            : Nn != 0))
    return (int)cudaErrorInvalidValue;
  const int grid = (n_rays + r_blk - 1) / r_blk;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto go = [&](auto kernel) {
    kernel<<<grid, r_blk, 0, s>>>(rays, tris, cl_map, inst_woop, lvl_bounds,
                                  lvl_oct_perm, lvl_members,
                                  lvl_member_bounds, lvl_start, lvl_nodes,
                                  lvl_node_bounds, t_out, slot_out, votes,
                                  n_rays, r_blk, M, N, Nn);
  };
  if (inst)
    any_hit ? go(two_level_kernel<true, true>)
            : go(two_level_kernel<false, true>);
  else
    any_hit ? go(two_level_kernel<true, false>)
            : go(two_level_kernel<false, false>);
  return (int)cudaGetLastError();
}

const char* hydra_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
