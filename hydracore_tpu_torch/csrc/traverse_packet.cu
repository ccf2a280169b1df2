// Packet traversal of the 8-wide BVH for Hopper: kernel B4, closest hit and
// any hit.
//
// Replaces: hydracore_tpu/ops/traverse_packet.py, _make_kernel as launched
// by _packet_traverse (the Pallas TPU kernel), with any_hit_mode False and
// True.
//
// Contract (the same as the TPU kernel and the plain PyTorch twin
// packet_traverse_plain in hydracore_tpu_torch/ops/traverse_packet.py):
//   rays   (n_rays, 8) f32 [ox oy oz dx dy dz t_lim active], grouped in
//          packets of 32 consecutive rays
//   nodes  (Np, 128) f32: 8 children x 16 floats [bmin.xyz bmax.xyz payload
//          pad]; the payload, bitcast to i32, is a node row (>= 0), a leaf
//          -(block + 1), or kEmpty for an unused child slot
//   tris   (Bp, 128) f32: 8 triangles x 16 floats [v0 e1 e2 pad]
//   t_out  (n_rays,) f32 closest t, 3e38 on a miss
//   u_out, v_out (n_rays,) f32 barycentrics of the hit as this kernel
//          computes them (the path has no refinement epilogue), 0 on a miss
//   slot_out (n_rays,) i32 block * 8 + k, -1 on a miss; in any-hit mode
//          >= 0 where some triangle lies in (1e-5, t_lim)
//   visits_out (n_packets,) i32 entries the packet popped; kMaxVisits when
//          the safety bound cut the walk short
// The packet shares one depth-first walk: an entry is popped, a node pushes
// every child that some ray of the packet may still hit (children 0..7 in
// order, so child 7 is popped first), a leaf tests its 8 triangles against
// every ray of the packet. A later triangle wins only with t < the ray's
// current t, so among equal t the first met in the walk's order wins.
// Inactive rays carry t_act = -3e38: they never hit and never widen a vote.
//
// Design: a packet is one warp. The TPU kernel's packet is 1024 rays because
// its vector unit is 8 x 128 wide and scalar work is paid once per packet;
// here the vote that decides a push is one __ballot_sync, the stack is 384
// ints of shared memory per warp, and there is no CTA barrier anywhere: the
// 8 warps of a CTA walk independently. A small packet matters on this path:
// bounce wavefronts arrive unsorted, and the union of the subtrees that 32
// incoherent rays enter is far smaller than that of 1024. Node and triangle
// rows are read through the read-only path at warp-uniform addresses (one
// transaction per row segment, served by L1/L2: the pools are a few MiB).
// Empty child slots are skipped by their payload: their boxes are NaN, and
// fminf/fmaxf would drop the NaN and could let the slab test pass.
//
// Bound on the H100: a ray pays a slab test for each of the 8 children of
// every node it enters and a Moller-Trumbore for each of the 8 triangles of
// every leaf it enters, some 25 to 50 f32 operations each, against 32 bytes
// of ray in and 16 out and the pools read once. A single ray enters few
// nodes and leaves of a tree, so at 2^18 rays the bytes are the larger part
// (chip_smoke.py counts both from the run's rays); what the kernel pays
// beyond either is the packet: the tests of nodes and leaves that only its
// other rays needed. What the design does about it: the smallest packet the
// hardware votes over, and a slab test against each ray's own current t, so
// a subtree behind every ray's hit is dropped.
//
// Numerics: built without --use_fast_math (IEEE division for the safe
// inverse of the direction and for 1/det) and with --fmad=false, so products
// and sums round like the twin's separate multiply and add
// (utils/build.py holds the flags).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kBig = 3.0e38f;
constexpr int kPacket = 32;          // rays per packet: one warp
constexpr int kWarps = 8;            // packets per CTA
constexpr int kStackDepth = 384;     // >= 7 * wide-tree depth + 9
constexpr int kMaxVisits = 65536;    // safety bound on popped entries
constexpr int kEmpty = -(1 << 30);   // payload of an unused child slot
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float safe_inv(float d) {
  const float eps = 1e-12f;
  const float e = fabsf(d) < eps ? (d < 0.0f ? -eps : eps) : d;
  return 1.0f / e;
}

template <bool kAnyHit>
__global__ void __launch_bounds__(kWarps * kPacket)
packet_traverse_kernel(const float* __restrict__ rays,
                       const float* __restrict__ nodes,
                       const float* __restrict__ tris,
                       float* __restrict__ t_out, float* __restrict__ u_out,
                       float* __restrict__ v_out, int* __restrict__ slot_out,
                       int* __restrict__ visits_out, int n_rays) {
  __shared__ int stacks[kWarps][kStackDepth];

  const int warp = threadIdx.x / kPacket;
  const int lane = threadIdx.x % kPacket;
  const int packet = blockIdx.x * kWarps + warp;
  const int idx = packet * kPacket + lane;
  // a whole warp past the end leaves together; a ragged last packet keeps
  // its idle lanes for the votes
  if (packet * kPacket >= n_rays) return;
  const bool valid = idx < n_rays;
  int* stack = stacks[warp];

  float ox = 0.f, oy = 0.f, oz = 0.f, dx = 1.f, dy = 1.f, dz = 1.f;
  float t_lim = 0.f;
  bool act = false;
  if (valid) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(rays) + 2 * (size_t)idx);
    const float4 b = __ldg(reinterpret_cast<const float4*>(rays) + 2 * (size_t)idx + 1);
    ox = a.x; oy = a.y; oz = a.z; dx = a.w;
    dy = b.x; dz = b.y; t_lim = b.z;
    act = b.w > 0.0f;
  }
  const float ix = safe_inv(dx), iy = safe_inv(dy), iz = safe_inv(dz);
  const float t_act = act ? t_lim : -kBig;

  float t_best = fminf(t_lim, kBig);
  float u_best = 0.f, v_best = 0.f;
  int slot_best = -1;

  if (lane == 0) stack[0] = 0;
  __syncwarp();
  int sp = 1;
  int it = 0;

  while (sp > 0 && it < kMaxVisits) {
    const int ent = stack[sp - 1];  // the same word for every lane
    --sp;
    ++it;
    float t_cap = fminf(t_best, t_act);
    if (ent >= 0) {
      const float* row = nodes + (size_t)ent * 128;
      // every lane has read `ent` before lane 0 may overwrite its word
      __syncwarp();
      for (int c = 0; c < 8; ++c) {
        const float* ch = row + c * 16;
        const int pay = __float_as_int(__ldg(ch + 6));
        if (pay == kEmpty) continue;  // warp-uniform
        const float tx0 = (__ldg(ch + 0) - ox) * ix;
        const float tx1 = (__ldg(ch + 3) - ox) * ix;
        const float ty0 = (__ldg(ch + 1) - oy) * iy;
        const float ty1 = (__ldg(ch + 4) - oy) * iy;
        const float tz0 = (__ldg(ch + 2) - oz) * iz;
        const float tz1 = (__ldg(ch + 5) - oz) * iz;
        const float tn = fmaxf(fmaxf(fminf(tx0, tx1), fminf(ty0, ty1)),
                               fminf(tz0, tz1));
        const float tf = fminf(fminf(fmaxf(tx0, tx1), fmaxf(ty0, ty1)),
                               fmaxf(tz0, tz1));
        const bool hit = (tf >= fmaxf(tn, 0.0f)) && (tn < t_cap);
        if (__ballot_sync(kFull, hit) != 0u) {
          if (lane == 0) stack[sp] = pay;
          ++sp;
        }
      }
      sp = min(sp, kStackDepth - 9);
      __syncwarp();  // lane 0's pushes are visible to the next pop
    } else {
      const int blk = -ent - 1;
      const float* row = tris + (size_t)blk * 128;
      for (int k = 0; k < 8; ++k) {
        const float* tr = row + k * 16;
        const float v0x = __ldg(tr + 0), v0y = __ldg(tr + 1), v0z = __ldg(tr + 2);
        const float e1x = __ldg(tr + 3), e1y = __ldg(tr + 4), e1z = __ldg(tr + 5);
        const float e2x = __ldg(tr + 6), e2y = __ldg(tr + 7), e2z = __ldg(tr + 8);
        const float px = dy * e2z - dz * e2y;
        const float py = dz * e2x - dx * e2z;
        const float pz = dx * e2y - dy * e2x;
        const float det = e1x * px + e1y * py + e1z * pz;
        const float inv = fabsf(det) > 1e-12f ? 1.0f / det : 0.0f;
        const float sx = ox - v0x, sy = oy - v0y, sz = oz - v0z;
        const float u = (sx * px + sy * py + sz * pz) * inv;
        const float qx = sy * e1z - sz * e1y;
        const float qy = sz * e1x - sx * e1z;
        const float qz = sx * e1y - sy * e1x;
        const float v = (dx * qx + dy * qy + dz * qz) * inv;
        const float t = (e2x * qx + e2y * qy + e2z * qz) * inv;
        const bool hit = inv != 0.0f && u >= 0.0f && v >= 0.0f &&
                         u + v <= 1.0f && t > 1e-5f && t < t_cap;
        if (hit) {
          t_best = t;
          slot_best = blk * 8 + k;
          u_best = u;
          v_best = v;
        }
        t_cap = fminf(t_cap, t_best);
      }
      if (kAnyHit) {
        // the packet is done once every active ray is occluded
        if (!__any_sync(kFull, act && slot_best < 0)) sp = 0;
      }
    }
  }

  if (valid) {
    t_out[idx] = slot_best >= 0 ? t_best : kBig;
    u_out[idx] = u_best;
    v_out[idx] = v_best;
    slot_out[idx] = slot_best;
  }
  if (lane == 0) visits_out[packet] = it;
}

}  // namespace

extern "C" {

// Launches B4 on `stream`: closest hit (any_hit == 0) or any hit over the
// packed 8-wide BVH. Returns cudaGetLastError() right after the launch (0 on
// success).
int hydra_packet_traverse(const float* rays, const float* nodes,
                          const float* tris, float* t_out, float* u_out,
                          float* v_out, int* slot_out, int* visits_out,
                          int n_rays, int any_hit, void* stream) {
  if (n_rays <= 0) return 0;
  const int packets = (n_rays + kPacket - 1) / kPacket;
  const int grid = (packets + kWarps - 1) / kWarps;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (any_hit)
    packet_traverse_kernel<true><<<grid, kWarps * kPacket, 0, s>>>(
        rays, nodes, tris, t_out, u_out, v_out, slot_out, visits_out, n_rays);
  else
    packet_traverse_kernel<false><<<grid, kWarps * kPacket, 0, s>>>(
        rays, nodes, tris, t_out, u_out, v_out, slot_out, visits_out, n_rays);
  return (int)cudaGetLastError();
}

int hydra_packet_size(void) { return kPacket; }
int hydra_packet_stack_depth(void) { return kStackDepth; }
int hydra_packet_max_visits(void) { return kMaxVisits; }

const char* hydra_packet_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
