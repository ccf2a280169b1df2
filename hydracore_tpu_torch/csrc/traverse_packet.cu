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
// Design: a packet is one warp of 32 rays (the TPU kernel's 1024 follow its
// 8 x 128 vector unit; on bounce wavefronts, which arrive unsorted, the
// union of the subtrees 32 incoherent rays enter is far smaller than that
// of 1024). Three parts:
//  * Persistent warps over a packet queue. The grid is the SMs times the
//    CTAs an SM holds (the occupancy query, once per device and
//    instantiation), at most one warp per packet; a warp takes the next
//    packet from a global counter (lane 0's atomicAdd, shared by a shuffle)
//    until none is left, so a busy packet holds one warp slot and no CTA's
//    other seven. The queue is two words of device memory, [next packet,
//    warps done]: the last warp out puts both back to 0, so a launch leaves
//    the queue as it found it, with no memset of its own, and a CUDA graph
//    may replay it. Launches of B4 on one card must therefore not overlap:
//    they share the queue (the path tracer's launches are stream-ordered).
//  * A warp-wide, double-buffered row fetch. A row of pkt_nodes or pkt_tris
//    is 512 bytes: each lane copies 16 of them with one cp.async into the
//    warp's shared buffer, and the lanes read boxes and triangles from it as
//    float4 broadcasts (in place of 56 scalar loads a node and 72 a leaf).
//    The next entry's row is copied into the other buffer while the current
//    one is tested: at a leaf the next entry is the stack top, known at the
//    pop; at a node it is known after the vote.
//  * One vote a node. Each lane forms its 8 hit bits; one __reduce_or_sync
//    gives the packet's push mask; lanes 0..7 store their child's payload at
//    sp + popc(mask & ((1 << c) - 1)) at once, so the stack holds what eight
//    pushes in child order would leave.
// The stack is 384 ints of shared memory per warp; no CTA barrier anywhere.
// Empty child slots are skipped by their payload: their boxes are NaN, and
// fminf/fmaxf would drop the NaN and could let the slab test pass.
//
// Bound on the H100: a ray pays a slab test for each of the 8 children of
// every node it enters and a Moller-Trumbore for each of the 8 triangles of
// every leaf it enters, some 25 to 50 f32 operations each, against 32 bytes
// of ray in and 16 out and the pools read once. A single ray enters few
// nodes and leaves of a tree, so at 2^18 rays the bytes are the larger part
// (chip_smoke.py counts both from the run's rays); what the kernel pays
// beyond either is the packet (the tests of nodes and leaves that only its
// other rays needed) and the latency of a walk that is one dependent chain
// per packet. What the design does about it: the smallest packet the
// hardware votes over, a slab test against each ray's own current t, the
// next row in flight while the current one is tested, and no packet that
// keeps other warps waiting.
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
constexpr int kWarps = 8;            // warps per CTA
constexpr int kStackDepth = 384;     // >= 7 * wide-tree depth + 9
constexpr int kMaxVisits = 65536;    // safety bound on popped entries
constexpr int kEmpty = -(1 << 30);   // payload of an unused child slot
constexpr int kRow = 128;            // floats a row of nodes or tris
constexpr int kMaxDevices = 64;
constexpr unsigned kFull = 0xffffffffu;

// [next packet, warps done] of the running launch; 0 between launches
__device__ unsigned g_queue[2];

__device__ __forceinline__ float safe_inv(float d) {
  const float eps = 1e-12f;
  const float e = fabsf(d) < eps ? (d < 0.0f ? -eps : eps) : d;
  return 1.0f / e;
}

__device__ __forceinline__ unsigned sm_id() {
  unsigned r;
  asm volatile("mov.u32 %0, %%smid;" : "=r"(r));
  return r;
}

// The row of entry `ent`: a node row (ent >= 0) or a leaf's triangle row.
__device__ __forceinline__ const float* row_of(int ent, const float* nodes,
                                               const float* tris) {
  return ent >= 0 ? nodes + (size_t)ent * kRow
                  : tris + (size_t)(-ent - 1) * kRow;
}

// The warp copies one 512-byte row into `dst` (shared), 16 bytes a lane, as
// one cp.async group.
__device__ __forceinline__ void fetch_row(float* dst, const float* src,
                                          int lane) {
  const unsigned s =
      static_cast<unsigned>(__cvta_generic_to_shared(dst + 4 * lane));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src + 4 * lane)
               : "memory");
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Floats 4i..4i+3 of a row in shared memory: one broadcast to the warp.
__device__ __forceinline__ float4 row4(const float* row, int i) {
  return reinterpret_cast<const float4*>(row)[i];
}

template <bool kAnyHit, bool kProfile>
__global__ void __launch_bounds__(kWarps * kPacket)
packet_traverse_kernel(const float* __restrict__ rays,
                       const float* __restrict__ nodes,
                       const float* __restrict__ tris,
                       float* __restrict__ t_out, float* __restrict__ u_out,
                       float* __restrict__ v_out, int* __restrict__ slot_out,
                       int* __restrict__ visits_out,
                       long long* __restrict__ prof, int n_rays) {
  __shared__ int stacks[kWarps][kStackDepth];
  __shared__ __align__(16) float rows[kWarps][2][kRow];

  const int warp = threadIdx.x / kPacket;
  const int lane = threadIdx.x % kPacket;
  const int n_packets = (n_rays + kPacket - 1) / kPacket;
  int* stack = stacks[warp];

  for (;;) {
    int packet = 0;
    if (lane == 0) packet = static_cast<int>(atomicAdd(&g_queue[0], 1u));
    packet = __shfl_sync(kFull, packet, 0);
    if (packet >= n_packets) break;

    // the root's row goes in flight first
    int ent = 0;   // the entry popped next; its row goes to rows[warp][b]
    int b = 0;
    fetch_row(rows[warp][0], nodes, lane);

    const int idx = packet * kPacket + lane;
    // a ragged last packet keeps its idle lanes for the votes
    const bool valid = idx < n_rays;
    float ox = 0.f, oy = 0.f, oz = 0.f, dx = 1.f, dy = 1.f, dz = 1.f;
    float t_lim = 0.f;
    bool act = false;
    if (valid) {
      const float4 a =
          __ldg(reinterpret_cast<const float4*>(rays) + 2 * (size_t)idx);
      const float4 c =
          __ldg(reinterpret_cast<const float4*>(rays) + 2 * (size_t)idx + 1);
      ox = a.x; oy = a.y; oz = a.z; dx = a.w;
      dy = c.x; dz = c.y; t_lim = c.z;
      act = c.w > 0.0f;
    }
    const float ix = safe_inv(dx), iy = safe_inv(dy), iz = safe_inv(dz);
    const float t_act = act ? t_lim : -kBig;

    float t_best = fminf(t_lim, kBig);
    float u_best = 0.f, v_best = 0.f;
    int slot_best = -1;

    long long t_start = 0;
    int n_node = 0;
    if (kProfile) t_start = clock64();
    int sp = 0;    // entries on the stack below `ent`
    int it = 0;
    bool more = true;

    while (more && it < kMaxVisits) {
      ++it;
      float t_cap = fminf(t_best, t_act);
      const float* row = rows[warp][b];
      if (ent >= 0) {
        if (kProfile) ++n_node;
        asm volatile("cp.async.wait_group 0;\n" ::: "memory");
        __syncwarp();  // every lane's 16 bytes of the row have landed
        unsigned bits = 0u;  // this lane's hit bits, child c at bit c
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const float4 lo = row4(row, 4 * c);
          const float4 hi = row4(row, 4 * c + 1);
          if (__float_as_int(hi.z) == kEmpty) continue;  // warp-uniform
          const float tx0 = (lo.x - ox) * ix;
          const float tx1 = (lo.w - ox) * ix;
          const float ty0 = (lo.y - oy) * iy;
          const float ty1 = (hi.x - oy) * iy;
          const float tz0 = (lo.z - oz) * iz;
          const float tz1 = (hi.y - oz) * iz;
          const float tn = fmaxf(fmaxf(fminf(tx0, tx1), fminf(ty0, ty1)),
                                 fminf(tz0, tz1));
          const float tf = fminf(fminf(fmaxf(tx0, tx1), fmaxf(ty0, ty1)),
                                 fmaxf(tz0, tz1));
          const bool hit = (tf >= fmaxf(tn, 0.0f)) && (tn < t_cap);
          bits |= hit ? 1u << c : 0u;
        }
        // one vote: the children some ray of the packet may still hit, each
        // stored by its own lane where pushes in child order would put it
        const unsigned mask = __reduce_or_sync(kFull, bits);
        if (lane < 8 && ((mask >> lane) & 1u))
          stack[sp + __popc(mask & ((1u << lane) - 1u))] =
              __float_as_int(row[16 * lane + 6]);
        sp = min(sp + __popc(mask), kStackDepth - 9);
        __syncwarp();  // the pushes are visible to every lane
        more = sp > 0;
        if (more) {
          ent = stack[sp - 1];
          --sp;
          fetch_row(rows[warp][b ^ 1], row_of(ent, nodes, tris), lane);
        }
      } else {
        const int blk = -ent - 1;
        // the next entry is the stack top: its row goes in flight now
        more = sp > 0;
        int next = 0;
        if (more) {
          next = stack[sp - 1];
          --sp;
          fetch_row(rows[warp][b ^ 1], row_of(next, nodes, tris), lane);
          asm volatile("cp.async.wait_group 1;\n" ::: "memory");
        } else {
          asm volatile("cp.async.wait_group 0;\n" ::: "memory");
        }
        __syncwarp();  // every lane's 16 bytes of this leaf's row have landed
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const float4 p0 = row4(row, 4 * k);
          const float4 p1 = row4(row, 4 * k + 1);
          const float4 p2 = row4(row, 4 * k + 2);
          const float v0x = p0.x, v0y = p0.y, v0z = p0.z;
          const float e1x = p0.w, e1y = p1.x, e1z = p1.y;
          const float e2x = p1.z, e2y = p1.w, e2z = p2.x;
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
        // the packet is done once every active ray is occluded
        if (kAnyHit && !__any_sync(kFull, act && slot_best < 0)) more = false;
        ent = next;
      }
      b ^= 1;
    }
    // a row fetched for an entry the walk never popped lands before the
    // buffers serve the next packet
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncwarp();

    if (valid) {
      t_out[idx] = slot_best >= 0 ? t_best : kBig;
      u_out[idx] = u_best;
      v_out[idx] = v_best;
      slot_out[idx] = slot_best;
    }
    if (lane == 0) visits_out[packet] = it;
    if (kProfile && lane == 0) {
      long long* p = prof + 5 * (size_t)packet;
      p[0] = t_start;
      p[1] = clock64();
      p[2] = sm_id();
      p[3] = n_node;
      p[4] = it - n_node;
    }
  }

  // the last warp out leaves the queue at 0 for the next launch: every other
  // warp has taken its last packet index before it counts itself done
  if (lane == 0) {
    __threadfence();
    if (atomicAdd(&g_queue[1], 1u) == gridDim.x * kWarps - 1) {
      atomicExch(&g_queue[0], 0u);
      atomicExch(&g_queue[1], 0u);
    }
  }
}

using Kernel = void (*)(const float*, const float*, const float*, float*,
                        float*, float*, int*, int*, long long*, int);

Kernel kernel_of(int any_hit, int profile) {
  return any_hit ? (profile ? packet_traverse_kernel<true, true>
                            : packet_traverse_kernel<true, false>)
                 : (profile ? packet_traverse_kernel<false, true>
                            : packet_traverse_kernel<false, false>);
}

// CTAs of each instantiation an SM of each device holds (0: not asked yet)
int g_ctas[kMaxDevices][4];
int g_sms[kMaxDevices];

// The persistent grid of an instantiation on the current device: its SMs
// times the CTAs an SM holds, queried once per device.
cudaError_t persistent_grid(int any_hit, int profile, int* ctas, int* sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  int& c = g_ctas[dev][2 * any_hit + profile];
  if (c == 0) {
    int n = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, kernel_of(any_hit, profile), kWarps * kPacket, 0);
    if (err != cudaSuccess) return err;
    if (n <= 0) return cudaErrorLaunchOutOfResources;
    int m = 0;
    err = cudaDeviceGetAttribute(&m, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    g_sms[dev] = m;
    c = n;
  }
  *ctas = c;
  *sms = g_sms[dev];
  return cudaSuccess;
}

}  // namespace

extern "C" {

// Launches B4 on `stream`: closest hit (any_hit == 0) or any hit over the
// packed 8-wide BVH; with `prof` (n_packets, 5) i64 the profiling
// instantiation, which also writes each packet's [clock64 at its start, at
// its end, SM id, node entries, leaf entries]. Returns the error of the
// occupancy query, or cudaGetLastError() right after the launch (0 on
// success).
int hydra_packet_traverse(const float* rays, const float* nodes,
                          const float* tris, float* t_out, float* u_out,
                          float* v_out, int* slot_out, int* visits_out,
                          long long* prof, int n_rays, int any_hit,
                          void* stream) {
  if (n_rays <= 0) return 0;
  const int profile = prof != nullptr;
  int ctas = 0, sms = 0;
  const cudaError_t err = persistent_grid(any_hit != 0, profile, &ctas, &sms);
  if (err != cudaSuccess) return (int)err;
  const int packets = (n_rays + kPacket - 1) / kPacket;
  const int grid = min(sms * ctas, (packets + kWarps - 1) / kWarps);
  kernel_of(any_hit != 0, profile)<<<grid, kWarps * kPacket, 0,
                                     static_cast<cudaStream_t>(stream)>>>(
      rays, nodes, tris, t_out, u_out, v_out, slot_out, visits_out, prof,
      n_rays);
  return (int)cudaGetLastError();
}

// CTAs of one instantiation that an SM of the current device holds at once
// (the occupancy query the launch sizes its grid by).
int hydra_packet_ctas_per_sm(int any_hit, int profile, int* out) {
  int sms = 0;
  return (int)persistent_grid(any_hit != 0, profile != 0, out, &sms);
}

int hydra_packet_size(void) { return kPacket; }
int hydra_packet_stack_depth(void) { return kStackDepth; }
int hydra_packet_max_visits(void) { return kMaxVisits; }

const char* hydra_packet_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
