"""Packet traversal of the 8-wide BVH: kernel B4 (closest hit and any hit),
its plain PyTorch twin, the pool packing and the closest_hit / any_hit
entry points.

The kernel (csrc/traverse_packet.cu, CUDA C++ for sm_90a, built with nvcc at
first use and loaded with ctypes) replaces the JAX package's Pallas kernel
hydracore_tpu/ops/traverse_packet.py::_make_kernel as launched by
_packet_traverse. A packet of PKT rays shares one depth-first walk of the
tree with one stack: a popped node pushes every child some ray of the
packet may still hit, a popped leaf tests its 8 triangles against every ray
of the packet. The function is the TPU kernel's; the packet is a warp of 32
rays instead of 1024 (the source note in the .cu file says why), which
changes no ray's answer except among triangles at exactly equal t.

packet_traverse() is the wrapper: for CUDA tensors it launches the kernel
(or raises), for CPU tensors it runs packet_traverse_plain, the twin with
the same contract, walk order and packet size. It counts kernel launches in
closest_launches / any_launches. A check that wants every launch's visit
counts (MAX_VISITS means a walk was cut short) sets visits_hook; the wrapper
itself adds nothing to the launch.
"""
from __future__ import annotations

import sys

import numpy as np
import torch

from hydracore_tpu_torch.bvh.wide import EMPTY_PAYLOAD
from hydracore_tpu_torch.ops.intersect import safe_inv
from hydracore_tpu_torch.utils.build import CI, VP, launch, load_lib

PKT = 32            # rays per packet: one warp
STACK_D = 384       # shared stack depth (>= 7 * wide-tree depth + 9)
MAX_VISITS = 65536  # safety bound on the entries a packet pops
BIG = 3.0e38
# traverse_packet.cu's name for the text of a CUDA error
ERR_FN = "hydra_packet_error_string"

closest_launches = 0
any_launches = 0

# for checks: a callable given the (G,) visit counts of every kernel launch
visits_hook = None

_lib = None


def reset_launch_counts() -> None:
    this = sys.modules[__name__]
    this.closest_launches = 0
    this.any_launches = 0


def _kernel_lib():
    global _lib
    if _lib is None:
        lib = load_lib("traverse_packet.cu", "hydra_packet_traverse",
                       [VP] * 8 + [CI, CI, VP], err_fn=ERR_FN)
        built = (lib.hydra_packet_size(), lib.hydra_packet_stack_depth(),
                 lib.hydra_packet_max_visits())
        if built != (PKT, STACK_D, MAX_VISITS):
            raise RuntimeError(f"traverse_packet.cu was built with (packet, "
                               f"stack, visits) = {built}, the module expects "
                               f"{(PKT, STACK_D, MAX_VISITS)}")
        _lib = lib
    return _lib


def pack_pools(wbvh_nodes: np.ndarray, wbvh_tri9f: np.ndarray,
               max_depth: int | None = None):
    """Host side: pack the wide-BVH pools into rows of 128 floats (the JAX
    package's pack_pools, the same bytes). A node row holds 8 children x
    16 floats [bmin.xyz bmax.xyz payload pad]; rows are padded to a multiple
    of 8 with EMPTY payloads, triangle rows with far degenerate triangles.
    Returns (nodes, tris); the payload is read through .view(int32) of the
    one node array."""
    nodes = np.asarray(wbvh_nodes)
    if max_depth is not None and max_depth * 7 + 9 > STACK_D:
        raise ValueError(
            f"wide-BVH depth {max_depth} needs stack {max_depth * 7 + 9} > "
            f"STACK_D={STACK_D}; raise STACK_D in traverse_packet")
    N = nodes.shape[0]
    Np = (N + 7) // 8 * 8
    n128 = np.zeros((Np, 128), np.float32)
    n128.reshape(Np, 8, 16)[:N, :, 0:8] = nodes
    n128.reshape(Np, 8, 16)[N:, :, 6] = np.int32(EMPTY_PAYLOAD).view(np.float32)
    t_src = np.asarray(wbvh_tri9f)
    B = t_src.shape[0]
    Bp = (B + 7) // 8 * 8
    t128 = np.zeros((Bp, 128), np.float32)
    t128[:B] = t_src
    t128.reshape(Bp, 8, 16)[B:, :, 0:3] = 1e30
    return n128, t128


def _check_inputs(rays, nodes, tris) -> None:
    if rays.dim() != 3 or tuple(rays.shape[1:]) != (PKT, 8):
        raise ValueError(f"rays must be (G, {PKT}, 8), got {tuple(rays.shape)}")
    for name, x in (("nodes", nodes), ("tris", tris)):
        if x.dim() != 2 or x.shape[1] != 128 or x.shape[0] == 0:
            raise ValueError(f"{name} must be (rows, 128), got {tuple(x.shape)}")
    for name, x in (("rays", rays), ("nodes", nodes), ("tris", tris)):
        if x.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {x.dtype}")
        if x.device != rays.device:
            raise ValueError(f"{name} is on {x.device}, rays on {rays.device}")


def packet_traverse(rays, nodes, tris, any_hit_mode: bool = False):
    """rays (G, PKT, 8) f32 [o d t_lim active] -> (t, u, v (G, PKT) f32,
    slot (G, PKT) i32, visits (G,) i32): per ray the closest t (3e38 on a
    miss), the barycentrics as the walk computed them, the slot block * 8 +
    k (-1 on a miss; any-hit mode: >= 0 where occluded), per packet the
    entries it popped. CUDA tensors launch kernel B4; CPU tensors run the
    plain twin."""
    _check_inputs(rays, nodes, tris)
    if not rays.is_cuda:
        return packet_traverse_plain(rays, nodes, tris, any_hit_mode)
    G = rays.shape[0]
    rays, nodes, tris = rays.contiguous(), nodes.contiguous(), tris.contiguous()
    dev = rays.device
    t, u, v = (torch.empty((G, PKT), dtype=torch.float32, device=dev)
               for _ in range(3))
    slot = torch.empty((G, PKT), dtype=torch.int32, device=dev)
    visits = torch.empty((G,), dtype=torch.int32, device=dev)
    launch(_kernel_lib(), "hydra_packet_traverse", "packet traversal", dev,
           rays.data_ptr(), nodes.data_ptr(), tris.data_ptr(), t.data_ptr(),
           u.data_ptr(), v.data_ptr(), slot.data_ptr(), visits.data_ptr(),
           G * PKT, int(any_hit_mode), err_fn=ERR_FN)
    this = sys.modules[__name__]
    if any_hit_mode:
        this.any_launches += 1
    else:
        this.closest_launches += 1
    if visits_hook is not None:
        visits_hook(visits)
    return t, u, v, slot, visits


def packet_traverse_plain(rays, nodes, tris, any_hit_mode: bool = False):
    """Plain PyTorch twin of B4 with the kernel's contract. All packets step
    together, each with its own row of a (G, STACK_D) stack tensor, so the
    walk order, the pruning and the ties are the kernel's: a step pops one
    entry per live packet, the node entries push their children 0..7 where
    some ray of the packet passes the slab test against its current t, the
    leaf entries test their 8 triangles and keep the first among the
    nearest (what the kernel's 8 sequential updates come to)."""
    G = rays.shape[0]
    dev = rays.device
    nodes_i = nodes.view(torch.int32)
    ox, oy, oz, dx, dy, dz, t_lim, act_f = rays.unbind(dim=2)  # (G, PKT)
    act = act_f > 0.0
    ix, iy, iz = safe_inv(dx), safe_inv(dy), safe_inv(dz)
    t_act = torch.where(act, t_lim, -BIG)
    t_best = torch.clamp(t_lim, max=BIG)
    slot_best = torch.full((G, PKT), -1, dtype=torch.int32, device=dev)
    u_best = torch.zeros((G, PKT), dtype=torch.float32, device=dev)
    v_best = torch.zeros((G, PKT), dtype=torch.float32, device=dev)
    stack = torch.zeros((G, STACK_D), dtype=torch.int32, device=dev)
    sp = torch.ones((G,), dtype=torch.int64, device=dev)
    visits = torch.zeros((G,), dtype=torch.int32, device=dev)
    k8 = torch.arange(8, device=dev)

    while True:
        live = torch.nonzero((sp > 0) & (visits < MAX_VISITS)).flatten()
        if live.numel() == 0:
            break
        sp[live] -= 1
        visits[live] += 1
        ent = stack[live, sp[live]]
        is_node = ent >= 0

        g = live[is_node]  # packets that popped a node
        if g.numel() > 0:
            row = ent[is_node].long()
            rec = nodes[row].view(-1, 8, 16)                  # (K, 8, 16)
            pay = nodes_i[row].view(-1, 8, 16)[:, :, 6]       # (K, 8)
            t_cap = torch.minimum(t_best[g], t_act[g])[:, :, None]

            def slab(lo, hi, o, inv):
                a = (rec[:, None, :, lo] - o[g][:, :, None]) * inv[g][:, :, None]
                b = (rec[:, None, :, hi] - o[g][:, :, None]) * inv[g][:, :, None]
                return torch.minimum(a, b), torch.maximum(a, b)

            nx, fx = slab(0, 3, ox, ix)
            ny, fy = slab(1, 4, oy, iy)
            nz, fz = slab(2, 5, oz, iz)
            tn = torch.maximum(torch.maximum(nx, ny), nz)     # (K, PKT, 8)
            tf = torch.minimum(torch.minimum(fx, fy), fz)
            hit = (tf >= torch.clamp(tn, min=0.0)) & (tn < t_cap)
            push = hit.any(dim=1) & (pay != EMPTY_PAYLOAD)    # (K, 8)
            top = sp[g]
            for c in range(8):
                m = push[:, c]
                stack[g[m], top[m]] = pay[m, c]
                top = top + m.long()
            sp[g] = torch.clamp(top, max=STACK_D - 9)

        g = live[~is_node]  # packets that popped a leaf
        if g.numel() > 0:
            blk = -ent[~is_node] - 1                          # (K,) i32
            tri = tris[blk.long()].view(-1, 8, 16)
            o_x, o_y, o_z = (x[g][:, :, None] for x in (ox, oy, oz))
            d_x, d_y, d_z = (x[g][:, :, None] for x in (dx, dy, dz))
            v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z = (
                tri[:, None, :, f] for f in range(9))
            px = d_y * e2z - d_z * e2y                        # (K, PKT, 8)
            py = d_z * e2x - d_x * e2z
            pz = d_x * e2y - d_y * e2x
            det = e1x * px + e1y * py + e1z * pz
            inv = torch.where(det.abs() > 1e-12,
                              1.0 / torch.where(det == 0.0, 1.0, det), 0.0)
            sx, sy, sz = o_x - v0x, o_y - v0y, o_z - v0z
            u = (sx * px + sy * py + sz * pz) * inv
            qx = sy * e1z - sz * e1y
            qy = sz * e1x - sx * e1z
            qz = sx * e1y - sy * e1x
            v = (d_x * qx + d_y * qy + d_z * qz) * inv
            t = (e2x * qx + e2y * qy + e2z * qz) * inv
            t_cap = torch.minimum(t_best[g], t_act[g])[:, :, None]
            hit = (inv != 0.0) & (u >= 0) & (v >= 0) & (u + v <= 1.0) \
                & (t > 1e-5) & (t < t_cap)
            # the kernel tests the 8 triangles in order and a later one wins
            # only with a smaller t: the first among the nearest
            t_m = torch.where(hit, t, float("inf"))
            t_k = t_m.amin(dim=2)
            k = torch.where(hit & (t_m == t_k[:, :, None]), k8,
                            7).amin(dim=2, keepdim=True)
            won = t_k < float("inf")
            sb = torch.where(won, blk[:, None] * 8 + k[:, :, 0].int(),
                             slot_best[g])
            slot_best[g] = sb
            t_best[g] = torch.where(won, t_k, t_best[g])
            u_best[g] = torch.where(won, u.gather(2, k)[:, :, 0], u_best[g])
            v_best[g] = torch.where(won, v.gather(2, k)[:, :, 0], v_best[g])
            if any_hit_mode:
                # a packet is done once every active ray is occluded
                pend = (act[g] & (sb < 0)).any(dim=1)
                sp[g] = torch.where(pend, sp[g], 0)

    t_out = torch.where(slot_best >= 0, t_best, BIG)
    return t_out, u_best, v_best, slot_best, visits


def _to_packets(ro, rd, t_max, active):
    """Pack rays into (G, PKT, 8) [o d t_lim active]; the padded tail of the
    last packet is inactive."""
    R = ro.shape[0]
    Rp = max((R + PKT - 1) // PKT, 1) * PKT
    r = torch.zeros((Rp, 8), dtype=torch.float32, device=ro.device)
    r[:R, 0:3] = ro
    r[:R, 3:6] = rd
    r[:R, 6] = torch.as_tensor(t_max, dtype=torch.float32, device=ro.device)
    r[:R, 7] = 1.0 if active is None else active.to(torch.float32)
    return r.reshape(Rp // PKT, PKT, 8), R


def closest_hit(scene, ray_o, ray_d, t_max=1e30, active=None):
    """Closest hit over the packet walk. Returns (t, tri_id, u, v); t = +inf
    and tri_id = -1 on a miss; u and v as the walk computed them."""
    rays, R = _to_packets(ray_o, ray_d, t_max, active)
    t, u, v, slot, _ = packet_traverse(rays, scene.pkt_nodes, scene.pkt_tris,
                                       any_hit_mode=False)
    t, u, v = t.reshape(-1)[:R], u.reshape(-1)[:R], v.reshape(-1)[:R]
    slot = slot.reshape(-1)[:R].long()
    hit = slot >= 0
    n_slots = scene.wbvh_slot_tri.shape[0]
    tri = torch.where(
        hit, scene.wbvh_slot_tri[torch.clamp(slot, 0, n_slots - 1)].long(), -1)
    return torch.where(hit, t, float("inf")), tri, u, v


def any_hit(scene, ray_o, ray_d, t_max, active=None):
    """Shadow query: True where some triangle lies in (1e-5, t_max)."""
    rays, R = _to_packets(ray_o, ray_d, t_max, active)
    _, _, _, slot, _ = packet_traverse(rays, scene.pkt_nodes, scene.pkt_tris,
                                       any_hit_mode=True)
    return slot.reshape(-1)[:R] >= 0
