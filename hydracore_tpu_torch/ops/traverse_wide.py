"""8-wide BVH traversal, one ray per row, no memory stack.

The JAX package's ops/traverse_wide.py in plain PyTorch (it is XLA code
there, not a kernel). Every ray carries ONE packed entry
`cur = node_id << 8 | remaining_mask` and a bank of k_regs shift registers
((R,) tensors) holding its ancestors' entries; push and pop are shifts of
the bank by one, three-way selects and never scatters. An iteration
re-fetches the current node (one row gather), re-tests its 8 child boxes
against the latest t_best, and descends into the NEAREST pending hit child:
a leaf child is intersected inline (one row gather and a dense
Moller-Trumbore over its 8 slots), an internal child pushes the parent
entry, an exhausted mask pops. All rays step together; the loop condition
is read every CHUNK iterations.
"""
from __future__ import annotations

import torch

from hydracore_tpu_torch.bvh.wide import EMPTY_PAYLOAD, LEAF_SIZE
from hydracore_tpu_torch.ops.intersect import ray_args, safe_inv

K_REGS = 16  # default ancestor registers; grown per scene from wbvh_depth
CHUNK = 8  # traversal iterations between checks of the loop condition
BIG = 3.0e38
MASK_FULL = 0xFF


def traverse_wide(nodes2, tri9f, slot_tri, ray_o, ray_d, t_max, active,
                  any_hit_mode: bool = False, k_regs: int = K_REGS):
    """nodes2: (N, 64) packed wide nodes; tri9f: (B, LEAF_SIZE*16) leaf rows.
    Returns per ray (t, tri_id, u, v); t = +inf and tri_id = -1 on a miss."""
    R = ray_o.shape[0]
    dev = ray_o.device
    k8 = torch.arange(8, device=dev)[None, :]
    bit8 = (1 << torch.arange(8, device=dev))[None, :]
    nodes2_i = nodes2.view(torch.int32)

    ox, oy, oz = ray_o[:, 0:1], ray_o[:, 1:2], ray_o[:, 2:3]  # (R,1)
    dx, dy, dz = ray_d[:, 0:1], ray_d[:, 1:2], ray_d[:, 2:3]
    ix, iy, iz = safe_inv(dx), safe_inv(dy), safe_inv(dz)

    zero_i = torch.zeros((R,), dtype=torch.int64, device=dev)
    cur = zero_i + MASK_FULL  # root (node 0) with all children pending
    depth = active.to(torch.int64)
    regs = [zero_i for _ in range(k_regs)]
    t_best = t_max.clone()
    slot_best = zero_i - 1
    u_best = torch.zeros((R,), dtype=torch.float32, device=dev)
    v_best = torch.zeros((R,), dtype=torch.float32, device=dev)

    while bool((depth > 0).any()):
        for _ in range(CHUNK):
            act = depth > 0
            node = torch.where(act, cur >> 8, 0)
            mask = torch.where(act, cur & MASK_FULL, 0)

            # ---------- fetch the current wide node, test all 8 children
            rec = nodes2[node].view(R, 8, 8)  # row gather
            payload = nodes2_i[node].view(R, 8, 8)[:, :, 6].long()
            tx0 = (rec[:, :, 0] - ox) * ix
            tx1 = (rec[:, :, 3] - ox) * ix
            ty0 = (rec[:, :, 1] - oy) * iy
            ty1 = (rec[:, :, 4] - oy) * iy
            tz0 = (rec[:, :, 2] - oz) * iz
            tz1 = (rec[:, :, 5] - oz) * iz
            tn = torch.maximum(torch.maximum(torch.minimum(tx0, tx1),
                                             torch.minimum(ty0, ty1)),
                               torch.minimum(tz0, tz1))
            tf = torch.minimum(torch.minimum(torch.maximum(tx0, tx1),
                                             torch.maximum(ty0, ty1)),
                               torch.maximum(tz0, tz1))
            pending = (mask[:, None] & bit8) != 0
            cand = pending & (payload != EMPTY_PAYLOAD) \
                & (tf >= torch.clamp(tn, min=0.0)) & (tn < t_best[:, None])

            # nearest pending hit child, the lowest slot among equal tn
            tn_m = torch.where(cand, tn, BIG)
            tn_min = tn_m.amin(dim=1)
            has_cand = act & (tn_min < BIG)
            k_sel = torch.where((tn_m == tn_min[:, None]) & cand, k8,
                                8).amin(dim=1).clamp(max=7)
            p_sel = torch.where(has_cand,
                                payload.gather(1, k_sel[:, None])[:, 0], 0)
            new_mask = torch.where(has_cand, mask & ~(1 << k_sel), mask)

            go_leaf = has_cand & (p_sel < 0)
            go_node = has_cand & (p_sel >= 0)
            do_pop = act & ~has_cand

            # ---------- leaf child: dense LEAF_SIZE-triangle intersection
            blk = torch.where(go_leaf, -p_sel - 1, 0)
            tri = tri9f[blk].view(R, LEAF_SIZE, 16)  # row gather
            v0x, v0y, v0z = tri[:, :, 0], tri[:, :, 1], tri[:, :, 2]
            e1x, e1y, e1z = tri[:, :, 3], tri[:, :, 4], tri[:, :, 5]
            e2x, e2y, e2z = tri[:, :, 6], tri[:, :, 7], tri[:, :, 8]
            px = dy * e2z - dz * e2y
            py = dz * e2x - dx * e2z
            pz = dx * e2y - dy * e2x
            det = e1x * px + e1y * py + e1z * pz
            inv = torch.where(det.abs() > 1e-12,
                              1.0 / torch.where(det == 0.0, 1.0, det), 0.0)
            sx, sy, sz = ox - v0x, oy - v0y, oz - v0z
            u = (sx * px + sy * py + sz * pz) * inv
            qx = sy * e1z - sz * e1y
            qy = sz * e1x - sx * e1z
            qz = sx * e1y - sy * e1x
            v = (dx * qx + dy * qy + dz * qz) * inv
            t = (e2x * qx + e2y * qy + e2z * qz) * inv
            hit = (inv != 0.0) & (u >= 0) & (v >= 0) & (u + v <= 1.0) \
                & (t > 1e-5)
            hit = hit & go_leaf[:, None] & (t < t_best[:, None])
            t_m = torch.where(hit, t, BIG)
            t_k = t_m.amin(dim=1)
            better = t_k < t_best
            w = torch.where((t_m == t_k[:, None]) & hit, k8,
                            8).amin(dim=1).clamp(max=7)[:, None]
            t_best = torch.where(better, t_k, t_best)
            slot_best = torch.where(better, blk * LEAF_SIZE + w[:, 0], slot_best)
            u_best = torch.where(better, u.gather(1, w)[:, 0], u_best)
            v_best = torch.where(better, v.gather(1, w)[:, 0], v_best)

            # ---------- state transition: masked selects, the register bank
            # shifts by one on a push or a pop
            stay_entry = (node << 8) | new_mask
            # leaf: stay at this node with the child consumed
            # node: push stay_entry, descend into the child
            # pop : take regs[0]
            cur = torch.where(go_leaf, stay_entry,
                              torch.where(go_node, (p_sel << 8) | MASK_FULL,
                                          torch.where(do_pop, regs[0], cur)))
            depth = depth + go_node.long() - do_pop.long()
            new_regs = []
            for i in range(k_regs):
                below = regs[i + 1] if i + 1 < k_regs else regs[k_regs - 1]
                above = regs[i - 1] if i >= 1 else stay_entry
                new_regs.append(torch.where(go_node, above,
                                            torch.where(do_pop, below, regs[i])))
            regs = new_regs

            if any_hit_mode:
                depth = torch.where(slot_best >= 0, 0, depth)

    found = slot_best >= 0
    tri_best = torch.where(
        found, slot_tri[torch.clamp(slot_best, 0, slot_tri.shape[0] - 1)].long(),
        -1)
    return torch.where(found, t_best, float("inf")), tri_best, u_best, v_best


def _prep(scene):
    """Views of the scene's wide BVH in the layouts the traversal wants."""
    nodes2 = scene.wbvh_nodes.reshape(scene.wbvh_nodes.shape[0], 64)
    # the register bank must cover the wide-tree depth: a deeper tree would
    # shift ancestors off the bank (missed intersections)
    k_regs = max(K_REGS, int(scene.wbvh_depth))
    return nodes2, scene.wbvh_tri9f, scene.wbvh_slot_tri, k_regs


def _call(scene, ray_o, ray_d, t_max, active, any_hit_mode):
    tm, active = ray_args(ray_o, t_max, active)
    nodes2, tri9f, slot_tri, k_regs = _prep(scene)
    return traverse_wide(nodes2, tri9f, slot_tri, ray_o, ray_d, tm, active,
                         any_hit_mode=any_hit_mode, k_regs=k_regs)


def closest_hit(scene, ray_o, ray_d, t_max=1e30, active=None):
    """Closest hit over the wide BVH. Returns (t, tri_id, u, v)."""
    return _call(scene, ray_o, ray_d, t_max, active, False)


def any_hit(scene, ray_o, ray_d, t_max, active=None):
    """Shadow query: True where some triangle lies in (1e-5, t_max)."""
    return _call(scene, ray_o, ray_d, t_max, active, True)[1] >= 0
