"""Binary-BVH traversal over ray batches, the reference the other
traversals are held against.

The JAX package's ops/traverse.py in plain PyTorch (XLA code there, not a
kernel): every ray keeps its own short stack in an (R, STACK_DEPTH) tensor
and ALL rays step together through one loop; divergence is handled by
masking. A step pops a node per live ray, intersects the up to LEAF_ITER
triangles of a leaf, or tests both children of an inner node and pushes
the far one, then the near one. closest_hit and any_hit read the scene's
bvh_* arrays and its triangles in leaf order.
"""
from __future__ import annotations

import torch

from hydracore_tpu_torch.ops.intersect import (moller_trumbore, ray_args,
                                                ray_box, safe_inv)

STACK_DEPTH = 64
LEAF_ITER = 8  # bvh/builder.py keeps a leaf's count <= 2 * MAX_LEAF = 8


def _push(stack, sp, node, cond):
    """Masked push of `node` for rays where cond; returns (stack, sp)."""
    r = torch.arange(stack.shape[0], device=stack.device)
    col = torch.clamp(sp, 0, STACK_DEPTH - 1)
    stack[r, col] = torch.where(cond, node, stack[r, col])
    return stack, sp + cond.long()


def traverse(bvh_bmin, bvh_bmax, bvh_left, bvh_right, bvh_count,
             tri_v0, tri_e1, tri_e2, ray_o, ray_d, t_max, active,
             any_hit_mode: bool = False):
    """Per ray (t, tri_id, u, v); t = +inf and tri_id = -1 on a miss."""
    R = ray_o.shape[0]
    dev = ray_o.device
    inv_d = safe_inv(ray_d)
    left_all, right_all, count_all = (x.long() for x in
                                      (bvh_left, bvh_right, bvh_count))
    stack = torch.zeros((R, STACK_DEPTH), dtype=torch.int64, device=dev)
    sp = active.long()  # root pre-pushed
    t_best = t_max.clone()
    tri_best = torch.full((R,), -1, dtype=torch.int64, device=dev)
    u_best = torch.zeros((R,), dtype=torch.float32, device=dev)
    v_best = torch.zeros((R,), dtype=torch.float32, device=dev)
    r = torch.arange(R, device=dev)
    n_tris = tri_v0.shape[0]
    n_nodes = bvh_bmin.shape[0]

    while bool((sp > 0).any()):
        act = sp > 0
        top = torch.clamp(sp - 1, 0, STACK_DEPTH - 1)
        node = torch.where(act, stack[r, top], 0)
        sp = torch.where(act, sp - 1, sp)

        cnt = count_all[node]
        left = left_all[node]
        right = right_all[node]
        is_leaf = act & (cnt > 0)
        is_inner = act & (cnt == 0)

        # ---- leaf: intersect up to LEAF_ITER triangles
        for k in range(LEAF_ITER):
            tri = torch.clamp(left + k, 0, n_tris - 1)
            valid = is_leaf & (k < cnt)
            t, u, v, hit = moller_trumbore(ray_o, ray_d, tri_v0[tri],
                                           tri_e1[tri], tri_e2[tri],
                                           t_max=t_best)
            better = valid & hit & (t < t_best)
            t_best = torch.where(better, t, t_best)
            tri_best = torch.where(better, tri, tri_best)
            u_best = torch.where(better, u, u_best)
            v_best = torch.where(better, v, v_best)

        # ---- inner: test both children, push far then near (near on top)
        # (a leaf's `left` is its first triangle: clamp it as a node index)
        lc = torch.clamp(left, 0, n_nodes - 1)
        rc = torch.clamp(right, 0, n_nodes - 1)
        tl, hl = ray_box(ray_o, inv_d, bvh_bmin[lc], bvh_bmax[lc], t_best)
        tr_, hr = ray_box(ray_o, inv_d, bvh_bmin[rc], bvh_bmax[rc], t_best)
        hl = hl & is_inner
        hr = hr & is_inner
        near_is_left = tl <= tr_
        near = torch.where(near_is_left, left, right)
        far = torch.where(near_is_left, right, left)
        h_near = torch.where(near_is_left, hl, hr)
        h_far = torch.where(near_is_left, hr, hl)
        stack, sp = _push(stack, sp, far, h_far)
        stack, sp = _push(stack, sp, near, h_near)

        if any_hit_mode:
            # a ray that found any hit stops traversing
            sp = torch.where(tri_best >= 0, 0, sp)

    t_out = torch.where(tri_best >= 0, t_best, float("inf"))
    return t_out, tri_best, u_best, v_best


def _call(scene, ray_o, ray_d, t_max, active, any_hit_mode):
    tm, active = ray_args(ray_o, t_max, active)
    return traverse(scene.bvh_bmin, scene.bvh_bmax, scene.bvh_left,
                    scene.bvh_right, scene.bvh_count, scene.tri_v0,
                    scene.tri_e1, scene.tri_e2, ray_o, ray_d, tm, active,
                    any_hit_mode=any_hit_mode)


def closest_hit(scene, ray_o, ray_d, t_max=1e30, active=None):
    """Closest-hit traversal. Returns (t, tri_id, u, v)."""
    return _call(scene, ray_o, ray_d, t_max, active, False)


def any_hit(scene, ray_o, ray_d, t_max, active=None):
    """Shadow traversal: the occluded mask (True = blocked)."""
    return _call(scene, ray_o, ray_d, t_max, active, True)[1] >= 0
