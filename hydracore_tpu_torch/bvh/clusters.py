"""Triangle clusters: the scene layout the cluster traversal kernels read.

The port's own copy of cut_clusters from the JAX package's bvh/clusters.py
(same bytes out for the same tree). The binary SAH tree is cut into
subtrees of at most K_TRIS triangles; each becomes a cluster with its tight
AABB and a padded block of 128 triangles in Woop form. Padded clusters are
1e30 point boxes, padded slots have u = -1, degenerate triangles get rows
that fail every hit test. Pools past CL_PART_CAP clusters are stacked into
chunks (partition_clusters), as the JAX package lays big scenes out.
group_tables derives the group level that kernels B1/B2 walk first.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from hydracore_tpu_torch.bvh.builder import FlatBVH

K_TRIS = 128  # triangles per cluster (= lane width)
CL_PART_CAP = 1024  # clusters per chunk of a partitioned pool
# real clusters per group of B1/B2's two-level walk: with 8, no wavefront of
# the main path is slower than under the single-level walk; 16 loses on the
# flat pool's bounce rays, 32 on most wavefronts (chip_smoke.py:group_sizes,
# PERF.md section 6)
CL_GROUP = 8


@dataclass
class ClusterSet:
    bounds_lane: np.ndarray  # (8, Cp) f32 rows [bxm bym bzm bxM byM bzM 0 0]
    bounds_sub: np.ndarray   # (Cp, 8) f32 same data, sublane-indexed
    tris: np.ndarray         # (Cp, 4, 384) f32 Woop rows, lanes [Mu | Mv | Mw]
    slot_tri: np.ndarray     # (Cp*128,) i32 padded slot -> tri id (-1 pad)
    oct_perm: np.ndarray     # (8, Cp) i32 cluster visit order per dir octant
    bounds_oct: np.ndarray   # (8, 8, Cp) f32 bounds_lane pre-permuted per octant
    num_clusters: int


def cut_clusters(bvh: FlatBVH, tri_v0: np.ndarray, tri_e1: np.ndarray,
                 tri_e2: np.ndarray, k_tris: int = K_TRIS) -> ClusterSet:
    """Cut the binary BVH into clusters of <= k_tris triangles.

    Triangles must already be in BVH leaf order (builder perm applied), so
    every subtree covers one contiguous triangle range."""
    T = tri_v0.shape[0]
    count = bvh.count
    left = bvh.left
    right = bvh.right

    # subtree triangle counts + range starts (iterative post-order)
    n = bvh.num_nodes
    sub_cnt = np.zeros(n, np.int64)
    sub_start = np.zeros(n, np.int64)
    order = []
    stack = [0]
    while stack:
        i = stack.pop()
        order.append(i)
        if count[i] == 0:
            stack.append(left[i])
            stack.append(right[i])
    for i in reversed(order):
        if count[i] > 0:
            sub_cnt[i] = count[i]
            sub_start[i] = left[i]
        else:
            sub_cnt[i] = sub_cnt[left[i]] + sub_cnt[right[i]]
            sub_start[i] = min(sub_start[left[i]], sub_start[right[i]])

    # DFS cut
    ranges: list[tuple[int, int, int]] = []  # (start, cnt, node)
    stack = [0]
    while stack:
        i = stack.pop()
        if sub_cnt[i] <= k_tris or count[i] > 0:
            ranges.append((int(sub_start[i]), int(sub_cnt[i]), i))
        else:
            stack.append(right[i])
            stack.append(left[i])

    C = len(ranges)
    Cp = max((C + 127) // 128 * 128, 128)
    # padded clusters get a far-away POINT box (min == max) so the slab
    # test rejects them; an inverted box (min > max) would always pass
    bl = np.zeros((8, Cp), np.float32)
    bl[0:6, :] = 1e30
    slot_tri = np.full(Cp * 128, -1, np.int32)

    # Woop-style affine transforms per triangle: rows u/v/w of
    # A = inv([e1 e2 n]) with n = e1 x e2, plus offsets c = -A v0, stored
    # as three (4, 128) blocks per cluster; the kernel computes
    # o' = [o 1] @ M and d' = [d 0] @ M per lane
    # (t = -o'w/d'w, u = o'u + t d'u, v = o'v + t d'v).
    n_all = np.cross(tri_e1, tri_e2)
    det = np.einsum("ij,ij->i", n_all, n_all)  # |n|^2 = det([e1 e2 n])
    good = det > 1e-24
    inv_det = np.where(good, 1.0 / np.where(det == 0, 1.0, det), 0.0)
    row_u = np.cross(tri_e2, n_all) * inv_det[:, None]
    row_v = np.cross(n_all, tri_e1) * inv_det[:, None]
    row_w = n_all * inv_det[:, None]
    cu = -np.einsum("ij,ij->i", row_u, tri_v0)
    cv = -np.einsum("ij,ij->i", row_v, tri_v0)
    cw = -np.einsum("ij,ij->i", row_w, tri_v0)
    # degenerate: zero rows + cu = -1 make u = -1 fail everywhere
    cu = np.where(good, cu, -1.0)
    cv = np.where(good, cv, 0.0)
    cw = np.where(good, cw, 1.0)

    tris = np.zeros((Cp, 4, 384), np.float32)
    tris[:, 3, 0:128] = -1.0  # padding slots: u = -1 always
    tris[:, 3, 256:384] = 1.0

    for ci, (start, cnt, node) in enumerate(ranges):
        bl[0:3, ci] = bvh.bmin[node]
        bl[3:6, ci] = bvh.bmax[node]
        sl = slice(start, start + cnt)
        tris[ci, 0:3, 0:cnt] = row_u[sl].T
        tris[ci, 3, 0:cnt] = cu[sl]
        tris[ci, 0:3, 128:128 + cnt] = row_v[sl].T
        tris[ci, 3, 128:128 + cnt] = cv[sl]
        tris[ci, 0:3, 256:256 + cnt] = row_w[sl].T
        tris[ci, 3, 256:256 + cnt] = cw[sl]
        slot_tri[ci * 128 : ci * 128 + cnt] = np.arange(start, start + cnt)

    # front-to-back visit order per direction octant (bit0: dx>0, bit1:
    # dy>0, bit2: dz>0): ascending signed centroid projection; padded
    # clusters always sort last
    center = (bl[0:3, :] + bl[3:6, :]) * 0.5  # (3, Cp)
    oct_perm = np.zeros((8, Cp), np.int32)
    pad = np.arange(Cp) >= C
    for o in range(8):
        s = np.array([1.0 if o & 1 else -1.0,
                      1.0 if o & 2 else -1.0,
                      1.0 if o & 4 else -1.0])
        key = s @ center
        key[pad] = np.inf
        oct_perm[o] = np.argsort(key, kind="stable").astype(np.int32)

    # bounds pre-permuted per octant: stage A's lane order IS visit order
    bounds_oct = np.zeros((8, 8, Cp), np.float32)
    for o in range(8):
        bounds_oct[o] = bl[:, oct_perm[o]]

    return ClusterSet(bounds_lane=bl, bounds_sub=np.ascontiguousarray(bl.T),
                      tris=tris, slot_tri=slot_tri, oct_perm=oct_perm,
                      bounds_oct=bounds_oct, num_clusters=C)


def partition_clusters(cl: ClusterSet, cap: int) -> ClusterSet:
    """Split a flat ClusterSet into chunks of `cap` clusters (the JAX
    package's partition_clusters, the same bytes out).

    Big-scene analogue of the reference's multi-tree traversal loop
    (runKernel_Trace iterates up to MAXBVHTREES=4 trees per bounce,
    GPUOCLKernels.cpp:424-512): the traversal walks the chunks in order,
    each in its own front-to-back order, carrying the best t from chunk to
    chunk so later chunks prune against earlier hits. Chunks follow the
    DFS cut order, which keeps them spatially coherent.

    Arrays gain a leading partition axis P; slot_tri stays FLAT in
    partition-major padded order (slot_global = p*cap*128 + slot_local),
    so downstream slot->tri tables need no changes.
    """
    if cap % 128 != 0 or cap < 128:
        raise ValueError(f"cap must be a multiple of 128, got {cap}")
    C = cl.num_clusters
    P = max((C + cap - 1) // cap, 1)

    bl = np.zeros((P, 8, cap), np.float32)
    bl[:, 0:6, :] = 1e30  # far-away POINT boxes reject padded lanes
    tris = np.zeros((P, cap, 4, 384), np.float32)
    tris[:, :, 3, 0:128] = -1.0  # padding slots: u = -1 always fails
    tris[:, :, 3, 256:384] = 1.0
    slot_tri = np.full(P * cap * 128, -1, np.int32)

    for p in range(P):
        lo = p * cap
        hi = min(lo + cap, C)
        n = hi - lo
        bl[p, :, :n] = cl.bounds_lane[:, lo:hi]
        tris[p, :n] = cl.tris[lo:hi]
        slot_tri[p * cap * 128 : p * cap * 128 + n * 128] = \
            cl.slot_tri[lo * 128 : hi * 128]

    # per-chunk octant visit orders (local indices; padded clusters last)
    oct_perm = np.zeros((P, 8, cap), np.int32)
    bounds_oct = np.zeros((P, 8, 8, cap), np.float32)
    lane = np.arange(cap)
    for p in range(P):
        center = (bl[p, 0:3, :] + bl[p, 3:6, :]) * 0.5
        pad = lane >= min(C - p * cap, cap)
        for o in range(8):
            s = np.array([1.0 if o & 1 else -1.0,
                          1.0 if o & 2 else -1.0,
                          1.0 if o & 4 else -1.0])
            key = s @ center
            key[pad] = np.inf
            perm = np.argsort(key, kind="stable").astype(np.int32)
            oct_perm[p, o] = perm
            bounds_oct[p, o] = bl[p][:, perm]

    return ClusterSet(
        bounds_lane=bl, bounds_sub=np.ascontiguousarray(bl.transpose(0, 2, 1)),
        tris=tris, slot_tri=slot_tri, oct_perm=oct_perm,
        bounds_oct=bounds_oct, num_clusters=C)


def maybe_partition(cl: ClusterSet, cap: int = CL_PART_CAP) -> ClusterSet:
    """Partition when the flat pool exceeds `cap` clusters (the JAX
    package's default layout rule: 1024)."""
    if cl.tris.shape[0] <= cap:
        return cl
    return partition_clusters(cl, cap)


def group_tables(bounds_lane, oct_perm, group: int = CL_GROUP) -> dict:
    """The upper level of kernels B1/B2's two-level walk (the tables
    ops/traverse_cluster.py:LEVEL_TABLES names), derived from a flat (8, Cp)
    or partitioned (P, 8, Cp) pool's own tables (a pool from either package
    gets the same tables). Its boxes are groups: runs of at most `group`
    consecutive real clusters of one chunk in true-id order (the DFS cut's,
    spatially coherent); padding (the 1e30 point box) joins no group, and no
    group straddles two chunks.
      lvl_bounds        (8, Gn) f32 each group's AABB, the union of its
                        clusters' boxes, laid out like bounds_lane;
      lvl_oct_perm      (8, Gn) i32 per octant the groups of all chunks in
                        one front-to-back order: by the centre key of the
                        cluster order (cut_clusters') of each group's
                        nearest cluster, so a group comes up where its first
                        cluster would in a walk over every cluster;
      lvl_members       (8, Cr) i32 per octant the Cr real clusters as
                        chunk * Cp + cluster, grouped by group (group g at
                        [lvl_start[g], lvl_start[g + 1])), each group in the
                        chunk's front-to-back order (a stable filter of
                        oct_perm);
      lvl_member_bounds (8, 8, Cr) f32 the clusters' boxes in
                        lvl_members[o]'s order;
      lvl_start         (Gn + 1,) i32 the groups' offsets into
                        lvl_members[o] (the same in every octant);
      lvl_nodes         (8, 0) i32 and lvl_node_bounds (8, 0) f32: no tree
                        (B1/B2 vote on every group in lvl_oct_perm's order).
    Each cluster box lies inside its group's box, so a ray that misses the
    group box misses every cluster box in it."""
    b = np.asarray(bounds_lane, np.float32)
    perm = np.asarray(oct_perm, np.int32)
    if b.ndim == 2:
        b, perm = b[None], perm[None]
    P, _, Cp = b.shape
    flat = b.transpose(1, 0, 2).reshape(8, P * Cp)  # column chunk * Cp + c
    ids = np.flatnonzero(flat[0] < 1e29)  # the real clusters, chunk-major
    # each chunk's real clusters cut into runs of `group` from its first
    bnd = np.searchsorted(ids, np.arange(P + 1) * Cp)
    starts = np.concatenate([np.arange(lo, hi, group)
                             for lo, hi in zip(bnd[:-1], bnd[1:])])
    starts = starts.astype(np.int64)
    Gn = starts.size
    start = np.append(starts, ids.size).astype(np.int32)
    boxes = np.zeros((8, Gn), np.float32)
    if Gn:
        boxes[0:3] = np.minimum.reduceat(flat[0:3, ids], starts, axis=1)
        boxes[3:6] = np.maximum.reduceat(flat[3:6, ids], starts, axis=1)
    of = np.full(P * Cp, -1, np.int64)
    of[ids] = np.repeat(np.arange(Gn), np.diff(start))

    center = (flat[0:3, ids] + flat[3:6, ids]) * 0.5
    order_g = np.zeros((8, Gn), np.int32)
    members = np.zeros((8, ids.size), np.int32)
    chunk_base = (np.arange(P, dtype=np.int64) * Cp)[:, None]
    for o in range(8):
        s = np.array([1.0 if o & 1 else -1.0,
                      1.0 if o & 2 else -1.0,
                      1.0 if o & 4 else -1.0])
        if Gn:
            near = np.minimum.reduceat(s @ center, starts)
            order_g[o] = np.argsort(near, kind="stable")
        order = (chunk_base + perm[:, o]).reshape(-1)  # front to back a chunk
        order = order[of[order] >= 0]
        members[o] = order[np.argsort(of[order], kind="stable")]
    return dict(lvl_bounds=boxes, lvl_oct_perm=order_g, lvl_members=members,
                lvl_member_bounds=np.ascontiguousarray(
                    np.stack([flat[:, members[o]] for o in range(8)])),
                lvl_start=start, lvl_nodes=np.zeros((8, 0), np.int32),
                lvl_node_bounds=np.zeros((8, 0), np.float32))
