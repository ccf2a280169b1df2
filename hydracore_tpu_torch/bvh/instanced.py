"""Two-level BVH as *instantiated clusters*: the instancing layout.

The port's own copy of the JAX package's bvh/instanced.py (pure numpy; the
same bytes out for the same meshes and matrices). The reference keeps a
top-level BVH whose leaves carry instance matrices and recurses into
per-mesh bottom trees in local space (hydra_drv/ctrace.h:841
BVH4InstTraverse, bvh_builder/bvh_access_dll2.cpp:388 ConvertBvh4TwoLevel).
The cluster kernels walk no tree, so the two levels are collapsed
differently:

  * each unique mesh is cut into local-space clusters ONCE (shared Woop
    triangle pool — stored per mesh, not per instance);
  * each instance contributes its mesh's cluster AABBs transformed to
    world space ("instance-clusters") to the flat list the box test reads;
  * visiting an instance-cluster moves the ray into mesh-local space with
    the instance's inverse matrix (inst_woop holds A^T), so the triangle
    test runs in mesh-local space while t stays the WORLD ray parameter
    (directions are transformed unnormalized).

Memory: O(unique mesh tris) + O(instances x clusters), vs the flattened
path's O(instances x tris). Non-instanceable geometry (emissive meshes,
instances with material remap lists, single-use meshes) is flattened into
one world-space "mesh" riding instance 0 with the identity transform.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from hydracore_tpu_torch.bvh.clusters import cut_clusters
from hydracore_tpu_torch.bvh.native import build_bvh_auto


@dataclass
class MeshTris:
    """Per-mesh triangle arrays (local space, BVH leaf order)."""

    v0: np.ndarray
    e1: np.ndarray
    e2: np.ndarray
    n0: np.ndarray
    n1: np.ndarray
    n2: np.ndarray
    t0: np.ndarray
    t1: np.ndarray
    t2: np.ndarray
    uv0: np.ndarray
    uv1: np.ndarray
    uv2: np.ndarray
    mat: np.ndarray
    light: np.ndarray
    inst: np.ndarray


@dataclass
class InstancedLayout:
    # concatenated per-mesh triangle arrays (world mesh first)
    tris: MeshTris
    # shared Woop pool across meshes
    pool_tris: np.ndarray     # (Cpool, 4, 384) f32
    # instance-cluster tables (padded to a multiple of 128)
    bounds_lane: np.ndarray   # (8, Ci) f32 world AABBs
    bounds_oct: np.ndarray    # (8, 8, Ci) f32 per-octant permuted
    oct_perm: np.ndarray      # (8, Ci) i32
    cl_map: np.ndarray        # (2, Ci) i32 [pool cluster; instance id]
    slot_tri2: np.ndarray     # (Ci*128, 2) i32 [global tri id; instance id]
    # per-instance transforms
    inst_attr: np.ndarray     # (I, 32) f32 [M 3x4 | invM 3x4 | pad]
    inst_woop: np.ndarray     # (I, 4, 4) f32 A^T (world -> mesh-local)
    world_bmin: np.ndarray    # (3,)
    world_bext: np.ndarray    # (3,)
    num_instances: int
    num_iclusters: int


def mesh_local_tris(mesh, mat_remap=None, lrow=-1, inst_id=0) -> MeshTris:
    """Local-space triangle arrays for one mesh (no transform applied)."""
    ia, ib, ic = mesh.indices[:, 0], mesh.indices[:, 1], mesh.indices[:, 2]
    pos = mesh.pos[:, :3].astype(np.float32)
    nrm = mesh.norm[:, :3].astype(np.float32)
    nl = np.linalg.norm(nrm, axis=1, keepdims=True)
    nrm = nrm / np.maximum(nl, 1e-12)
    tng = mesh.tang[:, :3].astype(np.float32)
    tng = tng / np.maximum(np.linalg.norm(tng, axis=1, keepdims=True), 1e-12)
    a, b, c = pos[ia], pos[ib], pos[ic]
    mat = mesh.mat_indices.astype(np.int32)
    if mat_remap:
        mat = np.asarray([mat_remap.get(int(m), int(m)) for m in mat], np.int32)
    T = len(mat)
    return MeshTris(
        v0=a, e1=b - a, e2=c - a,
        n0=nrm[ia], n1=nrm[ib], n2=nrm[ic],
        t0=tng[ia], t1=tng[ib], t2=tng[ic],
        uv0=mesh.texcoord[ia].astype(np.float32),
        uv1=mesh.texcoord[ib].astype(np.float32),
        uv2=mesh.texcoord[ic].astype(np.float32),
        mat=mat, light=np.full(T, lrow, np.int32),
        inst=np.full(T, inst_id, np.int32),
    )


def transform_tris(mt: MeshTris, M: np.ndarray) -> MeshTris:
    """World-space copy of the arrays under the affine 4x4 row-major M."""
    R = M[:3, :3]
    t = M[:3, 3]
    n_mat = np.linalg.inv(R).T if abs(np.linalg.det(R)) > 1e-12 else R

    def rot_n(n):
        out = n @ n_mat.T
        return out / np.maximum(np.linalg.norm(out, axis=1, keepdims=True), 1e-12)

    def rot_t(v):
        out = v @ R.T
        return out / np.maximum(np.linalg.norm(out, axis=1, keepdims=True), 1e-12)

    return MeshTris(
        v0=(mt.v0 @ R.T + t).astype(np.float32),
        e1=(mt.e1 @ R.T).astype(np.float32),
        e2=(mt.e2 @ R.T).astype(np.float32),
        n0=rot_n(mt.n0), n1=rot_n(mt.n1), n2=rot_n(mt.n2),
        t0=rot_t(mt.t0), t1=rot_t(mt.t1), t2=rot_t(mt.t2),
        uv0=mt.uv0, uv1=mt.uv1, uv2=mt.uv2,
        mat=mt.mat, light=mt.light, inst=mt.inst,
    )


def concat_tris(parts: list[MeshTris]) -> MeshTris:
    f = {k: np.concatenate([getattr(p, k) for p in parts]).astype(
        np.int32 if k in ("mat", "light", "inst") else np.float32)
        for k in MeshTris.__dataclass_fields__}
    return MeshTris(**f)


def _permute_tris(mt: MeshTris, p: np.ndarray) -> MeshTris:
    return MeshTris(**{k: getattr(mt, k)[p]
                       for k in MeshTris.__dataclass_fields__})


def _inst_mats(M: np.ndarray):
    """(attr row (32,), woop A^T (4,4)) for one instance matrix."""
    Rm = M[:3, :3]
    t = M[:3, 3]
    invR = np.linalg.inv(Rm) if abs(np.linalg.det(Rm)) > 1e-12 else Rm.T
    invT = -invR @ t
    attr = np.zeros(32, np.float32)
    attr[0:12] = np.concatenate([Rm, t[:, None]], axis=1).reshape(-1)
    attr[12:24] = np.concatenate([invR, invT[:, None]], axis=1).reshape(-1)
    # A = [[invR, invT], [0, 1]], stored as A^T: the kernel moves a ray
    # into mesh-local space as [o_w 1] @ A^T and [d_w 0] @ A^T
    A = np.eye(4, dtype=np.float32)
    A[:3, :3] = invR
    A[:3, 3] = invT
    return attr, np.ascontiguousarray(A.T)


def build_instanced_layout(world: MeshTris | None,
                           meshes: dict[int, MeshTris],
                           instances: list[tuple[int, np.ndarray]],
                           k_tris: int = 128) -> InstancedLayout:
    """world: pre-flattened world-space geometry (identity instance 0) or
    None; meshes: mesh-local arrays per mesh id; instances: (mesh_id, 4x4)
    world transforms."""
    parts: list[MeshTris] = []
    pool_tris_parts: list[np.ndarray] = []
    pool_slot_parts: list[np.ndarray] = []
    # per source: (pool cluster offset, real cluster count, local bounds (C,6))
    mesh_cl: dict[int, tuple[int, int, np.ndarray]] = {}

    tri_off = 0
    pool_off = 0

    def add_mesh(key, mt: MeshTris):
        nonlocal tri_off, pool_off
        bvh = build_bvh_auto(mt.v0, mt.v0 + mt.e1, mt.v0 + mt.e2)
        p = bvh.perm if bvh.perm.size else np.arange(mt.v0.shape[0])
        mt = _permute_tris(mt, p)
        cs = cut_clusters(bvh, mt.v0, mt.e1, mt.e2, k_tris=k_tris)
        parts.append(mt)
        pool_tris_parts.append(cs.tris)
        st = cs.slot_tri.copy()
        st[st >= 0] += tri_off
        pool_slot_parts.append(st)
        C = cs.num_clusters
        bl = np.stack([cs.bounds_lane[0:3, :C].T,
                       cs.bounds_lane[3:6, :C].T], axis=1)  # (C, 2, 3)
        mesh_cl[key] = (pool_off, C, bl)
        tri_off += mt.v0.shape[0]
        pool_off += cs.tris.shape[0]

    if world is not None and world.v0.shape[0] > 0:
        add_mesh("world", world)
    used = sorted({mid for mid, _ in instances})
    for mid in used:
        add_mesh(mid, meshes[mid])

    # ---- instance table (0 = identity world instance)
    inst_list: list[tuple[str | int, np.ndarray]] = [("world", np.eye(4, dtype=np.float32))]
    inst_list += [(mid, M) for mid, M in instances]

    inst_attr = np.zeros((len(inst_list), 32), np.float32)
    inst_woop = np.zeros((len(inst_list), 4, 4), np.float32)
    for i, (_, M) in enumerate(inst_list):
        inst_attr[i], inst_woop[i] = _inst_mats(np.asarray(M, np.float32))

    # ---- instance-clusters
    rows = []  # (pool cluster, instance, bmin(3), bmax(3))
    for i, (key, M) in enumerate(inst_list):
        if key not in mesh_cl:
            continue  # world row when world is None
        off, C, bl = mesh_cl[key]
        if C == 0:
            continue
        Rm = np.asarray(M, np.float32)[:3, :3]
        t = np.asarray(M, np.float32)[:3, 3]
        c_l = (bl[:, 0] + bl[:, 1]) * 0.5
        e_l = (bl[:, 1] - bl[:, 0]) * 0.5
        c_w = c_l @ Rm.T + t
        e_w = e_l @ np.abs(Rm).T
        pc = np.arange(off, off + C, dtype=np.int32)
        ii = np.full(C, i, np.int32)
        rows.append((pc, ii, (c_w - e_w).astype(np.float32),
                     (c_w + e_w).astype(np.float32)))

    pc = np.concatenate([r[0] for r in rows])
    ii = np.concatenate([r[1] for r in rows])
    bmin = np.concatenate([r[2] for r in rows])
    bmax = np.concatenate([r[3] for r in rows])
    Ci = len(pc)
    Cip = max((Ci + 127) // 128 * 128, 128)

    bounds = np.zeros((8, Cip), np.float32)
    bounds[0:6, :] = 1e30  # padded: far-away point box
    bounds[0:3, :Ci] = bmin.T
    bounds[3:6, :Ci] = bmax.T

    cl_map = np.zeros((2, Cip), np.int32)
    cl_map[0, :Ci] = pc
    cl_map[1, :Ci] = ii

    pool_slot = np.concatenate(pool_slot_parts)
    slot_tri2 = np.full((Cip * 128, 2), -1, np.int32)
    for g in range(Ci):
        s = pc[g] * 128
        slot_tri2[g * 128:(g + 1) * 128, 0] = pool_slot[s:s + 128]
        slot_tri2[g * 128:(g + 1) * 128, 1] = ii[g]

    # front-to-back per-octant order over world centers (clusters.py logic)
    center = (bounds[0:3, :] + bounds[3:6, :]) * 0.5
    pad = np.arange(Cip) >= Ci
    oct_perm = np.zeros((8, Cip), np.int32)
    for o in range(8):
        s = np.array([1.0 if o & 1 else -1.0,
                      1.0 if o & 2 else -1.0,
                      1.0 if o & 4 else -1.0])
        key = s @ center
        key[pad] = np.inf
        oct_perm[o] = np.argsort(key, kind="stable").astype(np.int32)
    bounds_oct = np.zeros((8, 8, Cip), np.float32)
    for o in range(8):
        bounds_oct[o] = bounds[:, oct_perm[o]]

    wb_min = bmin.min(0).astype(np.float32)
    wb_ext = np.maximum(bmax.max(0) - wb_min, 1e-6).astype(np.float32)

    return InstancedLayout(
        tris=concat_tris(parts),
        pool_tris=np.concatenate(pool_tris_parts),
        bounds_lane=bounds, bounds_oct=bounds_oct, oct_perm=oct_perm,
        cl_map=cl_map, slot_tri2=slot_tri2,
        inst_attr=inst_attr, inst_woop=inst_woop,
        world_bmin=wb_min, world_bext=wb_ext,
        num_instances=len(inst_list), num_iclusters=Ci,
    )


# children of an inner node of the instance tree (instance_tables;
# csrc/traverse_cluster.cu kTreeFan): of 2, 4 and 8, timed on an H100, 4
# was the fastest or within about 1% on every wavefront of the sphereflake
# and of a 25-instance scene
TREE_FAN = 4
# the most stack entries B3's tree walk may hold (csrc/traverse_cluster.cu
# kTreeStack): depth x (TREE_FAN - 1) + 1 of the deepest leaf
TREE_STACK = 64


def _area(lo, hi):
    """Half the surface area of the boxes [lo, hi] (..., 3)."""
    e = hi - lo
    return e[..., 0] * e[..., 1] + e[..., 1] * e[..., 2] + e[..., 2] * e[..., 0]


def _seg_scan(v, rank, big, op, sign):
    """Running `op` (np.minimum / np.maximum) of v (n, ...) along axis 0
    within runs of equal `rank` (ascending, step 1): each run is shifted by
    sign * rank * big, with big above v's range, so that no value of an
    earlier run wins. Exact to the rounding of the shift (the costs of the
    surface area heuristic need no more)."""
    shift = (sign * big * rank.astype(np.float64)).reshape(
        (-1,) + (1,) * (v.ndim - 1))
    return op.accumulate(v + shift, axis=0) - shift


def _binary_sah(lo, hi):
    """A binary tree over m boxes (lo, hi (m, 3) float64) by the surface
    area heuristic, built top down one depth at a time: every node of more
    than one box is cut where the boxes sorted by centre along one axis
    split with the least area x count summed over both sides. Where that
    cut gains nothing on the node's own area x count (boxes that share one
    centre: every cut costs the same), the node is cut at its median
    instead, into halves of its count, so that such boxes make no chain.
    Returns (left, right, area, item) over the tree's nodes (node 0 the
    root): a leaf has left = right = -1 and its box in `item`, an inner
    node item = -1; area is half the surface area of each node's box."""
    m = lo.shape[0]
    cen = lo + hi
    big = 2.0 * float(max(hi.max() - lo.min(), 1.0)) + 1.0
    seg = np.zeros(m, np.int64)  # each box's node
    left = np.full(2 * m - 1, -1, np.int64)  # a binary tree of m leaves
    right = np.full(2 * m - 1, -1, np.int64)
    area = np.zeros(2 * m - 1)
    area[0] = _area(lo.min(0), hi.max(0))
    base = 1  # the next free node
    while True:
        sizes = np.bincount(seg)
        idx = np.flatnonzero(sizes[seg] > 1)
        if not idx.size:
            break
        s = seg[idx]
        nodes, size = np.unique(s, return_counts=True)
        starts = np.cumsum(size) - size  # the runs, in node order
        S = nodes.size
        r = np.repeat(np.arange(S), size)  # each position's run
        pos = np.arange(idx.size) - starts[r]
        cost = np.empty((3, idx.size))
        orders, pre, suf = [], [], []
        for a in range(3):
            o = idx[np.lexsort((cen[idx, a], s))]  # runs by node, then centre
            bl, bh = lo[o], hi[o]
            p = _area(_seg_scan(bl, r, big, np.minimum, -1.0),
                      _seg_scan(bh, r, big, np.maximum, 1.0))
            q = _area(_seg_scan(bl[::-1], r[::-1], big, np.minimum, 1.0),
                      _seg_scan(bh[::-1], r[::-1], big, np.maximum, -1.0))[::-1]
            nxt = np.append(q[1:], 0.0)
            cost[a] = np.where(pos < size[r] - 1,
                               p * (pos + 1) + nxt * (size[r] - pos - 1), np.inf)
            orders.append(o)
            pre.append(p)
            suf.append(nxt)
        best = np.lexsort((cost, np.broadcast_to(r, cost.shape)), axis=1)
        best = np.take_along_axis(best, starts[None].repeat(3, 0), axis=1)
        least = np.take_along_axis(cost, best, axis=1)
        ax = np.argmin(least, axis=0)  # (S,)
        at = best[ax, np.arange(S)]  # the cut: its last left position
        whole = area[nodes] * size  # the cost of no cut
        median = least[ax, np.arange(S)] >= whole * (1.0 - 1e-9)
        at = np.where(median, starts + size // 2 - 1, at)
        left[nodes] = base + 2 * np.arange(S)
        right[nodes] = left[nodes] + 1
        area[left[nodes]] = np.asarray(pre)[ax, at]
        area[right[nodes]] = np.asarray(suf)[ax, at]
        o = np.asarray(orders)[ax[r], np.arange(idx.size)]
        seg[o] = base + 2 * r + (pos > pos[at][r])
        base += 2 * S
    item = np.full(2 * m - 1, -1, np.int64)
    item[seg] = np.arange(m)
    return left, right, area, item


def instance_tree(inst_bounds):
    """A bounding-volume tree over the instances whose box is real (the
    others own no cluster and are left out): the binary tree of
    _binary_sah with its nodes merged top down, each node opening its
    child of the largest box (of equal boxes, the one over more instances)
    until it has TREE_FAN children. Returns
    (children (Nn, TREE_FAN) int64, the ids of each inner node's children:
    an instance i < I, inner node j as I + j, -1 where a node has fewer;
    node_bounds (8, Nn) float32, each the float32 union of its children's
    boxes, bit for bit). Node 0 is the root; the nodes are numbered
    breadth first. With at most TREE_FAN instances the root's children are
    the instances themselves."""
    b = np.asarray(inst_bounds, np.float32)
    I = b.shape[1]
    real = np.flatnonzero(b[0] < 1e29)
    children, depth = [], []
    if real.size:
        left, right, area, item = _binary_sah(
            b[0:3, real].T.astype(np.float64), b[3:6, real].T.astype(np.float64))
        count = (left < 0).astype(np.int64)  # instances below each node
        for j in np.flatnonzero(left >= 0)[::-1]:  # children after parents
            count[j] = count[left[j]] + count[right[j]]
        todo = [0]  # the binary node each inner node starts from
        depth = [0]
        for j, top in enumerate(todo):
            parts = [top] if left[top] < 0 else [left[top], right[top]]
            while len(parts) < TREE_FAN:
                inner = [k for k, p in enumerate(parts) if left[p] >= 0]
                if not inner:
                    break
                k = max(inner, key=lambda k: (area[parts[k]],
                                              count[parts[k]]))
                parts[k:k + 1] = [left[parts[k]], right[parts[k]]]
            row = []
            for p in parts:
                if left[p] < 0:
                    row.append(int(real[item[p]]))
                else:
                    row.append(I + len(todo))
                    todo.append(p)
                    depth.append(depth[j] + 1)
            children.append(row + [-1] * (TREE_FAN - len(row)))
    else:
        children, depth = [[-1] * TREE_FAN], [0]
    children = np.asarray(children, np.int64).reshape(-1, TREE_FAN)
    depth = np.asarray(depth)
    Nn = children.shape[0]
    # bottom up, a depth at a time: each node's box from its children's
    lo = np.full((3, I + Nn + 1), np.inf, np.float32)  # the last: no child
    hi = np.full((3, I + Nn + 1), -np.inf, np.float32)
    lo[:, real], hi[:, real] = b[0:3, real], b[3:6, real]
    for d in range(int(depth.max()), -1, -1):
        at = np.flatnonzero(depth == d)
        kids = np.where(children[at] >= 0, children[at], I + Nn)
        lo[:, I + at] = lo[:, kids].min(axis=2)
        hi[:, I + at] = hi[:, kids].max(axis=2)
    node_bounds = np.zeros((8, Nn), np.float32)
    node_bounds[0:3], node_bounds[3:6] = lo[:, I:I + Nn], hi[:, I:I + Nn]
    empty = ~np.isfinite(node_bounds[0])
    node_bounds[0:6, empty] = 1e30  # no instance below: the far point box
    return children, node_bounds


def tree_stack(children, n_inst: int) -> int:
    """The most entries B3's walk of the tree `children` (instance_tree)
    can hold on its stack, whatever the order of the children: popping a
    node pushes its c children, of which c - 1 wait while the first is
    walked."""
    need = np.ones(children.shape[0], np.int64)
    for j in range(children.shape[0] - 1, -1, -1):
        kids = children[j][children[j] >= 0]
        if kids.size:
            inner = kids[kids >= n_inst] - n_inst
            below = int(need[inner].max()) if inner.size else 1
            need[j] = kids.size - 1 + below
    return int(need[0]) if children.shape[0] else 1


def instance_tables(bounds_lane, oct_perm, cl_map, n_inst: int) -> dict:
    """The upper level of kernel B3's two-level walk (the tables
    ops/traverse_cluster.py:LEVEL_TABLES names), derived from the
    instance-cluster tables alone (a layout from either package gets the
    same tables). Its leaves are the instances, under a tree:
      lvl_bounds        (8, I) f32 each instance's world AABB, the union of
                        its instance-clusters' boxes, laid out like
                        bounds_lane; an instance without a cluster gets the
                        1e30 point box (and is in no node of the tree);
      lvl_oct_perm      (8, 0) i32: no flat order (B3 walks the tree);
      lvl_members       (8, Ci) i32 per octant the real instance-clusters
                        grouped by instance id, each group in that octant's
                        front-to-back order (a stable filter of
                        oct_perm[o]), the padding last;
      lvl_member_bounds (8, 8, Ci) f32 bounds_lane in lvl_members[o]'s
                        order;
      lvl_start         (I + 1,) i32 the groups' offsets into lvl_members[o]
                        (the same in every octant);
      lvl_nodes         (8, Nn * TREE_FAN) i32 the tree (instance_tree):
                        per octant, inner node j's children at
                        [j * TREE_FAN, (j + 1) * TREE_FAN), front to back
                        (by s . centre of each child's box, s the octant's
                        signs), the empty slots (-1) last; a child is an instance i < I or inner
                        node j' as I + j'; node 0 is the root;
      lvl_node_bounds   (8, Nn) f32 each inner node's box, the float32
                        union of its children's boxes, laid out like
                        lvl_bounds.
    Each cluster box lies inside its instance's box and each box inside its
    parent node's, and the slab test is monotone under rounding, so a ray
    that misses a node misses every instance and cluster under it: the walk
    from the root drops nothing the flat vote over every instance would
    enter. Its depth is bounded by TREE_STACK, the kernel's stack."""
    bounds = np.asarray(bounds_lane, np.float32)
    oct_perm = np.asarray(oct_perm, np.int32)
    inst = np.asarray(cl_map, np.int32)[1]
    real = bounds[0] < 1e29  # padding: the 1e30 point box
    if real.any() and not 0 <= inst[real].min() <= inst[real].max() < n_inst:
        raise ValueError(f"cl_map names instances outside [0, {n_inst})")
    counts = np.bincount(inst[real], minlength=n_inst)
    lo = np.full((n_inst, 3), np.inf, np.float32)
    hi = np.full((n_inst, 3), -np.inf, np.float32)
    np.minimum.at(lo, inst[real], bounds[0:3, real].T)
    np.maximum.at(hi, inst[real], bounds[3:6, real].T)
    has = counts > 0
    inst_bounds = np.zeros((8, n_inst), np.float32)
    inst_bounds[0:6] = 1e30
    inst_bounds[0:3, has] = lo[has].T
    inst_bounds[3:6, has] = hi[has].T

    children, node_bounds = instance_tree(inst_bounds)
    need = tree_stack(children, n_inst)
    if need > TREE_STACK:
        raise ValueError(f"the instance tree needs a stack of {need}, the "
                         f"kernel holds {TREE_STACK}")
    center = (inst_bounds[0:3] + inst_bounds[3:6]) * 0.5
    kid_center = np.concatenate(
        [center, (node_bounds[0:3] + node_bounds[3:6]) * 0.5, np.zeros((3, 1))],
        axis=1)[:, children]  # (3, Nn, TREE_FAN); -1 reads the zero column
    icl_oct = np.zeros((8, bounds.shape[1]), np.int32)
    nodes = np.zeros((8,) + children.shape, np.int32)
    for o in range(8):
        s = np.array([1.0 if o & 1 else -1.0,
                      1.0 if o & 2 else -1.0,
                      1.0 if o & 4 else -1.0])
        ids = oct_perm[o]
        group = np.where(real[ids], inst[ids], n_inst)
        icl_oct[o] = ids[np.argsort(group, kind="stable")]
        kk = np.einsum("a,anf->nf", s, kid_center)
        kk[children < 0] = np.inf
        nodes[o] = np.take_along_axis(
            children, np.argsort(kk, axis=1, kind="stable"), axis=1)
    return dict(
        lvl_bounds=inst_bounds, lvl_oct_perm=np.zeros((8, 0), np.int32),
        lvl_members=icl_oct,
        lvl_member_bounds=np.stack([bounds[:, icl_oct[o]] for o in range(8)]),
        lvl_start=np.concatenate([[0], np.cumsum(counts)]).astype(np.int32),
        lvl_nodes=nodes.reshape(8, -1), lvl_node_bounds=node_bounds)
