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


def instance_tables(bounds_lane, oct_perm, cl_map, n_inst: int) -> dict:
    """The upper level of kernel B3's two-level walk (the tables
    ops/traverse_cluster.py:LEVEL_TABLES names), derived from the
    instance-cluster tables alone (a layout from either package gets the
    same tables). Its boxes are the instances:
      lvl_bounds        (8, I) f32 each instance's world AABB, the union of
                        its instance-clusters' boxes, laid out like
                        bounds_lane; an instance without a cluster gets the
                        1e30 point box;
      lvl_oct_perm      (8, I) i32 each octant's front-to-back instance
                        order, by the centre key of the cluster order;
      lvl_members       (8, Ci) i32 per octant the real instance-clusters
                        grouped by instance id, each group in that octant's
                        front-to-back order (a stable filter of
                        oct_perm[o]), the padding last;
      lvl_member_bounds (8, 8, Ci) f32 bounds_lane in lvl_members[o]'s
                        order;
      lvl_start         (I + 1,) i32 the groups' offsets into lvl_members[o]
                        (the same in every octant).
    Each cluster box lies inside its instance's box, so a ray that misses
    the instance box misses every cluster box in it."""
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

    center = (inst_bounds[0:3] + inst_bounds[3:6]) * 0.5
    inst_oct_perm = np.zeros((8, n_inst), np.int32)
    icl_oct = np.zeros((8, bounds.shape[1]), np.int32)
    for o in range(8):
        s = np.array([1.0 if o & 1 else -1.0,
                      1.0 if o & 2 else -1.0,
                      1.0 if o & 4 else -1.0])
        key = s @ center
        key[~has] = np.inf
        inst_oct_perm[o] = np.argsort(key, kind="stable")
        ids = oct_perm[o]
        group = np.where(real[ids], inst[ids], n_inst)
        icl_oct[o] = ids[np.argsort(group, kind="stable")]
    return dict(
        lvl_bounds=inst_bounds, lvl_oct_perm=inst_oct_perm, lvl_members=icl_oct,
        lvl_member_bounds=np.stack([bounds[:, icl_oct[o]] for o in range(8)]),
        lvl_start=np.concatenate([[0], np.cumsum(counts)]).astype(np.int32))
