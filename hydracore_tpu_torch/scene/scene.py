"""SceneData: the port's scene, a dataclass of tensors with .to(device),
and the scene assembler (statefile / SceneDesc -> SceneData).

Host code (assemble here, scene/procedural.py for recipes) compiles numpy
arrays and finalize_scene derives the packed rows (tri_attr, mat_attr,
light_attr, cl_slot_tri2) and static feature gates exactly as the JAX
package's scene/scene.py does, so both packages hold the same bytes for
the same SceneDesc or recipe. Three cluster layouts come out, all read by
ops/traverse_cluster.py: a flat pool, a pool partitioned into chunks (more
than CL_PART_CAP clusters), and the two-level instanced layout
(bvh/instanced.py). Beside them every scene carries the binary BVH
(bvh_*), its 8-wide collapse (wbvh_*, bvh/wide.py) and the packed rows of
the packet kernel (pkt_*); an instanced scene holds one-triangle dummies
there, since only the cluster kernels read its layout. scene_from_arrays
turns the numpy leaves of a JAX-built scene into a port scene.

Which traversal reads the scene is one static choice on it, `traversal`
(ops/trace_api.py): "auto", or "dense", "cluster", "packet", "wide" by
name. Textures (image, normal map, blend mask, opacity), procedural
textures with their AO input, SSS, glass fog, sky images, back plates, IES
profiles and the render layers are carried; a procedural texture that
ships its C source is compiled by ops/proctex_c.py (outside the
translator's subset, a ProcTexCompileError warns and the stdlib match is
bound, ops/proctex.py), and check_supported refuses scenes the port cannot
take.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from hydracore_tpu_torch.bvh.clusters import (CL_PART_CAP, cut_clusters,
                                              group_tables, maybe_partition)
from hydracore_tpu_torch.bvh.native import build_bvh_auto
from hydracore_tpu_torch.bvh.wide import collapse_wide
from hydracore_tpu_torch.ops.traverse_packet import pack_pools
from hydracore_tpu_torch.scene.camera import CameraParams, build_camera
from hydracore_tpu_torch.scene.lights import LightTable, build_light_table
from hydracore_tpu_torch.scene.materials import (MaterialTable,
                                                 build_material_table)
from hydracore_tpu_torch.scene.statefile import (RenderSettings, SceneDesc,
                                                 load_statefile, parse_floats)
from hydracore_tpu_torch.scene.textures import (build_texture_storage,
                                                load_texture_array)
from hydracore_tpu_torch.utils import spans
from hydracore_tpu_torch.utils.device import resolve_device, tree_to


@dataclass
class SceneData:
    # geometry (world space, reordered to BVH leaf order)
    tri_v0: object  # (T,3)
    tri_e1: object  # (T,3) v1-v0
    tri_e2: object  # (T,3) v2-v0
    n0: object  # (T,3) shading normals at the 3 vertices
    n1: object
    n2: object
    t0: object  # (T,3) shading tangents
    t1: object
    t2: object
    uv0: object  # (T,2)
    uv1: object
    uv2: object
    tri_mat: object  # (T,) int32
    tri_light: object  # (T,) int32 light-table row or -1
    tri_inst: object  # (T,) int32 instance id
    # binary SAH BVH (bvh/builder.py) read by ops/traverse.py
    bvh_bmin: object  # (N,3)
    bvh_bmax: object  # (N,3)
    bvh_left: object  # (N,)
    bvh_right: object  # (N,)
    bvh_count: object  # (N,)
    # its 8-wide collapse (bvh/wide.py) read by ops/traverse_wide.py and
    # ops/traverse_dense.py, and the packet kernel's packed rows
    # (ops/traverse_packet.py:pack_pools)
    wbvh_nodes: object  # (Nw,8,8) f32, child payload bitcast in [:, :, 6]
    wbvh_tri9f: object  # (B, LEAF*16) f32 block-row triangle table
    wbvh_slot_tri: object  # (B*LEAF,) i32
    pkt_nodes: object  # (Np,128) f32, payload read through .view(int32)
    pkt_tris: object  # (Bp,128) f32
    # cluster pool (bvh/clusters.py) read by ops/traverse_cluster.py; a
    # partitioned pool carries a leading chunk axis P on every cl_* array
    # but cl_slot_tri, which stays flat in chunk-major order
    cl_bounds: object  # (8, Cp) f32 AABB rows [xm ym zm xM yM zM 0 0]
    cl_tris: object  # (Cp, 4, 384) f32 Woop rows [Mu|Mv|Mw]
    cl_slot_tri: object  # (Cp*128,) i32
    cl_oct_perm: object  # (8, Cp) i32 per-octant front-to-back order
    cl_bounds_oct: object  # (8, 8, Cp) f32 bounds pre-permuted per octant
    world_bmin: object  # (3,) f32 scene AABB (ray-coherence Morton keys)
    world_bext: object  # (3,) f32 scene AABB extent (>= eps)
    # mesh-light sampling tables (lights with ltype LIGHT_MESH)
    ml_cdf: object  # (ML, TMAX) f32 per-light area CDF over triangles
    ml_tri: object  # (ML, TMAX) i32 global triangle ids (-1 pad)
    materials: MaterialTable
    lights: LightTable
    texels: object  # (X,4) texture heap (slot 0: one white texel)
    tex_table: object  # (K,4) [offset,w,h,flags]
    tex_sampler: object  # (K,8) f32 sampler rows
    camera: CameraParams
    env_color: object  # (3,) sky radiance fallback
    env_rows_cdf: object  # (Ht+1,)
    env_cols_cdf: object  # (Ht, Wt+1)
    env_pdf_uv: object  # (Ht, Wt)
    settings: RenderSettings = None
    # packed rows (finalize_scene)
    tri_attr: object = None  # (T, 40) f32 [v0 e1 e2 n0 n1 n2 t0 t1 t2 uv0 uv1 uv2 mat light inst 0*4]
    cl_slot_tri2: object = None  # (S, 2) i32 slot -> [tri, instance]
    mat_attr: object = None  # (M, MA_WIDTH_FULL) f32 packed material rows
    light_attr: object = None  # (L, LA_WIDTH) f32 packed light rows
    tex_meta: object = None  # (K, 12) f32 [bitcast(off,w,h,flags) | sampler 8f]
    # two-level instancing (bvh/instanced.py): the geometry above is
    # mesh-LOCAL, cl_bounds* are world AABBs of instance-clusters over the
    # shared Woop pool cl_tris; None for flattened scenes
    cl_map: object = None  # (2, Ci) i32 [pool cluster; instance]
    cl_slot_inst: object = None  # (S,) i32 slot -> instance id
    inst_attr: object = None  # (I, 32) f32 [M 3x4 | invM 3x4 | pad]
    inst_orig: object = None  # (I,) i32 row -> desc.instances index (-1 = flattened world)
    inst_woop: object = None  # (I, 4, 4) f32 A^T (world -> mesh-local)
    # the upper level of the cluster kernels' two-level walk, derived from
    # cl_bounds / cl_oct_perm (and cl_map): the instances of an instanced
    # pool under a tree (bvh/instanced.py:instance_tables, kernel B3),
    # groups of clusters of any other, with no tree
    # (bvh/clusters.py:group_tables, B1/B2); never read from a compiled
    # scene
    lvl_bounds: object = None  # (8, N) f32 AABB of each upper box
    lvl_oct_perm: object = None  # (8, N) i32 front-to-back per octant; B3 (8, 0)
    lvl_members: object = None  # (8, M) i32 clusters grouped by upper box
    lvl_member_bounds: object = None  # (8, 8, M) f32 their boxes, that order
    lvl_start: object = None  # (N + 1,) i32 group offsets into lvl_members
    lvl_nodes: object = None  # (8, Nn * TREE_FAN) i32 B3's tree, children a node
    lvl_node_bounds: object = None  # (8, Nn) f32 its nodes' boxes
    # split shadow sets of alpha scenes (None unless has_alpha)
    cl_tris_shadow: object = None  # (Cp, 4, 384) f32
    alpha_tri9f: object = None  # (9, A) f32
    alpha_tri_id: object = None  # (A,) i32
    env_back: object = None  # (8,) f32 sky back-plate row
    # static (plain Python values, not tensors)
    wbvh_depth: int = 16  # wide-tree depth (root = 1)
    traversal: str = "auto"  # ops/trace_api.py: which traversal reads the scene

    def __post_init__(self):
        check_traversal(self.traversal, self.cl_map is not None)

    @property
    def num_triangles(self) -> int:
        return int(self.tri_v0.shape[0])

    def to(self, device) -> "SceneData":
        return tree_to(self, device)


# leaves that may be None: the instanced layout's tables, the shadow split
# of alpha scenes, the sky back plate
_INSTANCED = ("cl_map", "cl_slot_inst", "inst_attr", "inst_orig", "inst_woop")
# derived from the cluster tables: not leaves of a compiled scene (the
# upper level of the two-level walk)
_DERIVED = ("lvl_bounds", "lvl_oct_perm", "lvl_members", "lvl_member_bounds",
            "lvl_start", "lvl_nodes", "lvl_node_bounds")
_OPTIONAL = _INSTANCED + _DERIVED + ("cl_tris_shadow", "alpha_tri9f",
                                     "alpha_tri_id", "env_back")

# static fields: Python values that scene_leaves / scene_from_arrays carry
# as they are (wbvh_depth) or that only the port has (traversal)
TRAVERSALS = ("auto", "dense", "cluster", "packet", "wide")


def check_traversal(traversal: str, instanced: bool) -> None:
    """Validate a scene's static traversal choice (ops/trace_api.py reads
    it): only the cluster kernels understand the instanced layout. Every
    SceneData checks itself when it is made; assemble and SceneBuilder.build
    also call this first, to refuse a choice before they build anything."""
    if traversal not in TRAVERSALS:
        raise ValueError(f"traversal must be one of {TRAVERSALS}, "
                         f"got {traversal!r}")
    if instanced and traversal not in ("auto", "cluster"):
        raise ValueError(f"an instanced scene is traversed by the cluster "
                         f"kernels only, not by traversal={traversal!r}")


def part_cap_for(traversal: str, part_cap: int) -> int:
    """The packet and wide routes never read the cluster pool, and keep it
    flat whatever its size."""
    return (1 << 30) if traversal in ("packet", "wide") else part_cap


def wide_pools(bvh, tri_v0, tri_e1, tri_e2) -> dict:
    """The bvh_*, wbvh_* and pkt_* fields of a scene from its binary BVH
    and its triangles in leaf order."""
    wbvh = collapse_wide(bvh, tri_v0, tri_e1, tri_e2)
    pkt_nodes, pkt_tris = pack_pools(wbvh.nodes, wbvh.tri9f, wbvh.max_depth)
    return dict(
        bvh_bmin=bvh.bmin, bvh_bmax=bvh.bmax, bvh_left=bvh.left,
        bvh_right=bvh.right, bvh_count=bvh.count,
        wbvh_nodes=wbvh.nodes, wbvh_tri9f=wbvh.tri9f,
        wbvh_slot_tri=wbvh.slot_tri, wbvh_depth=wbvh.max_depth,
        pkt_nodes=pkt_nodes, pkt_tris=pkt_tris)


# auto instancing kicks in above this many flattened triangles (when the
# two-level layout actually saves memory; see _should_instance)
INSTANCING_AUTO_TRIS = 400_000
_TABLES = {"materials": MaterialTable, "lights": LightTable,
           "camera": CameraParams}


def _settings_flags(materials) -> dict:
    """Static material feature gates (the JAX package's _settings_flags)."""
    return {
        "has_alpha": bool((np.asarray(materials.opacity_tex) != 0).any()),
        "has_blend": bool((np.asarray(materials.blend_node) >= 0).any()),
        "has_rough_glass": bool(((np.asarray(materials.transp_gloss) < 0.999)
                                 & (np.asarray(materials.transp_color).max(-1) > 0)).any()),
        "has_transl": bool((np.asarray(materials.transl_color).max(-1) > 0).any()),
        "has_aniso": bool((np.asarray(materials.refl_aniso) > 1e-3).any()),
        "has_ms_comp": bool(((((np.asarray(materials.refl_dist) == 2)
                               | (np.asarray(materials.refl_dist) == 3))
                              & (np.asarray(materials.refl_alpha) > 0.05))
                             | ((np.asarray(materials.transp_gloss) < 0.999)
                                & (np.asarray(materials.transp_color).max(-1)
                                   > 0))).any()),
    }


def _build_env(desc, lights, tex_remap=None):
    """Sky fallback color + env importance tables + the optional second-env
    back plate row (<back> under the sky light: camera-mapped or spherical
    texture replacing the env for camera-visible rays — the reference's
    backColorOfSecondEnv machinery, RenderDriverRTE.cpp:945-963,
    cbidir.h:543-572, consumed in environmentColorExtended :624)."""
    from hydracore_tpu_torch.lights.envmap import build_env_pdf

    env = np.zeros(3, np.float32)
    env_img = None
    env_back = np.zeros(8, np.float32)
    for row in range(len(np.asarray(lights.ltype))):
        if int(np.asarray(lights.ltype)[row]) == 3:  # LIGHT_SKY
            env = np.asarray(lights.intensity)[row]
            sid = int(np.asarray(lights.statefile_id)[row])
            lnode = desc.lights.get(sid)
            if lnode is not None:
                inten = lnode.find("intensity")
                t = inten.find("texture") if inten is not None else None
                if t is not None:
                    env_img = load_texture_array(desc, int(t.get("id", -1)))
                back = lnode.find("back")
                bt = back.find("texture") if back is not None else None
                if bt is not None and tex_remap is not None:
                    tid = int(bt.get("id", -1))
                    slot = int(tex_remap[tid]) if 0 <= tid < len(tex_remap) else 0
                    if slot > 0:
                        mode = 1.0 if (back.get("mode") or "") == "spherical" \
                            else 2.0
                        # LDR slots are linearized at finalize (the default
                        # input gamma 2.2 is BAKED into the heap texels,
                        # textures.TextureStorage.finalize); env_back[2]
                        # records the binding's gamma for provenance only —
                        # a non-default <back input_gamma=...> differing
                        # from the baked value is not re-applied at fetch
                        gamma = float(bt.get("input_gamma", 2.2))
                        mult = parse_floats(back.get("multcolor"), [1, 1, 1])
                        env_back[:6] = [slot, mode, gamma,
                                        mult[0], mult[1], mult[2]]
            break
    if env_img is None:
        env_img = np.ones((8, 16, 4), np.float32)  # sin-weighted uniform sky
    env_rows, env_cols, env_pdf = build_env_pdf(env_img)
    return env, env_rows, env_cols, env_pdf, env_back


def _partition_instances(desc, lid_to_row):
    """Split instances into (instanceable, must-flatten). Emissive meshes,
    remapped instances, single-use meshes and absent chunks flatten; meshes
    instanced >= 2x without those features keep shared local geometry
    (the reference instances everything through its two-level tree,
    ctrace.h:841; flattening the rest is this design's simplification)."""
    from collections import Counter

    uses = Counter()
    for inst in desc.instances:
        if desc.meshes.get(inst.mesh_id) is not None:
            uses[inst.mesh_id] += 1

    keep, flat = [], []
    for inst in desc.instances:
        mesh = desc.meshes.get(inst.mesh_id)
        if mesh is None:
            continue
        light_id = inst.light_id if inst.light_id >= 0 else \
            desc.mesh_light_id.get(inst.mesh_id, -1)
        remapped = inst.remap_list is not None and inst.remap_list.size >= 2
        if light_id >= 0 or remapped or uses[inst.mesh_id] < 2:
            flat.append(inst)
        else:
            keep.append(inst)
    return keep, flat


def _should_instance(desc, keep, flat, instancing: str) -> bool:
    if instancing == "off" or not keep:
        return False
    if instancing == "force":
        return True
    flat_tris = sum(desc.meshes[i.mesh_id].num_triangles for i in keep + flat)
    unique_tris = sum(desc.meshes[m].num_triangles
                      for m in {i.mesh_id for i in keep})
    stored = unique_tris + sum(desc.meshes[i.mesh_id].num_triangles for i in flat)
    return flat_tris > INSTANCING_AUTO_TRIS and stored < 0.6 * flat_tris


@spans.spanned("scene.build")
def assemble(desc: SceneDesc, width: int | None = None, height: int | None = None,
             instancing: str = "auto", part_cap: int = CL_PART_CAP,
             traversal: str = "auto") -> SceneData:
    """Compile a SceneDesc into a SceneData of CPU tensors (the JAX
    package's assemble, the same bytes out). instancing: 'auto' (two-level
    layout when it saves memory on big scenes), 'force' (always when any
    instanceable mesh exists), 'off'. A flattened pool of more than
    `part_cap` clusters is partitioned into chunks of that many. traversal:
    the scene's static choice of traversal (ops/trace_api.py); 'packet' and
    'wide' keep the cluster pool flat, and an instanced scene takes only
    'auto' or 'cluster'. The span `scene.build` (utils/spans.py), a flat
    layout's stages its children."""
    if instancing not in ("auto", "force", "off"):
        raise ValueError(f"instancing must be auto, force or off, "
                         f"got {instancing!r}")
    check_traversal(traversal, False)
    st = desc.settings
    W = width or st.width
    H = height or st.height

    texels, tex_table, tex_sampler, tex_remap, bump_slots, ies_slots = \
        build_texture_storage(desc)
    materials = build_material_table(desc, tex_remap, bump_slots)
    lights = build_light_table(desc, tex_remap, ies_slots)

    # map statefile light id -> light-table row (area lights; first match)
    lid_to_row = {}
    for row, sid in enumerate(np.asarray(lights.statefile_id)):
        if sid >= 0 and int(sid) not in lid_to_row:
            lid_to_row[int(sid)] = row

    keep, flat = _partition_instances(desc, lid_to_row)
    if _should_instance(desc, keep, flat, instancing):
        check_traversal(traversal, True)
        return _assemble_instanced(desc, W, H, keep, flat, lid_to_row,
                                   materials, lights, texels, tex_table,
                                   tex_sampler, tex_remap, traversal)

    # ---- flatten instances to world space
    v0s, e1s, e2s = [], [], []
    n0s, n1s, n2s = [], [], []
    t0s, t1s, t2s = [], [], []
    uv0s, uv1s, uv2s = [], [], []
    mats, lids, insts = [], [], []
    for inst_id, inst in enumerate(desc.instances):
        mesh = desc.meshes.get(inst.mesh_id)
        if mesh is None:
            continue  # delayed-load chunk absent — skip (loader note)
        M = inst.matrix
        R = M[:3, :3]
        pos = mesh.pos[:, :3] @ R.T + M[:3, 3]
        n_mat = np.linalg.inv(R).T if abs(np.linalg.det(R)) > 1e-12 else R
        nrm = mesh.norm[:, :3] @ n_mat.T
        nlen = np.linalg.norm(nrm, axis=1, keepdims=True)
        nrm = nrm / np.maximum(nlen, 1e-12)
        tng = mesh.tang[:, :3] @ R.T
        tng = tng / np.maximum(np.linalg.norm(tng, axis=1, keepdims=True), 1e-12)

        ia, ib, ic = mesh.indices[:, 0], mesh.indices[:, 1], mesh.indices[:, 2]
        a, b, c = pos[ia], pos[ib], pos[ic]
        v0s.append(a)
        e1s.append(b - a)
        e2s.append(c - a)
        n0s.append(nrm[ia])
        n1s.append(nrm[ib])
        n2s.append(nrm[ic])
        t0s.append(tng[ia])
        t1s.append(tng[ib])
        t2s.append(tng[ic])
        uv0s.append(mesh.texcoord[ia])
        uv1s.append(mesh.texcoord[ib])
        uv2s.append(mesh.texcoord[ic])

        tri_m = mesh.mat_indices.copy()
        if inst.remap_list is not None and inst.remap_list.size >= 2:
            rl = inst.remap_list.reshape(-1, 2)
            remap = {int(f): int(t) for f, t in rl}
            tri_m = np.asarray([remap.get(int(m), int(m)) for m in tri_m], np.int32)
        mats.append(tri_m)

        lrow = -1
        light_id = inst.light_id if inst.light_id >= 0 else desc.mesh_light_id.get(inst.mesh_id, -1)
        if light_id >= 0:
            lrow = lid_to_row.get(light_id, -1)
        lids.append(np.full(len(tri_m), lrow, np.int32))
        insts.append(np.full(len(tri_m), inst_id, np.int32))

    if v0s:
        tri_v0 = np.concatenate(v0s).astype(np.float32)
        tri_e1 = np.concatenate(e1s).astype(np.float32)
        tri_e2 = np.concatenate(e2s).astype(np.float32)
        n0 = np.concatenate(n0s).astype(np.float32)
        n1 = np.concatenate(n1s).astype(np.float32)
        n2 = np.concatenate(n2s).astype(np.float32)
        t0 = np.concatenate(t0s).astype(np.float32)
        t1 = np.concatenate(t1s).astype(np.float32)
        t2 = np.concatenate(t2s).astype(np.float32)
        uv0 = np.concatenate(uv0s).astype(np.float32)
        uv1 = np.concatenate(uv1s).astype(np.float32)
        uv2 = np.concatenate(uv2s).astype(np.float32)
        tri_mat = np.concatenate(mats).astype(np.int32)
        tri_light = np.concatenate(lids).astype(np.int32)
        tri_inst = np.concatenate(insts).astype(np.int32)
    else:  # empty scene: one degenerate far-away triangle keeps shapes valid
        tri_v0 = np.full((1, 3), 1e30, np.float32)
        tri_e1 = np.zeros((1, 3), np.float32)
        tri_e2 = np.zeros((1, 3), np.float32)
        n0 = n1 = n2 = np.tile(np.array([[0, 1, 0]], np.float32), (1, 1))
        t0 = t1 = t2 = np.tile(np.array([[1, 0, 0]], np.float32), (1, 1))
        uv0 = uv1 = uv2 = np.zeros((1, 2), np.float32)
        tri_mat = np.zeros(1, np.int32)
        tri_light = np.full(1, -1, np.int32)
        tri_inst = np.zeros(1, np.int32)

    with spans.span("scene.bvh"):
        bvh = build_bvh_auto(tri_v0, tri_v0 + tri_e1, tri_v0 + tri_e2)
    p = bvh.perm if bvh.perm.size else np.zeros(0, np.int32)
    if p.size:
        tri_v0, tri_e1, tri_e2 = tri_v0[p], tri_e1[p], tri_e2[p]
        n0, n1, n2 = n0[p], n1[p], n2[p]
        t0, t1, t2 = t0[p], t1[p], t2[p]
        uv0, uv1, uv2 = uv0[p], uv1[p], uv2[p]
        tri_mat, tri_light, tri_inst = tri_mat[p], tri_light[p], tri_inst[p]

    with spans.span("scene.layout"):
        pools = wide_pools(bvh, tri_v0, tri_e1, tri_e2)
        cl = maybe_partition(cut_clusters(bvh, tri_v0, tri_e1, tri_e2),
                             part_cap_for(traversal, part_cap))

    pts = np.concatenate([tri_v0, tri_v0 + tri_e1, tri_v0 + tri_e2], 0)
    wb_min = pts.min(0).astype(np.float32)
    wb_ext = np.maximum(pts.max(0) - pts.min(0), 1e-6).astype(np.float32)

    with spans.span("scene.camera"):
        cam = build_camera(desc.camera, W, H)

    with spans.span("scene.lights"):
        lights, ml_cdf, ml_tri = build_mesh_light_tables(
            lights, tri_light, tri_v0, tri_e1, tri_e2)

    # env fallback: sky light color if present else black; build env
    # importance tables from the sky texture (constant-sky fallback table)
    env, env_rows, env_cols, env_pdf, env_back = _build_env(desc, lights,
                                                            tex_remap)

    st2 = RenderSettings(**{**st.__dict__, "width": W, "height": H,
                            **_settings_flags(materials),
                            "has_env_back": bool(env_back[1] > 0)})

    return finalize_scene(SceneData(
        tri_v0=tri_v0, tri_e1=tri_e1, tri_e2=tri_e2,
        n0=n0, n1=n1, n2=n2, t0=t0, t1=t1, t2=t2,
        uv0=uv0, uv1=uv1, uv2=uv2,
        tri_mat=tri_mat, tri_light=tri_light, tri_inst=tri_inst,
        cl_bounds=cl.bounds_lane, cl_tris=cl.tris, cl_slot_tri=cl.slot_tri,
        cl_oct_perm=cl.oct_perm, cl_bounds_oct=cl.bounds_oct,
        world_bmin=wb_min, world_bext=wb_ext,
        ml_cdf=ml_cdf, ml_tri=ml_tri,
        materials=materials, lights=lights,
        texels=texels, tex_table=tex_table, tex_sampler=tex_sampler,
        camera=cam, env_color=env, env_back=env_back,
        env_rows_cdf=env_rows, env_cols_cdf=env_cols, env_pdf_uv=env_pdf,
        settings=st2, traversal=traversal, **pools,
        **group_tables(cl.bounds_lane, cl.oct_perm),
    ))


def _assemble_instanced(desc, W, H, keep, flat, lid_to_row, materials,
                        lights, texels, tex_table, tex_sampler,
                        tex_remap=None, traversal: str = "auto") -> SceneData:
    """Two-level layout: shared local-space mesh pools + instantiated
    cluster AABBs (bvh/instanced.py). Non-instanceable geometry (lights,
    remaps, single-use meshes) flattens into the identity instance 0."""
    from hydracore_tpu_torch.bvh.instanced import (build_instanced_layout,
                                                   concat_tris,
                                                   instance_tables,
                                                   mesh_local_tris,
                                                   transform_tris)

    # original desc.instances indices: gbuffer ids must not depend on
    # whether auto-instancing kicked in (flat mode reports these)
    orig_of = {id(i): k for k, i in enumerate(desc.instances)}

    world_parts = []
    for inst in flat:
        inst_id = orig_of.get(id(inst), 0)
        mesh = desc.meshes[inst.mesh_id]
        remap = None
        if inst.remap_list is not None and inst.remap_list.size >= 2:
            rl = inst.remap_list.reshape(-1, 2)
            remap = {int(f): int(t) for f, t in rl}
        lrow = -1
        light_id = inst.light_id if inst.light_id >= 0 else \
            desc.mesh_light_id.get(inst.mesh_id, -1)
        if light_id >= 0:
            lrow = lid_to_row.get(light_id, -1)
        world_parts.append(transform_tris(
            mesh_local_tris(mesh, remap, lrow, inst_id), inst.matrix))
    world = concat_tris(world_parts) if world_parts else None

    local = {mid: mesh_local_tris(desc.meshes[mid])
             for mid in {i.mesh_id for i in keep}}
    layout = build_instanced_layout(
        world, local, [(i.mesh_id, i.matrix) for i in keep])
    inst_orig = np.asarray([-1] + [orig_of.get(id(i), -1) for i in keep],
                           np.int32)
    mt = layout.tris

    # single-level pools (binary, wide, packet, dense): one-triangle dummies,
    # the dispatcher sends an instanced scene to the cluster kernels only
    dummy_v0 = np.full((1, 3), 1e30, np.float32)
    dz = np.zeros((1, 3), np.float32)
    pools = wide_pools(build_bvh_auto(dummy_v0, dummy_v0, dummy_v0),
                       dummy_v0, dz, dz)

    cam = build_camera(desc.camera, W, H)
    lights2, ml_cdf, ml_tri = build_mesh_light_tables(
        lights, mt.light, mt.v0, mt.e1, mt.e2)
    env, env_rows, env_cols, env_pdf, env_back = _build_env(desc, lights2,
                                                            tex_remap)

    st2 = RenderSettings(**{**desc.settings.__dict__, "width": W, "height": H,
                            **_settings_flags(materials), "has_inst": True,
                            "has_env_back": bool(env_back[1] > 0)})

    return finalize_scene(SceneData(
        tri_v0=mt.v0, tri_e1=mt.e1, tri_e2=mt.e2,
        n0=mt.n0, n1=mt.n1, n2=mt.n2, t0=mt.t0, t1=mt.t1, t2=mt.t2,
        uv0=mt.uv0, uv1=mt.uv1, uv2=mt.uv2,
        tri_mat=mt.mat, tri_light=mt.light, tri_inst=mt.inst,
        cl_bounds=layout.bounds_lane, cl_tris=layout.pool_tris,
        cl_slot_tri=np.ascontiguousarray(layout.slot_tri2[:, 0]),
        cl_oct_perm=layout.oct_perm, cl_bounds_oct=layout.bounds_oct,
        world_bmin=layout.world_bmin, world_bext=layout.world_bext,
        ml_cdf=ml_cdf, ml_tri=ml_tri,
        materials=materials, lights=lights2,
        texels=texels, tex_table=tex_table, tex_sampler=tex_sampler,
        camera=cam, env_color=env, env_back=env_back,
        env_rows_cdf=env_rows, env_cols_cdf=env_cols, env_pdf_uv=env_pdf,
        settings=st2,
        cl_map=layout.cl_map,
        cl_slot_inst=np.ascontiguousarray(layout.slot_tri2[:, 1]),
        inst_attr=layout.inst_attr, inst_woop=layout.inst_woop,
        inst_orig=inst_orig, traversal=traversal, **pools,
        **instance_tables(layout.bounds_lane, layout.oct_perm, layout.cl_map,
                          layout.num_instances),
    ))


def load_scene(lib_dir: str, width: int | None = None, height: int | None = None,
               instancing: str = "auto", statefile: str | None = None,
               part_cap: int = CL_PART_CAP,
               traversal: str = "auto") -> SceneData:
    """Load a HydraAPI scene library directory into a SceneData of CPU
    tensors. `statefile` picks an explicit statex_NNNNN.xml inside the
    library (default = the latest); the other arguments are assemble's."""
    return assemble(load_statefile(lib_dir, statefile), width, height,
                    instancing, part_cap, traversal)


def _blend_depth(blend_node: np.ndarray, blend_top: np.ndarray) -> int:
    """Longest blend chain (levels of blend records a fetch may traverse)."""
    depth = 1
    M = blend_node.shape[0]
    memo = {}

    def walk(mid, seen):
        if mid < 0 or mid >= M or mid in seen:
            return 0
        if mid in memo:
            return memo[mid]
        if blend_node[mid] < 0 and blend_top[mid] < 0:
            memo[mid] = 0
            return 0
        seen = seen | {mid}
        d = 1 + max(walk(int(blend_node[mid]), seen),
                    walk(int(blend_top[mid]), seen))
        memo[mid] = d
        return d

    for m in range(M):
        depth = max(depth, walk(m, frozenset()))
    return depth


def finalize_scene(sc: SceneData) -> SceneData:
    """Derive the packed rows + static feature gates from the raw numpy
    tables (the JAX package's finalize_scene, bit for bit), check that the
    scene needs nothing the port lacks yet, and return it as CPU
    tensors."""
    from hydracore_tpu_torch.scene.lights import (LIGHT_MESH, LIGHT_POINT,
                                                  LIGHT_SKY, LIGHT_SPOT,
                                                  pack_light_attr)
    from hydracore_tpu_torch.scene.materials import (bake_tex_meta,
                                                     pack_mat_attr)

    tri_attr = np.concatenate(
        [np.asarray(x, np.float32) for x in (
            sc.tri_v0, sc.tri_e1, sc.tri_e2, sc.n0, sc.n1, sc.n2,
            sc.t0, sc.t1, sc.t2, sc.uv0, sc.uv1, sc.uv2)]
        + [np.asarray(sc.tri_mat, np.float32)[:, None],
           np.asarray(sc.tri_light, np.float32)[:, None],
           np.asarray(sc.tri_inst, np.float32)[:, None],
           np.zeros((sc.tri_v0.shape[0], 4), np.float32)],
        axis=1)

    slot = np.asarray(sc.cl_slot_tri, np.int32)
    col1 = (np.asarray(sc.cl_slot_inst, np.int32)
            if sc.cl_slot_inst is not None else slot)
    cl_slot_tri2 = np.stack([slot, col1], axis=1)

    tex_meta = np.concatenate(
        [np.asarray(sc.tex_table, np.int32).view(np.float32),
         np.asarray(sc.tex_sampler, np.float32)], axis=1)

    st = sc.settings
    if st is not None:
        lt, mt = sc.lights, sc.materials
        ltypes = np.asarray(lt.ltype)
        present = tuple(sorted({int(x) for x in ltypes}))
        point_spot = (ltypes == LIGHT_POINT) | (ltypes == LIGHT_SPOT)
        st = dataclasses.replace(
            st,
            light_types=present,
            has_sky=bool((ltypes == LIGHT_SKY).any()),
            has_ies=bool(((np.asarray(lt.tex) > 0) & point_spot).any()),
            has_portal=bool((np.asarray(lt.is_portal) > 0).any()),
            has_mesh_light=bool((ltypes == LIGHT_MESH).any()),
            has_em_tex=bool((np.asarray(mt.em_tex) != 0).any()),
            has_diff_tex=bool((np.asarray(mt.diff_tex) != 0).any()
                              or (np.asarray(mt.blend_tex) > 1).any()),
            has_refl_tex=bool((np.asarray(mt.refl_tex) != 0).any()),
            has_transl_tex=bool((np.asarray(mt.transl_tex) != 0).any()),
            has_proc_tex=bool((np.asarray(mt.diff_proc) >= 0).any()),
            has_bump=bool((np.asarray(mt.bump_tex) > 0).any()),
            has_sss=bool((np.asarray(mt.sss_transmission) > 0).any()),
            has_fog=bool((np.asarray(mt.fog_mult) > 0).any()),
            has_proc_ao=bool((np.asarray(mt.ao_type) > 0).any()),
            has_transl=bool(getattr(st, "has_transl", True)
                            or (np.asarray(mt.sss_transmission) > 0).any()),
            blend_depth=_blend_depth(np.asarray(mt.blend_node),
                                     np.asarray(mt.blend_top)),
        )

    shadow_fields = _build_shadow_split(sc, st)
    out = dataclasses.replace(
        sc, tri_attr=tri_attr, cl_slot_tri2=cl_slot_tri2,
        mat_attr=bake_tex_meta(pack_mat_attr(sc.materials), tex_meta),
        light_attr=pack_light_attr(sc.lights), tex_meta=tex_meta,
        settings=st, **shadow_fields)
    check_supported(out)
    return out.to("cpu")


# alpha sets beyond this keep the legacy layered closest-hit shadow walk
ALPHA_SPLIT_MAX = 4096


def _mat_shadow_soft(mt) -> np.ndarray:
    """Per-material 'may pass shadow rays' flag: own opacity texture or
    skip_shadow, closed over blend children."""
    soft = (np.asarray(mt.opacity_tex) != 0) | (np.asarray(mt.skip_shadow) != 0)
    node = np.asarray(mt.blend_node)
    top = np.asarray(mt.blend_top)
    for _ in range(max(_blend_depth(node, top), 1)):
        soft = soft | ((node >= 0) & soft[np.clip(node, 0, len(soft) - 1)]) \
            | ((top >= 0) & soft[np.clip(top, 0, len(soft) - 1)])
    return soft


def _build_shadow_split(sc: SceneData, st) -> dict:
    """Opaque-only cluster pool + dense alpha triangle set for alpha scenes
    (the JAX package's _build_shadow_split; flattened scenes only): NEE
    shadow rays walk the opaque pool with kernel B2 and test the alpha set
    densely (integrators/pt.py:shadow_trace)."""
    none = dict(cl_tris_shadow=None, alpha_tri9f=None, alpha_tri_id=None)
    if st is None or not getattr(st, "has_alpha", False):
        return none
    if sc.cl_map is not None:  # instanced: slot ids are not global tris
        return none
    soft_mat = _mat_shadow_soft(sc.materials)
    tri_soft = soft_mat[np.clip(np.asarray(sc.tri_mat), 0, len(soft_mat) - 1)]
    ids = np.where(tri_soft)[0].astype(np.int32)
    if ids.size == 0 or ids.size > ALPHA_SPLIT_MAX:
        return none

    # opaque pool: degenerate the soft lanes (all-zero Woop block -> the
    # kernel's t = -0/0 = nan fails every hit comparison)
    slot = np.asarray(sc.cl_slot_tri, np.int32)
    lane_soft = (slot >= 0) & tri_soft[np.clip(slot, 0, len(tri_soft) - 1)]
    cl_shadow = np.array(sc.cl_tris, np.float32, copy=True)
    flat = cl_shadow.reshape(-1, 4, 384)
    lane_soft = lane_soft.reshape(flat.shape[0], 128)
    kill = np.repeat(lane_soft[:, None, :], 4, axis=1)  # (C, 4, 128)
    kill = np.concatenate([kill, kill, kill], axis=2)  # [Mu|Mv|Mw] lanes
    flat[kill] = 0.0

    # dense alpha set, field-major (9, A) padded to a lane multiple
    A = int(np.ceil(ids.size / 128) * 128)
    tri9 = np.zeros((9, A), np.float32)
    tri9[0:3, : ids.size] = np.asarray(sc.tri_v0)[ids].T
    tri9[0:3, ids.size:] = 1e30  # far-away degenerate padding
    tri9[3:6, : ids.size] = np.asarray(sc.tri_e1)[ids].T
    tri9[6:9, : ids.size] = np.asarray(sc.tri_e2)[ids].T
    tid = np.full(A, -1, np.int32)
    tid[: ids.size] = ids
    return dict(cl_tris_shadow=cl_shadow, alpha_tri9f=tri9, alpha_tri_id=tid)


def build_mesh_light_tables(lights, tri_light, tri_v0, tri_e1, tri_e2):
    """Per-mesh-light triangle area CDFs (CalcTrianglePickProbTable
    analogue): rows index via lights.mesh_row; total surface area lands in
    lights.area so the standard area-light pdf path covers mesh lights."""
    from hydracore_tpu_torch.scene.lights import LIGHT_MESH, compute_pick_cdf

    ltypes = np.asarray(lights.ltype)
    mesh_rows = np.where(ltypes == LIGHT_MESH)[0]
    if len(mesh_rows) == 0:
        return lights, np.ones((1, 8), np.float32), np.full((1, 8), -1, np.int32)

    areas_all = 0.5 * np.linalg.norm(np.cross(tri_e1, tri_e2), axis=1)
    tmax = 8
    per_row = []
    for lrow in mesh_rows:
        tids = np.where(np.asarray(tri_light) == lrow)[0]
        tmax = max(tmax, len(tids))
        per_row.append(tids)
    tmax = int(2 ** np.ceil(np.log2(max(tmax, 8))))

    ML = len(mesh_rows)
    ml_cdf = np.ones((ML, tmax), np.float32)
    ml_tri = np.full((ML, tmax), -1, np.int32)
    new_area = np.asarray(lights.area).copy()
    new_mesh_row = np.asarray(lights.mesh_row).copy()
    for mi, (lrow, tids) in enumerate(zip(mesh_rows, per_row)):
        a = areas_all[tids] if len(tids) else np.zeros(1)
        tot = max(float(a.sum()), 1e-12)
        if len(tids):
            ml_cdf[mi, : len(tids)] = np.cumsum(a) / tot
            ml_tri[mi, : len(tids)] = tids
            ml_tri[mi, len(tids):] = tids[-1]
        ml_cdf[mi, len(tids):] = 2.0  # unreachable
        new_area[lrow] = tot
        new_mesh_row[lrow] = mi

    recs = [dict(ltype=int(ltypes[i]),
                 intensity=np.asarray(lights.intensity)[i],
                 area=float(new_area[i]),
                 is_portal=int(np.asarray(lights.is_portal)[i]))
            for i in range(len(ltypes))]
    cdf = compute_pick_cdf(recs)
    return dataclasses.replace(lights, area=new_area.astype(np.float32),
                               mesh_row=new_mesh_row.astype(np.int32),
                               pick_cdf=cdf), ml_cdf, ml_tri


RENDER_LAYERS = ("color", "direct", "indirect")


def check_supported(sc: SceneData) -> None:
    """Raise for a scene the port cannot take: one without RenderSettings
    (NotImplementedError), settings.has_inst without the instanced tables
    or the other way round, or an unknown render layer (ValueError).
    Procedural textures (from a C source too: ops/proctex_c.py compiles
    it, and a ProcTexCompileError warns and binds the stdlib match), their
    AO input, SSS, glass fog and the direct and indirect layers all
    render."""
    st = sc.settings
    if st is None:
        raise NotImplementedError("a scene without RenderSettings")
    if bool(st.has_inst) != (sc.cl_map is not None):
        raise ValueError("settings.has_inst and the instanced tables "
                         "(cl_map, ...) must come together")
    if st.render_layer not in RENDER_LAYERS:
        raise ValueError(f"render_layer={st.render_layer!r}, not one of "
                         f"{RENDER_LAYERS}")


def scene_leaves(sc: SceneData) -> dict:
    """Flat {name: numpy array} view of a scene; table fields are named
    'materials.em_color', 'lights.pick_cdf', 'camera.pos', ... The tables
    derived from other leaves (_DERIVED) are left out."""
    out = {}
    for f in dataclasses.fields(sc):
        v = getattr(sc, f.name)
        if f.name in _TABLES:
            for g in dataclasses.fields(v):
                w = getattr(v, g.name)
                if isinstance(w, torch.Tensor):
                    out[f"{f.name}.{g.name}"] = w.cpu().numpy()
        elif isinstance(v, torch.Tensor) and f.name not in _DERIVED:
            out[f.name] = v.cpu().numpy()
        elif f.name == "wbvh_depth":
            out[f.name] = np.asarray(v)
    return out


def leaf_names() -> list:
    """Every leaf name scene_from_arrays reads (optional ones included)."""
    names = []
    for f in dataclasses.fields(SceneData):
        if f.name in ("settings", "traversal") + _DERIVED:
            continue
        if f.name in _TABLES:
            names += [f"{f.name}.{g.name}"
                      for g in dataclasses.fields(_TABLES[f.name])
                      if g.name not in ("width", "height")]
        else:
            names.append(f.name)
    return names


def scene_from_arrays(leaves: dict, settings: dict, device=None,
                      traversal: str = "auto") -> SceneData:
    """Build a port scene from the numpy leaves of a scene compiled
    elsewhere (the JAX package's SceneData: the names of leaf_names()).
    The bytes are taken as they are — nothing is recompiled — so both
    packages render the very same scene. `settings` holds the
    RenderSettings fields; the camera takes its width/height from them.
    `traversal` is the port's static choice of traversal for the scene.
    The level of the two-level walk (_DERIVED: an instanced scene's
    instance level, any other's group level) is derived from the cluster
    tables here, as assemble derives it."""
    dev = resolve_device(device)
    st = RenderSettings(**settings)
    kw = {"traversal": traversal}
    for f in dataclasses.fields(SceneData):
        if f.name in ("settings", "traversal") + _DERIVED:
            continue
        if f.name == "wbvh_depth":
            kw[f.name] = int(leaves[f.name])
            continue
        if f.name in _TABLES:
            cls = _TABLES[f.name]
            sub = {g.name: np.asarray(leaves[f"{f.name}.{g.name}"])
                   for g in dataclasses.fields(cls)
                   if g.name not in ("width", "height")}
            if cls is CameraParams:
                sub.update(width=int(st.width), height=int(st.height))
            kw[f.name] = cls(**sub)
        elif f.name in leaves and leaves[f.name] is not None:
            kw[f.name] = np.asarray(leaves[f.name])
        elif f.name not in _OPTIONAL:
            raise KeyError(f"scene leaf {f.name!r} missing")
    missing = [n for n in _INSTANCED if n not in kw]
    if "cl_map" in kw and missing:
        raise KeyError(f"instanced scene leaves missing: {missing}")
    sc = SceneData(settings=st, **kw)
    check_supported(sc)
    if sc.cl_map is not None:
        from hydracore_tpu_torch.bvh.instanced import instance_tables
        sc = dataclasses.replace(sc, **instance_tables(
            sc.cl_bounds, sc.cl_oct_perm, sc.cl_map, sc.inst_woop.shape[0]))
    else:
        sc = dataclasses.replace(sc, **group_tables(sc.cl_bounds,
                                                    sc.cl_oct_perm))
    return sc.to(dev)
