"""SceneData: the port's scene, a dataclass of tensors with .to(device).

Host code (scene/procedural.py) compiles numpy arrays and finalize_scene
derives the packed rows (tri_attr, mat_attr, light_attr, cl_slot_tri2) and
static feature gates exactly as the JAX package's scene/scene.py does, so
both packages hold the same bytes for the same recipe. scene_from_arrays
turns the numpy leaves of a JAX-built scene into a port scene.

The wide-BVH, packet and binary-BVH pools of the JAX scene are left out:
nothing in this slice reads them. Features this slice does not port raise
NotImplementedError naming the feature (check_supported).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from hydracore_tpu_torch.scene.camera import CameraParams
from hydracore_tpu_torch.scene.lights import LightTable
from hydracore_tpu_torch.scene.materials import MaterialTable
from hydracore_tpu_torch.scene.statefile import RenderSettings
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
    # cluster pool (bvh/clusters.py) read by ops/traverse_cluster.py
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
    texels: object  # (X,4) texture heap (one white texel in this slice)
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
    # split shadow sets of alpha scenes (None unless has_alpha)
    cl_tris_shadow: object = None  # (Cp, 4, 384) f32
    alpha_tri9f: object = None  # (9, A) f32
    alpha_tri_id: object = None  # (A,) i32
    env_back: object = None  # (8,) f32 sky back-plate row

    @property
    def num_triangles(self) -> int:
        return int(self.tri_v0.shape[0])

    def to(self, device) -> "SceneData":
        return tree_to(self, device)


# leaves that are None unless a feature this slice does not port is on
_OPTIONAL = ("cl_tris_shadow", "alpha_tri9f", "alpha_tri_id", "env_back")
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
    scene needs nothing this slice does not port, and return it as CPU
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
    cl_slot_tri2 = np.stack([slot, slot], axis=1)

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
    (the JAX package's _build_shadow_split). Alpha shading comes in a later
    slice, so check_supported refuses the scenes that get these leaves."""
    none = dict(cl_tris_shadow=None, alpha_tri9f=None, alpha_tri_id=None)
    if st is None or not getattr(st, "has_alpha", False):
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


def check_supported(sc: SceneData) -> None:
    """Raise NotImplementedError naming the first feature the scene needs
    that this slice of the port does not carry."""
    from hydracore_tpu_torch.scene.lights import LIGHT_SKY

    def host(x):
        return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)

    if sc.cl_tris.ndim != 3:
        raise NotImplementedError("partitioned cluster pool (more than "
                                  "1024 clusters)")
    st = sc.settings
    if st is None:
        raise NotImplementedError("a scene without RenderSettings")
    for flag, name in (
            ("has_inst", "instanced cluster pool"),
            ("has_alpha", "alpha (opacity textures)"),
            ("has_blend", "blend materials"),
            ("has_bump", "bump / normal maps"),
            ("has_proc_tex", "procedural textures"),
            ("has_sss", "subsurface scattering (SSS)"),
            ("has_fog", "glass fog"),
            ("has_proc_ao", "procedural-texture AO"),
            ("has_ies", "IES light profiles"),
            ("has_em_tex", "textures (emission)"),
            ("has_diff_tex", "textures (diffuse)"),
            ("has_refl_tex", "textures (reflection)"),
            ("has_transl_tex", "textures (translucency)"),
            ("has_env_back", "sky back plate")):
        if getattr(st, flag, False):
            raise NotImplementedError(name)
    if st.render_layer != "color":
        raise NotImplementedError(f"render_layer={st.render_layer!r}")
    ltype = host(sc.lights.ltype)
    if ((ltype == LIGHT_SKY) & (host(sc.lights.tex) > 0)).any():
        raise NotImplementedError("textures (sky image)")


def scene_leaves(sc: SceneData) -> dict:
    """Flat {name: numpy array} view of a scene; table fields are named
    'materials.em_color', 'lights.pick_cdf', 'camera.pos', ..."""
    out = {}
    for f in dataclasses.fields(sc):
        v = getattr(sc, f.name)
        if f.name in _TABLES:
            for g in dataclasses.fields(v):
                w = getattr(v, g.name)
                if isinstance(w, torch.Tensor):
                    out[f"{f.name}.{g.name}"] = w.cpu().numpy()
        elif isinstance(v, torch.Tensor):
            out[f.name] = v.cpu().numpy()
    return out


def leaf_names() -> list:
    """Every leaf name scene_from_arrays reads (optional ones included)."""
    names = []
    for f in dataclasses.fields(SceneData):
        if f.name == "settings":
            continue
        if f.name in _TABLES:
            names += [f"{f.name}.{g.name}"
                      for g in dataclasses.fields(_TABLES[f.name])
                      if g.name not in ("width", "height")]
        else:
            names.append(f.name)
    return names


def scene_from_arrays(leaves: dict, settings: dict, device=None) -> SceneData:
    """Build a port scene from the numpy leaves of a scene compiled
    elsewhere (the JAX package's SceneData: the names of leaf_names()).
    The bytes are taken as they are — nothing is recompiled — so both
    packages render the very same scene. `settings` holds the
    RenderSettings fields; the camera takes its width/height from them."""
    dev = resolve_device(device)
    if leaves.get("cl_map") is not None:
        raise NotImplementedError("instanced cluster pool")
    st = RenderSettings(**settings)
    kw = {}
    for f in dataclasses.fields(SceneData):
        if f.name == "settings":
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
    sc = SceneData(settings=st, **kw)
    check_supported(sc)
    return sc.to(dev)
