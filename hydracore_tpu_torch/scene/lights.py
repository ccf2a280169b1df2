"""Light table: the SoA light records of the JAX package's
scene/lights.py, its statefile XML compiler (build_light_table: instance
matrices are applied at compile time) and its pick CDF. pack_light_attr
flattens a table into one (L, LA_WIDTH) float32 row per light.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from hydracore_tpu_torch.scene.statefile import SceneDesc, get_color, get_float
from hydracore_tpu_torch.utils.device import tree_to

LIGHT_POINT = 0
LIGHT_SPOT = 1
LIGHT_DIRECT = 2
LIGHT_SKY = 3
LIGHT_AREA_RECT = 4
LIGHT_AREA_DISK = 5
LIGHT_SPHERE = 6
LIGHT_CYLINDER = 7  # axis along local Y, radiates radially (ref clight.h cylinder)
LIGHT_MESH = 8  # arbitrary emissive mesh (ref PlainLightConverter.cpp:724)



@dataclass
class LightTable:
    """SoA over instanced lights (length L; L >= 1, slot padding benign)."""

    ltype: np.ndarray  # (L,)
    pos: np.ndarray  # (L,3) world position / center
    norm: np.ndarray  # (L,3) emission normal (area), direction (spot/direct)
    vx: np.ndarray  # (L,3) rect half-axis * half_length (world)
    vy: np.ndarray  # (L,3) rect half-axis * half_width (world)
    intensity: np.ndarray  # (L,3) radiance (area) / radiant intensity (point)
    radius: np.ndarray  # (L,) sphere/disk radius
    area: np.ndarray  # (L,) surface area (world)
    cos_in: np.ndarray  # (L,) spot inner cone cos
    cos_out: np.ndarray  # (L,) spot outer cone cos
    tex: np.ndarray  # (L,) sky texture slot (0 = none/white)
    mesh_row: np.ndarray  # (L,) row into the scene's mesh-light CDF tables
    is_portal: np.ndarray  # (L,) area light is a sky portal (clight SkyPortal)
    pick_cdf: np.ndarray  # (L+1,) prefix CDF over pick probability
    statefile_id: np.ndarray  # (L,) original light id

    def to(self, device) -> "LightTable":
        return tree_to(self, device)


def _lum(c) -> float:
    return float(0.2126 * c[0] + 0.7152 * c[1] + 0.0722 * c[2])


# ----------------------------------------------------------------------------
# Packed light row: one (L, 28) float32 row per light, the JAX package's
# layout bit for bit (sync with lights/sampling.py):
LA_POS = 0        # [0:3)
LA_NORM = 3       # [3:6)
LA_VX = 6         # [6:9)
LA_VY = 9         # [9:12)
LA_INTEN = 12     # [12:15)
LA_RADIUS = 15
LA_AREA = 16
LA_COS_IN = 17
LA_COS_OUT = 18
LA_TYPE = 19
LA_PORTAL = 20
LA_MESH_ROW = 21
LA_TEX = 22
LA_PICK_PROB = 23  # pick_cdf[i+1] - pick_cdf[i] (saves 2 CDF gathers at MIS)
LA_WIDTH = 28


def pack_light_attr(lt: "LightTable") -> np.ndarray:
    """(L, LA_WIDTH) float32 packed light rows (layout above)."""
    L = np.asarray(lt.ltype).shape[0]
    a = np.zeros((L, LA_WIDTH), np.float32)
    a[:, LA_POS:LA_POS + 3] = np.asarray(lt.pos)
    a[:, LA_NORM:LA_NORM + 3] = np.asarray(lt.norm)
    a[:, LA_VX:LA_VX + 3] = np.asarray(lt.vx)
    a[:, LA_VY:LA_VY + 3] = np.asarray(lt.vy)
    a[:, LA_INTEN:LA_INTEN + 3] = np.asarray(lt.intensity)
    a[:, LA_RADIUS] = np.asarray(lt.radius)
    a[:, LA_AREA] = np.asarray(lt.area)
    a[:, LA_COS_IN] = np.asarray(lt.cos_in)
    a[:, LA_COS_OUT] = np.asarray(lt.cos_out)
    a[:, LA_TYPE] = np.asarray(lt.ltype).astype(np.float32)
    a[:, LA_PORTAL] = np.asarray(lt.is_portal).astype(np.float32)
    a[:, LA_MESH_ROW] = np.asarray(lt.mesh_row).astype(np.float32)
    a[:, LA_TEX] = np.asarray(lt.tex).astype(np.float32)
    cdf = np.asarray(lt.pick_cdf)
    a[:, LA_PICK_PROB] = np.maximum(cdf[1:] - cdf[:-1], 1e-12)
    return a


def build_light_table(desc: SceneDesc, tex_remap: np.ndarray,
                      ies_slots: dict | None = None) -> LightTable:
    recs = []

    # sky lights are not instanced in <scenes>; add them directly
    for lid, node in desc.lights.items():
        if node.get("type") == "sky":
            recs.append(_compile(node, np.eye(4, dtype=np.float32), lid, tex_remap))

    for li in desc.light_instances:
        node = desc.lights.get(li.light_id)
        if node is None or node.get("type") == "sky":
            continue
        rec = _compile(node, li.matrix, li.light_id, tex_remap)
        if ies_slots and li.light_id in ies_slots:
            rec["tex"] = ies_slots[li.light_id]  # IES spherical profile
        recs.append(rec)

    if not recs:  # keep shapes static: one dummy dark light
        recs.append(_blank())

    def stack(key, dtype):
        return np.asarray([r[key] for r in recs], dtype)

    cdf = compute_pick_cdf(recs)

    return LightTable(
        ltype=stack("ltype", np.int32),
        pos=stack("pos", np.float32),
        norm=stack("norm", np.float32),
        vx=stack("vx", np.float32),
        vy=stack("vy", np.float32),
        intensity=stack("intensity", np.float32),
        radius=stack("radius", np.float32),
        area=stack("area", np.float32),
        cos_in=stack("cos_in", np.float32),
        cos_out=stack("cos_out", np.float32),
        tex=stack("tex", np.int32),
        mesh_row=stack("mesh_row", np.int32),
        is_portal=stack("is_portal", np.int32),
        pick_cdf=cdf,
        statefile_id=stack("statefile_id", np.int32),
    )


def _blank() -> dict:
    return dict(
        ltype=LIGHT_POINT,
        pos=np.zeros(3, np.float32),
        norm=np.array([0, -1, 0], np.float32),
        vx=np.array([1, 0, 0], np.float32),
        vy=np.array([0, 0, 1], np.float32),
        intensity=np.zeros(3, np.float32),
        radius=0.0,
        area=0.0,
        cos_in=1.0,
        cos_out=1.0,
        tex=0,
        mesh_row=-1,
        is_portal=0,
        statefile_id=-1,
    )


def _compile(node, matrix: np.ndarray, lid: int, tex_remap: np.ndarray) -> dict:
    rec = _blank()
    rec["statefile_id"] = lid
    ltype = node.get("type", "point")
    shape = node.get("shape", "")

    inten = node.find("intensity")
    color = get_color(inten, "color", (1, 1, 1))
    mult = get_float(inten, "multiplier", 1.0)
    rec["intensity"] = color * mult

    R, T = matrix[:3, :3], matrix[:3, 3]
    rec["pos"] = T.astype(np.float32)
    # local emission frame: area lights emit along -Y (HydraAPI convention)
    rec["norm"] = _safe_normalize(R @ np.array([0, -1, 0], np.float32))

    size = node.find("size")
    if shape == "mesh" or ltype == "mesh":
        # emissive mesh light: the geometry arrives through the instanced
        # mesh (tri_light rows); the per-triangle area CDF is built in
        # scene assembly once triangles are flattened
        rec["ltype"] = LIGHT_MESH
        rec["area"] = 1.0
    elif ltype == "area":
        portal = node.find("sky_portal")
        if portal is not None and int(float(portal.get("val", 0))) == 1:
            rec["is_portal"] = 1
        if shape == "disk" or (size is not None and size.get("radius") is not None):
            r = float(size.get("radius", 1.0)) if size is not None else 1.0
            rec["ltype"] = LIGHT_AREA_DISK
            rec["radius"] = r
            rec["vx"] = R @ np.array([r, 0, 0], np.float32)
            rec["vy"] = R @ np.array([0, 0, r], np.float32)
            # true sampled-parallelogram area (robust to shear / non-
            # uniform scale in the instance matrix — the pdf must match the
            # actually sampled surface): pi * |vx x vy|
            rec["area"] = float(np.pi * np.linalg.norm(np.cross(rec["vx"], rec["vy"])))
        else:
            hl = float(size.get("half_length", 1.0)) if size is not None else 1.0
            hw = float(size.get("half_width", 1.0)) if size is not None else 1.0
            rec["ltype"] = LIGHT_AREA_RECT
            rec["vx"] = R @ np.array([hl, 0, 0], np.float32)
            rec["vy"] = R @ np.array([0, 0, hw], np.float32)
            rec["area"] = float(4.0 * np.linalg.norm(np.cross(rec["vx"], rec["vy"])))
    elif ltype == "sphere":
        r = float(size.get("radius", 1.0)) if size is not None else 1.0
        rec["ltype"] = LIGHT_SPHERE
        rec["radius"] = r * float(np.cbrt(max(abs(np.linalg.det(R)), 1e-12)))
        rec["area"] = float(4.0 * np.pi * rec["radius"] ** 2)
    elif ltype == "cylinder":
        r = float(size.get("radius", 1.0)) if size is not None else 1.0
        h = float(size.get("height", size.get("half_length", 1.0))) if size is not None else 1.0
        rec["ltype"] = LIGHT_CYLINDER
        rec["radius"] = r
        rec["norm"] = _safe_normalize(R @ np.array([0, 1, 0], np.float32))  # axis
        rec["vx"] = (R @ np.array([0, 1, 0], np.float32)) * (h * 0.5)  # half-axis vector
        rec["area"] = float(2.0 * np.pi * r * h)
    elif ltype == "directional":
        rec["ltype"] = LIGHT_DIRECT
        rec["norm"] = _safe_normalize(R @ np.array([0, -1, 0], np.float32))
        if size is not None:
            rec["radius"] = float(size.get("inner_radius", 0.0))
    elif ltype == "sky":
        rec["ltype"] = LIGHT_SKY
        back = node.find("intensity")
        tid = -1
        if back is not None:
            t = back.find("texture")
            if t is not None:
                tid = int(t.get("id", -1))
        rec["tex"] = int(tex_remap[tid]) if 0 <= tid < len(tex_remap) else 0
    elif ltype == "spot":
        rec["ltype"] = LIGHT_SPOT
        a1 = get_float(node, "falloff_angle", 60.0)
        a2 = get_float(node, "falloff_angle2", a1)
        inner, outer = np.deg2rad(min(a1, a2) * 0.5), np.deg2rad(max(a1, a2) * 0.5)
        rec["cos_in"] = float(np.cos(inner))
        rec["cos_out"] = float(np.cos(outer))
    else:  # point / omni
        rec["ltype"] = LIGHT_POINT

    return rec


def _safe_normalize(v: np.ndarray) -> np.ndarray:
    n = np.linalg.norm(v)
    return (v / n if n > 1e-12 else v).astype(np.float32)


def compute_pick_cdf(recs) -> np.ndarray:
    """Light pick CDF ~ emitted power (CalcLightPickProbTable analogue,
    RenderDriverRTE.cpp:1499-1520). Sky portals REPLACE the sky dome for
    NEE (the reference swaps SkyPortalLight in for indoor scenes,
    PlainLightConverter.cpp:304): with any portal present the sky row gets
    (near-)zero pick probability."""
    has_portal = any(r.get("is_portal", 0) for r in recs)
    powers = []
    for r in recs:
        p = _lum(r["intensity"])
        if r["ltype"] in (LIGHT_AREA_RECT, LIGHT_AREA_DISK, LIGHT_SPHERE,
                          LIGHT_CYLINDER, LIGHT_MESH):
            p *= max(r["area"], 1e-6) * np.pi
        elif r["ltype"] == LIGHT_SKY:
            p *= 0.0 if has_portal else 4.0 * np.pi
        powers.append(max(p, 1e-8))
    powers = np.asarray(powers, np.float64)
    probs = powers / powers.sum()
    cdf = np.concatenate([[0.0], np.cumsum(probs)]).astype(np.float32)
    cdf[-1] = 1.0
    return cdf
