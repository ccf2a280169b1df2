"""Light table: the SoA light records of the JAX package's
scene/lights.py and its pick CDF, without the statefile XML compiler (a
later slice). pack_light_attr flattens a table into one (L, LA_WIDTH)
float32 row per light.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

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
