"""Light sampling (NEE) + pdf evaluation for MIS — vectorized (torch).

The JAX package's lights/sampling.py: one packed light row per ray
(scene.light_attr) and every per-type branch combined with masked selects
over the type enum; branches of light types the scene does not hold are
skipped (settings.light_types). Covers every light SceneBuilder makes:
rect, disk, sphere, cylinder, point, spot (both with an optional IES
profile), direct, mesh and a sky, constant or textured with a lat-long
image; and the sky's back plate (env_back_radiance).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from hydracore_tpu_torch.lights.envmap import env_pdf_for_dir, sample_env_dir
from hydracore_tpu_torch.scene.lights import (
    LA_AREA, LA_COS_IN, LA_COS_OUT, LA_INTEN, LA_MESH_ROW, LA_NORM,
    LA_PICK_PROB, LA_PORTAL, LA_POS, LA_RADIUS, LA_TEX, LA_TYPE, LA_VX, LA_VY,
    LIGHT_AREA_DISK, LIGHT_AREA_RECT, LIGHT_CYLINDER, LIGHT_DIRECT,
    LIGHT_MESH, LIGHT_POINT, LIGHT_SKY, LIGHT_SPHERE, LIGHT_SPOT)
from hydracore_tpu_torch.utils.math3d import (cross3, dot3,
                                              make_orthonormal_basis,
                                              normalize3, sqrt)

FAR_DIST = 1e8
PI = math.pi


def _smoothstep01(x):
    """Hermite falloff for spot penumbrae (mylocalsmoothstep, clight.h:7)."""
    x = torch.clamp(x, 0.0, 1.0)
    return x * x * (3.0 - 2.0 * x)


class LightSample(NamedTuple):
    dir: torch.Tensor  # (R,3) surface -> light
    dist: torch.Tensor  # (R,)
    radiance: torch.Tensor  # (R,3) incident radiance along dir
    pdf_w: torch.Tensor  # (R,) solid-angle pdf (1 for delta lights)
    is_delta: torch.Tensor  # (R,) bool — MIS weight 1
    cos_at_light: torch.Tensor  # (R,)
    pick_prob: torch.Tensor  # (R,) pick probability of this light


def light_rows(scene, l_idx):
    """Packed light_attr rows for light ids l_idx (R,)."""
    la = scene.light_attr
    return la[torch.clamp(l_idx.long(), 0, la.shape[0] - 1)]


def select_light(lights, u):
    """CDF pick: returns (index (R,), pick_prob (R,))."""
    cdf = lights.pick_cdf
    idx = torch.clamp((cdf[None, 1:-1] <= u[:, None]).sum(dim=1),
                      0, cdf.shape[0] - 2)
    prob = cdf[idx + 1] - cdf[idx]
    return idx.to(torch.int32), torch.clamp(prob, min=1e-12)


def _light_types(scene) -> set:
    st = scene.settings
    if st is None:
        return set(range(9))
    return set(getattr(st, "light_types", tuple(range(9))))


def _latlong_uv(d):
    """Lat-long texcoords of directions d (R, 3) (the sky image mapping)."""
    u = 0.5 + torch.atan2(d[:, 0], -d[:, 2]) * (0.5 / PI)
    v = torch.arccos(torch.clamp(d[:, 1], -1.0, 1.0)) * (1.0 / PI)
    return torch.stack([u, v], -1)


def env_radiance(scene, d):
    """Sky radiance along direction d (R,3): the sky light's color times
    its lat-long image where it has one (ref: environmentColorExtended,
    material.cl:344), or env_color in scenes without a sky light."""
    from hydracore_tpu_torch.ops.texture import tex_fetch

    lt = scene.lights
    if LIGHT_SKY not in _light_types(scene):
        return torch.broadcast_to(scene.env_color, d.shape)
    sky_rows = lt.ltype == LIGHT_SKY
    has_sky = sky_rows.any()
    sky_row = torch.argmax(sky_rows.to(torch.int32))
    tex = lt.tex[sky_row]
    texc = tex_fetch(scene, torch.broadcast_to(tex, (d.shape[0],)),
                     _latlong_uv(d))[:, :3]
    base = torch.where(has_sky, lt.intensity[sky_row], scene.env_color)
    return base[None, :] * torch.where(has_sky & (tex > 0), texc, 1.0)


def env_back_radiance(scene, d):
    """The sky's back plate color along direction d (R,3): a spherical
    lat-long lookup, or a camera-projected one (the screen uv of the
    direction's vanishing point, exact for pinhole primaries), of the <back>
    texture (ref backColorOfSecondEnv, cbidir.h:543-572). Only under
    settings.has_env_back; it replaces the env radiance for camera-visible
    rays (environmentColorExtended, cbidir.h:624)."""
    from hydracore_tpu_torch.ops.texture import tex_fetch

    eb = scene.env_back
    slot = eb[0].to(torch.int32)
    spherical = eb[1] < 1.5
    mult = eb[3:6]
    cam = scene.camera
    w2v = torch.linalg.inv(cam.mWorldViewInv)
    proj = torch.linalg.inv(cam.mProjInv)
    dv = d @ w2v[:3, :3].T
    pv = torch.cat([dv, torch.zeros_like(dv[:, :1])], -1) @ proj.T
    ndc = pv[:, :2] / torch.clamp(pv[:, 3:4].abs(), min=1e-12)
    u_c = torch.clamp(ndc[:, 0] * 0.5 + 0.5, 0.0, 1.0)
    v_c = torch.clamp(0.5 - ndc[:, 1] * 0.5, 0.0, 1.0)
    uv = torch.where(spherical, _latlong_uv(d), torch.stack([u_c, v_c], -1))
    texc = tex_fetch(scene, torch.broadcast_to(slot, (d.shape[0],)), uv)[:, :3]
    return mult[None, :] * texc


def sample_light_rev(scene, l_idx, rnds, sp, rows=None) -> LightSample:
    """Sample one point/direction on light l_idx (R,) from surface points sp
    (R,3) with rnds (R,3) uniforms. `rows` supplies prefetched light_attr
    rows."""
    types = _light_types(scene)
    a = light_rows(scene, l_idx) if rows is None else rows
    ltype = a[:, LA_TYPE].to(torch.int32)
    pos = a[:, LA_POS:LA_POS + 3]
    nrm = a[:, LA_NORM:LA_NORM + 3]
    vx = a[:, LA_VX:LA_VX + 3]
    vy = a[:, LA_VY:LA_VY + 3]
    inten = a[:, LA_INTEN:LA_INTEN + 3]
    radius = a[:, LA_RADIUS]
    area = torch.clamp(a[:, LA_AREA], min=1e-12)
    cos_in = a[:, LA_COS_IN]
    cos_out = a[:, LA_COS_OUT]
    pick_prob = a[:, LA_PICK_PROB]

    u1, u2 = rnds[:, 0], rnds[:, 1]

    def sel3(cond, x, y):
        return torch.where(cond[:, None], x, y)

    # shared geometry to the light center
    to_c = pos - sp
    dc2 = torch.clamp(dot3(to_c, to_c), min=1e-12)
    dc = sqrt(dc2)
    dir_p = to_c / dc[:, None]

    # defaults (point-light-ish); per-type branches overwrite below
    direction = dir_p
    dist = dc
    radiance = inten / dc2[:, None]
    pdf_w = torch.ones_like(dc)
    cos_at_light = torch.ones_like(dc)

    # --- IES photometric profile on point/spot (clight.h:411)
    if (LIGHT_POINT in types or LIGHT_SPOT in types) and \
            (scene.settings is None or getattr(scene.settings, "has_ies", True)):
        from hydracore_tpu_torch.ops.texture import tex_fetch

        tex_slot = a[:, LA_TEX].to(torch.int32)
        emit_dir = -dir_p
        cos_ax = torch.clamp(dot3(emit_dir, nrm), -1.0, 1.0)
        theta_v = torch.arccos(cos_ax) * (1.0 / PI)
        tb2, bb2 = make_orthonormal_basis(nrm)
        phi_v = torch.remainder(
            torch.atan2(dot3(emit_dir, bb2), dot3(emit_dir, tb2)) * (0.5 / PI),
            1.0)
        ies_val = tex_fetch(scene, tex_slot,
                            torch.stack([phi_v, theta_v], -1))[:, 0]
        has_ies = (tex_slot > 0) & ((ltype == LIGHT_POINT)
                                    | (ltype == LIGHT_SPOT))
        radiance = radiance * torch.where(has_ies, ies_val, 1.0)[:, None]

    # --- spot falloff
    if LIGHT_SPOT in types:
        spot_cos = dot3(nrm, -dir_p)
        spot_fall = _smoothstep01(
            (spot_cos - cos_out) / torch.clamp(cos_in - cos_out, min=1e-6))
        radiance = radiance * torch.where(ltype == LIGHT_SPOT, spot_fall, 1.0)[:, None]

    # --- area rect / disk
    if LIGHT_AREA_RECT in types or LIGHT_AREA_DISK in types:
        p_rect = pos + (2.0 * u1 - 1.0)[:, None] * vx + (2.0 * u2 - 1.0)[:, None] * vy
        r_d = sqrt(torch.clamp(u1, 0.0, 1.0))
        phi_d = 2.0 * PI * u2
        p_disk = pos + (r_d * torch.cos(phi_d))[:, None] * vx \
            + (r_d * torch.sin(phi_d))[:, None] * vy
        is_rect = ltype == LIGHT_AREA_RECT
        is_area = is_rect | (ltype == LIGHT_AREA_DISK)
        p_area = torch.where(is_rect[:, None], p_rect, p_disk)
        to_l = p_area - sp
        d2 = torch.clamp(dot3(to_l, to_l), min=1e-12)
        dist_a = sqrt(d2)
        dir_a = to_l / dist_a[:, None]
        cos_l = dot3(nrm, -dir_a)
        pdf_a = d2 / (area * torch.clamp(cos_l, min=1e-6))
        rad_a = torch.where((cos_l > 1e-6)[:, None], inten, 0.0)
        # sky portals re-emit the environment through the opening
        if scene.settings is None or getattr(scene.settings, "has_portal", True):
            portal = a[:, LA_PORTAL] > 0
            rad_a = torch.where(portal[:, None],
                                rad_a * env_radiance(scene, dir_a), rad_a)
        direction = sel3(is_area, dir_a, direction)
        dist = torch.where(is_area, dist_a, dist)
        radiance = sel3(is_area, rad_a, radiance)
        pdf_w = torch.where(is_area, pdf_a, pdf_w)
        cos_at_light = torch.where(is_area, cos_l, cos_at_light)

    # --- sphere: cone sampling toward the visible cap
    if LIGHT_SPHERE in types:
        sin_max2 = torch.clamp(radius * radius / dc2, 0.0, 0.9999)
        cos_max = sqrt(1.0 - sin_max2)
        cos_t = 1.0 - u1 * (1.0 - cos_max)
        sin_t = sqrt(torch.clamp(1.0 - cos_t * cos_t, 0.0, 1.0))
        phi = 2.0 * PI * u2
        tb, bb = make_orthonormal_basis(dir_p)
        dir_s = normalize3((sin_t * torch.cos(phi))[:, None] * tb
                           + (sin_t * torch.sin(phi))[:, None] * bb
                           + cos_t[:, None] * dir_p)
        pdf_s = 1.0 / torch.clamp(2.0 * PI * (1.0 - cos_max), min=1e-9)
        b_ = dot3(dir_s, to_c)
        disc = torch.clamp(b_ * b_ - dc2 + radius * radius, min=0.0)
        dist_s = b_ - sqrt(disc)
        is_sph = ltype == LIGHT_SPHERE
        direction = sel3(is_sph, dir_s, direction)
        dist = torch.where(is_sph, dist_s, dist)
        radiance = sel3(is_sph, inten, radiance)
        pdf_w = torch.where(is_sph, pdf_s, pdf_w)

    # --- direct (sun): delta direction
    if LIGHT_DIRECT in types:
        is_dir = ltype == LIGHT_DIRECT
        direction = sel3(is_dir, -nrm, direction)
        dist = torch.where(is_dir, FAR_DIST, dist)
        radiance = sel3(is_dir, inten, radiance)
        pdf_w = torch.where(is_dir, 1.0, pdf_w)

    # --- sky: env-importance sample (Map2DPiecewiseSample, clight.h:369)
    if LIGHT_SKY in types:
        dir_sky, pdf_sky = sample_env_dir(
            scene.env_rows_cdf, scene.env_cols_cdf, scene.env_pdf_uv, u1, u2)
        rad_sky = env_radiance(scene, dir_sky)
        is_sky = ltype == LIGHT_SKY
        direction = sel3(is_sky, dir_sky, direction)
        dist = torch.where(is_sky, FAR_DIST, dist)
        radiance = sel3(is_sky, rad_sky, radiance)
        pdf_w = torch.where(is_sky, pdf_sky, pdf_w)

    # --- mesh light: triangle by area CDF + uniform point
    if LIGHT_MESH in types:
        mrow = torch.clamp(a[:, LA_MESH_ROW].to(torch.int64), 0,
                           scene.ml_cdf.shape[0] - 1)
        cdf_rows = scene.ml_cdf[mrow]
        ti = (cdf_rows < u1[:, None]).sum(dim=1)
        ti = torch.clamp(ti, 0, scene.ml_tri.shape[1] - 1)
        tri = torch.clamp(scene.ml_tri[mrow, ti].long(), 0,
                          scene.tri_v0.shape[0] - 1)
        u3m = rnds[:, 2]
        r1 = sqrt(torch.clamp(u2, 0.0, 1.0))
        b1 = r1 * (1.0 - u3m)
        b2 = r1 * u3m
        ta = scene.tri_attr[tri]
        tv0, te1, te2 = ta[:, 0:3], ta[:, 3:6], ta[:, 6:9]
        p_mesh = tv0 + b1[:, None] * te1 + b2[:, None] * te2
        n_mesh = normalize3(cross3(te1, te2))
        to_m = p_mesh - sp
        dm2 = torch.clamp(dot3(to_m, to_m), min=1e-12)
        dist_m = sqrt(dm2)
        dir_m = to_m / dist_m[:, None]
        cos_m = dot3(n_mesh, -dir_m).abs()  # two-sided emission
        pdf_m = dm2 / (area * torch.clamp(cos_m, min=1e-6))
        rad_m = torch.where((cos_m > 1e-6)[:, None], inten, 0.0)
        is_mesh = ltype == LIGHT_MESH
        direction = sel3(is_mesh, dir_m, direction)
        dist = torch.where(is_mesh, dist_m, dist)
        radiance = sel3(is_mesh, rad_m, radiance)
        pdf_w = torch.where(is_mesh, pdf_m, pdf_w)
        cos_at_light = torch.where(is_mesh, cos_m, cos_at_light)

    # --- cylinder: lateral-surface area sampling
    if LIGHT_CYLINDER in types:
        axis = normalize3(vx)
        half_h = sqrt(torch.clamp(dot3(vx, vx), min=1e-12))
        at, ab = make_orthonormal_basis(axis)
        phi_c = 2.0 * PI * u2
        radial = torch.cos(phi_c)[:, None] * at + torch.sin(phi_c)[:, None] * ab
        p_cyl = pos + ((2.0 * u1 - 1.0) * half_h)[:, None] * axis \
            + radius[:, None] * radial
        to_c2 = p_cyl - sp
        dc2b = torch.clamp(dot3(to_c2, to_c2), min=1e-12)
        dist_c = sqrt(dc2b)
        dir_c = to_c2 / dist_c[:, None]
        cos_c = dot3(radial, -dir_c)
        pdf_c = dc2b / (area * torch.clamp(cos_c, min=1e-6))
        rad_c = torch.where((cos_c > 1e-6)[:, None], inten, 0.0)
        is_cyl = ltype == LIGHT_CYLINDER
        direction = sel3(is_cyl, dir_c, direction)
        dist = torch.where(is_cyl, dist_c, dist)
        radiance = sel3(is_cyl, rad_c, radiance)
        pdf_w = torch.where(is_cyl, pdf_c, pdf_w)
        cos_at_light = torch.where(is_cyl, cos_c, cos_at_light)

    is_delta = (ltype == LIGHT_POINT) | (ltype == LIGHT_SPOT) | (ltype == LIGHT_DIRECT)

    return LightSample(dir=direction, dist=dist, radiance=radiance,
                       pdf_w=pdf_w, is_delta=is_delta,
                       cos_at_light=cos_at_light, pick_prob=pick_prob)


def light_eval_pdf_from_hit(scene, l_idx, ray_o, ray_d, hit_pos, hit_norm,
                            return_pick: bool = False, rows=None):
    """Solid-angle pdf of sample_light_rev having produced direction ray_d
    toward the light surface point hit_pos (MIS when a BSDF ray lands on an
    emitter — ref lightEvalPDF clight.h:1613). With return_pick, also the
    light's pick probability."""
    types = _light_types(scene)
    a = light_rows(scene, l_idx) if rows is None else rows
    ltype = a[:, LA_TYPE].to(torch.int32)
    area = torch.clamp(a[:, LA_AREA], min=1e-12)

    to_h = hit_pos - ray_o
    d2 = torch.clamp(dot3(to_h, to_h), min=1e-12)
    cos_l = torch.clamp(dot3(hit_norm, -ray_d), min=1e-6)
    pdf = d2 / (area * cos_l)

    if LIGHT_SPHERE in types:
        pos = a[:, LA_POS:LA_POS + 3]
        radius = a[:, LA_RADIUS]
        to_c = pos - ray_o
        dc2 = torch.clamp(dot3(to_c, to_c), min=1e-12)
        sin_max2 = torch.clamp(radius * radius / dc2, 0.0, 0.9999)
        cos_max = sqrt(1.0 - sin_max2)
        pdf_sphere = 1.0 / torch.clamp(2.0 * PI * (1.0 - cos_max), min=1e-9)
        pdf = torch.where(ltype == LIGHT_SPHERE, pdf_sphere, pdf)

    if LIGHT_SKY in types:
        pdf_env = env_pdf_for_dir(scene.env_rows_cdf, scene.env_cols_cdf,
                                  scene.env_pdf_uv, ray_d)
        pdf = torch.where(ltype == LIGHT_SKY, pdf_env, pdf)
    if return_pick:
        return pdf, a[:, LA_PICK_PROB]
    return pdf
