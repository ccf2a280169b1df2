"""Light sampling (NEE) + pdf evaluation for MIS — vectorized (torch).

The JAX package's lights/sampling.py: one packed light row per ray
(scene.light_attr) and every per-type branch combined with masked selects
over the type enum; branches of light types the scene does not hold are
skipped (settings.light_types). Covers every light SceneBuilder makes:
rect, disk, sphere, cylinder, point, spot (both with an optional IES
profile), direct, mesh and a sky, constant or textured with a lat-long
image; and the sky's back plate (env_back_radiance). sample_light_fwd
starts a light path (emission rays for the light tracer) from any of them.
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
INV_4PI = 1.0 / (4.0 * math.pi)


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


class LightSampleFwd(NamedTuple):
    pos: torch.Tensor  # (R,3) point on light
    dir: torch.Tensor  # (R,3) emitted direction
    norm: torch.Tensor  # (R,3) light normal at pos
    radiance: torch.Tensor  # (R,3) emitted radiance
    pdf_a: torch.Tensor  # (R,) area pdf of pos
    pdf_w: torch.Tensor  # (R,) solid-angle pdf of dir (cos-weighted)
    cos_at_light: torch.Tensor  # (R,)


def scene_bounding_sphere(scene):
    """(center (3,), radius ()) of the scene from the BVH root box, both
    tensors on the scene's device (no host read)."""
    c = (scene.bvh_bmin[0] + scene.bvh_bmax[0]) * 0.5
    r = torch.linalg.vector_norm(scene.bvh_bmax[0] - scene.bvh_bmin[0]) * 0.5 \
        + 1e-3
    return c, r


def sample_light_fwd(scene, l_idx, rnds) -> LightSampleFwd:
    """Sample an emission ray (a light path's start) on light l_idx (R,)
    with rnds (R,4) uniforms — ref LightSampleForward (clight.h:1064), every
    light type: rect, disk, sphere, cylinder and mesh emit cosine-weighted
    (a mesh light picks its triangle by the area CDF), a point uniformly
    over the sphere, a spot uniformly in its outer cone with the smoothstep
    falloff (both with an optional IES profile), the sun and the sky from a
    disk on 1.5 times the scene's bounding sphere, inward (the sky's
    direction by env importance). Every branch is computed and selected by
    type, as in the JAX package."""
    from hydracore_tpu_torch.ops.texture import sample_bilinear

    a = light_rows(scene, l_idx)
    ltype = a[:, LA_TYPE].to(torch.int32)
    pos_c = a[:, LA_POS:LA_POS + 3]
    nrm = a[:, LA_NORM:LA_NORM + 3]
    vx = a[:, LA_VX:LA_VX + 3]
    vy = a[:, LA_VY:LA_VY + 3]
    inten = a[:, LA_INTEN:LA_INTEN + 3]
    radius = a[:, LA_RADIUS]
    area = torch.clamp(a[:, LA_AREA], min=1e-12)
    cos_in = a[:, LA_COS_IN]
    cos_out = a[:, LA_COS_OUT]

    u1, u2, u3, u4 = rnds[:, 0], rnds[:, 1], rnds[:, 2], rnds[:, 3]

    def sel3(cond, x, y):
        return torch.where(cond[:, None], x, y)

    # ---- position on the emitter
    p_rect = pos_c + (2 * u1 - 1)[:, None] * vx + (2 * u2 - 1)[:, None] * vy
    r_d = sqrt(torch.clamp(u1, 0.0, 1.0))
    phi_d = 2 * PI * u2
    p_disk = pos_c + (r_d * torch.cos(phi_d))[:, None] * vx \
        + (r_d * torch.sin(phi_d))[:, None] * vy
    # sphere: uniform point on the sphere
    z = 1.0 - 2.0 * u1
    r_ = sqrt(torch.clamp(1 - z * z, 0.0, 1.0))
    sph_n = torch.stack([r_ * torch.cos(2 * PI * u2), z,
                         r_ * torch.sin(2 * PI * u2)], -1)
    p_sph = pos_c + radius[:, None] * sph_n
    # cylinder: lateral surface, normal = radial
    axis = normalize3(vx)
    half_h = sqrt(torch.clamp(dot3(vx, vx), min=1e-12))
    at, ab = make_orthonormal_basis(axis)
    phi_c = 2 * PI * u2
    cyl_n = torch.cos(phi_c)[:, None] * at + torch.sin(phi_c)[:, None] * ab
    p_cyl = pos_c + ((2 * u1 - 1) * half_h)[:, None] * axis \
        + radius[:, None] * cyl_n

    is_rect = ltype == LIGHT_AREA_RECT
    is_disk = ltype == LIGHT_AREA_DISK
    is_sph = ltype == LIGHT_SPHERE
    is_cyl = ltype == LIGHT_CYLINDER
    is_mesh = ltype == LIGHT_MESH
    is_point = ltype == LIGHT_POINT
    is_spot = ltype == LIGHT_SPOT
    is_dir = ltype == LIGHT_DIRECT
    is_sky = ltype == LIGHT_SKY
    surf = is_rect | is_disk | is_sph | is_cyl | is_mesh  # cosine emitters

    # mesh light: triangle by area CDF + uniform point (MeshLight fwd)
    mrow = torch.clamp(a[:, LA_MESH_ROW].to(torch.int64), 0,
                       scene.ml_cdf.shape[0] - 1)
    cdf_rows = scene.ml_cdf[mrow]
    ti = torch.clamp((cdf_rows < u1[:, None]).sum(dim=1), 0,
                     scene.ml_tri.shape[1] - 1)
    trim = torch.clamp(scene.ml_tri[mrow, ti].long(), 0,
                       scene.tri_v0.shape[0] - 1)
    # uniform barycentric point: the sub-bin bits of u1/u2 (below the CDF
    # quantization) serve as two fresh uniforms
    ub1 = torch.remainder(u1 * 4096.0, 1.0)
    ub2 = torch.remainder(u2 * 4096.0, 1.0)
    r1m = sqrt(torch.clamp(ub1, 0.0, 1.0))
    te1, te2 = scene.tri_e1[trim], scene.tri_e2[trim]
    p_mesh = (scene.tri_v0[trim] + (r1m * (1.0 - ub2))[:, None] * te1
              + (r1m * ub2)[:, None] * te2)
    mesh_n = normalize3(cross3(te1, te2))

    pos = sel3(is_rect, p_rect, sel3(is_disk, p_disk, p_sph))
    pos = sel3(is_cyl, p_cyl, pos)
    pos = sel3(is_mesh, p_mesh, pos)
    pos = sel3(surf, pos, pos_c)
    n = sel3(is_sph, sph_n, torch.broadcast_to(nrm, sph_n.shape))
    n = sel3(is_cyl, cyl_n, n)
    n = sel3(is_mesh, mesh_n, n)

    # ---- direction
    # cosine-weighted about n (surface emitters)
    t, b = make_orthonormal_basis(n)
    ct = sqrt(torch.clamp(u3, 0.0, 1.0))
    st = sqrt(torch.clamp(1 - u3, 0.0, 1.0))
    ph = 2 * PI * u4
    d_cos = (st * torch.cos(ph))[:, None] * t + (st * torch.sin(ph))[:, None] * b \
        + ct[:, None] * n
    # uniform sphere (point)
    z2 = 1.0 - 2.0 * u3
    r2 = sqrt(torch.clamp(1 - z2 * z2, 0.0, 1.0))
    d_uni = torch.stack([r2 * torch.cos(2 * PI * u4), z2,
                         r2 * torch.sin(2 * PI * u4)], -1)
    # spot: uniform direction inside the outer cone about the axis (nrm)
    ct_sp = 1.0 - u3 * (1.0 - torch.clamp(cos_out, -1.0, 1.0))
    st_sp = sqrt(torch.clamp(1.0 - ct_sp * ct_sp, 0.0, 1.0))
    ta, ba = make_orthonormal_basis(torch.broadcast_to(nrm, sph_n.shape))
    d_spot = (st_sp * torch.cos(ph))[:, None] * ta \
        + (st_sp * torch.sin(ph))[:, None] * ba + ct_sp[:, None] * nrm
    pdf_spot = 1.0 / torch.clamp(2.0 * PI * (1.0 - cos_out), min=1e-9)
    spot_fall = _smoothstep01(
        (ct_sp - cos_out) / torch.clamp(cos_in - cos_out, min=1e-6))

    direction = sel3(surf, d_cos, d_uni)
    direction = sel3(is_spot, d_spot, direction)

    # sky / sun: a ray from a disk on the scene's bounding sphere, inward
    sky_dir, pdf_sky = sample_env_dir(scene.env_rows_cdf, scene.env_cols_cdf,
                                      scene.env_pdf_uv, u3, u4)
    emit_far = sel3(is_sky, -sky_dir, torch.broadcast_to(nrm, sph_n.shape))
    cen, rad_s = scene_bounding_sphere(scene)
    td, bd = make_orthonormal_basis(emit_far)
    rr = sqrt(torch.clamp(u1, 0.0, 1.0)) * rad_s
    ph2 = 2 * PI * u2
    p_far = cen[None, :] - emit_far * (rad_s * 1.5) \
        + (rr * torch.cos(ph2))[:, None] * td + (rr * torch.sin(ph2))[:, None] * bd
    pdf_a_far = 1.0 / torch.clamp(PI * rad_s * rad_s, min=1e-12)

    far = is_sky | is_dir
    pos = sel3(far, p_far, pos)
    direction = sel3(far, emit_far, direction)
    n = sel3(far, emit_far, n)

    # ---- pdfs and radiance
    pdf_a = torch.where(surf, 1.0 / area, 1.0)
    pdf_a = torch.where(far, pdf_a_far, pdf_a)
    cos_l = torch.where(surf, torch.clamp(ct, min=1e-6), 1.0)
    pdf_w = torch.where(surf, cos_l * (1.0 / PI), INV_4PI)
    pdf_w = torch.where(is_spot, pdf_spot, pdf_w)
    pdf_w = torch.where(is_sky, torch.clamp(pdf_sky, min=1e-12), pdf_w)
    pdf_w = torch.where(is_dir, 1.0, pdf_w)  # delta direction

    # IES photometric profile on the emitted direction for point / spot
    # (as sample_light_rev, so the light tracer agrees with the path tracer)
    tex_slot = a[:, LA_TEX].to(torch.int32)
    cos_ax = torch.clamp(dot3(direction, nrm), -1.0, 1.0)
    theta_v = torch.arccos(cos_ax) * (1.0 / PI)
    phi_v = torch.remainder(
        torch.atan2(dot3(direction, ba), dot3(direction, ta)) * (0.5 / PI), 1.0)
    ies_val = sample_bilinear(scene.texels, scene.tex_table, tex_slot,
                              torch.stack([phi_v, theta_v], -1),
                              scene.tex_sampler)[:, 0]
    has_ies = (tex_slot > 0) & (is_point | is_spot)
    radiance = inten * torch.where(has_ies, ies_val, 1.0)[:, None]
    radiance = radiance * torch.where(is_spot, spot_fall, 1.0)[:, None]
    radiance = sel3(is_sky, env_radiance(scene, sky_dir), radiance)

    return LightSampleFwd(pos=pos, dir=direction, norm=n, radiance=radiance,
                          pdf_a=pdf_a, pdf_w=pdf_w, cos_at_light=cos_l)


def sky_pdf():
    """Solid-angle pdf of a uniform sky direction."""
    return INV_4PI
