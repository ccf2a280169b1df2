"""Wavefront MIS path tracer (PT / MISPT) over megablock ray batches (torch).

The JAX package's integrators/pt.py, main path: per bounce a closest-hit
trace, compute_hit, fetch_material (textures, blends) and the normal map,
the BSDF, then NEE with a shadow any-hit trace; ops/trace_api.py picks the
traversal (kernels B1/B2, B3 over an instanced scene, B4 over the packet
route, or a plain path). Scenes with opacity maps (settings.has_alpha) let
a ray pass through a surface with probability 1 - opacity, and walk their
shadow rays through up to MAX_ALPHA_SHADOW_STEPS such layers
(shadow_trace); the sky's back plate replaces the env for camera-visible
rays (settings.has_env_back). Rays inside an SSS medium take a free-flight
step, scatter by Henyey-Greenstein and are absorbed by Beer-Lambert
(settings.has_sss); a ray through Beer-fog glass is attenuated over each
segment inside it (settings.has_fog); procedural textures that read an AO
input get it from AO_PROBES short any-hit rays a hit (ao_probe,
settings.has_proc_ao); the 'direct' and 'indirect' render layers keep
complementary parts of the radiance (settings.render_layer). Every such
gate is static on the settings, so a plain scene runs none of that code.
Two wavefront modes, as there: with a traversal that wants sorted rays (the
cluster kernels) the whole live state is permuted into (octant,
origin-Morton) order once per bounce and both traversals run on the sorted
wavefront; with any other the rays stay in caller order. The sample set is
the same either way (every stream is keyed by its sample id), so the images
agree to accumulation order.

Semantics (ref IntegratorMISPT::PathTrace / trace1D_Rev):
  * implicit light/env hits weighted by the power heuristic against the
    light-pick pdf (weight 1 after specular bounces),
  * next-event estimation with one light sampled from the pick CDF,
  * a path ends when it lands on an emitter,
  * russian roulette from bounce 3 by throughput.

The counter-based RNG (ops/rng.py) makes the sample set identical to the
JAX package's, ray for ray. Python loops replace jit and fori_loop; the
entry points (render_pass, render_passes, render, render_production,
render_tile_production, and through render_passes(regen=True) the
regenerating wavefront of integrators/pt_regen.py) run on `device`
("cuda" by default).
"""
from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch

from hydracore_tpu_torch.bsdf.core import (apply_bump, eval_bsdf,
                                           fetch_material, sample_bsdf,
                                           scene_feats)
from hydracore_tpu_torch.lights.envmap import env_pdf_for_dir
from hydracore_tpu_torch.lights.sampling import (env_back_radiance,
                                                 env_radiance,
                                                 light_eval_pdf_from_hit,
                                                 light_rows,
                                                 sample_light_rev,
                                                 select_light)
from hydracore_tpu_torch.ops import rng
from hydracore_tpu_torch.ops.trace_api import (alpha_layer_hit, any_hit,
                                               any_hit_opaque, any_hit_sorted,
                                               ao_any_hit, closest_hit,
                                               closest_hit_sorted,
                                               coherence_order,
                                               has_shadow_split,
                                               wants_sorted_rays)
from hydracore_tpu_torch.scene import materials as MC
from hydracore_tpu_torch.scene.lights import LIGHT_SKY
from hydracore_tpu_torch.scene.scene import check_supported
from hydracore_tpu_torch.utils.device import resolve_device
from hydracore_tpu_torch.utils.math3d import (cross3, dot3,
                                              make_orthonormal_basis,
                                              normalize3, offs_ray_pos, sqrt)

# rng dimension groups per bounce (role analogue of QMC_VAR_* slots)
DG_LENS = 0
DG_BSDF = 1
DG_LIGHT = 2
DG_RR = 3
DG_ALPHA = 4  # col 0: stochastic alpha; col 1: blend-tree walk
DG_SSS = 5  # subsurface medium events
DG_AO = 6  # proc-tex AO probe directions

MAX_ALPHA_SHADOW_STEPS = 2  # transparent layers a shadow ray may cross

AO_PROBES = 4  # hemisphere probes per hit (MakeAORaysPacked4 analogue)

# max rays per wavefront: decouples image size from device footprint
# (CalcMegaBlockSize, GPUOCLLayer.cpp:841-876)
MEGABLOCK = 1 << 18


def hg_sample(d, g, e1, e2):
    """Henyey-Greenstein phase direction about d (SampleHenyeyGreenstein,
    CPUExp_IntegratorSSS.cpp:110)."""
    s = 1.0 - 2.0 * e1
    denom = torch.clamp((1.0 + g * s) * (1.0 + g * s), min=1e-6)
    cost = (s + 2.0 * g * g * g * (e1 - 1.0) * e1 + g * g * s
            + 2.0 * g * (1.0 - e1 + e1 * e1)) / denom
    cost = torch.clamp(cost, -1.0, 1.0)
    sint = sqrt(torch.clamp(1.0 - cost * cost, min=1e-6))
    t, b = make_orthonormal_basis(d)
    phi = 2.0 * math.pi * e2
    return (torch.cos(phi) * sint)[:, None] * t \
        + (torch.sin(phi) * sint)[:, None] * b + cost[:, None] * d


def ao_rays(pos, n, ng, ao_type, ao_len, need, r_ao):
    """The AO probe wavefront of ao_probe: AO_PROBES cosine-weighted rays
    of length ao_len about +n (ao_type 1, 'up') or -n (2, 'down'; 3,
    'both', alternates the sides probe by probe), probe-major. Returns
    (origins, directions, t_max, active), each AO_PROBES * R long."""
    o_list, d_list = [], []
    for k in range(AO_PROBES):
        down = ((ao_type == 2) | ((ao_type == 3) & bool(k & 1)))[:, None]
        nh = torch.where(down, -n, n)
        ngh = torch.where(down, -ng, ng)
        t_, b_ = make_orthonormal_basis(nh)
        # golden-ratio rotations stretch 2 uniforms over the probes
        u1 = (r_ao[:, 0] + k * 0.618034) % 1.0
        u2 = (r_ao[:, 1] + k * 0.381966) % 1.0
        ct = sqrt(torch.clamp(u1, 0.0, 1.0))
        st = sqrt(torch.clamp(1.0 - u1, 0.0, 1.0))
        ph = 2.0 * math.pi * u2
        d = (st * torch.cos(ph))[:, None] * t_ \
            + (st * torch.sin(ph))[:, None] * b_ + ct[:, None] * nh
        o_list.append(offs_ray_pos(pos, ngh, d))
        d_list.append(d)
    return (torch.cat(o_list), torch.cat(d_list),
            torch.clamp(ao_len, min=1e-5).repeat(AO_PROBES),
            need.repeat(AO_PROBES))


def ao_probe(scene, pos, n, ng, ao_type, ao_len, need, r_ao):
    """Hemisphere-occlusion input of AO procedural textures (MakeAORays'
    packed probes -> surfHit.ao, light.cl:274-457 + texproc.cl:152): the
    unoccluded fraction of the ao_rays probes, averaged; 1 where `need` is
    False. One any-hit trace over the AO_PROBES * R rays
    (trace_api.ao_any_hit: B2 over the full pool on the cluster route,
    counted in traverse_cluster.ao_any_launches)."""
    R = pos.shape[0]
    occ = ao_any_hit(scene, *ao_rays(pos, n, ng, ao_type, ao_len, need, r_ao))
    ao = 1.0 - occ.reshape(AO_PROBES, R).to(torch.float32).mean(dim=0)
    return torch.where(need, ao, 1.0)


def mis_weight(a, b):
    """Power heuristic (beta=2) — misWeightHeuristic in the reference."""
    a2 = a * a
    den = a2 + b * b
    return torch.where(den > 0.0, a2 / den, 0.0)


# ----------------------------------------------------------------------------
# Eye rays (screen.cl MakeEyeRaysQMC semantics: NDC unproject + DOF)
# ----------------------------------------------------------------------------

def make_eye_rays(cam, px, py, jitter, lens_uv):
    """px, py: (R,) int pixel coords; jitter: (R,2) in [0,1); lens_uv (R,2)."""
    W, H = cam.width, cam.height
    x = (px.to(torch.float32) + jitter[:, 0]) / W * 2.0 - 1.0
    # image row 0 is the TOP of the frame (PNG convention) -> NDC y = +1
    y = 1.0 - (py.to(torch.float32) + jitter[:, 1]) / H * 2.0
    ndc = torch.stack([x, y, torch.zeros_like(x), torch.ones_like(x)], -1)
    pv = ndc @ cam.mProjInv.T
    d_view = normalize3(pv[:, :3] / torch.clamp(pv[:, 3:4].abs(), min=1e-12))
    # view space: camera at origin looking down -Z
    d_world = normalize3(d_view @ cam.mWorldViewInv[:3, :3].T)
    o_world = torch.broadcast_to(cam.pos, d_world.shape)

    # thin-lens DOF: jitter the origin on the lens disc, re-aim at the
    # focal plane point
    r = sqrt(torch.clamp(lens_uv[:, 0], 0.0, 1.0)) * cam.lens_radius
    phi = 2.0 * math.pi * lens_uv[:, 1]
    focus_t = cam.focal_dist / torch.clamp(-d_view[:, 2], min=1e-6)
    p_focus = o_world + focus_t[:, None] * d_world
    right = cam.mWorldViewInv[:3, 0]
    up = cam.mWorldViewInv[:3, 1]
    o_dof = o_world + (r * torch.cos(phi))[:, None] * right \
        + (r * torch.sin(phi))[:, None] * up
    d_dof = normalize3(p_focus - o_dof)
    use_dof = cam.lens_radius > 0.0
    return (torch.where(use_dof, o_dof, o_world),
            torch.where(use_dof, d_dof, d_world))


# ----------------------------------------------------------------------------
# Hit shading data (trace.cl ComputeHit semantics)
# ----------------------------------------------------------------------------

def compute_hit(scene, tri, u, v, ray_o, ray_d, t):
    """Hit attribute interpolation from ONE packed tri_attr row per ray.
    Returns (pos, n, ng, uv, mat, light, tangent).

    Instanced scenes (settings.has_inst): `tri` is the cluster SLOT id; it
    resolves to (mesh triangle, instance) through cl_slot_tri2, attributes
    interpolate in mesh-local space and rotate to world by the instance
    matrix (normals by invM^T, tangents by M — BVH4InstTraverse's
    local-space hit semantics, ctrace.h:940-1010)."""
    has_inst = scene.settings.has_inst
    if has_inst:
        row = scene.cl_slot_tri2[torch.clamp(tri.long(), 0,
                                             scene.cl_slot_tri2.shape[0] - 1)]
        tri = row[:, 0]
        im = scene.inst_attr[torch.clamp(row[:, 1].long(), 0,
                                         scene.inst_attr.shape[0] - 1)]
    tri_c = torch.clamp(tri.long(), 0, scene.tri_attr.shape[0] - 1)
    a = scene.tri_attr[tri_c]  # (R, 40)
    w = 1.0 - u - v
    wc, uc, vc = w[:, None], u[:, None], v[:, None]
    pos = ray_o + t[:, None] * ray_d  # world in both modes (world-t rays)
    n = wc * a[:, 9:12] + uc * a[:, 12:15] + vc * a[:, 15:18]
    ng = cross3(a[:, 3:6], a[:, 6:9])
    tang = wc * a[:, 18:21] + uc * a[:, 21:24] + vc * a[:, 24:27]
    if has_inst:
        def rot_normal(v3):  # v @ invR == invR^T action (rows 12:24 = invM)
            return torch.stack([
                v3[:, 0] * im[:, 12] + v3[:, 1] * im[:, 16] + v3[:, 2] * im[:, 20],
                v3[:, 0] * im[:, 13] + v3[:, 1] * im[:, 17] + v3[:, 2] * im[:, 21],
                v3[:, 0] * im[:, 14] + v3[:, 1] * im[:, 18] + v3[:, 2] * im[:, 22],
            ], dim=1)

        def rot_vec(v3):  # R v (rows 0:12 = M)
            return torch.stack([
                v3[:, 0] * im[:, 0] + v3[:, 1] * im[:, 1] + v3[:, 2] * im[:, 2],
                v3[:, 0] * im[:, 4] + v3[:, 1] * im[:, 5] + v3[:, 2] * im[:, 6],
                v3[:, 0] * im[:, 8] + v3[:, 1] * im[:, 9] + v3[:, 2] * im[:, 10],
            ], dim=1)

        n = rot_normal(n)
        ng = rot_normal(ng)
        tang = rot_vec(tang)
    n = normalize3(n)
    ng = normalize3(ng)
    # orient the geometric normal with the shading normal
    ng = torch.where(dot3(ng, n)[:, None] < 0.0, -ng, ng)
    uv = wc * a[:, 27:29] + uc * a[:, 29:31] + vc * a[:, 31:33]
    tang = normalize3(tang)
    mat = a[:, 33].to(torch.int32)
    lgt = a[:, 34].to(torch.int32)
    return pos, n, ng, uv, mat, lgt, tang


def _layer_passes(scene, tri, u, v, o, sdir, t, hit, u_alpha, step: int):
    """Which shadow-ray hits of one layer pass through: a surface with
    opacity < 0.999 lets the ray through when its uniform (a hash of
    u_alpha and the layer) reaches the opacity, a skip-shadow one always.
    The blend walk of the hit material takes a second hash."""
    _, _, _, uv, mat_id, _, _ = compute_hit(scene, tri, u, v, o, sdir, t)
    ub = rng.hash_u32(u_alpha ^ ((0xB5297A4D + step * 0x68E31DA4) & rng.M32))
    ub = (ub >> 8).to(torch.float32) * (1.0 / 16777216.0)
    p = fetch_material(scene, mat_id, uv, u_blend=ub)
    ua = rng.hash_u32(rng.add32(u_alpha, (step * 0x9E3779B9) & rng.M32))
    ua = (ua >> 8).to(torch.float32) * (1.0 / 16777216.0)
    return hit & (((p.opacity < 0.999) & (ua >= p.opacity))
                  | (p.skip_shadow != 0))


def shadow_trace(scene, sray_o, sdir, dist, active, u_alpha=None,
                 presorted: bool = True, has_alpha: bool | None = None):
    """Occlusion query on the wavefront as it stands (already in coherence
    order when the traversal wants that), or sorted into coherence order
    first when not `presorted` (any_hit_sorted, any_hit_opaque; the layers
    are taken unsorted, as in the JAX package). With alpha materials
    (has_alpha, by default settings.has_alpha) it walks up
    to MAX_ALPHA_SHADOW_STEPS stochastic transparent layers (ref: the
    alpha variants of shadow traversal, trace.cl:244+); u_alpha (R,) u32
    values (int64) key their uniforms. With the split shadow sets one B2
    walk over the opaque pool answers for opaque geometry and the layers
    are taken from the dense alpha set alone (occlusion by opaque and by
    alpha surfaces does not depend on their order, so the split is exact);
    without, each layer is a closest-hit trace of the scene's route.
    has_alpha=False makes every surface opaque to shadow rays, as PSSMLT
    asks."""
    if has_alpha is None:
        has_alpha = bool(scene.settings.has_alpha)
    if not has_alpha:
        trace = any_hit if presorted else any_hit_sorted
        return trace(scene, sray_o, sdir, dist * 0.995, active=active)
    if has_shadow_split(scene):
        occluded = any_hit_opaque(scene, sray_o, sdir, dist * 0.995,
                                  active=active, presorted=presorted)
        searching = active & ~occluded
        t_lo = torch.full_like(dist, 1e-5)
        t_hi = dist * 0.995
        for step in range(MAX_ALPHA_SHADOW_STEPS + 1):
            t, tri, u, v = alpha_layer_hit(scene, sray_o, sdir, t_lo, t_hi,
                                           searching)
            hit = searching & (tri >= 0)
            if step == MAX_ALPHA_SHADOW_STEPS:  # out of layers: opaque
                return occluded | hit
            passthru = _layer_passes(scene, tri, u, v, sray_o, sdir, t, hit,
                                     u_alpha, step)
            occluded = occluded | (hit & ~passthru)
            searching = passthru
            t_lo = t + 1e-4
    occluded = torch.zeros_like(active)
    searching = active
    o = sray_o
    d_left = dist * 0.995
    for step in range(MAX_ALPHA_SHADOW_STEPS + 1):
        t, tri, u, v = closest_hit(scene, o, sdir, t_max=d_left,
                                   active=searching)
        hit = searching & (tri >= 0)
        if step == MAX_ALPHA_SHADOW_STEPS:  # out of layers: opaque
            return occluded | hit
        passthru = _layer_passes(scene, tri, u, v, o, sdir, t, hit, u_alpha,
                                 step)
        occluded = occluded | (hit & ~passthru)
        searching = passthru
        o = o + t[:, None] * sdir + sdir * 1e-4
        d_left = torch.clamp(d_left - t - 1e-4, min=0.0)


# ----------------------------------------------------------------------------
# The bounce loop
# ----------------------------------------------------------------------------

def pt_trace(scene, ray_o, ray_d, sample_idx, seed, max_depth: int = 5,
             min_rr_depth: int = 3, rand_fn=None,
             has_alpha: bool | None = None):
    """Trace a batch of primary rays (already in coherence order, as
    Morton-ordered primaries are) to completion. sample_idx (R,) u32 stream
    ids (int64) key every random number. The live state is re-sorted every
    bounce only for a traversal that wants sorted rays. The static gates of
    the settings turn on alpha pass-through and the layered shadow walk
    (has_alpha), the SSS medium walk (has_sss), Beer fog (has_fog), the AO
    probes (has_proc_ao) and the layer split (render_layer). Returns
    (radiance (R,3) in caller order, rays_traced (int64 scalar tensor)):
    the ray counter feeds the Mrays/s metric (MRaysStat analogue) and
    counts the AO probes too.

    With rand_fn(depth, group) -> (R, 4) uniforms the JAX package's legacy
    mode runs instead (PSSMLT's positional random provider, integrators/
    mlt.py): sample_idx and seed go unused, the rays stay in caller order
    (the first wavefront through closest_hit, later bounces through
    closest_hit_sorted, NEE through shadow_trace(presorted=False)), the
    alpha / blend-walk uniforms are drawn at every depth and `has_alpha`
    (default settings.has_alpha) picks the shadow walk alone: a surface
    with an opacity map still passes camera-path rays."""
    st = scene.settings
    dev = ray_o.device
    R = ray_o.shape[0]
    legacy = rand_fn is not None
    alpha_sh = bool(st.has_alpha) if has_alpha is None else bool(has_alpha)
    has_alpha = bool(st.has_alpha)

    if legacy:
        def rand(sidx, depth, group):
            return rand_fn(depth, group)
    else:
        def rand(sidx, depth, group):
            return rng.rand4(sidx, depth, group, seed)

    sorted_mode = not legacy and wants_sorted_rays(scene)
    sidx = sample_idx
    orig_pos = torch.arange(R, device=dev)
    rays_traced = torch.zeros((), dtype=torch.int64, device=dev)
    acc = torch.zeros((R, 3), dtype=torch.float32, device=dev)
    throughput = torch.ones((R, 3), dtype=torch.float32, device=dev)
    alive = torch.ones((R,), dtype=torch.bool, device=dev)
    prev_pdf = torch.zeros((R,), dtype=torch.float32, device=dev)
    prev_spec = torch.ones((R,), dtype=torch.bool, device=dev)  # camera vertex

    feats = scene_feats(scene)
    # static sky gate: closed scenes skip the env machinery
    has_sky_s = st.has_sky
    # caustics gate (method_caustic == none): PT drops implicit light hits
    # reached through a specular bounce once the path has diffused
    pt_caustics = getattr(st, "pt_caustics", True)
    if not pt_caustics:
        diff_bounce = torch.zeros((R,), dtype=torch.int32, device=dev)
    # back-plate gate (sky <back>): camera-visible rays (primary, or behind
    # pure transmission or alpha pass-through) take the back plate's color
    # in place of the env's (environmentColorExtended, cbidir.h:619-625)
    has_back = getattr(st, "has_env_back", False)
    if has_back:
        pure_t = torch.ones((R,), dtype=torch.bool, device=dev)
    # render-layer gate (the HRT_DIRECT_LIGHT_MODE / HRT_INDIRECT_LIGHT_MODE
    # kills, material.cl:953-955, :544): 'direct' keeps emission on short or
    # specular-only paths and NEE at the first non-specular vertex,
    # 'indirect' the rest. As in the JAX package, specular-only chains leave
    # the indirect layer too (the reference kills its NEE at bounce 0 only),
    # so that direct + indirect == color.
    layer = st.render_layer
    split = layer != "color"
    if split:
        spec_only = torch.ones((R,), dtype=torch.bool, device=dev)
    # SSS gate: the medium a ray is inside (SSSMaterial,
    # CPUExp_IntegratorSSS.cpp), its scattering and absorption coefficients
    # and phase g
    has_sss = bool(st.has_sss)
    scat = None  # scatter lanes of this step: no surface interaction
    if has_sss:
        in_med = torch.zeros((R,), dtype=torch.bool, device=dev)
        med_sig_s = torch.zeros((R,), dtype=torch.float32, device=dev)
        med_sig_a = torch.zeros((R, 3), dtype=torch.float32, device=dev)
        med_g = torch.zeros_like(med_sig_s)
    # thick-glass fog gate (attenuationStep, cmaterial.h:2787-2827): rgb the
    # armed fog colour, w its multiplier (0 = the ray is in no fog)
    has_fog = bool(st.has_fog)
    if has_fog:
        fog_state = torch.zeros((R, 4), dtype=torch.float32, device=dev)
    has_proc_ao = bool(st.has_proc_ao)
    # the alpha / blend-walk uniforms are drawn only where a gate reads them
    want_r_a = legacy or has_alpha or (st.has_blend
                                       and getattr(st, "blend_depth", 1) > 1)
    if has_sky_s:
        sky_rows = scene.lights.ltype == LIGHT_SKY
        has_sky = sky_rows.any()
        sky_row = torch.argmax(sky_rows.to(torch.int32))
        cdf = scene.lights.pick_cdf
        sky_pick = torch.where(has_sky, cdf[sky_row + 1] - cdf[sky_row], 1.0)
    multi_light = scene.light_attr.shape[0] > 1

    for depth in range(max_depth):
        if sorted_mode and depth > 0:
            # permute the whole live state into (octant, origin-Morton)
            # coherence order: one sort + one row gather per state tensor
            perm = coherence_order(scene, ray_o, ray_d, alive)
            ray_o, ray_d = ray_o[perm], ray_d[perm]
            throughput, acc = throughput[perm], acc[perm]
            prev_pdf, prev_spec, alive = prev_pdf[perm], prev_spec[perm], alive[perm]
            sidx, orig_pos = sidx[perm], orig_pos[perm]
            if not pt_caustics:
                diff_bounce = diff_bounce[perm]
            if has_back:
                pure_t = pure_t[perm]
            if split:
                spec_only = spec_only[perm]
            if has_sss:
                in_med, med_sig_s = in_med[perm], med_sig_s[perm]
                med_sig_a, med_g = med_sig_a[perm], med_g[perm]
            if has_fog:
                fog_state = fog_state[perm]

        rays_traced = rays_traced + alive.sum()
        if legacy and depth > 0:  # sort, trace, unsort inside the call
            t, tri, u, v = closest_hit_sorted(scene, ray_o, ray_d,
                                              active=alive)
        else:
            t, tri, u, v = closest_hit(
                scene, ray_o, ray_d, active=alive,
                kind="primary" if depth == 0 else "bounce")
        hit = alive & (tri >= 0)
        miss = alive & ~hit

        # ---- Beer fog over the segment just traced (attenuationStep:
        # T = exp(-max(1 - fogColor, 0) * fogMult * dist)); misses stay
        # unattenuated, as in the reference
        if has_fog:
            fog_on = hit & (fog_state[:, 3] > 0.0)
            seg = torch.where(torch.isfinite(t), t, 0.0)
            att = torch.exp(-torch.clamp(1.0 - fog_state[:, 0:3], min=0.0)
                            * (fog_state[:, 3] * seg)[:, None])
            throughput = torch.where(fog_on[:, None], throughput * att,
                                     throughput)

        # ---- subsurface medium walk (PathTraceVol,
        # CPUExp_IntegratorSSS.cpp:143): a ray inside a medium draws a
        # scatter distance ~ exp(sigma_s); a scatter before the surface
        # takes this step (a new HG direction, Beer-Lambert absorption) and
        # skips every surface gate below (~scat)
        if has_sss:
            r_m = rand(sidx, depth, DG_SSS)
            t_srf = torch.where(torch.isfinite(t), t, 3e38)
            d_scat = -torch.log(torch.clamp(r_m[:, 0], min=1e-12)) \
                / torch.clamp(med_sig_s, min=1e-12)
            scat = alive & in_med & (med_sig_s > 0.0) & (d_scat < t_srf) & hit
            d_abs = torch.where(scat, d_scat, torch.clamp(t_srf, max=3e38))
            att = torch.exp(-med_sig_a * d_abs[:, None])
            throughput = torch.where(((alive & in_med & hit) | scat)[:, None],
                                     throughput * att, throughput)
            pos_scat = ray_o + d_scat[:, None] * ray_d
            hg_dir = normalize3(hg_sample(ray_d, med_g, r_m[:, 1], r_m[:, 2]))
            alive = alive & ~(in_med & miss)  # lost inside the medium
            miss = miss & ~in_med

        # ---- environment (HitEnvOrLightKernel env path, material.cl:344)
        if has_sky_s:
            env = env_radiance(scene, ray_d)
            env_pdf = env_pdf_for_dir(scene.env_rows_cdf, scene.env_cols_cdf,
                                      scene.env_pdf_uv, ray_d)
            w_env = torch.where(prev_spec | ~has_sky, 1.0,
                                mis_weight(prev_pdf, env_pdf * sky_pick))
            env_c = env * w_env[:, None]
            if has_back:  # the back plate replaces the env, unweighted
                env_c = torch.where(pure_t[:, None],
                                    env_back_radiance(scene, ray_d), env_c)
            if split:  # sky emission splits like light emission
                keep_em = spec_only | (depth <= 1)
                if layer == "indirect":
                    keep_em = ~keep_em
                env_c = torch.where(keep_em[:, None], env_c, 0.0)
            acc = acc + torch.where(miss[:, None], throughput * env_c, 0.0)
        alive = alive & hit

        pos, n, ng, uv, mat_id, tri_light, tang = compute_hit(
            scene, tri, u, v, ray_o, ray_d, t)
        wo = -ray_d  # toward the viewer
        r_a = rand(sidx, depth, DG_ALPHA) if want_r_a else None
        ao_val = None
        if has_proc_ao:  # AO probes only where a procedural texture asks
            arow = scene.mat_attr[torch.clamp(mat_id.long(), 0,
                                              scene.mat_attr.shape[0] - 1)]
            ao_t = arow[:, MC.MA_AO_TYPE].to(torch.int32)
            need_ao = alive & (ao_t > 0)
            rays_traced = rays_traced + need_ao.sum() * AO_PROBES
            ao_val = ao_probe(scene, pos, n, ng, ao_t, arow[:, MC.MA_AO_LENGTH],
                              need_ao, rand(sidx, depth, DG_AO))
        p = fetch_material(scene, mat_id, uv, pos, n, wo=wo,
                           u_blend=None if r_a is None else r_a[:, 1],
                           ao=ao_val)
        n = apply_bump(scene, p, n, tang, uv)
        # stochastic alpha (ref: alpha-tested traversal + NextTransparentBounce,
        # material.cl:1080): with probability 1 - opacity the ray passes the
        # surface unchanged, which takes one wavefront step
        passthru = None
        if has_alpha:
            passthru = alive & (p.opacity < 0.999) & (r_a[:, 0] >= p.opacity)
            if has_sss:
                passthru = passthru & ~scat

        # one light-row fetch serves the implicit-hit MIS eval (by the hit
        # triangle's light id) and the NEE sample (by the CDF pick)
        nee = depth < max_depth - 1
        lrow = torch.clamp(tri_light, 0, scene.lights.ltype.shape[0] - 1)
        rows_hit = rows_nee = l_idx = r_l = None
        if nee:
            r_l = rand(sidx, depth, DG_LIGHT)
            l_idx, _ = select_light(scene.lights, r_l[:, 3])
        if multi_light:
            rows_hit = light_rows(scene, lrow)
            if nee:
                rows_nee = light_rows(scene, l_idx)

        # ---- implicit emitter hit (HitEnvOrLightKernel light path)
        em_lum = p.em_color.amax(dim=-1)
        is_emitter = alive & (em_lum > 1e-6)
        if has_alpha:
            is_emitter = is_emitter & ~passthru
        if has_sss:
            is_emitter = is_emitter & ~scat
        front = dot3(n, wo) > 0.0
        l_pdf_w, l_pick = light_eval_pdf_from_hit(scene, lrow, ray_o, ray_d,
                                                  pos, n, return_pick=True,
                                                  rows=rows_hit)
        w_li = torch.where(prev_spec | (tri_light < 0), 1.0,
                           mis_weight(prev_pdf, l_pdf_w * l_pick))
        emit = torch.where((is_emitter & front)[:, None],
                           throughput * p.em_color * w_li[:, None], 0.0)
        if not pt_caustics:
            emit = torch.where(((diff_bounce > 0) & prev_spec)[:, None],
                               0.0, emit)
        if split:
            # emission belongs to the direct layer on short (<= 1 bounce)
            # or specular-only paths (material.cl:543-544, inverted)
            keep_em = spec_only | (depth <= 1)
            if layer == "indirect":
                keep_em = ~keep_em
            emit = torch.where(keep_em[:, None], emit, 0.0)
        acc = acc + emit
        alive = alive & ~is_emitter  # the path ends on emitters

        if depth == max_depth - 1:
            break

        # ---- NEE (ShadePass: LightSample -> ShadowTrace -> Shade); shade
        # with the viewer-oriented normal (two-sided reflection)
        ns = torch.where(dot3(n, wo)[:, None] >= 0.0, n, -n)
        ngs = torch.where(dot3(ng, wo)[:, None] >= 0.0, ng, -ng)
        ls = sample_light_rev(scene, l_idx, r_l[:, :3], pos, rows=rows_nee)
        pick_prob = ls.pick_prob
        sray_o = offs_ray_pos(pos, ngs, ls.dir)
        f, pdf_fwd = eval_bsdf(p, wo, ls.dir, ns, feats)
        # two-sided combine: |cos| credits transmission lobes
        cos_s = dot3(ls.dir, ns).abs()
        w_l = torch.where(ls.is_delta, 1.0,
                          mis_weight(ls.pdf_w * pick_prob, pdf_fwd))
        contrib = (throughput * f * ls.radiance
                   * (cos_s * w_l / torch.clamp(ls.pdf_w * pick_prob, min=1e-12))[:, None])
        ok = alive & (cos_s > 0.0)
        if has_alpha:
            ok = ok & ~passthru
        if has_sss:
            ok = ok & ~scat
        if split:
            # NEE at the first vertex, or through a pure specular chain, is
            # direct light (killDueToDirectLight/IndirectLight, inverted)
            keep_nee = spec_only | (depth == 0)
            if layer == "indirect":
                keep_nee = ~keep_nee
            ok = ok & keep_nee
        # zero-contribution lanes need no occlusion query
        need_sh = ok & (contrib.amax(dim=-1) > 0.0)
        rays_traced = rays_traced + need_sh.sum()  # shadow rays
        u_sh = (r_l[:, 0] * 16777216.0).to(torch.int64) if alpha_sh else None
        occluded = shadow_trace(scene, sray_o, ls.dir, ls.dist, need_sh, u_sh,
                                presorted=not legacy, has_alpha=alpha_sh)
        acc = acc + torch.where((need_sh & ~occluded)[:, None], contrib, 0.0)

        # ---- next bounce (NextBounce: BSDF sample, RR, flags)
        bs = sample_bsdf(p, wo, ns, rand(sidx, depth, DG_BSDF), feats)
        wi, weight, prev_pdf, prev_spec = bs.wi, bs.weight, bs.pdf, bs.is_specular
        through = bs.is_transmission  # the ray goes on through the surface
        if has_alpha:
            # pass-through: direction and throughput unchanged, a specular
            # event for MIS
            wi = torch.where(passthru[:, None], ray_d, wi)
            weight = torch.where(passthru[:, None], 1.0, weight)
            prev_pdf = torch.where(passthru, 0.0, prev_pdf)
            prev_spec = prev_spec | passthru
            through = through | passthru
        if has_back:  # transmission-only paths stay camera-visible
            pure_t = pure_t & through
            if has_sss:
                pure_t = pure_t & ~scat

        # ---- fog state machine: transmission INTO a Beer glass arms the
        # fog, transmission OUT (a hit on the far side) clears it, internal
        # reflection keeps it armed. As in the JAX package it arms on entry
        # only (the reference's attenuationStep also arms on front-face
        # reflections, fogging the next outside segment).
        if has_fog:
            beer = alive & (p.fog_mult > 0.0)
            if has_alpha:
                beer = beer & ~passthru
            enter = beer & bs.is_transmission & front
            leave = beer & bs.is_transmission & ~front
            armed = torch.cat([p.fog_color, p.fog_mult[:, None]], 1)
            fog_state = torch.where(enter[:, None], armed,
                                    torch.where(leave[:, None], 0.0, fog_state))

        # ---- SSS boundary (sampleAndEvalBxDF's SSS branch,
        # CPUExp_IntegratorSSS.cpp:36): direction, weight and pdf come from
        # the lobes sampled above, into which fetch_material folded the
        # boundary (kd (1 - T) diffuse, (1 - kd) T translucency); picking
        # the translucency lobe crosses it, entering on a front hit and
        # leaving on a back hit
        if has_sss:
            is_sss = alive & ~scat & (p.sss_transmission > 0.0)
            if has_alpha:
                is_sss = is_sss & ~passthru
            cross = is_sss & bs.is_diff_trans
            enter = cross & front
            exit_ = cross & ~front
            in_med = (in_med & ~exit_) | enter
            med_sig_s = torch.where(enter, p.sss_density * p.sss_scattering,
                                    torch.where(exit_, 0.0, med_sig_s))
            med_sig_a = torch.where(enter[:, None],
                                    p.sss_density[:, None] * p.sss_absorption,
                                    torch.where(exit_[:, None], 0.0, med_sig_a))
            med_g = torch.where(enter, p.sss_phase, med_g)
            weight = torch.where(scat[:, None], 1.0, weight)
        throughput = throughput * weight
        if not pt_caustics:  # count diffuse bounces (unpackBounceNumDiff)
            diffused = alive & ~prev_spec
            if has_sss:
                diffused = diffused & ~scat
            diff_bounce = diff_bounce + diffused.to(torch.int32)
        if split:
            spec_only = spec_only & prev_spec
            if has_sss:
                spec_only = spec_only & ~scat
            if layer == "direct" and depth > 0:
                # RAY_WILL_DIE_NEXT_BOUNCE (material.cl:973-980): past the
                # first vertex a path that is not specular-only adds nothing
                # more to the direct layer (at depth 0 it lives one more
                # segment, for the implicit hit)
                alive = alive & spec_only

        # russian roulette on throughput from min_rr_depth
        if depth >= min_rr_depth:
            q = torch.clamp(throughput.amax(dim=-1), 0.05, 1.0)
            u_rr = rand(sidx, depth, DG_RR)[:, 0]
            throughput = throughput / q[:, None]
            alive = alive & ~(u_rr >= q)

        alive = alive & (throughput.amax(dim=-1) > 1e-7)
        n_off = torch.where(through[:, None], -ngs, ngs)
        ray_o = offs_ray_pos(pos, n_off, wi)
        if has_sss:  # scattered lanes go on from inside the medium
            ray_o = torch.where(scat[:, None], pos_scat, ray_o)
            wi = torch.where(scat[:, None], hg_dir, wi)
            prev_spec = prev_spec | scat
            prev_pdf = torch.where(scat, 0.0, prev_pdf)
        ray_d = wi

    if not sorted_mode:
        return acc, rays_traced
    out = torch.empty_like(acc)  # restore caller ray order (one scatter)
    out[orig_pos] = acc
    return out, rays_traced


# ----------------------------------------------------------------------------
# Full-frame pass driver (BeginTracingPass analogue, unified sampling)
# ----------------------------------------------------------------------------

@lru_cache(maxsize=8)
def _morton_pixel_order(W: int, H: int):
    """Flat pixel ids in Morton (z-curve) order, static per resolution."""
    ys, xs = np.mgrid[0:H, 0:W]
    xs = xs.reshape(-1).astype(np.uint64)
    ys = ys.reshape(-1).astype(np.uint64)
    key = np.zeros(W * H, np.uint64)
    for b in range(16):
        key |= ((xs >> b) & 1) << (2 * b)
        key |= ((ys >> b) & 1) << (2 * b + 1)
    order = np.argsort(key)
    return ((ys[order] * W) + xs[order]).astype(np.uint32)


@lru_cache(maxsize=8)
def _morton_pixel_inverse(W: int, H: int):
    """inv[pixel] = rank of that pixel in Morton order."""
    order = _morton_pixel_order(W, H)
    inv = np.empty(W * H, np.int32)
    inv[order] = np.arange(W * H, dtype=np.int32)
    return inv


def eye_rays(cam, pix, samp, seed: int):
    """Eye rays of the flat pixel ids pix at the QMC sample indices samp
    (int64, 32-bit): the streams keyed by pix * PHI ^ samp, the screen
    jitter screen_sample(samp, pix), the lens from the stream. Every
    schedule (pass loop, production, regen) draws its rays here, so all
    share one sample set. Returns (ray_o, ray_d, sample_idx)."""
    W = cam.width
    sample_idx = rng.mul32(pix, 0x9E3779B9) ^ samp
    jitter = rng.screen_sample(samp, pix)
    lens = rng.rand2(sample_idx, 0, DG_LENS, seed)
    ray_o, ray_d = make_eye_rays(cam, pix % W, pix // W, jitter, lens)
    return ray_o, ray_d, sample_idx


def primary_rays(scene, passes, seed: int, band: tuple[int, int] | None = None):
    """Eye rays of the Morton-ordered pixel band [start, end) for each pass
    in `passes`, pass-major. Returns (ray_o, ray_d, sample_idx, pix) with
    pix (B,) the band's flat pixel ids."""
    cam = scene.camera
    W, H = cam.width, cam.height
    dev = scene.tri_attr.device
    start, end = band if band is not None else (0, W * H)
    # consecutive ray blocks become compact screen tiles (Morton order)
    pix = torch.as_tensor(_morton_pixel_order(W, H)[start:end].astype(np.int64),
                          device=dev)
    pass_all = torch.as_tensor([p & rng.M32 for p in passes], dtype=torch.int64,
                               device=dev).repeat_interleave(pix.shape[0])
    ray_o, ray_d, sample_idx = eye_rays(cam, pix.repeat(len(passes)),
                                        pass_all, seed)
    return ray_o, ray_d, sample_idx, pix


def render_band_impl(scene, pass_idx, seed: int, max_depth: int = 5,
                     band: tuple[int, int] | None = None):
    """Trace one sample per pass in `pass_idx` (an int, or a list of ints
    traced together in one wavefront) for the Morton-ordered pixel band
    [start, end); returns (colors (P*B,3) pass-major, pix ids (B,), ray
    count)."""
    passes = [pass_idx] if isinstance(pass_idx, int) else list(pass_idx)
    ray_o, ray_d, sample_idx, pix = primary_rays(scene, passes, seed, band)
    color, rays = pt_trace(scene, ray_o, ray_d, sample_idx, seed,
                           max_depth=max_depth)
    # clamp fireflies like runKernel_ClampFloat4 (<clamping> setting)
    return torch.clamp(color, 0.0, scene.settings.clamp), pix, rays


def render_passes_band(scene, pass_base: int, seed: int, n_pass: int = 8,
                       max_depth: int = 5, band: tuple[int, int] | None = None):
    """N passes over one megablock band. Returns (colors sum (B,3),
    pix (B,), total rays). Bands smaller than MEGABLOCK trace several
    passes in one wavefront (every ray's numbers depend only on its pixel
    and pass, so the image is the same); the sum runs pass by pass."""
    W, H = scene.camera.width, scene.camera.height
    start, end = band if band is not None else (0, W * H)
    B = end - start
    group = max(1, MEGABLOCK // B)
    acc = None
    rays = 0
    for g in range(0, n_pass, group):
        passes = list(range(pass_base + g, pass_base + min(g + group, n_pass)))
        c, pix, r = render_band_impl(scene, passes, seed,
                                     max_depth=max_depth, band=band)
        for k in range(len(passes)):
            ck = c[k * B:(k + 1) * B]
            acc = ck if acc is None else acc + ck
        rays = rays + r
    return acc, pix, rays


def render_pass(scene, pass_idx: int, seed: int, max_depth: int = 5,
                device=None):
    """One sample for every pixel: render_passes with n_pass = 1, in
    megablock bands (the JAX package traces the frame in one wavefront;
    the image and ray count are the same, since every ray's numbers depend
    only on its pixel and pass). Returns ((H, W, 3) radiance f32, rays
    traced (int64 scalar tensor)) on `device` ("cuda" unless asked)."""
    return render_passes(scene, pass_idx, seed, n_pass=1, max_depth=max_depth,
                         device=device)


def render_passes(scene, pass_base: int, seed: int, n_pass: int = 8,
                  max_depth: int = 5, device=None, regen: bool = False,
                  lanes: int | None = None):
    """N full-frame passes, megablock-banded when the frame exceeds
    MEGABLOCK rays. Returns (sum of N pass images (H,W,3) f32, total rays
    traced (int64 scalar tensor)) on `device` ("cuda" unless asked).
    With regen a scene that pt_regen.regen_supported accepts goes through
    the regenerating wavefront of `lanes` lanes (the same sample set); any
    other scene through the pass loop."""
    if regen:  # pt_regen imports this module
        from hydracore_tpu_torch.integrators.pt_regen import (
            regen_supported, render_passes_regen)

        if regen_supported(scene):
            return render_passes_regen(scene, pass_base, seed, n_pass=n_pass,
                                       max_depth=max_depth, lanes=lanes,
                                       device=device)
    dev = resolve_device(device)
    check_supported(scene)
    scene = scene.to(dev)
    H, W = scene.camera.height, scene.camera.width
    R = H * W
    rays = torch.zeros((), dtype=torch.int64, device=dev)
    step = min(MEGABLOCK, R)
    bands = []
    for start in range(0, R, step):
        end = min(start + step, R)
        acc, _, r = render_passes_band(scene, pass_base, seed, n_pass,
                                       max_depth, (start, end))
        bands.append(acc)
        rays = rays + r
    morton_full = torch.cat(bands) if len(bands) > 1 else bands[0]
    inv = torch.as_tensor(_morton_pixel_inverse(W, H).astype(np.int64),
                          device=dev)
    return morton_full[inv].reshape(H, W, 3), rays


def _production_rays(scene, pix_ids, pass_base: int, seed: int,
                     k_samples: int):
    """Eye rays of K samples of each pixel of pix_ids (P,), pixel-major:
    sample k of pixel p is sample pass_base + k of the pass loop. Returns
    (ray_o, ray_d, sample_idx), P * K each."""
    P = pix_ids.shape[0]
    pix = pix_ids.to(torch.int64).repeat_interleave(k_samples)
    samp = (torch.arange(k_samples, dtype=torch.int64, device=pix.device)
            .repeat(P) + pass_base) & rng.M32
    return eye_rays(scene.camera, pix, samp, seed)


def _tile_production(scene, pix_ids, pass_base: int, seed: int,
                     k_samples: int, max_depth: int):
    """render_tile_production on a scene already on its device, with the
    rays traced (int64 scalar tensor)."""
    ray_o, ray_d, sample_idx = _production_rays(scene, pix_ids, pass_base,
                                                seed, k_samples)
    color, rays = pt_trace(scene, ray_o, ray_d, sample_idx, seed,
                           max_depth=max_depth)
    color = torch.clamp(color, 0.0, scene.settings.clamp)
    return color.reshape(pix_ids.shape[0], k_samples, 3).mean(dim=1), rays


def render_tile_production(scene, pix_ids, pass_base: int, seed: int,
                           k_samples: int = 64, max_depth: int = 5,
                           device=None):
    """Production sampling: K samples of each pixel of pix_ids (P,) flat
    pixel ids in one wavefront of P * K rays, pixel-major, the QMC index of
    sample k being pass_base + k (ref RunProductionSamplingMode); each
    sample clamped, then the per-pixel mean. Returns (P, 3) f32 on
    `device` ("cuda" unless asked)."""
    dev = resolve_device(device)
    check_supported(scene)
    pix_ids = torch.as_tensor(pix_ids, device=dev)
    return _tile_production(scene.to(dev), pix_ids, pass_base, seed,
                            k_samples, max_depth)[0]


def render_production(scene, spp: int, seed: int = 777,
                      max_depth: int | None = None, tile_pixels: int = 16384,
                      device=None, stats: dict | None = None):
    """Offline 'production' render: tiles of tile_pixels pixels in raster
    order, each in rounds of K = min(spp, 64) samples a pixel (round r at
    pass_base r * K), the tile the mean of its ceil(spp / K) rounds, so spp
    is rounded up to whole rounds, as in the JAX package. Returns (H, W, 3)
    f32 on `device` ("cuda" unless asked); a `stats` dict receives the
    tiles, the rounds a tile and the rays traced."""
    dev = resolve_device(device)
    check_supported(scene)
    md = max_depth or scene.settings.trace_depth
    scene = scene.to(dev)
    H, W = scene.camera.height, scene.camera.width
    k = min(max(spp, 1), 64)
    n_rounds = -(-spp // k)  # ceil: never silently under-sample
    out = torch.zeros((H * W, 3), dtype=torch.float32, device=dev)
    rays = torch.zeros((), dtype=torch.int64, device=dev)
    for start in range(0, H * W, tile_pixels):
        ids = torch.arange(start, min(start + tile_pixels, H * W),
                           dtype=torch.int64, device=dev)
        acc = torch.zeros((ids.shape[0], 3), dtype=torch.float32, device=dev)
        for r in range(n_rounds):
            c, rr = _tile_production(scene, ids, r * k, seed, k, md)
            acc = acc + c
            rays = rays + rr
        out[start:start + ids.shape[0]] = acc / n_rounds
    if stats is not None:
        stats.update(tiles=-(-H * W // tile_pixels), rounds=n_rounds,
                     rays=rays)
    return out.reshape(H, W, 3)


def render(scene, spp: int, seed: int = 777, max_depth: int | None = None,
           progress=None, device=None, regen: bool = False):
    """Accumulate `spp` passes; returns (H, W, 3) float32 mean radiance on
    `device` ("cuda" unless asked). regen as in render_passes."""
    dev = resolve_device(device)
    md = max_depth or scene.settings.trace_depth
    scene = scene.to(dev)  # keep the scene heap device-resident
    H, W = scene.camera.height, scene.camera.width
    fb = torch.zeros((H, W, 3), dtype=torch.float32, device=dev)
    chunk = min(8, spp)
    i = 0
    while i < spp:
        k = min(chunk, spp - i)
        color, _ = render_passes(scene, i, seed, n_pass=k, max_depth=md,
                                 device=dev, regen=regen)
        fb = fb + color
        i += k
        if progress is not None:
            progress(i - 1)
    return fb / spp
