"""Wavefront MIS path tracer (PT / MISPT) over megablock ray batches (torch).

The JAX package's integrators/pt.py, main path: per bounce a closest-hit
trace, compute_hit, fetch_material and the BSDF, then NEE with a shadow
any-hit trace; ops/trace_api.py picks the traversal (kernels B1/B2, B3
over an instanced scene, B4 over the packet route, or a plain path). Two
wavefront modes, as there: with a traversal that wants sorted rays (the
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
entry points (render_passes, render) run on `device` ("cuda" by default).
"""
from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch

from hydracore_tpu_torch.bsdf.core import (eval_bsdf, fetch_material,
                                           sample_bsdf, scene_feats)
from hydracore_tpu_torch.lights.envmap import env_pdf_for_dir
from hydracore_tpu_torch.lights.sampling import (env_radiance,
                                                 light_eval_pdf_from_hit,
                                                 light_rows,
                                                 sample_light_rev,
                                                 select_light)
from hydracore_tpu_torch.ops import rng
from hydracore_tpu_torch.ops.trace_api import (any_hit, closest_hit,
                                               coherence_order,
                                               wants_sorted_rays)
from hydracore_tpu_torch.scene.lights import LIGHT_SKY
from hydracore_tpu_torch.scene.scene import check_supported
from hydracore_tpu_torch.utils.device import resolve_device
from hydracore_tpu_torch.utils.math3d import (cross3, dot3, normalize3,
                                              offs_ray_pos, sqrt)

# rng dimension groups per bounce (role analogue of QMC_VAR_* slots)
DG_LENS = 0
DG_BSDF = 1
DG_LIGHT = 2
DG_RR = 3

# max rays per wavefront: decouples image size from device footprint
# (CalcMegaBlockSize, GPUOCLLayer.cpp:841-876)
MEGABLOCK = 1 << 18


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


def shadow_trace(scene, sray_o, sdir, dist, active):
    """Occlusion query on the wavefront as it stands: already in coherence
    order when the traversal wants that (opaque scenes; the alpha layer
    walk is not ported yet)."""
    return any_hit(scene, sray_o, sdir, dist * 0.995, active=active)


# ----------------------------------------------------------------------------
# The bounce loop
# ----------------------------------------------------------------------------

def pt_trace(scene, ray_o, ray_d, sample_idx, seed, max_depth: int = 5,
             min_rr_depth: int = 3):
    """Trace a batch of primary rays (already in coherence order, as
    Morton-ordered primaries are) to completion. sample_idx (R,) u32 stream
    ids (int64) key every random number. The live state is re-sorted every
    bounce only for a traversal that wants sorted rays. Returns (radiance (R,3) in caller
    order, rays_traced (int64 scalar tensor)): the ray counter feeds the
    Mrays/s metric (MRaysStat analogue)."""
    st = scene.settings
    dev = ray_o.device
    R = ray_o.shape[0]

    def rand(sidx, depth, group):
        return rng.rand4(sidx, depth, group, seed)

    sorted_mode = wants_sorted_rays(scene)
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

        rays_traced = rays_traced + alive.sum()
        t, tri, u, v = closest_hit(scene, ray_o, ray_d, active=alive,
                                   kind="primary" if depth == 0 else "bounce")
        hit = alive & (tri >= 0)
        miss = alive & ~hit

        # ---- environment (HitEnvOrLightKernel env path, material.cl:344)
        if has_sky_s:
            env = env_radiance(scene, ray_d)
            env_pdf = env_pdf_for_dir(scene.env_rows_cdf, scene.env_cols_cdf,
                                      scene.env_pdf_uv, ray_d)
            w_env = torch.where(prev_spec | ~has_sky, 1.0,
                                mis_weight(prev_pdf, env_pdf * sky_pick))
            env_c = env * w_env[:, None]
            acc = acc + torch.where(miss[:, None], throughput * env_c, 0.0)
        alive = alive & hit

        pos, n, ng, uv, mat_id, tri_light, _ = compute_hit(
            scene, tri, u, v, ray_o, ray_d, t)
        p = fetch_material(scene, mat_id, uv)

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
        front = dot3(n, -ray_d) > 0.0
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
        acc = acc + emit
        alive = alive & ~is_emitter  # the path ends on emitters

        if depth == max_depth - 1:
            break

        # ---- NEE (ShadePass: LightSample -> ShadowTrace -> Shade); shade
        # with the viewer-oriented normal (two-sided reflection)
        ns = torch.where(dot3(n, -ray_d)[:, None] >= 0.0, n, -n)
        ngs = torch.where(dot3(ng, -ray_d)[:, None] >= 0.0, ng, -ng)
        ls = sample_light_rev(scene, l_idx, r_l[:, :3], pos, rows=rows_nee)
        pick_prob = ls.pick_prob
        sray_o = offs_ray_pos(pos, ngs, ls.dir)
        f, pdf_fwd = eval_bsdf(p, -ray_d, ls.dir, ns, feats)
        # two-sided combine: |cos| credits transmission lobes
        cos_s = dot3(ls.dir, ns).abs()
        w_l = torch.where(ls.is_delta, 1.0,
                          mis_weight(ls.pdf_w * pick_prob, pdf_fwd))
        contrib = (throughput * f * ls.radiance
                   * (cos_s * w_l / torch.clamp(ls.pdf_w * pick_prob, min=1e-12))[:, None])
        ok = alive & (cos_s > 0.0)
        # zero-contribution lanes need no occlusion query
        need_sh = ok & (contrib.amax(dim=-1) > 0.0)
        rays_traced = rays_traced + need_sh.sum()  # shadow rays
        occluded = shadow_trace(scene, sray_o, ls.dir, ls.dist, need_sh)
        acc = acc + torch.where((need_sh & ~occluded)[:, None], contrib, 0.0)

        # ---- next bounce (NextBounce: BSDF sample, RR, flags)
        bs = sample_bsdf(p, -ray_d, ns, rand(sidx, depth, DG_BSDF), feats)
        prev_pdf = bs.pdf
        prev_spec = bs.is_specular
        throughput = throughput * bs.weight
        if not pt_caustics:  # count diffuse bounces (unpackBounceNumDiff)
            diff_bounce = diff_bounce + (alive & ~prev_spec).to(torch.int32)

        # russian roulette on throughput from min_rr_depth
        if depth >= min_rr_depth:
            q = torch.clamp(throughput.amax(dim=-1), 0.05, 1.0)
            u_rr = rand(sidx, depth, DG_RR)[:, 0]
            throughput = throughput / q[:, None]
            alive = alive & ~(u_rr >= q)

        alive = alive & (throughput.amax(dim=-1) > 1e-7)
        n_off = torch.where(bs.is_transmission[:, None], -ngs, ngs)
        ray_o = offs_ray_pos(pos, n_off, bs.wi)
        ray_d = bs.wi

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
    pix_all = pix.repeat(len(passes))
    pass_all = torch.as_tensor([p & rng.M32 for p in passes], dtype=torch.int64,
                               device=dev).repeat_interleave(pix.shape[0])
    sample_idx = rng.mul32(pix_all, 0x9E3779B9) ^ pass_all
    jitter = rng.screen_sample(pass_all, pix_all)
    lens = rng.rand2(sample_idx, 0, DG_LENS, seed)
    ray_o, ray_d = make_eye_rays(cam, pix_all % W, pix_all // W, jitter, lens)
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


def render_passes(scene, pass_base: int, seed: int, n_pass: int = 8,
                  max_depth: int = 5, device=None):
    """N full-frame passes, megablock-banded when the frame exceeds
    MEGABLOCK rays. Returns (sum of N pass images (H,W,3) f32, total rays
    traced (int64 scalar tensor)) on `device` ("cuda" unless asked)."""
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


def render(scene, spp: int, seed: int = 777, max_depth: int | None = None,
           progress=None, device=None):
    """Accumulate `spp` passes; returns (H, W, 3) float32 mean radiance on
    `device` ("cuda" unless asked)."""
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
                                 device=dev)
        fb = fb + color
        i += k
        if progress is not None:
            progress(i - 1)
    return fb / spp
