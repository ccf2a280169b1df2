"""SBDPT — bidirectional path tracing with s-t connections and full MIS
(torch).

The JAX package's integrators/bdpt.py (ref hydra_drv/GPUOCLLayerAdvanced.cpp:599
SBDPT_Pass / :949 EvalSBDPT, hydra_drv/shaders/mlt.cl:723
MMLTCameraPathBounce / :1135 MMLTLightPathBounce / :1472 MMLTConnect,
hydra_drv/cbidir.h PathVertex / PdfVertex): whole wavefronts of camera and
light subpaths are generated in lockstep with every vertex recorded as
stacked tensors, then every (s, t) strategy is evaluated batched.

MIS uses the explicit-product form of the power heuristic: for an
assembled path x_0..x_{k-1} (x_0 = camera pinhole, x_{k-1} = the light
sample y_0) the per-vertex area pdfs from the camera side (pf) and the
light side (pl) give each strategy t' (number of camera vertices) the
density
    p(t') = prod_{0<i<t'} pf[i] * prod_{t'<=i<k} pl[i]
and w = D(t)^2 / sum_t' D(t')^2, with D(1) scaled by the light-subpath
count (t'=1 splats draw from every light path in the wavefront). Delta
(specular) scatter pdfs are remapped to 1 with the adjacent connection
strategies zeroed. The weight is walked as float32 pdf ratios in the JAX
package's order (_mis_weight).

Camera measure is per-pixel (image plane at d_img = H/(2 tan(fov/2)) in
pixel units), as in integrators/lt.py, so PT / LT / SBDPT estimate the same
per-pixel integral. Area-class lights take part in every strategy, the
sky in every strategy through the infinite-light convention (env endpoint
in solid-angle measure, first surface vertex from the env at planar
bounding-disk density), delta lights through NEE and light subpaths.

The port's rules where the JAX package leans on XLA:
  * every trace goes through ops/trace_api.py over the full pool, with no
    alpha layer walk, as the JAX package's do: the first camera wavefront
    as it comes (Morton pixel order), every other one through the sorted
    calls, which sort on the cluster route only;
  * values that are garbage on masked lanes (a miss has t = +inf) are
    masked with torch.where, never multiplied by a 0/1 mask, and the
    screen coordinates of the t = 1 strategy are tested in float and cast
    only on lanes that land on the screen;
  * the splat is index_add_ (many light vertices land in one pixel), then
    the per-pass clamp to [0, 1e6];
  * the strategy structure (which blocks exist, the sky blocks only in a
    scene with a sky) is static Python, so a scene without a sky launches
    no sky work.
"""
from __future__ import annotations

import math

import torch

from hydracore_tpu_torch.bsdf.core import (FEATS_ALL, apply_bump, eval_bsdf,
                                           fetch_material, sample_bsdf,
                                           scene_feats)
from hydracore_tpu_torch.integrators.pt import (_morton_pixel_order,
                                                compute_hit, make_eye_rays)
from hydracore_tpu_torch.lights.envmap import env_pdf_for_dir
from hydracore_tpu_torch.lights.sampling import (FAR_DIST, _light_types,
                                                 env_radiance,
                                                 sample_light_fwd,
                                                 scene_bounding_sphere,
                                                 select_light)
from hydracore_tpu_torch.ops import rng
from hydracore_tpu_torch.ops.trace_api import (any_hit_sorted, closest_hit,
                                               closest_hit_sorted)
from hydracore_tpu_torch.scene.lights import (LIGHT_AREA_DISK,
                                              LIGHT_AREA_RECT,
                                              LIGHT_CYLINDER, LIGHT_MESH,
                                              LIGHT_SKY, LIGHT_SPHERE)
from hydracore_tpu_torch.scene.scene import check_supported
from hydracore_tpu_torch.utils import spans
from hydracore_tpu_torch.utils.device import resolve_device
from hydracore_tpu_torch.utils.math3d import dot3, offs_ray_pos, sqrt

# light types a camera ray can land on (s'=0 strategies exist)
HITTABLE_TYPES = (LIGHT_AREA_RECT, LIGHT_AREA_DISK, LIGHT_SPHERE,
                  LIGHT_CYLINDER, LIGHT_MESH)

INV_PI = 1.0 / math.pi

# rng dimension groups (distinct from PT's 0..6 and LT's 5, 6, 12)
DG_BD_LENS = 7
DG_BD_CAM_BSDF = 8
DG_BD_LGT_EMIT = 9
DG_BD_LGT_BSDF = 10
DG_BD_BLEND = 11  # blend-tree walk uniforms (col 0)


def _remap1(x):
    """remap0 of the reference/PBRT MIS walk: delta pdfs count as 1."""
    return torch.where(x > 0.0, x, 1.0)


def _to_area(pdf_w, from_pos, to_pos, to_ng):
    """Solid-angle pdf at `from` -> area pdf at `to` (cbidir.h PdfWtoA)."""
    d = to_pos - from_pos
    d2 = torch.clamp(dot3(d, d), min=1e-12)
    w = d * torch.rsqrt(d2)[:, None]
    return pdf_w * dot3(w, to_ng).abs() / d2


class _V:
    """One recorded subpath vertex: attribute bag of (R,...) tensors."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


def _camera_data(cam):
    tan_half = cam.mProjInv[1, 1]
    d_img = cam.height / (2.0 * tan_half)
    return tan_half, d_img


def _view(cam):
    """The view matrix (world -> view), float32 as the JAX package inverts
    it; inv_ex, so the card is not synchronized to check the inverse."""
    return torch.linalg.inv_ex(cam.mWorldViewInv).inverse


def cam_pdf_w(cam, w_world):
    """Per-pixel-measure solid-angle pdf of the camera emitting direction
    w_world: d_img^2 / cos^3 (the CameraImageToSurfaceFactor core)."""
    view = _view(cam)[:3, :3]
    wv = w_world @ view.T
    cos_c = torch.clamp(-wv[:, 2], min=1e-6)
    _, d_img = _camera_data(cam)
    return d_img * d_img / (cos_c ** 3)


def project_to_screen(cam, pos):
    """World pos -> (pix_flat, on_screen, w_to_cam, dist, cos_cam).

    The pixel is floored and tested in float; only lanes that land on the
    screen are cast (a dead lane's inf or NaN position never is), the others
    take pixel 0. Every on-screen lane gets the JAX package's pixel."""
    W, H = cam.width, cam.height
    tan_half, _ = _camera_data(cam)
    view = _view(cam)
    pv = pos @ view[:3, :3].T + view[:3, 3]
    z = -pv[:, 2]
    in_front = z > 1e-4
    sx = pv[:, 0] / torch.clamp(z, min=1e-6) / (tan_half * W / H)
    sy = pv[:, 1] / torch.clamp(z, min=1e-6) / tan_half
    fx = torch.floor((sx + 1.0) * 0.5 * W)
    fy = torch.floor((1.0 - sy) * 0.5 * H)
    on = in_front & (fx >= 0) & (fx < W) & (fy >= 0) & (fy < H)
    to_cam = cam.pos - pos
    dist2 = torch.clamp(dot3(to_cam, to_cam), min=1e-12)
    dist = sqrt(dist2)
    w_cam = to_cam / dist[:, None]
    cos_cam = torch.clamp(z / dist, min=1e-6)
    px = torch.where(on, fx, 0.0).to(torch.int64)
    py = torch.where(on, fy, 0.0).to(torch.int64)
    return py * W + px, on, w_cam, dist, cos_cam


def light_emit_pdf_w(cos_at_light):
    """Solid-angle pdf of the cosine-weighted emission the forward sampler
    uses for hittable (area-class) lights (clight.h LightSampleForward)."""
    return torch.clamp(cos_at_light, min=0.0) * INV_PI


# ----------------------------------------------------------------------------
# Subpath generation
# ----------------------------------------------------------------------------

def trace_camera_subpath(scene, ray_o, ray_d, rand_fn, n_surf: int,
                         feats=None, n_lane=None):
    """Trace z_1..z_{n_surf} (z_0 = camera pinhole, implicit).

    Vertex fields: pos, ns, ng, wo (unit, toward previous vertex), beta
    (throughput up to and including arrival), pf (area pdf of this vertex
    from the camera side), pr (area pdf of this vertex from one step
    deeper — valid for i < last-1), valid, spec (scatter AT this vertex
    was delta), is_env / env_dir / pf_w_arr (a live ray that escaped: its
    direction and raw solid-angle arrival pdf), mat, em_color, light_row.

    n_lane (R,) int optionally caps each LANE's surface-vertex count —
    deeper steps go inactive for that lane (MMLT's merged per-depth
    dispatch)."""
    feats = FEATS_ALL if feats is None else feats
    R = ray_o.shape[0]
    cam = scene.camera
    dev = ray_o.device
    verts = []
    beta = torch.ones((R, 3), dtype=torch.float32, device=dev)
    alive = torch.ones((R,), dtype=torch.bool, device=dev)
    prev_pos = torch.broadcast_to(cam.pos, (R, 3))
    pdf_w_prev = cam_pdf_w(cam, ray_d)

    for i in range(n_surf):
        spans.phase("bdpt.camera", within="bdpt.pass", depth=i)
        if n_lane is not None:
            alive = alive & (i < n_lane)
        trace = closest_hit if i == 0 else closest_hit_sorted
        t, tri, u, v = trace(scene, ray_o, ray_d, active=alive)
        hit = alive & (tri >= 0)
        pos, n, ng, uv, mat_id, tri_light, tang = compute_hit(
            scene, tri, u, v, ray_o, ray_d, t)
        p = fetch_material(scene, mat_id, uv, pos, n, wo=-ray_d,
                           u_blend=rand_fn(i, DG_BD_BLEND)[:, 0])
        n = apply_bump(scene, p, n, tang, uv)
        n = torch.where(dot3(n, -ray_d)[:, None] >= 0.0, n, -n)
        ng_o = torch.where(dot3(ng, -ray_d)[:, None] >= 0.0, ng, -ng)

        pf = _to_area(pdf_w_prev, prev_pos, pos, ng_o)
        # env escape bookkeeping (the "sky strategy": cbidir.h:619-625): a
        # live ray that missed ends the path at the environment
        v_rec = _V(pos=pos, ns=n, ng=ng_o, wo=-ray_d, beta=beta, pf=pf,
                   pr=torch.zeros((R,), dtype=torch.float32, device=dev),
                   valid=hit,
                   spec=torch.zeros((R,), dtype=torch.bool, device=dev),
                   is_env=alive & (tri < 0), env_dir=ray_d,
                   pf_w_arr=pdf_w_prev,
                   mat=p, em_color=p.em_color, light_row=tri_light)
        verts.append(v_rec)

        if i == n_surf - 1:
            break

        r_b = rand_fn(i, DG_BD_CAM_BSDF)
        bs = sample_bsdf(p, -ray_d, n, r_b, feats)
        v_rec.spec = bs.is_specular
        beta = beta * bs.weight
        alive = hit & (beta.amax(dim=-1) > 1e-7)

        # pr of the PREVIOUS vertex: this vertex scattering back to it
        _, pdf_back = eval_bsdf(p, bs.wi, -ray_d, n, feats)
        pdf_back = torch.where(bs.is_specular, 0.0, pdf_back)
        if i >= 1:
            verts[i - 1].pr = _to_area(pdf_back, pos, verts[i - 1].pos,
                                       verts[i - 1].ng)

        pdf_w_prev = torch.where(bs.is_specular, 0.0, bs.pdf)
        prev_pos = pos
        n_off = torch.where(bs.is_transmission[:, None], -ng_o, ng_o)
        ray_o = offs_ray_pos(pos, n_off, bs.wi)
        ray_d = bs.wi

    return verts


def trace_light_subpath(scene, rand_fn, n_surf: int, feats=None,
                        n_lane=None):
    """Sample y_0 on a light, trace y_1..y_{n_surf}.

    y0 fields: pos, ns, ng, beta (= Le/(pick*pdfA)), pf (= pick*pdfA, or
    pick*pdfW on sky lanes), pr (camera-side pdf once y_1's continuation is
    known), is_env / env_dir / beta_dir / pdf_a_far (sky lanes), hittable
    (area-class light or sky — s'=0 strategies exist), valid."""
    feats = FEATS_ALL if feats is None else feats
    spans.phase("bdpt.light", within="bdpt.pass", depth=0)
    r_e = rand_fn(0, DG_BD_LGT_EMIT)
    l_idx, pick_prob = select_light(scene.lights, r_e[:, 3])
    ls = sample_light_fwd(scene, l_idx, r_e)
    R = ls.pos.shape[0]
    dev = ls.pos.device
    ltype = scene.lights.ltype[l_idx.long()]
    hittable = torch.zeros((R,), dtype=torch.bool, device=dev)
    for ht in HITTABLE_TYPES:
        hittable = hittable | (ltype == ht)

    # sky lanes: the env endpoint lives in DIRECTIONAL measure (PBRT-style
    # infinite-light convention):
    #   pl[k-1] (endpoint density)  = pick * env_pdf_w(emit dir)
    #   pl[k-2] (first surface hit) = planar disk density * |cos|
    # and the env is always "hittable" (a camera ray can escape to it).
    is_env0 = (ltype == LIGHT_SKY) if LIGHT_SKY in _light_types(scene) \
        else torch.zeros((R,), dtype=torch.bool, device=dev)
    env_dir0 = -ls.dir  # direction TOWARD the sky
    y0 = _V(pos=ls.pos, ns=ls.norm, ng=ls.norm,
            beta=ls.radiance / torch.clamp(ls.pdf_a * pick_prob,
                                           min=1e-12)[:, None],
            pf=torch.where(is_env0, ls.pdf_w * pick_prob,
                           ls.pdf_a * pick_prob),
            pr=torch.zeros((R,), dtype=torch.float32, device=dev),
            spec=torch.zeros((R,), dtype=torch.bool, device=dev),
            is_env=is_env0, env_dir=env_dir0,
            # directional beta for the s'=1 env connect (radiance over the
            # DIRECTION density; garbage on non-sky lanes, always masked)
            beta_dir=ls.radiance / torch.clamp(ls.pdf_w * pick_prob,
                                               min=1e-12)[:, None],
            pdf_a_far=ls.pdf_a,
            hittable=hittable | is_env0,
            valid=torch.ones((R,), dtype=torch.bool, device=dev),
            light_row=l_idx)

    verts = []
    beta = y0.beta * (ls.cos_at_light / torch.clamp(ls.pdf_w,
                                                    min=1e-12))[:, None]
    alive = torch.ones((R,), dtype=torch.bool, device=dev)
    ray_o = offs_ray_pos(ls.pos, ls.norm, ls.dir)
    ray_d = ls.dir
    prev_pos = ls.pos
    pdf_w_prev = ls.pdf_w

    for j in range(n_surf):
        if j:
            spans.phase("bdpt.light", within="bdpt.pass", depth=j)
        if n_lane is not None:  # per-lane depth cap (merged MMLT groups)
            alive = alive & (j < n_lane)
        t, tri, u, v = closest_hit_sorted(scene, ray_o, ray_d, active=alive)
        hit = alive & (tri >= 0)
        pos, n, ng, uv, mat_id, _, tang = compute_hit(
            scene, tri, u, v, ray_o, ray_d, t)
        p = fetch_material(scene, mat_id, uv, pos, n, wo=-ray_d,
                           u_blend=rand_fn(j + 1, DG_BD_BLEND)[:, 0])
        n = apply_bump(scene, p, n, tang, uv)
        n = torch.where(dot3(n, -ray_d)[:, None] >= 0.0, n, -n)
        ng_o = torch.where(dot3(ng, -ray_d)[:, None] >= 0.0, ng, -ng)

        pf = _to_area(pdf_w_prev, prev_pos, pos, ng_o)
        if j == 0:
            # env light paths: the first surface vertex's light-side
            # density is the PLANAR disk density, not pdf_w-to-area
            pf = torch.where(is_env0,
                             y0.pdf_a_far * dot3(ng_o, ray_d).abs(), pf)
        v_rec = _V(pos=pos, ns=n, ng=ng_o, wo=-ray_d, beta=beta, pf=pf,
                   pr=torch.zeros((R,), dtype=torch.float32, device=dev),
                   valid=hit,
                   spec=torch.zeros((R,), dtype=torch.bool, device=dev),
                   mat=p)
        verts.append(v_rec)

        if j == n_surf - 1:
            break

        r_b = rand_fn(j + 1, DG_BD_LGT_BSDF)
        bs = sample_bsdf(p, -ray_d, n, r_b, feats)
        v_rec.spec = bs.is_specular
        beta = beta * bs.weight
        alive = hit & (beta.amax(dim=-1) > 1e-7)

        _, pdf_back = eval_bsdf(p, bs.wi, -ray_d, n, feats)
        pdf_back = torch.where(bs.is_specular, 0.0, pdf_back)
        if j >= 1:
            verts[j - 1].pr = _to_area(pdf_back, pos, verts[j - 1].pos,
                                       verts[j - 1].ng)
        else:
            # env y0 lives in directional measure: the camera-side density
            # of scattering back toward the sky is the RAW solid-angle pdf
            y0.pr = torch.where(is_env0, pdf_back,
                                _to_area(pdf_back, pos, y0.pos, y0.ng))

        pdf_w_prev = torch.where(bs.is_specular, 0.0, bs.pdf)
        prev_pos = pos
        n_off = torch.where(bs.is_transmission[:, None], -ng_o, ng_o)
        ray_o = offs_ray_pos(pos, n_off, bs.wi)
        ray_d = bs.wi

    return y0, verts


# ----------------------------------------------------------------------------
# Assembled-path pdf lists + MIS
# ----------------------------------------------------------------------------

def _assemble(R, zs, ys, y0, t: int, s: int, junc):
    """pf/pl/spec lists for the assembled path x_0..x_{k-1}, k = s + t.

    x_0 = pinhole, x_i = z_i (= zs[i-1]) for 1<=i<=t-1,
    x_{t-1+m} = y_{s-m} for 1<=m<=s (y_j = ys[j-1] for j>=1, y_0 = y0).

    junc: dict with the connection-dependent pdfs (already area-measure):
      pf_junc   — pdfA(x_t <- x_{t-1})        [absent when s == 0]
      pf_junc2  — pdfA(x_{t+1} <- x_t)        [when s >= 2]
      pl_junc   — pdfA(x_{t-1} <- x_t)        [absent when s+t trivial]
      pl_junc2  — pdfA(x_{t-2} <- x_{t-1})    [when t >= 3]
    """
    one = torch.ones((R,), dtype=torch.float32, device=y0.pos.device)
    k = s + t
    xs = [None]  # x_0 camera
    xs += [zs[i - 1] for i in range(1, t)]
    xs += [(ys[s - m - 1] if s - m >= 1 else y0) for m in range(1, s + 1)]

    pf = [one] * k
    for i in range(1, t):
        pf[i] = zs[i - 1].pf
    if s >= 1:
        pf[t] = junc["pf_junc"]
    if s >= 2:
        pf[t + 1] = junc["pf_junc2"]
    for i in range(t + 2, k):
        pf[i] = xs[i].pr  # stored camera-side scatter-back pdfs

    pl = [one] * k
    if s >= 1:
        pl[k - 1] = y0.pf
        for m in range(1, s):  # x_{t-1+m} = y_{s-m}, generated from y_{s-m-1}
            pl[t - 1 + m] = xs[t - 1 + m].pf
    if "pl_junc" in junc:
        pl[t - 1] = junc["pl_junc"]
    if t >= 3 and "pl_junc2" in junc:
        pl[t - 2] = junc["pl_junc2"]
    for i in range(1, t - 2):
        pl[i] = zs[i - 1].pr

    spec = [torch.zeros((R,), dtype=torch.bool, device=y0.pos.device)] * k
    for i in range(1, k):
        spec[i] = xs[i].spec
    return pf, pl, spec


def _mis_weight(pf, pl, spec, can, t_strat: int, n_splat: float,
                y0_hittable, three_way: bool):
    """Power-heuristic weight for the strategy with t_strat camera vertices
    (t_strat == k means s'=0: the camera path hits the light)."""
    k = len(pf)
    if three_way:
        allowed = {1, k - 1, k}
    else:
        allowed = set(range(1, k + 1))
    if k == 2:
        # the (s'=1, t'=1) directly-visible-light splat is not sampled;
        # keeping it in the denominator would leak energy on k=2 paths
        allowed.discard(1)

    # Incremental pdf-RATIO walk relative to the sampled strategy (the
    # PBRT MISWeight `ri` recursion): r(tp) = p_tp / p_{t_strat}, built as
    # a product of per-vertex pf/pl ratios, in float32 and in the JAX
    # package's order. Absolute per-strategy products of area pdfs
    # overflow float32 on deep paths (7 vertices at ~1e4-1e5 each reach
    # 1e20; squaring hits inf and inf/inf => NaN pixels); the ratio form
    # stays O(1) near the sampled strategy and degrades to w -> 0 (not
    # NaN) when an alternative dominates.
    def ok_for(tp):
        if tp == k:  # implicit hit: light must be geometrically hittable
            return y0_hittable & ~spec[k - 1]
        return (~spec[tp - 1] & ~spec[tp]) if tp >= 2 else ~spec[tp]

    def term(tp, r):
        d = torch.where(ok_for(tp) & can, r, 0.0)
        if tp == 1:
            d = d * n_splat
        return d * d

    num_f = n_splat if t_strat == 1 else 1.0
    total = term(t_strat, torch.ones_like(pf[0])) if t_strat in allowed \
        else torch.zeros_like(pf[0])
    # walk down: p_{tp-1} = p_tp * pl[tp-1] / pf[tp-1]
    r = torch.ones_like(pf[0])
    for tp in range(t_strat - 1, 0, -1):
        r = r * _remap1(pl[tp]) / _remap1(pf[tp])
        if tp in allowed:
            total = total + term(tp, r)
    # walk up: p_{tp+1} = p_tp * pf[tp] / pl[tp]
    r = torch.ones_like(pf[0])
    for tp in range(t_strat + 1, k + 1):
        r = r * _remap1(pf[tp - 1]) / _remap1(pl[tp - 1])
        if tp in allowed:
            total = total + term(tp, r)
    num = torch.where(ok_for(t_strat) & can, float(num_f) ** 2, 0.0)
    return torch.where(total > 0, num / torch.clamp(total, min=1e-30), 0.0)


# ----------------------------------------------------------------------------
# The pass
# ----------------------------------------------------------------------------

def _bdpt_core(scene, ray_o, ray_d, rand_fn, own_pix, n_splat: float,
               max_depth: int, strategies: str = "full",
               k_only: int | None = None, with_labels: bool = False,
               lane_k=None):
    """Evaluate SBDPT strategies for a wavefront of camera+light
    subpaths. Returns a list of (flat_pix (R,) int64, color (R,3))
    contributions — one entry per (s, t) strategy evaluated. k_only
    restricts to paths with exactly k vertices (MMLT's per-depth chains).
    with_labels=True returns ((s, t), flat, color) triples instead (the
    per-strategy oracle cross-check consumes these).

    rand_fn(depth, group) -> (R, 4) uniforms (a primary-sample vector for
    MMLT, the counter-based streams for a pass). lane_k (R,) int: per-LANE
    path-vertex count — every lane evaluates only its own depth's
    strategies, and subpath tracing goes inactive past each lane's depth
    (the merged per-depth MMLT dispatch, GPUOCLLayerAdvanced.cpp:518-595)."""
    cam = scene.camera
    R = ray_o.shape[0]
    dev = ray_o.device
    three_way = strategies == "3way"
    n_splat = float(n_splat)

    feats = scene_feats(scene)
    if k_only is None:
        NC = max_depth        # camera surface vertices z_1..z_NC
        NL = max_depth - 1    # light surface vertices y_1..y_NL
    else:
        NC = k_only - 1
        NL = max(k_only - 2, 1)
    nl_c = nl_l = None
    if lane_k is not None:
        nl_c = lane_k - 1                             # camera surface vertices
        nl_l = torch.clamp(lane_k - 2, min=0)         # light surface vertices
    zs = trace_camera_subpath(scene, ray_o, ray_d, rand_fn, NC, feats,
                              n_lane=nl_c)
    y0, ys = trace_light_subpath(scene, rand_fn, NL, feats, n_lane=nl_l)
    spans.phase("bdpt.connect", within="bdpt.pass")
    fzero = torch.zeros((R,), dtype=torch.bool, device=dev)

    out = []

    def keep(t, s):
        return k_only is None or (s + t) == k_only

    # ---- s = 0: camera path hits an emitter (PT implicit)
    n_lights = scene.lights.ltype.shape[0]
    for t in range(2, NC + 2):
        if not keep(t, 0):
            continue
        z = zs[t - 2]
        on_light = z.valid & (z.em_color.amax(dim=-1) > 1e-6) \
            & (z.light_row >= 0)
        front = dot3(z.ns, z.wo) > 0.0
        lrow = torch.clamp(z.light_row.long(), 0, n_lights - 1)
        pick = scene.lights.pick_cdf[lrow + 1] - scene.lights.pick_cdf[lrow]
        area = torch.clamp(scene.lights.area[lrow], min=1e-12)

        # treat z_{t-1} as the light vertex y_0 of the assembled path
        y0_here = _V(pos=z.pos, ns=z.ns, ng=z.ng, pf=pick / area, pr=z.pr,
                     spec=fzero, hittable=on_light, valid=on_light)
        pf, pl, spec = _assemble(R, zs, [], y0_here, t, 0, {})
        # s=0 specifics: pl[k-1] = light pos pdf; pl[k-2] = emission pdf
        pl[t - 1] = y0_here.pf
        if t >= 3:
            zp = zs[t - 3]
            dv = zp.pos - z.pos
            dist = sqrt(torch.clamp(dot3(dv, dv), min=1e-12))
            wl = dv / dist[:, None]
            pl[t - 2] = _to_area(light_emit_pdf_w(dot3(z.ns, wl)),
                                 z.pos, zp.pos, zp.ng)
        for i in range(1, t - 2):
            pl[i] = zs[i - 1].pr
        # emissive terminal vertex is never a 'scatter' vertex
        spec[t - 1] = fzero
        w = _mis_weight(pf, pl, spec, on_light, t, n_splat,
                        y0_here.hittable, three_way)
        contrib = z.beta * z.em_color * w[:, None]
        out.append(((0, t), own_pix, torch.where((on_light & front)[:, None],
                                                 contrib, 0.0)))

    # ---- s = 0 env: camera path escapes to the sky (cbidir.h:619-625
    # environmentColorExtended in the bidir path, mlt.cl:723). The env
    # endpoint uses DIRECTIONAL measure: pf[k-1] is the raw solid-angle
    # arrival pdf, pl[k-1] the sky sampler's pick * env_pdf_w, pl[k-2] the
    # planar bounding-disk density x |cos| (infinite-light convention).
    if LIGHT_SKY in _light_types(scene):
        cdf_l = scene.lights.pick_cdf
        pick_sky = torch.where(scene.lights.ltype == LIGHT_SKY,
                               cdf_l[1:] - cdf_l[:-1], 0.0).sum()
        _, rad_s = scene_bounding_sphere(scene)
        pdf_a_far = 1.0 / torch.clamp(math.pi * rad_s * rad_s, min=1e-12)
        one = torch.ones((R,), dtype=torch.float32, device=dev)
        all_lanes = torch.ones((R,), dtype=torch.bool, device=dev)
        for t in range(2, NC + 2):
            if not keep(t, 0):
                continue
            z = zs[t - 2]
            w_dir = z.env_dir
            env_c = env_radiance(scene, w_dir)
            env_pdf = env_pdf_for_dir(scene.env_rows_cdf, scene.env_cols_cdf,
                                      scene.env_pdf_uv, w_dir)
            pf = [one] * t
            pl = [one] * t
            spec = [fzero] * t
            for i in range(1, t - 1):
                pf[i] = zs[i - 1].pf
                spec[i] = zs[i - 1].spec
            pf[t - 1] = z.pf_w_arr
            pl[t - 1] = pick_sky * env_pdf
            if t >= 3:
                pl[t - 2] = pdf_a_far * dot3(zs[t - 3].ng, w_dir).abs()
            for i in range(1, t - 2):
                pl[i] = zs[i - 1].pr
            w = _mis_weight(pf, pl, spec, z.is_env, t, n_splat, all_lanes,
                            three_way)
            out.append(((0, t), own_pix,
                        torch.where(z.is_env[:, None],
                                    z.beta * env_c * w[:, None], 0.0)))

    # ---- s = 1: NEE from every camera vertex to y0. Sky lanes connect
    # DIRECTIONALLY (toward y0's sampled env direction, shadow ray to
    # infinity, radiance over the direction density), MIS-consistent with
    # the env s'=0 strategy above.
    env1 = y0.is_env
    for t in range(2, NC + 1):
        if not keep(t, 1):
            continue
        z = zs[t - 2]
        d = y0.pos - z.pos
        d2 = torch.clamp(dot3(d, d), min=1e-12)
        dist = sqrt(d2)
        wl = d / dist[:, None]
        wl = torch.where(env1[:, None], y0.env_dir, wl)
        cos_z = dot3(z.ns, wl)
        cos_y = torch.where(env1, 1.0, dot3(y0.ns, -wl))
        f_z, pdf_z_w = eval_bsdf(z.mat, z.wo, wl, z.ns, feats)
        can = z.valid & ~z.spec & (cos_z > 0) & (cos_y > 1e-6)
        sray_o = offs_ray_pos(z.pos, z.ng, wl)
        occ = any_hit_sorted(scene, sray_o, wl,
                             torch.where(env1, FAR_DIST, dist * 0.995),
                             active=can)
        G = cos_z.abs() * cos_y.abs() / d2
        c_unw = z.beta * f_z * y0.beta * G[:, None]
        c_unw = torch.where(env1[:, None],
                            z.beta * f_z * y0.beta_dir
                            * cos_z.abs()[:, None], c_unw)

        junc = {
            "pf_junc": torch.where(
                env1, pdf_z_w, _to_area(pdf_z_w, z.pos, y0.pos, y0.ng)),
            "pl_junc": torch.where(
                env1, y0.pdf_a_far * dot3(z.ng, wl).abs(),
                _to_area(light_emit_pdf_w(cos_y), y0.pos, z.pos, z.ng)),
        }
        if t >= 3:
            _, pdf_back = eval_bsdf(z.mat, wl, z.wo, z.ns, feats)
            junc["pl_junc2"] = _to_area(pdf_back, z.pos, zs[t - 3].pos,
                                        zs[t - 3].ng)
        pf, pl, spec = _assemble(R, zs, ys, y0, t, 1, junc)
        w = _mis_weight(pf, pl, spec, can, t, n_splat, y0.hittable,
                        three_way)
        out.append(((1, t), own_pix, torch.where((can & ~occ)[:, None],
                                                 c_unw * w[:, None], 0.0)))

    # ---- t = 1: connect light vertices to the camera (LT splat)
    _, d_img = _camera_data(cam)
    cam_pos = torch.broadcast_to(cam.pos, (R, 3))
    for s in range(2, NL + 2):
        if not keep(1, s):
            continue
        y = ys[s - 2]
        flat, on, w_cam, dist, cos_cam = project_to_screen(cam, y.pos)
        f_y, _ = eval_bsdf(y.mat, y.wo, w_cam, y.ns, feats)
        cos_x = dot3(w_cam, y.ns).abs()
        img_factor = (d_img / cos_cam) ** 2 / cos_cam
        factor = img_factor * cos_x / torch.clamp(dist * dist, min=1e-12)
        can = y.valid & ~y.spec & on & (cos_x > 0)
        sray_o = offs_ray_pos(y.pos, y.ng, w_cam)
        occ = any_hit_sorted(scene, sray_o, w_cam, dist * 0.995, active=can)
        c_unw = y.beta * f_y * (factor / n_splat)[:, None]

        junc = {
            "pf_junc": _to_area(cam_pdf_w(cam, -w_cam), cam_pos, y.pos, y.ng),
        }
        _, pdf_down = eval_bsdf(y.mat, w_cam, y.wo, y.ns, feats)
        nxt = ys[s - 3] if s >= 3 else y0
        junc["pf_junc2"] = _to_area(pdf_down, y.pos, nxt.pos, nxt.ng)
        if s == 2:  # env y0: directional measure, raw solid-angle pdf
            junc["pf_junc2"] = torch.where(env1, pdf_down, junc["pf_junc2"])
        pf, pl, spec = _assemble(R, zs, ys, y0, 1, s, junc)
        w = _mis_weight(pf, pl, spec, can, 1, n_splat, y0.hittable,
                        three_way)
        amt = torch.where((can & ~occ)[:, None], c_unw * w[:, None], 0.0)
        out.append(((s, 1), flat, amt))

    # ---- s >= 2, t >= 2: inner connections (full SBDPT only)
    if not three_way:
        for t in range(2, NC + 1):
            for s in range(2, NL + 2):
                if (s + t - 1) > max_depth or not keep(t, s):
                    continue
                z = zs[t - 2]
                y = ys[s - 2]
                d = y.pos - z.pos
                d2 = torch.clamp(dot3(d, d), min=1e-12)
                dist = sqrt(d2)
                wl = d / dist[:, None]
                f_z, pdf_z_w = eval_bsdf(z.mat, z.wo, wl, z.ns, feats)
                f_y, pdf_y_w = eval_bsdf(y.mat, y.wo, -wl, y.ns, feats)
                cos_z = dot3(z.ns, wl)
                cos_y = dot3(y.ns, -wl)
                can = (z.valid & y.valid & ~z.spec & ~y.spec
                       & (cos_z > 0) & (cos_y > 0))
                sray_o = offs_ray_pos(z.pos, z.ng, wl)
                occ = any_hit_sorted(scene, sray_o, wl, dist * 0.995,
                                     active=can)
                G = cos_z.abs() * cos_y.abs() / d2
                c_unw = z.beta * f_z * f_y * y.beta * G[:, None]

                junc = {
                    "pf_junc": _to_area(pdf_z_w, z.pos, y.pos, y.ng),
                    "pl_junc": _to_area(pdf_y_w, y.pos, z.pos, z.ng),
                }
                # wo at y is the OUTGOING connection direction -wl
                _, pdf_y_down = eval_bsdf(y.mat, -wl, y.wo, y.ns, feats)
                nxt = ys[s - 3] if s >= 3 else y0
                junc["pf_junc2"] = _to_area(pdf_y_down, y.pos, nxt.pos,
                                            nxt.ng)
                if s == 2:  # env y0: directional measure
                    junc["pf_junc2"] = torch.where(env1, pdf_y_down,
                                                   junc["pf_junc2"])
                if t >= 3:
                    _, pdf_z_back = eval_bsdf(z.mat, wl, z.wo, z.ns, feats)
                    junc["pl_junc2"] = _to_area(pdf_z_back, z.pos,
                                                zs[t - 3].pos, zs[t - 3].ng)
                pf, pl, spec = _assemble(R, zs, ys, y0, t, s, junc)
                w = _mis_weight(pf, pl, spec, can, t, n_splat, y0.hittable,
                                False)
                out.append(((s, t), own_pix,
                            torch.where((can & ~occ)[:, None],
                                        c_unw * w[:, None], 0.0)))

    if lane_k is not None:
        # each lane belongs to one depth group: zero every other depth's
        # strategies (its own subpaths are truncated at lane_k anyway)
        out = [(lbl, flat,
                torch.where((lane_k == (lbl[0] + lbl[1]))[:, None], amt, 0.0))
               for lbl, flat, amt in out]
    if with_labels:
        return out
    return [(flat, amt) for _lbl, flat, amt in out]


# lanes of one wavefront: a frame of fewer pixels takes several passes in
# one wavefront (each pass splats into its own image, clamped on its own)
WAVEFRONT_LANES = 1 << 20


def _eye_wavefront(scene, passes, seed: int):
    """Camera rays of the passes `passes` over every pixel in Morton order,
    pass-major, and their streams: (ray_o, ray_d, rand_fn, pix (P*R,)
    int64 pixel ids, lane_pass (P*R,) int64 index of the lane's pass in
    `passes`). Every lane is keyed as the JAX package keys one pass's:
    sample_idx = pix * 0x9E3779B9 ^ pass * 0x85EBCA6B."""
    spans.phase("bdpt.eye", within="bdpt.pass")
    cam = scene.camera
    W, H = cam.width, cam.height
    dev = scene.tri_attr.device
    R = W * H
    one = torch.as_tensor(_morton_pixel_order(W, H).astype("int64"),
                          device=dev)
    pix = one.repeat(len(passes))
    lane_pass = torch.arange(len(passes), device=dev).repeat_interleave(R)
    samp = torch.as_tensor([p & rng.M32 for p in passes], dtype=torch.int64,
                           device=dev).repeat_interleave(R)
    sample_idx = rng.mul32(pix, 0x9E3779B9) ^ rng.mul32(samp, 0x85EBCA6B)

    def rand_fn(depth, group):
        return rng.rand4(sample_idx, depth, group, seed)

    jitter = rng.screen_sample(samp, pix)
    lens = rng.rand2(sample_idx, 0, DG_BD_LENS, seed)
    ray_o, ray_d = make_eye_rays(cam, pix % W, pix // W, jitter, lens)
    return ray_o, ray_d, rand_fn, pix, lane_pass


def _splats(scene, passes, seed: int, max_depth: int, strategies: str):
    """_bdpt_core(with_labels=True) over the passes `passes` in one
    wavefront: its ((s, t), pixel, color) contributions and each lane's
    pass (an index into `passes`)."""
    R = scene.camera.width * scene.camera.height
    ray_o, ray_d, rand_fn, pix, lane_pass = _eye_wavefront(scene, passes,
                                                           seed)
    return _bdpt_core(scene, ray_o, ray_d, rand_fn, pix, float(R), max_depth,
                      strategies, with_labels=True), lane_pass


def _passes_image(scene, passes, seed: int, max_depth: int,
                  strategies: str) -> torch.Tensor:
    """The sum of the (H, W, 3) images of the passes `passes`, each pass
    splatted and clamped to [0, 1e6] on its own, as bdpt_pass_impl's. The
    span `bdpt.pass` (utils/spans.py), with the phases bdpt.eye, bdpt.camera
    and bdpt.light (one a depth), bdpt.connect (the strategies, their
    shadow and camera tests) and bdpt.splat."""
    with spans.span("bdpt.pass", strategies=strategies):
        W, H = scene.camera.width, scene.camera.height
        R = W * H
        img = torch.zeros((len(passes) * R, 3), dtype=torch.float32,
                          device=scene.tri_attr.device)
        out, lane_pass = _splats(scene, passes, seed, max_depth, strategies)
        spans.phase("bdpt.splat", within="bdpt.pass")
        for _, flat, amt in out:  # each pass into its own image
            img.index_add_(0, lane_pass * R + flat, amt)
        img = torch.clamp(img, 0.0, 1e6).reshape(len(passes), H, W, 3)
        return img.sum(dim=0) if len(passes) > 1 else img[0]


def bdpt_pass_impl(scene, pass_idx: int, seed: int, max_depth: int = 5,
                   strategies: str = "full") -> torch.Tensor:
    """One SBDPT sample per pixel -> (H, W, 3) image of this pass, on the
    scene's device.

    strategies: "full" (all s-t connections) or "3way" (the reference's
    IBPT subset: implicit s'=0, NEE s'=1, connect-to-eye t'=1, MIS-combined
    — RenderDriverRTE.cpp:1819-1855 + material.cl:64)."""
    return _passes_image(scene, [pass_idx], seed, max_depth, strategies)


def _pass_groups(scene, passes):
    """`passes` in groups of at most WAVEFRONT_LANES lanes (one pass a
    group at 1024^2 and above)."""
    per = max(1, WAVEFRONT_LANES // (scene.camera.width
                                     * scene.camera.height))
    passes = list(passes)
    return [passes[i:i + per] for i in range(0, len(passes), per)]


def strategy_images(scene, passes, seed: int, max_depth: int = 5,
                    strategies: str = "full", device=None) -> dict:
    """_bdpt_core(with_labels=True) splatted strategy by strategy and
    averaged over the passes `passes` (an int: one pass): {(s, t): (H, W, 3)
    image} on `device` ("cuda" unless asked), unclamped. The per-strategy
    oracle checks and the card-against-CPU checks read these."""
    dev = resolve_device(device)
    check_supported(scene)
    scene = scene.to(dev)
    passes = [passes] if isinstance(passes, int) else list(passes)
    W, H = scene.camera.width, scene.camera.height
    R = W * H
    out = {}
    for group in _pass_groups(scene, passes):
        for lbl, flat, amt in _splats(scene, group, seed, max_depth,
                                      strategies)[0]:
            if lbl not in out:
                out[lbl] = torch.zeros((R, 3), dtype=torch.float32,
                                       device=dev)
            out[lbl].index_add_(0, flat, amt)
    return {lbl: (img / len(passes)).reshape(H, W, 3)
            for lbl, img in out.items()}


def bdpt_pass(scene, pass_idx: int, seed: int, max_depth: int = 5,
              strategies: str = "full", device=None) -> torch.Tensor:
    """bdpt_pass_impl on `device` ("cuda" unless asked)."""
    dev = resolve_device(device)
    check_supported(scene)
    return bdpt_pass_impl(scene.to(dev), pass_idx, seed, max_depth,
                          strategies)


def render_bdpt(scene, n_passes: int, seed: int = 777,
                max_depth: int | None = None, strategies: str = "full",
                device=None) -> torch.Tensor:
    """Accumulate SBDPT passes -> (H, W, 3), a tensor on `device` ("cuda"
    unless asked). A frame of fewer than WAVEFRONT_LANES pixels traces
    several passes in one wavefront; each pass is splatted and clamped on
    its own, so the image is the mean of bdpt_pass's."""
    dev = resolve_device(device)
    check_supported(scene)
    md = max_depth or scene.settings.trace_depth
    H, W = scene.camera.height, scene.camera.width
    scene = scene.to(dev)
    fb = torch.zeros((H, W, 3), dtype=torch.float32, device=dev)
    for group in _pass_groups(scene, range(n_passes)):
        fb = fb + _passes_image(scene, group, seed, md, strategies)
    return fb / n_passes


def render_ibpt(scene, n_passes: int, seed: int = 777,
                max_depth: int | None = None, device=None) -> torch.Tensor:
    """IBPT 'instant bidirectional' (reference 3-way MIS): PT + LT with
    accumulated-pdf weights (material.cl:64 UpdateForwardPdfFor3Way,
    cglobals.h:2490 PerRayAcc, RenderDriverRTE.cpp:1819-1855) — here the
    SBDPT machinery restricted to that strategy subset."""
    return render_bdpt(scene, n_passes, seed, max_depth, strategies="3way",
                       device=device)
