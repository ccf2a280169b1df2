"""Plain IBPT over a Flat description: the renderer's 3-way bidirectional
estimator (implicit hits s = 0, next-event estimation s = 1, light-path
vertices connected to the camera t = 1; its sources
RenderDriverRTE.cpp:1819-1855, material.cl:64 UpdateForwardPdfFor3Way,
cglobals.h:2490 PerRayAcc), as the renderer documents it for one pass.

One pass traces a camera subpath and a light subpath a lane, one lane a
pixel in Morton order, keyed pix * 0x9E3779B9 ^ pass * 0x85EBCA6B; the
camera subpath has `depth` surface vertices z_1.., the light subpath a
point y_0 on the rect light and depth - 1 surface vertices y_1... Each
vertex keeps its area pdf from its own side (pf) and from one step deeper
(pr); a strategy's MIS weight is the power heuristic over the assembled
path's strategies {1, k - 1, k} (t' camera vertices, k the path's
vertices; at k = 2 only the implicit hit), walked as pdf ratios in the
renderer's order, with the t' = 1 density scaled by the pass's light-path
count. Every t = 1 splat lands in the pixel its vertex projects to; the
pass's image is clamped to [0, 1e6] on its own.

Departures from the renderer's documented semantics, none of which the
configurations meet: one rect light only (no sky, no other light types),
the reference's materials only (Lambert, GGX, smooth glass; no textures,
bump, blends or Fresnel), no thin lens. Shading, sampling and the RNG are
render.py's and rng.py's; the casts go through grouped.GroupedCaster.
"""
from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import torch

from h100_bench.reference import render as R
from h100_bench.reference import rng
from h100_bench.reference.grouped import GroupedCaster
from h100_bench.reference.render import dot3, offset

DG_BD_CAM_BSDF, DG_BD_LGT_EMIT, DG_BD_LGT_BSDF = 8, 9, 10
CLAMP = 1e6


class Scene(R.Scene):
    """render.Scene with the grouped caster in place of the run-by-run one
    (the description's other tables as render.Scene keeps them); its
    matmuls run in full float32 (TF32 off)."""

    def __init__(self, flat, device, dtype=torch.float32):
        torch.backends.cuda.matmul.allow_tf32 = False
        super().__init__(flat, device, dtype)
        self.cast = GroupedCaster(flat, device, dtype)
        self.view = torch.linalg.inv(self.view_inv.float()).to(dtype)


def morton_order(W: int, H: int) -> np.ndarray:
    """Flat pixel ids in Morton (z-curve) order."""
    ys, xs = np.mgrid[0:H, 0:W]
    xs = xs.reshape(-1).astype(np.uint64)
    ys = ys.reshape(-1).astype(np.uint64)
    key = np.zeros(W * H, np.uint64)
    for b in range(16):
        key |= ((xs >> b) & 1) << (2 * b)
        key |= ((ys >> b) & 1) << (2 * b + 1)
    order = np.argsort(key)
    return (ys[order] * W + xs[order]).astype(np.int64)


def to_area(pdf_w, src, dst, dst_ng):
    """Solid-angle pdf at src -> area pdf at dst."""
    d = dst - src
    d2 = torch.clamp(dot3(d, d), min=1e-12)
    w = d * torch.rsqrt(d2)[:, None]
    return pdf_w * dot3(w, dst_ng).abs() / d2


def emit_pdf_w(cos):
    """Cosine-weighted emission of the rect light, solid angle."""
    return torch.clamp(cos, min=0.0) * R.INV_PI


def cam_pdf_w(S: Scene, w):
    """Per-pixel-measure solid-angle pdf of the camera emitting w."""
    wv = w @ S.view[:3, :3].T
    cos_c = torch.clamp(-wv[:, 2], min=1e-6)
    d_img = S.H / (2.0 * S.proj_inv[1, 1])
    return d_img * d_img / (cos_c ** 3)


def project(S: Scene, pos):
    """(flat pixel, on screen, unit direction to the camera, distance,
    cosine at the camera) of world points."""
    W, H = S.W, S.H
    tan_half = S.proj_inv[1, 1]
    pv = pos @ S.view[:3, :3].T + S.view[:3, 3]
    z = -pv[:, 2]
    sx = pv[:, 0] / torch.clamp(z, min=1e-6) / (tan_half * W / H)
    sy = pv[:, 1] / torch.clamp(z, min=1e-6) / tan_half
    fx = torch.floor((sx + 1.0) * 0.5 * W)
    fy = torch.floor((1.0 - sy) * 0.5 * H)
    on = (z > 1e-4) & (fx >= 0) & (fx < W) & (fy >= 0) & (fy < H)
    to_cam = S.cam_pos - pos
    dist = torch.sqrt(torch.clamp(dot3(to_cam, to_cam), min=1e-12))
    w_cam = to_cam / dist[:, None]
    cos_cam = torch.clamp(z / dist, min=1e-6)
    px = torch.where(on, fx, 0.0).to(torch.int64)
    py = torch.where(on, fy, 0.0).to(torch.int64)
    return py * W + px, on, w_cam, dist, cos_cam


def _vertex(S, o, d, alive, prev_pos, pdf_w_prev, beta):
    """The closest hit of (o, d) as a subpath vertex, its normals facing
    the incoming ray."""
    t, tri, u, v = S.cast.closest(o, d, alive)
    hit = alive & (tri >= 0)
    pos, n, ng, p, light = S.hit(tri, u, v, o, d, t)
    n = torch.where(dot3(n, -d)[:, None] >= 0.0, n, -n)
    ng = torch.where(dot3(ng, -d)[:, None] >= 0.0, ng, -ng)
    zero = torch.zeros_like(t)
    return SimpleNamespace(pos=pos, ns=n, ng=ng, wo=-d, beta=beta,
                           pf=to_area(pdf_w_prev, prev_pos, pos, ng), pr=zero,
                           valid=hit, spec=torch.zeros_like(hit), mat=p,
                           light=light)


def _scatter(S, x, r4):
    """Samples x's BSDF: (next o, next d, weight, forward pdf, the reverse
    solid-angle pdf back along the incoming ray)."""
    wi, weight, pdf, spec, trans = S.sample_bsdf(x.mat, x.wo, x.ns, r4)
    x.spec = spec
    _, back = S.eval_bsdf(x.mat, wi, x.wo, x.ns)
    back = torch.where(spec, 0.0, back)
    o = offset(x.pos, torch.where(trans[:, None], -x.ng, x.ng), wi)
    return o, wi, weight, torch.where(spec, 0.0, pdf), back


def camera_subpath(S, o, d, rand, n_surf):
    R_ = o.shape[0]
    beta = torch.ones((R_, 3), dtype=S.dtype, device=S.device)
    alive = torch.ones((R_,), dtype=torch.bool, device=S.device)
    prev, pdf_w = torch.broadcast_to(S.cam_pos, o.shape), cam_pdf_w(S, d)
    zs = []
    for i in range(n_surf):
        z = _vertex(S, o, d, alive, prev, pdf_w, beta)
        zs.append(z)
        if i == n_surf - 1:
            break
        o, d, weight, pdf_w, back = _scatter(S, z, rand(i, DG_BD_CAM_BSDF))
        beta = beta * weight
        alive = z.valid & (beta.amax(dim=-1) > 1e-7)
        if i >= 1:
            zs[i - 1].pr = to_area(back, z.pos, zs[i - 1].pos, zs[i - 1].ng)
        prev = z.pos
    return zs


def light_subpath(S, rand, n_surf):
    L = S.l
    r = rand(0, DG_BD_LGT_EMIT)
    pos = L.pos + (2 * r[:, 0] - 1)[:, None] * L.vx \
        + (2 * r[:, 1] - 1)[:, None] * L.vy
    nl = torch.broadcast_to(L.norm, pos.shape)
    t, b = R.basis(nl)
    ct = torch.sqrt(torch.clamp(r[:, 2], 0.0, 1.0))
    st = torch.sqrt(torch.clamp(1 - r[:, 2], 0.0, 1.0))
    ph = 2 * R.PI * r[:, 3]
    d = (st * torch.cos(ph))[:, None] * t + (st * torch.sin(ph))[:, None] * b \
        + ct[:, None] * nl
    cos_l = torch.clamp(ct, min=1e-6)
    pdf_a = 1.0 / torch.full_like(ct, L.area)
    pdf_w = cos_l * (1.0 / R.PI)
    pick = L.pick
    y0 = SimpleNamespace(
        pos=pos, ns=nl, ng=nl, pf=pdf_a * pick, pr=torch.zeros_like(ct),
        spec=torch.zeros_like(ct, dtype=torch.bool),
        beta=L.intensity / torch.clamp(pdf_a * pick, min=1e-12)[:, None])
    beta = y0.beta * (cos_l / torch.clamp(pdf_w, min=1e-12))[:, None]
    alive = torch.ones_like(ct, dtype=torch.bool)
    o, prev = offset(pos, nl, d), pos
    ys = []
    for j in range(n_surf):
        y = _vertex(S, o, d, alive, prev, pdf_w, beta)
        ys.append(y)
        if j == n_surf - 1:
            break
        o, d, weight, pdf_w, back = _scatter(S, y, rand(j + 1,
                                                         DG_BD_LGT_BSDF))
        beta = beta * weight
        alive = y.valid & (beta.amax(dim=-1) > 1e-7)
        back_at = ys[j - 1] if j >= 1 else y0
        back_at.pr = to_area(back, y.pos, back_at.pos, back_at.ng)
        prev = y.pos
    return y0, ys


def mis_weight(pf, pl, spec, can, t_strat, n_splat, y0_hittable):
    """Power heuristic over the strategies {1, k - 1, k} of the assembled
    path (k = 2: k alone), pdf ratios walked down then up from the sampled
    strategy t_strat; the t' = 1 density scaled by n_splat."""
    k = len(pf)
    allowed = {1, k - 1, k}
    if k == 2:
        allowed.discard(1)

    def ok_for(tp):
        if tp == k:
            return y0_hittable & ~spec[k - 1]
        return (~spec[tp - 1] & ~spec[tp]) if tp >= 2 else ~spec[tp]

    def term(tp, r):
        x = torch.where(ok_for(tp) & can, r, 0.0)
        if tp == 1:
            x = x * n_splat
        return x * x

    def remap(x):
        return torch.where(x > 0.0, x, 1.0)

    total = term(t_strat, torch.ones_like(pf[0])) if t_strat in allowed \
        else torch.zeros_like(pf[0])
    r = torch.ones_like(pf[0])
    for tp in range(t_strat - 1, 0, -1):
        r = r * remap(pl[tp]) / remap(pf[tp])
        if tp in allowed:
            total = total + term(tp, r)
    r = torch.ones_like(pf[0])
    for tp in range(t_strat + 1, k + 1):
        r = r * remap(pf[tp - 1]) / remap(pl[tp - 1])
        if tp in allowed:
            total = total + term(tp, r)
    num_f = n_splat if t_strat == 1 else 1.0
    num = torch.where(ok_for(t_strat) & can, float(num_f) ** 2,
                      0.0).to(pf[0].dtype)
    return torch.where(total > 0, num / torch.clamp(total, min=1e-30), 0.0)


def _path(zs, t, tail):
    """The assembled path's vertices x_1..x_{k-1}: z_1..z_{t-1}, then the
    light side `tail` (y_{s-1} .. y_0)."""
    return [None] + [zs[i - 1] for i in range(1, t)] + tail


def implicit(S, zs, t, n_splat):
    """s = 0: the camera subpath's vertex z_{t-1} lies on the light."""
    z = zs[t - 2]
    on = z.valid & (z.mat.em_color.amax(dim=-1) > 1e-6) & (z.light >= 0)
    front = dot3(z.ns, z.wo) > 0.0
    xs = _path(zs, t, [])
    one = torch.ones_like(z.pf)
    pf = [one] + [xs[i].pf for i in range(1, t)]
    pl = [one] * t
    for i in range(1, t - 2):
        pl[i] = zs[i - 1].pr
    pl[t - 1] = S.l.pick / torch.clamp(torch.full_like(one, S.l.area),
                                       min=1e-12)
    if t >= 3:
        zp = zs[t - 3]
        dv = zp.pos - z.pos
        wl = dv / torch.sqrt(torch.clamp(dot3(dv, dv), min=1e-12))[:, None]
        pl[t - 2] = to_area(emit_pdf_w(dot3(z.ns, wl)), z.pos, zp.pos, zp.ng)
    spec = [torch.zeros_like(on)] + [xs[i].spec for i in range(1, t)]
    spec[t - 1] = torch.zeros_like(on)
    w = mis_weight(pf, pl, spec, on, t, n_splat, on)
    return torch.where((on & front)[:, None],
                       z.beta * z.mat.em_color * w[:, None], 0.0)


def nee(S, zs, y0, t, n_splat):
    """s = 1: z_{t-1} connected to the light point y_0."""
    z = zs[t - 2]
    dv = y0.pos - z.pos
    d2 = torch.clamp(dot3(dv, dv), min=1e-12)
    dist = torch.sqrt(d2)
    wl = dv / dist[:, None]
    cos_z = dot3(z.ns, wl)
    cos_y = dot3(y0.ns, -wl)
    f_z, pdf_z = S.eval_bsdf(z.mat, z.wo, wl, z.ns)
    can = z.valid & ~z.spec & (cos_z > 0) & (cos_y > 1e-6)
    occ = S.cast.occluded(offset(z.pos, z.ng, wl), wl, dist * 0.995, can)
    G = cos_z.abs() * cos_y.abs() / d2
    c = z.beta * f_z * y0.beta * G[:, None]
    xs = _path(zs, t, [y0])
    k = t + 1
    one = torch.ones_like(G)
    pf = [one] * k
    for i in range(1, t):
        pf[i] = zs[i - 1].pf
    pf[t] = to_area(pdf_z, z.pos, y0.pos, y0.ng)
    pl = [one] * k
    pl[k - 1] = y0.pf
    pl[t - 1] = to_area(emit_pdf_w(cos_y), y0.pos, z.pos, z.ng)
    if t >= 3:
        _, back = S.eval_bsdf(z.mat, wl, z.wo, z.ns)
        pl[t - 2] = to_area(back, z.pos, zs[t - 3].pos, zs[t - 3].ng)
    for i in range(1, t - 2):
        pl[i] = zs[i - 1].pr
    spec = [torch.zeros_like(can)] + [xs[i].spec for i in range(1, k)]
    w = mis_weight(pf, pl, spec, can, t, n_splat,
                   torch.ones_like(can))
    return torch.where((can & ~occ)[:, None], c * w[:, None], 0.0)


def to_camera(S, ys, y0, s, n_splat):
    """t = 1: the light subpath's vertex y_{s-1} connected to the camera;
    (pixel, colour) of the splat."""
    y = ys[s - 2]
    pix, on, w_cam, dist, cos_cam = project(S, y.pos)
    f_y, _ = S.eval_bsdf(y.mat, y.wo, w_cam, y.ns)
    cos_x = dot3(w_cam, y.ns).abs()
    d_img = S.H / (2.0 * S.proj_inv[1, 1])
    factor = (d_img / cos_cam) ** 2 / cos_cam * cos_x \
        / torch.clamp(dist * dist, min=1e-12)
    can = y.valid & ~y.spec & on & (cos_x > 0)
    occ = S.cast.occluded(offset(y.pos, y.ng, w_cam), w_cam, dist * 0.995,
                          can)
    c = y.beta * f_y * (factor / n_splat)[:, None]
    tail = [ys[s - m - 1] if s - m >= 1 else y0 for m in range(1, s + 1)]
    xs = _path([], 1, tail)
    k = s + 1
    one = torch.ones_like(dist)
    cam = torch.broadcast_to(S.cam_pos, y.pos.shape)
    pf = [one] * k
    pf[1] = to_area(cam_pdf_w(S, -w_cam), cam, y.pos, y.ng)
    _, down = S.eval_bsdf(y.mat, w_cam, y.wo, y.ns)
    nxt = ys[s - 3] if s >= 3 else y0
    pf[2] = to_area(down, y.pos, nxt.pos, nxt.ng)
    for i in range(3, k):
        pf[i] = xs[i].pr
    pl = [one] * k
    pl[k - 1] = y0.pf
    for m in range(1, s):
        pl[m] = xs[m].pf
    spec = [torch.zeros_like(can)] + [xs[i].spec for i in range(1, k)]
    w = mis_weight(pf, pl, spec, can, 1, n_splat, torch.ones_like(can))
    return pix, torch.where((can & ~occ)[:, None], c * w[:, None], 0.0)


def ibpt_pass(S: Scene, pass_idx: int, seed: int, depth: int | None = None):
    """One IBPT pass, one lane a pixel: the (H, W, 3) image, clamped to
    [0, 1e6]."""
    depth = depth or S.depth
    W, H, dev = S.W, S.H, S.device
    pix = torch.as_tensor(morton_order(W, H), device=dev)
    samp = torch.full_like(pix, pass_idx & rng.M32)
    key = rng.mul32(pix, 0x9E3779B9) ^ rng.mul32(samp, 0x85EBCA6B)

    def rand(d, group):
        return rng.rand4(key, d, group, seed, S.dtype)

    o, d, _ = S.eye_rays(pix, samp, seed)
    n_splat = float(W * H)
    zs = camera_subpath(S, o, d, rand, depth)
    y0, ys = light_subpath(S, rand, depth - 1)
    img = torch.zeros((W * H, 3), dtype=S.dtype, device=dev)
    for t in range(2, depth + 2):
        img.index_add_(0, pix, implicit(S, zs, t, n_splat))
    for t in range(2, depth + 1):
        img.index_add_(0, pix, nee(S, zs, y0, t, n_splat))
    for s in range(2, depth + 1):
        img.index_add_(0, *to_camera(S, ys, y0, s, n_splat))
    return torch.clamp(img, 0.0, CLAMP).reshape(H, W, 3)
