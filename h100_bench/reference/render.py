"""Plain path tracing (PT) and light tracing (LT) over a Flat description.

The integrands are the renderer's documented ones for the materials and
lights the configurations use (Lambert, isotropic GGX with the
Kulla-Conty term, smooth dielectric glass; rect area lights; a pinhole
camera): MIS + NEE path tracing with Russian roulette from depth 3, and
light tracing that connects every light-path vertex to the camera. Every
uniform comes from reference/rng.py on the renderer's keys (pixel, sample,
pass, depth, dimension group), so both trace the same paths.
"""
from __future__ import annotations

import math
from types import SimpleNamespace

import numpy as np
import torch

from h100_bench.reference import rng
from h100_bench.reference.energy import ggx_tables
from h100_bench.reference.trace import Caster, cross3
from h100_bench.scenes.common import REFL_GGX, camera_matrices

PI = math.pi
INV_PI = float(1.0 / math.pi)
EPS_PDF = 1e-20
REFL_MIRROR = 4
DG_LENS, DG_BSDF, DG_LIGHT, DG_RR = 0, 1, 2, 3
DG_LT_EMIT, DG_LT_BSDF = 5, 6


def dot3(a, b):
    return (a * b).sum(dim=-1)


def normalize3(a):
    return a / torch.sqrt(torch.clamp(dot3(a, a), min=1e-20))[..., None]


def reflect3(d, n):
    return d - 2.0 * dot3(d, n)[..., None] * n


def basis(n):
    nx, ny, nz = n[..., 0], n[..., 1], n[..., 2]
    sign = torch.where(nz >= 0.0, 1.0, -1.0).to(n.dtype)
    a = -1.0 / (sign + nz)
    b = nx * ny * a
    return (torch.stack([1.0 + sign * nx * nx * a, sign * b, -sign * nx], -1),
            torch.stack([b, sign + ny * ny * a, -ny], -1))


def offset(pos, n, direction, eps: float = 1e-4):
    scale = torch.clamp(pos.abs().amax(dim=-1), min=1.0)
    signed = torch.where(dot3(direction, n) >= 0.0, 1.0, -1.0).to(pos.dtype)
    return pos + (eps * scale * signed)[..., None] * n


def mis(a, b):
    a2 = a * a
    den = a2 + b * b
    return torch.where(den > 0.0, a2 / den, 0.0)


def luminance(c):
    return 0.2126 * c[..., 0] + 0.7152 * c[..., 1] + 0.0722 * c[..., 2]


class Scene:
    """The description on `device` in `dtype`: the caster, per-triangle
    normals and ids, material columns, the one rect light, the camera."""

    def __init__(self, flat, device, dtype=torch.float32):
        r = flat.recipe
        if len(r.lights) != 1:
            raise ValueError("the reference renders scenes of one rect light")

        def put(a):
            return torch.as_tensor(np.asarray(a), device=device).to(dtype)

        self.device, self.dtype = device, dtype
        self.cast = Caster(flat, device, dtype)
        self.n0, self.n1, self.n2 = put(flat.n0), put(flat.n1), put(flat.n2)
        self.mat = torch.as_tensor(flat.mat, device=device)
        self.light = torch.as_tensor(flat.light, device=device)
        ms = r.materials
        col = {k: put(np.stack([np.asarray(m[k], np.float32) for m in ms]))
               for k in ("em_color", "diff_color", "refl_color", "refl_alpha",
                         "transp_color", "transp_ior")}
        col["refl_dist"] = torch.as_tensor([int(m["refl_dist"]) for m in ms],
                                           device=device)
        self.m = SimpleNamespace(**col)
        lt = r.lights[0]
        self.l = SimpleNamespace(**{k: put(lt[k]) for k in
                                    ("pos", "norm", "vx", "vy", "intensity")})
        self.l.area = max(float(lt["area"]), 1e-12)
        self.l.pick = 1.0
        E, e_avg = ggx_tables()
        self.E, self.E_avg = put(E), put(e_avg)
        self.W, self.H, self.depth = r.width, r.height, r.depth
        view_inv, proj_inv = camera_matrices(r)
        self.view_inv, self.proj_inv = put(view_inv), put(proj_inv)
        self.cam_pos = put(np.asarray(r.camera["pos"], np.float32))

    # ---- hits and materials
    def hit(self, tri, u, v, o, d, t):
        k = torch.clamp(tri, min=0)
        w = 1.0 - u - v
        pos = o + t[:, None] * d
        n = w[:, None] * self.n0[k] + u[:, None] * self.n1[k] \
            + v[:, None] * self.n2[k]
        ng = cross3(self.cast.e1[k], self.cast.e2[k])
        n = normalize3(n)
        ng = normalize3(ng)
        ng = torch.where(dot3(ng, n)[:, None] < 0.0, -ng, ng)
        mat = self.mat[k]
        p = SimpleNamespace(**{f: getattr(self.m, f)[mat]
                               for f in vars(self.m)})
        return pos, n, ng, p, self.light[k]

    def _table_index(self, x):
        n = self.E.shape[0]
        return torch.clamp((x * n - 0.5).to(torch.int64), 0, n - 1)

    # ---- BSDF
    @staticmethod
    def weights(p):
        kd = luminance(p.diff_color)
        ks = luminance(p.refl_color)
        kt = luminance(p.transp_color)
        total = kd + ks + kt
        safe = torch.clamp(total, min=EPS_PDF)
        return kd / safe, ks / safe, kt / safe, total

    def eval_bsdf(self, p, wo, wi, n):
        """(f, mixture pdf) of the non-delta lobes: Lambert and GGX."""
        facing = dot3(n, wo) >= 0.0
        ns = torch.where(facing[:, None], n, -n)
        cos_o = torch.clamp(dot3(ns, wo), min=0.0)
        cos_i = dot3(ns, wi)
        kd, ks, kt, total = self.weights(p)
        refl = cos_i > 0.0
        ci = torch.clamp(cos_i, min=0.0)
        f_d = torch.where(refl[:, None], p.diff_color * INV_PI, 0.0)
        pdf_d = torch.where(refl, ci * INV_PI, 0.0)
        # GGX (Smith separable G) with the Kulla-Conty term
        a = p.refl_alpha
        a2 = a * a
        h = normalize3(wo + wi)
        cos_h = torch.clamp(dot3(ns, h), min=0.0)
        cos_oh = torch.clamp(dot3(wo, h), min=1e-6)
        dd = cos_h * cos_h * (a2 - 1.0) + 1.0
        D = a2 / torch.clamp(PI * dd * dd, min=1e-12)

        def g1(c):
            return 2.0 * c / torch.clamp(c + torch.sqrt(a2 + (1.0 - a2) * c * c),
                                         min=1e-12)

        f_g = D * (g1(cos_o) * g1(ci)) / torch.clamp(4.0 * cos_o * ci, min=1e-6)
        ia = self._table_index(a)
        E_o = self.E[ia, self._table_index(cos_o)]
        E_i = self.E[ia, self._table_index(torch.clamp(ci, min=1e-3))]
        f_ms = (1.0 - E_o) * (1.0 - E_i) / torch.clamp(
            PI * (1.0 - self.E_avg[ia]), min=1e-3)
        f_g = f_g + torch.where(a > 0.05, f_ms, 0.0)
        pdf_g = D * cos_h / (4.0 * cos_oh)
        ok = refl & (cos_o > 0.0) & (p.refl_dist == REFL_GGX)
        f_s = torch.where(ok[:, None], f_g[:, None] * p.refl_color, 0.0)
        pdf_s = torch.where(ok, pdf_g, 0.0)
        alive = total > EPS_PDF
        f = torch.where(alive[:, None], f_d + f_s, 0.0)
        pdf = torch.where(alive, kd * pdf_d + ks * pdf_s, 0.0)
        return f, pdf

    @staticmethod
    def fresnel(cos_i, eta):
        cos_i = torch.clamp(cos_i, 0.0, 1.0)
        sin2_t = torch.clamp(1.0 - cos_i * cos_i, min=0.0) / torch.clamp(
            eta * eta, min=1e-12)
        cos_t = torch.sqrt(torch.clamp(1.0 - sin2_t, min=0.0))
        r_par = (eta * cos_i - cos_t) / torch.clamp(eta * cos_i + cos_t,
                                                    min=1e-12)
        r_perp = (cos_i - eta * cos_t) / torch.clamp(cos_i + eta * cos_t,
                                                     min=1e-12)
        f = 0.5 * (r_par * r_par + r_perp * r_perp)
        return torch.where(sin2_t >= 1.0, 1.0, torch.clamp(f, 0.0, 1.0))

    def sample_bsdf(self, p, wo, n, r):
        """One lobe picked by luminance: (wi, weight, pdf, specular,
        transmission)."""
        facing = dot3(n, wo) >= 0.0
        ns = torch.where(facing[:, None], n, -n)
        kd, ks, kt, total = self.weights(p)
        alive = total > EPS_PDF
        u = r[:, 0]
        pick_d = u < kd
        pick_s = ~pick_d & (u < kd + ks)
        pick_t = ~pick_d & ~pick_s & (u < kd + ks + kt) & alive
        pick_l = ~pick_d & ~pick_s & ~pick_t & alive
        u1, u2, u3 = r[:, 1], r[:, 2], r[:, 3]
        t, b = basis(ns)
        ct = torch.sqrt(torch.clamp(u1, 0.0, 1.0))
        st = torch.sqrt(torch.clamp(1.0 - u1, 0.0, 1.0))
        phi = 2.0 * PI * u2
        wi_d = (st * torch.cos(phi))[:, None] * t \
            + (st * torch.sin(phi))[:, None] * b + ct[:, None] * ns
        a2 = p.refl_alpha * p.refl_alpha
        c2 = (1.0 - u1) / torch.clamp(1.0 + (a2 - 1.0) * u1, min=1e-12)
        ch = torch.sqrt(torch.clamp(c2, 0.0, 1.0))
        sh = torch.sqrt(torch.clamp(1.0 - c2, 0.0, 1.0))
        h = (sh * torch.cos(phi))[:, None] * t \
            + (sh * torch.sin(phi))[:, None] * b + ch[:, None] * ns
        mirror = p.refl_dist == REFL_MIRROR
        wi_s = torch.where(mirror[:, None], reflect3(-wo, ns), reflect3(-wo, h))
        wi_s = normalize3(wi_s)
        # smooth glass: Fresnel-weighted reflection or refraction about ns
        eta = torch.where(facing, p.transp_ior,
                          1.0 / torch.clamp(p.transp_ior, min=1e-4))
        cio = torch.clamp(dot3(ns, wo), 0.0, 1.0)
        F = self.fresnel(cio, eta)
        ie = 1.0 / torch.clamp(eta, min=1e-6)
        ct2 = 1.0 - ie * ie * (1.0 - cio * cio)
        tir = ct2 < 0.0
        ctt = torch.sqrt(torch.clamp(ct2, 0.0, 1.0))
        wt = normalize3((-ie)[:, None] * wo + (ie * cio - ctt)[:, None] * ns)
        refl_choice = (u3 < F) | tir
        wi_t = torch.where(refl_choice[:, None], reflect3(-wo, ns), wt)
        wi = torch.where(pick_d[:, None], wi_d,
                         torch.where(pick_s[:, None], wi_s,
                                     torch.where(pick_t[:, None], wi_t, -wi_d)))
        spec = (pick_s & mirror) | pick_t
        trans = (pick_t & ~refl_choice) | pick_l
        f, pdf = self.eval_bsdf(p, wo, wi, ns)
        cos_i = dot3(ns, wi).abs()
        w_gl = f * (cos_i / torch.clamp(pdf, min=EPS_PDF))[:, None]
        w_mirror = p.refl_color / torch.clamp(ks, min=EPS_PDF)[:, None]
        w_glass = p.transp_color / torch.clamp(kt, min=EPS_PDF)[:, None]
        weight = torch.where(spec[:, None],
                             torch.where(pick_t[:, None], w_glass, w_mirror),
                             w_gl)
        pdf = torch.where(spec, 0.0, pdf)
        dead = ~(pick_d | pick_s | pick_t | pick_l)
        weight = torch.where((dead | ~alive)[:, None], 0.0, weight)
        return wi, weight, pdf, spec, trans

    # ---- the light
    def sample_light(self, r, sp):
        """A point on the rect seen from sp: (dir, dist, radiance, pdf_w)."""
        L = self.l
        p = L.pos + (2.0 * r[:, 0] - 1.0)[:, None] * L.vx \
            + (2.0 * r[:, 1] - 1.0)[:, None] * L.vy
        to_l = p - sp
        d2 = torch.clamp(dot3(to_l, to_l), min=1e-12)
        dist = torch.sqrt(d2)
        wi = to_l / dist[:, None]
        cos_l = dot3(L.norm, -wi)
        pdf = d2 / (L.area * torch.clamp(cos_l, min=1e-6))
        rad = torch.where((cos_l > 1e-6)[:, None], L.intensity, 0.0)
        return wi, dist, rad, pdf

    def light_pdf(self, o, d, pos, n):
        to_h = pos - o
        d2 = torch.clamp(dot3(to_h, to_h), min=1e-12)
        cos_l = torch.clamp(dot3(n, -d), min=1e-6)
        return d2 / (self.l.area * cos_l)

    # ---- camera
    def eye_rays(self, pix, samp, seed: int):
        W, H = self.W, self.H
        sidx = rng.mul32(pix, 0x9E3779B9) ^ samp
        jit = rng.screen_sample(samp, pix).to(self.dtype)
        x = ((pix % W).to(torch.float32).to(self.dtype) + jit[:, 0]) / W \
            * 2.0 - 1.0
        y = 1.0 - ((pix // W).to(torch.float32).to(self.dtype) + jit[:, 1]) \
            / H * 2.0
        ndc = torch.stack([x, y, torch.zeros_like(x), torch.ones_like(x)], -1)
        pv = ndc @ self.proj_inv.T
        dv = normalize3(pv[:, :3] / torch.clamp(pv[:, 3:4].abs(), min=1e-12))
        d = normalize3(dv @ self.view_inv[:3, :3].T)
        return torch.broadcast_to(self.cam_pos, d.shape), d, sidx


def pt_radiance(S: Scene, o, d, sidx, seed: int, depth: int):
    """MIS + NEE path tracing of the rays; radiance (R, 3)."""
    R = o.shape[0]
    dt, dev = S.dtype, S.device
    acc = torch.zeros((R, 3), dtype=dt, device=dev)
    T = torch.ones((R, 3), dtype=dt, device=dev)
    alive = torch.ones((R,), dtype=torch.bool, device=dev)
    prev_pdf = torch.zeros((R,), dtype=dt, device=dev)
    prev_spec = torch.ones((R,), dtype=torch.bool, device=dev)
    for k in range(depth):
        t, tri, u, v = S.cast.closest(o, d, alive)
        alive = alive & (tri >= 0)
        pos, n, ng, p, light = S.hit(tri, u, v, o, d, t)
        wo = -d
        emitter = alive & (p.em_color.amax(-1) > 1e-6)
        front = dot3(n, wo) > 0.0
        w_li = torch.where(prev_spec | (light < 0), 1.0,
                           mis(prev_pdf, S.light_pdf(o, d, pos, n) * S.l.pick))
        acc = acc + torch.where((emitter & front)[:, None],
                                T * p.em_color * w_li[:, None], 0.0)
        alive = alive & ~emitter
        if k == depth - 1:
            break
        r_l = rng.rand4(sidx, k, DG_LIGHT, seed, dt)
        ns = torch.where(dot3(n, wo)[:, None] >= 0.0, n, -n)
        ngs = torch.where(dot3(ng, wo)[:, None] >= 0.0, ng, -ng)
        ldir, ldist, lrad, lpdf = S.sample_light(r_l, pos)
        so = offset(pos, ngs, ldir)
        f, pdf_f = S.eval_bsdf(p, wo, ldir, ns)
        cos_s = dot3(ldir, ns).abs()
        w_l = mis(lpdf * S.l.pick, pdf_f)
        contrib = T * f * lrad * (cos_s * w_l / torch.clamp(
            lpdf * S.l.pick, min=1e-12))[:, None]
        need = alive & (cos_s > 0.0) & (contrib.amax(-1) > 0.0)
        occ = S.cast.occluded(so, ldir, ldist * 0.995, need)
        acc = acc + torch.where((need & ~occ)[:, None], contrib, 0.0)
        wi, weight, prev_pdf, prev_spec, trans = S.sample_bsdf(
            p, wo, ns, rng.rand4(sidx, k, DG_BSDF, seed, dt))
        T = T * weight
        if k >= 3:
            q = torch.clamp(T.amax(-1), 0.05, 1.0)
            u_rr = rng.rand4(sidx, k, DG_RR, seed, dt)[:, 0]
            T = T / q[:, None]
            alive = alive & ~(u_rr >= q)
        alive = alive & (T.amax(-1) > 1e-7)
        o = offset(pos, torch.where(trans[:, None], -ngs, ngs), wi)
        d = wi
    return acc


def pt_tile(S: Scene, pix, pass_base: int, seed: int, k_samples: int,
            clamp: float = 1e6, block: int = 1 << 16):
    """Mean of K samples a pixel of the flat pixel ids `pix` (P,), sample
    k of a pixel being pass_base + k; each sample clamped to [0, clamp].
    Rays are traced `block` at a time."""
    pix = pix.to(torch.int64)
    P = pix.shape[0]
    out = []
    per = max(1, block // k_samples)
    for b in range(0, P, per):
        pb = pix[b:b + per].repeat_interleave(k_samples)
        samp = (torch.arange(k_samples, dtype=torch.int64, device=pix.device)
                .repeat(pb.shape[0] // k_samples) + pass_base) & rng.M32
        o, d, sidx = S.eye_rays(pb, samp, seed)
        c = torch.clamp(pt_radiance(S, o, d, sidx, seed, S.depth), 0.0, clamp)
        out.append(c.reshape(-1, k_samples, 3).mean(dim=1))
    return torch.cat(out)


def lt_pass(S: Scene, pass_idx: int, seed: int, n_paths: int):
    """One light-tracing pass of n_paths paths: the (H, W, 3) splat."""
    W, H, dev, dt = S.W, S.H, S.device, S.dtype
    tan_half = S.proj_inv[1, 1]
    d_img = H / (2.0 * tan_half)
    view = torch.linalg.inv(S.view_inv.float()).to(dt)
    pidx = torch.arange(n_paths, dtype=torch.int64, device=dev)
    sidx = rng.mul32(pidx, 0x9E3779B9) ^ rng.mul32(
        torch.tensor(pass_idx & rng.M32, device=dev), 0x85EBCA6B)
    r = rng.rand4(sidx, 0, DG_LT_EMIT, seed, dt)
    L = S.l
    pos = L.pos + (2 * r[:, 0] - 1)[:, None] * L.vx \
        + (2 * r[:, 1] - 1)[:, None] * L.vy
    nl = torch.broadcast_to(L.norm, pos.shape)
    t, b = basis(nl)
    ct = torch.sqrt(torch.clamp(r[:, 2], 0.0, 1.0))
    st = torch.sqrt(torch.clamp(1 - r[:, 2], 0.0, 1.0))
    ph = 2 * PI * r[:, 3]
    d = (st * torch.cos(ph))[:, None] * t + (st * torch.sin(ph))[:, None] * b \
        + ct[:, None] * nl
    cos_l = torch.clamp(ct, min=1e-6)
    pdf = (1.0 / L.area) * (cos_l * (1.0 / PI)) * L.pick
    T = L.intensity * (cos_l / torch.clamp(pdf, min=1e-12))[:, None]
    o = offset(pos, nl, d)
    alive = torch.ones((n_paths,), dtype=torch.bool, device=dev)
    fb = torch.zeros((H * W, 3), dtype=dt, device=dev)
    for k in range(S.depth - 1):
        tt, tri, u, v = S.cast.closest(o, d, alive)
        alive = alive & (tri >= 0)
        pos, n, ng, p, _ = S.hit(tri, u, v, o, d, tt)
        n = torch.where(dot3(n, -d)[:, None] >= 0.0, n, -n)
        ng = torch.where(dot3(ng, -d)[:, None] >= 0.0, ng, -ng)
        to_cam = S.cam_pos - pos
        dist2 = torch.clamp(dot3(to_cam, to_cam), min=1e-12)
        dist = torch.sqrt(dist2)
        w_cam = to_cam / dist[:, None]
        pv = pos @ view[:3, :3].T + view[:3, 3]
        z = -pv[:, 2]
        sx = pv[:, 0] / torch.clamp(z, min=1e-6) / (tan_half * W / H)
        sy = pv[:, 1] / torch.clamp(z, min=1e-6) / tan_half
        fx = torch.floor((sx + 1.0) * 0.5 * W)
        fy = torch.floor((1.0 - sy) * 0.5 * H)
        on = (z > 1e-4) & (fx >= 0) & (fx < W) & (fy >= 0) & (fy < H)
        f, _ = S.eval_bsdf(p, -d, w_cam, n)
        cos_x = dot3(w_cam, n).abs()
        cos_cam = torch.clamp(z / dist, min=1e-6)
        factor = (d_img / cos_cam) ** 2 / cos_cam * cos_x / dist2
        can = alive & on & (cos_x > 0)
        occ = S.cast.occluded(offset(pos, ng, w_cam), w_cam, dist * 0.995, can)
        c = T * f * (factor / n_paths)[:, None]
        c = torch.where((can & ~occ)[:, None], c, 0.0)
        px = torch.where(can, fx, 0.0).to(torch.int64)
        py = torch.where(can, fy, 0.0).to(torch.int64)
        fb.index_add_(0, py * W + px, c)
        if k == S.depth - 2:
            break
        wi, weight, _, _, trans = S.sample_bsdf(
            p, -d, n, rng.rand4(sidx, k, DG_LT_BSDF, seed, dt))
        T = T * weight
        alive = alive & (T.amax(-1) > 1e-7)
        o = offset(pos, torch.where(trans[:, None], -ng, ng), wi)
        d = wi
    return fb.reshape(H, W, 3)
