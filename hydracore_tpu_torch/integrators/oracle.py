"""Eager numpy reference integrator — the executable spec / oracle.

The port's own copy of the JAX package's integrators/oracle.py (ref CPU
core role, CPUExpLayer + IntegratorMISPT, SURVEY.md §4.4: "the CPU
reference core as oracle"): a deliberately boring, per-ray-recursive,
pure-numpy MIS path tracer (OracleRenderer), forward light tracer
(OracleLT), per-(s, t) bidirectional oracle (OracleSBDPT, rect light or
sky) and scalar Metropolis over that target (OracleMMLT), sharing NOTHING
with the torch wavefront except the scene tables and the counter-based
RNG: independent implementations the wavefront integrators are tested
against. The scene's tables are read once into host
numpy arrays (`.cpu().numpy()`), so a scene on the card works too.

Slow by construction (python loop over pixels); use tiny resolutions.
"""
from __future__ import annotations

import dataclasses
from types import SimpleNamespace

import numpy as np
import torch


def _np(x, dtype=None) -> np.ndarray:
    """A host numpy array of a tensor (on any device) or an array."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype)


def _host_table(table) -> SimpleNamespace:
    """A material or light table with every field as a host numpy array."""
    return SimpleNamespace(**{f.name: _np(getattr(table, f.name))
                              for f in dataclasses.fields(table)})


def _rand4(sample_index: int, bounce: int, group: int, seed: int) -> np.ndarray:
    """Mirror of ops/rng.rand4 for scalar indices (uint32 semantics)."""
    # pure-numpy PCG3D identical to ops/rng.py
    def u32(x):
        return np.uint32(x & 0xFFFFFFFF)

    v = np.array([
        u32(sample_index),
        u32(np.uint32(bounce) * np.uint32(0x9E3779B9) ^ np.uint32(group) * np.uint32(0x85EBCA6B)),
        u32(seed),
    ], np.uint32)
    with np.errstate(over="ignore"):
        v = v * np.uint32(1664525) + np.uint32(1013904223)
        x, y, z = v
        x = u32(x + y * z)
        y = u32(y + z * x)
        z = u32(z + x * y)
        x ^= x >> np.uint32(16)
        y ^= y >> np.uint32(16)
        z ^= z >> np.uint32(16)
        x = u32(x + y * z)
        y = u32(y + z * x)
        z = u32(z + x * y)
        w = x ^ y ^ z ^ np.uint32(0x27220A95)
        w ^= w >> np.uint32(16)
        w = u32(w * np.uint32(0x7FEB352D))
        w ^= w >> np.uint32(15)
        w = u32(w * np.uint32(0x846CA68B))
        w ^= w >> np.uint32(16)
    bits = np.array([x, y, z, w], np.uint32)
    return (bits >> np.uint32(8)).astype(np.float64) / 16777216.0


class OracleRenderer:
    """Per-pixel recursive path tracer over a SceneData (host numpy copies
    of its tables). Three estimator modes — the reference's CPU integrator family
    (CPUExp_Integrators.h):

      * "mispt"    — NEE + BSDF sampling combined by the power heuristic
                     (IntegratorMISPT:381)
      * "ptstupid" — BSDF sampling only, emitter hits weight 1
                     (IntegratorStupidPT:317)
      * "shadowpt" — NEE only; emitter light reaches the camera solely
                     through delta/specular chains (IntegratorShadowPT:369)

    All three estimate the same integral: they cross-check each other AND
    the production wavefront (tests/test_torch_oracle.py)."""

    def __init__(self, scene, mode: str = "mispt"):
        assert mode in ("mispt", "ptstupid", "shadowpt")
        self.mode = mode
        self.v0 = _np(scene.tri_v0)
        self.e1 = _np(scene.tri_e1)
        self.e2 = _np(scene.tri_e2)
        self.n0 = _np(scene.n0)
        self.n1 = _np(scene.n1)
        self.n2 = _np(scene.n2)
        self.uv0 = _np(scene.uv0)
        self.uv1 = _np(scene.uv1)
        self.uv2 = _np(scene.uv2)
        self.tri_mat = _np(scene.tri_mat)
        self.tri_light = _np(scene.tri_light)
        self.mt = _host_table(scene.materials)
        self.lt = _host_table(scene.lights)
        self.cam = scene.camera.to("cpu")
        self.env = _np(scene.env_color)
        self.texels = _np(scene.texels)
        self.tex_table = _np(scene.tex_table)
        self.ml_cdf = _np(scene.ml_cdf)
        self.ml_tri = _np(scene.ml_tri)
        self.has_alpha = bool((np.asarray(self.mt.opacity_tex) != 0).any()
                              | (np.asarray(self.mt.skip_shadow) != 0).any())
        # first sky light row (textured env)
        self.sky_row = -1
        lts = np.asarray(self.lt.ltype)
        for i in range(len(lts)):
            if int(lts[i]) == 3:
                self.sky_row = i
                break

    # ---- textures (independent numpy mirror of ops/texture.sample_bilinear
    # bilinear/wrap semantics, identity sampler)
    def _tex(self, slot: int, uv) -> np.ndarray:
        off, w, h, flags = (int(x) for x in self.tex_table[slot])
        u = float(uv[0]) % 1.0 if not (flags & 1) else min(max(float(uv[0]), 0.0), 1.0)
        v = float(uv[1]) % 1.0 if not (flags & 2) else min(max(float(uv[1]), 0.0), 1.0)
        x = u * w - 0.5
        y = v * h - 0.5
        x0, y0 = int(np.floor(x)), int(np.floor(y))
        fx, fy = x - x0, y - y0

        def texel(xi, yi):
            xi = min(max(xi, 0), w - 1) if (flags & 1) else xi % max(w, 1)
            yi = min(max(yi, 0), h - 1) if (flags & 2) else yi % max(h, 1)
            return self.texels[off + yi * w + xi].astype(np.float64)

        top = texel(x0, y0) * (1 - fx) + texel(x0 + 1, y0) * fx
        bot = texel(x0, y0 + 1) * (1 - fx) + texel(x0 + 1, y0 + 1) * fx
        return top * (1 - fy) + bot * fy

    def _env_radiance(self, d) -> np.ndarray:
        """Sky radiance along d — textured lat-long like
        lights/sampling.env_radiance (same mapping so integrands match)."""
        if self.sky_row < 0:
            return self.env.astype(np.float64)
        inten = np.asarray(self.lt.intensity)[self.sky_row].astype(np.float64)
        slot = int(np.asarray(self.lt.tex)[self.sky_row])
        if slot <= 0:
            return inten
        u = 0.5 + np.arctan2(d[0], -d[2]) * (0.5 / np.pi)
        v = np.arccos(np.clip(d[1], -1.0, 1.0)) / np.pi
        return inten * self._tex(slot, (u, v))[:3]

    def _opacity(self, mat: int, uv) -> float:
        slot = int(np.asarray(self.mt.opacity_tex)[mat])
        if slot == 0:
            return 1.0
        return float(self._tex(slot, uv)[0])

    # ---- geometry
    def trace(self, o, d, t_max=1e30):
        from hydracore_tpu_torch.bvh.builder import brute_force_closest_hit

        t, tri, u, v = brute_force_closest_hit(o[None], d[None], self.v0, self.e1, self.e2, t_max)
        return t[0], int(tri[0]), float(u[0]), float(v[0])

    def occluded(self, o, d, dist, u_alpha: float = 0.5):
        if not self.has_alpha:
            t, tri, _, _ = self.trace(o, d, dist * 0.995)
            return np.isfinite(t)
        # stochastic transparent-layer walk (pt.shadow_trace semantics:
        # up to 2 alpha layers pass w.p. 1-opacity / skip_shadow, 3rd
        # surface counts opaque)
        oo, d_left = o.copy(), dist * 0.995
        for step in range(3):
            t, tri, u, v = self.trace(oo, d, d_left)
            if not np.isfinite(t):
                return False
            if step == 2:
                return True
            mat = int(self.tri_mat[tri])
            w = 1.0 - u - v
            uvh = w * self.uv0[tri] + u * self.uv1[tri] + v * self.uv2[tri]
            op = self._opacity(mat, uvh)
            skip = int(np.asarray(self.mt.skip_shadow)[mat]) != 0
            ustep = (u_alpha + step * 0.618034) % 1.0
            if not (((op < 0.999) and (ustep >= op)) or skip):
                return True
            oo = oo + (t + 1e-4) * d
            d_left = max(d_left - t - 1e-4, 0.0)
        return False

    # ---- shading
    def _nee_w(self, pdf_light, pdf_bsdf):
        """NEE estimator weight per mode: 0 kills the NEE branch (stupid
        PT), 1 takes it whole (shadow PT), else power-heuristic MIS."""
        if self.mode == "ptstupid":
            return 0.0
        if self.mode == "shadowpt":
            return 1.0
        return pdf_light**2 / max(pdf_light**2 + pdf_bsdf**2, 1e-20)

    @staticmethod
    def _hg(d, g, e1, e2):
        """Henyey-Greenstein direction about d — scalar mirror of
        pt.hg_sample (SampleHenyeyGreenstein, CPUExp_IntegratorSSS.cpp:110)."""
        s = 1.0 - 2.0 * e1
        denom = max((1.0 + g * s) ** 2, 1e-6)
        cost = (s + 2.0 * g**3 * (e1 - 1.0) * e1 + g * g * s
                + 2.0 * g * (1.0 - e1 + e1 * e1)) / denom
        cost = min(max(cost, -1.0), 1.0)
        sint = np.sqrt(max(1.0 - cost * cost, 1e-6))
        sign = 1.0 if d[2] >= 0 else -1.0
        a = -1.0 / (sign + d[2])
        b = d[0] * d[1] * a
        tb = np.array([1.0 + sign * d[0] ** 2 * a, sign * b, -sign * d[0]])
        bb = np.array([b, sign + d[1] ** 2 * a, -d[1]])
        phi = 2.0 * np.pi * e2
        wi = np.cos(phi) * sint * tb + np.sin(phi) * sint * bb + cost * d
        return wi / max(np.linalg.norm(wi), 1e-12)

    def radiance(self, o, d, sample_index, seed, depth, max_depth, prev_pdf,
                 prev_spec, fog=None, med=None):
        """fog: None or (color (3,), mult) — the armed thick-glass Beer fog
        of the medium this segment travels through (attenuationStep,
        cmaterial.h:2787). Attenuates everything arriving along it.

        med: None or (sigma_s, sigma_a (3,), g) — the SSS scattering medium
        this ray currently travels inside (ref PathTraceVol,
        CPUExp_IntegratorSSS.cpp:143): sample a free-flight distance
        ~ exp(sigma_s); scattering consumes a depth step (HG direction,
        Beer absorption, specular-for-MIS like the wavefront's scat lanes);
        otherwise attenuate to the boundary surface."""
        if med is not None:
            sig_s, sig_a, g = med
            if depth >= max_depth - 1:
                return np.zeros(3)
            pre = self.trace(o, d)
            if not np.isfinite(pre[0]):
                return np.zeros(3)  # lost inside the medium (pt.py in_med&miss)
            r_m = _rand4(sample_index, depth, 5, seed)
            d_scat = -np.log(max(r_m[0], 1e-12)) / max(sig_s, 1e-12)
            if sig_s > 0.0 and d_scat < pre[0]:
                att = np.exp(-sig_a * d_scat)
                wi = self._hg(d, g, r_m[1], r_m[2])
                return att * self.radiance(o + d_scat * d, wi, sample_index,
                                           seed, depth + 1, max_depth, 0.0,
                                           True, fog=fog, med=med)
            att = np.exp(-sig_a * pre[0])
            return att * self._radiance_inner(o, d, sample_index, seed, depth,
                                              max_depth, prev_pdf, prev_spec,
                                              fog, pre=pre, med=med)
        if fog is not None:
            pre = self.trace(o, d)
            inner = self._radiance_inner(o, d, sample_index, seed, depth,
                                         max_depth, prev_pdf, prev_spec, fog,
                                         pre=pre)
            t_f = pre[0]
            if np.isfinite(t_f):
                att = np.exp(-np.maximum(1.0 - np.asarray(fog[0], np.float64),
                                         0.0) * fog[1] * t_f)
                return att * inner
            return inner
        return self._radiance_inner(o, d, sample_index, seed, depth,
                                    max_depth, prev_pdf, prev_spec, None)

    def _radiance_inner(self, o, d, sample_index, seed, depth, max_depth,
                        prev_pdf, prev_spec, fog=None, pre=None, med=None):
        t, tri, u, v = pre if pre is not None else self.trace(o, d)
        if not np.isfinite(t):
            # BSDF-only env estimator (no env NEE): unbiased on its own,
            # textured to match the production integrand
            return self._env_radiance(d)
        w = 1.0 - u - v
        pos = o + t * d
        n = w * self.n0[tri] + u * self.n1[tri] + v * self.n2[tri]
        n = n / max(np.linalg.norm(n), 1e-12)
        mat = int(self.tri_mat[tri])
        uv = w * self.uv0[tri] + u * self.uv1[tri] + v * self.uv2[tri]

        # ---- stochastic alpha pass-through (one step consumed, specular
        # for MIS — mirrors pt.py passthru semantics)
        if self.has_alpha:
            op = self._opacity(mat, uv)
            ua = _rand4(sample_index, depth, 4, seed)[0]
            if op < 0.999 and ua >= op:
                if depth >= max_depth - 1:
                    return np.zeros(3)
                eps_a = 2e-4 * max(1.0, np.abs(pos).max())
                return self.radiance(pos + d * eps_a, d, sample_index, seed,
                                     depth + 1, max_depth, 0.0, True, fog=fog)

        em = np.asarray(self.mt.em_color)[mat].astype(np.float64)
        if em.max() > 1e-6:
            if float(np.dot(n, -d)) <= 0.0:
                return np.zeros(3)
            lrow = int(self.tri_light[tri])
            if self.mode == "ptstupid" or prev_spec or lrow < 0:
                return em  # BSDF-only estimator: implicit hits weight 1
            if self.mode == "shadowpt":
                return np.zeros(3)  # NEE-only: implicit hits dropped
            # MIS vs the light pdf
            lp = self._light_pdf_hit(lrow, o, d, pos, n)
            pick = float(np.asarray(self.lt.pick_cdf)[lrow + 1] - np.asarray(self.lt.pick_cdf)[lrow])
            wmis = prev_pdf**2 / max(prev_pdf**2 + (lp * pick) ** 2, 1e-20)
            return em * wmis
        if depth >= max_depth - 1:
            return np.zeros(3)

        facing = np.dot(n, -d) >= 0
        ns = n if facing else -n
        albedo = np.asarray(self.mt.diff_color)[mat].astype(np.float64)
        refl = np.asarray(self.mt.refl_color)[mat].astype(np.float64)
        transp = np.asarray(self.mt.transp_color)[mat].astype(np.float64)
        transl = np.asarray(self.mt.transl_color)[mat].astype(np.float64)
        # ---- SSS boundary lobes (bsdf/core.py:164-176 mapping of the
        # reference's branch probabilities, CPUExp_IntegratorSSS.cpp:69-97):
        # transmit w.p. T with color 1-kd, else diffuse-reflect with color
        # kd => effective diffuse = kd(1-T), effective translucency = (1-kd)T
        T_sss = float(np.asarray(self.mt.sss_transmission)[mat])
        if T_sss > 0.0:
            kd_vec = albedo.copy()
            albedo = kd_vec * (1.0 - T_sss)
            transl = np.clip(1.0 - kd_vec, 0.0, 1.0) * T_sss
        ior = float(np.asarray(self.mt.transp_ior)[mat])
        rdist = int(np.asarray(self.mt.refl_dist)[mat])
        ralpha = float(np.asarray(self.mt.refl_alpha)[mat])

        def lum(c):
            return 0.2126 * c[0] + 0.7152 * c[1] + 0.0722 * c[2]

        kd_, ks_ = lum(albedo), lum(refl)
        kt_, kl_ = lum(transp), lum(transl)
        ktot = kd_ + ks_ + kt_ + kl_
        is_mirror = rdist == 4

        out = np.zeros(3)
        # ---- NEE over one light picked by the CDF (diffuse + GGX lobes;
        # pure mirrors skip NEE)
        r_l = _rand4(sample_index, depth, 2, seed)
        u_sh = _rand4(sample_index, depth, 6, seed)[0]  # alpha shadow walk
        cdf = np.asarray(self.lt.pick_cdf)
        lrow = int(np.clip(np.searchsorted(cdf, r_l[3], side="right") - 1, 0, len(cdf) - 2))
        pick = float(cdf[lrow + 1] - cdf[lrow])
        ltype = int(np.asarray(self.lt.ltype)[lrow])
        lpos = np.asarray(self.lt.pos)[lrow].astype(np.float64)
        lnorm = np.asarray(self.lt.norm)[lrow].astype(np.float64)
        inten = np.asarray(self.lt.intensity)[lrow].astype(np.float64)
        def eval_f_pdf(wi):
            """mixture (f, pdf) for NEE MIS: diffuse + GGX reflection on the
            facing side, lambert transmission (translucency) on the back
            (eval_bsdf two-sided semantics, bsdf/core.py:548)."""
            cos_i = float(np.dot(wi, ns))
            if ktot <= 0:
                return np.zeros(3), 0.0
            if cos_i <= 0:  # transmission side: translucency lobe only
                if kl_ <= 0:
                    return np.zeros(3), 0.0
                return transl / np.pi, (kl_ / ktot) * abs(cos_i) / np.pi
            f = albedo / np.pi
            pdf = (kd_ / ktot) * cos_i / np.pi
            if ks_ > 0 and rdist == 2 and not is_mirror:  # GGX
                wo = -d
                h = wo + wi
                h = h / max(np.linalg.norm(h), 1e-12)
                ch = max(float(np.dot(h, ns)), 0.0)
                coh = max(float(np.dot(wo, h)), 1e-6)
                co = max(float(np.dot(wo, ns)), 1e-6)
                a2 = ralpha * ralpha
                dd = ch * ch * (a2 - 1.0) + 1.0
                D = a2 / max(np.pi * dd * dd, 1e-12)
                def g1(c):
                    return 2 * c / max(c + np.sqrt(a2 + (1 - a2) * c * c), 1e-12)
                G = g1(co) * g1(cos_i)
                f = f + refl * D * G / max(4 * co * cos_i, 1e-6)
                pdf += (ks_ / ktot) * D * ch / (4 * coh)
            return f, pdf

        f_d = albedo / np.pi

        if ltype == 4:  # area rect
            vx = np.asarray(self.lt.vx)[lrow].astype(np.float64)
            vy = np.asarray(self.lt.vy)[lrow].astype(np.float64)
            area = float(np.asarray(self.lt.area)[lrow])
            p = lpos + (2 * r_l[0] - 1) * vx + (2 * r_l[1] - 1) * vy
            to_l = p - pos
            d2 = float(np.dot(to_l, to_l))
            dist = np.sqrt(d2)
            wi = to_l / dist
            cos_l = float(np.dot(lnorm, -wi))
            cos_s = abs(float(np.dot(wi, ns)))
            if cos_l > 1e-6 and cos_s > 0:
                pdf_w = d2 / (area * cos_l)
                side = 1.0 if float(np.dot(wi, ns)) >= 0 else -1.0
                sro = pos + side * ns * 2e-4 * max(1.0, np.abs(pos).max())
                if not self.occluded(sro, wi, dist, u_sh):
                    fv, pdf_b = eval_f_pdf(wi)
                    wmis = self._nee_w(pdf_w * pick, pdf_b)
                    out += fv * inten * cos_s * wmis / max(pdf_w * pick, 1e-12)
        elif ltype == 6:  # sphere: cone sampling toward the center
            rad = float(np.asarray(self.lt.radius)[lrow])
            to_c = lpos - pos
            dc2 = float(np.dot(to_c, to_c))
            dc = np.sqrt(dc2)
            sin2 = min(rad * rad / dc2, 0.9999)
            cos_max = np.sqrt(1 - sin2)
            cos_t = 1 - r_l[0] * (1 - cos_max)
            sin_t = np.sqrt(max(1 - cos_t * cos_t, 0.0))
            phi = 2 * np.pi * r_l[1]
            wd = to_c / dc
            sign = 1.0 if wd[2] >= 0 else -1.0
            aa = -1.0 / (sign + wd[2])
            bb_ = wd[0] * wd[1] * aa
            tb2 = np.array([1 + sign * wd[0] ** 2 * aa, sign * bb_, -sign * wd[0]])
            bb2 = np.array([bb_, sign + wd[1] ** 2 * aa, -wd[1]])
            wi = sin_t * np.cos(phi) * tb2 + sin_t * np.sin(phi) * bb2 + cos_t * wd
            wi /= max(np.linalg.norm(wi), 1e-12)
            cos_s = abs(float(np.dot(wi, ns)))
            b_ = float(np.dot(wi, to_c))
            disc = max(b_ * b_ - dc2 + rad * rad, 0.0)
            dist = b_ - np.sqrt(disc)
            if cos_s > 0 and dist > 1e-5:
                pdf_w = 1.0 / max(2 * np.pi * (1 - cos_max), 1e-9)
                side = 1.0 if float(np.dot(wi, ns)) >= 0 else -1.0
                sro = pos + side * ns * 2e-4 * max(1.0, np.abs(pos).max())
                if not self.occluded(sro, wi, dist, u_sh):
                    fv, pdf_b = eval_f_pdf(wi)
                    wmis = self._nee_w(pdf_w * pick, pdf_b)
                    out += fv * inten * cos_s * wmis / max(pdf_w * pick, 1e-12)
        elif ltype == 8:  # mesh light: tri by area CDF + uniform point
            mrow = int(np.asarray(self.lt.mesh_row)[lrow])
            area = float(np.asarray(self.lt.area)[lrow])
            cdfm = self.ml_cdf[mrow]
            ti = int(np.clip((cdfm < r_l[0]).sum(), 0, self.ml_tri.shape[1] - 1))
            trim = int(np.clip(self.ml_tri[mrow, ti], 0, len(self.v0) - 1))
            ub1 = (r_l[0] * 4096.0) % 1.0
            ub2 = (r_l[1] * 4096.0) % 1.0
            r1m = np.sqrt(max(ub1, 0.0))
            pm = (self.v0[trim] + r1m * (1.0 - ub2) * self.e1[trim]
                  + r1m * ub2 * self.e2[trim]).astype(np.float64)
            nm = np.cross(self.e1[trim], self.e2[trim]).astype(np.float64)
            nm /= max(np.linalg.norm(nm), 1e-12)
            to_l = pm - pos
            d2 = max(float(np.dot(to_l, to_l)), 1e-12)
            dist = np.sqrt(d2)
            wi = to_l / dist
            cos_m = abs(float(np.dot(nm, -wi)))  # two-sided emission
            cos_s = abs(float(np.dot(wi, ns)))
            if cos_m > 1e-6 and cos_s > 0:
                pdf_w = d2 / (area * cos_m)
                side = 1.0 if float(np.dot(wi, ns)) >= 0 else -1.0
                sro = pos + side * ns * 2e-4 * max(1.0, np.abs(pos).max())
                if not self.occluded(sro, wi, dist * 0.998, u_sh):
                    fv, pdf_b = eval_f_pdf(wi)
                    wmis = self._nee_w(pdf_w * pick, pdf_b)
                    out += fv * inten * cos_s * wmis / max(pdf_w * pick, 1e-12)
        elif ltype in (0, 1):  # point / spot (delta)
            to_l = lpos - pos
            d2 = float(np.dot(to_l, to_l))
            dist = np.sqrt(d2)
            wi = to_l / dist
            cos_s = abs(float(np.dot(wi, ns)))
            fall = 1.0
            if ltype == 1:  # spot smoothstep falloff (clight.h:7 semantics)
                ci = float(np.asarray(self.lt.cos_in)[lrow])
                co_ = float(np.asarray(self.lt.cos_out)[lrow])
                sc = float(np.dot(lnorm, -wi))
                x = np.clip((sc - co_) / max(ci - co_, 1e-6), 0.0, 1.0)
                fall = x * x * (3 - 2 * x)
            if cos_s > 0 and fall > 0 and self.mode != "ptstupid":
                side = 1.0 if float(np.dot(wi, ns)) >= 0 else -1.0
                sro = pos + side * ns * 2e-4 * max(1.0, np.abs(pos).max())
                if not self.occluded(sro, wi, dist, u_sh):
                    fv, _ = eval_f_pdf(wi)
                    out += fv * (inten * fall / d2) * cos_s / max(pick, 1e-12)

        # ---- bounce: one-sample mixture over diffuse / glossy-mirror /
        # glass / translucency (sample_bsdf's kd/ks/kt/kl partition,
        # bsdf/core.py:707-713)
        if ktot <= 0:
            return out
        r_b = _rand4(sample_index, depth, 1, seed)
        u_lobe = r_b[0] * ktot
        pick_d = u_lobe < kd_
        pick_s = (not pick_d) and u_lobe < kd_ + ks_
        pick_t = (not pick_d) and (not pick_s) and u_lobe < kd_ + ks_ + kt_
        eps2 = 2e-4 * max(1.0, np.abs(pos).max())
        ro2 = pos + ns * eps2
        # Frisvad basis (same as device math3d)
        sign = 1.0 if ns[2] >= 0 else -1.0
        a = -1.0 / (sign + ns[2])
        b = ns[0] * ns[1] * a
        tb = np.array([1.0 + sign * ns[0] ** 2 * a, sign * b, -sign * ns[0]])
        bb = np.array([b, sign + ns[1] ** 2 * a, -ns[1]])
        # SSS boundary events ride the regular lobe mixture below (the
        # effective-lobe fold above keeps sample/eval/NEE MIS pdfs mutually
        # consistent — mirrors pt.py); only the medium STATE is SSS-specific:
        # picking the translucency lobe crosses the boundary.
        med_child = med
        if pick_t:
            # smooth glass: delta Fresnel split (sample_bsdf glass branch,
            # bsdf/core.py:737-763; oracle scenes keep transp_gloss = 1)
            eta = ior if facing else 1.0 / max(ior, 1e-4)
            cos_io = max(float(np.dot(ns, -d)), 0.0)
            sin2_t = max(0.0, 1.0 - cos_io * cos_io) / max(eta * eta, 1e-12)
            tir = sin2_t >= 1.0
            cos_t = np.sqrt(max(1.0 - sin2_t, 0.0))
            rp = (eta * cos_io - cos_t) / max(eta * cos_io + cos_t, 1e-12)
            rs = (cos_io - eta * cos_t) / max(cos_io + eta * cos_t, 1e-12)
            F = 1.0 if tir else min(max(0.5 * (rp * rp + rs * rs), 0.0), 1.0)
            fogm = float(np.asarray(self.mt.fog_mult)[mat])
            fogc = np.asarray(self.mt.fog_color)[mat].astype(np.float64)
            if r_b[3] < F or tir:
                wi = d - 2 * float(np.dot(d, ns)) * ns
                fog_child = fog  # reflection stays in the current medium
            else:
                inv_eta = 1.0 / max(eta, 1e-6)
                wi = inv_eta * d + (inv_eta * cos_io - cos_t) * ns
                wi /= max(np.linalg.norm(wi), 1e-12)
                ro2 = pos - ns * eps2
                # entering arms the Beer fog; exiting clears it (pt.py fog
                # state machine / attenuationStep semantics)
                fog_child = (fogc, fogm) if (facing and fogm > 0.0) else None
            lo = self.radiance(ro2, wi, sample_index, seed, depth + 1,
                               max_depth, 0.0, True, fog=fog_child, med=med)
            return out + transp * (ktot / max(kt_, 1e-9)) * lo
        if (not pick_d) and (not pick_s):  # translucency: back cosine lobe
            ct = np.sqrt(max(r_b[1], 0.0))
            st = np.sqrt(max(1.0 - r_b[1], 0.0))
            phi = 2 * np.pi * r_b[2]
            wi = -(st * np.cos(phi) * tb + st * np.sin(phi) * bb + ct * ns)
            ro2 = pos - ns * eps2
            if T_sss > 0.0:  # SSS boundary crossing (pt.py `cross` lanes)
                if facing:  # entering the medium
                    dens = float(np.asarray(self.mt.sss_density)[mat])
                    med_child = (
                        dens * float(np.asarray(self.mt.sss_scattering)[mat]),
                        dens * np.asarray(self.mt.sss_absorption)[mat]
                        .astype(np.float64),
                        float(np.asarray(self.mt.sss_phase)[mat]))
                else:  # exiting
                    med_child = None
        elif pick_d:
            ct = np.sqrt(max(r_b[1], 0.0))
            st = np.sqrt(max(1.0 - r_b[1], 0.0))
            phi = 2 * np.pi * r_b[2]
            wi = st * np.cos(phi) * tb + st * np.sin(phi) * bb + ct * ns
        elif is_mirror:
            wi = d - 2 * float(np.dot(d, ns)) * ns
            lo = self.radiance(ro2, wi, sample_index, seed, depth + 1,
                               max_depth, 0.0, True, fog=fog, med=med)
            return out + refl * (ktot / max(ks_, 1e-9)) * lo
        else:  # GGX half-vector sampling
            a2 = ralpha * ralpha
            ct2 = (1 - r_b[1]) / max(1 + (a2 - 1) * r_b[1], 1e-12)
            ct = np.sqrt(np.clip(ct2, 0, 1))
            st = np.sqrt(np.clip(1 - ct2, 0, 1))
            phi = 2 * np.pi * r_b[2]
            h = st * np.cos(phi) * tb + st * np.sin(phi) * bb + ct * ns
            wi = d - 2 * float(np.dot(d, h)) * h
            wi /= max(np.linalg.norm(wi), 1e-12)
        cos_i = float(np.dot(wi, ns))
        if (cos_i <= 0 and kl_ <= 0) or cos_i == 0:
            return out
        fv, pdf = eval_f_pdf(wi)
        if pdf <= 0:
            return out
        lo = self.radiance(ro2, wi, sample_index, seed, depth + 1, max_depth,
                           pdf, False, fog=fog, med=med_child)
        return out + fv * abs(cos_i) / pdf * lo

    def render(self, width: int, height: int, spp: int, max_depth: int = 3, seed: int = 777):
        """(H, W, 3) image; pixel-center rays + per-sample decorrelation
        identical in STRUCTURE to the production render (not bit-identical:
        the oracle is an independent estimator)."""
        from hydracore_tpu_torch.integrators.pt import make_eye_rays

        img = np.zeros((height, width, 3))
        pix = np.arange(width * height, dtype=np.uint32)
        for s in range(spp):
            jitter = np.random.default_rng(seed * 1000 + s).random((width * height, 2)).astype(np.float32)
            ro, rd = make_eye_rays(self.cam, torch.as_tensor((pix % width).astype(np.int32)),
                                   torch.as_tensor((pix // width).astype(np.int32)),
                                   torch.as_tensor(jitter), torch.zeros((len(pix), 2)))
            ro = ro.numpy().astype(np.float64)
            rd = rd.numpy().astype(np.float64)
            for i in range(len(pix)):
                sample_index = int((np.uint32(pix[i]) * np.uint32(0x9E3779B9)) ^ np.uint32(s))
                c = self.radiance(ro[i], rd[i], sample_index, seed, 0, max_depth, 0.0, True)
                img[i // width, i % width] += c
        return img / spp

    def _light_pdf_hit(self, lrow, o, d, pos, n):
        ltype = int(np.asarray(self.lt.ltype)[lrow])
        if ltype == 6:  # sphere: cone-sampling pdf (matches sampling.py)
            lpos = np.asarray(self.lt.pos)[lrow].astype(np.float64)
            rad = float(np.asarray(self.lt.radius)[lrow])
            dc2 = max(float(np.dot(lpos - o, lpos - o)), 1e-12)
            sin2 = min(rad * rad / dc2, 0.9999)
            cos_max = np.sqrt(1 - sin2)
            return 1.0 / max(2 * np.pi * (1 - cos_max), 1e-9)
        area = float(np.asarray(self.lt.area)[lrow])
        d2 = float(np.dot(pos - o, pos - o))
        cos_l = max(float(np.dot(n, -d)), 1e-6)
        return d2 / max(area * cos_l, 1e-9)


class OracleLT:
    """Independent forward light tracer — the scalar numpy cross-check of
    the wavefront LT stack: LightSampleForward rect emission (clight.h:1064),
    the camera connection with the image-measure factor
    (CameraImageToSurfaceFactor, cbidir.h:78; ConnectToEyeKernel,
    material.cl:147), cosine diffuse bounces. Shares NO code with the torch
    wavefront (lt.py) beyond the scene tables, so agreement pins the
    forward-sampling machinery the whole bidirectional family
    (LT/SBDPT/IBPT/MMLT) is built on. Diffuse surfaces + rect area lights
    only (assert-guarded) — the lobes themselves are cross-checked by
    OracleRenderer on the backward side."""

    def __init__(self, scene):
        self.r = OracleRenderer(scene)
        self.lt = self.r.lt
        self.mt = self.r.mt

    @staticmethod
    def _cosine_about(n, u1, u2):
        sign = 1.0 if n[2] >= 0 else -1.0
        a = -1.0 / (sign + n[2])
        b = n[0] * n[1] * a
        tb = np.array([1.0 + sign * n[0] ** 2 * a, sign * b, -sign * n[0]])
        bb = np.array([b, sign + n[1] ** 2 * a, -n[1]])
        ct = np.sqrt(max(u1, 0.0))
        st = np.sqrt(max(1.0 - u1, 0.0))
        phi = 2.0 * np.pi * u2
        d = st * np.cos(phi) * tb + st * np.sin(phi) * bb + ct * n
        return d / max(np.linalg.norm(d), 1e-12)

    def render(self, n_paths: int, max_depth: int = 5, seed: int = 4242):
        """(H, W, 3) LT splat estimate of the image lt.render_lt computes
        (direct emitter-to-camera paths excluded on both sides)."""
        cam = self.r.cam
        W, H = cam.width, cam.height
        view = np.linalg.inv(_np(cam.mWorldViewInv, np.float64))
        tan_half = float(_np(cam.mProjInv)[1, 1])
        d_img = H / (2.0 * tan_half)
        cpos = _np(cam.pos, np.float64)
        cdf = np.asarray(self.lt.pick_cdf, np.float64)
        ltype = np.asarray(self.lt.ltype)
        img = np.zeros((H, W, 3))
        g = np.random.default_rng(seed)

        def connect(pos, ns, albedo, T):
            to_cam = cpos - pos
            dist2 = max(float(np.dot(to_cam, to_cam)), 1e-12)
            dist = np.sqrt(dist2)
            w_cam = to_cam / dist
            pv = view[:3, :3] @ pos + view[:3, 3]
            z = -pv[2]
            if z <= 1e-4:
                return
            sx = pv[0] / z / (tan_half * W / H)
            sy = pv[1] / z / tan_half
            px = int(np.floor((sx + 1.0) * 0.5 * W))
            py = int(np.floor((1.0 - sy) * 0.5 * H))
            if not (0 <= px < W and 0 <= py < H):
                return
            cos_x = float(np.dot(w_cam, ns))
            if cos_x <= 0.0:  # camera behind the shading surface
                return
            eps = 2e-4 * max(1.0, np.abs(pos).max())
            if self.r.occluded(pos + ns * eps, w_cam, dist):
                return
            cos_cam = max(z / dist, 1e-6)
            factor = (d_img / cos_cam) ** 2 / cos_cam * cos_x / dist2
            img[py, px] += T * (albedo / np.pi) * factor / n_paths

        for _ in range(n_paths):
            u = g.random(4)
            li = int(np.sum(cdf[1:-1] <= u[3]))
            li = min(max(li, 0), len(cdf) - 2)
            pick = max(cdf[li + 1] - cdf[li], 1e-12)
            assert int(ltype[li]) == 4, "OracleLT: rect area lights only"
            lpos = (np.asarray(self.lt.pos)[li]
                    + (2 * u[0] - 1) * np.asarray(self.lt.vx)[li]
                    + (2 * u[1] - 1) * np.asarray(self.lt.vy)[li]).astype(np.float64)
            lnorm = np.asarray(self.lt.norm)[li].astype(np.float64)
            Le = np.asarray(self.lt.intensity)[li].astype(np.float64)
            d = self._cosine_about(lnorm, *g.random(2))
            # Le * cos / (pdf_a * pdf_w * pick) with pdf_a=1/area,
            # pdf_w=cos/pi  =>  Le * area * pi / pick
            T = Le * float(np.asarray(self.lt.area)[li]) * np.pi / pick
            o = lpos + lnorm * 1e-4

            for depth in range(max_depth - 1):
                t, tri, uu, vv = self.r.trace(o, d)
                if not np.isfinite(t):
                    break
                w = 1.0 - uu - vv
                pos = o + t * d
                n = (w * self.r.n0[tri] + uu * self.r.n1[tri]
                     + vv * self.r.n2[tri])
                n = n / max(np.linalg.norm(n), 1e-12)
                mat = int(self.r.tri_mat[tri])
                if np.asarray(self.mt.em_color)[mat].max() > 1e-6:
                    break  # emitter hit: no camera connection, path ends
                assert (np.asarray(self.mt.refl_color)[mat].max() < 1e-6
                        and np.asarray(self.mt.transp_color)[mat].max() < 1e-6), \
                    "OracleLT: diffuse surfaces only"
                ns = n if np.dot(n, -d) >= 0 else -n
                albedo = np.asarray(self.mt.diff_color)[mat].astype(np.float64)
                connect(pos, ns, albedo, T)
                if depth == max_depth - 2:
                    break
                T = T * albedo  # cosine bounce: f*cos/pdf = albedo
                if T.max() < 1e-7:
                    break
                d = self._cosine_about(ns, *g.random(2))
                o = pos + ns * (2e-4 * max(1.0, np.abs(pos).max()))
        return img


class OracleSBDPT:
    """Independent scalar-numpy bidirectional oracle — per-(s, t) strategy
    images with explicit absolute-product MIS in float64.

    The reference carries CPU reference integrators for the bidirectional
    family (IntegratorSBDPT / IntegratorMMLT, CPUExp_Integrators.h:797,842,
    CPUExp_Integrators_*Bidir*.cpp). Aggregate agreement with PT cannot
    catch a bug symmetric across the shared library (e.g. an eval_bsdf pdf
    convention consumed by every strategy). This oracle shares NOTHING with
    the torch wavefront (bdpt.py) beyond the scene tables and the traversal
    cross-checked elsewhere: camera/light subpaths, per-vertex area pdfs,
    the power-heuristic weights and the splat geometry are all re-derived
    here in scalar form. Diffuse (lambert) surfaces + one rect area light
    (or a sky) only, assert-guarded.

    Conventions pinned against bdpt.py (so per-strategy images estimate the
    SAME weighted integrals):
      * camera measure is per-pixel: pdf_w = d_img^2/cos_c^3 with
        d_img = H / (2 tan(fov/2))  (bdpt.cam_pdf_w);
      * a t'=1 strategy's contribution and its density in the weight walk
        carry the 1/n_splat screen-sample suppression (n_splat = W*H);
      * on k=2 paths the unsampled (s'=1, t'=1) strategy leaves the
        denominator (bdpt._mis_weight);
      * t' = k requires a geometrically hittable light.
    """

    def __init__(self, scene):
        self.r = OracleRenderer(scene)
        self.lt = self.r.lt
        self.mt = self.r.mt
        ltype = np.asarray(self.lt.ltype)
        self.sky_mode = len(ltype) >= 1 and int(ltype[0]) == 3
        if not self.sky_mode:
            emitters = np.where(np.asarray(self.lt.area) > 0)[0]
            assert len(ltype) >= 1 and int(ltype[0]) == 4 \
                and len(emitters) >= 1, \
                "OracleSBDPT: rect area light (or sky) expected at row 0"
        assert (np.asarray(self.mt.refl_color).max() < 1e-6
                and np.asarray(self.mt.transp_color).max() < 1e-6), \
            "OracleSBDPT: diffuse surfaces only"
        cam = self.r.cam
        self.W, self.H = cam.width, cam.height
        self.world_view_inv = _np(cam.mWorldViewInv, np.float64)
        self.view = np.linalg.inv(self.world_view_inv)
        self.proj_inv = _np(cam.mProjInv, np.float64)
        self.tan_half = float(self.proj_inv[1, 1])
        self.d_img = self.H / (2.0 * self.tan_half)
        self.cpos = _np(cam.pos, np.float64)
        self.n_splat = float(self.W * self.H)
        # light-0 tables, shared by render_strategy and OracleMMLT
        self.Le = np.asarray(self.lt.intensity)[0].astype(np.float64)
        self.lpos = np.asarray(self.lt.pos)[0].astype(np.float64)
        self.lvx = np.asarray(self.lt.vx)[0].astype(np.float64)
        self.lvy = np.asarray(self.lt.vy)[0].astype(np.float64)
        self.lnorm = np.asarray(self.lt.norm)[0].astype(np.float64)
        self.larea = float(np.asarray(self.lt.area)[0])
        cdf0 = np.asarray(self.lt.pick_cdf, np.float64)
        self.pick = max(cdf0[1] - cdf0[0], 1e-12)
        if self.sky_mode:
            # infinite-light tables (the sky case, pinning the env
            # conventions of _bdpt_core: endpoint in solid-angle measure,
            # first surface vertex at planar bounding-disk density —
            # ref cbidir.h:619-625 / mlt.cl:723 env handling)
            bmin = _np(scene.bvh_bmin[0], np.float64)
            bmax = _np(scene.bvh_bmax[0], np.float64)
            self.scene_cen = (bmin + bmax) * 0.5
            self.scene_rad = float(np.linalg.norm(bmax - bmin) * 0.5 + 1e-3)
            self.pdf_a_far = 1.0 / max(np.pi * self.scene_rad ** 2, 1e-12)
            self.env_rows = _np(scene.env_rows_cdf, np.float64)
            self.env_cols = _np(scene.env_cols_cdf, np.float64)
            self.env_pdf_uv = _np(scene.env_pdf_uv, np.float64)
            self.pick_over_area = 0.0  # unused in sky mode
        else:
            self.pick_over_area = self.pick / self.larea

    def _light_y0(self, u0: float, u1: float) -> dict:
        """The light-sample vertex y0 at rect-light uniform coords."""
        y0p = (self.lpos + (2 * u0 - 1) * self.lvx
               + (2 * u1 - 1) * self.lvy)
        return dict(pos=y0p, ns=self.lnorm, ng=self.lnorm, alb=np.zeros(3),
                    em=self.Le, beta=self.Le / self.pick_over_area,
                    pf=self.pick_over_area)

    def _occluded(self, a, ng_a, b) -> bool:
        dv = b - a
        dist = np.linalg.norm(dv)
        w = dv / max(dist, 1e-12)
        eps = 2e-4 * max(1.0, np.abs(a).max())
        return self.r.occluded(a + ng_a * eps, w, dist * 0.995)

    # ---- shared scalar helpers
    def _eye_ray(self, px, py, jx, jy):
        x = (px + jx) / self.W * 2.0 - 1.0
        y = 1.0 - (py + jy) / self.H * 2.0
        pv = self.proj_inv @ np.array([x, y, 0.0, 1.0])
        dv = pv[:3] / max(abs(pv[3]), 1e-12)
        dv /= np.linalg.norm(dv)
        d = self.world_view_inv[:3, :3] @ dv
        return self.cpos, d / np.linalg.norm(d), dv

    def _cam_pdf_w(self, d_world):
        dv = self.view[:3, :3] @ d_world
        cos_c = max(-dv[2], 1e-6)
        return self.d_img ** 2 / cos_c ** 3

    @staticmethod
    def _to_area(pdf_w, frm, to, to_ng):
        d = to - frm
        d2 = max(float(d @ d), 1e-12)
        w = d / np.sqrt(d2)
        return pdf_w * abs(float(w @ to_ng)) / d2

    def _surface(self, tri, uu, vv, d):
        """(ns, ng, mat, albedo, emission) oriented toward -d."""
        w = 1.0 - uu - vv
        n = (w * self.r.n0[tri] + uu * self.r.n1[tri] + vv * self.r.n2[tri])
        n = n / max(np.linalg.norm(n), 1e-12)
        ng = np.cross(self.r.e1[tri], self.r.e2[tri])
        ng = ng / max(np.linalg.norm(ng), 1e-12)
        if float(n @ -d) < 0.0:
            n = -n
        if float(ng @ n) < 0.0:
            ng = -ng
        mat = int(self.r.tri_mat[tri])
        alb = np.asarray(self.mt.diff_color)[mat].astype(np.float64)
        em = np.asarray(self.mt.em_color)[mat].astype(np.float64)
        return n, ng, mat, alb, em

    def _walk(self, o, d, pdf_w0, n_surf, g):
        """Trace up to n_surf diffuse vertices; returns (verts, esc):
        verts the vertex list dict(pos, ns, ng, alb, em, beta, pf) — beta
        at ARRIVAL, pf the camera/light-side area pdf of this vertex — and
        esc the environment-escape record dict(dir, pdf_w, beta) when the
        walk left the scene (None otherwise; pdf_w is the RAW solid-angle
        pdf that generated the escaping direction — the env endpoint lives
        in directional measure, matching _bdpt_core's sky strategies)."""
        verts = []
        esc = None
        beta = np.ones(3)
        prev = o.copy()
        pdf_w = pdf_w0
        for _ in range(n_surf):
            t, tri, uu, vv = self.r.trace(o, d)
            if not np.isfinite(t):
                esc = dict(dir=d.copy(), pdf_w=pdf_w, beta=beta.copy())
                break
            pos = o + t * d
            ns, ng, mat, alb, em = self._surface(tri, uu, vv, d)
            pf = self._to_area(pdf_w, prev, pos, ng)
            verts.append(dict(pos=pos, ns=ns, ng=ng, alb=alb, em=em,
                              beta=beta.copy(), pf=pf))
            if em.max() > 1e-6:
                break  # emitters terminate subpaths (matches bdpt validity)
            u = g.random(2)
            wi = OracleLT._cosine_about(ns, u[0], u[1])
            cos_i = max(float(wi @ ns), 0.0)
            pdf_w = cos_i / np.pi
            if pdf_w < 1e-9:
                break
            beta = beta * alb  # lambert: f*cos/pdf = albedo
            prev = pos
            o = pos + ng * (2e-4 * max(1.0, np.abs(pos).max()))
            d = wi
        return verts, esc

    def _pl_chain(self, xs, k):
        """Light-side area pdfs pl[i] = pdfA(x_i | x_{i+1}); pl[k-1] is the
        light-position pdf. xs[i] must carry pos/ns/ng; x_{k-1} is y0."""
        pl = [1.0] * k
        pl[k - 1] = self.pick_over_area
        for i in range(k - 2, 0, -1):
            src = xs[i + 1]
            dv = xs[i]["pos"] - src["pos"]
            dist = max(np.linalg.norm(dv), 1e-12)
            w = dv / dist
            cos_s = max(float(w @ src["ns"]), 0.0)
            pl[i] = self._to_area(cos_s / np.pi, src["pos"], xs[i]["pos"],
                                  xs[i]["ng"])
        return pl

    def _pf_chain(self, xs, k):
        """Camera-side pf[i] = pdfA(x_i | x_{i-1}); pf[1] is the camera
        vertex pdf (xs[0] = pinhole sentinel with pos only)."""
        pf = [1.0] * k
        dv = xs[1]["pos"] - self.cpos
        w = dv / max(np.linalg.norm(dv), 1e-12)
        pf[1] = self._to_area(self._cam_pdf_w(w), self.cpos,
                              xs[1]["pos"], xs[1]["ng"])
        for i in range(2, k):
            src = xs[i - 1]
            dv = xs[i]["pos"] - src["pos"]
            dist = max(np.linalg.norm(dv), 1e-12)
            w = dv / dist
            cos_s = max(float(w @ src["ns"]), 0.0)
            pf[i] = self._to_area(cos_s / np.pi, src["pos"], xs[i]["pos"],
                                  xs[i]["ng"])
        return pf

    # ---- sky-mode helpers: the env endpoint lives in DIRECTIONAL measure
    # (pinning _bdpt_core's infinite-light convention, cbidir.h:619-625 /
    # mlt.cl:723: pl[k-1] = pick * env_pdf_w, pl[k-2] = planar bounding-
    # disk density x |cos|, pf[k-1] = raw solid-angle scatter pdf).
    def _env_pdf_w(self, d):
        """Scalar mirror of envmap.env_pdf_for_dir."""
        Ht, Wt = self.env_pdf_uv.shape
        u = 0.5 + np.arctan2(d[0], -d[2]) * (0.5 / np.pi)
        v = np.arccos(np.clip(d[1], -1.0, 1.0)) / np.pi
        row = min(max(int(v * Ht), 0), Ht - 1)
        col = min(max(int(u * Wt), 0), Wt - 1)
        sin_t = np.sqrt(max(1.0 - d[1] ** 2, 1e-8))
        return float(self.env_pdf_uv[row, col]) \
            / max(2.0 * np.pi ** 2 * sin_t, 1e-8)

    def _env_sample(self, u1, u2):
        """Scalar mirror of envmap.sample_env_dir: (dir TOWARD sky, pdf_w)."""
        Ht, Wt = self.env_pdf_uv.shape
        row = min(max(int(np.searchsorted(self.env_rows, u1, side="right"))
                      - 1, 0), Ht - 1)
        fr = (u1 - self.env_rows[row]) / max(
            self.env_rows[row + 1] - self.env_rows[row], 1e-12)
        ccdf = self.env_cols[row]
        col = min(max(int(np.sum(ccdf <= u2)) - 1, 0), Wt - 1)
        fc = (u2 - ccdf[col]) / max(ccdf[col + 1] - ccdf[col], 1e-12)
        v = (row + fr) / Ht
        u = (col + fc) / Wt
        theta = v * np.pi
        phi = (u - 0.5) * 2.0 * np.pi
        st = np.sin(theta)
        d = np.array([st * np.sin(phi), np.cos(theta), -st * np.cos(phi)])
        d /= max(np.linalg.norm(d), 1e-12)
        pdf = float(self.env_pdf_uv[row, col]) \
            / max(2.0 * np.pi ** 2 * st, 1e-8)
        return d, pdf

    def _pf_chain_sky(self, xs, k, d_sky):
        """Camera-side pdfs for a path whose LAST vertex x_{k-1} is the
        environment (xs[1..k-2] surface vertices; xs[0] pinhole):
        pf[k-1] is the RAW solid-angle pdf toward the sky."""
        pf = [1.0] * k
        if k == 2:
            pf[1] = self._cam_pdf_w(d_sky)
            return pf
        dv = xs[1]["pos"] - self.cpos
        w = dv / max(np.linalg.norm(dv), 1e-12)
        pf[1] = self._to_area(self._cam_pdf_w(w), self.cpos,
                              xs[1]["pos"], xs[1]["ng"])
        for i in range(2, k - 1):
            src = xs[i - 1]
            dv = xs[i]["pos"] - src["pos"]
            dist = max(np.linalg.norm(dv), 1e-12)
            w = dv / dist
            cos_s = max(float(w @ src["ns"]), 0.0)
            pf[i] = self._to_area(cos_s / np.pi, src["pos"], xs[i]["pos"],
                                  xs[i]["ng"])
        pf[k - 1] = max(float(xs[k - 2]["ns"] @ d_sky), 0.0) / np.pi
        return pf

    def _pl_chain_sky(self, xs, k, d_sky):
        """Light-side pdfs for an env-terminated path: pl[k-1] the sky
        sampler's pick * env_pdf_w, pl[k-2] the planar bounding-disk
        density x |cos|, interior vertices as in _pl_chain."""
        pl = [1.0] * k
        pl[k - 1] = self.pick * self._env_pdf_w(d_sky)
        if k >= 3:
            pl[k - 2] = self.pdf_a_far \
                * abs(float(xs[k - 2]["ng"] @ d_sky))
        for i in range(k - 3, 0, -1):
            src = xs[i + 1]
            dv = xs[i]["pos"] - src["pos"]
            dist = max(np.linalg.norm(dv), 1e-12)
            w = dv / dist
            cos_s = max(float(w @ src["ns"]), 0.0)
            pl[i] = self._to_area(cos_s / np.pi, src["pos"], xs[i]["pos"],
                                  xs[i]["ng"])
        return pl

    def _occluded_far(self, a, ng_a, d) -> bool:
        eps = 2e-4 * max(1.0, np.abs(a).max())
        return self.r.occluded(a + ng_a * eps, d, 1e8)

    def _weight(self, pf, pl, t_strat, k, hittable):
        """Power heuristic over all t' in 1..k (absolute products, f64) —
        the explicit form of bdpt._mis_weight's ratio walk."""
        def p_of(tp):
            v = 1.0
            for i in range(1, tp):
                v *= pf[i]
            for i in range(tp, k):
                v *= pl[i]
            return v

        total, num = 0.0, 0.0
        for tp in range(1, k + 1):
            if k == 2 and tp == 1:
                continue  # unsampled directly-visible-light splat
            if tp == k and not hittable:
                continue
            d = p_of(tp) * (self.n_splat if tp == 1 else 1.0)
            total += d * d
            if tp == t_strat:
                num = d * d
        return num / total if total > 0 else 0.0

    def _sample_light_path_env(self, n_surf, g):
        """Env-started light subpath: y0 is the sky endpoint (directional),
        surface vertices walked from a scene-bounding disk inward.
        Returns (y0, ys); y0 carries env_dir (TOWARD the sky), beta_dir
        (radiance over the direction density, the s'=1 connect beta) and
        the verts' beta already folds Le/(pick*pdf_a_far*pdf_w)."""
        u = g.random(2)
        d_sky, pdf_w = self._env_sample(u[0], u[1])
        Le = self.r._env_radiance(d_sky)
        y0 = dict(env_dir=d_sky, em=Le, pdf_w=pdf_w,
                  beta_dir=Le / max(self.pick * pdf_w, 1e-300))
        if n_surf == 0:
            return y0, []
        emit = -d_sky
        # orthonormal basis about the emission direction
        a = np.array([1.0, 0.0, 0.0]) if abs(emit[0]) < 0.9 \
            else np.array([0.0, 1.0, 0.0])
        tt = np.cross(emit, a)
        tt /= max(np.linalg.norm(tt), 1e-12)
        bb = np.cross(emit, tt)
        u = g.random(2)
        rr = np.sqrt(u[0]) * self.scene_rad
        ph = 2.0 * np.pi * u[1]
        o0 = (self.scene_cen - emit * (self.scene_rad * 1.5)
              + rr * np.cos(ph) * tt + rr * np.sin(ph) * bb)
        ys, _ = self._walk(o0, emit, 1.0, n_surf, g)
        beta_walk = Le / max(self.pick * self.pdf_a_far * pdf_w, 1e-300)
        for y in ys:
            y["beta"] = y["beta"] * beta_walk
        if ys:
            # first surface vertex's light-side density is the PLANAR
            # bounding-disk density (not pdf_w-to-area)
            ys[0]["pf"] = self.pdf_a_far * abs(float(ys[0]["ng"] @ emit))
        return y0, ys

    def _render_strategy_sky(self, s: int, t: int, spp: int, seed: int):
        """Sky-mode (s, t) strategy image: the light endpoint x_{k-1} is
        the environment. Mirrors _bdpt_core's env s'=0 / s'=1 / env-started
        light-subpath blocks in scalar float64."""
        k = s + t
        g = np.random.default_rng(seed)
        img = np.zeros((self.H, self.W, 3))
        pin = dict(pos=self.cpos)

        if t >= 2:
            for py in range(self.H):
                for px in range(self.W):
                    acc = np.zeros(3)
                    for _ in range(spp):
                        o, d, _ = self._eye_ray(px, py, *g.random(2))
                        zs, esc = self._walk(o, d, self._cam_pdf_w(d),
                                             t - 1, g)
                        if s == 0:
                            # camera path escapes to the sky after t-2
                            # surface vertices
                            if len(zs) != t - 2 or esc is None:
                                continue
                            d_sky = esc["dir"]
                            xs = [pin] + zs + [None]
                            pf = self._pf_chain_sky(xs, k, d_sky)
                            pf[k - 1] = esc["pdf_w"]
                            pl = self._pl_chain_sky(xs, k, d_sky)
                            w = self._weight(pf, pl, t, k, True)
                            acc += esc["beta"] \
                                * self.r._env_radiance(d_sky) * w
                            continue
                        if len(zs) < t - 1:
                            continue
                        z = zs[-1]
                        if s == 1:
                            # directional NEE toward a sampled env dir
                            u = g.random(2)
                            d_sky, pdf_w = self._env_sample(u[0], u[1])
                            cos_z = float(z["ns"] @ d_sky)
                            if cos_z <= 0.0:
                                continue
                            if self._occluded_far(z["pos"], z["ng"], d_sky):
                                continue
                            beta_dir = self.r._env_radiance(d_sky) \
                                / max(self.pick * pdf_w, 1e-300)
                            c = (z["beta"] * (z["alb"] / np.pi) * cos_z
                                 * beta_dir)
                            xs = [pin] + zs + [None]
                            pf = self._pf_chain_sky(xs, k, d_sky)
                            pl = self._pl_chain_sky(xs, k, d_sky)
                            w = self._weight(pf, pl, t, k, True)
                            acc += c * w
                            continue
                        # s >= 2: inner connection to an env-started
                        # light subpath
                        y0, ys = self._sample_light_path_env(s - 1, g)
                        if len(ys) < s - 1:
                            continue
                        yv = ys[-1]
                        dv = yv["pos"] - z["pos"]
                        d2 = max(float(dv @ dv), 1e-12)
                        dist = np.sqrt(d2)
                        wl = dv / dist
                        cos_z = float(wl @ z["ns"])
                        cos_y = float(-wl @ yv["ns"])
                        if cos_z <= 0 or cos_y <= 1e-6:
                            continue
                        if self._occluded(z["pos"], z["ng"], yv["pos"]):
                            continue
                        G = abs(cos_z) * abs(cos_y) / d2
                        c = (z["beta"] * (z["alb"] / np.pi) * G
                             * (yv["alb"] / np.pi) * yv["beta"])
                        xs = [pin] + zs + list(reversed(ys)) + [None]
                        pf = self._pf_chain_sky(xs, k, y0["env_dir"])
                        pl = self._pl_chain_sky(xs, k, y0["env_dir"])
                        w = self._weight(pf, pl, t, k, True)
                        acc += c * w
                    img[py, px] += acc / spp
            return img

        # t == 1: env-started light paths splatted to the camera
        n_paths = int(self.n_splat)
        for _ in range(spp):
            for _p in range(n_paths):
                y0, ys = self._sample_light_path_env(s - 1, g)
                if len(ys) < s - 1:
                    continue
                yv = ys[-1]
                to_cam = self.cpos - yv["pos"]
                dist2 = max(float(to_cam @ to_cam), 1e-12)
                dist = np.sqrt(dist2)
                w_cam = to_cam / dist
                pv = self.view[:3, :3] @ yv["pos"] + self.view[:3, 3]
                zc = -pv[2]
                if zc <= 1e-4:
                    continue
                sx = pv[0] / zc / (self.tan_half * self.W / self.H)
                sy = pv[1] / zc / self.tan_half
                qx = int(np.floor((sx + 1.0) * 0.5 * self.W))
                qy = int(np.floor((1.0 - sy) * 0.5 * self.H))
                if not (0 <= qx < self.W and 0 <= qy < self.H):
                    continue
                cos_x = float(w_cam @ yv["ns"])
                if cos_x <= 0.0:
                    continue
                if self._occluded(yv["pos"], yv["ng"], self.cpos):
                    continue
                cos_cam = max(zc / dist, 1e-6)
                factor = ((self.d_img / cos_cam) ** 2 / cos_cam
                          * cos_x / dist2)
                c = yv["beta"] * (yv["alb"] / np.pi) * factor / self.n_splat
                xs = [pin] + list(reversed(ys)) + [None]
                pf = self._pf_chain_sky(xs, k, y0["env_dir"])
                pl = self._pl_chain_sky(xs, k, y0["env_dir"])
                w = self._weight(pf, pl, 1, k, True)
                img[qy, qx] += c * w / spp
        return img

    def render_strategy(self, s: int, t: int, spp: int, seed: int = 11):
        """(H, W, 3) float64 image of the MIS-weighted (s, t) strategy:
        t camera vertices (incl. pinhole), s light vertices (incl. the
        light sample y0)."""
        k = s + t
        assert k >= 2 and t >= 1
        if self.sky_mode:
            return self._render_strategy_sky(s, t, spp, seed)
        g = np.random.default_rng(seed)
        lnorm = self.lnorm
        img = np.zeros((self.H, self.W, 3))

        def sample_light_path(n_surf):
            u = g.random(2)
            y0 = self._light_y0(u[0], u[1])
            if n_surf == 0:
                return y0, []
            u = g.random(2)
            d0 = OracleLT._cosine_about(lnorm, u[0], u[1])
            o0 = y0["pos"] + lnorm * 1e-4
            # beta after leaving: Le/(pick/area) * cos/pdf_w = that * pi
            ys, _ = self._walk(o0, d0, max(float(d0 @ lnorm), 1e-9) / np.pi,
                               n_surf, g)
            for y in ys:
                y["beta"] = y["beta"] * y0["beta"] * np.pi
            return y0, ys

        occluded = self._occluded

        for py in range(self.H):
            for px in range(self.W):
                acc = np.zeros(3)
                for _ in range(spp):
                    if t >= 2:
                        o, d, _ = self._eye_ray(px, py, *g.random(2))
                        zs, _ = self._walk(o, d, self._cam_pdf_w(d),
                                           t - 1, g)
                        if len(zs) < t - 1:
                            continue
                        z = zs[-1]
                        # mid-path emitter ends the subpath before t-1
                        if any(zz["em"].max() > 1e-6 for zz in zs[:-1]):
                            continue
                    if s == 0:
                        if z["em"].max() <= 1e-6:
                            continue
                        if float(z["ns"] @ (zs[-2]["pos"] - z["pos"]
                                            if t > 2 else self.cpos
                                            - z["pos"])) <= 0.0:
                            continue
                        xs = [dict(pos=self.cpos)] + zs
                        pf = self._pf_chain(xs, k)
                        pl = self._pl_chain(xs, k)
                        w = self._weight(pf, pl, t, k, True)
                        acc += z["beta"] * z["em"] * w
                        continue
                    y0, ys = sample_light_path(s - 1)
                    if s >= 2 and len(ys) < s - 1:
                        continue
                    if s >= 2 and any(yy["em"].max() > 1e-6 for yy in ys):
                        continue
                    yv = ys[-1] if s >= 2 else y0
                    if t >= 2:
                        if z["em"].max() > 1e-6:
                            continue  # camera subpath ended on the light
                        dv = yv["pos"] - z["pos"]
                        d2 = max(float(dv @ dv), 1e-12)
                        dist = np.sqrt(d2)
                        wl = dv / dist
                        cos_z = float(wl @ z["ns"])
                        cos_y = float(-wl @ yv["ns"])
                        if cos_z <= 0 or cos_y <= 1e-6:
                            continue
                        if occluded(z["pos"], z["ng"], yv["pos"]):
                            continue
                        G = abs(cos_z) * abs(cos_y) / d2
                        f_z = z["alb"] / np.pi
                        f_y = (yv["alb"] / np.pi if s >= 2
                               else np.ones(3))
                        c = (z["beta"] * f_z * G * f_y
                             * (yv["beta"] if s >= 2 else y0["beta"]))
                        xs = ([dict(pos=self.cpos)] + zs
                              + list(reversed(ys)) + [y0])
                        pf = self._pf_chain(xs, k)
                        pl = self._pl_chain(xs, k)
                        w = self._weight(pf, pl, t, k, True)
                        acc += c * w
                    else:
                        # t = 1 handled image-wide below (splats)
                        pass
                img[py, px] += acc / spp

        if t == 1:
            # light-path splats: n_splat paths per "pass", spp passes
            n_paths = int(self.n_splat)
            for _ in range(spp):
                for _p in range(n_paths):
                    y0, ys = sample_light_path(s - 1)
                    if len(ys) < s - 1 or any(
                            yy["em"].max() > 1e-6 for yy in ys):
                        continue
                    yv = ys[-1]
                    to_cam = self.cpos - yv["pos"]
                    dist2 = max(float(to_cam @ to_cam), 1e-12)
                    dist = np.sqrt(dist2)
                    w_cam = to_cam / dist
                    pv = self.view[:3, :3] @ yv["pos"] + self.view[:3, 3]
                    zc = -pv[2]
                    if zc <= 1e-4:
                        continue
                    sx = pv[0] / zc / (self.tan_half * self.W / self.H)
                    sy = pv[1] / zc / self.tan_half
                    qx = int(np.floor((sx + 1.0) * 0.5 * self.W))
                    qy = int(np.floor((1.0 - sy) * 0.5 * self.H))
                    if not (0 <= qx < self.W and 0 <= qy < self.H):
                        continue
                    cos_x = float(w_cam @ yv["ns"])
                    if cos_x <= 0.0:
                        continue
                    if occluded(yv["pos"], yv["ng"], self.cpos):
                        continue
                    cos_cam = max(zc / dist, 1e-6)
                    factor = ((self.d_img / cos_cam) ** 2 / cos_cam
                              * cos_x / dist2)
                    c = yv["beta"] * (yv["alb"] / np.pi) * factor \
                        / self.n_splat
                    xs = [dict(pos=self.cpos)] + list(reversed(ys)) + [y0]
                    pf = self._pf_chain(xs, k)
                    pl = self._pl_chain(xs, k)
                    w = self._weight(pf, pl, 1, k, True)
                    img[qy, qx] += c * w / spp
        return img


class _SeqU:
    """Sequential reader over a fixed uniform vector — the rng shim that
    lets the walk helpers consume a Metropolis state's dims in order."""

    def __init__(self, u):
        self.u = np.asarray(u, np.float64)
        self.i = 0

    def random(self, n=None):
        m = 1 if n is None else int(n)
        out = self.u[self.i:self.i + m]
        if out.shape[0] != m:  # explicit: assert would vanish under -O and
            raise IndexError(  # silently corrupt the Metropolis mapping
                f"uniform vector exhausted: want {m}, have {out.shape[0]}")
        self.i += m
        return float(out[0]) if n is None else out


class OracleMMLT:
    """Independent scalar Metropolis over the scalar SBDPT target.

    The reference keeps a CPU MMLT reference integrator
    (IntegratorMMLT, CPUExp_Integrators.h:842) next to the GPU chains.
    Agreement with PT and a per-strategy check of the target (through
    OracleSBDPT) leave the CHAIN machinery — Kelemen mutations, the Veach
    (1-a)/a double splat, contribution-proportional starts, the per-depth
    b_k normalization — checked only in aggregate. This oracle re-derives
    that machinery in scalar numpy on top of OracleSBDPT's path evaluation
    (which shares nothing with the torch wavefront), so per-depth image
    agreement pins the Metropolis estimator end-to-end:

        E[image_k] = W*H * b_k * E_pi[ sum_S col_S(u) / f(u) ]
                   = W*H * integral( sum_{s+t=k} col_st(u) du )

    — the same per-depth integral render_mmlt estimates
    (GPUOCLLayerAdvanced.cpp:395 MMLT_Pass semantics).

    State layout for path length k (vertex count, pinhole + light incl.):
    [2 pixel] + 2*(k-1) camera-bounce dirs + [2 light pos + 2 emit dir] +
    2*max(k-2, 0) light-bounce dirs. One state evaluates ALL t' = 1..k
    strategies from one camera walk + one light walk, as mmlt._eval_merged
    does over bdpt._bdpt_core with every lane at depth k.
    """

    def __init__(self, scene):
        self.o = OracleSBDPT(scene)  # owns the light tables + occlusion
        self.Le = self.o.Le
        self.lnorm = self.o.lnorm

    @staticmethod
    def dims(k: int) -> int:
        return 2 + 2 * (k - 1) + 4 + 2 * max(k - 2, 0)

    @staticmethod
    def _lum(c):
        return 0.2126 * c[0] + 0.7152 * c[1] + 0.0722 * c[2]

    def _occluded(self, a, ng_a, b):
        return self.o._occluded(a, ng_a, b)

    def eval_state(self, u, k: int):
        """(f_lum, [(qy, qx, rgb), ...]) — every k-vertex strategy's
        MIS-weighted contribution at primary-sample state u."""
        o = self.o
        W, H = o.W, o.H
        fx, fy = float(u[0]) * W, float(u[1]) * H
        px = min(int(fx), W - 1)
        py = min(int(fy), H - 1)
        co, cd, _ = o._eye_ray(px, py, fx - px, fy - py)
        zs, _ = o._walk(co, cd, o._cam_pdf_w(cd), k - 1,
                        _SeqU(u[2:2 + 2 * (k - 1)]))
        lb = 2 + 2 * (k - 1)
        y0 = o._light_y0(float(u[lb]), float(u[lb + 1]))
        y0p = y0["pos"]
        ys = []
        if k >= 3:
            d0 = OracleLT._cosine_about(self.lnorm, float(u[lb + 2]),
                                        float(u[lb + 3]))
            ys, _ = o._walk(y0p + self.lnorm * 1e-4, d0,
                            max(float(d0 @ self.lnorm), 1e-9) / np.pi,
                            k - 2, _SeqU(u[lb + 4:]))
            for y in ys:
                y["beta"] = y["beta"] * y0["beta"] * np.pi
        pin = dict(pos=o.cpos)
        splats = []
        for t in range(1, k + 1):
            s = k - t
            if t == 1 and k == 2:
                continue  # unsampled directly-visible-light splat
            if t >= 2:
                if len(zs) < t - 1 or any(
                        zz["em"].max() > 1e-6 for zz in zs[:t - 2]):
                    continue
                z = zs[t - 2]
            if s == 0:
                if z["em"].max() <= 1e-6:
                    continue
                prev = zs[k - 3]["pos"] if k > 2 else o.cpos
                if float(z["ns"] @ (prev - z["pos"])) <= 0.0:
                    continue
                xs = [pin] + zs[:k - 1]
                w = o._weight(o._pf_chain(xs, k), o._pl_chain(xs, k), t, k,
                              True)
                splats.append((py, px, z["beta"] * z["em"] * w))
                continue
            if s >= 2 and (len(ys) < s - 1 or any(
                    yy["em"].max() > 1e-6 for yy in ys[:s - 1])):
                continue
            yv = ys[s - 2] if s >= 2 else y0
            if t >= 2:
                if z["em"].max() > 1e-6:
                    continue  # camera subpath ended on the light
                dv = yv["pos"] - z["pos"]
                d2 = max(float(dv @ dv), 1e-12)
                dist = np.sqrt(d2)
                wl = dv / dist
                cos_z = float(wl @ z["ns"])
                cos_y = float(-wl @ yv["ns"])
                if cos_z <= 0 or cos_y <= 1e-6:
                    continue
                if self._occluded(z["pos"], z["ng"], yv["pos"]):
                    continue
                G = abs(cos_z) * abs(cos_y) / d2
                c = (z["beta"] * (z["alb"] / np.pi) * G
                     * (yv["alb"] / np.pi if s >= 2 else np.ones(3))
                     * (yv["beta"] if s >= 2 else y0["beta"]))
                xs = [pin] + zs[:t - 1] + list(reversed(ys[:s - 1])) + [y0]
                w = o._weight(o._pf_chain(xs, k), o._pl_chain(xs, k), t, k,
                              True)
                splats.append((py, px, c * w))
            else:  # t == 1: connect yv to the eye, splat where it lands
                to_cam = o.cpos - yv["pos"]
                dist2 = max(float(to_cam @ to_cam), 1e-12)
                dist = np.sqrt(dist2)
                w_cam = to_cam / dist
                pv = o.view[:3, :3] @ yv["pos"] + o.view[:3, 3]
                zc = -pv[2]
                if zc <= 1e-4:
                    continue
                sx = pv[0] / zc / (o.tan_half * o.W / o.H)
                sy = pv[1] / zc / o.tan_half
                qx = int(np.floor((sx + 1.0) * 0.5 * o.W))
                qy = int(np.floor((1.0 - sy) * 0.5 * o.H))
                if not (0 <= qx < o.W and 0 <= qy < o.H):
                    continue
                cos_x = float(w_cam @ yv["ns"])
                if cos_x <= 0.0:
                    continue
                if self._occluded(yv["pos"], yv["ng"], o.cpos):
                    continue
                cos_cam = max(zc / dist, 1e-6)
                factor = ((o.d_img / cos_cam) ** 2 / cos_cam
                          * cos_x / dist2)
                c = (yv["beta"] * (yv["alb"] / np.pi) * factor
                     / o.n_splat)
                xs = [pin] + list(reversed(ys[:s - 1])) + [y0]
                w = o._weight(o._pf_chain(xs, k), o._pl_chain(xs, k), 1, k,
                              True)
                splats.append((qy, qx, c * w))
        f = sum(self._lum(rgb) for _, _, rgb in splats)
        return float(f), splats

    def render(self, ks, n_chains: int = 32, n_steps: int = 250,
               n_pool: int = 512, seed: int = 3, p_large: float = 0.3,
               step: float = 0.08):
        """(H, W, 3) image: per-depth Metropolis chains with large/small
        mutations, double splats, and b_k from the uniform (pool +
        large-step) samples — render_mmlt's estimator in scalar form."""
        o = self.o
        W, H = o.W, o.H
        img = np.zeros((H, W, 3))
        g = np.random.default_rng(seed)
        for k in ks:
            D = self.dims(k)
            pool_u = g.random((n_pool, D))
            evals = [self.eval_state(pool_u[i], k) for i in range(n_pool)]
            fs = np.array([e[0] for e in evals])
            b_sum, b_n = float(fs.sum()), float(n_pool)
            if fs.sum() <= 0.0:
                continue  # no transport at this depth
            cdf = np.cumsum(fs)
            picks = np.clip(np.searchsorted(
                cdf, (np.arange(n_chains) + g.random(n_chains))
                / n_chains * cdf[-1]), 0, n_pool - 1)
            us = pool_u[picks].copy()
            cur = [evals[p] for p in picks]
            fb = np.zeros((H, W, 3))
            for _ in range(n_steps):
                for c in range(n_chains):
                    f_x, spl_x = cur[c]
                    large = g.random() < p_large
                    up = (g.random(D) if large
                          else (us[c] + (g.random(D) - 0.5) * step) % 1.0)
                    f_y, spl_y = self.eval_state(up, k)
                    if large:
                        b_sum += f_y
                        b_n += 1.0
                    a = min(1.0, f_y / max(f_x, 1e-12))
                    if f_x > 0 and a < 1.0:
                        w_old = (1.0 - a) / f_x
                        for qy, qx, rgb in spl_x:
                            fb[qy, qx] += rgb * w_old
                    if f_y > 0 and a > 0:
                        w_new = a / f_y
                        for qy, qx, rgb in spl_y:
                            fb[qy, qx] += rgb * w_new
                    if g.random() < a:
                        us[c] = up
                        cur[c] = (f_y, spl_y)
            img += fb * (b_sum / b_n) * (W * H) / (n_steps * n_chains)
        return img
