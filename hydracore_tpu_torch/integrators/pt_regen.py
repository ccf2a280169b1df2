"""Path-regeneration wavefront PT (torch): the JAX package's
integrators/pt_regen.py.

The pass loop (pt.render_passes) advances every lane through max_depth
lockstep bounces; a lane whose path ended early (emitter hit, env miss,
Russian roulette) still rides every remaining stage. Here one persistent
R-lane wavefront runs until the sample set is spent: the moment a lane's
path dies it splats its radiance into the framebuffer and is refilled with
the next (pixel, pass) sample of a global counter, so every iteration
traces and shades mostly live segments, and the loop runs about
n_pass * (mean path length) * Npix / R iterations.

The sample set is the pass loop's: sample (pix, pass) keys the same
counter-RNG streams (sidx = pix * PHI ^ pass), each lane drawing at its own
depth, so the images agree to accumulation order. The loop carries every
per-lane state the pass loop does (alpha pass-through, Beer fog, the SSS
medium, the back-plate flag, the AO probes); render layers other than
'color' and caustics-off are refused by regen_supported and stay with the
pass loop.

Where the JAX package runs one lax.while_loop on the device, the port runs
a Python loop whose exit test (live lanes or samples left) is read back to
the host: on the card one iteration late, through a non-blocking copy and
an event, so the host keeps one iteration queued ahead of the device. An
iteration after the exit condition is a no-op (nothing is refilled, no
lane is alive, the splat adds zeros), so the image does not depend on when
the test is read.
"""
from __future__ import annotations

import numpy as np
import torch

from hydracore_tpu_torch.bsdf.core import (apply_bump, eval_bsdf,
                                           fetch_material, sample_bsdf,
                                           scene_feats)
from hydracore_tpu_torch.integrators.pt import (AO_PROBES, DG_ALPHA, DG_AO,
                                                DG_BSDF, DG_LIGHT, DG_RR,
                                                DG_SSS, MEGABLOCK,
                                                _morton_pixel_order,
                                                ao_probe, compute_hit,
                                                eye_rays, hg_sample,
                                                mis_weight, shadow_trace)
from hydracore_tpu_torch.lights.envmap import env_pdf_for_dir
from hydracore_tpu_torch.lights.sampling import (env_back_radiance,
                                                 env_radiance,
                                                 light_eval_pdf_from_hit,
                                                 light_rows,
                                                 sample_light_rev,
                                                 select_light)
from hydracore_tpu_torch.ops import rng
from hydracore_tpu_torch.ops.trace_api import (closest_hit, coherence_order,
                                               wants_sorted_rays)
from hydracore_tpu_torch.scene import materials as MC
from hydracore_tpu_torch.scene.lights import LIGHT_SKY
from hydracore_tpu_torch.scene.scene import check_supported
from hydracore_tpu_torch.utils.device import resolve_device
from hydracore_tpu_torch.utils.math3d import dot3, normalize3, offs_ray_pos


def regen_supported(scene) -> bool:
    """Static gate: the regenerating loop carries every per-lane state of
    the pass loop but the render-layer split and caustics-off."""
    st = scene.settings
    return st is None or (getattr(st, "render_layer", "color") == "color"
                          and getattr(st, "pt_caustics", True))


def render_passes_regen(scene, pass_base: int, seed: int, n_pass: int = 8,
                        max_depth: int = 5, min_rr_depth: int = 3,
                        lanes: int | None = None, device=None,
                        stats: dict | None = None):
    """n_pass full-frame passes with a regenerating wavefront of R = min(lanes
    or MEGABLOCK, Npix * n_pass) lanes (a small frame runs several passes
    abreast). Returns (sum of the n_pass samples of every pixel (H, W, 3)
    f32, rays traced (int64 scalar tensor)) on `device` ("cuda" unless
    asked). A `stats` dict receives the iterations run and the host syncs
    of the exit test."""
    dev = resolve_device(device)
    check_supported(scene)
    scene = scene.to(dev)
    cam = scene.camera
    W, H = cam.width, cam.height
    Npix = W * H
    R = min(lanes or MEGABLOCK, Npix * n_pass)
    total = Npix * n_pass
    morton = torch.as_tensor(_morton_pixel_order(W, H).astype(np.int64),
                             device=dev)

    st = scene.settings
    has_alpha = bool(st.has_alpha)
    has_sky_s = st.has_sky
    has_back = getattr(st, "has_env_back", False)
    has_fog = bool(st.has_fog)
    has_sss = bool(st.has_sss)
    has_proc_ao = bool(st.has_proc_ao)
    want_r_a = has_alpha or (st.has_blend and getattr(st, "blend_depth", 1) > 1)
    feats = scene_feats(scene)
    sorted_mode = wants_sorted_rays(scene)
    multi_light = scene.light_attr.shape[0] > 1
    clamp_hi = st.clamp
    if has_sky_s:
        sky_rows = scene.lights.ltype == LIGHT_SKY
        has_sky = sky_rows.any()
        sky_row = torch.argmax(sky_rows.to(torch.int32))
        cdf = scene.lights.pick_cdf
        sky_pick = torch.where(has_sky, cdf[sky_row + 1] - cdf[sky_row], 1.0)

    def rand(sidx, depth, group):
        return rng.rand4(sidx, depth, group, seed)

    f32, i64 = torch.float32, torch.int64

    def zeros(*shape, dtype=f32):
        return torch.zeros(shape, dtype=dtype, device=dev)

    next_ctr = zeros(dtype=i64)
    fb = zeros(Npix, 3)
    rays = zeros(dtype=i64)
    pix = zeros(R, dtype=i64)
    sidx = zeros(R, dtype=i64)
    depth = zeros(R, dtype=i64)
    ray_o, ray_d = zeros(R, 3), torch.ones((R, 3), dtype=f32, device=dev)
    tp, acc = zeros(R, 3), zeros(R, 3)
    prev_pdf = zeros(R)
    prev_spec = zeros(R, dtype=torch.bool)
    alive = zeros(R, dtype=torch.bool)
    if has_fog:
        fog_state = zeros(R, 4)
    if has_back:
        pure_t = zeros(R, dtype=torch.bool)
    if has_sss:
        in_med = zeros(R, dtype=torch.bool)
        med_sig_s, med_sig_a, med_g = zeros(R), zeros(R, 3), zeros(R)

    iterations = syncs = 0
    pending = None  # the previous iteration's exit flag on its way to the host
    while True:
        # ---- 1. regeneration: refill dead lanes with the next samples
        regen = ~alive
        rank = torch.cumsum(regen.to(i64), 0) - regen.to(i64)
        new_ctr = next_ctr + rank
        take = regen & (new_ctr < total)
        pix_n = morton[new_ctr % Npix]
        pass_n = (pass_base + new_ctr // Npix) & rng.M32
        eo, ed, sidx_n = eye_rays(cam, pix_n, pass_n, seed)
        take3 = take[:, None]
        pix = torch.where(take, pix_n, pix)
        sidx = torch.where(take, sidx_n, sidx)
        depth = torch.where(take, 0, depth)
        ray_o = torch.where(take3, eo, ray_o)
        ray_d = torch.where(take3, ed, ray_d)
        tp = torch.where(take3, 1.0, tp)
        acc = torch.where(take3, 0.0, acc)
        prev_pdf = torch.where(take, 0.0, prev_pdf)
        prev_spec = prev_spec | take  # the camera vertex counts as specular
        if has_fog:
            fog_state = torch.where(take3, 0.0, fog_state)
        if has_back:
            pure_t = pure_t | take
        if has_sss:
            in_med = in_med & ~take
            med_sig_s = torch.where(take, 0.0, med_sig_s)
            med_sig_a = torch.where(take3, 0.0, med_sig_a)
            med_g = torch.where(take, 0.0, med_g)
        alive = alive | take
        next_ctr = next_ctr + torch.minimum(regen.sum(), total - next_ctr)

        # ---- 2. coherence sort of the whole lane state (cluster route);
        # dead lanes take the largest key and go last
        if sorted_mode:
            perm = coherence_order(scene, ray_o, ray_d, alive)
            ray_o, ray_d, tp, acc = ray_o[perm], ray_d[perm], tp[perm], acc[perm]
            prev_pdf, prev_spec, alive = prev_pdf[perm], prev_spec[perm], alive[perm]
            sidx, pix, depth = sidx[perm], pix[perm], depth[perm]
            if has_fog:
                fog_state = fog_state[perm]
            if has_back:
                pure_t = pure_t[perm]
            if has_sss:
                in_med, med_sig_s = in_med[perm], med_sig_s[perm]
                med_sig_a, med_g = med_sig_a[perm], med_g[perm]

        # ---- 3. trace and shade one segment (pt.pt_trace's bounce body,
        # every lane at its own depth); liveness on entry, in this order
        was_alive = alive
        rays = rays + alive.sum()
        t, tri, u, v = closest_hit(scene, ray_o, ray_d, active=alive,
                                   kind="bounce")
        hit = alive & (tri >= 0)
        miss = alive & ~hit

        if has_fog:  # Beer fog over the segment just traced
            fog_on = hit & (fog_state[:, 3] > 0.0)
            seg = torch.where(torch.isfinite(t), t, 0.0)
            att = torch.exp(-torch.clamp(1.0 - fog_state[:, 0:3], min=0.0)
                            * (fog_state[:, 3] * seg)[:, None])
            tp = torch.where(fog_on[:, None], tp * att, tp)

        scat = None
        if has_sss:  # the SSS medium walk
            r_m = rand(sidx, depth, DG_SSS)
            t_srf = torch.where(torch.isfinite(t), t, 3e38)
            d_scat = -torch.log(torch.clamp(r_m[:, 0], min=1e-12)) \
                / torch.clamp(med_sig_s, min=1e-12)
            scat = alive & in_med & (med_sig_s > 0.0) & (d_scat < t_srf) & hit
            d_abs = torch.where(scat, d_scat, torch.clamp(t_srf, max=3e38))
            att = torch.exp(-med_sig_a * d_abs[:, None])
            tp = torch.where(((alive & in_med & hit) | scat)[:, None],
                             tp * att, tp)
            pos_scat = ray_o + d_scat[:, None] * ray_d
            hg_dir = normalize3(hg_sample(ray_d, med_g, r_m[:, 1], r_m[:, 2]))
            alive = alive & ~(in_med & miss)
            miss = miss & ~in_med

        if has_sky_s:  # env and back plate
            env = env_radiance(scene, ray_d)
            env_pdf = env_pdf_for_dir(scene.env_rows_cdf, scene.env_cols_cdf,
                                      scene.env_pdf_uv, ray_d)
            w_env = torch.where(prev_spec | ~has_sky, 1.0,
                                mis_weight(prev_pdf, env_pdf * sky_pick))
            env_c = env * w_env[:, None]
            if has_back:
                env_c = torch.where(pure_t[:, None],
                                    env_back_radiance(scene, ray_d), env_c)
            acc = acc + torch.where(miss[:, None], tp * env_c, 0.0)
        alive = alive & hit

        pos, n, ng, uv, mat_id, tri_light, tang = compute_hit(
            scene, tri, u, v, ray_o, ray_d, t)
        wo = -ray_d
        r_a = rand(sidx, depth, DG_ALPHA) if want_r_a else None
        ao_val = None
        if has_proc_ao:
            arow = scene.mat_attr[torch.clamp(mat_id.long(), 0,
                                              scene.mat_attr.shape[0] - 1)]
            ao_t = arow[:, MC.MA_AO_TYPE].to(torch.int32)
            need_ao = alive & (ao_t > 0)
            rays = rays + need_ao.sum() * AO_PROBES
            ao_val = ao_probe(scene, pos, n, ng, ao_t, arow[:, MC.MA_AO_LENGTH],
                              need_ao, rand(sidx, depth, DG_AO))
        p = fetch_material(scene, mat_id, uv, pos, n, wo=wo,
                           u_blend=None if r_a is None else r_a[:, 1],
                           ao=ao_val)
        n = apply_bump(scene, p, n, tang, uv)
        passthru = None
        if has_alpha:
            passthru = alive & (p.opacity < 0.999) & (r_a[:, 0] >= p.opacity)
            if has_sss:
                passthru = passthru & ~scat

        # one light-row fetch for the implicit-hit MIS eval and the NEE
        # sample; every lane draws DG_LIGHT (depth is per lane)
        lrow = torch.clamp(tri_light, 0, scene.lights.ltype.shape[0] - 1)
        r_l = rand(sidx, depth, DG_LIGHT)
        l_idx, _ = select_light(scene.lights, r_l[:, 3])
        rows_hit = rows_nee = None
        if multi_light:
            rows_hit = light_rows(scene, lrow)
            rows_nee = light_rows(scene, l_idx)

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
        acc = acc + torch.where((is_emitter & front)[:, None],
                                tp * p.em_color * w_li[:, None], 0.0)
        alive = alive & ~is_emitter
        # the last bounce collects env and emitters only
        alive = alive & (depth < max_depth - 1)

        # ---- NEE
        ns = torch.where(dot3(n, wo)[:, None] >= 0.0, n, -n)
        ngs = torch.where(dot3(ng, wo)[:, None] >= 0.0, ng, -ng)
        ls = sample_light_rev(scene, l_idx, r_l[:, :3], pos, rows=rows_nee)
        pick_prob = ls.pick_prob
        sray_o = offs_ray_pos(pos, ngs, ls.dir)
        f, pdf_fwd = eval_bsdf(p, wo, ls.dir, ns, feats)
        cos_s = dot3(ls.dir, ns).abs()
        w_l = torch.where(ls.is_delta, 1.0,
                          mis_weight(ls.pdf_w * pick_prob, pdf_fwd))
        contrib = (tp * f * ls.radiance
                   * (cos_s * w_l / torch.clamp(ls.pdf_w * pick_prob, min=1e-12))[:, None])
        ok = alive & (cos_s > 0.0)
        if has_alpha:
            ok = ok & ~passthru
        if has_sss:
            ok = ok & ~scat
        need_sh = ok & (contrib.amax(dim=-1) > 0.0)
        rays = rays + need_sh.sum()
        u_sh = (r_l[:, 0] * 16777216.0).to(torch.int64) if has_alpha else None
        occluded = shadow_trace(scene, sray_o, ls.dir, ls.dist, need_sh, u_sh)
        acc = acc + torch.where((need_sh & ~occluded)[:, None], contrib, 0.0)

        # ---- next bounce: BSDF sample, state machines, RR
        bs = sample_bsdf(p, wo, ns, rand(sidx, depth, DG_BSDF), feats)
        wi, weight, prev_pdf, prev_spec = bs.wi, bs.weight, bs.pdf, bs.is_specular
        through = bs.is_transmission
        if has_alpha:
            wi = torch.where(passthru[:, None], ray_d, wi)
            weight = torch.where(passthru[:, None], 1.0, weight)
            prev_pdf = torch.where(passthru, 0.0, prev_pdf)
            prev_spec = prev_spec | passthru
            through = through | passthru
        if has_back:
            pure_t = pure_t & through
            if has_sss:
                pure_t = pure_t & ~scat
        if has_fog:  # arm on entry, clear on exit
            beer = alive & (p.fog_mult > 0.0)
            if has_alpha:
                beer = beer & ~passthru
            enter = beer & bs.is_transmission & front
            leave = beer & bs.is_transmission & ~front
            armed = torch.cat([p.fog_color, p.fog_mult[:, None]], 1)
            fog_state = torch.where(enter[:, None], armed,
                                    torch.where(leave[:, None], 0.0, fog_state))
        if has_sss:  # the SSS boundary: the translucency lobe crosses it
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
        tp = tp * weight

        # Russian roulette from min_rr_depth (each lane's own depth)
        q = torch.clamp(tp.amax(dim=-1), 0.05, 1.0)
        u_rr = rand(sidx, depth, DG_RR)[:, 0]
        rr_on = depth >= min_rr_depth
        tp = torch.where(rr_on[:, None], tp / q[:, None], tp)
        alive = alive & ~(rr_on & (u_rr >= q)) & (tp.amax(dim=-1) > 1e-7)

        n_off = torch.where(through[:, None], -ngs, ngs)
        ray_o = offs_ray_pos(pos, n_off, wi)
        if has_sss:  # scattered lanes go on from inside the medium
            ray_o = torch.where(scat[:, None], pos_scat, ray_o)
            wi = torch.where(scat[:, None], hg_dir, wi)
            prev_spec = prev_spec | scat
            prev_pdf = torch.where(scat, 0.0, prev_pdf)
        ray_d = wi
        depth = depth + 1

        # ---- 4. death splat: finished samples add their clamped radiance;
        # a pixel may be held by several lanes, so the add accumulates
        dying = was_alive & ~alive
        fb.index_add_(0, pix, torch.where(dying[:, None],
                                          torch.clamp(acc, 0.0, clamp_hi), 0.0))

        iterations += 1
        live = alive.any() | (next_ctr < total)
        if dev.type != "cuda":
            if not bool(live):
                break
            continue
        flag = live.to("cpu", non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        if pending is not None:
            pending[1].synchronize()
            syncs += 1
            if not bool(pending[0]):
                break
        pending = (flag, done)
    if stats is not None:
        stats.update(iterations=iterations, host_syncs=syncs)
    return fb.reshape(H, W, 3), rays
