"""G-buffer evaluation and adaptive sampling (torch).

The JAX package's integrators/gbuffer.py (ref gbuffer pass
GPUOCLLayerOther.cpp:694 EvalGBuffer + material.cl:1347 GetGBufferSample):
anti-aliased primary rays per pixel produce depth / world normal / diffuse
texcolor / coverage / shadow / alpha layers, averaged over the subsamples
that hit, and matId / instId / canonical depth from the DOMINANT sample,
the subsample whose depth is the per-pixel median (the reference picks the
median-depth sample of GBUFFER_SAMPLES=64 Hammersley the same way).

render_adaptive is noise-driven adaptive sampling over production tiles
(integrators/pt.py): every pixel gets spp_base samples, pixels whose noise
estimate (noise_map) exceeds the threshold are topped up toward spp_max.
"""
from __future__ import annotations

import numpy as np
import torch

from hydracore_tpu_torch.bsdf.core import fetch_material
from hydracore_tpu_torch.integrators.pt import (_tile_production, compute_hit,
                                                make_eye_rays, shadow_trace)
from hydracore_tpu_torch.lights.sampling import sample_light_rev, select_light
from hydracore_tpu_torch.ops import rng
from hydracore_tpu_torch.ops.trace_api import closest_hit
from hydracore_tpu_torch.scene.scene import check_supported
from hydracore_tpu_torch.utils.device import resolve_device
from hydracore_tpu_torch.utils.math3d import dot3, offs_ray_pos


def _inst_ids(scene, tri, hit):
    """Instance id of each hit: the original desc.instances index. On an
    instanced scene `tri` is a slot whose cl_slot_tri2 row names the
    SYNTHETIC instance row, mapped through inst_orig (the flattened world,
    row 0, carries it per triangle in tri_inst), so objId masks match the
    flattened layout of the same desc."""
    if scene.settings.has_inst:
        s2 = scene.cl_slot_tri2
        row = s2[torch.clamp(tri.long(), 0, s2.shape[0] - 1)]
        tri_c = torch.clamp(row[:, 0].long(), 0, scene.tri_inst.shape[0] - 1)
        orig_kept = scene.inst_orig[torch.clamp(
            row[:, 1].long(), 0, scene.inst_orig.shape[0] - 1)]
        inst = torch.where(row[:, 1] == 0, scene.tri_inst[tri_c], orig_kept)
    else:
        tri_c = torch.clamp(tri.long(), 0, scene.tri_inst.shape[0] - 1)
        inst = scene.tri_inst[tri_c]
    return torch.where(hit, inst.to(torch.int32), -1)


def eval_gbuffer(scene, seed: int, n_samples: int = 4, device=None) -> dict:
    """Returns a dict of (H, W, ...) layers on `device` ("cuda" unless
    asked): depth, normal (3), texcolor (3), coverage, shadow, alpha,
    mat_id, inst_id, depth_center. Sample 0 takes the pixel centre; the
    texcolor is the material fetched without a position (no proc-tex
    modulation), as in the JAX package."""
    dev = resolve_device(device)
    check_supported(scene)
    scene = scene.to(dev)
    cam = scene.camera
    W, H = cam.width, cam.height
    R = W * H
    pix = torch.arange(R, dtype=torch.int64, device=dev)
    px, py = pix % W, pix // W

    depth_acc = torch.zeros((R,), dtype=torch.float32, device=dev)
    norm_acc = torch.zeros((R, 3), dtype=torch.float32, device=dev)
    tex_acc = torch.zeros((R, 3), dtype=torch.float32, device=dev)
    cover_acc = torch.zeros((R,), dtype=torch.float32, device=dev)
    shadow_acc = torch.zeros((R,), dtype=torch.float32, device=dev)
    alpha_acc = torch.zeros((R,), dtype=torch.float32, device=dev)
    t_all, mat_all, inst_all = [], [], []
    lens = torch.zeros((R, 2), dtype=torch.float32, device=dev)

    for s in range(n_samples):
        sample_idx = rng.mul32(pix, 0x9E3779B9) ^ s
        jitter = (rng.rand2(sample_idx, 0, 7, seed) if s > 0
                  else torch.full((R, 2), 0.5, device=dev))
        ray_o, ray_d = make_eye_rays(cam, px, py, jitter, lens)
        t, tri, u, v = closest_hit(scene, ray_o, ray_d)
        hit = tri >= 0
        pos, n, ng, uv, mat_id, _, _ = compute_hit(scene, tri, u, v, ray_o,
                                                   ray_d, t)
        p = fetch_material(scene, mat_id, uv)
        inst = _inst_ids(scene, tri, hit)

        depth_acc = depth_acc + torch.where(hit, t, 0.0)
        norm_acc = norm_acc + torch.where(hit[:, None], n, 0.0)
        tex_acc = tex_acc + torch.where(hit[:, None], p.diff_color, 0.0)
        cover_acc = cover_acc + hit.to(torch.float32)
        # shadow layer: NEE occlusion of the first hit (the gray first-
        # bounce shadow the reference packs to pathShadow8B,
        # material.cl:728-735), through the layered walk on alpha scenes;
        # the wavefront is in raster order, so the cluster route sorts it
        r_l = rng.rand4(sample_idx, 0, 12, seed)
        l_idx, _ = select_light(scene.lights, r_l[:, 3])
        ls = sample_light_rev(scene, l_idx, r_l[:, :3], pos)
        ngs = torch.where(dot3(ng, -ray_d)[:, None] >= 0.0, ng, -ng)
        sray_o = offs_ray_pos(pos, ngs, ls.dir)
        u_alpha = (r_l[:, 0] * 16777216.0).to(torch.int64)
        occ = shadow_trace(scene, sray_o, ls.dir, ls.dist, hit, u_alpha,
                           presorted=False)
        shadow_acc = shadow_acc + torch.where(hit & ~occ, 1.0, 0.0)
        # alpha layer: surface opacity at the hit (PutAlphaToGBuffer
        # analogue, material.cl:1475)
        alpha_acc = alpha_acc + torch.where(hit, p.opacity, 0.0)
        t_all.append(torch.where(hit, t, float("inf")))
        mat_all.append(torch.where(hit, mat_id, -1))
        inst_all.append(inst)

    # dominant sample = the depth-MEDIAN subsample (GetGBufferSample,
    # material.cl:1347): stable on edges where the centre sample flickers
    # between foreground and background. Ties go to the first subsample;
    # a pixel no subsample hit gives inf - inf = NaN, masked below.
    ts = torch.stack(t_all)  # (S, R), inf on miss -> sorts last
    ts_sorted = torch.sort(ts, dim=0).values
    hits = cover_acc.to(torch.int64)
    med_idx = torch.clamp(torch.div(hits - 1, 2, rounding_mode="floor"), min=0)
    t_med = torch.gather(ts_sorted, 0, med_idx[None, :])[0]
    s_star = torch.argmin((ts - t_med[None, :]).abs(), dim=0)
    mat_dom = torch.gather(torch.stack(mat_all), 0, s_star[None, :])[0]
    inst_dom = torch.gather(torch.stack(inst_all), 0, s_star[None, :])[0]
    any_hit_px = hits > 0
    mat_dom = torch.where(any_hit_px, mat_dom, -1)
    inst_dom = torch.where(any_hit_px, inst_dom, -1)
    t_dom = torch.where(any_hit_px, t_med, float("inf"))

    denom = torch.clamp(cover_acc, min=1.0)
    return {
        "depth": (depth_acc / denom).reshape(H, W),
        "normal": (norm_acc / denom[:, None]).reshape(H, W, 3),
        "texcolor": (tex_acc / denom[:, None]).reshape(H, W, 3),
        "coverage": (cover_acc / n_samples).reshape(H, W),
        "shadow": (shadow_acc / denom).reshape(H, W),
        "alpha": (alpha_acc / denom).reshape(H, W),
        "mat_id": mat_dom.reshape(H, W),
        "inst_id": inst_dom.reshape(H, W),
        "depth_center": t_dom.reshape(H, W),
    }


def noise_map(fb_sum, fb_sq_sum, n):
    """Per-pixel relative-variance estimate from accumulated sum and
    sum-of-squares images (the noise extraction of the reference's adaptive
    path, CPUExp_GBuffer.cpp / CPUExp_Integrators.h:227-234)."""
    n = torch.clamp(torch.as_tensor(n, dtype=torch.float32,
                                    device=fb_sum.device), min=1.0)
    mean = fb_sum / n
    var = torch.clamp(fb_sq_sum / n - mean * mean, min=0.0)
    lum_m = 0.2126 * mean[..., 0] + 0.7152 * mean[..., 1] + 0.0722 * mean[..., 2]
    lum_v = 0.2126 * var[..., 0] + 0.7152 * var[..., 1] + 0.0722 * var[..., 2]
    return torch.sqrt(lum_v) / torch.clamp(lum_m, min=1e-3)


def render_adaptive(scene, spp_base: int, spp_max: int, seed: int = 777,
                    max_depth: int | None = None, noise_threshold: float = 0.15,
                    tile_pixels: int = 16384, device=None) -> np.ndarray:
    """Noise-driven adaptive sampling on top of production tiles (ref
    MISPTLoop2Adapt + noise spreading, CPUExp_Integrators.h:450/227): every
    pixel gets rounds of K = min(spp_base, 32) samples (raster tiles of
    tile_pixels), then the pixels whose noise_map exceeds noise_threshold
    get ceil((spp_max - spp_base) / K) more rounds. The noisy set is padded
    to whole tiles with copies of its last id, and those duplicates add up
    (index_add_), counted exactly. Traces on `device` ("cuda" unless
    asked); returns the (H, W, 3) float32 numpy image."""
    dev = resolve_device(device)
    check_supported(scene)
    md = max_depth or scene.settings.trace_depth
    scene = scene.to(dev)
    H, W = scene.camera.height, scene.camera.width
    R = H * W

    # base pass: accumulate sum and sum-of-squares per pixel
    fb = torch.zeros((R, 3), dtype=torch.float32, device=dev)
    fb2 = torch.zeros((R, 3), dtype=torch.float32, device=dev)
    k = min(max(spp_base, 1), 32)
    rounds = -(-spp_base // k)
    for start in range(0, R, tile_pixels):
        ids = torch.arange(start, min(start + tile_pixels, R),
                           dtype=torch.int64, device=dev)
        for r in range(rounds):
            c, _ = _tile_production(scene, ids, r * k, seed, k, md)
            fb.index_add_(0, ids, c)
            fb2.index_add_(0, ids, c * c)
    n_base = float(rounds)
    noise = noise_map(fb.reshape(H, W, 3), fb2.reshape(H, W, 3),
                      n_base).reshape(-1).cpu().numpy()

    # top-up pass for noisy pixels
    counts = np.full(R, n_base, np.float32)
    noisy = np.where(noise > noise_threshold)[0]
    extra_rounds = max(int(np.ceil((spp_max - spp_base) / k)), 0)
    if len(noisy) and extra_rounds > 0:
        pad = (-len(noisy)) % tile_pixels
        noisy_p = np.concatenate([noisy, np.full(pad, noisy[-1])]) if pad else noisy
        for start in range(0, len(noisy_p), tile_pixels):
            ids = torch.as_tensor(noisy_p[start:start + tile_pixels]
                                  .astype(np.int64), device=dev)
            for r in range(extra_rounds):
                c, _ = _tile_production(scene, ids, (rounds + r) * k, seed, k,
                                        md)
                fb.index_add_(0, ids, c)
        # duplicate pad ids receive duplicate adds: count them exactly
        np.add.at(counts, noisy_p, float(extra_rounds))
    img = fb.cpu().numpy().reshape(H, W, 3) / counts.reshape(H, W, 1)
    return img.astype(np.float32)
