"""Light tracing (LT): light-emitted paths connected to the camera (torch).

The JAX package's integrators/lt.py (ref forward path GPUOCLLayerCore.cpp:133
trace1D_Fwd + material.cl:147 ConnectToEyeKernel): per bounce every light
path vertex is connected to the eye with a shadow ray, projected to the
screen, and splatted. The camera importance factor follows
CameraImageToSurfaceFactor (cbidir.h:78): with the image plane at distance
  d_img = H / (2 tan(fov/2))
the surface-to-image measure conversion is
  factor = (d_img / cos_cam)^2 / cos_cam * |cos_x| / dist^2
and each vertex contributes T * f_adj * factor / n_paths to its pixel.

The light rays go to ops/trace_api.py:closest_hit as they come, unsorted,
and the camera connections to any_hit over the full pool, as in the JAX
package. The splat is a scatter-add with duplicates (many vertices land in
one pixel): index_add_, never fb[flat] += x, which would keep one of them.
The streams are keyed as the JAX package keys them (u32 arithmetic in
int64, ops/rng.py), so both trace the same paths.

With spans recording (utils/spans.py) a pass is the span `lt.pass`:
`lt.emit`, then one `lt.bounce` a depth, cut into `lt.shade`,
`lt.connect`, `lt.splat` and `lt.next`.
"""
from __future__ import annotations

import torch

from hydracore_tpu_torch.bsdf.core import (apply_bump, eval_bsdf,
                                           fetch_material, sample_bsdf,
                                           scene_feats)
from hydracore_tpu_torch.integrators.pt import compute_hit
from hydracore_tpu_torch.lights.sampling import sample_light_fwd, select_light
from hydracore_tpu_torch.ops import rng
from hydracore_tpu_torch.ops.trace_api import any_hit, closest_hit
from hydracore_tpu_torch.scene.scene import check_supported
from hydracore_tpu_torch.utils import spans
from hydracore_tpu_torch.utils.device import resolve_device
from hydracore_tpu_torch.utils.math3d import dot3, offs_ray_pos, sqrt

DG_LT_EMIT = 5
DG_LT_BSDF = 6
DG_LT_BLEND = 12  # distinct from DG_BD_* (7-11)


def _world_to_view(cam, p):
    """World point -> view space (camera at origin, looking down -Z)."""
    m = torch.linalg.inv(cam.mWorldViewInv)  # view matrix
    return p @ m[:3, :3].T + m[:3, 3]


@spans.spanned("lt.pass")
def _lt_pass(scene, pass_idx: int, seed: int, n_paths: int,
             max_depth: int) -> torch.Tensor:
    """lt_pass on a scene already on its device: the (H, W, 3) splat image
    of this pass."""
    spans.phase("lt.emit", within="lt.pass")
    cam = scene.camera
    W, H = cam.width, cam.height
    dev = scene.tri_attr.device
    tan_half = cam.mProjInv[1, 1]  # proj[1,1] = 1/tan(fovy/2)
    d_img = H / (2.0 * tan_half)  # image-plane distance in PIXEL units

    feats = scene_feats(scene)
    pidx = torch.arange(n_paths, dtype=torch.int64, device=dev)
    sample_idx = rng.mul32(pidx, 0x9E3779B9) ^ rng.mul32(
        rng.u32(pass_idx, dev), 0x85EBCA6B)

    r_e = rng.rand4(sample_idx, 0, DG_LT_EMIT, seed)
    l_idx, pick_prob = select_light(scene.lights, r_e[:, 3])
    ls = sample_light_fwd(scene, l_idx, r_e)

    # initial throughput: Le * cos / (pdfA * pdfW * pick)
    T = ls.radiance * (ls.cos_at_light / torch.clamp(
        ls.pdf_a * ls.pdf_w * pick_prob, min=1e-12))[:, None]
    ray_o = offs_ray_pos(ls.pos, ls.norm, ls.dir)
    ray_d = ls.dir
    alive = torch.ones((n_paths,), dtype=torch.bool, device=dev)

    fb = torch.zeros((H * W, 3), dtype=torch.float32, device=dev)

    # connect at depths 0..max_depth-2 so total path segments (light->x_1..
    # x_{d+1}->cam = d+2) stay within the budget PT covers (its NEE at
    # depth d yields d+2 segments and stops at max_depth-2 too)
    for depth in range(max_depth - 1):
        spans.phase("lt.bounce", within="lt.pass", depth=depth)
        t, tri, u, v = closest_hit(scene, ray_o, ray_d, active=alive)
        spans.phase("lt.shade", within="lt.bounce")
        alive = alive & (tri >= 0)
        pos, n, ng, uv, mat_id, _, tang = compute_hit(scene, tri, u, v,
                                                      ray_o, ray_d, t)
        p = fetch_material(scene, mat_id, uv, pos, n, wo=-ray_d,
                           u_blend=rng.rand1(sample_idx, depth, DG_LT_BLEND,
                                             seed))
        n = apply_bump(scene, p, n, tang, uv)
        # orient normals toward the incoming side (two-sided shading)
        n = torch.where(dot3(n, -ray_d)[:, None] >= 0.0, n, -n)
        ng = torch.where(dot3(ng, -ray_d)[:, None] >= 0.0, ng, -ng)

        # ---- connect to eye (ConnectToEyeKernel semantics)
        spans.phase("lt.connect", within="lt.bounce")
        to_cam = cam.pos - pos
        dist2 = torch.clamp(dot3(to_cam, to_cam), min=1e-12)
        dist = sqrt(dist2)
        w_cam = to_cam / dist[:, None]

        pv = _world_to_view(cam, pos)  # view space
        z = -pv[:, 2]
        in_front = z > 1e-4
        sx = pv[:, 0] / torch.clamp(z, min=1e-6) / (tan_half * W / H)
        sy = pv[:, 1] / torch.clamp(z, min=1e-6) / tan_half
        # floor (not an int cast): truncation toward zero would make the
        # 0-column/row a double-width splat bin
        fx = torch.floor((sx + 1.0) * 0.5 * W)
        fy = torch.floor((1.0 - sy) * 0.5 * H)
        on_screen = in_front & (fx >= 0) & (fx < W) & (fy >= 0) & (fy < H)

        f_adj, _ = eval_bsdf(p, -ray_d, w_cam, n, feats)
        cos_x = dot3(w_cam, n).abs()
        cos_cam = torch.clamp(z / dist, min=1e-6)  # angle at the pinhole
        img_factor = (d_img / cos_cam) ** 2 / cos_cam
        factor = img_factor * cos_x / dist2

        can = alive & on_screen & (cos_x > 0)
        sray_o = offs_ray_pos(pos, ng, w_cam)
        occluded = any_hit(scene, sray_o, w_cam, dist * 0.995, active=can)
        contrib = T * f_adj * (factor / n_paths)[:, None]
        contrib = torch.where((can & ~occluded)[:, None], contrib, 0.0)
        # off-screen and dead lanes (NaN coordinates too) add 0 to pixel 0
        spans.phase("lt.splat", within="lt.bounce")
        px = torch.where(can, fx, 0.0).to(torch.int64)
        py = torch.where(can, fy, 0.0).to(torch.int64)
        fb.index_add_(0, py * W + px, contrib)

        if depth == max_depth - 2:
            break

        # ---- next bounce
        spans.phase("lt.next", within="lt.bounce")
        r_b = rng.rand4(sample_idx, depth, DG_LT_BSDF, seed)
        bs = sample_bsdf(p, -ray_d, n, r_b, feats)
        T = T * bs.weight
        alive = alive & (T.amax(dim=-1) > 1e-7)
        n_off = torch.where(bs.is_transmission[:, None], -ng, ng)
        ray_o = offs_ray_pos(pos, n_off, bs.wi)
        ray_d = bs.wi

    return fb.reshape(H, W, 3)


def lt_pass(scene, pass_idx: int, seed: int, n_paths: int,
            max_depth: int = 5, device=None):
    """Trace n_paths light subpaths; returns ((H,W,3) splat image of THIS
    pass, paths traced) on `device` ("cuda" unless asked). Accumulate over
    passes and divide by their number."""
    dev = resolve_device(device)
    check_supported(scene)
    return _lt_pass(scene.to(dev), pass_idx, seed, n_paths,
                    max_depth), float(n_paths)


def render_lt(scene, n_passes: int, paths_per_pass: int | None = None,
              seed: int = 777, max_depth: int | None = None, device=None):
    """Accumulate LT passes -> (H, W, 3) estimate of the image PT renders
    (direct-from-light paths excluded: LT cannot see the camera ray hit the
    emitter), a tensor on `device` ("cuda" unless asked)."""
    dev = resolve_device(device)
    check_supported(scene)
    md = max_depth or scene.settings.trace_depth
    H, W = scene.camera.height, scene.camera.width
    n_paths = paths_per_pass or (W * H)
    scene = scene.to(dev)
    fb = torch.zeros((H, W, 3), dtype=torch.float32, device=dev)
    for i in range(n_passes):
        fb = fb + _lt_pass(scene, i, seed, n_paths, md)
    return fb / n_passes
