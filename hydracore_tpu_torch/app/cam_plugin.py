"""Host camera-rays plugin API: custom optics generate rays on the host.

The JAX package's app/cam_plugin.py (reference camera plugin interface
cam_plug/CamHostPluginAPI.h:54 IHostRaysAPI::MakeRaysBlock /
:64 AddSamplesContribution, SimpleCamPlugin.cpp, and its double-buffered
async pipeline GPUOCLLayer.cpp:1464-1483 DoCamPluginRays). The plugins are
numpy, copied; render_with_plugin traces each block with the port's path
tracer on the card, and keeps the pipeline's one-block latency: block b's
trace is queued on the card, block b + 1 is generated on the host
meanwhile, and block b is copied back only then.
"""
from __future__ import annotations

from typing import Protocol

import numpy as np
import torch


def _host(x) -> np.ndarray:
    """A camera field (tensor on any device, or numpy) as numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


class HostRaysPlugin(Protocol):
    """MakeRaysBlock / AddSamplesContribution contract."""

    def make_rays_block(self, block_size: int, pass_idx: int):
        """-> (ray_o (B,3) f32, ray_d (B,3) f32, pix (B,) i32)"""

    def add_samples_contribution(self, colors: np.ndarray, pix: np.ndarray):
        """Receive traced radiance for the block's rays."""


class SimplePinholePlugin:
    """Reference SimpleCamPlugin analogue: jittered pinhole rays on host."""

    def __init__(self, scene, seed: int = 777):
        self.scene = scene
        cam = scene.camera
        self.W, self.H = int(cam.width), int(cam.height)
        self.rng = np.random.default_rng(seed)
        self.fb = np.zeros((self.H * self.W, 3), np.float64)
        self.counts = np.zeros(self.H * self.W, np.int64)
        # host-side camera model
        self.proj_inv = _host(cam.mProjInv)
        self.view_inv = _host(cam.mWorldViewInv)
        self.pos = _host(cam.pos)

    def make_rays_block(self, block_size: int, pass_idx: int):
        R = self.H * self.W
        start = (pass_idx * block_size) % R
        pix = (np.arange(block_size) + start) % R
        px = (pix % self.W).astype(np.float32)
        py = (pix // self.W).astype(np.float32)
        jit = self.rng.random((block_size, 2)).astype(np.float32)
        x = (px + jit[:, 0]) / self.W * 2.0 - 1.0
        y = 1.0 - (py + jit[:, 1]) / self.H * 2.0
        ndc = np.stack([x, y, np.zeros_like(x), np.ones_like(x)], -1)
        pv = ndc @ self.proj_inv.T
        d_view = pv[:, :3] / np.maximum(np.abs(pv[:, 3:4]), 1e-12)
        d_view /= np.linalg.norm(d_view, axis=1, keepdims=True)
        d_world = d_view @ self.view_inv[:3, :3].T
        d_world /= np.linalg.norm(d_world, axis=1, keepdims=True)
        o = np.broadcast_to(self.pos, d_world.shape)
        return (o.astype(np.float32), d_world.astype(np.float32),
                pix.astype(np.int32))

    def add_samples_contribution(self, colors: np.ndarray, pix: np.ndarray):
        np.add.at(self.fb, pix, colors.astype(np.float64))
        np.add.at(self.counts, pix, 1)

    def image(self):
        return (self.fb / np.maximum(self.counts, 1)[:, None]) \
            .reshape(self.H, self.W, 3).astype(np.float32)


def render_with_plugin(scene, plugin: HostRaysPlugin, n_blocks: int,
                       block_size: int = 1 << 16, max_depth: int | None = None,
                       seed: int = 777, device=None):
    """Drive the plugin pipeline on `device` ("cuda" unless asked): host
    ray generation overlapped with device tracing (one-block latency, like
    the reference's pinned double-buffer + std::async). The rays of a block
    are keyed sample_idx = pix * 0x9E3779B9 ^ (b * 0x85EBCA6B mod 2^32)."""
    from hydracore_tpu_torch.integrators.pt import pt_trace
    from hydracore_tpu_torch.scene.scene import check_supported
    from hydracore_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    check_supported(scene)
    md = max_depth or scene.settings.trace_depth
    scene_d = scene.to(dev)
    has_alpha = bool(scene.settings.has_alpha) if scene.settings is not None else False

    pending = None  # (queued colors, pix): copied back one block late
    for b in range(n_blocks):
        o, d, pix = plugin.make_rays_block(block_size, b)
        sample_idx = (pix.astype(np.uint32) * np.uint32(0x9E3779B9)
                      ^ np.uint32((b * 0x85EBCA6B) & 0xFFFFFFFF))
        colors, _ = pt_trace(scene_d, torch.as_tensor(o, device=dev),
                             torch.as_tensor(d, device=dev),
                             torch.as_tensor(sample_idx.astype(np.int64),
                                             device=dev),
                             seed, max_depth=md, has_alpha=has_alpha)
        if pending is not None:
            pc, ppix = pending
            plugin.add_samples_contribution(pc.cpu().numpy(), ppix)
        pending = (colors, pix)  # queued: read back after the next block
    if pending is not None:
        pc, ppix = pending
        plugin.add_samples_contribution(pc.cpu().numpy(), ppix)
    return plugin


class TabulatedLensPlugin:
    """Tabulated multi-lens optics — the non-trivial HostRaysPlugin the
    plugin API exists to host (cam_plug/CamHostPluginAPI.h:26-70; the
    test_42 statefile carries a 12-surface fisheye table,
    <optical_system type="tabular">).

    Sequential spherical-surface ray tracing from the sensor through the
    element stack (the PBRT-style realistic-camera construction the
    reference's .dat tables come from): each line is one interface —
    curvature_radius (0 = aperture stop), thickness (axial distance to the
    next interface toward the sensor), ior (medium between this interface
    and the next), aperture_radius — listed scene-to-sensor. Rays start on
    the film plane, aim at the rear element, refract through every
    interface (Snell, vectorized numpy), and die on aperture clips or TIR
    (real vignetting). Dead rays resample next pass.

    optics: list of dicts or the statefile CameraDesc.optics payload."""

    def __init__(self, scene, optics, sensor_diagonal: float = 0.035,
                 seed: int = 777, film_dist: float | None = None):
        self.scene = scene
        cam = scene.camera
        self.W, self.H = int(cam.width), int(cam.height)
        self.rng = np.random.default_rng(seed)
        self.fb = np.zeros((self.H * self.W, 3), np.float64)
        self.counts = np.zeros(self.H * self.W, np.int64)
        self.view_inv = _host(cam.mWorldViewInv).astype(np.float64)
        self.pos = _host(cam.pos).astype(np.float64)
        # scene_to_sensor order: element 0 is the FRONT (scene-side) surface
        self.curv = np.array([e["curvature_radius"] for e in optics])
        self.thick = np.array([e["thickness"] for e in optics])
        self.eta = np.array([e["ior"] for e in optics])
        self.aper = np.array([e["aperture_radius"] for e in optics])
        asp = self.W / self.H
        diag = sensor_diagonal
        self.sensor_h = diag / np.sqrt(1.0 + asp * asp)
        self.sensor_w = self.sensor_h * asp
        # film sits film_dist behind the rear interface (default: the last
        # listed thickness, the usual .dat convention)
        self.film_dist = float(film_dist if film_dist is not None
                               else max(self.thick[-1], 1e-6))
        self.n_dead = 0
        self.n_rays = 0

    # lens space: film plane at z = 0, scene toward -z (camera view-space
    # convention). Interface i vertex at z_i = -(film_dist + sum of
    # thicknesses of interfaces BEHIND it, i.e. with larger index).
    def _element_z(self):
        # z_{N-1} = -film_dist (the last listed thickness IS the rear-to-
        # film gap); z_i = z_{i+1} - t_i toward the scene
        if len(self.thick) == 1:
            tail = np.array([0.0])
        else:
            tail = np.concatenate([np.cumsum(self.thick[:-1][::-1])[::-1],
                                   [0.0]])
        return -(self.film_dist + tail)

    def _trace_through(self, p, d):
        """p (B,3) on film (z=0), d (B,3) unit toward -z. Returns
        (o (B,3), d (B,3), alive (B,)) in lens space at the front."""
        zs = self._element_z()
        alive = np.ones(p.shape[0], bool)
        n_prev = np.ones(p.shape[0])  # medium behind the rear element: air
        for i in range(len(self.curv) - 1, -1, -1):
            r = self.curv[i]
            if abs(r) < 1e-12:  # aperture stop: flat clip, no refraction
                t = (zs[i] - p[:, 2]) / np.where(np.abs(d[:, 2]) < 1e-12,
                                                 1e-12, d[:, 2])
                hit = p + t[:, None] * d
                rad2 = hit[:, 0] ** 2 + hit[:, 1] ** 2
                alive &= (t > 0) & (rad2 <= self.aper[i] ** 2)
                p = np.where(alive[:, None], hit, p)
                continue  # the medium continues through a stop (ior 0)
            zc = zs[i] + r  # sphere center on the axis
            oc = p - np.array([0.0, 0.0, zc])
            b = np.sum(oc * d, axis=1)
            c = np.sum(oc * oc, axis=1) - r * r
            disc = b * b - c
            ok = disc >= 0.0
            sq = np.sqrt(np.maximum(disc, 0.0))
            # vertex-side intersection: closer root iff (d_z > 0) XOR (r < 0)
            closer = (d[:, 2] > 0) != (r < 0)
            t = np.where(closer, -b - sq, -b + sq)
            ok &= t > 1e-9
            hit = p + t[:, None] * d
            rad2 = hit[:, 0] ** 2 + hit[:, 1] ** 2
            ok &= rad2 <= self.aper[i] ** 2
            n_surf = (hit - np.array([0.0, 0.0, zc])) / r
            # orient normal against the ray
            flip = np.sum(n_surf * d, axis=1) > 0
            n_surf = np.where(flip[:, None], -n_surf, n_surf)
            # media: ray crosses interface i from medium n_prev into the
            # medium between i and i-1 (toward the scene); for i == 0 that
            # is air
            n_out = 1.0 if i == 0 else (self.eta[i - 1]
                                        if self.eta[i - 1] > 0 else 1.0)
            eta_rel = n_prev / n_out
            cos_i = -np.sum(n_surf * d, axis=1)
            sin2_t = eta_rel ** 2 * np.maximum(1.0 - cos_i ** 2, 0.0)
            tir = sin2_t >= 1.0
            cos_t = np.sqrt(np.maximum(1.0 - sin2_t, 0.0))
            d_new = (eta_rel[..., None] * d
                     + (eta_rel * cos_i - cos_t)[:, None] * n_surf)
            d_new /= np.maximum(np.linalg.norm(d_new, axis=1,
                                               keepdims=True), 1e-12)
            ok &= ~tir
            alive &= ok
            p = np.where(alive[:, None], hit, p)
            d = np.where(alive[:, None], d_new, d)
            n_prev = np.where(alive, n_out, n_prev)
        return p, d, alive

    def make_rays_block(self, block_size: int, pass_idx: int):
        R = self.H * self.W
        start = (pass_idx * block_size) % R
        pix = (np.arange(block_size) + start) % R
        px = (pix % self.W).astype(np.float64)
        py = (pix // self.W).astype(np.float64)
        jit = self.rng.random((block_size, 2))
        # film point (image inverted through the lens: flip both axes)
        fx = -((px + jit[:, 0]) / self.W - 0.5) * self.sensor_w
        fy = ((py + jit[:, 1]) / self.H - 0.5) * self.sensor_h
        p = np.stack([fx, fy, np.zeros_like(fx)], -1)
        # aim at a uniform point on the rear aperture disk
        u = self.rng.random((block_size, 2))
        rr = np.sqrt(u[:, 0]) * self.aper[-1]
        ph = 2.0 * np.pi * u[:, 1]
        rear = np.stack([rr * np.cos(ph), rr * np.sin(ph),
                         np.full(block_size, -self.film_dist)], -1)
        d = rear - p
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        o_l, d_l, alive = self._trace_through(p, d)
        self.n_rays += block_size
        self.n_dead += int((~alive).sum())
        # lens space == camera view space (film at the view origin, scene
        # toward -z); vignetted rays become degenerate no-hit rays
        o_w = o_l @ self.view_inv[:3, :3].T + self.pos
        d_w = d_l @ self.view_inv[:3, :3].T
        d_w /= np.maximum(np.linalg.norm(d_w, axis=1, keepdims=True), 1e-12)
        d_w = np.where(alive[:, None], d_w, np.array([[0.0, 0.0, 1.0]]))
        o_w = np.where(alive[:, None], o_w, self.pos + 1e9)
        return (o_w.astype(np.float32), d_w.astype(np.float32),
                np.where(alive, pix, -1).astype(np.int32))

    def add_samples_contribution(self, colors: np.ndarray, pix: np.ndarray):
        ok = pix >= 0
        np.add.at(self.fb, pix[ok], colors[ok].astype(np.float64))
        np.add.at(self.counts, pix[ok], 1)

    def image(self):
        return (self.fb / np.maximum(self.counts, 1)[:, None]) \
            .reshape(self.H, self.W, 3).astype(np.float32)
