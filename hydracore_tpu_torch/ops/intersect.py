"""Ray-triangle primitives (torch, vectorized over rays x triangles).

The JAX package's ops/intersect.py: branch-free masked Moller-Trumbore, the
ray-box slab test and the exact (t, u, v) refinement the traversal epilogue
runs per hit.
"""
from __future__ import annotations

import torch

from hydracore_tpu_torch.utils.math3d import cross3

HIT_EPS = 1e-5


def moller_trumbore(ray_o, ray_d, v0, e1, e2, t_min=HIT_EPS, t_max=1e30):
    """Intersect rays (..., 3) against triangles (..., 3) elementwise on the
    broadcast shape. Returns (t, u, v, hit_mask); t=inf on miss."""
    p = cross3(ray_d, e2)
    det = (e1 * p).sum(-1)
    ok = det.abs() > 1e-12
    inv = torch.where(ok, 1.0 / torch.where(det == 0.0, 1.0, det), 0.0)
    s = ray_o - v0
    u = (s * p).sum(-1) * inv
    q = cross3(s, e1)
    v = (ray_d * q).sum(-1) * inv
    t = (e2 * q).sum(-1) * inv
    hit = ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > t_min) & (t < t_max)
    return torch.where(hit, t, float("inf")), u, v, hit


def safe_inv(d):
    """1 / d with |d| held at 1e-12 or more (the sign kept), so an
    axis-parallel ray divides by no zero in a slab test."""
    eps = 1e-12
    return 1.0 / torch.where(d.abs() < eps, torch.where(d < 0, -eps, eps), d)


def ray_args(ray_o, t_max, active):
    """A traversal's per-ray arguments in full: t_max broadcast to (R,) f32
    and `active` all True where the caller gave None."""
    R, dev = ray_o.shape[0], ray_o.device
    if active is None:
        active = torch.ones((R,), dtype=torch.bool, device=dev)
    tm = torch.broadcast_to(
        torch.as_tensor(t_max, dtype=torch.float32, device=dev), (R,))
    return tm, active


def ray_box(ray_o, inv_d, bmin, bmax, t_max):
    """Slab test. ray_o/inv_d (...,3), boxes (...,3). Returns (t_near, hit)."""
    t0 = (bmin - ray_o) * inv_d
    t1 = (bmax - ray_o) * inv_d
    tn = torch.minimum(t0, t1).amax(dim=-1)
    tf = torch.maximum(t0, t1).amin(dim=-1)
    hit = (tf >= torch.clamp(tn, min=0.0)) & (tn < t_max)
    return tn, hit


def want_double(scene) -> bool:
    """True when the scene asked for f64 hit refinement (-double_rt, the
    reference's -D DOUBLE_RAY_TRIANGLE variant)."""
    st = getattr(scene, "settings", None)
    return bool(st is not None and getattr(st, "double_rt", False))


def mt_refine(ray_o, ray_d, v0, e1, e2, f64: bool = False):
    """Exact (t, u, v) for paired rays/triangles (..., 3) — no hit logic,
    the caller owns validity. With f64 the arithmetic runs in float64 and
    rounds back to f32 (the -double_rt refinement)."""
    if f64:
        ray_o, ray_d, v0, e1, e2 = (x.to(torch.float64)
                                    for x in (ray_o, ray_d, v0, e1, e2))
    p = cross3(ray_d, e2)
    det = (e1 * p).sum(-1)
    eps = 1e-24 if f64 else 1e-12
    inv = torch.where(det.abs() > eps,
                      1.0 / torch.where(det == 0.0, 1.0, det), 0.0)
    s = ray_o - v0
    u = (s * p).sum(-1) * inv
    q = cross3(s, e1)
    v = (ray_d * q).sum(-1) * inv
    t = (e2 * q).sum(-1) * inv
    return t.to(torch.float32), u.to(torch.float32), v.to(torch.float32)
