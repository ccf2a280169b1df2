"""Brute-force ray casting over world triangles.

Every triangle is tested by Moller-Trumbore (a hit needs |det| > 1e-12,
u, v >= 0, u + v <= 1 and 1e-5 < t < t_max); triangles are taken in runs
of up to CHUNK consecutive ones of one object, and a run is tested only by
the rays that enter its box (widened by a small margin, so that no ray
the triangle test accepts is culled). The closest hit's (t, u, v) are
recomputed for the winning triangle alone.
"""
from __future__ import annotations

import numpy as np
import torch

CHUNK = 1024
PAIRS = 1 << 24  # ray x triangle pairs a batch holds


def cross3(a, b):
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([ay * bz - az * by, az * bx - ax * bz,
                        ax * by - ay * bx], dim=-1)


def chunks(object_of: np.ndarray, v0, v1, v2):
    """[(start, end, box min, box max)] over runs of one object."""
    out = []
    T = object_of.shape[0]
    cuts = np.flatnonzero(np.diff(object_of)) + 1
    starts = np.concatenate([[0], cuts])
    ends = np.concatenate([cuts, [T]])
    for s0, e0 in zip(starts, ends):
        for s in range(int(s0), int(e0), CHUNK):
            e = min(s + CHUNK, int(e0))
            pts = np.concatenate([v0[s:e], v1[s:e], v2[s:e]])
            lo, hi = pts.min(0), pts.max(0)
            pad = 1e-4 * np.maximum(np.abs(lo).max(), np.abs(hi).max()) + 1e-6
            out.append((s, e, lo - pad, hi + pad))
    return out


def mt(o, d, v0, e1, e2):
    """(t, u, v, det) of rays (..., 3) against triangles (..., 3)."""
    p = cross3(d, e2)
    det = (e1 * p).sum(-1)
    inv = torch.where(det.abs() > 1e-12,
                      1.0 / torch.where(det == 0.0, 1.0, det), 0.0)
    s = o - v0
    u = (s * p).sum(-1) * inv
    q = cross3(s, e1)
    v = (d * q).sum(-1) * inv
    t = (e2 * q).sum(-1) * inv
    return t, u, v, det


def _hit(t, u, v, det, t_max):
    return ((det.abs() > 1e-12) & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
            & (t > 1e-5) & (t < t_max))


def _box(o, inv_d, lo, hi, t_max):
    t0 = (lo - o) * inv_d
    t1 = (hi - o) * inv_d
    tn = torch.minimum(t0, t1).amax(-1)
    tf = torch.maximum(t0, t1).amin(-1)
    return (tf >= torch.clamp(tn, min=0.0)) & (tn < t_max)


def _inv(d):
    eps = 1e-12
    return 1.0 / torch.where(d.abs() < eps, torch.where(d < 0, -eps, eps), d)


class Caster:
    """Closest-hit and any-hit queries over a Flat description's
    triangles, on `device` in `dtype`."""

    def __init__(self, flat, device, dtype=torch.float32):
        def put(a):
            return torch.as_tensor(a, device=device).to(dtype)

        self.v0 = put(flat.v0)
        self.e1 = put(flat.v1 - flat.v0)
        self.e2 = put(flat.v2 - flat.v0)
        self.runs = [(s, e, put(lo), put(hi)) for s, e, lo, hi in
                     chunks(flat.object_of, flat.v0, flat.v1, flat.v2)]

    def _batches(self, idx, width):
        step = max(1, PAIRS // max(width, 1))
        for b in range(0, idx.shape[0], step):
            yield idx[b:b + step]

    def closest(self, o, d, active):
        """(t (inf on a miss), triangle (-1), u, v) a ray."""
        R = o.shape[0]
        t_best = torch.full((R,), float("inf"), dtype=o.dtype,
                            device=o.device)
        tri = torch.full((R,), -1, dtype=torch.int64, device=o.device)
        inv_d = _inv(d)
        for s, e, lo, hi in self.runs:
            cand = active & _box(o, inv_d, lo, hi, t_best)
            for ib in self._batches(torch.nonzero(cand)[:, 0], e - s):
                t, u, v, det = mt(o[ib, None], d[ib, None], self.v0[None, s:e],
                                  self.e1[None, s:e], self.e2[None, s:e])
                t = torch.where(_hit(t, u, v, det, t_best[ib, None]), t,
                                float("inf"))
                tm, am = t.min(dim=1)
                better = tm < t_best[ib]
                t_best[ib] = torch.where(better, tm, t_best[ib])
                tri[ib] = torch.where(better, am + s, tri[ib])
        hit = tri >= 0
        k = torch.clamp(tri, min=0)
        t, u, v, _ = mt(o, d, self.v0[k], self.e1[k], self.e2[k])
        return (torch.where(hit, t, float("inf")), tri,
                torch.where(hit, u, 0.0), torch.where(hit, v, 0.0))

    def occluded(self, o, d, t_max, active):
        """True where some triangle lies in (1e-5, t_max) along the ray."""
        occ = torch.zeros_like(active)
        inv_d = _inv(d)
        for s, e, lo, hi in self.runs:
            cand = active & ~occ & _box(o, inv_d, lo, hi, t_max)
            for ib in self._batches(torch.nonzero(cand)[:, 0], e - s):
                t, u, v, det = mt(o[ib, None], d[ib, None], self.v0[None, s:e],
                                  self.e1[None, s:e], self.e2[None, s:e])
                occ[ib] = _hit(t, u, v, det, t_max[ib, None]).any(dim=1)
        return occ
