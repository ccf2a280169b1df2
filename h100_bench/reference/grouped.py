"""Ray casting over millions of world triangles: trace.py's
Moller-Trumbore, hit rule and box test, under an exact cull by boxes.

trace.Caster walks its per-object runs one by one in Python, which over a
scene of thousands of objects is thousands of steps a cast. Here the
triangles of each object are cut into leaves of up to LEAF consecutive
ones, and the leaves into levels of boxes, each box over FAN consecutive
boxes of the level below, up to a top level of at most TOP boxes. Every
box is the union of what it holds, widened by trace.chunks' margin rule
(1e-4 of its largest coordinate, plus 1e-6), so a ray that misses a box
meets no triangle in it: the cast descends, level by level, only into the
boxes a ray enters (trace._box against its t limit; for the closest hit
the best t found so far), and tests the triangles of the leaves it
reaches. The result is trace.Caster's: the nearest t, ties to the lowest
triangle index, (t, u, v) recomputed for the winner alone; any hit in
(1e-5, t_max) for occlusion.
"""
from __future__ import annotations

import numpy as np
import torch

from h100_bench.reference.trace import _box, _hit, _inv, mt

LEAF = 32  # triangles a leaf, all of one object
FAN = 8  # boxes of the level below a box holds
TOP = 64  # the top level holds at most this many boxes
PAIRS = 1 << 22  # (ray, box) tests or (ray, triangle) tests a batch
NONE = torch.iinfo(torch.int64).max


def _widen(lo: np.ndarray, hi: np.ndarray):
    """Boxes (N, 3) widened by trace.chunks' margin rule, box by box."""
    pad = 1e-4 * np.maximum(np.abs(lo).max(-1), np.abs(hi).max(-1)) + 1e-6
    return lo - pad[:, None], hi + pad[:, None]


class GroupedCaster:
    """Closest-hit and any-hit queries over a Flat description's
    triangles, on `device` in `dtype`, with the interface of
    trace.Caster."""

    def __init__(self, flat, device, dtype=torch.float32):
        def put(a):
            return torch.as_tensor(a, device=device).to(dtype)

        self.v0 = put(flat.v0)
        self.e1 = put(flat.v1 - flat.v0)
        self.e2 = put(flat.v2 - flat.v0)
        obj = flat.object_of
        T = obj.shape[0]
        cuts = np.flatnonzero(np.diff(obj)) + 1
        runs = list(zip(np.concatenate([[0], cuts]),
                        np.concatenate([cuts, [T]])))
        start = np.concatenate([np.arange(s, e, LEAF) for s, e in runs])
        end = np.concatenate([np.minimum(np.arange(s, e, LEAF) + LEAF, e)
                              for s, e in runs])
        count = end - start
        lo = np.minimum(np.minimum(flat.v0, flat.v1), flat.v2)
        hi = np.maximum(np.maximum(flat.v0, flat.v1), flat.v2)
        lo, hi = _widen(np.minimum.reduceat(lo, start, axis=0),
                        np.maximum.reduceat(hi, start, axis=0))
        levels = [(lo, hi)]
        while lo.shape[0] > TOP:
            g = np.arange(0, lo.shape[0], FAN)
            lo, hi = _widen(np.minimum.reduceat(lo, g, axis=0),
                            np.maximum.reduceat(hi, g, axis=0))
            levels.append((lo, hi))
        self.levels = [(put(a), put(b)) for a, b in reversed(levels)]
        self.start = torch.as_tensor(start, device=device)
        self.count = torch.as_tensor(count, device=device)
        self.lane = torch.arange(LEAF, device=device)
        self.fan = torch.arange(FAN, device=device)

    def _leaves(self, o, inv_d, lim, rays):
        """(rays, leaves) of every leaf box each ray of `rays` enters,
        batch by batch, depth first; `lim` (R,) is each ray's t limit,
        read at every test (a caller may lower it between batches)."""
        lo, hi = self.levels[0]
        n = lo.shape[0]
        step = max(1, PAIRS // n)
        for b in range(0, rays.numel(), step):
            r = rays[b:b + step].repeat_interleave(n)
            k = torch.arange(n, device=r.device).repeat(r.numel() // n)
            keep = _box(o[r], inv_d[r], lo[k], hi[k], lim[r])
            yield from self._descend(1, r[keep], k[keep], o, inv_d, lim)

    def _descend(self, level, r, k, o, inv_d, lim):
        if level == len(self.levels):
            yield r, k
            return
        lo, hi = self.levels[level]
        n = lo.shape[0]
        step = max(1, PAIRS // FAN)
        for b in range(0, r.numel(), step):
            kid = (k[b:b + step, None] * FAN + self.fan).reshape(-1)
            rr = r[b:b + step].repeat_interleave(FAN)
            real = kid < n
            kid, rr = kid[real], rr[real]
            keep = _box(o[rr], inv_d[rr], lo[kid], hi[kid], lim[rr])
            yield from self._descend(level + 1, rr[keep], kid[keep], o,
                                     inv_d, lim)

    def _tests(self, o, d, inv_d, lim, active):
        """(rays, triangle ids (P, LEAF), t, u, v, det) of the leaves the
        rays reach, batch by batch; ids past a leaf's end repeat its last
        triangle and are masked by `valid`."""
        for r, leaf in self._leaves(o, inv_d, lim,
                                    torch.nonzero(active)[:, 0]):
            step = max(1, PAIRS // LEAF)
            for b in range(0, r.numel(), step):
                rb, lb = r[b:b + step], leaf[b:b + step]
                valid = self.lane < self.count[lb, None]
                tri = self.start[lb, None] + torch.minimum(
                    self.lane, self.count[lb, None] - 1)
                t, u, v, det = mt(o[rb, None], d[rb, None], self.v0[tri],
                                  self.e1[tri], self.e2[tri])
                yield rb, tri, valid, t, u, v, det

    def closest(self, o, d, active):
        """(t (inf on a miss), triangle (-1), u, v) a ray."""
        R = o.shape[0]
        best = torch.full((R,), float("inf"), dtype=o.dtype, device=o.device)
        tri = torch.full((R,), NONE, dtype=torch.int64, device=o.device)
        inv_d = _inv(d)
        for r, ids, valid, t, u, v, det in self._tests(o, d, inv_d, best,
                                                       active):
            ok = valid & _hit(t, u, v, det, torch.full_like(t, float("inf")))
            t = torch.where(ok, t, float("inf"))
            tm = t.amin(dim=1)
            im = torch.where(ok & (t == tm[:, None]), ids, NONE).amin(dim=1)
            new = best.scatter_reduce(0, r, tm, "amin")
            tie = (tm == new[r]) & (tm < float("inf"))
            cand = torch.full_like(tri, NONE).scatter_reduce(
                0, r, torch.where(tie, im, NONE), "amin")
            tri = torch.where(new < best, cand, torch.minimum(tri, cand))
            best.copy_(new)
        hit = tri != NONE
        tri = torch.where(hit, tri, -1)
        k = torch.clamp(tri, min=0)
        t, u, v, _ = mt(o, d, self.v0[k], self.e1[k], self.e2[k])
        return (torch.where(hit, t, float("inf")), tri,
                torch.where(hit, u, 0.0), torch.where(hit, v, 0.0))

    def occluded(self, o, d, t_max, active):
        """True where some triangle lies in (1e-5, t_max) along the ray."""
        occ = torch.zeros_like(active)
        lim = t_max.clone()
        inv_d = _inv(d)
        for r, _, valid, t, u, v, det in self._tests(o, d, inv_d, lim,
                                                     active):
            got = (valid & _hit(t, u, v, det, t_max[r, None])).any(dim=1)
            occ[r[got]] = True
            lim[r[got]] = -float("inf")  # an occluded ray enters no box
        return occ
