"""Binned-SAH BVH builder (host side, numpy): the port's own copy of the
JAX package's bvh/builder.py, so both build the same tree.

A single-level world-space BVH2 with explicit child indices; leaves cover
(start, count) ranges of a REORDERED triangle array. The native C++ builder
(bvh/native.py) has the same output ABI and is preferred when g++ exists.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

N_BINS = 16
MAX_LEAF = 4
TRAVERSAL_COST = 1.0
INTERSECT_COST = 1.0


@dataclass
class FlatBVH:
    """SoA flat BVH. Internal node: count == 0, left/right = child indices.
    Leaf: count > 0, left = first triangle, right unused (=-1)."""

    bmin: np.ndarray  # (N,3) float32
    bmax: np.ndarray  # (N,3) float32
    left: np.ndarray  # (N,) int32
    right: np.ndarray  # (N,) int32
    count: np.ndarray  # (N,) int32
    perm: np.ndarray  # (T,) int32 — new order -> original triangle index

    @property
    def num_nodes(self) -> int:
        return int(self.bmin.shape[0])


def build_bvh(v0: np.ndarray, v1: np.ndarray, v2: np.ndarray, max_leaf: int = MAX_LEAF) -> FlatBVH:
    """Build over triangles given by three (T,3) vertex arrays."""
    T = v0.shape[0]
    if T == 0:
        z = np.zeros((1, 3), np.float32)
        return FlatBVH(z, z, np.array([0], np.int32), np.array([-1], np.int32),
                       np.array([0], np.int32), np.zeros(0, np.int32))

    tb_min = np.minimum(np.minimum(v0, v1), v2).astype(np.float32)
    tb_max = np.maximum(np.maximum(v0, v1), v2).astype(np.float32)
    centroid = (tb_min + tb_max) * 0.5

    order = np.arange(T, dtype=np.int32)

    bmins, bmaxs, lefts, rights, counts = [], [], [], [], []

    def new_node():
        bmins.append(np.zeros(3, np.float32))
        bmaxs.append(np.zeros(3, np.float32))
        lefts.append(-1)
        rights.append(-1)
        counts.append(0)
        return len(bmins) - 1

    # iterative top-down build, explicit stack of (node_idx, start, end)
    root = new_node()
    stack = [(root, 0, T)]
    while stack:
        node, start, end = stack.pop()
        idx = order[start:end]
        nb_min = tb_min[idx].min(axis=0)
        nb_max = tb_max[idx].max(axis=0)
        bmins[node], bmaxs[node] = nb_min, nb_max
        n = end - start
        if n <= max_leaf:
            lefts[node], counts[node] = start, n
            continue

        c = centroid[idx]
        c_min, c_max = c.min(axis=0), c.max(axis=0)
        extent = c_max - c_min
        axis = int(np.argmax(extent))
        if extent[axis] <= 1e-12:
            # degenerate spread: median split
            mid = start + n // 2
            _split_children(node, start, mid, end, new_node, lefts, rights, stack)
            continue

        # binned SAH on the widest axis
        scale = N_BINS * (1.0 - 1e-6) / extent[axis]
        bins = np.minimum(((c[:, axis] - c_min[axis]) * scale).astype(np.int32), N_BINS - 1)
        bin_count = np.bincount(bins, minlength=N_BINS)
        bin_bmin = np.full((N_BINS, 3), np.inf, np.float32)
        bin_bmax = np.full((N_BINS, 3), -np.inf, np.float32)
        np.minimum.at(bin_bmin, bins, tb_min[idx])
        np.maximum.at(bin_bmax, bins, tb_max[idx])

        # sweep: SAH cost per split position
        def accum(cmins, cmaxs, cnts):
            am = np.minimum.accumulate(cmins, axis=0)
            aM = np.maximum.accumulate(cmaxs, axis=0)
            ac = np.cumsum(cnts)
            d = np.maximum(aM - am, 0.0)
            area = d[:, 0] * d[:, 1] + d[:, 1] * d[:, 2] + d[:, 2] * d[:, 0]
            return area, ac

        areaL, cntL = accum(bin_bmin, bin_bmax, bin_count)
        areaR, cntR = accum(bin_bmin[::-1], bin_bmax[::-1], bin_count[::-1])
        areaR, cntR = areaR[::-1], cntR[::-1]
        cost = areaL[:-1] * cntL[:-1] + areaR[1:] * cntR[1:]
        valid = (cntL[:-1] > 0) & (cntR[1:] > 0)
        if not valid.any():
            mid = start + n // 2
            _split_children(node, start, mid, end, new_node, lefts, rights, stack)
            continue
        cost = np.where(valid, cost, np.inf)
        best = int(np.argmin(cost))

        # leaf cost check
        d = np.maximum(nb_max - nb_min, 0.0)
        node_area = max(d[0] * d[1] + d[1] * d[2] + d[2] * d[0], 1e-12)
        split_cost = TRAVERSAL_COST + INTERSECT_COST * cost[best] / node_area
        if split_cost >= INTERSECT_COST * n and n <= 2 * max_leaf:
            lefts[node], counts[node] = start, n
            continue

        go_left = bins <= best
        li, ri = idx[go_left], idx[~go_left]
        mid = start + len(li)
        order[start:mid], order[mid:end] = li, ri
        _split_children(node, start, mid, end, new_node, lefts, rights, stack)

    return FlatBVH(
        bmin=np.asarray(bmins, np.float32),
        bmax=np.asarray(bmaxs, np.float32),
        left=np.asarray(lefts, np.int32),
        right=np.asarray(rights, np.int32),
        count=np.asarray(counts, np.int32),
        perm=order,
    )


def _split_children(node, start, mid, end, new_node, lefts, rights, stack):
    l = new_node()
    r = new_node()
    lefts[node], rights[node] = l, r
    # push larger child first so smaller ranges finish early (stack locality)
    stack.append((l, start, mid))
    stack.append((r, mid, end))



# ----------------------------------------------------------------------------
# Reference brute-force intersector (oracle for traversal tests)
# ----------------------------------------------------------------------------

def brute_force_closest_hit(ray_o, ray_d, v0, e1, e2, t_max=1e30):
    """Numpy Möller–Trumbore over all triangles; returns (t, tri_id, u, v).
    Oracle analogue of IBVHBuilder2::RayTrace (IBVHBuilderAPI.h:65)."""
    ray_o = np.asarray(ray_o, np.float32)[:, None, :]  # (R,1,3)
    ray_d = np.asarray(ray_d, np.float32)[:, None, :]
    v0 = v0[None]
    e1 = e1[None]
    e2 = e2[None]
    p = np.cross(ray_d, e2)
    det = (e1 * p).sum(-1)
    inv = np.where(np.abs(det) > 1e-12, 1.0 / np.where(det == 0, 1, det), 0.0)
    s = ray_o - v0
    u = (s * p).sum(-1) * inv
    q = np.cross(s, e1)
    v = (ray_d * q).sum(-1) * inv
    t = (e2 * q).sum(-1) * inv
    hit = (np.abs(det) > 1e-12) & (u >= 0) & (v >= 0) & (u + v <= 1) & (t > 1e-5) & (t < t_max)
    t = np.where(hit, t, np.inf)
    tri = np.argmin(t, axis=1)
    rr = np.arange(t.shape[0])
    tbest = t[rr, tri]
    return (
        np.where(np.isfinite(tbest), tbest, np.inf),
        np.where(np.isfinite(tbest), tri, -1),
        u[rr, tri],
        v[rr, tri],
    )


def bvh_stats(bvh: FlatBVH) -> dict:
    """Structural statistics — the PrintBVHStat analogue
    (RenderDriverRTE_DebugBVH.cpp)."""
    leaf = bvh.count > 0
    n_leaf = int(leaf.sum())
    # compute depths by DFS from the root (parents are not stored)
    depth = {0: 0}
    stack = [0]
    max_depth = 0
    while stack:
        n = stack.pop()
        if bvh.count[n] == 0:
            for c in (int(bvh.left[n]), int(bvh.right[n])):
                depth[c] = depth[n] + 1
                max_depth = max(max_depth, depth[c])
                stack.append(c)
    d = np.maximum(bvh.bmax - bvh.bmin, 0.0)
    sa = d[:, 0] * d[:, 1] + d[:, 1] * d[:, 2] + d[:, 2] * d[:, 0]
    return {
        "nodes": bvh.num_nodes,
        "leaves": n_leaf,
        "tris": int(bvh.count[leaf].sum()),
        "max_leaf": int(bvh.count.max()) if bvh.num_nodes else 0,
        "avg_leaf": float(bvh.count[leaf].mean()) if n_leaf else 0.0,
        "max_depth": max_depth,
        "sah_cost": float((sa[leaf] * bvh.count[leaf]).sum() / max(sa[0], 1e-9)),
    }
