"""Dense small-scene traversal: brute force over the padded triangle slots.

The JAX package's ops/traverse_dense.py in plain PyTorch (it is XLA code
there, not a kernel). Below a few hundred triangles a tree costs more than
intersecting every ray with every triangle slot in dense (rays x slots)
tensor math. The dispatcher (ops/trace_api.py) picks this path by scene
size; with settings.double_rt the whole Moller-Trumbore runs in float64.

Eager PyTorch materialises every (rays x slots) temporary that XLA fuses
away, so the rays go through in slices of a bounded number of elements, and
only the active ones: a dead ray's answer is a miss whatever is computed
for it.
"""
from __future__ import annotations

import torch

from hydracore_tpu_torch.bvh.wide import LEAF_SIZE
from hydracore_tpu_torch.ops.intersect import ray_args, want_double

DENSE_MAX_TRIS = 512  # single-shot threshold; blocked path above
BLOCK_SLOTS = 2048  # triangle slots per dense block
# rays x slots elements of one slice's temporaries: cache-sized on the CPU,
# 64 MiB each on the card (fewer, larger launches)
STEP_ELEMS = 1 << 20
STEP_ELEMS_CUDA = 1 << 24
BIG = 3.0e38


def _mt_block(tri, o, d, t_cap):
    """Dense Moller-Trumbore of n rays against one (16, S) field-major block.
    Returns (t_k, u_k, v_k, k) per ray: the nearest hit below t_cap (3e38
    when none) and its slot within the block, the first among equal t."""
    v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z = (tri[f][None] for f in range(9))
    ox, oy, oz = o[:, 0:1], o[:, 1:2], o[:, 2:3]
    dx, dy, dz = d[:, 0:1], d[:, 1:2], d[:, 2:3]
    px = dy * e2z - dz * e2y
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    det = e1x * px + e1y * py + e1z * pz
    inv = torch.where(det.abs() > 1e-12,
                      1.0 / torch.where(det == 0.0, 1.0, det), 0.0)
    sx, sy, sz = ox - v0x, oy - v0y, oz - v0z
    u = (sx * px + sy * py + sz * pz) * inv
    qx = sy * e1z - sz * e1y
    qy = sz * e1x - sx * e1z
    qz = sx * e1y - sy * e1x
    v = (dx * qx + dy * qy + dz * qz) * inv
    t = (e2x * qx + e2y * qy + e2z * qz) * inv
    hit = (inv != 0.0) & (u >= 0) & (v >= 0) & (u + v <= 1.0) & (t > 1e-5) \
        & (t < t_cap[:, None])
    t_m = torch.where(hit, t, BIG)
    t_k = t_m.amin(dim=1)
    # argmin's first index among equal values, whatever the backend
    slots = torch.arange(t_m.shape[1], device=t_m.device)
    k = torch.where(t_m == t_k[:, None], slots, t_m.shape[1]).amin(dim=1)
    kk = k[:, None]
    return t_k, u.gather(1, kk)[:, 0], v.gather(1, kk)[:, 0], k


def traverse_dense(tri9f, slot_tri, ray_o, ray_d, t_max, active,
                   f64: bool = False):
    """tri9f (B, LEAF_SIZE*16) leaf rows, slot_tri (B*LEAF_SIZE,) -> per ray
    (t, tri_id, u, v); t = +inf and tri_id = -1 on a miss."""
    R = ray_o.shape[0]
    dev = ray_o.device
    S = tri9f.shape[0] * LEAF_SIZE
    # slot-major (B, L, 16) -> field-major (16, S)
    tri_fields = tri9f.reshape(S, 16).T.contiguous()
    if f64:  # -double_rt: the whole dense MT runs in float64
        tri_fields = tri_fields.double()
        ray_o, ray_d = ray_o.double(), ray_d.double()
    t_best = torch.clamp(t_max, max=BIG)
    slot_best = torch.full((R,), -1, dtype=torch.int64, device=dev)
    u_best = torch.zeros((R,), dtype=torch.float32, device=dev)
    v_best = torch.zeros((R,), dtype=torch.float32, device=dev)

    live = torch.nonzero(active).flatten()
    blocks = [(0, S)] if S <= BLOCK_SLOTS else \
        [(lo, min(lo + BLOCK_SLOTS, S)) for lo in range(0, S, BLOCK_SLOTS)]
    elems = STEP_ELEMS_CUDA if ray_o.is_cuda else STEP_ELEMS
    step = max(1, elems // min(S, BLOCK_SLOTS))
    for s in range(0, live.numel(), step):
        r = live[s:s + step]
        o, d = ray_o[r], ray_d[r]
        tb, sb, ub, vb = t_best[r], slot_best[r], u_best[r], v_best[r]
        for lo, hi in blocks:
            t_k, u_k, v_k, k = _mt_block(tri_fields[:, lo:hi], o, d, tb)
            better = t_k < tb
            tb = torch.where(better, t_k.float(), tb)
            sb = torch.where(better, lo + k, sb)
            ub = torch.where(better, u_k.float(), ub)
            vb = torch.where(better, v_k.float(), vb)
        t_best[r], slot_best[r], u_best[r], v_best[r] = tb, sb, ub, vb

    found = slot_best >= 0
    tri = torch.where(
        found, slot_tri[torch.clamp(slot_best, 0, slot_tri.shape[0] - 1)].long(),
        -1)
    return torch.where(found, t_best, float("inf")), tri, u_best, v_best


def closest_hit(scene, ray_o, ray_d, t_max=1e30, active=None):
    """Closest hit by brute force. Returns (t, tri_id, u, v)."""
    tm, active = ray_args(ray_o, t_max, active)
    return traverse_dense(scene.wbvh_tri9f, scene.wbvh_slot_tri, ray_o, ray_d,
                          tm, active, f64=want_double(scene))


def any_hit(scene, ray_o, ray_d, t_max, active=None):
    """Shadow query: True where some triangle lies in (1e-5, t_max)."""
    tm, active = ray_args(ray_o, t_max, active)
    _, tri, _, _ = traverse_dense(scene.wbvh_tri9f, scene.wbvh_slot_tri, ray_o,
                                  ray_d, tm, active, f64=want_double(scene))
    return tri >= 0
