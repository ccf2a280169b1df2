"""Traversal dispatcher and coherence sort.

Every pool goes to the cluster kernels (ops/traverse_cluster.py): flat,
partitioned into chunks, or instanced — the JAX package's _pick restricted
to what the port has. Its dense, wide-BVH and packet paths are not ported
yet.

Secondary wavefronts are sorted by (direction octant, origin Morton) before
traversal so that a ray block shares an octant and a small box — the
coherence the block kernels prune with.
"""
from __future__ import annotations

import torch

from hydracore_tpu_torch.ops import traverse_cluster
from hydracore_tpu_torch.ops.rng import M32


def closest_hit(scene, ray_o, ray_d, t_max=1e30, active=None,
                kind: str = "primary"):
    return traverse_cluster.closest_hit(scene, ray_o, ray_d, t_max, active,
                                        kind)


def any_hit(scene, ray_o, ray_d, t_max, active=None):
    return traverse_cluster.any_hit(scene, ray_o, ray_d, t_max, active)


def _spread10(x):
    x = x & 0x3FF
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    x = (x | (x << 2)) & 0x09249249
    return x


def ray_sort_key(scene, ray_o, ray_d):
    """u32 coherence key (int64 tensor): 3-bit direction octant (major) +
    29-bit origin Morton code over the scene bounds. Bit-exact with the JAX
    package's key."""
    q = (ray_o - scene.world_bmin) / scene.world_bext * 1023.0
    q = torch.clamp(q, 0.0, 1023.0).to(torch.int64)
    m = (_spread10(q[:, 0]) | (_spread10(q[:, 1]) << 1)
         | (_spread10(q[:, 2]) << 2))
    oct_ = ((ray_d[:, 0] > 0).to(torch.int64)
            | ((ray_d[:, 1] > 0).to(torch.int64) << 1)
            | ((ray_d[:, 2] > 0).to(torch.int64) << 2))
    return ((oct_ << 29) | (m >> 1)) & M32


def coherence_order(scene, ray_o, ray_d, active=None):
    """Permutation that sorts rays by ray_sort_key; dead rays (active False)
    pack at the end into all-dead blocks."""
    key = ray_sort_key(scene, ray_o, ray_d)
    if active is not None:
        key = torch.where(active, key, M32)
    return torch.sort(key, stable=True).indices


def _sorted_call(fn, scene, ray_o, ray_d, t_max, active):
    R = ray_o.shape[0]
    idx = coherence_order(scene, ray_o, ray_d, active)
    act = None if active is None else active[idx]
    tm = torch.broadcast_to(torch.as_tensor(t_max, dtype=torch.float32,
                                            device=ray_o.device), (R,))
    out = fn(scene, ray_o[idx], ray_d[idx], tm[idx], act)
    inv = torch.empty_like(idx)
    inv[idx] = torch.arange(R, device=idx.device)
    return out, inv


def closest_hit_sorted(scene, ray_o, ray_d, t_max=1e30, active=None):
    (t, tri, u, v), inv = _sorted_call(closest_hit, scene, ray_o, ray_d,
                                       t_max, active)
    return t[inv], tri[inv], u[inv], v[inv]


def any_hit_sorted(scene, ray_o, ray_d, t_max, active=None):
    occ, inv = _sorted_call(any_hit, scene, ray_o, ray_d, t_max, active)
    return occ[inv]
