"""Traversal dispatcher and coherence sort.

Four traversals read a scene (the JAX package's _pick chooses among the
same four): ops/traverse_dense.py (brute force over every triangle slot),
ops/traverse_cluster.py (kernels B1/B2/B3 over the cluster pool: flat,
partitioned into chunks, or instanced), ops/traverse_packet.py (kernel B4,
warp packets over the 8-wide BVH) and ops/traverse_wide.py (the 8-wide BVH
ray by ray in plain PyTorch). Which one is a static choice on the scene,
`scene.traversal`, set where the scene is built (assemble, load_scene,
SceneBuilder.build, scene_from_arrays): one of the four by name, or "auto".

"auto" follows the JAX rule as far as it means anything on a GPU: an
instanced scene goes to the cluster kernels, the only ones that understand
its layout; a scene of at most 2 * DENSE_MAX_TRIS triangle slots goes to the
dense path; every other scene to the cluster kernels. The JAX rule also
reads its backend, two environment variables and an on-chip memory budget
to choose between the packet kernel and the wide loop; none of these
carries over, so "packet" and "wide" are reached when named, on the card
and on the CPU alike.

Secondary wavefronts of the cluster path are sorted by (direction octant,
origin Morton) before traversal so that a ray block shares an octant and a
small box, the coherence its block kernels prune with. The other paths take
the rays as they come (wants_sorted_rays).
"""
from __future__ import annotations

import torch

from hydracore_tpu_torch.bvh.wide import LEAF_SIZE
from hydracore_tpu_torch.ops import (traverse_cluster, traverse_dense,
                                     traverse_packet, traverse_wide)
from hydracore_tpu_torch.ops.intersect import ray_args
from hydracore_tpu_torch.ops.rng import M32

_BY_NAME = {"dense": traverse_dense, "cluster": traverse_cluster,
            "packet": traverse_packet, "wide": traverse_wide}


def _pick(scene):
    """The traversal module that reads `scene` (SceneData has validated the
    choice)."""
    if scene.traversal != "auto":
        return _BY_NAME[scene.traversal]
    if scene.cl_map is not None:
        return traverse_cluster
    slots = scene.wbvh_tri9f.shape[0] * LEAF_SIZE
    dense = slots <= traverse_dense.DENSE_MAX_TRIS * 2
    return traverse_dense if dense else traverse_cluster


def closest_hit(scene, ray_o, ray_d, t_max=1e30, active=None,
                kind: str = "primary"):
    mod = _pick(scene)
    if mod is traverse_cluster:  # per-wavefront-kind ray-block size
        return mod.closest_hit(scene, ray_o, ray_d, t_max, active, kind)
    return mod.closest_hit(scene, ray_o, ray_d, t_max, active)


def any_hit(scene, ray_o, ray_d, t_max, active=None):
    return _pick(scene).any_hit(scene, ray_o, ray_d, t_max, active)


def wants_sorted_rays(scene) -> bool:
    """True when the scene's traversal prunes by ray block and so wants its
    wavefronts in coherence order (the cluster kernels)."""
    return _pick(scene) is traverse_cluster


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
    tm, _ = ray_args(ray_o, t_max, active)
    out = fn(scene, ray_o[idx], ray_d[idx], tm[idx], act)
    inv = torch.empty_like(idx)
    inv[idx] = torch.arange(R, device=idx.device)
    return out, inv


def closest_hit_sorted(scene, ray_o, ray_d, t_max=1e30, active=None):
    if not wants_sorted_rays(scene):
        return closest_hit(scene, ray_o, ray_d, t_max, active)
    (t, tri, u, v), inv = _sorted_call(closest_hit, scene, ray_o, ray_d,
                                       t_max, active)
    return t[inv], tri[inv], u[inv], v[inv]


def any_hit_sorted(scene, ray_o, ray_d, t_max, active=None):
    if not wants_sorted_rays(scene):
        return any_hit(scene, ray_o, ray_d, t_max, active)
    occ, inv = _sorted_call(any_hit, scene, ray_o, ray_d, t_max, active)
    return occ[inv]
