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

Alpha scenes with the split shadow sets (scene._build_shadow_split) trace
NEE shadow rays in two parts: any_hit_opaque, kernel B2 over the opaque
pool cl_tris_shadow, and alpha_layer_hit, a dense test of the small alpha
triangle set in plain PyTorch (an XLA computation in the JAX package, not
a Pallas kernel). The path tracer's AO probes take ao_any_hit: any_hit
sorted into coherence order, B2 over the full pool on the cluster route,
counted apart from the shadow rays.

Secondary wavefronts of the cluster path are sorted by (direction octant,
origin Morton) before traversal so that a ray block shares an octant and a
small box, the coherence its block kernels prune with. The other paths take
the rays as they come (wants_sorted_rays).
"""
from __future__ import annotations

from functools import partial

import torch

from hydracore_tpu_torch.bvh.wide import LEAF_SIZE
from hydracore_tpu_torch.ops import (traverse_cluster, traverse_dense,
                                     traverse_packet, traverse_wide)
from hydracore_tpu_torch.ops.intersect import ray_args, want_double
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


def ao_any_hit(scene, ray_o, ray_d, t_max, active=None):
    """any_hit_sorted for the AO probes of integrators/pt.py:ao_probe, over
    the full pool as in the JAX package; on the cluster route B2's launches
    count in traverse_cluster.ao_any_launches."""
    if not wants_sorted_rays(scene):
        return any_hit(scene, ray_o, ray_d, t_max, active)
    occ, inv = _sorted_call(partial(traverse_cluster.any_hit, ao_probes=True),
                            scene, ray_o, ray_d, t_max, active)
    return occ[inv]


def has_shadow_split(scene) -> bool:
    """True when the scene carries the split shadow sets and its traversal
    can take them (the cluster kernels over a flattened pool)."""
    return (scene.cl_tris_shadow is not None
            and _pick(scene) is traverse_cluster)


def any_hit_opaque(scene, ray_o, ray_d, t_max, active=None,
                   presorted: bool = True):
    """Occlusion by opaque geometry only: B2 over the shadow pool, where the
    alpha and skip-shadow lanes are zeroed, on the wavefront as it stands
    (the path tracer's is in coherence order on this route), or put into
    coherence order first when not `presorted`. The caller tests the alpha
    set with alpha_layer_hit; together they are the reference's one-walk
    transparent shadow query (trace.cl:244-551)."""
    walk = partial(traverse_cluster.any_hit, opaque_only=True)
    if presorted:
        return walk(scene, ray_o, ray_d, t_max, active=active)
    occ, inv = _sorted_call(walk, scene, ray_o, ray_d, t_max, active)
    return occ[inv]


# elements of one (rays x alpha triangles) step of alpha_layer_hit: its
# dozen f32 temporaries stay near 256 MiB each
ALPHA_STEP_ELEMS = 1 << 26


def alpha_layer_hit(scene, ray_o, ray_d, t_lo, t_hi, active):
    """Closest hit strictly inside (t_lo, t_hi) over the dense alpha set
    (scene.alpha_tri9f (9, A) field-major, scene.alpha_tri_id (A,)):
    Moller-Trumbore of every active ray against every alpha triangle, in
    float64 under settings.double_rt, over steps of at most
    ALPHA_STEP_ELEMS (ray, triangle) pairs. Returns (t, tri_id, u, v); t = 3e38 and tri_id
    -1 on a miss (u = v = 0)."""
    dev = ray_o.device
    R = ray_o.shape[0]
    t_out = torch.full((R,), 3.0e38, dtype=torch.float32, device=dev)
    tid_out = torch.full((R,), -1, dtype=torch.int32, device=dev)
    u_out = torch.zeros((R,), dtype=torch.float32, device=dev)
    v_out = torch.zeros((R,), dtype=torch.float32, device=dev)
    live = torch.nonzero(active).flatten()
    tri = scene.alpha_tri9f
    f64 = want_double(scene)
    if f64:
        tri = tri.to(torch.float64)
    v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z = (tri[k][None]
                                                    for k in range(9))
    step = max(1, ALPHA_STEP_ELEMS // tri.shape[1])
    for s in range(0, live.numel(), step):
        idx = live[s:s + step]
        o, d = ray_o[idx], ray_d[idx]
        if f64:
            o, d = o.to(torch.float64), d.to(torch.float64)
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
        hit = (inv != 0.0) & (u >= 0) & (v >= 0) & (u + v <= 1.0) \
            & (t > t_lo[idx, None]) & (t < t_hi[idx, None])
        t_m = torch.where(hit, t, 3.0e38)
        k = torch.argmin(t_m, dim=1)
        t_k = torch.gather(t_m, 1, k[:, None])[:, 0].to(torch.float32)
        found = t_k < 3.0e38
        u_k = torch.gather(u, 1, k[:, None])[:, 0].to(torch.float32)
        v_k = torch.gather(v, 1, k[:, None])[:, 0].to(torch.float32)
        t_out[idx] = t_k
        tid_out[idx] = torch.where(found, scene.alpha_tri_id[k], -1)
        u_out[idx] = torch.where(found, u_k, 0.0)
        v_out[idx] = torch.where(found, v_k, 0.0)
    return t_out, tid_out, u_out, v_out
