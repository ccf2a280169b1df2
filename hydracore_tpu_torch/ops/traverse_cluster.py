"""Cluster traversal: kernels B1 (closest hit) and B2 (any hit), their plain
PyTorch twin, and the closest_hit / any_hit epilogues.

The kernels (csrc/traverse_cluster.cu, CUDA C++ for sm_90a, built with
nvcc at first use and loaded with ctypes) replace the JAX package's Pallas
kernel hydracore_tpu/ops/traverse_cluster.py::_make_kernel as launched by
_cluster_traverse. They compute the same function, not its TPU block
structure; the source note in the .cu file gives the design and its bound.

cluster_traverse() is the wrapper: for CUDA tensors it launches the kernel
(or raises), for CPU tensors it runs cluster_traverse_plain, the twin with
the same contract. It counts kernel launches in closest_launches /
any_launches.
"""
from __future__ import annotations

import ctypes
import sys

import torch

from hydracore_tpu_torch.ops.intersect import mt_refine, want_double

BIG = 3.0e38
LANES = 128
# rays per CTA (one thread per ray): the coherence unit of the box-test
# pruning. Bounce wavefronts are less coherent than primary and shadow
# ones, so they use smaller blocks (the JAX package's defaults).
R_BLK = 256
R_BLK_BOUNCE = 128

closest_launches = 0
any_launches = 0

_lib = None


def reset_launch_counts() -> None:
    this = sys.modules[__name__]
    this.closest_launches = 0
    this.any_launches = 0


def _kernel_lib():
    global _lib
    if _lib is None:
        from hydracore_tpu_torch.utils.build import build

        lib = ctypes.CDLL(build("traverse_cluster.cu"))
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.hydra_cluster_traverse.argtypes = [vp, vp, vp, vp, vp, vp,
                                               ci, ci, ci, ci, vp]
        lib.hydra_cluster_traverse.restype = ci
        lib.hydra_cuda_error_string.argtypes = [ci]
        lib.hydra_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _check_inputs(rays, cbl_oct, tris, perm):
    if rays.dim() != 3 or rays.shape[2] != 8:
        raise ValueError(f"rays must be (G, r_blk, 8), got {tuple(rays.shape)}")
    Cp = cbl_oct.shape[2] if cbl_oct.dim() == 3 else -1
    if tuple(cbl_oct.shape) != (8, 8, Cp) or Cp <= 0:
        raise ValueError(f"cbl_oct must be (8, 8, Cp), got {tuple(cbl_oct.shape)}")
    if tuple(tris.shape) != (Cp, 4, 3 * LANES):
        raise ValueError(f"tris must be ({Cp}, 4, 384), got {tuple(tris.shape)}")
    if tuple(perm.shape) != (8, Cp):
        raise ValueError(f"perm must be (8, {Cp}), got {tuple(perm.shape)}")
    for name, x, dt in (("rays", rays, torch.float32),
                        ("cbl_oct", cbl_oct, torch.float32),
                        ("tris", tris, torch.float32),
                        ("perm", perm, torch.int32)):
        if x.dtype != dt:
            raise TypeError(f"{name} must be {dt}, got {x.dtype}")
        if x.device != rays.device:
            raise ValueError(f"{name} is on {x.device}, rays on {rays.device}")


def cluster_traverse(rays, cbl_oct, tris, perm, any_hit_mode: bool = False):
    """rays (G, r_blk, 8) f32 [o d t_lim active] -> (t (G, r_blk) f32,
    slot (G, r_blk) i32). CUDA tensors launch kernel B1 / B2; CPU tensors
    run the plain twin."""
    _check_inputs(rays, cbl_oct, tris, perm)
    if not rays.is_cuda:
        return cluster_traverse_plain(rays, cbl_oct, tris, perm, any_hit_mode)
    G, r_blk, _ = rays.shape
    if r_blk > 256:
        raise ValueError(f"r_blk {r_blk} > 256 threads per block")
    rays, cbl_oct, tris, perm = (x.contiguous() for x in (rays, cbl_oct, tris, perm))
    t = torch.empty((G, r_blk), dtype=torch.float32, device=rays.device)
    slot = torch.empty((G, r_blk), dtype=torch.int32, device=rays.device)
    lib = _kernel_lib()
    with torch.cuda.device(rays.device):
        stream = torch.cuda.current_stream(rays.device).cuda_stream
        err = lib.hydra_cluster_traverse(
            rays.data_ptr(), cbl_oct.data_ptr(), tris.data_ptr(),
            perm.data_ptr(), t.data_ptr(), slot.data_ptr(),
            G * r_blk, r_blk, cbl_oct.shape[2], int(any_hit_mode), stream)
    if err != 0:
        msg = lib.hydra_cuda_error_string(err).decode()
        raise RuntimeError(f"cluster traversal kernel launch failed: {msg}")
    this = sys.modules[__name__]
    if any_hit_mode:
        this.any_launches += 1
    else:
        this.closest_launches += 1
    return t, slot


# elements of one slab-test step of the twin: bounds its (rays x clusters)
# temporaries to ~16 MiB each
_TWIN_SLAB_ELEMS = 1 << 22


def cluster_traverse_plain(rays, cbl_oct, tris, perm, any_hit_mode: bool = False):
    """Plain PyTorch twin of B1/B2 with the kernel's contract: a dense
    masked slab test of every ray against every cluster box, then, cluster
    by cluster, the Woop Moller-Trumbore of the rays that enter its box
    against its lanes up to the last live one (padded lanes never hit).
    Ties between equal t go to the lowest cluster id and lane (the kernel:
    first in visit order)."""
    G, RB, _ = rays.shape
    dev = rays.device
    flat = rays.reshape(-1, 8)
    N = flat.shape[0]
    Cp = cbl_oct.shape[2]
    # boxes in true-cluster order (every octant holds the same boxes)
    bounds = torch.empty((8, Cp), dtype=torch.float32, device=dev)
    bounds[:, perm[0].long()] = cbl_oct[0]
    # padded clusters are 1e30 point boxes that no ray enters: skip them
    real = torch.nonzero(bounds[0] < 1e29).flatten()
    bounds = bounds[:, real]
    real = real.tolist()
    # lanes past the last live one are padding (u row 0,0,0,-1: u = -1)
    pad = (tris[:, 0:3, :LANES] == 0).all(dim=1) & (tris[:, 3, :LANES] == -1.0)
    lane_no = torch.arange(1, LANES + 1, device=dev)
    n_lanes = torch.where(pad, 0, lane_no).amax(dim=1).tolist()

    act = flat[:, 7] > 0.0
    t0 = torch.where(act, torch.clamp(flat[:, 6], max=BIG),
                     torch.full_like(flat[:, 6], -BIG))
    best_t = torch.full((N,), float("inf"), dtype=torch.float32, device=dev)
    best_s = torch.full((N,), -1, dtype=torch.int64, device=dev)

    eps = 1e-12

    def safe_inv(d):
        return 1.0 / torch.where(d.abs() < eps,
                                 torch.where(d < 0, -eps, eps), d)

    chunk = max(1, min(N, _TWIN_SLAB_ELEMS // max(len(real), 1)))
    for s in range(0, N, chunk):
        e = min(s + chunk, N)
        o = flat[s:e, 0:3]
        d = flat[s:e, 3:6]
        inv = safe_inv(d)
        oi = o * inv
        t_a = bounds[None, 0:3] * inv[:, :, None] - oi[:, :, None]  # (n,3,Cp)
        t_b = bounds[None, 3:6] * inv[:, :, None] - oi[:, :, None]
        tmin = torch.minimum(t_a, t_b)
        tmax = torch.maximum(t_a, t_b)
        tn = torch.maximum(torch.maximum(tmin[:, 0], tmin[:, 1]), tmin[:, 2])
        tf = torch.minimum(torch.minimum(tmax[:, 0], tmax[:, 1]), tmax[:, 2])
        box = (tf >= torch.clamp(tn, min=0.0)) & (tn < t0[s:e, None]) \
            & act[s:e, None]
        for j in torch.nonzero(box.any(dim=0)).flatten().tolist():
            r = torch.nonzero(box[:, j]).flatten() + s
            c = real[j]
            L = n_lanes[c]
            if L == 0:
                continue
            blk = tris[c, :, :]  # (4, 384)
            bu, bv, bw = (blk[:, k * LANES:k * LANES + L] for k in range(3))
            ox, oy, oz = (flat[r, k:k + 1] for k in range(3))
            dx, dy, dz = (flat[r, k:k + 1] for k in range(3, 6))
            ow = ox * bw[0] + oy * bw[1] + oz * bw[2] + bw[3]
            dw = dx * bw[0] + dy * bw[1] + dz * bw[2]
            t = -ow / dw
            u = (ox * bu[0] + oy * bu[1] + oz * bu[2] + bu[3]) \
                + t * (dx * bu[0] + dy * bu[1] + dz * bu[2])
            v = (ox * bv[0] + oy * bv[1] + oz * bv[2] + bv[3]) \
                + t * (dx * bv[0] + dy * bv[1] + dz * bv[2])
            hit = (t > 1e-5) & (t < t0[r, None]) & (u >= 0) & (v >= 0) \
                & (u + v <= 1.0)
            kt, kl = torch.where(hit, t, float("inf")).min(dim=1)
            better = kt < best_t[r]
            best_t[r] = torch.where(better, kt, best_t[r])
            best_s[r] = torch.where(better, c * LANES + kl, best_s[r])
    found = best_s >= 0
    if any_hit_mode:
        t_out = torch.where(found, -BIG, t0)
    else:
        t_out = torch.where(found, best_t, t0)
    slot_out = best_s.to(torch.int32)
    return t_out.reshape(G, RB), slot_out.reshape(G, RB)


def _to_blocks(ro, rd, t_max, active, r_blk):
    """Pack rays into (G, r_blk, 8) [o d t_lim active]; the padded tail of
    the last block is inactive."""
    R = ro.shape[0]
    Rp = max((R + r_blk - 1) // r_blk, 1) * r_blk
    r = torch.zeros((Rp, 8), dtype=torch.float32, device=ro.device)
    r[:R, 0:3] = ro
    r[:R, 3:6] = rd
    r[:R, 6] = torch.as_tensor(t_max, dtype=torch.float32, device=ro.device)
    r[:R, 7] = 1.0 if active is None else active.to(torch.float32)
    return r.reshape(Rp // r_blk, r_blk, 8), R


def closest_hit(scene, ray_o, ray_d, t_max=1e30, active=None,
                kind: str = "primary"):
    """Returns (t, tri_id, u, v); t = +inf and tri_id = -1 on a miss. The
    kernel's slot maps to a triangle through cl_slot_tri2; the exact
    (t, u, v) come from one gathered Moller-Trumbore per ray (mt_refine),
    as in the JAX package's epilogue."""
    r_blk = R_BLK_BOUNCE if kind == "bounce" else R_BLK
    rays, R = _to_blocks(ray_o, ray_d, t_max, active, r_blk)
    _, slot = cluster_traverse(rays, scene.cl_bounds_oct, scene.cl_tris,
                               scene.cl_oct_perm, any_hit_mode=False)
    slot = slot.reshape(-1)[:R].long()
    hit = slot >= 0
    n_slots = scene.cl_slot_tri2.shape[0]
    row = scene.cl_slot_tri2[torch.clamp(slot, 0, n_slots - 1)]
    tri = torch.where(hit, row[:, 0].long(), -1)
    tid = torch.clamp(tri, 0, scene.tri_attr.shape[0] - 1)
    a = scene.tri_attr[tid]
    v0, e1, e2 = a[:, 0:3], a[:, 3:6], a[:, 6:9]
    t_e, u, v = mt_refine(ray_o, ray_d, v0, e1, e2, f64=want_double(scene))
    t = torch.where(hit, t_e, float("inf"))
    return t, tri, torch.where(hit, u, 0.0), torch.where(hit, v, 0.0)


def any_hit(scene, ray_o, ray_d, t_max, active=None):
    """Shadow query: True where some triangle lies in (1e-5, t_max)."""
    rays, R = _to_blocks(ray_o, ray_d, t_max, active, R_BLK)
    _, slot = cluster_traverse(rays, scene.cl_bounds_oct, scene.cl_tris,
                               scene.cl_oct_perm, any_hit_mode=True)
    return slot.reshape(-1)[:R] >= 0
