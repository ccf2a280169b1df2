"""Dense small-scene traversal: brute force over the padded triangle slots.

The JAX package's ops/traverse_dense.py (XLA code there, not a kernel).
Below a few hundred triangles a tree costs more than intersecting every ray
with every triangle slot. The dispatcher (ops/trace_api.py) picks this path
by scene size; with settings.double_rt the whole Moller-Trumbore runs in
float64.

traverse_dense() is the wrapper: for CUDA tensors it launches the kernel
(csrc/traverse_dense.cu, built with nvcc at first use and loaded with
ctypes; one launch a call, no host sync) or raises; for CPU tensors it runs
traverse_dense_plain, the same function in eager PyTorch. It counts kernel
launches in closest_launches / any_launches: module attributes read from
the always-counted counters of utils/spans.py.

Eager PyTorch materialises every (rays x slots) temporary that XLA fuses
away, so the plain version takes the rays in slices of a bounded number of
elements, and only the active ones: a dead ray's answer is a miss whatever
is computed for it.
"""
from __future__ import annotations

import ctypes

import torch

from hydracore_tpu_torch.bvh.wide import LEAF_SIZE
from hydracore_tpu_torch.ops.intersect import ray_args, want_double
from hydracore_tpu_torch.utils import spans
from hydracore_tpu_torch.utils.build import CI, VP, launch, load_lib

DENSE_MAX_TRIS = 512  # single-shot threshold; blocked path above
BLOCK_SLOTS = 2048  # triangle slots per dense block
# rays x slots elements of one slice's temporaries: cache-sized on the CPU,
# 64 MiB each on the card (fewer, larger launches)
STEP_ELEMS = 1 << 20
STEP_ELEMS_CUDA = 1 << 24
# 3e38 as float32 holds it (the JAX package's jnp.float32(3.0e38)), so a
# float64 miss stays above every float32 t_max
BIG = float(torch.tensor(3.0e38, dtype=torch.float32))

LAUNCH_COUNTERS = ("closest_launches", "any_launches")

_lib = None


def __getattr__(name):
    if name in LAUNCH_COUNTERS:
        return spans.value("traverse_dense." + name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def reset_launch_counts() -> None:
    spans.reset(*("traverse_dense." + k for k in LAUNCH_COUNTERS))


def _kernel_lib():
    global _lib
    if _lib is None:
        _lib = load_lib("traverse_dense.cu", "hydra_dense_traverse",
                        [VP] * 5 + [CI, ctypes.c_float] + [VP] * 6 + [CI] * 4
                        + [VP])
    return _lib


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


def traverse_dense_plain(tri9f, slot_tri, ray_o, ray_d, t_max, active,
                         f64: bool = False):
    """tri9f (B, LEAF_SIZE*16) leaf rows, slot_tri (B*LEAF_SIZE,), t_max
    (R,) f32, active (R,) bool -> per ray (t, tri_id, u, v); t = +inf,
    tri_id = -1 and u = v = 0 on a miss."""
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


def _dense_kernel(tri9f, slot_tri, ray_o, ray_d, t_max, active, f64,
                  any_hit_mode):
    """One launch of csrc/traverse_dense.cu on the rays' card."""
    R, dev = ray_o.shape[0], ray_o.device
    B = tri9f.shape[0]
    if tri9f.dim() != 2 or tri9f.shape[1] != LEAF_SIZE * 16:
        raise ValueError(f"tri9f must be (B, {LEAF_SIZE * 16}), got "
                         f"{tuple(tri9f.shape)}")
    if tuple(slot_tri.shape) != (B * LEAF_SIZE,):
        raise ValueError(f"slot_tri must be ({B * LEAF_SIZE},), got "
                         f"{tuple(slot_tri.shape)}")
    for name, x in (("ray_o", ray_o), ("ray_d", ray_d)):
        if tuple(x.shape) != (R, 3):
            raise ValueError(f"{name} must be ({R}, 3), got {tuple(x.shape)}")
    tensors = [("tri9f", tri9f, torch.float32),
               ("slot_tri", slot_tri, torch.int32),
               ("ray_o", ray_o, torch.float32), ("ray_d", ray_d, torch.float32)]
    if active is not None:
        if tuple(active.shape) != (R,):
            raise ValueError(f"active must be ({R},), got {tuple(active.shape)}")
        tensors.append(("active", active, torch.bool))
    for name, x, dt in tensors:
        if x.dtype != dt or x.device != dev:
            raise ValueError(f"{name} must be {dt} on {dev}, got {x.dtype} on "
                             f"{x.device}")
    if isinstance(t_max, torch.Tensor):  # per ray, or one value for all
        tm = torch.broadcast_to(t_max.to(dev, torch.float32), (R,))
        stride = int(R > 1 and tm.stride(0) != 0)
        if stride:
            tm = tm.contiguous()
        scalar = 0.0
    else:  # rounded on the host as torch.as_tensor(t_max, float32) rounds it
        tm, stride = None, 0
        scalar = float(torch.tensor(t_max, dtype=torch.float32))
    ins = [x.contiguous() for x in (tri9f, slot_tri, ray_o, ray_d)]
    ins += [tm, None if active is None else active.contiguous()]
    if any_hit_mode:
        outs = [None] * 4 + [torch.empty((R,), dtype=torch.bool, device=dev)]
    else:
        outs = [torch.empty((R,), dtype=torch.float32, device=dev),
                torch.empty((R,), dtype=torch.int64, device=dev),
                torch.empty((R,), dtype=torch.float32, device=dev),
                torch.empty((R,), dtype=torch.float32, device=dev), None]
    ptr = [None if x is None else x.data_ptr() for x in ins + outs]
    launch(_kernel_lib(), "hydra_dense_traverse", "dense traversal", dev,
           *ptr[:5], stride, scalar, *ptr[5:], R, B * LEAF_SIZE, int(f64),
           int(any_hit_mode))
    spans.bump(f"traverse_dense.{'any' if any_hit_mode else 'closest'}"
               "_launches")
    return outs[4] if any_hit_mode else tuple(outs[:4])


def traverse_dense(tri9f, slot_tri, ray_o, ray_d, t_max, active=None,
                   f64: bool = False, any_hit_mode: bool = False):
    """tri9f (B, LEAF_SIZE*16) leaf rows, slot_tri (B*LEAF_SIZE,) i32, t_max
    a number or a tensor broadcast to (R,), active (R,) bool or None (all
    live) -> per ray (t, tri_id, u, v) (t = +inf, tri_id = -1, u = v = 0 on
    a miss), or with any_hit_mode the bool of a hit below t_max. CUDA
    tensors launch the kernel (float64 with f64) and raise if it cannot run;
    CPU tensors run traverse_dense_plain."""
    if ray_o.is_cuda:
        return _dense_kernel(tri9f, slot_tri, ray_o, ray_d, t_max, active,
                             f64, any_hit_mode)
    tm, active = ray_args(ray_o, t_max, active)
    out = traverse_dense_plain(tri9f, slot_tri, ray_o, ray_d, tm, active, f64)
    return out[1] >= 0 if any_hit_mode else out


def closest_hit(scene, ray_o, ray_d, t_max=1e30, active=None):
    """Closest hit by brute force. Returns (t, tri_id, u, v)."""
    return traverse_dense(scene.wbvh_tri9f, scene.wbvh_slot_tri, ray_o, ray_d,
                          t_max, active, f64=want_double(scene))


def any_hit(scene, ray_o, ray_d, t_max, active=None):
    """Shadow query: True where some triangle lies in (1e-5, t_max)."""
    return traverse_dense(scene.wbvh_tri9f, scene.wbvh_slot_tri, ray_o, ray_d,
                          t_max, active, f64=want_double(scene),
                          any_hit_mode=True)
