"""The yardstick of the kernels' roofline: published peaks of one NVIDIA
H100 SXM (dense, 700 W) and the bytes and operations a traversal call
needs whatever implements it."""
from __future__ import annotations

PEAK_BYTES_PER_S = 3.35e12  # HBM3
PEAK_F32_PER_S = 67e12  # float32 outside the tensor cores
RAY_IN_BYTES = 28  # origin, direction, t_max
CLOSEST_OUT_BYTES = 16  # t, u, v, triangle id
ANY_OUT_BYTES = 1  # occluded
TRIANGLE_BYTES = 36  # three vertices
INSTANCE_BYTES = 48  # a 3x4 matrix
MT_OPERATIONS = 51  # one Moller-Trumbore test: the ray's own hit at least


def scene_bytes(recipe) -> int:
    """The description's raw geometry: each mesh's triangles once and
    every instance's matrix."""
    tris = sum(m.pos.shape[0] for m in recipe.meshes)
    return tris * TRIANGLE_BYTES + len(recipe.instances) * INSTANCE_BYTES


def traversal_need(calls: dict, live: dict, recipe) -> tuple[float, float]:
    """(bytes, operations) of the traversal calls: `calls` and `live`
    (live rays) by kind, "closest" and "any"."""
    n_calls = calls["closest"] + calls["any"]
    rays = live["closest"] + live["any"]
    b = (rays * RAY_IN_BYTES + live["closest"] * CLOSEST_OUT_BYTES
         + live["any"] * ANY_OUT_BYTES + n_calls * scene_bytes(recipe))
    return float(b), float(rays * MT_OPERATIONS)


def bound_s(bytes_: float, ops: float) -> tuple[float, str]:
    """The least time the chip could take, and which peak bounds it."""
    tb = bytes_ / PEAK_BYTES_PER_S
    to = ops / PEAK_F32_PER_S
    return (tb, "bytes") if tb >= to else (to, "operations")
