"""Cases of the dense route (ops/traverse_dense.py) that its CPU tests
(tests/test_torch_dense.py), its card tests (tests/test_torch_card.py) and
chip_smoke.py's phase 10 share: a synthetic scene of leaf rows with the
cases the kernel must survive, ray masks, an exact comparison, and the
benchmark's Cornell box built through the port's SceneBuilder.

dense_case() builds the leaf rows of a synthetic scene: duplicated
triangles (equal-t ties) in different leaves, padding slots inside leaves,
zero-area and collinear triangles, rays aimed at the duplicate, rays
parallel to a triangle, rays with inf, NaN and zero components, and
adversarial t_max values.
"""
import json
import math
import pathlib

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
CORNELL = ROOT / "h100_bench" / "configs" / "cornell.json"


def leaf_rows(tris, ids):
    """(S, 9) f32 slot records (v0, e1, e2; NaN rows are padding) and their
    triangle ids -> tri9f (S / 8, 128) f32 and slot_tri (S,) i32, padded as
    bvh/wide.py pads (v0 = 1e30, zero edges, id 0)."""
    S = tris.shape[0]
    assert S % 8 == 0
    rows = np.zeros((S, 16), np.float32)
    pad = np.isnan(tris[:, 0])
    rows[:, 0:9] = np.where(pad[:, None], 0.0, tris)
    rows[pad, 0:3] = 1e30
    return (torch.tensor(rows.reshape(S // 8, 128)),
            torch.tensor(np.where(pad, 0, ids).astype(np.int32)))


def dense_case(seed: int, n_slots: int = 96, n_rays: int = 1000):
    """A synthetic scene and rays: (tri9f, slot_tri, ray_o, ray_d, t_max)
    as CPU tensors, t_max (R,) f32."""
    rng = np.random.default_rng(seed)
    v0 = rng.uniform(-1, 1, (n_slots, 3))
    e1 = rng.uniform(-0.4, 0.4, (n_slots, 3))
    e2 = rng.uniform(-0.4, 0.4, (n_slots, 3))
    tris = np.concatenate([v0, e1, e2], 1).astype(np.float32)
    ids = rng.permutation(n_slots * 4)[:n_slots]
    dup = [1, n_slots // 2 + 3, n_slots - 2]  # one triangle in three leaves
    tris[dup] = tris[dup[0]]
    tris[5, 3:] = 0.0  # zero edges
    tris[6, 6:9] = 2.0 * tris[6, 3:6]  # collinear edges
    tris[[3, 12, 13]] = np.nan  # padding inside leaves
    ro = rng.uniform(-1.5, 1.5, (n_rays, 3))
    rd = rng.normal(size=(n_rays, 3))
    centre = tris[dup[0], 0:3] + (tris[dup[0], 3:6] + tris[dup[0], 6:9]) / 3
    aim = slice(0, n_rays // 4)  # at the duplicated triangle
    rd[aim] = centre - ro[aim]
    par = slice(n_rays // 4, n_rays // 4 + 16)  # parallel to triangle 2
    ro[par] = tris[2, 0:3] - 0.5 * tris[2, 3:6] + 0.01 * rng.normal(size=(16, 3))
    rd[par] = tris[2, 3:6] * rng.uniform(0.5, 2.0, (16, 1))
    odd = n_rays // 4 + 16
    rd[odd:odd + 4] = [[np.inf, 0, 1], [0, np.nan, 1], [0, 0, 0], [-0.0, 0, 1]]
    ro[odd + 4:odd + 8] = [[np.nan, 0, 0], [0, -np.inf, 0], [1e30, 0, 0],
                           [0, 0, -0.0]]
    tm = rng.uniform(0.5, 3.0, n_rays)
    tm[odd + 8:odd + 16] = [np.inf, -np.inf, np.nan, 0.0, -1.0, 1e39, 3e38,
                            1e-5]
    tri9f, slot_tri = leaf_rows(tris, ids)
    return (tri9f, slot_tri, torch.tensor(ro, dtype=torch.float32),
            torch.tensor(rd, dtype=torch.float32),
            torch.tensor(tm, dtype=torch.float32))


def active_mask(kind: str, R: int, seed: int = 3):
    if kind == "all":
        return torch.ones(R, dtype=torch.bool)
    if kind == "none":
        return torch.zeros(R, dtype=torch.bool)
    return torch.tensor(np.random.default_rng(seed).random(R) < 0.6)


def same_words(a, b) -> bool:
    """Equal dtype, shape and bits (a -0.0 is not a +0.0)."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return torch.equal(a, b)


def cornell_box(width: int = 64, height: int = 64):
    """The benchmark's Cornell box (the quads, light and camera of
    h100_bench/configs/cornell.json, in metres) through the port's
    SceneBuilder: each quad two triangles (0, 1, 2) and (0, 2, 3) in the
    file's order, then the rect light; 32 triangles in 88 dense slots."""
    from hydracore_tpu_torch.scene.procedural import SceneBuilder

    cfg = json.loads(CORNELL.read_text())
    unit = cfg["unit_m"]
    b = SceneBuilder()
    mats = {k: b.lambert(m["diff_color"])
            for k, m in cfg["materials"].items() if "diff_color" in m}
    for o in cfg["objects"]:
        for q in o["quads"]:
            p = (np.asarray(q, np.float64) * unit).astype(np.float32)
            n = np.cross(p[1] - p[0], p[2] - p[0])
            b._quad(list(p), n / np.linalg.norm(n), mats[o["material"]])
    q = np.asarray(cfg["light"]["quad"], np.float64) * unit
    lo, hi = q.min(0), q.max(0)
    b.rect_light((lo + hi) / 2, (hi[0] - lo[0]) / 2, (hi[2] - lo[2]) / 2,
                 cfg["light"]["radiance"])
    cam = cfg["camera"]
    eye = np.asarray(cam["position"], np.float64) * unit
    fov = math.degrees(2 * math.atan(cam["film"][1] / 2 / cam["focal_length"]))
    return b.build(cam_pos=eye.astype(np.float32),
                   cam_lookat=(eye + cam["direction"]).astype(np.float32),
                   fov=fov, width=width, height=height,
                   trace_depth=cfg["trace_depth"])
