"""Recipe `cornell`: the Cornell box as Cornell University's Program of
Computer Graphics publishes it (walls, two blocks, one rect light, a
pinhole camera), every triangle its own (one flat pool). The quads,
light and camera are the configuration's numbers; the port gets the
triangles, materials and light through its SceneBuilder."""
from __future__ import annotations

import math

import numpy as np

from h100_bench.scenes import common as C


def _triangles(quads, unit: float, solid: bool, inside):
    """Two triangles a quad, each with its face normal: facing `inside`
    for a wall, away from the object's own centre for a solid."""
    q = np.asarray(quads, np.float64) * unit  # (Q, 4, 3)
    tri = np.concatenate([q[:, [0, 1, 2]], q[:, [0, 2, 3]]], 1)
    tri = tri.reshape(-1, 3, 3)
    n = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    toward = tri.mean(1) - (q.reshape(-1, 3).mean(0) if solid else inside)
    sign = np.where((n * toward).sum(1) * (1 if solid else -1) >= 0, 1.0, -1.0)
    n = n * sign[:, None]
    return tri.astype(np.float32), np.repeat(n[:, None], 3, 1).astype(
        np.float32)


def recipe(cfg: dict) -> C.Recipe:
    unit = cfg["unit_m"]
    names = list(cfg["materials"])
    mats = [C.material(**cfg["materials"][k]) for k in names]
    mid = {k: i for i, k in enumerate(names)}
    walls = [o for o in cfg["objects"] if not o.get("solid")]
    inside = np.concatenate([np.asarray(o["quads"], np.float64).reshape(-1, 3)
                             for o in walls]).mean(0) * unit
    pos, nrm, mat = [], [], []
    for o in cfg["objects"]:
        p, n = _triangles(o["quads"], unit, bool(o.get("solid")), inside)
        pos.append(p)
        nrm.append(n)
        mat.append(np.full(p.shape[0], mid[o["material"]], np.int64))
    body = C.Mesh(pos=np.concatenate(pos), nrm=np.concatenate(nrm),
                  mat=np.concatenate(mat))

    lt = cfg["light"]
    q = np.asarray(lt["quad"], np.float64) * unit
    lo, hi = q.min(0), q.max(0)
    if lo[1] != hi[1]:
        raise ValueError("the light is a rect in a plane of constant y")
    centre = (lo + hi) / 2
    hx, hz = (hi[0] - lo[0]) / 2, (hi[2] - lo[2]) / 2
    light = C.rect_light(centre, hx, hz, lt["radiance"], mid[lt["material"]])
    c, vx, vy = light["pos"], light["vx"], light["vy"]
    lamp = C.mesh([C.quad([c - vx - vy, c + vx - vy, c + vx + vy,
                           c - vx + vy], light["norm"], mid[lt["material"]])])

    cam = cfg["camera"]
    eye = np.asarray(cam["position"], np.float64) * unit
    fov = math.degrees(2 * math.atan(cam["film"][1] / 2 / cam["focal_length"]))
    camera = dict(pos=eye.astype(np.float32).tolist(),
                  look_at=(eye + cam["direction"]).astype(np.float32).tolist(),
                  up=list(cam["up"]), fov=fov, near=cam["near"],
                  far=cam["far"])
    ident = np.eye(4, dtype=np.float32)
    return C.Recipe(meshes=[body, lamp], instances=[(0, ident, -1),
                                                    (1, ident, 0)],
                    materials=mats, lights=[light], camera=camera,
                    width=cfg["width"], height=cfg["height"],
                    depth=cfg["trace_depth"])


def to_port(r: C.Recipe):
    """The port's scene (CPU tensors) from the recipe, through its
    SceneBuilder: the light, the materials, the triangles in recipe
    order."""
    from hydracore_tpu_torch.scene.lights import LIGHT_AREA_RECT
    from hydracore_tpu_torch.scene.procedural import SceneBuilder

    cam = r.camera
    if (list(cam["up"]) != [0, 1, 0] or cam["near"] != 0.01
            or cam["far"] != 100.0):
        raise ValueError("SceneBuilder takes the default up, near and far")
    b = SceneBuilder()
    lt = r.lights[0]
    lid = b.add_light(ltype=LIGHT_AREA_RECT, pos=lt["pos"], norm=lt["norm"],
                      vx=lt["vx"], vy=lt["vy"], intensity=lt["intensity"],
                      area=lt["area"])
    for i, m in enumerate(r.materials):
        kw = dict(m)
        if m["refl_dist"] != C.REFL_NONE:
            kw["refl_gloss"] = 1.0 - m["refl_alpha"]
        if i == lt["material"]:
            kw["light_id"] = lid
        b.add_material(**kw)
    uv = np.zeros(2, np.float32)  # no texture reads a coordinate
    for (mi, _, light) in r.instances:
        ms = r.meshes[mi]
        for k in range(ms.pos.shape[0]):
            p, n = ms.pos[k], ms.nrm[k]
            b.tris.append((p[0], p[1], p[2], n[0], n[1], n[2], uv, uv, uv,
                           int(ms.mat[k]), int(light)))
    return b.build(cam_pos=cam["pos"], cam_lookat=cam["look_at"],
                   fov=cam["fov"], width=r.width, height=r.height,
                   trace_depth=r.depth)
