"""The harness's own scene description and the geometry its recipes use.

A recipe gives a Recipe: meshes in their own space, instances placing them
in the world, material records, rect lights and the camera. The reference
renders `flatten(recipe)`, every instance's triangles moved into the world;
the port gets the recipe through the recipe module's `to_port`.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

REFL_NONE = 0
REFL_GGX = 2


@dataclass
class Mesh:
    """Triangles as three vertices each: pos (T, 3, 3), normals (T, 3, 3),
    a material id a triangle."""
    pos: np.ndarray
    nrm: np.ndarray
    mat: np.ndarray


@dataclass
class Recipe:
    meshes: list  # [Mesh]
    instances: list  # [(mesh index, 4x4 float32 matrix, light id or -1)]
    materials: list  # [dict]: em_color, diff_color, refl_color, refl_alpha,
    #                   refl_dist, transp_color, transp_ior (numpy / floats)
    lights: list  # [dict] rect lights: pos, norm, vx, vy, intensity, area,
    #                material (its emissive material)
    camera: dict  # pos, look_at, up, fov, near, far
    width: int
    height: int
    depth: int
    extra: dict = field(default_factory=dict)


@dataclass
class Flat:
    """World triangles: v0, v1, v2, n0, n1, n2 (T, 3) float32, mat and
    light (T,) int64; the records and camera of the recipe."""
    v0: np.ndarray
    v1: np.ndarray
    v2: np.ndarray
    n0: np.ndarray
    n1: np.ndarray
    n2: np.ndarray
    mat: np.ndarray
    light: np.ndarray
    object_of: np.ndarray  # (T,) the instance each triangle came from
    recipe: Recipe


def material(**kw) -> dict:
    rec = dict(em_color=np.zeros(3, np.float32),
               diff_color=np.zeros(3, np.float32),
               refl_color=np.zeros(3, np.float32), refl_alpha=1e-3,
               refl_dist=REFL_NONE, transp_color=np.zeros(3, np.float32),
               transp_ior=1.5)
    for k, v in kw.items():
        if k not in rec:
            raise KeyError(f"material key {k!r} is not one the reference "
                           "renders")
        rec[k] = np.asarray(v, np.float32) if np.ndim(v) else v
    return rec


def quad(pts, n, mat: int):
    """Two triangles (0, 1, 2), (0, 2, 3) of a quad with one normal."""
    pos = [(pts[i], pts[j], pts[k]) for i, j, k in ((0, 1, 2), (0, 2, 3))]
    return pos, [(n, n, n)] * 2, [mat, mat]


def join(parts):
    pos, nrm, mats = [], [], []
    for p, n, m in parts:
        pos += list(p)
        nrm += list(n)
        mats += list(m)
    return pos, nrm, mats


def mesh(parts) -> Mesh:
    pos, nrm, mats = join(parts)
    return Mesh(pos=np.asarray(pos, np.float32),
                nrm=np.asarray(nrm, np.float32),
                mat=np.asarray(mats, np.int64))


def rect_light(center, hx: float, hz: float, radiance, mat: int) -> dict:
    """A rect in the XZ plane at `center`, emitting down -Y; `mat` is its
    emissive material."""
    return dict(pos=np.asarray(center, np.float32),
                norm=np.array([0, -1, 0], np.float32),
                vx=np.array([hx, 0, 0], np.float32),
                vy=np.array([0, 0, hz], np.float32),
                intensity=np.asarray(radiance, np.float32),
                area=float(4 * hx * hz), material=mat)


def flatten(recipe: Recipe) -> Flat:
    """Every instance's triangles in world space: positions by the
    matrix, normals by its inverse transpose (left unnormalised: shading
    interpolates, then normalises)."""
    cols = {k: [] for k in ("v0", "v1", "v2", "n0", "n1", "n2", "mat",
                            "light", "obj")}
    for i, (mi, m, light) in enumerate(recipe.instances):
        ms = recipe.meshes[mi]
        m = np.asarray(m, np.float32)
        a, t = m[:3, :3], m[:3, 3]
        inv = np.linalg.inv(a.astype(np.float64)).astype(np.float32)
        for j in range(3):
            cols[f"v{j}"].append((ms.pos[:, j] @ a.T + t).astype(np.float32))
            cols[f"n{j}"].append((ms.nrm[:, j] @ inv).astype(np.float32))
        T = ms.pos.shape[0]
        cols["mat"].append(ms.mat)
        cols["light"].append(np.full(T, light, np.int64))
        cols["obj"].append(np.full(T, i, np.int64))
    c = {k: np.concatenate(v) for k, v in cols.items()}
    return Flat(v0=c["v0"], v1=c["v1"], v2=c["v2"], n0=c["n0"], n1=c["n1"],
                n2=c["n2"], mat=c["mat"], light=c["light"], object_of=c["obj"],
                recipe=recipe)


def look_at(eye, center, up) -> np.ndarray:
    """Right-handed view matrix (row-major)."""
    eye, center, up = (np.asarray(x, np.float32) for x in (eye, center, up))
    f = center - eye
    f = f / np.linalg.norm(f)
    s = np.cross(f, up)
    s = s / np.linalg.norm(s)
    u = np.cross(s, f)
    m = np.eye(4, dtype=np.float32)
    m[0, :3], m[1, :3], m[2, :3] = s, u, -f
    m[0, 3] = -np.dot(s, eye)
    m[1, 3] = -np.dot(u, eye)
    m[2, 3] = np.dot(f, eye)
    return m


def perspective(fov_deg: float, aspect: float, near: float, far: float):
    """OpenGL projection, vertical field of view (row-major)."""
    ymax = near * np.tan(np.deg2rad(fov_deg) * 0.5)
    xmax = ymax * aspect
    m = np.zeros((4, 4), dtype=np.float32)
    m[0, 0] = near / xmax
    m[1, 1] = near / ymax
    m[2, 2] = -(far + near) / (far - near)
    m[2, 3] = -2.0 * far * near / (far - near)
    m[3, 2] = -1.0
    return m


def camera_matrices(recipe: Recipe):
    """(view -> world, inverse projection) float32, as the renderer's
    camera builds them."""
    c = recipe.camera
    view = look_at(c["pos"], c["look_at"], c["up"])
    proj = perspective(c["fov"], recipe.width / recipe.height, c["near"],
                       c["far"])
    return (np.linalg.inv(view).astype(np.float32),
            np.linalg.inv(proj).astype(np.float32))
