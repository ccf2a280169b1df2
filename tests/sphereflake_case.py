"""The benchmark's sphereflake (h100_bench/configs/sphereflake.json: the
`balls` database of Haines' Standard Procedural Databases) as the port's
tests build it, from the configuration's data alone: one unit sphere mesh
(the port's SceneBuilder.add_sphere) placed by one instance a sphere, and
the floor, under a sky, assembled by the port's own rules for instancing
and traversal. The benchmark's lamp is left out: the traversal tests need
the geometry and the camera only.
"""
import json
import math
import pathlib
import xml.etree.ElementTree as ET

import numpy as np

from hydracore_tpu_torch.scene import statefile as sf
from hydracore_tpu_torch.scene.procedural import SceneBuilder
from hydracore_tpu_torch.scene.scene import assemble
from hydracore_tpu_torch.scene.vsgf import MeshData

ROOT = pathlib.Path(__file__).resolve().parents[1]
CONFIG = ROOT / "h100_bench" / "configs" / "sphereflake.json"


def config(**kw) -> dict:
    return {**json.loads(CONFIG.read_text()), **kw}


def _turn_to(d: np.ndarray) -> np.ndarray:
    """The turn that takes +z to the unit vector d (Rodrigues about z x d;
    straight down: a half turn about y)."""
    if d[2] >= 1.0:
        return np.eye(3)
    if d[2] <= -1.0:
        return np.diag([-1.0, 1.0, -1.0])
    a = np.cross([0.0, 0.0, 1.0], d)
    a /= np.linalg.norm(a)
    k = np.array([[0.0, -a[2], a[1]], [a[2], 0.0, -a[0]], [-a[1], a[0], 0.0]])
    th = math.acos(float(np.clip(d[2], -1.0, 1.0)))
    return np.eye(3) + math.sin(th) * k + (1.0 - math.cos(th)) * k @ k


def spheres(cfg: dict):
    """(centres (N, 3), radii (N,)) float64 in depth-first order: each
    sphere above the last depth has nine children of child_scale its
    radius, touching it, along the child directions turned into the frame
    whose z axis is the sphere's own direction."""
    dirs = np.asarray(cfg["assumed"]["child_directions"]["values"])
    s = float(cfg["child_scale"])
    out = []

    def emit(depth, c, d, r):
        out.append((c, r))
        if depth:
            for k in dirs @ _turn_to(d).T:
                emit(depth - 1, c + k * r * (1.0 + s), k, r * s)

    root = cfg["root"]
    emit(int(cfg["size_factor"]), np.asarray(root["center"], np.float64),
         np.asarray(root["direction"], np.float64), float(root["radius"]))
    return np.stack([c for c, _ in out]), np.asarray([r for _, r in out])


def _mesh(pos: np.ndarray, nrm: np.ndarray, mat: int) -> MeshData:
    V = pos.shape[0]
    return MeshData(
        pos=np.concatenate([pos, np.ones((V, 1), np.float32)], 1),
        norm=np.concatenate([nrm, np.zeros((V, 1), np.float32)], 1),
        tang=np.tile(np.float32([[1, 0, 0, 0]]), (V, 1)),
        texcoord=np.zeros((V, 2), np.float32),
        indices=np.arange(V, dtype=np.int32).reshape(-1, 3),
        mat_indices=np.full(V // 3, mat, np.int32))


def sphereflake_scene(size_factor: int | None = None):
    """The port's scene (CPU tensors) of the flake at `size_factor` (the
    configuration's by default)."""
    cfg = config() if size_factor is None else config(size_factor=size_factor)
    b = SceneBuilder()
    b.add_sphere([0.0, 0.0, 0.0], 1.0, 0, n_seg=cfg["spheres"]["n_seg"],
                 n_ring=cfg["spheres"]["n_ring"])
    pos = np.asarray([t[0:3] for t in b.tris], np.float32).reshape(-1, 3)
    nrm = np.asarray([t[3:6] for t in b.tris], np.float32).reshape(-1, 3)
    h, z = float(cfg["floor"]["half_extent"]), float(cfg["floor"]["z"])
    quad = np.float32([[-h, -h, z], [h, -h, z], [h, h, z],
                       [-h, -h, z], [h, h, z], [-h, h, z]])
    floor = _mesh(quad, np.tile(np.float32([0, 0, 1]), (6, 1)), 1)
    instances = [sf.InstanceDesc(mesh_id=1, matrix=np.eye(4, dtype=np.float32))]
    for c, r in zip(*spheres(cfg)):
        m = np.eye(4, dtype=np.float32)
        m[0, 0] = m[1, 1] = m[2, 2] = r
        m[:3, 3] = c
        instances.append(sf.InstanceDesc(mesh_id=2, matrix=m))
    mats = {k: ET.fromstring(
        f'<material id="{k}" type="hydra_material"><diffuse brdf_type='
        f'"lambert"><color val="{col}"/></diffuse></material>')
        for k, col in ((0, "0.5 0.45 0.35"), (1, "0.8 0.6 0.26"))}
    sky = ET.fromstring(
        '<light id="0" type="sky" shape="sky" distribution="uniform">'
        '<intensity><color val="1 1 1"/><multiplier val="1"/></intensity>'
        '</light>')
    c = cfg["camera"]
    cam = sf.CameraDesc(fov=c["fov"], near=c["near"], far=c["far"],
                        position=np.asarray(c["position"], np.float32),
                        look_at=np.asarray(c["look_at"], np.float32),
                        up=np.asarray(c["up"], np.float32))
    desc = sf.SceneDesc(
        lib_dir="", textures={}, materials=mats, lights={0: sky}, camera=cam,
        settings=sf.RenderSettings(width=cfg["width"], height=cfg["height"],
                                   trace_depth=cfg["trace_depth"]),
        meshes={1: floor, 2: _mesh(pos, nrm, 0)}, mesh_light_id={},
        instances=instances, light_instances=[])
    return assemble(desc, instancing="auto", traversal="auto")
