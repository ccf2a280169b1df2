"""Recipe `sphereflake`: the `balls` database of Haines' Standard Procedural
Databases (the sphereflake) at its size factor, as a HydraAPI user builds
it: one UV-sphere mesh placed by one instance a sphere, a floor polygon and
one rect lamp. The port reads the scene as a statefile library through
scene.load_scene, with instancing and traversal left to its own rules
("auto"); the reference renders every instance's triangles in the world.
"""
from __future__ import annotations

import math
import os
import shutil
import tempfile

import numpy as np

from h100_bench.scenes import common as C

HERE = os.path.dirname(os.path.abspath(__file__))
CACHE = os.path.join(os.path.dirname(os.path.dirname(HERE)), ".bench_cache",
                     "scenes")
SPHERE, FLOOR, LAMP = 0, 1, 2  # mesh ids, and material ids of the statefile


def _turn(axis, angle: float) -> np.ndarray:
    """Right-handed rotation by `angle` about `axis` (Rodrigues)."""
    a = np.asarray(axis, np.float64)
    a = a / np.linalg.norm(a)
    k = np.array([[0.0, -a[2], a[1]], [a[2], 0.0, -a[0]], [-a[1], a[0], 0.0]])
    return np.eye(3) + math.sin(angle) * k + (1.0 - math.cos(angle)) * k @ k


def _frame(direction) -> np.ndarray:
    """balls.c's output_object: the turn that takes +z to `direction`."""
    d = np.asarray(direction, np.float64)
    if d[2] >= 1.0:
        return np.eye(3)
    if d[2] <= -1.0:
        return _turn([0.0, 1.0, 0.0], math.pi)
    return _turn(np.cross([0.0, 0.0, 1.0], d),
                 math.acos(float(np.clip(d[2], -1.0, 1.0))))


def spheres(cfg: dict):
    """(centres (N, 3), radii (N,)) float64 and each sphere's parent (N,)
    (-1 for the root) of the flake at cfg's size factor, in balls.c's
    depth-first order."""
    dirs = np.asarray(cfg["assumed"]["child_directions"]["values"],
                      np.float64)
    scale = float(cfg["child_scale"])
    root = cfg["root"]
    out_c, out_r, out_p = [], [], []

    def emit(depth, c, d, r, parent):
        me = len(out_c)
        out_c.append(c)
        out_r.append(r)
        out_p.append(parent)
        if depth == 0:
            return
        for k in dirs @ _frame(d).T:
            emit(depth - 1, c + k * (r * (1.0 + scale)), k, r * scale, me)

    emit(int(cfg["size_factor"]), np.asarray(root["center"], np.float64),
         np.asarray(root["direction"], np.float64), float(root["radius"]), -1)
    return np.asarray(out_c), np.asarray(out_r), np.asarray(out_p)


def sphere_mesh(n_seg: int, n_ring: int, mat: int) -> C.Mesh:
    """The port's SceneBuilder.add_sphere at radius 1 about the origin
    (poles on y; one triangle a segment in the polar rings), positions and
    normals float32 as it computes them."""
    pos = []
    for r in range(n_ring):
        th0, th1 = np.pi * r / n_ring, np.pi * (r + 1) / n_ring
        for s in range(n_seg):
            ph0, ph1 = 2 * np.pi * s / n_seg, 2 * np.pi * (s + 1) / n_seg

            def pt(th, ph):
                return np.array([np.sin(th) * np.cos(ph), np.cos(th),
                                 np.sin(th) * np.sin(ph)], np.float32)

            p00, p01, p10, p11 = (pt(th0, ph0), pt(th0, ph1), pt(th1, ph0),
                                  pt(th1, ph1))
            if r > 0:
                pos.append((p00, p11, p01))
            if r < n_ring - 1:
                pos.append((p00, p10, p11))
    pos = np.asarray(pos, np.float32)
    return C.Mesh(pos=pos, nrm=pos.copy(),
                  mat=np.full(pos.shape[0], mat, np.int64))


def nff_material(nff) -> dict:
    """An NFF 'f' record (colour, Kd, Ks, Phong exponent, T, ior) as a
    Lambert lobe Kd x colour and a grey GGX lobe Ks, alpha = sqrt(2 / (n +
    2)) in float32 (the port reads it as glossiness 1 - alpha)."""
    col = np.asarray(nff[:3], np.float64)
    kd, ks, n = float(nff[3]), float(nff[4]), float(nff[5])
    rec = dict(diff_color=(kd * col).astype(np.float32))
    if ks > 0.0:
        rec.update(refl_color=np.full(3, ks, np.float32),
                   refl_alpha=float(np.float32(math.sqrt(2.0 / (n + 2.0)))),
                   refl_dist=C.REFL_GGX)
    return rec


def lamp_matrix(lt: dict) -> np.ndarray:
    """The lamp's 4x4 float32: its local -y (the way a HydraAPI rect light
    emits) turned toward `look_at`, its centre at `center`."""
    c = np.asarray(lt["center"], np.float64)
    y = c - np.asarray(lt["look_at"], np.float64)
    y /= np.linalg.norm(y)
    x = np.cross(y, [0.0, 0.0, 1.0])
    x /= np.linalg.norm(x)
    z = np.cross(x, y)
    m = np.eye(4, dtype=np.float32)
    m[:3, :3] = np.stack([x, y, z], axis=1)
    m[:3, 3] = c
    return m


def recipe(cfg: dict) -> C.Recipe:
    sph = cfg["spheres"]
    names = list(cfg["materials"])
    mid = {k: i for i, k in enumerate(names)}
    if [mid[sph["material"]], mid[cfg["floor"]["material"]],
            mid[cfg["lights"]["material"]]] != [SPHERE, FLOOR, LAMP]:
        raise ValueError("materials are listed sphere, floor, lamp")
    records = [C.material(**(nff_material(m["nff"]) if "nff" in m else m))
               for m in (cfg["materials"][k] for k in names)]

    ball = sphere_mesh(sph["n_seg"], sph["n_ring"], SPHERE)
    h = float(cfg["floor"]["half_extent"])
    zf = float(cfg["floor"]["z"])
    corners = [[-h, -h, zf], [h, -h, zf], [h, h, zf], [-h, h, zf]]
    floor = C.mesh([C.quad(np.asarray(corners, np.float32),
                           np.array([0, 0, 1], np.float32), FLOOR)])

    lt = cfg["lights"]
    hl, hw = float(lt["half_length"]), float(lt["half_width"])
    lm = lamp_matrix(lt)
    rot = lm[:3, :3]
    norm = rot @ np.array([0, -1, 0], np.float32)
    vx = rot @ np.array([hl, 0, 0], np.float32)
    vy = rot @ np.array([0, 0, hw], np.float32)
    light = dict(pos=lm[:3, 3].copy(),
                 norm=(norm / np.linalg.norm(norm)).astype(np.float32),
                 vx=vx, vy=vy, intensity=np.asarray(lt["radiance"], np.float32),
                 area=float(4.0 * np.linalg.norm(np.cross(vx, vy))),
                 material=LAMP)
    rect = np.asarray([[-hl, 0, -hw], [hl, 0, -hw], [hl, 0, hw], [-hl, 0, hw]],
                      np.float32)
    lamp = C.mesh([C.quad(rect, np.array([0, -1, 0], np.float32), LAMP)])

    centres, radii, _ = spheres(cfg)
    instances = []
    for c, r in zip(centres, radii):
        m = np.eye(4, dtype=np.float32)
        m[0, 0] = m[1, 1] = m[2, 2] = r
        m[:3, 3] = c
        instances.append((0, m, -1))
    instances += [(1, np.eye(4, dtype=np.float32), -1), (2, lm, 0)]
    cam = cfg["camera"]
    camera = dict(pos=list(cam["position"]), look_at=list(cam["look_at"]),
                  up=list(cam["up"]), fov=cam["fov"], near=cam["near"],
                  far=cam["far"])
    return C.Recipe(meshes=[ball, floor, lamp], instances=instances,
                    materials=records, lights=[light], camera=camera,
                    width=cfg["width"], height=cfg["height"],
                    depth=cfg["trace_depth"],
                    extra=dict(half=(hl, hw)))


def _floats(a) -> str:
    return " ".join(repr(float(x)) for x in np.asarray(a).reshape(-1))


def _material_xml(i: int, name: str, m: dict, light_id: int) -> str:
    if light_id >= 0:
        return (f'<material id="{i}" type="hydra_material" name="{name}" '
                f'light_id="{light_id}"><emission><color val='
                f'"{_floats(m["em_color"])}"/><multiplier val="1"/>'
                f'</emission></material>')
    xml = (f'<material id="{i}" type="hydra_material" name="{name}"><diffuse '
           f'brdf_type="lambert"><color val="{_floats(m["diff_color"])}"/>'
           f'</diffuse>')
    if m["refl_dist"] == C.REFL_GGX:  # 1 - alpha and back are exact
        xml += (f'<reflectivity brdf_type="ggx"><color val='
                f'"{_floats(m["refl_color"])}"/><glossiness val='
                f'"{1.0 - m["refl_alpha"]!r}"/></reflectivity>')
    return xml + "</material>"


def write_library(r: C.Recipe, root: str) -> str:
    """The recipe as a HydraAPI statefile library under `root`: the sphere
    and floor meshes as .vsgf chunks, the lamp as a rect light with its
    light mesh (which the loader makes), one instance a sphere."""
    from hydracore_tpu_torch.scene.library import vsgf_bytes
    from hydracore_tpu_torch.scene.vsgf import MeshData

    os.makedirs(os.path.join(root, "data"), exist_ok=True)
    mesh_xml = []
    for i in (SPHERE, FLOOR):
        m = r.meshes[i]
        T = m.pos.shape[0]
        p = m.pos.reshape(-1, 3)
        md = MeshData(
            pos=np.concatenate([p, np.ones((3 * T, 1), np.float32)], 1),
            norm=np.concatenate([m.nrm.reshape(-1, 3),
                                 np.zeros((3 * T, 1), np.float32)], 1),
            tang=np.tile(np.float32([[1, 0, 0, 0]]), (3 * T, 1)),
            texcoord=np.zeros((3 * T, 2), np.float32),
            indices=np.arange(3 * T, dtype=np.int32).reshape(T, 3),
            mat_indices=m.mat.astype(np.int32))
        blob = vsgf_bytes(md)
        loc = f"data/chunk_{i:05d}.vsgf"
        with open(os.path.join(root, loc), "wb") as f:
            f.write(blob)
        off, kids = 24, []
        for tag, n in (("positions", 3 * T * 16), ("normals", 3 * T * 16),
                       ("tangents", 3 * T * 16), ("texcoords", 3 * T * 8),
                       ("indices", T * 12), ("matindices", T * 4)):
            kids.append(f'<{tag} bytesize="{n}" offset="{off}"/>')
            off += n
        mesh_xml.append(
            f'<mesh id="{i}" name="m{i}" type="vsgf" bytesize="{len(blob)}" '
            f'loc="{loc}" offset="0" vertNum="{3 * T}" triNum="{T}">'
            f'{"".join(kids)}</mesh>')
    mesh_xml.append(f'<mesh id="{LAMP}" name="lmesh" type="vsgf" light_id="0"'
                    f' loc="data/chunk_{LAMP:05d}.vsgf" offset="0" '
                    'bytesize="0"/>')

    mats = "".join(_material_xml(i, f"m{i}", m, 0 if i == LAMP else -1)
                   for i, m in enumerate(r.materials))
    lt = r.lights[0]
    hl, hw = r.extra["half"]
    light = (f'<light id="0" type="area" shape="rect" distribution="diffuse" '
             f'mat_id="{LAMP}"><size half_length="{hl!r}" half_width='
             f'"{hw!r}"/><intensity><color val="{_floats(lt["intensity"])}"/>'
             '<multiplier val="1"/></intensity></light>')
    inst = []
    for k, (mesh, m, light_id) in enumerate(r.instances):
        if mesh == LAMP:
            inst.append(f'<instance_light id="0" light_id="0" '
                        f'matrix="{_floats(m)}"/>')
            inst.append(f'<instance id="{k}" mesh_id="{LAMP}" rmap_id="-1" '
                        f'light_id="0" linst_id="0" matrix="{_floats(m)}"/>')
        else:
            inst.append(f'<instance id="{k}" mesh_id="{mesh}" rmap_id="-1" '
                        f'matrix="{_floats(m)}"/>')
    cam = r.camera
    text = f'''<?xml version="1.0"?>
<textures_lib></textures_lib>
<materials_lib>{mats}</materials_lib>
<lights_lib>{light}</lights_lib>
<cam_lib><camera id="0" name="cam" type="uvn"><fov>{cam["fov"]!r}</fov>
<nearClipPlane>{cam["near"]!r}</nearClipPlane><farClipPlane>{cam["far"]!r}</farClipPlane>
<up>{_floats(cam["up"])}</up><position>{_floats(cam["pos"])}</position>
<look_at>{_floats(cam["look_at"])}</look_at></camera></cam_lib>
<geometry_lib>{"".join(mesh_xml)}</geometry_lib>
<render_lib><render_settings type="HydraModern" id="0"><width>{r.width}</width>
<height>{r.height}</height><method_primary>IBPT</method_primary>
<trace_depth>{r.depth}</trace_depth></render_settings></render_lib>
<scenes><scene id="0" name="sphereflake">{"".join(inst)}</scene></scenes>
'''
    with open(os.path.join(root, "statex_00001.xml"), "w") as f:
        f.write(text)
    return root


def to_port(r: C.Recipe):
    """The port's scene (CPU tensors): the recipe written as a statefile
    library (under the checkout's .bench_cache/, removed after) and read by
    scene.load_scene with the port's own rules for instancing and
    traversal ("auto": above its flattened-triangle threshold the two-level
    layout and kernel B3)."""
    from hydracore_tpu_torch.scene.scene import load_scene

    os.makedirs(CACHE, exist_ok=True)
    root = tempfile.mkdtemp(prefix="sphereflake-", dir=CACHE)
    try:
        write_library(r, root)
        return load_scene(root, instancing="auto", traversal="auto")
    finally:
        shutil.rmtree(root, ignore_errors=True)
