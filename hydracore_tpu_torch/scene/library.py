"""A small statefile scene library written to disk, to try the CLI on and to
test the loaders and the front ends with.

    write_library(root, size=24)   ->  root/statex_00001.xml
                                       root/data/chunk_0000{0,1,...}.vsgf

The scene: a floor, three boxes (the third with a remap list), a rect light
with its light mesh and a sky; materials lambert, GGX and the light's
emission; a uvn camera at (0, 4, 14) looking at the origin. Options add a
grid x grid field of small boxes on the floor (over the dense route's 1,024
triangle slots, so the cluster route reads a flat pool) and `balls` spheres
of 25,280 triangles at random places from `seed` (20 of them pass the
400,000 flattened triangles at which load_scene instances). `depth`, `spp`,
`seed` and `burn_iters` are the library's <trace_depth>,
<maxRaysPerPixel>, <seed> and <mmlt_burn_iters> (left out if None).
"""
from __future__ import annotations

import os
import struct

import numpy as np

from hydracore_tpu_torch.scene.vsgf import MeshData

MAT_XML = (
    '<material id="0" type="hydra_material" name="m0"><diffuse '
    'brdf_type="lambert"><color val="0.7 0.3 0.2"/></diffuse></material>'
    '<material id="1" type="hydra_material" name="m1"><diffuse '
    'brdf_type="lambert"><color val="0.5 0.5 0.5"/></diffuse></material>'
    '<material id="2" type="hydra_material" name="rect_em" light_id="1">'
    '<emission><color val="6 6 6"/><multiplier val="1"/></emission>'
    '</material>'
    '<material id="4" type="hydra_material" name="ggx"><diffuse '
    'brdf_type="lambert"><color val="0.2 0.2 0.6"/></diffuse>'
    '<reflectivity brdf_type="ggx"><color val="0.4 0.4 0.4"/>'
    '<glossiness val="0.7"/><fresnel val="1"/><fresnel_ior val="1.5"/>'
    '</reflectivity></material>')
LIGHT_XML = (
    '<light id="0" type="sky" shape="sky" distribution="uniform">'
    '<intensity><color val="0.6 0.7 0.9"/><multiplier val="1"/>'
    '</intensity></light>'
    '<light id="1" type="area" shape="rect" distribution="diffuse" '
    'mat_id="2"><size half_length="1.5" half_width="0.75"/>'
    '<intensity><color val="6 6 6"/><multiplier val="1"/></intensity>'
    '</light>')
# (x, z, scale, rotation about y) of the three boxes on the floor
BOXES = ((-3, -2, 1.0, 0.3), (0, 0, 0.7, 1.1), (3, -1, 1.3, 2.0))


def vsgf_bytes(mesh: MeshData) -> bytes:
    """A .vsgf chunk of a MeshData, in the layout scene/vsgf.py reads."""
    body = b"".join(np.ascontiguousarray(a).tobytes() for a in (
        mesh.pos.astype(np.float32), mesh.norm.astype(np.float32),
        mesh.tang.astype(np.float32), mesh.texcoord.astype(np.float32),
        mesh.indices.astype(np.int32).reshape(-1),
        mesh.mat_indices.astype(np.int32)))
    head = struct.pack("<QIIII", 24 + len(body), mesh.pos.shape[0],
                       mesh.indices.size, 1, 0)
    return head + body


def xform(tx, ty, tz, s=1.0, rot_y=0.0) -> np.ndarray:
    c, sn = np.cos(rot_y), np.sin(rot_y)
    M = np.eye(4, dtype=np.float32)
    M[:3, :3] = np.array([[c, 0, sn], [0, 1, 0], [-sn, 0, c]]) * s
    M[:3, 3] = (tx, ty, tz)
    return M


def _box() -> MeshData:
    v = np.array([[x, y, z] for x in (-1, 1) for y in (-1, 1) for z in (-1, 1)],
                 np.float32)
    quads = [(0, 1, 3, 2), (4, 6, 7, 5), (0, 4, 5, 1),
             (2, 3, 7, 6), (0, 2, 6, 4), (1, 5, 7, 3)]
    idx = np.asarray([t for a, b, c, d in quads for t in ((a, b, c), (a, c, d))],
                     np.int32)
    pos = np.concatenate([v, np.ones((8, 1), np.float32)], 1)
    return MeshData(pos=pos, norm=pos / np.float32(np.sqrt(3.0)),
                    tang=np.tile(np.float32([[1, 0, 0, 0]]), (8, 1)),
                    texcoord=(v[:, :2] * 0.5 + 0.5).astype(np.float32),
                    indices=idx, mat_indices=np.zeros(12, np.int32))


def _floor() -> MeshData:
    p = np.float32([[-20, -1, -20], [20, -1, -20], [20, -1, 20], [-20, -1, 20]])
    return MeshData(pos=np.concatenate([p, np.ones((4, 1), np.float32)], 1),
                    norm=np.tile(np.float32([[0, 1, 0, 0]]), (4, 1)),
                    tang=np.tile(np.float32([[1, 0, 0, 0]]), (4, 1)),
                    texcoord=np.zeros((4, 2), np.float32),
                    indices=np.int32([(0, 2, 1), (0, 3, 2)]),
                    mat_indices=np.ones(2, np.int32))


def _ball() -> MeshData:
    """SceneBuilder.add_sphere's 160 x 80 sphere (material 4), three
    vertices a triangle."""
    from hydracore_tpu_torch.scene.procedural import SceneBuilder

    b = SceneBuilder()
    b.add_sphere([0, 0, 0], 1.0, 4, n_seg=160, n_ring=80)
    tris = b.tris
    T = len(tris)

    def col(k, w):
        a = np.stack([t[k + j] for t in tris for j in range(3)])
        return np.concatenate([a, np.zeros((3 * T, w - a.shape[1]),
                                           np.float32)], 1)

    return MeshData(pos=col(0, 4), norm=col(3, 4),
                    tang=np.tile(np.float32([[1, 0, 0, 0]]), (3 * T, 1)),
                    texcoord=col(6, 2),
                    indices=np.arange(3 * T, dtype=np.int32).reshape(T, 3),
                    mat_indices=np.asarray([t[9] for t in tris], np.int32))


def write_library(root, size: int = 24, *, depth: int = 4, spp: int = 64,
                  seed: int = 5, grid: int = 0, balls: int = 0,
                  burn_iters: int | None = None) -> str:
    """Write the library (module docstring) under `root` at size x size;
    returns `root` as a string."""
    root = os.fspath(root)
    os.makedirs(os.path.join(root, "data"), exist_ok=True)
    meshes = {0: _floor(), 1: _box()}
    if balls:
        meshes[2] = _ball()
    mesh_xml = []
    for mid, m in meshes.items():
        blob = vsgf_bytes(m)
        loc = f"data/chunk_{mid:05d}.vsgf"
        with open(os.path.join(root, loc), "wb") as f:
            f.write(blob)
        V, T = m.pos.shape[0], m.indices.shape[0]
        off, kids = 24, []
        for tag, n in (("positions", V * 16), ("normals", V * 16),
                       ("tangents", V * 16), ("texcoords", V * 8),
                       ("indices", T * 12), ("matindices", T * 4)):
            kids.append(f'<{tag} bytesize="{n}" offset="{off}"/>')
            off += n
        mesh_xml.append(
            f'<mesh id="{mid}" name="m{mid}" type="vsgf" bytesize="{len(blob)}"'
            f' loc="{loc}" offset="0" vertNum="{V}" triNum="{T}">'
            f'{"".join(kids)}</mesh>')
    # the light's mesh has no chunk on disk: the loader makes the rect
    lm = len(meshes)
    mesh_xml.append(f'<mesh id="{lm}" name="lmesh" type="vsgf" light_id="1" '
                    f'loc="data/chunk_{lm:05d}.vsgf" offset="0" bytesize="0"/>')

    def m16(M):
        return " ".join(repr(float(x)) for x in M.reshape(-1))

    mats = [(0, xform(0, 0, 0))]
    mats += [(1, xform(tx, 0.0, tz, s, ry)) for tx, tz, s, ry in BOXES]
    step = 12.0 / max(grid, 1)
    mats += [(1, xform(-6 + step * (i + 0.5), -0.85, -6 + step * (j + 0.5),
                       0.15, 0.37 * (i + j)))
             for i in range(grid) for j in range(grid)]
    rng = np.random.default_rng(seed)
    mats += [(2, xform(*rng.uniform([-5, 0, -5], [5, 2, 3]),
                       rng.uniform(0.4, 0.9), rng.uniform(0, 2 * np.pi)))
             for _ in range(balls)]
    inst = [f'<instance id="{k}" mesh_id="{mid}" rmap_id="-1"'
            + (' remap_lists="0 4"' if k == 3 else "")
            + f' matrix="{m16(M)}"/>' for k, (mid, M) in enumerate(mats)]
    m_l = m16(xform(0.0, 6.0, 0.0))
    inst.append(f'<instance_light id="0" light_id="1" matrix="{m_l}"/>')
    inst.append(f'<instance id="{len(mats)}" mesh_id="{lm}" rmap_id="-1" '
                f'light_id="1" linst_id="0" matrix="{m_l}"/>')
    burn = ("" if burn_iters is None
            else f"<mmlt_burn_iters>{burn_iters}</mmlt_burn_iters>")
    text = f'''<?xml version="1.0"?>
<textures_lib></textures_lib>
<materials_lib>{MAT_XML}</materials_lib>
<lights_lib>{LIGHT_XML}</lights_lib>
<cam_lib><camera id="0" name="cam" type="uvn"><fov>40</fov>
<nearClipPlane>0.01</nearClipPlane><farClipPlane>100</farClipPlane>
<up>0 1 0</up><position>0 4 14</position><look_at>0 0 0</look_at>
</camera></cam_lib>
<geometry_lib>{"".join(mesh_xml)}</geometry_lib>
<render_lib><render_settings type="HydraModern" id="0"><width>{size}</width>
<height>{size}</height><method_primary>pathtracing</method_primary>
<trace_depth>{depth}</trace_depth><diff_trace_depth>2</diff_trace_depth>{burn}
<maxRaysPerPixel>{spp}</maxRaysPerPixel><seed>{seed}</seed><pt_error>2.5</pt_error>
<clamping>100</clamping></render_settings></render_lib>
<scenes><scene id="0" name="s">{"".join(inst)}</scene></scenes>
'''
    with open(os.path.join(root, "statex_00001.xml"), "w") as f:
        f.write(text)
    return root
