"""Scene assembly parity: the port's assemble / load_statefile against the
JAX package's on the same SceneDesc data.

The SceneDesc of tests/test_instancing.py (a plane and five transformed
boxes, lambert, sky) is rebuilt for both packages from the same numpy
data, with an area-light instance, a mesh-light instance, a remapped
instance, a single-use mesh (all of which must flatten) and a
negative-scale matrix added. Every leaf the port keeps must be bit-exact
(tolerance 0) in the flattened and in the instanced layout, and the static
settings equal. A second case writes a tiny scene library (statefile XML
and .vsgf chunks, scene/library.py) and loads it with both packages'
load_statefile.
"""
import dataclasses
import struct
import xml.etree.ElementTree as ET

import numpy as np
import pytest
import torch

from hydracore_tpu.scene import scene as jscene
from hydracore_tpu.scene import statefile as jsf
from hydracore_tpu.scene import vsgf as jvsgf
from hydracore_tpu_torch.scene import scene as pscene
from hydracore_tpu_torch.scene import statefile as psf
from hydracore_tpu_torch.scene import vsgf as pvsgf
from hydracore_tpu_torch.scene.library import write_library
from tests.test_torch_scene import (_assert_same_leaves, jax_leaves,
                                    jax_settings, to_port)

# one intra-op thread: the suite runs several test processes at once, and
# spinning PyTorch worker threads on shared cores slow every one of them
torch.set_num_threads(1)

JAX = (jsf, jvsgf)
PORT = (psf, pvsgf)


def box_arrays(half=1.0, mat=0):
    v = np.array([[x, y, z] for x in (-half, half) for y in (-half, half)
                  for z in (-half, half)], np.float32)
    quads = [(0, 1, 3, 2), (4, 6, 7, 5), (0, 4, 5, 1),
             (2, 3, 7, 6), (0, 2, 6, 4), (1, 5, 7, 3)]
    idx = np.asarray([t for a, b, c, d in quads
                      for t in ((a, b, c), (a, c, d))], np.int32)
    pos = np.concatenate([v, np.ones((8, 1), np.float32)], 1)
    nrm = pos / np.maximum(np.linalg.norm(v, axis=1, keepdims=True), 1e-9)
    tang = np.tile(np.array([[1, 0, 0, 0]], np.float32), (8, 1))
    uv = (v[:, :2] * 0.5 + 0.5).astype(np.float32)
    return dict(pos=pos, norm=nrm.astype(np.float32), tang=tang, texcoord=uv,
                indices=idx, mat_indices=np.full(len(idx), mat, np.int32))


def plane_arrays(size=20.0, y=-1.0, mat=1):
    v = np.array([[-size, y, -size], [size, y, -size],
                  [size, y, size], [-size, y, size]], np.float32)
    return dict(
        pos=np.concatenate([v, np.ones((4, 1), np.float32)], 1),
        norm=np.tile(np.array([[0, 1, 0, 0]], np.float32), (4, 1)),
        tang=np.tile(np.array([[1, 0, 0, 0]], np.float32), (4, 1)),
        texcoord=np.zeros((4, 2), np.float32),
        indices=np.asarray([(0, 2, 1), (0, 3, 2)], np.int32),
        mat_indices=np.full(2, mat, np.int32))


def xform(tx, ty, tz, s=1.0, rot_y=0.0, sx=1.0):
    c, sn = np.cos(rot_y), np.sin(rot_y)
    M = np.eye(4, dtype=np.float32)
    M[:3, :3] = np.array([[c, 0, sn], [0, 1, 0], [-sn, 0, c]]) * s
    M[:3, 0] *= sx
    M[:3, 3] = (tx, ty, tz)
    return M


MAT_XML = {
    0: '<material id="0" type="hydra_material" name="m0"><diffuse '
       'brdf_type="lambert"><color val="0.7 0.3 0.2"/></diffuse></material>',
    1: '<material id="1" type="hydra_material" name="m1"><diffuse '
       'brdf_type="lambert"><color val="0.5 0.5 0.5"/></diffuse></material>',
    2: '<material id="2" type="hydra_material" name="rect_em" light_id="1">'
       '<emission><color val="6 6 6"/><multiplier val="1"/></emission>'
       '</material>',
    3: '<material id="3" type="hydra_material" name="mesh_em" light_id="2">'
       '<emission><color val="3 2 1"/><multiplier val="2"/></emission>'
       '</material>',
    4: '<material id="4" type="hydra_material" name="ggx"><diffuse '
       'brdf_type="lambert"><color val="0.2 0.2 0.6"/></diffuse>'
       '<reflectivity brdf_type="ggx"><color val="0.4 0.4 0.4"/>'
       '<glossiness val="0.7"/><fresnel val="1"/><fresnel_ior val="1.5"/>'
       '</reflectivity></material>',
}
SKY_XML = ('<light id="0" type="sky" shape="sky" distribution="uniform">'
           '<intensity><color val="0.6 0.7 0.9"/><multiplier val="1"/>'
           '</intensity></light>')
RECT_XML = ('<light id="1" type="area" shape="rect" distribution="diffuse" '
            'mat_id="2"><size half_length="1.5" half_width="0.75"/>'
            '<intensity><color val="6 6 6"/><multiplier val="1"/></intensity>'
            '</light>')
MESH_XML = ('<light id="2" type="area" shape="mesh" distribution="diffuse" '
            'mat_id="3"><intensity><color val="3 2 1"/><multiplier val="2"/>'
            '</intensity></light>')

BOXES = [(-3, -2, 1.0, 0.3), (0, 0, 0.7, 1.1), (3, -1, 1.3, 2.0),
         (-1.5, 2.5, 0.9, 0.7), (2.0, 2.5, 0.6, 2.8)]


def make_desc(pkg, extended: bool, size: int = 48):
    """The plane + 5 boxes + sky scene of tests/test_instancing.py for the
    package `pkg` = (statefile module, vsgf module); `extended` adds the
    lights, the remap, the single-use mesh and the mirrored instance."""
    sf, vs = pkg
    settings = sf.RenderSettings(width=size, height=size, trace_depth=3)
    cam = sf.CameraDesc()
    cam.position = np.array([0, 4, 14], np.float32)
    cam.look_at = np.array([0, 0, 0], np.float32)
    meshes = {1: vs.MeshData(**plane_arrays()), 2: vs.MeshData(**box_arrays())}
    mats = {k: ET.fromstring(MAT_XML[k]) for k in (0, 1)}
    lights = {0: ET.fromstring(SKY_XML)}
    instances = [sf.InstanceDesc(mesh_id=1, matrix=xform(0, -1.0, 0))]
    for tx, tz, s, ry in BOXES:
        instances.append(sf.InstanceDesc(mesh_id=2,
                                         matrix=xform(tx, 0.0, tz, s, ry)))
    light_instances, mesh_light_id = [], {}
    if extended:
        mats.update({k: ET.fromstring(MAT_XML[k]) for k in (2, 3, 4)})
        lights.update({1: ET.fromstring(RECT_XML), 2: ET.fromstring(MESH_XML)})
        # a mirrored, non-uniformly scaled box (negative determinant)
        instances.append(sf.InstanceDesc(
            mesh_id=2, matrix=xform(-4.5, 0.3, 3.0, 0.8, 0.4, sx=-1.5)))
        # a remapped box: material 0 -> 4 (must flatten)
        instances.append(sf.InstanceDesc(
            mesh_id=2, matrix=xform(4.5, 0.0, 3.0, 0.5, 0.2),
            remap_list=np.array([0, 4], np.int32)))
        # a single-use mesh (must flatten)
        meshes[5] = vs.MeshData(**box_arrays(0.5, mat=4))
        instances.append(sf.InstanceDesc(mesh_id=5,
                                         matrix=xform(0.0, 1.5, -3.0)))
        # a rect area light and its emitter instance
        m_rect = xform(0.0, 6.0, 0.0)
        meshes[3] = vs.make_rect_mesh(1.5, 0.75, 2)
        light_instances.append(sf.LightInstanceDesc(light_id=1, matrix=m_rect))
        instances.append(sf.InstanceDesc(mesh_id=3, matrix=m_rect, light_id=1,
                                         linst_id=0))
        # a mesh light: two instances of an emissive box, found through the
        # mesh's light id
        meshes[4] = vs.MeshData(**box_arrays(0.3, mat=3))
        mesh_light_id[4] = 2
        for k, tx in enumerate((-2.0, 2.0)):
            m_ml = xform(tx, 3.0, 1.0, 1.0, 0.5)
            light_instances.append(sf.LightInstanceDesc(light_id=2,
                                                        matrix=m_ml))
            instances.append(sf.InstanceDesc(mesh_id=4, matrix=m_ml,
                                             linst_id=1 + k))
    return sf.SceneDesc(
        lib_dir="", textures={}, materials=mats, lights=lights, camera=cam,
        settings=settings, meshes=meshes, mesh_light_id=mesh_light_id,
        instances=instances, light_instances=light_instances)


@pytest.mark.parametrize("instancing", ["off", "force"])
@pytest.mark.parametrize("extended", [False, True])
def test_assemble_leaves_bit_exact(extended, instancing):
    js = jscene.assemble(make_desc(JAX, extended), instancing=instancing)
    ps = pscene.assemble(make_desc(PORT, extended), instancing=instancing)
    pl = pscene.scene_leaves(ps)
    _assert_same_leaves(jax_leaves(js), pl)
    assert jax_settings(js) == dataclasses.asdict(ps.settings)
    inst = instancing == "force"
    assert ps.settings.has_inst == inst
    assert ("cl_map" in pl) == inst and ("inst_woop" in pl) == inst
    if inst:
        n_inst = 6 + int(extended)  # world identity + the shared boxes
        assert pl["inst_attr"].shape == (n_inst, 32)
        assert pl["inst_woop"].shape == (n_inst, 4, 4)
        assert pl["cl_map"].shape[1] % 128 == 0
        assert np.array_equal(pl["cl_slot_tri2"][:, 1], pl["cl_slot_inst"])
        # 12 local box triangles + everything that had to flatten
        flat_tris = 2 + (12 + 12 + 2 + 24 if extended else 0)
        assert ps.num_triangles == 12 + flat_tris
    # scene_from_arrays of the JAX scene is the port's own assembly
    _assert_same_leaves(pl, pscene.scene_leaves(to_port(js)))


def test_auto_instancing_rule():
    """'auto' stays flat below INSTANCING_AUTO_TRIS and engages above it
    when the two-level layout stores under 60%."""
    desc = make_desc(PORT, False)
    assert not pscene.assemble(desc, instancing="auto").settings.has_inst
    keep, flat = pscene._partition_instances(desc, {})
    assert len(keep) == 5 and len(flat) == 1
    assert not pscene._should_instance(desc, keep, flat, "auto")
    big = dataclasses.replace(desc.meshes[2], indices=np.zeros(
        (pscene.INSTANCING_AUTO_TRIS // 5 + 1, 3), np.int32))
    desc.meshes[2] = big
    assert pscene._should_instance(desc, keep, flat, "auto")
    assert not pscene._should_instance(desc, keep, flat, "off")
    with pytest.raises(ValueError, match="instancing"):
        pscene.assemble(desc, instancing="always")


def _same_desc(dj, dp):
    assert dataclasses.asdict(dj.settings) == dataclasses.asdict(dp.settings)
    for f in dataclasses.fields(dj.camera):
        a, b = getattr(dj.camera, f.name), getattr(dp.camera, f.name)
        assert np.array_equal(np.asarray(a), np.asarray(b)), f.name
    assert sorted(dj.meshes) == sorted(dp.meshes) == [0, 1, 2]
    for mid in dj.meshes:
        for f in dataclasses.fields(dj.meshes[mid]):
            a, b = getattr(dj.meshes[mid], f.name), getattr(dp.meshes[mid], f.name)
            assert a.dtype == b.dtype and np.array_equal(a, b), (mid, f.name)
    assert dj.mesh_light_id == dp.mesh_light_id == {2: 1}
    assert len(dj.instances) == len(dp.instances) == 5
    for a, b in zip(dj.instances, dp.instances):
        assert (a.mesh_id, a.light_id, a.linst_id) == (b.mesh_id, b.light_id,
                                                       b.linst_id)
        assert np.array_equal(a.matrix, b.matrix)
        assert (a.remap_list is None) == (b.remap_list is None)
        if a.remap_list is not None:
            assert np.array_equal(a.remap_list, b.remap_list)
    assert [(li.light_id, li.matrix.tobytes()) for li in dj.light_instances] \
        == [(li.light_id, li.matrix.tobytes()) for li in dp.light_instances]
    for tab in ("materials", "lights"):
        tj, tp = getattr(dj, tab), getattr(dp, tab)
        assert {k: ET.tostring(v) for k, v in tj.items()} \
            == {k: ET.tostring(v) for k, v in tp.items()}


@pytest.mark.parametrize("instancing", ["off", "force"])
def test_statefile_library_parity(tmp_path, instancing):
    write_library(tmp_path)
    dj = jsf.load_statefile(str(tmp_path))
    dp = psf.load_statefile(str(tmp_path))
    _same_desc(dj, dp)
    assert dp.settings.pt_error == 0.025 and dp.settings.seed == 5
    assert dp.instances[3].remap_list.tolist() == [0, 4]
    js = jscene.assemble(dj, instancing=instancing)
    ps = pscene.load_scene(str(tmp_path), instancing=instancing)
    _assert_same_leaves(jax_leaves(js), pscene.scene_leaves(ps))
    assert jax_settings(js) == dataclasses.asdict(ps.settings)
    assert ps.settings.has_inst == (instancing == "force")


def _desc_with(materials_xml: str, textures: dict, pkg=PORT):
    desc = make_desc(pkg, False)
    desc.materials[0] = ET.fromstring(materials_xml)
    desc.textures.update(textures)
    return desc


def test_unported_bindings_raise(tmp_path):
    """A bound procedural texture whose C source lies in the library is
    compiled from it (ops/proctex_c) and registered before any stdlib
    match, as in the JAX package: "float4 prtex1_main() { }" compiles (it
    raises only when evaluated), both packages give it id 0 and assemble
    the same leaves; one that no stdlib function matches warns and renders
    untextured, as in the JAX package; a bound image texture (refused
    before the port carried textures) assembles with its texels in the
    heap and its gate set, as the JAX package assembles it."""
    from hydracore_tpu.ops import proctex as jproc
    from hydracore_tpu_torch.ops import proctex as pproc

    xml = ('<material id="0" type="hydra_material"><diffuse brdf_type="lambert">'
           '<color val="1 1 1"><texture id="1" type="texref_proc"/></color>'
           '</diffuse></material>')
    (tmp_path / "noise.c").write_text("float4 prtex1_main() { }\n")
    jproc.clear_registry()
    pproc.clear_registry()
    try:
        scenes = []
        for pkg, mod, proc_mod in ((JAX, jscene, jproc), (PORT, pscene, pproc)):
            proc = pkg[0].TextureDesc(id=1, name="falloff", loc="noise.c",
                                      offset=0, bytesize=0,
                                      proc_name="falloff")
            desc = _desc_with(xml, {1: proc}, pkg)
            desc.lib_dir = str(tmp_path)
            scenes.append(mod.assemble(desc))
            assert proc_mod.num_proc_tex() == 1
            assert proc_mod._REGISTRY[0][0].__name__ == "proctex_prtex1_main"
        js, sc = scenes
        _assert_same_leaves(jax_leaves(js), pscene.scene_leaves(sc))
        pproc.clear_registry()
        proc = psf.TextureDesc(id=1, name="noise", loc=None, offset=0,
                               bytesize=0, proc_name="noise")
        with pytest.warns(UserWarning, match="noise"):
            sc = pscene.assemble(_desc_with(xml, {1: proc}))
        assert not sc.settings.has_proc_tex and pproc.num_proc_tex() == 0
    finally:
        jproc.clear_registry()
        pproc.clear_registry()

    img = np.full((2, 2, 4), 128, np.uint8)
    (tmp_path / "t.image4ub").write_bytes(struct.pack("<ii", 2, 2) + img.tobytes())
    tex = psf.TextureDesc(id=1, name="t", loc="t.image4ub", offset=0,
                          bytesize=24)
    desc = _desc_with(
        '<material id="0" type="hydra_material"><diffuse brdf_type="lambert">'
        '<color val="1 1 1"/><texture id="1" type="texref"/></diffuse>'
        '</material>', {1: tex})
    desc.lib_dir = str(tmp_path)
    sc = pscene.assemble(desc)
    assert sc.settings.has_diff_tex and sc.texels.shape[0] == 1 + 4
