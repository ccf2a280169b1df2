"""Textured and alpha scenes for the port's parity tests.

Each recipe builds a scene with a package's SceneBuilder, packs its
textures into that package's TextureStorage and finalizes it again with
that heap (the way tests/test_aux_subsystems.py and tests/test_envmap.py
build theirs): pkg "jax" (the JAX package, whose scenes tests carry to the
port with tests/test_torch_scene.py:to_port) or "port".
textured_desc writes a scene library's textures and IES profile to a
directory and returns the same SceneDesc for either package, for
assemble.
"""
import dataclasses
import struct
import xml.etree.ElementTree as ET

import numpy as np

from hydracore_tpu.lights import ies as jies
from hydracore_tpu.scene import procedural as jproc
from hydracore_tpu.scene import scene as jscene
from hydracore_tpu.scene import textures as jtex
from hydracore_tpu.scene.lights import LIGHT_POINT, LIGHT_SPOT
from hydracore_tpu.scene.textures import TEX_CLAMP_U, TEX_CLAMP_V
from hydracore_tpu_torch.lights import ies as pies
from hydracore_tpu_torch.scene import procedural as pproc
from hydracore_tpu_torch.scene import scene as pscene
from hydracore_tpu_torch.scene import textures as ptex

SIZE = 32

# (SceneBuilder, TextureStorage, finalize_scene, replace, IES module)
PKGS = {"jax": (jproc.SceneBuilder, jtex.TextureStorage, jscene.finalize_scene,
                lambda sc, **kw: sc.replace(**kw), jies),
        "port": (pproc.SceneBuilder, ptex.TextureStorage,
                 pscene.finalize_scene, dataclasses.replace, pies)}

# a profile that falls from 1000 cd along the axis to 0 at 180 degrees
IES_TEXT = """IESNA:LM-63-1995
[TEST] synthetic
TILT=NONE
1 1000.0 1.0 5 3 1 2 0.0 0.0 0.0
1.0 1.0 0.0
0.0 45.0 90.0 135.0 180.0
0.0 45.0 90.0
1000.0 800.0 300.0 50.0 0.0
900.0 600.0 250.0 40.0 0.0
700.0 500.0 200.0 30.0 0.0
"""


def image(h, w, seed, lo=0.05, hi=1.0):
    """(h, w, 4) random rgb in [lo, hi), alpha 1."""
    rng = np.random.default_rng(seed)
    img = np.ones((h, w, 4), np.float32)
    img[..., :3] = rng.uniform(lo, hi, (h, w, 3))
    return img


def normal_map(h, w, seed):
    """A tangent-space normal map stored in [0, 1]: random tilts up to
    about 40 degrees."""
    rng = np.random.default_rng(seed)
    n = np.concatenate([rng.uniform(-0.8, 0.8, (h, w, 2)),
                        np.ones((h, w, 1))], -1)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    out = np.ones((h, w, 4), np.float32)
    out[..., :3] = n * 0.5 + 0.5
    return out


def opacity_map(h, w):
    """Checker of opacities 0, 0.35, 0.7 and 1 in channel 0."""
    ys, xs = np.mgrid[0:h, 0:w]
    levels = np.array([0.0, 0.35, 0.7, 1.0], np.float32)
    img = np.ones((h, w, 4), np.float32)
    img[..., 0] = levels[(xs // 2 + ys // 2) % 4]
    return img


def ies_texture(pkg="jax"):
    ies = PKGS[pkg][4]
    v, h, c = ies.parse_ies(IES_TEXT)
    tex, _ = ies.ies_to_texture(v, h, c, n_theta=16, n_phi=8)
    return tex


def _finish(pkg, b, storage, cam_pos, cam_lookat, depth=4, **kw):
    """Build, then finalize again with the storage's heap and the fields
    (settings flags among them) in kw."""
    _, _, finalize, replace, _ = PKGS[pkg]
    sc = b.build(cam_pos=cam_pos, cam_lookat=cam_lookat, width=SIZE,
                 height=SIZE, trace_depth=depth, **kw.pop("build", {}))
    texels, table, samplers = storage.finalize()
    flags = kw.pop("flags", {})
    if flags:
        kw["settings"] = dataclasses.replace(sc.settings, **flags)
    return finalize(replace(sc, texels=texels, tex_table=table,
                            tex_sampler=samplers, **kw))


def _box(b, floor, back, left, right):
    """An open box of half size 2 without a ceiling: floor, back, sides."""
    ex, ey, ez = [2, 0, 0], [0, 2, 0], [0, 0, 2]
    b.add_rect([0, -2, 0], ex, ez, floor, flip=True)
    b.add_rect([0, 0, -2], ex, ey, back)
    b.add_rect([-2, 0, 0], ey, ez, left)
    b.add_rect([2, 0, 0], ey, ez, right, flip=True)


def surfaces(pkg="jax"):
    """Diffuse textures with wrap (tiled 3x by the texcoord matrix) and
    clamp (shifted past the edge) addressing, a reflection texture on a
    GGX panel, an emission texture, a translucency texture, a normal map,
    a mask blend and a Fresnel blend; a rect light and an IES point
    light."""
    SceneBuilder, TextureStorage = PKGS[pkg][:2]
    st = TextureStorage()
    tile = np.diag([3.0, 3.0, 1.0, 1.0])
    shift = np.eye(4)
    shift[0, 3], shift[1, 3] = -0.4, 0.3
    floor_t = st.add(image(16, 16, 1), matrix=tile)
    back_t = st.add(image(8, 12, 2), matrix=shift,
                    flags=TEX_CLAMP_U | TEX_CLAMP_V)
    side_t = st.add(image(8, 8, 3), flags=TEX_CLAMP_U)
    refl_t = st.add(image(8, 8, 4, 0.3, 1.0))
    em_t = st.add(image(4, 4, 5))
    transl_t = st.add(image(8, 8, 6))
    bump_t = st.add(normal_map(16, 16, 7))
    mask_t = st.add(image(8, 8, 8, 0.0, 1.0))
    ies_t = st.add(ies_texture(pkg))

    b = SceneBuilder()
    floor = b.add_material(diff_color=np.array([0.8, 0.8, 0.8], np.float32),
                           diff_tex=floor_t, bump_tex=bump_t)
    green = b.lambert([0.2, 0.6, 0.25])
    back = b.add_material(diff_color=np.array([0.9, 0.6, 0.4], np.float32),
                          diff_tex=back_t, blend_node=green, blend_type=1,
                          blend_tex=mask_t)
    left = b.add_material(diff_color=np.array([0.7, 0.7, 0.7], np.float32),
                          diff_tex=side_t, bump_tex=bump_t)
    mirror = b.add_material(refl_color=np.array([0.9, 0.9, 0.9], np.float32),
                            refl_dist=4)
    right = b.add_material(diff_color=np.array([0.3, 0.3, 0.6], np.float32),
                           blend_node=mirror, blend_type=2, blend_ior=1.7)
    _box(b, floor, back, left, right)
    ggx = b.add_material(refl_color=np.array([0.8, 0.7, 0.5], np.float32),
                         refl_tex=refl_t, refl_dist=2, refl_alpha=0.3,
                         refl_gloss=0.7)
    b.add_rect([-0.7, -1.2, -0.5], [0.6, 0, 0.2], [0, 0.6, 0], ggx)
    glow = b.add_material(em_color=np.array([2.0, 2.0, 2.0], np.float32),
                          em_tex=em_t)
    b.add_rect([1.2, 0.8, -1.9], [0.3, 0, 0], [0, 0.3, 0], glow)
    leaf = b.add_material(diff_color=np.array([0.3, 0.5, 0.2], np.float32),
                          transl_color=np.array([0.5, 0.6, 0.3], np.float32),
                          transl_tex=transl_t)
    b.add_rect([0.8, -0.8, 0.3], [0.5, 0, 0], [0, 0.6, 0.3], leaf)
    b.rect_light([0, 1.95, 0], 0.5, 0.5, [10.0] * 3)
    for ltype, pos in ((LIGHT_POINT, [1.2, 1.5, 1.0]),
                       (LIGHT_SPOT, [-1.2, 1.5, 0.5])):
        b.add_light(ltype=ltype, pos=np.array(pos, np.float32),
                    intensity=np.array([4.0, 4.0, 4.0], np.float32),
                    norm=np.array([0.2, -1.0, -0.3], np.float32)
                    / np.linalg.norm([0.2, -1.0, -0.3]),
                    cos_in=0.8, cos_out=0.5, tex=ies_t)
    return _finish(pkg, b, st, [0, 0.3, 6.5], [0, -0.3, 0])


def sky_tree(pkg="jax"):
    """An open scene under a lat-long sky image, with a camera-projected
    back plate and a two-level blend tree (mask over a falloff blend of
    two leaves)."""
    env = image(8, 16, 11, 0.2, 2.0)
    env[2, 5, :3] = 40.0  # a sun: the env pdf has a peak to sample
    SceneBuilder, TextureStorage = PKGS[pkg][:2]
    st = TextureStorage()
    env_t = st.add(env)
    mask_t = st.add(image(8, 8, 12, 0.0, 1.0))
    back_t = st.add(image(8, 8, 13, 0.0, 3.0))
    wood_t = st.add(image(8, 8, 14))

    b = SceneBuilder()
    b.sky([1.0, 1.0, 1.0], img=env)  # build() puts env at slot 1 as well
    floor = b.lambert([0.6, 0.6, 0.6])
    b.add_rect([0, -1.2, 0], [4, 0, 0], [0, 0, 4], floor, flip=True)
    red = b.lambert([0.8, 0.15, 0.1])
    wood = b.add_material(diff_color=np.array([0.8, 0.8, 0.8], np.float32),
                          diff_tex=wood_t)
    gold = b.add_material(refl_color=np.array([0.9, 0.7, 0.3], np.float32),
                          refl_dist=2, refl_alpha=0.2, refl_gloss=0.8)
    # a blend record holds its top leaf and points at its bottom leaf; the
    # root's top is another blend record (blend_top)
    inner = b.add_material(diff_color=np.array([0.8, 0.8, 0.8], np.float32),
                           diff_tex=wood_t, blend_node=gold, blend_type=3)
    root = b.add_material(blend_node=red, blend_top=inner, blend_type=1,
                          blend_tex=mask_t)
    b.add_rect([0, 0, -1], [1.2, 0, 0], [0, 1.0, 0.3], root)
    b.add_rect([1.5, -0.5, 0.5], [0.4, 0, 0.3], [0, 0.6, 0], wood)
    env_back = np.zeros(8, np.float32)
    env_back[:6] = [back_t, 2.0, 1.0, 1.0, 0.8, 0.6]  # camera-projected
    sc = _finish(pkg, b, st, [0, 0.4, 5.0], [0, 0, 0], env_back=env_back,
                 flags=dict(has_env_back=True))
    assert int(np.asarray(sc.lights.tex).max()) == env_t
    return sc


def alpha(pkg="jax", sphere_segments: int = 0, **build):
    """Opacity-mapped quads over a lit floor (three layers deep in
    places), a skip-shadow quad and an opaque blocker; a point light and a
    rect light above, so shadow rays cross up to three soft layers. With
    sphere_segments an opaque sphere of that many segments and rings joins
    (96 make a pool of over 128 clusters). `build` goes to
    SceneBuilder.build (the port's traversal= and part_cap=)."""
    SceneBuilder, TextureStorage = PKGS[pkg][:2]
    st = TextureStorage()
    op_t = st.add(opacity_map(8, 8))
    op2_t = st.add(opacity_map(4, 4), flags=TEX_CLAMP_V)
    b = SceneBuilder()
    floor = b.lambert([0.8, 0.8, 0.8])
    b.add_rect([0, 0, 0], [3, 0, 0], [0, 0, 3], floor, flip=True)
    soft = b.add_material(diff_color=np.array([0.7, 0.3, 0.2], np.float32),
                          opacity_tex=op_t)
    soft2 = b.add_material(diff_color=np.array([0.2, 0.5, 0.7], np.float32),
                           opacity_tex=op2_t)
    catcher = b.add_material(diff_color=np.array([0.5, 0.5, 0.2], np.float32),
                             skip_shadow=1)
    for k, (y, m) in enumerate(((0.6, soft), (1.0, soft2), (1.4, soft))):
        b.add_rect([0.3 * k - 0.3, y, 0.2 * k], [1.2, 0, 0.1], [0, 0, 1.2], m,
                   flip=True)
    b.add_rect([-1.6, 0.8, -1.2], [0.5, 0, 0], [0, 0, 0.5], catcher, flip=True)
    b.add_rect([1.5, 1.2, 1.3], [0.4, 0, 0], [0, 0, 0.4], floor, flip=True)
    if sphere_segments:
        b.add_sphere([1.2, 0.7, -1.0], 0.5, floor, n_seg=sphere_segments,
                     n_ring=sphere_segments)
    b.point_light([0.2, 2.5, 0.1], [14.0] * 3)
    b.rect_light([-0.8, 2.2, 0.8], 0.4, 0.4, [8.0] * 3)
    return _finish(pkg, b, st, [0, 3.5, 3.5], [0, 0, 0], build=build)


RECIPES = {"surfaces": surfaces, "sky_tree": sky_tree, "alpha": alpha}


# ---------------------------------------------------------------------------
# A scene library's textures through assemble
# ---------------------------------------------------------------------------

def _image4ub(img) -> bytes:
    h, w = img.shape[:2]
    px = np.clip(np.round(img * 255.0), 0, 255).astype(np.uint8)
    return struct.pack("<ii", w, h) + px.tobytes()


def _image4f(img) -> bytes:
    h, w = img.shape[:2]
    return struct.pack("<ii", w, h) + img.astype(np.float32).tobytes()


def rect_arrays(c, vx, vy, mat, n_uv=1.0):
    c, vx, vy = (np.asarray(x, np.float32) for x in (c, vx, vy))
    v = np.stack([c - vx - vy, c + vx - vy, c + vx + vy, c - vx + vy])
    n = np.cross(vx, vy)
    n = n / np.linalg.norm(n)
    t = vx / np.linalg.norm(vx)
    return dict(
        pos=np.concatenate([v, np.ones((4, 1), np.float32)], 1),
        norm=np.tile(np.append(n, 0).astype(np.float32), (4, 1)),
        tang=np.tile(np.append(t, 0).astype(np.float32), (4, 1)),
        texcoord=np.array([[0, 0], [n_uv, 0], [n_uv, n_uv], [0, n_uv]],
                          np.float32),
        indices=np.asarray([(0, 1, 2), (0, 2, 3)], np.int32),
        mat_indices=np.full(2, mat, np.int32))


def textured_desc(pkg, lib_dir, size: int = SIZE):
    """A SceneDesc for the package pkg = (statefile module, vsgf module)
    whose textures (image4ub and image4f) and IES profile are written to
    lib_dir: a wrap-addressed diffuse floor, a clamp-addressed wall with a
    height map (baked to a normal map), a mask blend, a two-level blend
    tree, an opacity-mapped quad, a point light with an IES profile, a
    rect light and a sky image with a camera-projected back plate."""
    import os

    sf, vs = pkg
    files = {1: ("floor.image4ub", _image4ub(image(16, 16, 21))),
             2: ("wall.image4ub", _image4ub(image(8, 8, 22))),
             3: ("height.image4ub", _image4ub(image(16, 16, 23, 0.0, 1.0))),
             4: ("mask.image4ub", _image4ub(image(8, 8, 24, 0.0, 1.0))),
             5: ("leaf.image4ub", _image4ub(opacity_map(8, 8))),
             6: ("sky.image4f", _image4f(image(8, 16, 25, 0.2, 2.0))),
             7: ("plate.image4ub", _image4ub(image(8, 8, 26)))}
    textures = {}
    for tid, (name, data) in files.items():
        with open(os.path.join(lib_dir, name), "wb") as f:
            f.write(data)
        textures[tid] = sf.TextureDesc(id=tid, name=name, loc=name, offset=0,
                                       bytesize=len(data))
    with open(os.path.join(lib_dir, "lamp.ies"), "w") as f:
        f.write(IES_TEXT)
    mats = {
        0: '<material id="0" type="hydra_material"><diffuse><color val="0.8 '
           '0.8 0.8"/><texture id="1" type="texref" matrix="3 0 0 0 0 3 0 0 '
           '0 0 1 0 0 0 0 1"/></diffuse></material>',
        1: '<material id="1" type="hydra_material"><diffuse><color val="0.9 '
           '0.7 0.5"/><texture id="2" type="texref" addressing_mode_u="clamp" '
           'addressing_mode_v="clamp" matrix="1.5 0 0 -0.2 0 1.5 0 -0.2 0 0 1 '
           '0 0 0 0 1"/></diffuse><displacement type="height_bump">'
           '<height_map amount="0.8"><texture id="3" type="texref"/>'
           '</height_map></displacement></material>',
        2: '<material id="2" type="hydra_material"><diffuse><color val="0.2 '
           '0.6 0.3"/></diffuse></material>',
        3: '<material id="3" type="hydra_material"><reflectivity '
           'brdf_type="ggx"><color val="0.8 0.7 0.4"/><glossiness val="0.8"/>'
           '</reflectivity></material>',
        4: '<material id="4" type="hydra_blend" node_top="1" node_bottom="2">'
           '<blend type="mask_blend"><mask><texture id="4" type="texref"/>'
           '</mask></blend></material>',
        5: '<material id="5" type="hydra_blend" node_top="4" node_bottom="3">'
           '<blend type="fresnel_blend" fresnel_ior="1.6"/></material>',
        6: '<material id="6" type="hydra_material"><diffuse><color val="0.6 '
           '0.3 0.2"/></diffuse><opacity><texture id="5" type="texref"/>'
           '</opacity></material>',
        7: '<material id="7" type="hydra_material" light_id="1"><emission>'
           '<color val="8 8 8"/></emission></material>',
    }
    lights = {
        0: '<light id="0" type="sky" shape="point"><intensity><color val="1 1 '
           '1"/><texture id="6" type="texref"/></intensity><back mode="camera_'
           'mapped" multcolor="1 0.9 0.8"><texture id="7" type="texref"/>'
           '</back></light>',
        1: '<light id="1" type="area" shape="rect"><size half_length="0.4" '
           'half_width="0.4"/><intensity><color val="8 8 8"/></intensity>'
           '</light>',
        2: '<light id="2" type="point" shape="point"><intensity><color val="5 '
           '5 5"/></intensity><ies data="lamp.ies"/></light>',
    }
    meshes = {
        0: rect_arrays([0, -1, 0], [3, 0, 0], [0, 0, -3], 0, 2.0),
        1: rect_arrays([0, 0.2, -2], [2, 0, 0], [0, 1.2, 0], 1),
        2: rect_arrays([-1.2, -0.3, 0], [0, 0, 0.6], [0, 0.7, 0], 5),
        3: rect_arrays([1.2, -0.3, 0.2], [0, 0, -0.6], [0, 0.7, 0], 4),
        4: rect_arrays([0, 0.3, 0.8], [0.7, 0, 0], [0, 0, -0.7], 6),
        5: rect_arrays([0, 0, 0], [0.4, 0, 0], [0, 0, 0.4], 7),
    }
    m_light = np.eye(4, dtype=np.float32)
    m_light[:3, 3] = [0, 1.9, 0]
    m_lamp = np.eye(4, dtype=np.float32)
    m_lamp[:3, 3] = [0.8, 1.2, 0.5]
    instances = [sf.InstanceDesc(mesh_id=k, matrix=np.eye(4, dtype=np.float32))
                 for k in range(5)]
    instances.append(sf.InstanceDesc(mesh_id=5, matrix=m_light, light_id=1,
                                     linst_id=0))
    cam = sf.CameraDesc()
    cam.position = np.array([0, 0.5, 4.5], np.float32)
    cam.look_at = np.array([0, -0.2, 0], np.float32)
    return sf.SceneDesc(
        lib_dir=str(lib_dir), textures=textures,
        materials={k: ET.fromstring(v) for k, v in mats.items()},
        lights={k: ET.fromstring(v) for k, v in lights.items()}, camera=cam,
        settings=sf.RenderSettings(width=size, height=size, trace_depth=4),
        meshes={k: vs.MeshData(**v) for k, v in meshes.items()},
        mesh_light_id={}, instances=instances,
        light_instances=[sf.LightInstanceDesc(light_id=1, matrix=m_light),
                         sf.LightInstanceDesc(light_id=2, matrix=m_lamp)])
