"""The regenerating wavefront: the port's integrators/pt_regen.py against
the JAX package's, and against the port's own pass loop (itself held to
the JAX package by tests/test_torch_pt*.py), on the scenes of
tests/test_regen.py.

The two schedules draw the same (pixel, pass) sample set through the same
counter-RNG streams, each regenerated lane keyed by its own depth, so the
images agree to accumulation order: rtol 2e-4, atol 2e-5 (the rule of
tests/test_regen.py), the ray counters within 2%. rand4 with a per-lane
depth tensor is bit-exact with the JAX package's, depths past max_depth
included. Scenes come from the JAX package's builders and cross with
to_port (the instanced one, which scene_from_arrays refuses, is assembled
by the port from the same description).
"""
import dataclasses
import xml.etree.ElementTree as ET

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hydracore_tpu.integrators import pt_regen as jregen
from hydracore_tpu.ops import rng as jrng
from hydracore_tpu.scene.procedural import SceneBuilder
from hydracore_tpu.scene.scene import finalize_scene
from hydracore_tpu.scene.textures import TextureStorage
from hydracore_tpu_torch.integrators import pt as tpt
from hydracore_tpu_torch.integrators import pt_regen as tregen
from hydracore_tpu_torch.ops import rng as trng
from hydracore_tpu_torch.scene import scene as pscene
from hydracore_tpu_torch.scene import statefile as psf
from hydracore_tpu_torch.scene import vsgf as pvsgf
from tests.test_instancing import _box_mesh, _mat, _plane_mesh, _xform
from tests.test_regen import _scene as plain_scene
from tests.test_torch_scene import to_port

torch.set_num_threads(1)

RTOL, ATOL = 2e-4, 2e-5


def test_rand4_per_lane_depth_bit_exact():
    """4,096 seeded (sample, depth, group) triples, depths 0..11 (past any
    max_depth a regenerated lane counts to), every group of the path
    tracer: bits equal."""
    rng = np.random.default_rng(4096)
    sidx = rng.integers(0, 2**32, 4096, dtype=np.uint64).astype(np.uint32)
    depth = rng.integers(0, 12, 4096).astype(np.int32)
    depth[:4] = [0, 8, 9, 11]
    for group in range(7):
        j = np.asarray(jrng.rand4(jnp.asarray(sidx), jnp.asarray(depth), group,
                                  777))
        p = trng.rand4(trng.u32(sidx), torch.tensor(depth), group, 777).numpy()
        assert np.array_equal(j.view(np.uint32), p.view(np.uint32)), group
    # a tensor of one depth draws what the int draws
    d3 = torch.full((4096,), 3, dtype=torch.int64)
    assert torch.equal(trng.rand4(trng.u32(sidx), d3, 2, 5),
                       trng.rand4(trng.u32(sidx), 3, 2, 5))


def _close(a, b, rays_a, rays_b):
    a, b = np.asarray(a), np.asarray(b)
    assert np.isfinite(b).all() and b.mean() > 0.0
    assert np.allclose(a, b, rtol=RTOL, atol=ATOL), \
        f"max abs diff {np.abs(a - b).max():.3e}"
    assert abs(float(rays_a) - float(rays_b)) / max(float(rays_a), 1) < 0.02


def test_regen_matches_jax_regen():
    """The plain scene of tests/test_regen.py (16x16, 6 passes from pass
    3, seed 77): the port's regen against the JAX package's."""
    js = plain_scene()
    assert jregen.regen_supported(js)
    fb_j, rays_j = jregen.render_passes_regen(js, jnp.uint32(3),
                                              jnp.uint32(77), n_pass=6,
                                              max_depth=5)
    ps = to_port(js)
    assert tregen.regen_supported(ps)
    stats = {}
    fb_p, rays_p = tregen.render_passes_regen(ps, 3, 77, n_pass=6,
                                              max_depth=5, device="cpu",
                                              stats=stats)
    _close(fb_j, fb_p.numpy(), rays_j, rays_p)
    assert stats["iterations"] == 5  # 1,536 lanes hold every sample at once


def _sky_alpha():
    b = SceneBuilder()
    m = b.lambert([0.65, 0.6, 0.55])
    b.add_rect([0, -1.0, 0], [3, 0, 0], [0, 0, 3], m, flip=True)
    storage = TextureStorage()
    otex = np.zeros((1, 1, 4), np.float32)
    otex[..., 0] = 0.45
    oslot = storage.add(otex, gamma=1.0)
    occm = b.add_material(diff_color=np.full(3, 0.3, np.float32),
                          opacity_tex=oslot)
    b.add_rect([0, 0.3, 0], [1.2, 0, 0], [0, 0, 1.2], occm, flip=True)
    sky_img = np.ones((8, 16, 4), np.float32)
    sky_img[:, :8, :3] = 0.2
    b.sky([0.5, 0.55, 0.6], img=sky_img)
    b.rect_light([0, 2.2, 0], 0.5, 0.5, [9.0] * 3)
    sc = b.build(cam_pos=[0, 1.8, 4.0], cam_lookat=[0, -0.5, 0], width=12,
                 height=12, trace_depth=4)
    texels, table, samplers = storage.finalize()
    sc = finalize_scene(sc.replace(texels=texels, tex_table=table,
                                   tex_sampler=samplers))
    return to_port(sc), (1, 5, 4, 4)  # pass_base, seed, n_pass, max_depth


def _fog_glass():
    b = SceneBuilder()
    m = b.lambert([0.6, 0.6, 0.6])
    glass = b.add_material(transp_color=np.array([0.9, 0.9, 0.9], np.float32),
                           transp_gloss=1.0, transp_ior=1.5,
                           fog_color=np.array([0.85, 0.4, 0.4], np.float32),
                           fog_mult=np.float32(2.0))
    b.add_box_interior(2.0, m, m, m, m, m)
    b.add_sphere([0, 0, 0.8], 0.7, glass, n_seg=10, n_ring=5)
    b.rect_light([0, 1.95, 0], 0.5, 0.5, [10.0] * 3)
    sc = b.build(cam_pos=[0, 0, 5.5], cam_lookat=[0, 0, 0], width=10,
                 height=10, trace_depth=5)
    return to_port(sc), (0, 9, 4, 5)


def _sss():
    b = SceneBuilder()
    m = b.lambert([0.6, 0.6, 0.6])
    sss = b.add_material(diff_color=np.full(3, 0.4, np.float32),
                         sss_transmission=np.float32(0.7),
                         sss_density=np.float32(1.5),
                         sss_scattering=np.float32(1.0),
                         sss_absorption=np.array([0.2, 0.4, 0.4], np.float32),
                         sss_phase=np.float32(0.3))
    b.add_box_interior(2.0, m, m, m, m, m)
    b.add_sphere([0, -0.8, 0.5], 0.8, sss, n_seg=10, n_ring=5)
    b.rect_light([0, 1.95, 0], 0.6, 0.6, [11.0] * 3)
    sc = b.build(cam_pos=[0, 0, 5.5], cam_lookat=[0, 0, 0], width=10,
                 height=10, trace_depth=5)
    return to_port(sc), (2, 11, 4, 5)


def _port_mesh(m):
    return pvsgf.MeshData(**dataclasses.asdict(m))


def _instanced():
    """tests/test_regen.py's instanced scene (a plane and three boxes under
    a sky), assembled by the port with instancing forced: the cluster
    route, so the regen loop sorts its lanes every iteration."""
    lights = {0: ET.fromstring(
        '<light id="0" type="sky" shape="sky" distribution="uniform">'
        '<intensity><color val="0.6 0.7 0.9"/>'
        '<multiplier val="1"/></intensity></light>')}
    cam = psf.CameraDesc()
    cam.position = np.array([0, 4, 14], np.float32)
    cam.look_at = np.array([0, 0, 0], np.float32)
    instances = [psf.InstanceDesc(mesh_id=1, matrix=_xform(0, -1.0, 0))]
    for tx, tz, s, ry in [(-3, -2, 1.0, 0.3), (0, 0, 0.7, 1.1),
                          (3, -1, 1.3, 2.0)]:
        instances.append(psf.InstanceDesc(mesh_id=2,
                                          matrix=_xform(tx, 0.0, tz, s, ry)))
    desc = psf.SceneDesc(
        lib_dir="", textures={}, materials={0: _mat(0, "0.7 0.3 0.2"),
                                            1: _mat(1, "0.5 0.5 0.5")},
        lights=lights, camera=cam,
        settings=psf.RenderSettings(width=20, height=20, trace_depth=3),
        meshes={1: _port_mesh(_plane_mesh()), 2: _port_mesh(_box_mesh())},
        mesh_light_id={}, instances=instances, light_instances=[])
    sc = pscene.assemble(desc, instancing="force")
    assert sc.settings.has_inst
    return sc, (0, 7, 4, 3)


def _plain_few_lanes():
    return to_port(plain_scene()), (3, 77, 6, 5)


SCENES = {"sky_alpha": _sky_alpha, "fog_glass": _fog_glass, "sss": _sss,
          "instanced_sorted": _instanced, "plain_96_lanes": _plain_few_lanes}


@pytest.mark.parametrize("name", list(SCENES))
def test_regen_matches_pass_loop(name):
    """Each scene's gate rides the regen state: alpha pass-through and the
    sky image (sky_alpha), the fog state machine, the SSS medium walk, the
    whole lane state through the per-iteration permute (instanced_sorted);
    plain_96_lanes refills 96 lanes about 40 times."""
    ps, (base, seed, n_pass, md) = SCENES[name]()
    st = ps.settings
    gate = {"sky_alpha": st.has_alpha and st.has_sky, "fog_glass": st.has_fog,
            "sss": st.has_sss, "instanced_sorted": st.has_inst,
            "plain_96_lanes": True}[name]
    assert gate and tregen.regen_supported(ps)
    fb_a, rays_a = tpt.render_passes(ps, base, seed, n_pass=n_pass,
                                     max_depth=md, device="cpu")
    lanes = 96 if name == "plain_96_lanes" else None
    stats = {}
    fb_b, rays_b = tregen.render_passes_regen(ps, base, seed, n_pass=n_pass,
                                              max_depth=md, lanes=lanes,
                                              device="cpu", stats=stats)
    _close(fb_a.numpy(), fb_b.numpy(), rays_a, rays_b)
    if lanes:
        assert stats["iterations"] > 30


def test_duplicate_splat_accumulates():
    """6x6 frame, 4 passes: the 144 lanes hold every pixel four times
    abreast, and their death splats must add up (index_add_), as the pass
    loop's four passes do."""
    b = SceneBuilder()
    m = b.lambert([0.6, 0.55, 0.5])
    mirror = b.add_material(refl_color=np.array([0.85] * 3, np.float32))
    b.add_box_interior(2.0, m, m, m, b.lambert([0.7, 0.1, 0.1]), m)
    b.add_sphere([-0.6, -1.2, 0.2], 0.7, mirror, n_seg=12, n_ring=6)
    b.rect_light([0, 1.95, 0], 0.6, 0.6, [13.0] * 3)
    ps = to_port(b.build(cam_pos=[0, 0, 5.5], cam_lookat=[0, 0, 0], width=6,
                         height=6, trace_depth=5))
    fb_a, rays_a = tpt.render_passes(ps, 0, 13, n_pass=4, max_depth=5,
                                     device="cpu")
    fb_b, rays_b = tpt.render_passes(ps, 0, 13, n_pass=4, max_depth=5,
                                     device="cpu", regen=True)
    _close(fb_a.numpy(), fb_b.numpy(), rays_a, rays_b)
    one, _ = tpt.render_passes(ps, 0, 13, n_pass=1, max_depth=5, device="cpu")
    assert float(fb_b.sum()) > 1.5 * float(one.sum())


@pytest.mark.parametrize("field,value", [("render_layer", "direct"),
                                         ("pt_caustics", False)])
def test_unsupported_scenes_take_the_pass_loop(field, value):
    """regen_supported refuses the direct layer and caustics-off, in both
    packages; render_passes(regen=True) then runs the pass loop."""
    js = plain_scene()
    js = js.replace(settings=dataclasses.replace(js.settings, **{field: value}))
    ps = to_port(js)
    assert not jregen.regen_supported(js) and not tregen.regen_supported(ps)
    fb_a, rays_a = tpt.render_passes(ps, 1, 3, n_pass=2, max_depth=4,
                                     device="cpu")
    fb_b, rays_b = tpt.render_passes(ps, 1, 3, n_pass=2, max_depth=4,
                                     device="cpu", regen=True, lanes=16)
    assert torch.equal(fb_a, fb_b) and int(rays_a) == int(rays_b)
