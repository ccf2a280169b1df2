"""Light tracing in the port: lights/sampling.py:sample_light_fwd and
integrators/lt.py against the JAX package on the same inputs, and the
port's LT against the port's PT.

Tolerances:
  * sample_light_fwd: every field at rtol 1e-5, atol 1e-6 (the rule of
    tests/test_torch_texture.py for light lookups: transcendentals differ
    by ulps);
  * lt_pass: >= 99% of pixels within 1e-3 of the JAX image (the image rule
    of tests/test_torch_pt.py; a splat may move across a pixel edge when
    the view matrix or a hit point differs by an ulp) and total energy
    within rtol 1e-4;
  * LT against PT: the criteria of tests/test_lt_gbuffer.py (mean within
    12% off directly seen emitters, median 4x4-block error < 25%).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests.textured_scenes as ts
from hydracore_tpu.integrators import lt as jlt
from hydracore_tpu.lights import sampling as jsamp
from hydracore_tpu.scene.lights import (LIGHT_AREA_DISK, LIGHT_AREA_RECT,
                                        LIGHT_CYLINDER, LIGHT_DIRECT,
                                        LIGHT_MESH, LIGHT_POINT, LIGHT_SKY,
                                        LIGHT_SPHERE, LIGHT_SPOT)
from hydracore_tpu.scene.procedural import SceneBuilder
from hydracore_tpu_torch.integrators import lt as tlt
from hydracore_tpu_torch.integrators import pt as tpt
from hydracore_tpu_torch.lights import sampling as tsamp
from tests.test_torch_scene import to_port

torch.set_num_threads(1)

N = 2048
TOL = dict(rtol=1e-5, atol=1e-6)
TYPES = {"rect": LIGHT_AREA_RECT, "disk": LIGHT_AREA_DISK,
         "sphere": LIGHT_SPHERE, "cylinder": LIGHT_CYLINDER,
         "mesh": LIGHT_MESH, "point": LIGHT_POINT, "spot": LIGHT_SPOT,
         "direct": LIGHT_DIRECT, "sky": LIGHT_SKY}


def _close(a, b) -> float:
    return float((np.abs(np.asarray(a) - np.asarray(b)).max(-1) <= 1e-3).mean())


def _all_lights():
    """A closed box holding one light of every type (a textured sky)."""
    b = SceneBuilder()
    m = b.lambert([0.6, 0.6, 0.6])
    b.add_box_interior(2.0, m, m, m, m, m)
    b.rect_light([0.5, 1.95, 0.2], 0.4, 0.3, [9.0, 8.0, 7.0])
    b.add_light(ltype=LIGHT_AREA_DISK, pos=np.array([-1.0, 1.9, 0], np.float32),
                norm=np.array([0, -1, 0], np.float32),
                vx=np.array([0.3, 0, 0], np.float32),
                vy=np.array([0, 0, 0.3], np.float32),
                intensity=np.array([5.0, 5.0, 5.0], np.float32),
                area=float(np.pi * 0.09))
    b.sphere_light([1.2, 1.2, -1.0], 0.2, [6.0, 5.0, 4.0])
    b.cylinder_light([-1.2, 0.5, -1.2], half_height=0.4, radius=0.1,
                     radiance=[3.0, 3.0, 3.0], n_seg=8)
    ml = b.mesh_light([4.0, 4.0, 2.0])
    em = b.emissive([4.0, 4.0, 2.0], light_id=ml)
    b.add_rect([0.0, -1.5, -1.9], [0.4, 0, 0], [0, 0.3, 0], em, light=ml)
    b.add_rect([1.9, -1.0, 0.0], [0, 0, 0.3], [0, 0.3, 0], em, light=ml)
    b.point_light([0.0, 0.5, 0.5], [7.0, 7.0, 7.0])
    b.add_light(ltype=LIGHT_SPOT, pos=np.array([0.3, 1.8, -0.3], np.float32),
                norm=np.array([0.1, -1, 0.05], np.float32) / np.linalg.norm(
                    [0.1, -1, 0.05]).astype(np.float32),
                intensity=np.array([8.0, 8.0, 8.0], np.float32),
                cos_in=np.float32(np.cos(np.radians(25.0))),
                cos_out=np.float32(np.cos(np.radians(45.0))))
    b.add_light(ltype=LIGHT_DIRECT,
                norm=np.array([0.3, -0.9, 0.2], np.float32) / np.linalg.norm(
                    [0.3, -0.9, 0.2]).astype(np.float32),
                intensity=np.array([2.0, 2.0, 2.0], np.float32))
    sky = ts.image(16, 32, 5, lo=0.2, hi=2.0)
    b.sky([0.7, 0.8, 1.0], img=sky)
    return b.build(cam_pos=[0, 0, 5.6], cam_lookat=[0, 0, 0], width=16,
                   height=12, trace_depth=4)


@pytest.fixture(scope="module")
def lights():
    js = _all_lights()
    return js, to_port(js)


def _fwd_pair(js, ps, rows, seed):
    rng = np.random.default_rng(seed)
    lidx = rng.choice(rows, N).astype(np.int32)
    rn = rng.random((N, 4)).astype(np.float32)
    lj = jsamp.sample_light_fwd(js, jnp.asarray(lidx), jnp.asarray(rn))
    lp = tsamp.sample_light_fwd(ps, torch.tensor(lidx), torch.tensor(rn))
    return lj, lp


def _same_fields(lj, lp, what):
    assert tuple(lp._fields) == tuple(lj._fields)
    for f in lj._fields:
        a, b = getattr(lp, f).numpy(), np.asarray(getattr(lj, f))
        assert a.shape == b.shape, (what, f)
        assert np.isfinite(a).all(), (what, f)
        np.testing.assert_allclose(a, b, err_msg=f"{what} {f}", **TOL)


@pytest.mark.parametrize("name", sorted(TYPES))
def test_sample_light_fwd_matches_jax(lights, name):
    js, ps = lights
    rows = np.nonzero(np.asarray(js.lights.ltype) == TYPES[name])[0]
    assert rows.size == 1, name
    lj, lp = _fwd_pair(js, ps, rows, 11 + TYPES[name])
    _same_fields(lj, lp, name)
    assert float(lp.radiance.abs().sum()) > 0.0


@pytest.mark.parametrize("ltype", [LIGHT_POINT, LIGHT_SPOT])
def test_sample_light_fwd_ies(ltype):
    """The IES point and spot lights of textured_scenes.surfaces: the
    profile (sample_bilinear with the scene's samplers) on the emitted
    direction."""
    js = ts.RECIPES["surfaces"]()
    ps = to_port(js)
    lt = js.lights
    rows = np.nonzero((np.asarray(lt.ltype) == ltype)
                      & (np.asarray(lt.tex) > 0))[0]
    assert rows.size == 1
    lj, lp = _fwd_pair(js, ps, rows, 3 + ltype)
    _same_fields(lj, lp, f"ies {ltype}")
    # the profile varies over the emitted directions
    assert float(lp.radiance[:, 0].std()) > 1e-3


def test_scene_bounding_sphere_and_sky_pdf(lights):
    js, ps = lights
    cj, rj = jsamp.scene_bounding_sphere(js)
    cp, rp = tsamp.scene_bounding_sphere(ps)
    assert cp.shape == (3,) and rp.shape == ()
    np.testing.assert_allclose(cp.numpy(), np.asarray(cj), **TOL)
    np.testing.assert_allclose(float(rp), float(rj), **TOL)
    assert tsamp.sky_pdf() == jsamp.sky_pdf()


def _box(width=16, height=12):
    """tests/test_oracle_lt.py's box: grey walls, a red one, a rect light."""
    b = SceneBuilder()
    grey = b.lambert([0.65, 0.65, 0.65])
    red = b.lambert([0.7, 0.15, 0.1])
    b.add_box_interior(2.0, grey, grey, grey, red, grey)
    b.rect_light([0, 1.95, 0], 0.7, 0.7, [12.0, 11.0, 9.0])
    return b.build(cam_pos=[0, 0, 5.6], cam_lookat=[0, 0, 0], width=width,
                   height=height, trace_depth=4)


def _glossy_box():
    """The box with a GGX sphere and a glass sphere in it (bounces through
    sample_bsdf's other lobes) under a rect and a point light."""
    b = SceneBuilder()
    grey = b.lambert([0.65, 0.65, 0.65])
    red = b.lambert([0.7, 0.15, 0.1])
    b.add_box_interior(2.0, grey, grey, grey, red, grey)
    ggx = b.add_material(refl_color=np.array([0.8, 0.7, 0.5], np.float32),
                         refl_dist=2, refl_alpha=0.3, refl_gloss=0.7,
                         diff_color=np.array([0.2, 0.2, 0.2], np.float32))
    b.add_sphere([-0.6, -1.2, -0.3], 0.7, ggx, n_seg=12, n_ring=6)
    glass = b.add_material(transp_color=np.array([0.95] * 3, np.float32),
                           transp_gloss=1.0, transp_ior=1.5)
    b.add_sphere([0.8, -1.4, 0.6], 0.5, glass, n_seg=12, n_ring=6)
    b.rect_light([0, 1.95, 0], 0.7, 0.7, [12.0, 11.0, 9.0])
    b.point_light([0.5, 1.0, 1.0], [4.0, 4.0, 4.0])
    return b.build(cam_pos=[0, 0, 5.6], cam_lookat=[0, 0, 0], width=16,
                   height=12, trace_depth=4)


@pytest.mark.parametrize("traversal", ["auto", "cluster"])
@pytest.mark.parametrize("recipe", ["box", "glossy"])
def test_lt_pass_matches_jax(recipe, traversal):
    """One pass of 16 paths a pixel at 16x12, depth 4, against the JAX
    lt_pass with the same seed; on the port's cluster route the light rays
    and camera connections go unsorted through B1/B2's twins. Each pixel
    takes many splats (16 paths a pixel, up to 3 vertices each), so a
    scatter that kept one duplicate would fail the energy check."""
    js = _box() if recipe == "box" else _glossy_box()
    ps = to_port(js, traversal=traversal)
    n_paths = 16 * 12 * 16
    img_j, paths_j = jlt.lt_pass(js, jnp.uint32(3), jnp.uint32(41), n_paths,
                                 max_depth=4)
    img_p, paths_p = tlt.lt_pass(ps, 3, 41, n_paths, max_depth=4,
                                 device="cpu")
    assert img_p.shape == (12, 16, 3) and torch.isfinite(img_p).all()
    assert paths_p == float(paths_j) == n_paths
    img_j = np.asarray(img_j)
    assert img_j.sum() > 0.0
    assert _close(img_j, img_p) >= 0.99
    e_j, e_p = float(img_j.sum(dtype=np.float64)), float(img_p.double().sum())
    assert abs(e_p - e_j) <= 1e-4 * e_j, (e_p, e_j)


def test_render_lt_sums_its_passes():
    """render_lt is the mean of its lt_pass images, on the device asked."""
    ps = to_port(_box())
    img = tlt.render_lt(ps, 3, paths_per_pass=500, seed=5, max_depth=3,
                        device="cpu")
    passes = [tlt.lt_pass(ps, i, 5, 500, max_depth=3, device="cpu")[0]
              for i in range(3)]
    assert img.device.type == "cpu"
    torch.testing.assert_close(img, sum(passes) / 3, rtol=1e-6, atol=1e-7)


def test_lt_entry_points_need_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    ps = to_port(_box(4, 4))
    with pytest.raises(RuntimeError, match="CUDA"):
        tlt.render_lt(ps, 1, paths_per_pass=16)
    with pytest.raises(RuntimeError, match="CUDA"):
        tlt.lt_pass(ps, 0, 3, 16)


def test_lt_matches_pt():
    """tests/test_lt_gbuffer.py::test_lt_matches_pt on the port alone."""
    b = SceneBuilder()
    m = b.lambert([0.65, 0.65, 0.65])
    red = b.lambert([0.7, 0.1, 0.1])
    b.add_box_interior(2.0, m, m, m, red, m)
    b.rect_light([0, 1.95, 0], 0.6, 0.6, [12.0, 12.0, 12.0])
    sc = to_port(b.build(cam_pos=[0, 0, 5.6], cam_lookat=[0, 0, 0], width=24,
                         height=24, trace_depth=4))
    pt = tpt.render(sc, spp=192, seed=5, device="cpu").numpy()
    lt = tlt.render_lt(sc, n_passes=48, paths_per_pass=24 * 24 * 8, seed=9,
                       device="cpu").numpy()
    emit_mask = pt.max(axis=-1) > 1.2
    pt_m = np.where(emit_mask[..., None], 0, pt)
    lt_m = np.where(emit_mask[..., None], 0, lt)
    rel = abs(pt_m.mean() - lt_m.mean()) / max(pt_m.mean(), 1e-9)
    assert rel < 0.12, f"LT/PT disagree: pt={pt_m.mean():.4f} lt={lt_m.mean():.4f}"
    a = pt_m.reshape(6, 4, 6, 4, 3).mean(axis=(1, 3))
    c = lt_m.reshape(6, 4, 6, 4, 3).mean(axis=(1, 3))
    mask = a.mean(-1) > 0.05
    relmap = np.abs(a - c).mean(-1)[mask] / np.maximum(a.mean(-1)[mask], 1e-9)
    assert np.median(relmap) < 0.25, f"median block error {np.median(relmap)}"
