"""app/cam_plugin.py of the port against the JAX package's: the plugins are
numpy copies, so the same scene and seed give the same host rays bit for
bit, and render_with_plugin traces them through the port's path tracer.

Tolerances: rays and pixel ids equal; the images by the image rule of
tests/test_torch_pt.py (>= 99% of pixels within 1e-3 of the JAX image).
The lens is an inline table (tests/test_cam_plugin_lens.py's biconvex
singlet), not the reference scene's.
"""
import numpy as np
import pytest
import torch

from hydracore_tpu.app import cam_plugin as jcp
from hydracore_tpu.scene.procedural import SceneBuilder
from hydracore_tpu_torch.app import cam_plugin as pcp
from hydracore_tpu_torch.integrators import pt as ppt
from tests.test_torch_scene import to_port

torch.set_num_threads(1)

W = 12
BLOCKS = 4
BICONVEX = [
    dict(curvature_radius=0.026, thickness=0.004, ior=1.52,
         aperture_radius=0.006),
    dict(curvature_radius=-0.026, thickness=0.024, ior=1.0,
         aperture_radius=0.006),
]


@pytest.fixture(scope="module")
def scenes():
    b = SceneBuilder()
    m = b.lambert([0.6] * 3)
    r = b.lambert([0.7, 0.2, 0.2])
    b.add_box_interior(2.0, r, m, m, m, m)
    b.rect_light([0, 1.95, 0], 0.5, 0.5, [12.0] * 3)
    js = b.build(cam_pos=[0, 0, 5.5], cam_lookat=[0, 0, 0], width=W,
                 height=W, trace_depth=3)
    return js, to_port(js)


def _plugins(kind, js, ps):
    if kind == "pinhole":
        return jcp.SimplePinholePlugin(js, seed=5), pcp.SimplePinholePlugin(ps, seed=5)
    kw = dict(sensor_diagonal=0.022, seed=5, film_dist=0.024)
    return (jcp.TabulatedLensPlugin(js, BICONVEX, **kw),
            pcp.TabulatedLensPlugin(ps, BICONVEX, **kw))


@pytest.mark.parametrize("kind", ["pinhole", "lens"])
def test_same_host_rays(scenes, kind):
    jp, pp = _plugins(kind, *scenes)
    for b in range(3):
        for x, y in zip(jp.make_rays_block(100, b), pp.make_rays_block(100, b)):
            assert x.dtype == y.dtype and np.array_equal(x, y)
    if kind == "lens":
        assert pp.n_dead == jp.n_dead > 0 and pp.n_rays == jp.n_rays


@pytest.mark.parametrize("kind", ["pinhole", "lens"])
def test_render_with_plugin_matches_jax(scenes, kind):
    js, ps = scenes
    jp, pp = _plugins(kind, js, ps)
    jcp.render_with_plugin(js, jp, n_blocks=BLOCKS, block_size=W * W, seed=9)
    pcp.render_with_plugin(ps, pp, n_blocks=BLOCKS, block_size=W * W, seed=9,
                           device="cpu")
    a, b = jp.image(), pp.image()
    assert np.array_equal(jp.counts, pp.counts)
    close = float((np.abs(a - b).max(-1) <= 1e-3).mean())
    assert close >= 0.99, close
    assert b.max() > 0.01 and np.isfinite(b).all()


def test_pinhole_plugin_sees_what_the_path_tracer_sees(scenes):
    """Pinhole rays through render_with_plugin estimate the image of the
    port's own render: the means agree within 10% at 32 samples a pixel."""
    _, ps = scenes
    plug = pcp.SimplePinholePlugin(ps, seed=3)
    pcp.render_with_plugin(ps, plug, n_blocks=32, block_size=W * W, seed=4,
                           device="cpu")
    ref = ppt.render(ps, spp=32, seed=4, device="cpu").numpy()
    img = plug.image()
    assert abs(img.mean() - ref.mean()) / ref.mean() < 0.1, (img.mean(), ref.mean())
