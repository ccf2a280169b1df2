"""The port's BDPT against the JAX package's on the scenes that reach the
rest of the BSDF and light code: a glossy box (tests/test_torch_lt.py's:
a GGX sphere, a glass sphere, a rect and a point light) and the textured
recipe tests/textured_scenes.py:surfaces (diffuse, reflection, emission
and translucency textures, normal maps, a mask and a Fresnel blend, IES
point and spot lights), both at 16x16: one wavefront shape, so the JAX
package's eager run compiles its operations once for both.

Tolerances: as in tests/test_torch_bdpt.py (the same labels, each
per-strategy image by the image rule, its total energy within rtol 1e-4),
for "full" and "3way" on the port's auto and cluster routes.
"""
import dataclasses

import numpy as np
import pytest
import torch

import tests.textured_scenes as ts
from hydracore_tpu.scene.procedural import SceneBuilder
from tests.test_torch_bdpt import jax_cache, same_strategies

torch.set_num_threads(1)


def _surfaces16():
    """textured_scenes.surfaces with its camera at 16x16 (the same aspect,
    so the same projection)."""
    js = ts.surfaces("jax")
    return js.replace(camera=js.camera.replace(width=16, height=16),
                      settings=dataclasses.replace(js.settings, width=16,
                                                   height=16))


def _glossy_box():
    """tests/test_torch_lt.py's glossy box at 16x16."""
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
                   height=16, trace_depth=4)


SCENES = {"glossy": _glossy_box, "surfaces": _surfaces16}


@pytest.fixture(scope="module")
def jax_runs():
    return jax_cache(SCENES)


@pytest.mark.parametrize("traversal", ["auto", "cluster"])
@pytest.mark.parametrize("strategy", ["full", "3way"])
@pytest.mark.parametrize("name", sorted(SCENES))
def test_strategy_images_match_jax(jax_runs, name, strategy, traversal):
    js, imgs, _ = jax_runs(name)
    same_strategies(js, imgs, strategy, traversal, name)
