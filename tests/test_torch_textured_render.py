"""Textured renders of the port against the JAX package's, and the
features that still raise.

Scenes: tests/textured_scenes.py's 'surfaces' (wrap and clamp diffuse
textures, reflection, emission and translucency textures, a normal map, a
mask and a Fresnel blend, IES point and spot lights) and 'sky_tree' (a sky
image, a camera-projected back plate, a two-level blend tree), carried to
the port by scene_from_arrays; and textured_desc, a SceneDesc with its
texture files, IES profile and an opacity map assembled by both packages
(every leaf bit for bit) and rendered on the dense, cluster (split alpha
shadows) and packet routes.

Tolerance, the rule of tests/test_torch_pt.py: at 32x32, 4 spp, seed 777,
>= 99% of pixels within 1e-3 of the JAX render and the ray count within
0.1%.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests.textured_scenes as ts
from hydracore_tpu.integrators import pt as jpt
from hydracore_tpu.scene import scene as jscene
from hydracore_tpu_torch.integrators import pt as tpt
from hydracore_tpu_torch.ops import trace_api as tta
from hydracore_tpu_torch.scene import scene as pscene
from tests.test_torch_assemble import JAX, PORT
from tests.test_torch_scene import (_assert_same_leaves, jax_leaves,
                                    jax_settings, to_port)

torch.set_num_threads(1)

SEED = 777
N_PASS = 4


def _jax_render(js):
    img, rays = jpt.render_passes(js, jnp.uint32(0), jnp.uint32(SEED),
                                  n_pass=N_PASS, max_depth=4)
    return np.asarray(img) / N_PASS, float(rays)


def _check(ps, ref):
    img_j, rays_j = ref
    img_p, rays_p = tpt.render_passes(ps, 0, SEED, n_pass=N_PASS, max_depth=4,
                                      device="cpu")
    img_p = img_p.numpy() / N_PASS
    assert img_p.shape == (ts.SIZE, ts.SIZE, 3) and np.isfinite(img_p).all()
    assert img_p.mean() > 0.01
    agree = (np.abs(img_p - img_j).max(axis=-1) <= 1e-3).mean()
    assert agree >= 0.99, agree
    assert abs(int(rays_p) - rays_j) <= 1e-3 * rays_j


@pytest.mark.parametrize("name", ["surfaces", "sky_tree"])
def test_render_matches_jax(name):
    js = ts.RECIPES[name]()
    _check(to_port(js), _jax_render(js))


@pytest.fixture(scope="module")
def desc_scenes(tmp_path_factory):
    d = tmp_path_factory.mktemp("lib")
    js = jscene.assemble(ts.textured_desc(JAX, d))
    ps = pscene.assemble(ts.textured_desc(PORT, d))
    return js, ps, _jax_render(js)


def test_desc_assembles_bit_exact(desc_scenes):
    """Every feature of the SceneDesc reaches the scene, as in the JAX
    package: the same leaves, bit for bit, and the same gates."""
    js, ps, _ = desc_scenes
    _assert_same_leaves(jax_leaves(js), pscene.scene_leaves(ps))
    assert jax_settings(js) == dataclasses.asdict(ps.settings)
    st = ps.settings
    assert (st.has_diff_tex and st.has_bump and st.has_alpha and st.has_blend
            and st.blend_depth == 2 and st.has_ies and st.has_env_back)
    assert int(ps.lights.tex[ps.lights.ltype == 3][0]) > 0  # the sky image
    assert ps.cl_tris_shadow is not None


@pytest.mark.parametrize("traversal", ["auto", "cluster", "packet"])
def test_desc_render_matches_jax(desc_scenes, traversal):
    js, _, ref = desc_scenes
    ps = to_port(js, traversal=traversal)
    assert tta.has_shadow_split(ps) == (traversal == "cluster")
    _check(ps, ref)


@pytest.mark.parametrize("flag,value,name", [
    ("has_proc_tex", True, "procedural textures"),
    ("has_sss", True, "subsurface"),
    ("has_fog", True, "glass fog"),
    ("has_proc_ao", True, "procedural-texture AO"),
    ("render_layer", "direct", "render_layer"),
])
def test_unported_features_still_raise(flag, value, name):
    """check_supported refuses the features of a later slice by name, at
    scene_from_arrays and at render_passes."""
    js = ts.alpha()
    settings = {**jax_settings(js), flag: value}
    with pytest.raises(NotImplementedError, match=name):
        pscene.scene_from_arrays(jax_leaves(js), settings, "cpu")
    ps = to_port(js)
    ps = dataclasses.replace(
        ps, settings=dataclasses.replace(ps.settings, **{flag: value}))
    with pytest.raises(NotImplementedError, match=name):
        tpt.render_passes(ps, 0, SEED, n_pass=1, device="cpu")
