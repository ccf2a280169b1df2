"""Textured renders of the port against the JAX package's, and the gates
check_supported takes.

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


@pytest.mark.parametrize("flag,value", [
    ("has_proc_tex", True),
    ("has_sss", True),
    ("has_fog", True),
    ("has_proc_ao", True),
    ("render_layer", "direct"),
    ("render_layer", "indirect"),
])
def test_gated_features_accepted(flag, value):
    """check_supported takes the gates of the last slice (they raised
    before the port carried them): scene_from_arrays builds the scene and
    render_passes renders a finite, non-zero image at depth 3 (the
    indirect layer starts at the second vertex's NEE)."""
    js = ts.alpha()
    settings = {**jax_settings(js), flag: value}
    ps = pscene.scene_from_arrays(jax_leaves(js), settings, "cpu")
    pscene.check_supported(ps)
    img, _ = tpt.render_passes(ps, 0, SEED, n_pass=1, max_depth=3,
                               device="cpu")
    assert torch.isfinite(img).all() and float(img.sum()) > 0.0


def test_unknown_layer_and_source_raise(tmp_path):
    """An unknown render layer is refused by name (ValueError); a
    procedural texture that ships its C source no longer raises: the port
    compiles it (ops/proctex_c) and registers it first, with the proc-tex
    gate set, as the JAX package does with the same desc."""
    from hydracore_tpu.ops import proctex as jproc
    from hydracore_tpu_torch.ops import proctex as pproc
    from tests.test_torch_proctex import proc_desc

    js = ts.alpha()
    with pytest.raises(ValueError, match="render_layer"):
        pscene.scene_from_arrays(
            jax_leaves(js), {**jax_settings(js), "render_layer": "albedo"},
            "cpu")
    jproc.clear_registry()
    pproc.clear_registry()
    try:
        with pytest.warns(UserWarning, match="noise"):
            jsc = jscene.assemble(proc_desc(JAX, tmp_path, source=True))
        with pytest.warns(UserWarning, match="noise"):
            psc = pscene.assemble(proc_desc(PORT, tmp_path, source=True))
        assert psc.settings.has_proc_tex and jsc.settings.has_proc_tex
        assert pproc._REGISTRY[0][0].__name__ == "proctex_prtex1_main" \
            == jproc._REGISTRY[0][0].__name__
        assert psc.materials.diff_proc.tolist()[1] == 0
        assert pproc.num_proc_tex() == jproc.num_proc_tex() == 3
    finally:
        jproc.clear_registry()
        pproc.clear_registry()
