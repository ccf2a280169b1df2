"""The path tracer's remaining gates in the port against the JAX package:
the SSS medium walk, Beer-fog glass, procedural textures with an AO input
and the direct / indirect render layers.

Scenes are built with the JAX package's SceneBuilder and carried to the
port by scene_from_arrays (the same bytes), then rendered on the cluster
route (sorted wavefronts, the kernels' CPU twins) and on the packet route
(unsorted):
  * sss: the SSS sphere of tests/test_sss_blend.py under a sky, depth 8;
  * fog: a Beer-fog glass sphere in a lit box;
  * ao: the AO-dirt floor of tests/test_aux_subsystems.py (ao_dirt
    registered first in both packages' registries, so its id is the same);
  * layers: the golden mirror sphere, 'direct' and 'indirect'.

Tolerance, the rule of tests/test_torch_pt.py: at 24x24, 4 passes, seed
777, >= 99% of pixels within 1e-3 of the JAX render and the ray count
within 0.1% (SSS flight distances go through log and exp, whose last ulp
may differ between XLA and PyTorch: a rare path may change). The layers
must also sum to the color render within atol 1e-4, the port's own and
the JAX package's. ao_probe and hg_sample are held as functions: ao on
>= 99% of rays equal, hg_sample at rtol 1e-5 / atol 1e-6.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests.golden_scenes as gs
from hydracore_tpu.integrators import pt as jpt
from hydracore_tpu.ops import proctex as jproc
from hydracore_tpu.scene.procedural import SceneBuilder as JaxBuilder
from hydracore_tpu_torch.integrators import pt as tpt
from hydracore_tpu_torch.ops import proctex as pproc
from tests.test_torch_scene import build_with, to_port

torch.set_num_threads(1)

SEED = 777
N_PASS = 4
SIZE = 24
ROUTES = ("cluster", "packet")


def _jax_render(js, depth):
    img, rays = jpt.render_passes(js, jnp.uint32(0), jnp.uint32(SEED),
                                  n_pass=N_PASS, max_depth=depth)
    return np.asarray(img) / N_PASS, float(rays)


def _port_render(ps, depth):
    img, rays = tpt.render_passes(ps, 0, SEED, n_pass=N_PASS, max_depth=depth,
                                  device="cpu")
    return img.numpy() / N_PASS, int(rays)


def _check(ps, ref, depth):
    img_j, rays_j = ref
    img_p, rays_p = _port_render(ps, depth)
    assert img_p.shape == (SIZE, SIZE, 3) and np.isfinite(img_p).all()
    assert img_p.mean() > 0.01
    agree = (np.abs(img_p - img_j).max(axis=-1) <= 1e-3).mean()
    assert agree >= 0.99, agree
    assert abs(rays_p - rays_j) <= 1e-3 * rays_j
    return img_p


def sss_scene():
    b = JaxBuilder()
    m = b.add_material(diff_color=np.asarray([0.25, 0.2, 0.15], np.float32),
                       sss_density=1.2,
                       sss_absorption=np.asarray([0.5, 0.15, 0.05], np.float32),
                       sss_scattering=3.0, sss_phase=0.3,
                       sss_transmission=0.8)
    b.add_sphere([0, 0, 0], 0.8, m, n_seg=24, n_ring=12)
    b.sky([0.8, 0.8, 0.9])
    return b.build([0, 0, 3.0], [0, 0, 0], fov=40.0, width=SIZE, height=SIZE,
                   trace_depth=8)


def fog_scene():
    b = JaxBuilder()
    wall = b.lambert([0.6, 0.6, 0.6])
    b.add_box_interior(2.0, wall, wall, wall, b.lambert([0.7, 0.12, 0.1]),
                       b.lambert([0.12, 0.55, 0.18]))
    glass = b.add_material(transp_color=np.ones(3, np.float32),
                           transp_ior=1.5,
                           fog_color=np.asarray([0.9, 0.5, 0.3], np.float32),
                           fog_mult=1.5)
    b.add_sphere([0, -1.0, 0], 0.9, glass, n_seg=24, n_ring=12)
    b.rect_light([0, 1.95, 0], 0.5, 0.5, [12.0] * 3)
    return b.build([0, 0, 5.6], [0, 0, 0], width=SIZE, height=SIZE,
                   trace_depth=5)


def ao_scene(pid):
    b = JaxBuilder()
    args = np.zeros(8, np.float32)
    args[0:3] = 0.03  # dirt (occluded)
    args[3:6] = 0.75  # clean (open)
    floor = b.add_material(diff_color=np.ones(3, np.float32), diff_proc=pid,
                           proc_args=args, ao_type=1, ao_length=1.5)
    b.add_rect([0, 0, 0], [4, 0, 0], [0, 0, 4], floor, flip=True)
    wall = b.lambert([0.4, 0.4, 0.4])
    b.add_rect([-1.5, 0.75, 0], [0, 0.75, 0], [0, 0, 2], wall)
    b.point_light([2.0, 3.5, 0], [30.0] * 3)
    return b.build(cam_pos=[0.5, 4.0, 0.01], cam_lookat=[0.3, 0, 0],
                   width=SIZE, height=SIZE, trace_depth=3)


@pytest.fixture
def ao_registered():
    """ao_dirt as id 0 in both registries, cleared after."""
    jproc.clear_registry()
    pproc.clear_registry()
    try:
        pid = jproc.register_proc_tex(jproc.ao_dirt)
        assert pproc.register_proc_tex(pproc.ao_dirt) == pid
        yield pid
    finally:
        jproc.clear_registry()
        pproc.clear_registry()


@pytest.fixture(scope="module")
def sss_ref():
    js = sss_scene()
    assert js.settings.has_sss
    return js, _jax_render(js, 8)


@pytest.mark.parametrize("route", ROUTES)
def test_sss_render_matches_jax(sss_ref, route):
    js, ref = sss_ref
    _check(to_port(js, traversal=route), ref, 8)


@pytest.fixture(scope="module")
def fog_ref():
    js = fog_scene()
    assert js.settings.has_fog
    return js, _jax_render(js, 5)


@pytest.mark.parametrize("route", ROUTES)
def test_fog_render_matches_jax(fog_ref, route):
    js, ref = fog_ref
    ps = to_port(js, traversal=route)
    img = _check(ps, ref, 5)
    # the fog takes light: with its gate off the image is brighter
    clear = dataclasses.replace(ps, settings=dataclasses.replace(
        ps.settings, has_fog=False))
    assert img.sum() < 0.99 * _port_render(clear, 5)[0].sum()


@pytest.mark.parametrize("route", ROUTES)
def test_ao_render_matches_jax(ao_registered, route):
    js = ao_scene(ao_registered)
    assert js.settings.has_proc_ao and js.settings.has_proc_tex
    _check(to_port(js, traversal=route), _jax_render(js, 3), 3)


def _layers(sc, replace):
    return {lay: sc if lay == "color" else replace(sc, settings=dataclasses.replace(
        sc.settings, render_layer=lay)) for lay in ("color", "direct", "indirect")}


def mirror_box():
    """The golden mirror sphere at SIZE x SIZE."""
    saved, gs.SIZE = gs.SIZE, SIZE
    try:
        return build_with(JaxBuilder, gs.scene_mirror_sphere)
    finally:
        gs.SIZE = saved


@pytest.fixture(scope="module")
def layer_refs():
    js = mirror_box()
    scenes = _layers(js, lambda s, **kw: s.replace(**kw))
    refs = {k: _jax_render(v, 4) for k, v in scenes.items()}
    assert np.allclose(refs["direct"][0] + refs["indirect"][0],
                       refs["color"][0], atol=1e-4)
    return js, refs


@pytest.mark.parametrize("route", ROUTES)
def test_layers_match_jax_and_sum_to_color(layer_refs, route):
    js, refs = layer_refs
    ps = to_port(js, traversal=route)
    imgs = {k: _check(v, refs[k], 4)
            for k, v in _layers(ps, dataclasses.replace).items()}
    assert np.allclose(imgs["direct"] + imgs["indirect"], imgs["color"],
                       atol=1e-4)
    assert imgs["direct"].sum() > 0.05 * imgs["color"].sum()
    assert imgs["indirect"].sum() > 0.05 * imgs["color"].sum()


@pytest.mark.parametrize("ao_type", [1, 2, 3])
def test_ao_probe_matches_jax(ao_type):
    """ao_probe on the first hits of the mirror-sphere box (walls, whose
    'down' side looks out of the box, and a sphere, whose 'down' side is
    inside it), ao_len 1, seeded uniforms."""
    js = mirror_box()
    ps = to_port(js, traversal="cluster")
    ray_o, ray_d, _, _ = tpt.primary_rays(ps, [0], SEED)
    t, tri, u, v = tpt.closest_hit(ps, ray_o, ray_d)
    pos, n, ng, _, _, _, _ = tpt.compute_hit(ps, tri, u, v, ray_o, ray_d, t)
    R = pos.shape[0]
    rng = np.random.default_rng(ao_type)
    r_ao = rng.random((R, 4)).astype(np.float32)
    need = (tri >= 0).numpy() & (rng.random(R) < 0.9)
    typ = np.full(R, ao_type, np.int32)
    ao_len = np.full(R, 1.0, np.float32)
    ao_j = np.asarray(jpt.ao_probe(
        js, *(jnp.asarray(x) for x in (pos.numpy(), n.numpy(), ng.numpy(),
                                       typ, ao_len, need, r_ao))))
    ao_p = tpt.ao_probe(ps, pos, n, ng, torch.tensor(typ),
                        torch.tensor(ao_len), torch.tensor(need),
                        torch.tensor(r_ao)).numpy()
    assert (ao_p == ao_j).mean() >= 0.99
    assert (ao_p[~need] == 1.0).all()
    assert (ao_p[need] < 1.0).any() and (ao_p[need] > 0.0).any()


def test_hg_sample_matches_jax():
    rng = np.random.default_rng(5)
    n = 4096
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    g = rng.uniform(-0.9, 0.9, n).astype(np.float32)
    e1, e2 = rng.random((2, n)).astype(np.float32)
    wj = np.asarray(jpt.hg_sample(*(jnp.asarray(x) for x in (d, g, e1, e2))))
    wp = tpt.hg_sample(*(torch.tensor(x) for x in (d, g, e1, e2))).numpy()
    np.testing.assert_allclose(wp, wj, rtol=1e-5, atol=1e-6)
    cos = (wp * d).sum(-1)
    assert np.corrcoef(cos, g)[0, 1] > 0.3  # forward scattering for g > 0
