"""Scene parity: the port's SceneBuilder against the JAX package's.

The five procedural golden recipes (tests/golden_scenes.py) and the
350-rect traversal scene are built by both packages; every leaf the port
keeps must be bit-exact (tolerance 0), and the static settings equal.
The binary BVH, its 8-wide collapse and the packet kernel's rows are among
those leaves. scene_from_arrays of a JAX scene must round-trip bit-exact.
Textured, procedural, SSS and fog materials build with their gates set.
"""
import dataclasses

import numpy as np
import pytest
import torch

import tests.golden_scenes as gs
from hydracore_tpu.scene.procedural import SceneBuilder as JaxBuilder
from hydracore_tpu_torch.scene.procedural import SceneBuilder as PortBuilder
from hydracore_tpu_torch.scene.scene import (leaf_names, scene_from_arrays,
                                             scene_leaves)

# one intra-op thread: the suite runs several test processes at once, and
# spinning PyTorch worker threads on shared cores slow every one of them
torch.set_num_threads(1)


def jax_leaves(sc) -> dict:
    """The numpy leaves of a JAX SceneData under the port's leaf names."""
    out = {}
    for name in leaf_names():
        obj = sc
        for part in name.split("."):
            obj = getattr(obj, part, None)
        if obj is not None:
            out[name] = np.asarray(obj)
    return out


def jax_settings(sc) -> dict:
    return dataclasses.asdict(sc.settings)


def to_port(jscene, device="cpu", traversal="auto"):
    """The port's scene holding the very bytes of a JAX scene."""
    return scene_from_arrays(jax_leaves(jscene), jax_settings(jscene), device,
                             traversal)


def build_with(builder, recipe):
    """Replay a golden_scenes recipe against `builder`'s SceneBuilder."""
    saved = gs.SceneBuilder
    gs.SceneBuilder = builder
    try:
        return recipe()
    finally:
        gs.SceneBuilder = saved


def rects_recipe():
    """tests/test_traverse_cluster.py's 350 random rects."""
    rng = np.random.default_rng(7)
    b = gs.SceneBuilder()
    m = b.lambert([0.7, 0.7, 0.7])
    for _ in range(350):
        c = rng.uniform(-4, 4, 3)
        vx = rng.uniform(-0.4, 0.4, 3)
        vy = rng.uniform(-0.4, 0.4, 3)
        b.add_rect(c, vx, vy, m)
    return b.build(cam_pos=[0, 0, 10], cam_lookat=[0, 0, 0], width=8, height=8)


RECIPES = {**gs.SCENES, "rects350": rects_recipe}


def _assert_same_leaves(jl: dict, pl: dict):
    assert sorted(pl) == sorted(jl)
    bad = [k for k in pl
           if jl[k].dtype != pl[k].dtype or jl[k].shape != pl[k].shape
           or jl[k].tobytes() != pl[k].tobytes()]
    assert not bad, bad


@pytest.mark.parametrize("name", sorted(RECIPES))
def test_builder_leaves_bit_exact(name):
    js = build_with(JaxBuilder, RECIPES[name])
    ps = build_with(PortBuilder, RECIPES[name])
    pl = scene_leaves(ps)
    assert len(pl) >= 101  # geometry, BVHs, cluster pool, tables, camera, rows
    assert {"bvh_bmin", "bvh_count", "wbvh_nodes", "wbvh_tri9f",
            "wbvh_slot_tri", "wbvh_depth", "pkt_nodes", "pkt_tris"} <= set(pl)
    # the packet kernel's payload view of the one node array is the JAX
    # scene's second, int32 copy
    assert js.pkt_nodesi.tobytes() == pl["pkt_nodes"].view(np.int32).tobytes()
    _assert_same_leaves(jax_leaves(js), pl)
    assert jax_settings(js) == dataclasses.asdict(ps.settings)
    assert (ps.camera.width, ps.camera.height) == (js.camera.width,
                                                   js.camera.height)


def test_scene_from_arrays_round_trip():
    js = build_with(JaxBuilder, gs.scene_spot_sphere_lights)
    ps = to_port(js)
    _assert_same_leaves(jax_leaves(js), scene_leaves(ps))
    assert dataclasses.asdict(ps.settings) == jax_settings(js)
    assert str(ps.tri_attr.device) == "cpu"


def _sky_image():
    b = PortBuilder()
    b.lambert([0.5, 0.5, 0.5])
    b.sky([1.0, 1.0, 1.0], img=np.ones((4, 8, 4), np.float32))
    return b


@pytest.mark.parametrize("gate,make", [
    ("has_sky", _sky_image),
    ("has_alpha", lambda: _with_material(opacity_tex=1)),
    ("has_blend", lambda: _with_material(blend_node=0)),
    ("has_proc_tex", lambda: _with_material(diff_proc=0)),
    ("has_proc_ao", lambda: _with_material(ao_type=1)),
    ("has_sss", lambda: _with_material(sss_transmission=0.5)),
    ("has_fog", lambda: _with_material(fog_mult=1.0)),
])
def test_textured_features_build(gate, make):
    """A sky image, an opacity map, a blend, a procedural texture and its AO
    input, SSS and glass fog build (each raised before the port carried
    it), with their static gate set."""
    b = make()
    b.add_rect([0, 0, 0], [1, 0, 0], [0, 0, 1], 0)
    sc = b.build(cam_pos=[0, 3, 3], cam_lookat=[0, 0, 0], width=8, height=8)
    assert getattr(sc.settings, gate)


def _with_material(**kw):
    b = PortBuilder()
    b.add_material(diff_color=np.array([0.5, 0.5, 0.5], np.float32), **kw)
    return b


def test_scene_from_arrays_refuses_instanced_pool():
    """An instanced pool is taken only whole: cl_map without the other
    instance tables, or without settings.has_inst, is refused."""
    js = build_with(JaxBuilder, gs.scene_cornell_diffuse)
    leaves = jax_leaves(js)
    leaves["cl_map"] = np.zeros((2, 128), np.int32)
    with pytest.raises(KeyError, match="inst_woop"):
        scene_from_arrays(leaves, jax_settings(js), "cpu")
    leaves.update(cl_slot_inst=np.zeros(128 * 128, np.int32),
                  inst_attr=np.zeros((1, 32), np.float32),
                  inst_orig=np.full(1, -1, np.int32),
                  inst_woop=np.eye(4, dtype=np.float32)[None])
    with pytest.raises(ValueError, match="has_inst"):
        scene_from_arrays(leaves, jax_settings(js), "cpu")
